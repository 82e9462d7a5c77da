"""Every load route under a shard draw, and a world's one cache: the
port's ``Dataset.load_train(io, rank=r, num_machines=P)`` by each route
against its resident shard and the JAX package's own load of that
route, and lightgbm_tpu_torch worlds (gloo on the CPU,
tests/test_torch_parallel.World) trained from each route.

- Routes: the native cache as ``data=`` and as the ``<data>.bin``
  sibling, a reference-format sibling, ``streaming=true`` (the serial
  passes), ``ingest_workers=2`` and two-round, at P = 2 and 3, with and
  without a query side file: for every rank the rows
  (``used_data_indices``), bins, labels, weights and query boundaries
  are the resident shard's and the JAX package's load of the route
  (its streamed, worker and two-round loads, and its cache re-shard,
  ``_reshard_rows``); the shards partition the file.  Under 50,000
  rows, so the JAX two-round sample is the resident one (C5).
- Known gap, the JAX rule on both sides: a cache re-shards
  query-atomically wherever it holds query boundaries, an in-file query
  column's too, while the text routes draw per record before reading
  that column; so for an in-file query column a cache world's rows are
  not the text world's.  The port's re-shard there is JAX
  ``_reshard_rows``'s, with ``shard_query_atomic`` set.
- Training: one 2-rank int8 ``tree_learner=data`` world loads by each
  route with the distributed bin finder and writes the resident
  world's model text byte for byte; a hybrid 2 x 2 world from the
  byte-range workers and from a cache writes its resident text.
- C14: with ``is_save_binary_file`` a world leaves one cache, rank 0's,
  byte-equal to the serial run's (resident and streamed ranks, native
  and reference format, a query side file and an in-file query column,
  under ``data`` and under ``feature``); a serial run from it holds the
  whole table.  The JAX package's ranks each write their own shard
  (``num_data < global_num_data``).  Under ``is_pre_partition`` each
  rank writes its own file's cache; ranks naming one path, or taking
  different kinds of route, stop on a ``Fatal``.
- Checkpoints: a world loaded from a cache keeps serial row order: its
  checkpoint has no ``row_order: rank``, and it resumes on the world
  loaded from text and on a serial run, to the unbroken text.

Tolerance: none (bytes and int8 model text).
"""
import glob
import hashlib
import json
import os
import shutil
import sys

import numpy as np
import pytest

from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io import parallel_ingest as jparallel_ingest
from lightgbm_tpu.io.dataset import Dataset as JDataset

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import checkpoint as ckpt
from lightgbm_tpu_torch import lifecycle
from lightgbm_tpu_torch.io import parallel_ingest
from lightgbm_tpu_torch.io.dataset import draw_shard, read_cache_header
from test_torch_parallel import BASE, World

N = 3000
COLUMNS = {"has_header": "true", "label_column": "name:y",
           "weight_column": "name:w", "ignore_column": "name:z"}
ROUTES = {
    "cache_direct": ("native", ".bin", {}),
    "cache_sibling": ("native", "", {}),
    "reference_sibling": ("reference", "", {}),
    "streaming": ("text", "", {"streaming": "true",
                               "ingest_chunk_rows": "701"}),
    "workers": ("text", "", {"streaming": "true", "ingest_workers": "2",
                             "ingest_chunk_rows": "503"}),
    "two_round": ("text", "", {"use_two_round_loading": "true",
                               "ingest_chunk_rows": "607"}),
}
DP = {"tree_learner": "data", "num_machines": "2", "hist_dtype": "int8"}


@pytest.fixture(autouse=True)
def reaped_workers():
    yield
    parallel_ingest.shutdown_workers()
    jparallel_ingest.shutdown_workers()
    left = lifecycle.leaks()
    for _, _, closer in left:
        closer()
    assert not left, [(k, n) for k, n, _ in left]


def write_csv(path, n=N, seed=5, queries=False, qcolumn=False):
    """A header, features f0-f6 with the label ``y`` as column 2, a weight
    ``w`` and an ignored ``z``; ``queries``: a ``.query`` side file;
    ``qcolumn``: an in-file query id ``q`` (runs of 1-29 rows)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 7)
    y = (x[:, 0] - 0.6 * x[:, 1] + 0.4 * rng.randn(n) > 0).astype(int)
    cols = [x[:, :2], y[:, None], x[:, 2:], (0.5 + rng.rand(n))[:, None],
            rng.randn(n, 1)]
    names = ["f0", "f1", "y", "f2", "f3", "f4", "f5", "f6", "w", "z"]
    fmt = ["%.6f"] * 2 + ["%d"] + ["%.6f"] * 5 + ["%.4f", "%.3f"]
    counts = None
    if queries or qcolumn:
        counts = rng.randint(1, 30, size=n)
        counts = counts[np.cumsum(counts) <= n]
        counts = np.append(counts, n - counts.sum())
        counts = counts[counts > 0]
    if qcolumn:
        cols.append(np.repeat(np.arange(counts.size), counts)[:, None])
        names.append("q")
        fmt.append("%d")
    np.savetxt(path, np.hstack(cols), delimiter=",", fmt=fmt,
               header=",".join(names), comments="")
    if queries:
        np.savetxt(str(path) + ".query", counts, fmt="%d")
    return str(path)


def port_io(path, **extra):
    cfg = lgt.OverallConfig()
    cfg.set(dict(BASE, **COLUMNS, data=str(path), **extra))
    return cfg.io_config


def jax_io(path, **extra):
    cfg = JConfig()
    cfg.set(dict(BASE, **COLUMNS, data=str(path), **extra))
    return cfg.io_config


def copy_table(src, dst):
    shutil.copy(src, dst)
    if os.path.exists(src + ".query"):
        shutil.copy(src + ".query", dst + ".query")
    return str(dst)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Per table (plain, ranked with a query side file): the text file
    and copies beside a native and a reference cache written serially."""
    d = tmp_path_factory.mktemp("tables")
    out = {}
    for name, queries in (("plain", False), ("ranked", True)):
        text = write_csv(d / (name + ".csv"), queries=queries)
        native = copy_table(text, str(d / (name + "_n.csv")))
        lgt.Dataset.load_train(port_io(native, is_save_binary_file="true"))
        ref = copy_table(text, str(d / (name + "_r.csv")))
        lgt.Dataset.load_train(port_io(ref, is_save_binary_file="true",
                                       save_binary_format="reference"))
        out[name] = {"text": text, "native": native, "reference": ref}
    return out


_RESIDENT = {}


def resident(tables, table, r, P):
    key = (table, r, P)
    if key not in _RESIDENT:
        _RESIDENT[key] = lgt.Dataset.load_train(
            port_io(tables[table]["text"]), rank=r, num_machines=P)
    return _RESIDENT[key]


def assert_same_shard(got, want, got_rows=None):
    """Rows, bins, labels, weights and query boundaries; ``got_rows``
    stands for a dataset that keeps no row indices (a JAX cache)."""
    rows = got.used_data_indices if got_rows is None else got_rows
    np.testing.assert_array_equal(rows, want.used_data_indices)
    assert [m.to_bytes() for m in got.bin_mappers] == \
        [m.to_bytes() for m in want.bin_mappers]
    gb = got.read_bins() if hasattr(got, "read_bins") else \
        np.asarray(got.bins)
    assert gb.dtype == want.bins.dtype and gb.tobytes() == \
        want.bins.tobytes()
    for key in ("label", "weights", "query_boundaries"):
        a, b = getattr(got.metadata, key), getattr(want.metadata, key)
        assert (a is None) == (b is None), key
        if b is not None:
            np.testing.assert_array_equal(a, b, err_msg=key)
    assert got.num_data == want.num_data
    assert got.global_num_data == want.global_num_data


@pytest.mark.parametrize("table", ["plain", "ranked"])
@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_equals_resident_shard_and_jax(tables, route, P, table):
    kind, suffix, extra = ROUTES[route]
    path = tables[table]["text" if kind == "text" else kind] + suffix
    rows = []
    for r in range(P):
        want = resident(tables, table, r, P)
        got = lgt.Dataset.load_train(port_io(path, **extra), rank=r,
                                     num_machines=P, device="cpu")
        assert_same_shard(got, want)
        assert got.shard_query_atomic == (table == "ranked")
        if kind == "text" and route != "two_round":
            assert got.bins is None and got.device_bins.device.type == "cpu"
        j = JDataset.load_train(jax_io(path, **extra), rank=r,
                                num_machines=P)
        # the JAX cache re-shard keeps no row indices (module docstring)
        assert_same_shard(j, want, None if kind == "text"
                          else want.used_data_indices)
        rows.append(got.used_data_indices)
    every = np.sort(np.concatenate(rows))
    np.testing.assert_array_equal(every, np.arange(N))


def test_in_file_query_column_cache_is_jax_reshard(tmp_path):
    """The known gap of the module docstring: a cache of an in-file query
    column re-shards query-atomically, as JAX ``_reshard_rows`` does,
    and so keeps other rows than the text routes' per-record draw."""
    text = write_csv(tmp_path / "qc.csv", qcolumn=True)
    cached = copy_table(text, str(tmp_path / "qc_n.csv"))
    extra = {"group_column": "name:q"}
    lgt.Dataset.load_train(port_io(cached, is_save_binary_file="true",
                                   **extra))
    qb = read_cache_header(cached + ".bin")[0]["query_boundaries"]
    assert qb is not None and qb.size > 100
    for r in range(2):
        got = lgt.Dataset.load_train(port_io(cached, **extra), rank=r,
                                     num_machines=2)
        j = JDataset.load_train(jax_io(cached, **extra), rank=r,
                                num_machines=2)
        want_rows = draw_shard(N, qb, port_io(cached).data_random_seed, r,
                               2)
        np.testing.assert_array_equal(got.used_data_indices, want_rows)
        assert got.shard_query_atomic
        assert np.asarray(j.bins).tobytes() == got.bins.tobytes()
        for key in ("label", "weights", "query_boundaries"):
            np.testing.assert_array_equal(getattr(got.metadata, key),
                                          getattr(j.metadata, key))
        # whole queries: the shard's boundaries are the cache's queries
        sizes = np.diff(qb)[np.unique(np.searchsorted(
            qb, want_rows, side="right") - 1)]
        np.testing.assert_array_equal(np.diff(got.metadata.query_boundaries),
                                      sizes)
        txt = lgt.Dataset.load_train(port_io(text, **extra), rank=r,
                                     num_machines=2)
        assert not txt.shard_query_atomic
        assert not np.array_equal(txt.used_data_indices, want_rows)


def test_jax_ranks_each_write_their_shard_c14(tmp_path):
    """ROADMAP C14, the JAX package's behaviour pinned: a rank that
    saves writes its own shard to ``<data>.bin`` (``num_data <
    global_num_data``), and the next rank re-shards that shard."""
    text = write_csv(tmp_path / "j.csv")
    r0 = JDataset.load_train(jax_io(text, is_save_binary_file="true"),
                             rank=0, num_machines=2)
    header = read_cache_header(text + ".bin")[0]
    assert header["num_data"] == r0.num_data < header["global_num_data"]
    assert header["global_num_data"] == N
    r1 = JDataset.load_train(jax_io(text, is_save_binary_file="true"),
                             rank=1, num_machines=2)
    # rank 1 found rank 0's shard and kept about half of it
    assert r1.num_data < header["num_data"]
    assert r1.num_data < N - r0.num_data


# one rank's program: join the world, then each job of the spec: load by
# its route (the rank's shard, the distributed bin finder), record the
# dataset, train unless told not to
WORKER = r'''
import hashlib, json, sys
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import parallel
from lightgbm_tpu_torch.config import OverallConfig
from lightgbm_tpu_torch.io import parallel_ingest
from lightgbm_tpu_torch.parallel import learners


def digest(a):
    return None if a is None else hashlib.sha256(a.tobytes()).hexdigest()


spec = json.load(open(sys.argv[1]))
parallel.init_distributed()
rank = parallel.get_rank()
out = {}
for job in spec["jobs"]:
    params = dict(spec["base"], **job["params"])
    cfg = OverallConfig()
    data = job["data"][rank] if isinstance(job["data"], list) else job["data"]
    cfg.set(dict(params, data=data))
    shard_rank, shards = learners.row_shard(cfg)
    rec = {}
    try:
        ds = lgt.Dataset.load_train(
            cfg.io_config, rank=shard_rank, num_machines=shards,
            device="cpu", bin_finder=learners.distributed_bin_finder()
            if cfg.is_parallel_find_bin else None)
        md = ds.metadata
        rec.update(rows=None if ds.used_data_indices is None
                   else ds.used_data_indices.tolist(),
                   bins=digest(ds.read_bins()), label=digest(md.label),
                   weights=digest(md.weights),
                   queries=None if md.query_boundaries is None
                   else md.query_boundaries.tolist(),
                   streamed=ds.bins is None, world_cache=ds.world_cache)
        if job.get("train", True):
            rec["model"] = lgt.train(params, ds,
                                     device="cpu").model_to_string()
    except Exception as e:
        if not job.get("expect_error"):
            raise
        rec["error"] = "%s: %s" % (type(e).__name__, e)
    out[job["name"]] = rec
parallel_ingest.shutdown_workers()
json.dump(out, open(spec["out"] % rank, "w"))
parallel.shutdown()
'''


def start_world(d, P, jobs, base):
    spec = {"base": dict(BASE, **COLUMNS, **base), "jobs": jobs,
            "out": str(d / "out.%d.json")}
    (d / "spec.json").write_text(json.dumps(spec))
    (d / "worker.py").write_text(WORKER)
    return World([sys.executable, "worker.py", "spec.json"], P, d)


def finish_world(world, d, P):
    for r, (rc, out) in enumerate(world.wait()):
        assert rc == 0, "rank %d failed:\n%s" % (r, out[-4000:])
    return [json.load(open(d / ("out.%d.json" % r))) for r in range(P)]


def serial_cache(d, src, name, **extra):
    """The cache a serial load of ``src``'s table writes, read back."""
    path = copy_table(src, str(d / name))
    lgt.Dataset.load_train(port_io(path, is_save_binary_file="true",
                                   **extra))
    with open(path + ".bin", "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """A 2-rank ``data`` world through every route, the cache writes,
    the checkpoint and the refusals; a hybrid 2 x 2 world beside it."""
    d = tmp_path_factory.mktemp("world")
    text = write_csv(d / "w.csv")
    for name in ("e", "h", "s", "f", "t", "m0", "m1", "p0", "p1", "pp"):
        copy_table(text, str(d / (name + ".csv")))
    write_csv(d / "q.csv", queries=True)
    write_csv(d / "qc.csv", qcolumn=True)
    for name, seed in (("p0", 11), ("p1", 12)):
        write_csv(d / (name + ".csv"), n=1200, seed=seed)
    lgt.Dataset.load_train(port_io(str(d / "m0.csv"),
                                   is_save_binary_file="true"))
    save = {"is_save_binary_file": "true"}
    p = lambda name: str(d / name)   # noqa: E731
    jobs = [
        {"name": "resident", "data": text, "params": dict(DP)},
        {"name": "streaming", "data": text,
         "params": dict(DP, **ROUTES["streaming"][2])},
        {"name": "workers", "data": text,
         "params": dict(DP, **ROUTES["workers"][2])},
        {"name": "two_round", "data": text,
         "params": dict(DP, **ROUTES["two_round"][2])},
        {"name": "save", "data": p("e.csv"), "params": dict(DP, **save)},
        {"name": "cache_direct", "data": p("e.csv.bin"), "params": DP},
        {"name": "cache_sibling", "data": p("e.csv"), "params": DP},
        {"name": "save_reference", "data": p("h.csv"),
         "params": dict(DP, **save, save_binary_format="reference",
                        **ROUTES["streaming"][2])},
        {"name": "reference_sibling", "data": p("h.csv"), "params": DP},
        {"name": "save_streamed", "data": p("s.csv"), "train": False,
         "params": dict(DP, **save, **ROUTES["workers"][2])},
        {"name": "save_two_round", "data": p("t.csv"), "train": False,
         "params": dict(DP, **save, **ROUTES["two_round"][2])},
        {"name": "save_feature", "data": p("f.csv"), "train": False,
         "params": dict(DP, **save, tree_learner="feature")},
        {"name": "save_queries", "data": p("q.csv"), "train": False,
         "params": dict(DP, **save)},
        {"name": "save_qcolumn", "data": p("qc.csv"), "train": False,
         "params": dict(DP, **save, group_column="name:q")},
        {"name": "ckpt_cache", "data": p("e.csv.bin"),
         "params": dict(DP, num_iterations="2", checkpoint_interval="1",
                        checkpoint_dir=p("ck"))},
        {"name": "resume_text", "data": text,
         "params": dict(DP, checkpoint_dir=p("ck"))},
        {"name": "pre_partition_save", "data": [p("p0.csv"), p("p1.csv")],
         "train": False, "params": dict(DP, **save,
                                        is_pre_partition="true")},
        {"name": "one_path", "data": p("pp.csv"), "expect_error": True,
         "params": dict(DP, **save, is_pre_partition="true")},
        {"name": "routes_differ", "data": [p("m0.csv"), p("m1.csv")],
         "expect_error": True,
         "params": dict(DP, is_pre_partition="true")},
    ]
    hybrid = dict(DP, tree_learner="hybrid", num_machines="4",
                  feature_shards="2")
    copy_table(text, str(d / "hy.csv"))
    lgt.Dataset.load_train(port_io(str(d / "hy.csv"),
                                   is_save_binary_file="true"))
    hd = d / "hybrid"
    hd.mkdir()
    w2 = start_world(hd, 4, [
        {"name": "resident", "data": text, "params": hybrid},
        {"name": "workers", "data": text,
         "params": dict(hybrid, **ROUTES["workers"][2])},
        {"name": "cache_direct", "data": p("hy.csv.bin"),
         "params": hybrid}], {})
    wd = d / "data"
    wd.mkdir()
    w1 = start_world(wd, 2, jobs, {})
    return d, finish_world(w1, wd, 2), finish_world(w2, hd, 4)


TRAINED = ["streaming", "workers", "two_round", "save", "cache_direct",
           "cache_sibling", "save_reference", "reference_sibling",
           "resume_text"]


@pytest.mark.parametrize("route", TRAINED)
def test_world_from_route_writes_resident_text(worlds, route):
    _, ranks, _ = worlds
    want = ranks[0]["resident"]["model"]
    for r, rank in enumerate(ranks):
        assert rank["resident"]["model"] == want
        assert rank[route]["model"] == want, "rank %d" % r
        if route != "resume_text":
            for key in ("rows", "bins", "label", "weights", "queries"):
                assert rank[route][key] == rank["resident"][key], key
    assert ranks[0]["streaming"]["streamed"]
    assert not ranks[0]["two_round"]["streamed"]


def test_world_routes_are_the_text_shards(worlds):
    _, ranks, _ = worlds
    rows = [rank["resident"]["rows"] for rank in ranks]
    assert sorted(rows[0] + rows[1]) == list(range(N))
    d = worlds[0]
    for r, rank in enumerate(ranks):
        want = lgt.Dataset.load_train(port_io(str(d / "w.csv")), rank=r,
                                      num_machines=2)
        assert rank["resident"]["rows"] == want.used_data_indices.tolist()


@pytest.mark.parametrize("route", ["workers", "cache_direct"])
def test_hybrid_world_from_route_writes_resident_text(worlds, route):
    _, _, ranks = worlds
    want = ranks[0]["resident"]["model"]
    for rank in ranks:
        assert rank[route]["model"] == want
        assert rank[route]["rows"] == rank["resident"]["rows"]
    # the ranks of a data index hold the same rows
    assert ranks[0]["workers"]["rows"] == ranks[1]["workers"]["rows"]
    assert ranks[0]["workers"]["rows"] != ranks[2]["workers"]["rows"]


@pytest.mark.parametrize("job,src,extra", [
    ("save", "e.csv", {}),
    ("save_reference", "h.csv", {"save_binary_format": "reference"}),
    ("save_streamed", "s.csv", {}),
    ("save_two_round", "t.csv", {}),
    ("save_feature", "f.csv", {}),
    ("save_queries", "q.csv", {}),
    ("save_qcolumn", "qc.csv", {"group_column": "name:q"}),
])
def test_world_writes_the_serial_cache_c14(worlds, job, src, extra,
                                           tmp_path):
    """One cache, rank 0's, byte-equal to the serial run's, no temp file
    left; a serial run from it holds the whole table."""
    d, ranks, _ = worlds
    path = str(d / src) + ".bin"
    assert glob.glob(path + "*") == [path]
    with open(path, "rb") as f:
        assert f.read() == serial_cache(tmp_path, str(d / src), src,
                                        **extra)
    if job != "save_reference":
        assert read_cache_header(path)[0]["num_data"] == N
    whole = lgt.Dataset.load_train(port_io(str(d / src), **extra))
    assert whole.num_data == whole.global_num_data == N
    stats = ranks[0][job]["world_cache"]
    if job == "save_feature":
        assert ranks[1][job]["rows"] is None
    assert stats["gather_bytes"] > 0 and ranks[1][job]["world_cache"] is None


def test_pre_partition_world_writes_each_rank_file(worlds):
    """Each rank's own file's cache holds that rank's dataset (its file's
    rows, the world's mappers)."""
    d, ranks, _ = worlds
    for r, name in enumerate(("p0.csv", "p1.csv")):
        path = str(d / name) + ".bin"
        assert glob.glob(path + "*") == [path]
        got = lgt.Dataset.load_train(port_io(path))
        rec = ranks[r]["pre_partition_save"]
        assert got.num_data == got.global_num_data == 1200
        assert rec["rows"] is None
        assert hashlib.sha256(got.bins.tobytes()).hexdigest() == rec["bins"]
        assert hashlib.sha256(got.metadata.label.tobytes()).hexdigest() \
            == rec["label"]


def test_world_refusals(worlds):
    d, ranks, _ = worlds
    for rank in ranks:
        assert "ranks name one cache path" in rank["one_path"]["error"]
        assert "different load routes" in rank["routes_differ"]["error"]
        assert "rank 0 native cache, rank 1 resident text" in \
            rank["routes_differ"]["error"]
    assert not os.path.exists(str(d / "m1.csv.bin"))


def test_cache_world_checkpoint_is_serial_order(worlds, tmp_path):
    """A world from a cache checkpoints in serial row order: no
    ``row_order: rank``; the text world resumed it to the unbroken text
    (above), and a serial run from text resumes it too."""
    d, ranks, _ = worlds
    files = ckpt.list_checkpoints(str(d / "ck"))
    payload = ckpt.load_checkpoint(files[-1])
    topo = payload["topology"]
    assert "row_order" not in topo
    assert topo["process_count"] == 2 and payload["iteration"] == 2
    ck = tmp_path / "ck"
    shutil.copytree(str(d / "ck"), str(ck))
    params = dict(BASE, **COLUMNS, hist_dtype="int8",
                  checkpoint_dir=str(ck))
    ds = lgt.Dataset.load_train(port_io(str(d / "w.csv")))
    text = lgt.train(params, ds, device="cpu").model_to_string()
    assert text == ranks[0]["resident"]["model"]
