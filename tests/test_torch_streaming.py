"""Two-round, streamed and worker loads: lightgbm_tpu_torch (device="cpu")
against its own resident load and against lightgbm_tpu.

- streamed serial, ``ingest_workers=2`` and two-round loads give the
  resident dataset bit for bit (mappers, bin bytes, metadata), at 60,000
  rows (above the 50,000-row binning sample, so the pinned draw
  matters) and at chunk sizes that split queries, with the label
  mid-file and in-file weight and query columns;
- each is the JAX package's resident and streamed dataset; the JAX
  package's two-round loader draws another sample above 50,000 rows
  (ROADMAP C5) and agrees below it;
- the streamed cache is byte-equal to the resident one and to the JAX
  package's;
- a streamed dataset trains to the resident model text, packed
  (``mixed_bin=auto``) through the device gather; continued training
  scores each chunk;
- the byte-range helpers are the JAX package's; the worker pool is
  reaped and leaves no ``lifecycle`` entry; the workers' parser tiers
  reach the parent's counts.

Tolerance: none.
"""
import filecmp
import os

import numpy as np
import pytest
import torch

from lightgbm_tpu.config import IOConfig as JIOConfig
from lightgbm_tpu.io import parser as jparser
from lightgbm_tpu.io import streaming as jstreaming
from lightgbm_tpu.io.dataset import Dataset as JDataset

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import lifecycle
from lightgbm_tpu_torch.config import IOConfig
from lightgbm_tpu_torch.io import parallel_ingest
from lightgbm_tpu_torch.io import parser as tparser
from lightgbm_tpu_torch.io import streaming
from lightgbm_tpu_torch.io.dataset import pinned_sample_indices
from lightgbm_tpu_torch.utils import log

from test_torch_ingest_columns import assert_same_dataset

COLUMNS = {"has_header": True, "label_column": "name:y",
           "weight_column": "name:w", "group_column": "name:q",
           "ignore_column": "name:z"}


@pytest.fixture(autouse=True)
def reaped_workers():
    """Every test ends with the worker pool reaped and nothing live."""
    yield
    parallel_ingest.shutdown_workers()
    leaked = lifecycle.leaks()
    for _kind, _name, closer in leaked:
        closer()
    assert not leaked, "left live: %s" % [(k, n) for k, n, _ in leaked]


def write_big(path, n=60_000, seed=3, qlen=37):
    """a, b, y (label mid-file), w, q (queries of ``qlen`` rows), z
    (ignored), c, d (narrow: 5 values, so the set packs)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4)
    y = (x[:, 0] + 0.6 * x[:, 1] + 0.5 * rng.randn(n) > 0).astype(int)
    w = 0.25 + rng.rand(n)
    q = np.arange(n) // qlen
    d = rng.randint(0, 5, n)
    with open(path, "w") as f:
        f.write("a,b,y,w,q,z,c,d\n")
        for i in range(n):
            f.write("%.6f,%.6f,%d,%.4f,%d,%.3f,%.6f,%d\n" % (
                x[i, 0], x[i, 1], y[i], w[i], q[i], x[i, 3], x[i, 2], d[i]))
    return str(path)


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    d = tmp_path_factory.mktemp("big")
    path = write_big(d / "big.csv")
    resident = lgt.Dataset.load_train(IOConfig(data_filename=path,
                                               streaming="false", **COLUMNS))
    return path, resident


ROUTES = {
    "streamed": {"streaming": "true", "ingest_chunk_rows": 7001},
    "streamed-one-chunk": {"streaming": "true"},
    "workers-2": {"streaming": "true", "ingest_workers": 2,
                  "ingest_chunk_rows": 5003},
    "workers-3": {"streaming": "true", "ingest_workers": 3,
                  "ingest_chunk_rows": 20000},
    "two-round": {"streaming": "false", "use_two_round_loading": True,
                  "ingest_chunk_rows": 6007},
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_equals_resident(big, route):
    path, resident = big
    ds = lgt.Dataset.load_train(
        IOConfig(data_filename=path, **COLUMNS, **ROUTES[route]),
        device="cpu")
    assert_same_dataset(resident, ds)
    assert ds.global_num_data == 60_000
    if route == "two-round":
        assert ds.bins is not None and ds.device_bins is None
    else:
        assert ds.bins is None and ds.device_bins.device.type == "cpu"
        assert ds.ingest_writer.h2d_bytes == resident.bins.nbytes


def test_resident_equals_jax_resident_and_streamed(big):
    path, resident = big
    j = JDataset.load_train(JIOConfig(data_filename=path, streaming="false",
                                      **COLUMNS))
    assert_same_dataset(j, resident)
    js = JDataset.load_train(JIOConfig(data_filename=path, streaming="true",
                                       ingest_chunk_rows=9000, **COLUMNS))
    assert_same_dataset(js, resident)


def test_c5_jax_two_round_sample_differs_above_50k(big):
    """ROADMAP C5: the JAX package's two-round loader bins from an
    algorithm-R reservoir; above 50,000 rows its mappers are not the
    resident ones.  The port's two-round load is the resident load."""
    path, resident = big
    j2 = JDataset.load_train(JIOConfig(data_filename=path, streaming="false",
                                       use_two_round_loading=True,
                                       **COLUMNS))
    assert [m.to_bytes() for m in j2.bin_mappers] != \
        [m.to_bytes() for m in resident.bin_mappers]
    np.testing.assert_array_equal(j2.metadata.label,
                                  resident.metadata.label)


def test_two_round_equals_jax_two_round_below_50k(tmp_path):
    path = write_big(tmp_path / "small.csv", n=9000, qlen=11)
    kw = dict(COLUMNS, streaming="false", use_two_round_loading=True)
    j = JDataset.load_train(JIOConfig(data_filename=path, **kw))
    t = lgt.Dataset.load_train(IOConfig(data_filename=path,
                                        ingest_chunk_rows=1000, **kw))
    assert_same_dataset(j, t)


def test_pinned_sample_is_jax_draw():
    for n, seed in ((50_000, 1), (50_001, 1), (123_457, 9)):
        a = pinned_sample_indices(n, seed)
        b = jstreaming.pinned_sample_indices(n, seed, 50_000)
        assert (a is None and b is None) or np.array_equal(a, b)


@pytest.mark.parametrize("workers", [1, 2])
def test_streamed_cache_byte_equal(tmp_path, workers):
    """The cache pass 2 streams out is the resident cache, and the JAX
    package's streamed one."""
    path = write_big(tmp_path / "c.csv", n=8000, qlen=13)
    kw = dict(COLUMNS, is_save_binary_file=True, ingest_chunk_rows=999)
    lgt.Dataset.load_train(IOConfig(data_filename=path, streaming="false",
                                    **kw))
    os.replace(path + ".bin", str(tmp_path / "resident.bin"))
    lgt.Dataset.load_train(IOConfig(data_filename=path, streaming="true",
                                    ingest_workers=workers, **kw),
                           device="cpu")
    os.replace(path + ".bin", str(tmp_path / "streamed.bin"))
    JDataset.load_train(JIOConfig(data_filename=path, streaming="true",
                                  **kw))
    assert filecmp.cmp(str(tmp_path / "resident.bin"),
                       str(tmp_path / "streamed.bin"), shallow=False)
    assert filecmp.cmp(path + ".bin", str(tmp_path / "streamed.bin"),
                       shallow=False)


def _model_text(params, ds):
    return lgt.train(params, ds, device="cpu").model_to_string()


def test_streamed_packed_model_equals_resident(tmp_path):
    """Narrow and wide features: the booster packs a streamed matrix by
    a device gather, releases the original, and trains the resident
    model; a second booster on the consumed dataset is a Fatal."""
    path = write_big(tmp_path / "p.csv", n=4000, qlen=20)
    kw = dict(COLUMNS, label_column="name:y", group_column="",
              ignore_column="name:q")
    resident = lgt.Dataset.load_train(IOConfig(data_filename=path,
                                               streaming="false", **kw))
    streamed = lgt.Dataset.load_train(IOConfig(data_filename=path,
                                               streaming="true",
                                               ingest_chunk_rows=777, **kw),
                                      device="cpu")
    assert resident.plan_packing("auto") is not None
    params = {"objective": "binary", "num_leaves": 15, "num_iterations": 3,
              "min_data_in_leaf": 20, "mixed_bin": "auto"}
    want = _model_text(params, resident)
    assert _model_text(params, streamed) == want
    assert streamed.device_bins is None and streamed.device_bins_consumed
    with pytest.raises(log.Fatal, match="consumed"):
        lgt.train(params, streamed, device="cpu")
    # unpacked, the streamed matrix serves booster after booster
    again = lgt.Dataset.load_train(IOConfig(data_filename=path,
                                            streaming="true", **kw),
                                   device="cpu")
    params["mixed_bin"] = "false"
    assert _model_text(params, again) == _model_text(params, resident)
    assert _model_text(params, again) == _model_text(params, resident)


@pytest.mark.parametrize("route", ["streamed", "workers-2", "two-round"])
def test_continued_training_scores_each_chunk(tmp_path, route):
    path = write_big(tmp_path / "k.csv", n=3000, qlen=10)

    def predict_fun(feats):
        return feats[:, 0] * 0.5 - feats[:, 1]

    resident = lgt.Dataset.load_train(
        IOConfig(data_filename=path, streaming="false", **COLUMNS),
        predict_fun)
    kw = dict(ROUTES[route], ingest_chunk_rows=701)
    ds = lgt.Dataset.load_train(IOConfig(data_filename=path, **COLUMNS,
                                         **kw), predict_fun, device="cpu")
    assert ds.metadata.init_score.dtype == np.float32
    np.testing.assert_array_equal(ds.metadata.init_score,
                                  resident.metadata.init_score)


def test_streaming_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    path = write_big(tmp_path / "n.csv", n=500)
    io = IOConfig(data_filename=path, streaming="true", **COLUMNS)
    with pytest.raises(log.Fatal, match="no CUDA device"):
        lgt.Dataset.load_train(io)
    assert lgt.Dataset.load_train(io, device="cpu").num_data == 500


def test_worker_pool_reaped_and_tiers_counted(tmp_path):
    path = write_big(tmp_path / "w.csv", n=6000, qlen=7)
    before = dict(tparser.tier_calls)
    lgt.Dataset.load_train(IOConfig(data_filename=path, streaming="true",
                                    ingest_workers=2,
                                    ingest_chunk_rows=1000, **COLUMNS),
                           device="cpu")
    procs = [w.proc for w in parallel_ingest._POOL.workers]
    assert len(procs) == 2 and all(p.poll() is None for p in procs)
    assert [k for k, _, _ in lifecycle.leaks()] == ["ingest_workers"]
    # a second load reuses the live workers
    lgt.Dataset.load_train(IOConfig(data_filename=path, streaming="true",
                                    ingest_workers=2, **COLUMNS),
                           device="cpu")
    assert [w.proc for w in parallel_ingest._POOL.workers] == procs
    after = tparser.tier_calls
    parsed = sum(after[k] - before[k] for k in after)
    assert parsed >= 12    # every range of pass 2, twice, in workers
    parallel_ingest.shutdown_workers()
    assert all(p.wait(timeout=10) == 0 for p in procs)
    assert not lifecycle.leaks()


def test_worker_error_surfaces_and_pool_recovers(tmp_path):
    """A ragged row inside a worker's range: the exact tier's Fatal comes
    back as the worker's error, and the next load works."""
    path = str(tmp_path / "r.csv")
    with open(path, "w") as f:
        for i in range(3000):
            f.write("1,2,3\n" if i != 2500 else "1,2\n")
    with pytest.raises(RuntimeError, match="input format error"):
        lgt.Dataset.load_train(IOConfig(data_filename=path,
                                        streaming="true", ingest_workers=2,
                                        ingest_chunk_rows=500),
                               device="cpu")
    good = write_big(tmp_path / "g.csv", n=2000)
    ds = lgt.Dataset.load_train(IOConfig(data_filename=good,
                                         streaming="true", ingest_workers=2,
                                         **COLUMNS), device="cpu")
    assert ds.num_data == 2000


def _crlf_file(path):
    rows = ["h1,h2\r\n"] + ["%d,%d%s" % (i, i * 3, "\r\n" if i % 3 else "\n")
                           for i in range(400)]
    rows.insert(50, "\r\n\n")
    rows.insert(200, "\r")
    with open(path, "wb") as f:
        f.write("".join(rows).encode())
        f.write(b"7,8")     # no final newline
    return str(path)


@pytest.mark.parametrize("skip_header", [False, True])
def test_byte_ranges_match_jax(tmp_path, skip_header):
    path = _crlf_file(tmp_path / "crlf.csv")
    assert tparser.data_byte_start(path, skip_header) == \
        jparser.data_byte_start(path, skip_header)
    assert tparser.count_data_rows(path, skip_header) == \
        jparser.count_data_rows(path, skip_header)
    for k in (1, 3, 7, 40):
        got = tparser.split_byte_ranges(path, k, skip_header)
        assert got == jparser.split_byte_ranges(path, k, skip_header)
        lines = [ln for s, e in got[0]
                 for ln in tparser.read_range_lines(path, s, e)]
        assert lines == tparser.read_lines(path, skip_header)
    cands = list(range(0, os.path.getsize(path) + 5, 97))
    assert tparser.split_byte_ranges_at(path, cands, skip_header) == \
        jparser.split_byte_ranges_at(path, cands, skip_header)
    assert parallel_ingest.plan_ranges(path, skip_header, 3, 50) == \
        _jax_plan(path, skip_header, 3, 50)


def _jax_plan(path, skip_header, workers, chunk_rows):
    from lightgbm_tpu.io import parallel_ingest as jpi
    return jpi.plan_ranges(path, skip_header, workers, chunk_rows)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("depth", [0, 2])
def test_row_writer_on_cpu(dtype, depth):
    """The writer's CPU target: odd chunk tails land in place, 8- and
    16-bit bins (the card's cases are in test_torch_cuda.py)."""
    rng = np.random.RandomState(depth)
    hi = 256 if dtype == np.uint8 else 65536
    want = rng.randint(0, hi, (5, 1003)).astype(dtype)
    w = streaming.DeviceRowWriter(5, 1003, dtype, torch.device("cpu"),
                                  depth=depth)
    for s in range(0, 1003, 250):
        w.append(np.ascontiguousarray(want[:, s:s + 250]), s)
    got = w.finish().numpy()
    if dtype == np.uint16:
        got = got.view(np.uint16)
    np.testing.assert_array_equal(got, want)
    assert w.h2d_bytes == want.nbytes
