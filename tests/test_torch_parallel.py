"""The data-parallel learner: lightgbm_tpu_torch worlds of 2 and 3 ranks
(gloo, one process a rank, on the CPU) against the port's serial run and
the JAX package's live serial and ``tree_learner=data`` runs (the
8-device virtual CPU mesh of tests/conftest.py).

Each world runs in subprocesses (``World``, at most WORLD_TIMEOUT s,
killed on expiry), so no pytest process joins a process group; one world
trains every configuration of a file in turn and writes each rank's
model text.

Tolerances:
- int8, both schedules, all three growers: model text byte-equal to the
  port's serial run (the pass maxima MAX-reduced before quantizing, the
  int32 accumulators SUM-reduced before dequantizing); against the JAX
  runs structure exact and leaf values rtol 1e-5 / atol 5e-7, the
  GBDT-level budget of tests/test_torch_gbdt.py (int8 leaf values of
  the two packages differ in the last bit, ROADMAP C, and the scores
  drift from there);
- float32: structure exact, leaf values rtol 1e-5 / atol F32_ATOL
  against the port's serial run and the JAX ``tree_learner=data`` run.
  On the CPU each rank's histogram is an f32 ``index_add_`` over its
  own rows, added across ranks, so its sums associate otherwise than
  the serial run's; at a leaf whose gradient sum cancels this reaches a
  few 1e-6 absolute.  On this table the port's serial run and the JAX
  package's serial run already differ by 2.8e-6 at one such leaf (rtol
  2.3e-5), so F32_ATOL is 5e-6, ten times the 5e-7 of
  tests/test_grower_unified.py:100-114, which that file's table meets;
- every rank's model text is byte-equal to every other rank's.
"""
import json
import os
import sys

import numpy as np
import pytest

from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.objectives import create_objective as jcreate
from lightgbm_tpu.parallel import learners as jlearners
from lightgbm_tpu.parallel import create_parallel_learner as jparallel

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops.split import SplitResult
from lightgbm_tpu_torch.parallel import learners, mesh
from lightgbm_tpu_torch.parallel.launch import LocalWorld, WorldTimeout
from lightgbm_tpu_torch.utils import log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 120
BASE = {"objective": "binary", "num_leaves": "15",
        "min_data_in_leaf": "20", "min_sum_hessian_in_leaf": "1.0",
        "learning_rate": "0.2", "num_iterations": "3", "max_bin": "32"}
GROWERS = {"compacted": {"leafwise_compact": "true"},
           "masked": {"leafwise_compact": "false"},
           "depthwise": {"grow_policy": "depthwise"}}
STRUCTURE = ("split_feature_real", "threshold", "left_child",
             "right_child", "leaf_parent")
F32_ATOL = 5e-6       # module docstring

# one rank's program: join the world, train each job of the spec on the
# rank's rows (its shard under tree_learner=data), write what was asked
WORKER = r'''
import json, sys
import numpy as np
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import parallel
from lightgbm_tpu_torch.config import OverallConfig
from lightgbm_tpu_torch.parallel import learners

spec = json.load(open(sys.argv[1]))
parallel.init_distributed()
rank, P = parallel.get_rank(), parallel.get_num_machines()
out = {}
for job in spec["jobs"]:
    params = dict(spec["base"], **job["params"])
    cfg = OverallConfig()
    cfg.set(dict(params, data=job.get("data", spec["data"])))
    # the rank's row draw: its own under data, its data index's under
    # hybrid and voting (a file each under is_pre_partition), every row
    # under feature
    shard_rank, shards = learners.row_shard(cfg)
    if "data_by_shard" in job:
        cfg.io_config.data_filename = job["data_by_shard"][shard_rank]
    shard = cfg.is_parallel_find_bin
    ds = lgt.Dataset.load_train(
        cfg.io_config, rank=shard_rank, num_machines=shards,
        bin_finder=learners.distributed_bin_finder() if shard else None)
    if job.get("telemetry"):
        from lightgbm_tpu_torch import telemetry
        telemetry.enable()
    booster = lgt.train(params, ds, device="cpu")
    if job.get("telemetry"):
        snap = telemetry.snapshot()
        telemetry.disable()
        telemetry.reset()
    rec = {"model": booster.model_to_string(), "rows": int(ds.num_data),
           "num_leaves": [int(t.num_leaves) for t in booster.models]}
    if ds.used_data_indices is not None:
        rec["indices"] = ds.used_data_indices.tolist()
    if "bagging_fraction" in params:
        rec["bag_mask"] = booster._bag_mask.cpu().numpy().tolist()
    if job.get("telemetry"):
        rec["sites"] = snap["interconnect"]["sites"]
        rec["counters"] = snap["counters"]
    if job.get("bin_finder"):
        sample = np.loadtxt(cfg.io_config.data_filename)[:, 1:]
        found = learners.distributed_bin_finder()(
            sample, cfg.io_config.max_bin)
        rec["mappers"] = [m.to_bytes().hex() for m in found]
    out[job["name"]] = rec
json.dump(out, open(spec["out"] % rank, "w"))
parallel.shutdown()
'''


class World:
    """``argv`` as ranks 0..P-1 of one gloo world (parallel/launch.
    LocalWorld: torch's environment variables, each rank's output in
    ``rank<r>.log`` under ``cwd``); ``wait`` gives the world ``timeout``
    s from its start, then kills it and fails the test."""

    def __init__(self, argv, P: int, cwd, timeout: float = WORLD_TIMEOUT,
                 env=None):
        # one intra-op thread a rank: P ranks of a core count's threads
        # each oversubscribe the host several times over (a 4-rank world
        # of the hybrid tests took 60 s so, 9 s with one thread a rank)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
            **dict({"OMP_NUM_THREADS": "1"}, **(env or {})))
        self.P = P
        self.world = LocalWorld(argv, P, str(cwd), timeout, env)

    def wait(self):
        """Each rank's (exit code, output)."""
        try:
            return self.world.wait()
        except WorldTimeout as e:
            pytest.fail(str(e))


def write_table(path, n=4000, f=8, seed=7, queries=False):
    """A seeded binary table as TSV, label in column 0; returns (x, y)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f)
    y = ((x[:, 0] - 0.6 * x[:, 1] + 0.25 * x[:, 2]
          + 0.3 * rng.randn(n)) > 0).astype(np.float64)
    np.savetxt(path, np.column_stack([y, x]), delimiter="\t", fmt="%.17g")
    return x, y.astype(np.float32)


class TrainWorld:
    """Every job of ``jobs`` ({"name", "params"}) trained in one world of
    P ranks, started now; ``result()`` waits: [rank] -> {name: record}."""

    def __init__(self, tmp_path, P: int, jobs, data, base=BASE):
        self.out = str(tmp_path / "out.%d.json")
        spec = {"base": base, "data": str(data), "jobs": jobs,
                "out": self.out}
        (tmp_path / "spec.json").write_text(json.dumps(spec))
        (tmp_path / "worker.py").write_text(WORKER)
        self.world = World([sys.executable, "worker.py", "spec.json"], P,
                           tmp_path)
        self._result = None

    def result(self):
        if self._result is None:
            for r, (rc, out) in enumerate(self.world.wait()):
                assert rc == 0, "rank %d failed:\n%s" % (r, out[-4000:])
            self._result = [json.load(open(self.out % r))
                            for r in range(self.world.P)]
        return self._result


def train_world(tmp_path, P: int, jobs, data, base=BASE):
    """``TrainWorld(...).result()``."""
    return TrainWorld(tmp_path, P, jobs, data, base).result()


def port_serial(params, data) -> str:
    """The port's serial model text of ``params`` on the TSV ``data``."""
    cfg = lgt.OverallConfig()
    cfg.set(dict(BASE, **params, data=str(data)))
    ds = lgt.Dataset.load_train(cfg.io_config)
    return lgt.train(dict(BASE, **params), ds, device="cpu") \
        .model_to_string()


def jax_booster(params, x, y, num_machines: int = 1):
    """The JAX package's booster, serial or the parallel learner that
    ``params`` name over ``num_machines`` virtual devices."""
    p = dict(BASE, **params)
    if num_machines > 1:
        p["num_machines"] = str(num_machines)
    cfg = JConfig()
    cfg.set(p, require_data=False)
    learner = jparallel(cfg) if cfg.is_parallel else None
    booster = JGBDT()
    booster.init(cfg.boosting_config,
                 JDataset.from_arrays(x, y, max_bin=int(BASE["max_bin"])),
                 jcreate(cfg.objective_type, cfg.objective_config),
                 learner=learner)
    for _ in range(int(BASE["num_iterations"])):
        if booster.train_one_iter(is_eval=False):
            break
    return booster


def trees_of(model):
    """A model's trees: a port model text or a JAX booster."""
    if isinstance(model, str):
        b = lgt.GBDT()
        b.models_from_string(model)
        return b.models
    return model.models


def assert_alike(got, want, rtol=1e-5, atol=0.0):
    a, b = trees_of(got), trees_of(want)
    assert len(a) == len(b)
    for k, (ta, tb) in enumerate(zip(a, b)):
        assert ta.num_leaves == tb.num_leaves, "tree %d" % k
        for field in STRUCTURE:
            np.testing.assert_array_equal(getattr(ta, field),
                                          getattr(tb, field),
                                          err_msg="tree %d %s" % (k, field))
        np.testing.assert_allclose(ta.leaf_value, tb.leaf_value, rtol=rtol,
                                   atol=atol, err_msg="tree %d" % k)


def _dp_jobs(dtypes, growers=tuple(GROWERS)):
    return [{"name": "%s-%s-%s" % (g, d, s),
             "params": dict(GROWERS[g], hist_dtype=d, tree_learner="data",
                            num_machines="8", dp_schedule=s)}
            for g in growers for d in dtypes
            for s in ("psum", "reduce_scatter")]


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    path = tmp_path_factory.mktemp("table") / "train.tsv"
    x, y = write_table(path)
    return path, x, y


@pytest.fixture(scope="module")
def started(table, tmp_path_factory):
    """The worlds, started before the JAX runs so that they overlap:
    every grower and schedule in int8 at 2 and 3 ranks (F = 8 over 3
    ranks pads the last ownership block), in float32 at 2, and a
    stopping configuration; num_machines=8 shrinks to the world."""
    path = table[0]
    stop = [{"name": "stop-%s" % g,
             "params": dict(GROWERS[g], hist_dtype="int8",
                            tree_learner="data", num_machines="2",
                            num_leaves="31", min_data_in_leaf="400")}
            for g in GROWERS]
    armed = [{"name": "telemetry-%s-%s" % (d, sch), "telemetry": True,
              "params": dict(hist_dtype=d, tree_learner="data",
                             num_machines="2", dp_schedule=sch)}
             for d, sch in (("float32", "psum"), ("int8", "reduce_scatter"))]
    return {2: TrainWorld(tmp_path_factory.mktemp("w2"), 2,
                          _dp_jobs(("int8", "float32")) + stop + armed,
                          path),
            3: TrainWorld(tmp_path_factory.mktemp("w3"), 3,
                          _dp_jobs(("int8",)), path)}


@pytest.fixture(scope="module")
def worlds(started, jax_runs, serial):
    """{P: [rank] -> {job: record}}."""
    return {P: w.result() for P, w in started.items()}


@pytest.fixture(scope="module")
def serial(table):
    """The port's serial model text per (grower, dtype)."""
    return {(g, d): port_serial(dict(GROWERS[g], hist_dtype=d), table[0])
            for g in GROWERS for d in ("int8", "float32")}


@pytest.fixture(scope="module")
def jax_runs(table, started):
    """JAX serial (int8) and tree_learner=data at 2 and 3 devices (int8)
    and at 2 (float32), per grower."""
    _, x, y = table
    out = {}
    for g in GROWERS:
        out[g, "int8", 1] = jax_booster(dict(GROWERS[g], hist_dtype="int8"),
                                        x, y)
        for P in (2, 3):
            out[g, "int8", P] = jax_booster(
                dict(GROWERS[g], hist_dtype="int8", tree_learner="data"),
                x, y, P)
        out[g, "float32", 2] = jax_booster(
            dict(GROWERS[g], hist_dtype="float32", tree_learner="data"),
            x, y, 2)
    return out


@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("schedule", ["psum", "reduce_scatter"])
@pytest.mark.parametrize("grower", list(GROWERS))
def test_int8_data_parallel_byte_equal_serial(worlds, serial, P, schedule,
                                              grower):
    name = "%s-int8-%s" % (grower, schedule)
    texts = [rank[name]["model"] for rank in worlds[P]]
    assert all(t == texts[0] for t in texts), "ranks disagree"
    assert texts[0] == serial[grower, "int8"]
    assert sum(rank[name]["rows"] for rank in worlds[P]) == 4000


@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("schedule", ["psum", "reduce_scatter"])
@pytest.mark.parametrize("grower", list(GROWERS))
def test_int8_data_parallel_matches_jax(worlds, jax_runs, P, schedule,
                                        grower):
    text = worlds[P][0]["%s-int8-%s" % (grower, schedule)]["model"]
    assert_alike(text, jax_runs[grower, "int8", 1], atol=5e-7)
    assert_alike(text, jax_runs[grower, "int8", P], atol=5e-7)


@pytest.mark.parametrize("schedule", ["psum", "reduce_scatter"])
@pytest.mark.parametrize("grower", list(GROWERS))
def test_float32_data_parallel_matches_serial_and_jax(worlds, serial,
                                                      jax_runs, schedule,
                                                      grower):
    name = "%s-float32-%s" % (grower, schedule)
    texts = [rank[name]["model"] for rank in worlds[2]]
    assert texts[0] == texts[1], "ranks disagree"
    assert_alike(texts[0], serial[grower, "float32"], atol=F32_ATOL)
    assert_alike(texts[0], jax_runs[grower, "float32", 2], atol=F32_ATOL)


@pytest.mark.parametrize("grower", list(GROWERS))
def test_early_stop_agrees_across_ranks(worlds, table, grower):
    """The best-first loop stops on ``best_gain > 0`` and the depth-wise
    one on no chosen slot, each rank on its own copy of the agreed
    records: with min_data_in_leaf=400 every tree stops short of its 31
    leaves, at the same split on both ranks, as the serial run does."""
    rec = [rank["stop-%s" % grower] for rank in worlds[2]]
    assert rec[0]["model"] == rec[1]["model"]
    assert rec[0]["num_leaves"] == rec[1]["num_leaves"]
    assert max(rec[0]["num_leaves"]) < 31
    assert rec[0]["model"] == port_serial(
        dict(GROWERS[grower], hist_dtype="int8", num_leaves="31",
             min_data_in_leaf="400"), table[0])


@pytest.mark.parametrize("dtype,schedule", [("float32", "psum"),
                                            ("int8", "reduce_scatter")])
def test_collective_sites(worlds, table, dtype, schedule):
    """Each collective a rank ran files its JAX site name with its calls
    and the payload it sent (a histogram F*B*3*4 bytes, B the table's
    widest feature's bins; the health vector's sites beside them,
    ``split_health_sites``), and the route counters summed over the
    ranks land under ``allhosts/``."""
    cfg = lgt.OverallConfig()
    cfg.set(dict(BASE, data=str(table[0])))
    ds = lgt.Dataset.load_train(cfg.io_config)
    F, B = ds.num_features, int(ds.num_bins.max())
    for rec in (rank["telemetry-%s-%s" % (dtype, schedule)]
                for rank in worlds[2]):
        leaves = rec["num_leaves"]
        splits, trees = sum(leaves) - len(leaves), len(leaves)
        sites = split_health_sites(rec["sites"], trees, dtype == "int8")
        if schedule == "psum":
            pre = "dp_psum/leafcompact/"
            want = {pre + "hist_allreduce": (splits, F * B * 12),
                    pre + "root_hist": (trees, F * B * 12),
                    pre + "root_stats": (trees, 24)}
        else:
            pre = "dp_rs/leafcompact/"
            want = {pre + "hist_scatter": (splits, F * B * 12),
                    pre + "root_hist": (trees, F * B * 12),
                    pre + "splitinfo_allreduce": (trees + splits, 88),
                    "hist/quant_scale_pmax": (trees + splits, 8)}
        assert set(sites) == set(want)
        for site, (calls, per_call) in want.items():
            assert sites[site]["calls"] == calls, site
            assert sites[site]["bytes_per_call"] == per_call, site
            assert sites[site]["phase"] == "grow"
        counters = rec["counters"]
        plain = counters["hist/plain_pane"] + counters["hist/plain_float"] \
            if dtype == "float32" else counters["hist/plain_int8"]
        assert plain == sum(leaves)
        assert counters["allhosts/partition/plain"] == \
            2 * counters["partition/plain"]


def split_health_sites(sites, iterations, int8):
    """``sites`` without the health vector's, once those are checked: the
    world's vector (health.py, 3) makes one call of each site an
    iteration over the data axis in the ``model_readback`` span (the
    counts 24 bytes, the watermark 4), and the int8 gauge two more (its
    scales' maxima and its counts, 8 bytes each)."""
    want = {"health/vector_psum": 24, "health/score_pmax": 4}
    if int8:
        want.update({"health/quant_sat_pmax": 8,
                     "health/quant_sat_reduce": 8})
    got = {k: v for k, v in sites.items() if k.startswith("health/")}
    assert set(got) == set(want)
    for site, per_call in want.items():
        v = got[site]
        assert (v["calls"], v["bytes_per_call"], v["axis"], v["phase"]) \
            == (iterations, per_call, "data", "model_readback"), site
    return {k: v for k, v in sites.items() if k not in got}


class _StackComm:
    """A world's ``all_gather`` played back from given per-rank records."""

    def __init__(self, stack):
        self.stack = stack

    def all_gather(self, t, site, axis="data"):
        assert t.shape == self.stack.shape[1:]
        return self.stack


def _record(gain, feature):
    import torch
    vals = [gain, feature, 3, 0.5, -0.5, 10, 20, 1.0, 2.0, 3.0, 4.0]
    return torch.tensor(vals, dtype=torch.float32)


@pytest.mark.parametrize("gains,features,want", [
    ((1.0, 1.0), (5, 2), 2),            # a tie: the smaller feature
    ((1.0, 1.0, 1.0), (7, 4, 6), 4),
    ((2.0, 3.0), (1, 6), 6),            # the larger gain
    ((float("-inf"), float("-inf")), (3, 1), 3),   # none: rank 0's
])
def test_allreduce_best_split_ties(gains, features, want):
    import torch
    stack = torch.stack([_record(g, f) for g, f in zip(gains, features)])
    local = learners.unpack_split(stack[0])
    got = learners.allreduce_best_split(local, _StackComm(stack), "t")
    assert int(got.feature) == want
    assert isinstance(got, SplitResult)
    # a batch of records reduces elementwise (no gain: rank 0's record)
    batch = torch.stack([stack, stack.flip(0)], 1)            # [P, 2, 11]
    got2 = learners.allreduce_best_split(
        learners.unpack_split(batch[0]), _StackComm(batch), "t")
    flipped = want if np.isfinite(max(gains)) else features[-1]
    assert got2.feature.tolist() == [want, flipped]


@pytest.mark.parametrize("num_bins,shards", [
    ([32, 5, 17, 32, 9, 2, 30, 11], 2),
    ([32, 5, 17, 32, 9, 2, 30, 11], 3),
    ([4, 4, 4, 4, 4], 2),
    (list(range(2, 23)), 4),
])
def test_ownership_equals_jax(num_bins, shards):
    for port_fn, jax_fn in ((learners.balanced_ownership,
                             jlearners.balanced_ownership),):
        got, want = port_fn(num_bins, shards), jax_fn(num_bins, shards)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    got = learners.static_ownership(len(num_bins), shards)
    want = jlearners.static_ownership(len(num_bins), shards)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_num_machines_past_the_world_shrinks(table, capsys):
    """No process group: the world is one rank; num_machines=4 warns and
    the data-parallel learner trains the serial run's trees."""
    assert not mesh.initialized()
    path = table[0]
    cfg = lgt.OverallConfig()
    cfg.set(dict(BASE, data=str(path), hist_dtype="int8",
                 tree_learner="data", num_machines="4"))
    ds = lgt.Dataset.load_train(cfg.io_config)
    capsys.readouterr()
    booster = lgt.train(dict(BASE, hist_dtype="int8", tree_learner="data",
                             num_machines="4"), ds, device="cpu")
    assert "num_machines=4 exceeds the world (1 ranks)" in \
        capsys.readouterr().out
    assert booster._learner.world == 1
    assert booster._learner.schedule() == "psum"
    assert booster.model_to_string() == port_serial(
        dict(hist_dtype="int8"), path)


def test_num_machines_one_is_serial():
    cfg = lgt.OverallConfig()
    cfg.set({"objective": "binary", "tree_learner": "data"},
            require_data=False)
    assert cfg.boosting_config.tree_learner == "serial"
    assert not cfg.is_parallel
    with pytest.raises(log.Fatal, match="should be >= 1"):
        cfg.set({"objective": "binary", "num_machines": "0"},
                require_data=False)
