"""Checkpoints and the elastic restart across a world of ranks: gloo
worlds of 2-4 ranks (one process a rank, on the CPU, each killed past
WORLD_TIMEOUT s) against the port's serial run and the JAX package live.

A world's checkpoint holds the scores in serial row order (rank 0
writes it; the JAX payload field for field), so:

- a run stopped at iteration STOP (a raise on every rank, or rank 1
  SIGKILLed) and resumed on the same world writes the unbroken world
  run's model text byte for byte, in float32 and int8 and with host
  bagging (each rank r > 0 then also keeps its own bagging state under
  ``checkpoint_dir/rank<r>``);
- int8 resumes of 4 -> 2, 2 -> 3, 2 -> 1 and 1 -> 2 ranks write the
  serial int8 run's model text byte for byte;
- a checkpoint of the JAX package's single-process ``tree_learner=data``
  run (the 8-device virtual CPU mesh of tests/conftest.py) resumes in a
  port world to the JAX run's unbroken trees, and a port world's
  checkpoint loads, passes the fingerprint check and resumes in the JAX
  package to the port's serial trees, both to the cross-package budget
  of tests/test_torch_checkpoint.py (structure exact, leaf values rtol
  1e-5 / atol 5e-7);
- host bagging or ``is_pre_partition=true`` across a topology change is
  a named ``Fatal`` on every rank;
- a world whose rank 1 raises ends on its own, well before WORLD_TIMEOUT:
  the exception path runs no collective (the JAX package's gathers the
  scores there, a collective its peers never join; ROADMAP C).

ROADMAP C10 is recorded here too: the JAX package's restore slices the
stored scores by process offset, which hands a rank rows it does not
hold once the process count changes.
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest

from lightgbm_tpu import checkpoint as jckpt
from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.objectives import create_objective as jcreate
from lightgbm_tpu.parallel import create_parallel_learner as jparallel

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import checkpoint as ckpt
from lightgbm_tpu_torch import faults
from lightgbm_tpu_torch.utils import log
from test_torch_parallel import (BASE, World, assert_alike, port_serial,
                                 write_table)

ITERS = 5
STOP = 2          # the fault fires at this iteration boundary
DP = {"tree_learner": "data", "num_machines": "8"}
CASES = {"float32": {"hist_dtype": "float32"},
         "int8": {"hist_dtype": "int8"},
         "host_bagging": {"hist_dtype": "int8", "bagging_fraction": "0.8",
                          "bagging_freq": "2"}}

# one rank's program: join the world, then each job of the spec on the
# rank's rows; a job may arm a fault on some ranks, expect a Fatal (its
# message recorded), slow one rank down (``slow``: [rank, seconds of its
# own work before every iteration], a straggler as the drain measures
# it) and record telemetry
WORKER = r'''
import json, sys, time
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import faults, parallel, telemetry
from lightgbm_tpu_torch.config import OverallConfig
from lightgbm_tpu_torch.parallel import learners

spec = json.load(open(sys.argv[1]))
parallel.init_distributed()
rank = parallel.get_rank()
train_one_iter = lgt.GBDT.train_one_iter


def slowed(seconds):
    def slow_iter(self, *args, **kwargs):
        time.sleep(seconds)
        return train_one_iter(self, *args, **kwargs)
    return slow_iter


def load(params, job):
    cfg = OverallConfig()
    cfg.set(dict(params, data=job.get("data", spec["data"])))
    shard_rank, shards = learners.row_shard(cfg)
    if "data_by_shard" in job:
        cfg.io_config.data_filename = job["data_by_shard"][shard_rank]
    return lgt.Dataset.load_train(
        cfg.io_config, rank=shard_rank, num_machines=shards,
        bin_finder=learners.distributed_bin_finder()
        if cfg.is_parallel_find_bin else None)


out = {}
for job in spec["jobs"]:
    params = dict(spec["base"], **job["params"])
    fault = job.get("fault")
    if fault and rank in fault["ranks"]:
        faults.arm(fault["at"], fault["kind"])
    if job.get("telemetry"):
        telemetry.enable()
        telemetry.reset()
    if job.get("slow", [None])[0] == rank:
        lgt.GBDT.train_one_iter = slowed(job["slow"][1])
    rec = {}
    t0 = time.perf_counter()
    try:
        ds = load(params, job)
        rec["rows"] = int(ds.num_data)
        if ds.used_data_indices is not None:
            rec["indices"] = ds.used_data_indices.tolist()
        booster = lgt.train(params, ds, device="cpu")
        rec["model"] = booster.model_to_string()
        rec["iter"] = booster.iter
        rec["leaf_count"] = [None if t.leaf_count is None
                             else t.leaf_count.tolist()
                             for t in booster.models]
    except Exception as e:
        if not job.get("expect_error"):
            raise
        rec["error"] = "%s: %s" % (type(e).__name__, e)
    finally:
        faults.disarm()
        lgt.GBDT.train_one_iter = train_one_iter
        if job.get("telemetry"):
            snap = telemetry.snapshot()
            rec["counters"] = snap["counters"]
            rec["sites"] = (snap.get("interconnect") or {}).get("sites", {})
            rec["phases"] = sorted(snap.get("phase_times", {}))
            telemetry.disable()
            telemetry.reset()
    rec["seconds"] = time.perf_counter() - t0
    out[job["name"]] = rec
json.dump(out, open(spec["out"] % rank, "w"))
parallel.shutdown()
'''


class CkptWorld:
    """Every job of ``jobs`` in one world of P ranks started now (WORKER);
    ``result()`` waits: (exit codes, [rank] -> {name: record}, logs).
    ``strict``: every rank must exit 0."""

    def __init__(self, root, name, P, jobs, data, strict=True):
        self.dir = root / name
        self.dir.mkdir()
        self.out = str(self.dir / "out.%d.json")
        spec = {"base": BASE, "data": str(data), "jobs": jobs,
                "out": self.out}
        (self.dir / "spec.json").write_text(json.dumps(spec))
        (self.dir / "worker.py").write_text(WORKER)
        self.P, self.strict = P, strict
        self.world = World([sys.executable, "worker.py", "spec.json"], P,
                           self.dir)
        self._result = None

    def result(self):
        if self._result is None:
            ranks = self.world.wait()
            if self.strict:
                for r, (rc, text) in enumerate(ranks):
                    assert rc == 0, "rank %d failed:\n%s" % (r, text[-4000:])
            recs = [json.load(open(self.out % r))
                    if os.path.exists(self.out % r) else None
                    for r in range(self.P)]
            self._result = ([rc for rc, _ in ranks], recs,
                            [text for _, text in ranks])
        return self._result


def _ck(root, name):
    return str(root / ("ck-" + name))


def _copy(root, src, dst):
    """A copy of checkpoint directory ``src`` as ``dst`` (a resume writes
    new checkpoints into its directory)."""
    shutil.copytree(_ck(root, src), _ck(root, dst))
    return _ck(root, dst)


def _params(case, **extra):
    return dict(CASES[case], num_iterations=str(ITERS), **extra)


def _jax(params, x, y, num_machines=1, iters=ITERS):
    """The JAX package's booster (serial, or its single-process parallel
    learner over ``num_machines`` virtual devices), ``iters``
    iterations."""
    p = dict(BASE, **params)
    p.pop("num_iterations", None)
    p.pop("num_machines", None)
    p.pop("tree_learner", None)
    if num_machines > 1:
        p.update(tree_learner="data", num_machines=str(num_machines))
    cfg = JConfig()
    cfg.set(p, require_data=False)
    b = JGBDT()
    b.init(cfg.boosting_config,
           JDataset.from_arrays(x, y, max_bin=int(BASE["max_bin"])),
           jcreate(cfg.objective_type, cfg.objective_config),
           learner=jparallel(cfg) if cfg.is_parallel else None)
    for _ in range(iters):
        if b.train_one_iter(is_eval=False):
            break
    return b


def _serial_stop(root, params, data, name):
    """The port's serial run of ``params`` stopped by a raise at STOP,
    checkpointing every iteration into ck-<name>."""
    cfg = lgt.OverallConfig()
    cfg.set(dict(BASE, **params, data=str(data)))
    ds = lgt.Dataset.load_train(cfg.io_config)
    faults.arm(STOP, "raise")
    try:
        with pytest.raises(RuntimeError, match="injected fault"):
            lgt.train(dict(BASE, **params, checkpoint_interval="1",
                           checkpoint_dir=_ck(root, name)), ds,
                      device="cpu")
    finally:
        faults.disarm()


def _port_resume(params, data, ckdir):
    """The port's serial run of ``params`` resumed from ``ckdir``."""
    cfg = lgt.OverallConfig()
    cfg.set(dict(BASE, **params, data=str(data)))
    ds = lgt.Dataset.load_train(cfg.io_config)
    return lgt.train(dict(BASE, **params, checkpoint_interval="1",
                          checkpoint_dir=ckdir), ds,
                     device="cpu").model_to_string()


def _stop_job(name, case, root, P_extra=DP, ranks=None, kind="raise",
              **extra):
    return {"name": name, "expect_error": kind == "raise",
            "params": _params(case, checkpoint_interval="1",
                              checkpoint_dir=_ck(root, name), **P_extra,
                              **extra),
            "fault": {"at": STOP, "kind": kind,
                      "ranks": ranks if ranks is not None else [0, 1, 2, 3]}}


def _resume_job(name, case, ckdir, P_extra=DP, expect_error=False,
                **extra):
    return {"name": name, "expect_error": expect_error,
            "params": _params(case, checkpoint_interval="1",
                              checkpoint_dir=ckdir, **P_extra, **extra)}


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckworld")
    x, y = write_table(root / "train.tsv")
    # is_pre_partition: each data shard's own file, cut in rank order
    for P in (2, 3):
        bounds = np.linspace(0, len(y), P + 1).astype(int)
        for r in range(P):
            sl = slice(bounds[r], bounds[r + 1])
            np.savetxt(root / ("part%d.%d.tsv" % (P, r)),
                       np.column_stack([y[sl], x[sl]]), delimiter="\t",
                       fmt="%.17g")
    return root, root / "train.tsv", x, y


@pytest.fixture(scope="module")
def stage0(table):
    """In-process: the serial runs, a serial checkpoint at STOP (1 -> 2),
    and a JAX single-process data-parallel checkpoint at STOP."""
    root, data, x, y = table
    serial = {c: port_serial(_params(c), data) for c in CASES}
    _serial_stop(root, _params("int8"), data, "serial")
    jpart = _jax(_params("int8"), x, y, num_machines=2, iters=STOP)
    os.makedirs(_ck(root, "jax_dp"))
    jckpt.write_checkpoint(_ck(root, "jax_dp"),
                           jckpt.serialize_state(jpart.checkpoint_state()))
    return serial


@pytest.fixture(scope="module")
def stage1(table, stage0):
    """The worlds of the first round, started together: (a) 2 ranks,
    every case unbroken, stopped and resumed, plus the checkpoints later
    worlds resume (int8, host bagging, pre-partitioned) and the resumes
    of the serial and JAX checkpoints; (b) 4 ranks, int8 stopped; (c) 2
    ranks, rank 1 SIGKILLed; (d) 2 ranks, rank 1 alone raising."""
    root, data, x, y = table
    a = []
    for c in CASES:
        a.append({"name": "whole-" + c, "params": _params(c, **DP)})
        a.append(_stop_job("stop-" + c, c, root))
        a.append(_resume_job("resume-" + c, c, _ck(root, "stop-" + c)))
    a.append(_stop_job("keep-int8", "int8", root))
    a.append(_stop_job("keep-host_bagging", "host_bagging", root))
    a.append(dict(_stop_job("keep-prepart", "int8", root,
                            is_pre_partition="true"),
                  data_by_shard=[str(root / ("part2.%d.tsv" % r))
                                 for r in range(2)]))
    a.append(_resume_job("from-serial", "int8",
                         _copy(root, "serial", "serial-to-2")))
    a.append(_resume_job("from-jax", "int8",
                         _copy(root, "jax_dp", "jax-to-2")))
    worlds = {
        "a": CkptWorld(root, "a", 2, a, data),
        "b": CkptWorld(root, "b", 4, [_stop_job("keep4-int8", "int8",
                                                root)], data),
        "c": CkptWorld(root, "c", 2, [_stop_job("kill-float32", "float32",
                                                root, ranks=[1],
                                                kind="kill")], data,
                       strict=False),
        "d": CkptWorld(root, "d", 2, [dict(_stop_job(
            "raise1-host_bagging", "host_bagging", root, ranks=[1]),
            expect_error=False)], data, strict=False)}
    return {k: w.result() for k, w in worlds.items()}


@pytest.fixture(scope="module")
def stage2(table, stage1):
    """The restarts: (e) 3 ranks from the 2-rank checkpoints (int8, host
    bagging, pre-partitioned); (f) 2 ranks from the 4-rank checkpoint and
    from the SIGKILLed world's; in-process, 2 -> 1."""
    root, data, x, y = table
    e = [_resume_job("2to3-int8", "int8", _copy(root, "keep-int8", "2to3")),
         _resume_job("2to3-host_bagging", "host_bagging",
                     _copy(root, "keep-host_bagging", "2to3-hb"),
                     expect_error=True),
         dict(_resume_job("2to3-prepart", "int8",
                          _copy(root, "keep-prepart", "2to3-pp"),
                          expect_error=True, is_pre_partition="true"),
              data_by_shard=[str(root / ("part3.%d.tsv" % r))
                             for r in range(3)])]
    f = [_resume_job("4to2-int8", "int8", _copy(root, "keep4-int8", "4to2")),
         _resume_job("after-kill", "float32",
                     _copy(root, "kill-float32", "after-kill"))]
    worlds = {"e": CkptWorld(root, "e", 3, e, data),
              "f": CkptWorld(root, "f", 2, f, data)}
    serial = _port_resume(_params("int8"), data,
                          _copy(root, "keep-int8", "2to1"))
    out = {k: w.result() for k, w in worlds.items()}
    out["2to1"] = serial
    return out


def _texts(result, name):
    rcs, recs, _ = result
    texts = [r[name]["model"] for r in recs]
    assert all(t == texts[0] for t in texts), "ranks disagree"
    return texts[0]


@pytest.mark.parametrize("case", list(CASES))
def test_stop_and_resume_same_world_byte_equal(stage1, case):
    whole = _texts(stage1["a"], "whole-" + case)
    assert _texts(stage1["a"], "resume-" + case) == whole
    for rec in stage1["a"][1]:
        assert "injected fault at iteration %d" % STOP \
            in rec["stop-" + case]["error"]


def test_int8_world_run_is_serial(stage0, stage1):
    assert _texts(stage1["a"], "whole-int8") == stage0["int8"]


@pytest.mark.parametrize("name,world", [("4to2-int8", "f"),
                                        ("2to3-int8", "e"),
                                        ("2to1", None),
                                        ("from-serial", "a")])
def test_int8_resume_across_topologies_is_serial(stage0, stage1, stage2,
                                                 name, world):
    if world is None:
        text = stage2[name]
    else:
        text = _texts((stage1 if world == "a" else stage2)[world], name)
    assert text == stage0["int8"]


def test_checkpoint_is_rank0s_and_serial_order(table, stage0):
    """The world's checkpoint at STOP holds the scores of the serial run
    stopped at STOP, bit for bit (int8: the same trees), in the JAX
    payload's fields; only rank 0 wrote, into the directory itself."""
    root = table[0]
    world = ckpt.load_checkpoint(ckpt.checkpoint_path(_ck(root, "keep-int8"),
                                                      STOP))
    serial = ckpt.load_checkpoint(ckpt.checkpoint_path(_ck(root, "serial"),
                                                       STOP))
    np.testing.assert_array_equal(ckpt.array_from_json(world["score"]),
                                  ckpt.array_from_json(serial["score"]))
    assert world["trees"] == serial["trees"]
    assert world["topology"] == {"tree_learner": "DataParallelLearner",
                                 "num_machines": 2, "process_count": 2}
    assert world["dataset"] == serial["dataset"]
    assert not [d for d in os.listdir(_ck(root, "keep-int8"))
                if d.startswith("rank")]
    jckpt.load_checkpoint(ckpt.checkpoint_path(_ck(root, "keep-int8"),
                                               STOP))


def test_host_bagging_keeps_a_state_per_rank(table, stage1):
    """Host bagging: rank 0's bagging state in the directory, rank 1's
    under rank1/, each its own shard's mask."""
    root = table[0]
    rows = [rec["keep-host_bagging"]["rows"] for rec in stage1["a"][1]]
    main = ckpt.load_checkpoint(ckpt.checkpoint_path(
        _ck(root, "keep-host_bagging"), STOP))
    own = ckpt.load_checkpoint(ckpt.checkpoint_path(
        os.path.join(_ck(root, "keep-host_bagging"), "rank1"), STOP))
    assert ckpt.mask_from_json(main["rng"]["bagging"]["mask"]).size == \
        rows[0]
    assert ckpt.mask_from_json(own["rng"]["bagging"]["mask"]).size == \
        rows[1]
    assert main["trees"] == own["trees"]


@pytest.mark.parametrize("name,match", [
    ("2to3-host_bagging", "host-path bagging state is per-shard"),
    ("2to3-prepart", "is_pre_partition=true cannot resume across a "
                     "topology change")])
def test_topology_change_refusals(stage2, name, match):
    rcs, recs, _ = stage2["e"]
    for rec in recs:
        assert "Fatal" in rec[name]["error"] or "LightGBMError" in \
            rec[name]["error"]
        assert match in rec[name]["error"]


def test_sigkilled_rank_ends_the_world_and_resumes(stage1, stage2):
    """Rank 1 SIGKILLed at STOP: rank 0 fails in its next collective (no
    wait past the world's limit), and the restarted world writes the
    unbroken run's text."""
    rcs, _, logs = stage1["c"]
    assert rcs[1] == -9, logs[1][-2000:]
    assert rcs[0] != 0
    assert _texts(stage2["f"], "after-kill") == \
        _texts(stage1["a"], "whole-float32")


def test_one_rank_raising_runs_no_collective(table, stage1):
    """Rank 1 alone raises at STOP (host bagging: it writes checkpoints
    of its own): its exception path writes no checkpoint (the snapshot's
    score gather would meet rank 0's next histogram sum), the world ends
    on its own, and the latest checkpoints are the periodic ones."""
    rcs, _, logs = stage1["d"]
    assert rcs[1] != 0 and rcs[0] != 0
    assert "injected fault at iteration %d" % STOP in logs[1]
    root = table[0]
    for d in ("", "rank1"):
        latest = ckpt.latest_checkpoint(
            os.path.join(_ck(root, "raise1-host_bagging"), d))
        assert ckpt.load_checkpoint(latest)["iteration"] == STOP


def test_jax_dp_checkpoint_resumes_in_a_port_world(table, stage1):
    root, data, x, y = table
    whole = _jax(_params("int8"), x, y, num_machines=2)
    assert_alike(_texts(stage1["a"], "from-jax"), whole, atol=5e-7)


def test_port_world_checkpoint_resumes_in_jax(table, stage0, stage1):
    """The 2-rank world's checkpoint at STOP passes the JAX loader and
    fingerprint check and resumes in the JAX package's serial booster to
    the port's serial trees."""
    root, data, x, y = table
    path = ckpt.checkpoint_path(_ck(root, "keep-int8"), STOP)
    payload = jckpt.load_checkpoint(path)
    j = _jax(_params("int8"), x, y, iters=0)
    jckpt.check_fingerprint(payload, j.checkpoint_fingerprint(),
                            j._dataset_fingerprint())
    j.restore_checkpoint(payload)
    for _ in range(ITERS - STOP):
        j.train_one_iter(is_eval=False)
    assert_alike(j, stage0["int8"], atol=5e-7)


def test_c10_jax_offset_restore_hands_other_rows(table):
    """ROADMAP C10: the JAX package's multi-process restore takes
    ``stored[:, off:off + n]`` with ``off`` the process's offset in the
    checkpoint's process-order layout of the new world's counts
    (lightgbm_tpu/models/gbdt.py:929-933).  After a P = 4 checkpoint
    (scores in P = 4 process order, ``_draw_shard_mask`` per process),
    rank 0 at P = 2 is handed rows it does not hold; the port's rule,
    ``stored_serial[:, used_data_indices]``, hands it its own."""
    root, data, x, y = table
    n = len(y)
    cfg = JConfig()
    cfg.set(dict(BASE, data=str(data)))

    def shards(P):
        d = JDataset()
        return [d._draw_shard_mask(cfg.io_config, r, P, n) for r in range(P)]

    four, two = shards(4), shards(2)
    stored_rows = np.concatenate(four)            # P = 4 process order
    handed = stored_rows[:two[0].size]            # rank 0 at P = 2, off 0
    assert not np.array_equal(handed, two[0])
    assert np.setdiff1d(handed, two[0]).size > 0
    # the port: serial order, each rank its own rows
    serial_order = np.arange(n)
    np.testing.assert_array_equal(serial_order[two[0]], two[0])


def test_world_host_bagging_checkpoint_refused_in_one_process(table):
    """The 2-rank world's host-bagging checkpoint restored by a serial
    run: rank 0's bagging state covers its shard alone, a named
    ``Fatal``."""
    root = table[0]
    path = ckpt.checkpoint_path(_ck(root, "keep-host_bagging"), STOP)
    cfg = lgt.OverallConfig()
    params = dict(BASE, **_params("host_bagging"))
    cfg.set(dict(params, data=str(table[1])))
    from lightgbm_tpu_torch.objectives import create_objective
    b = lgt.GBDT()
    b.init(cfg.boosting_config, lgt.Dataset.load_train(cfg.io_config),
           create_objective("binary", cfg.objective_config), device="cpu")
    with pytest.raises(log.Fatal, match="host-path bagging state is "
                       "per-shard"):
        b.restore_checkpoint(path)


@pytest.mark.parametrize("rank_order", [False, True])
def test_serial_rows_gather_and_take(monkeypatch, rank_order):
    """``SerialRows`` over two shards of 10 rows, [K, n] values (K = 3):
    the gather places every shard's values at their serial rows (or in
    rank order without ``used_data_indices``), ``take`` hands each rank
    its own, and ``gather_host`` places a host array's rows alike."""
    import torch
    from lightgbm_tpu_torch.models.gbdt import SerialRows
    from lightgbm_tpu_torch.parallel import mesh
    shards = ([np.arange(0, 4), np.arange(4, 10)] if rank_order else
              [np.array([0, 3, 4, 8]), np.array([1, 2, 5, 6, 7, 9])])
    full = torch.arange(30, dtype=torch.float32).reshape(3, 10) * 0.5

    def all_gather_object(obj):
        if isinstance(obj, int):
            return [len(s) for s in shards]
        if obj.dtype == np.int64:          # the shards' row indices
            return list(shards)
        return [full.numpy()[:, s].T for s in shards]

    monkeypatch.setattr(mesh, "all_gather_object", all_gather_object)
    monkeypatch.setattr(mesh, "get_rank", lambda: 1)

    class Comm:
        def all_gather(self, padded, site):
            width = padded.shape[-1]
            parts = []
            for s in shards:
                p = torch.zeros(3, width)
                p[:, :len(s)] = full[:, torch.as_tensor(s)]
                parts.append(p)
            return torch.stack(parts)

    class Shard:
        num_data = len(shards[1])
        used_data_indices = None if rank_order else shards[1]

    rows = SerialRows(Comm(), Shard, 1, torch.device("cpu"))
    assert rows.rank_order == rank_order and rows.n_total == 10
    own = full[:, torch.as_tensor(shards[1])]
    assert torch.equal(rows.gather(own, "site"), full)
    assert torch.equal(rows.take(full), own)
    np.testing.assert_array_equal(rows.gather_host(own.numpy().T),
                                  full.numpy().T)


def test_global_view_in_serial_order():
    """The world's metadata from two query-atomic shards whose rows lie
    apart in the file: labels, weights, query boundaries and query
    weights in serial row order are the whole table's."""
    from lightgbm_tpu_torch.io.metadata import Metadata
    counts = [3, 2, 4, 1, 2]                  # queries 0-4, 12 rows
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    whole = Metadata()
    whole.set_label(np.arange(12, dtype=np.float32))
    whole.weights = np.linspace(0.5, 2.0, 12).astype(np.float32)
    whole.query_boundaries = bounds
    whole.load_query_weights()
    queries = [[0, 3], [1, 2, 4]]             # each shard's whole queries
    parts = [np.concatenate([np.arange(bounds[q], bounds[q + 1])
                             for q in qs]) for qs in queries]
    shards = []
    for rows in parts:
        md = Metadata()
        md.set_label(whole.label.copy())
        md.weights = whole.weights.copy()
        md.query_boundaries = bounds.copy()
        md.partition(rows, 12)
        shards.append(md)
    order = np.concatenate(parts)

    def field(md, local):
        # this shard's array of the field rank 1 sends
        if local is shards[1].label:
            return md.label
        if local is shards[1].weights:
            return md.weights
        first = np.zeros(md.num_data, np.int8)
        first[md.query_boundaries[:-1]] = 1
        return first

    def gather(local):
        rows = np.concatenate([field(md, local) for md in shards])
        out = np.empty_like(rows)
        out[order] = rows
        return out

    g = shards[1].global_view(gather)
    np.testing.assert_array_equal(g.label, whole.label)
    np.testing.assert_array_equal(g.weights, whole.weights)
    np.testing.assert_array_equal(g.query_boundaries, bounds)
    np.testing.assert_array_equal(g.query_weights, whole.query_weights)
    assert g.num_data == 12
