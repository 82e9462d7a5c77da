"""Observability over a world of ranks: the leader-only sink, timeline
shards, the world's health vector, ``on_anomaly=halt`` on every rank and
the ranks' trace dumps, in two gloo worlds (2 and 4 ranks, one process a
rank on the CPU, each killed past WORLD_TIMEOUT s), against the port's
serial run and the JAX package's podtrace and report scripts, live.

- ROADMAP C12: a 2-rank ``tree_learner=data`` world with ``metrics_out``
  and ``timeline=false`` leaves exactly one file, every line of it JSON,
  with the serial run's record count; ``profile_dir`` holds one trace a
  rank.
- ``timeline=auto`` in the world writes one shard a rank, named by
  ``telemetry.shard_path`` and headed by its ``shard`` record, and no
  record reaches the leader's path first (the sink opens after the world
  has formed); ``timeline=true`` writes a shard on one process.
- ROADMAP C13: every rank's per-iteration health block and the summary's
  equal the serial run's, ``quant_sat`` (int8) included, under ``data``,
  hybrid 2 x 2 and ``feature``; the health sites are filed where rows are
  sharded and not under ``feature``.
- ``on_anomaly=halt`` with NaN gradients in rank 1's rows alone stops
  both ranks at iteration 1 with ``TrainingHealthError``, within
  seconds, and both exit nonzero.
- Under the armed drain (no drain fires), each rank's trace dump carries
  its rank identity and the ``collective_sync`` events of the exchange;
  the port's podtrace aligns the dumps as the JAX module does, and the
  port's report scripts print the JAX scripts' ``--json`` on the world's
  dumps and shards.
"""
import json
import os
import sys

import pytest

from lightgbm_tpu import podtrace as jpodtrace

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import lifecycle, podtrace, telemetry, tracing
from lightgbm_tpu_torch.config import IOConfig
from lightgbm_tpu_torch.utils import log
from scripts import (pod_report, port_pod_report, port_timeline_report,
                     timeline_report)
from test_torch_parallel import BASE, World, write_table

WORLD_TIMEOUT = 120
HALT_S = 30.0            # a halted rank's whole job, raise included
INT8 = dict(BASE, hist_dtype="int8", health="true")
DP2 = {"tree_learner": "data", "num_machines": "2"}
GRIDS = {"data": DP2,
         "hybrid": {"tree_learner": "hybrid", "num_machines": "4",
                    "feature_shards": "2"},
         "feature": {"tree_learner": "feature", "num_machines": "4"}}

# one rank's program: join the world, train each job on the rank's rows
# (rank 1 of a ``poison`` job with NaN in its first rows' gradients),
# record the model or the health error; exit 3 after a halted job
WORKER = r'''
import json, sys, time
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import parallel
from lightgbm_tpu_torch.config import OverallConfig
from lightgbm_tpu_torch.health import TrainingHealthError
from lightgbm_tpu_torch.objectives import binary
from lightgbm_tpu_torch.parallel import learners

spec = json.load(open(sys.argv[1]))
parallel.init_distributed()
rank = parallel.get_rank()
gradients = binary.BinaryLogloss.get_gradients


def poisoned(self, score):
    grad, hess = gradients(self, score)
    grad = grad.clone()
    grad[..., :3] = float("nan")
    return grad, hess


out, halted = {}, False
for job in spec["jobs"]:
    params = dict(spec["base"], **job["params"])
    cfg = OverallConfig()
    cfg.set(dict(params, data=spec["data"]))
    shard_rank, shards = learners.row_shard(cfg)
    ds = lgt.Dataset.load_train(
        cfg.io_config, rank=shard_rank, num_machines=shards,
        bin_finder=(learners.distributed_bin_finder()
                    if cfg.is_parallel_find_bin else None))
    binary.BinaryLogloss.get_gradients = (
        poisoned if rank in job.get("poison", ()) else gradients)
    rec = {"rows": int(ds.num_data)}
    t0 = time.perf_counter()
    try:
        rec["model"] = lgt.train(params, ds, device="cpu").model_to_string()
    except TrainingHealthError as e:
        rec["error"], halted = str(e), True
    rec["seconds"] = time.perf_counter() - t0
    out[job["name"]] = rec
json.dump(out, open(spec["out"] % rank, "w"))
parallel.shutdown()
sys.exit(3 if halted else 0)
'''


@pytest.fixture(autouse=True)
def no_leaks():
    yield
    left = lifecycle.leaks()
    for _, _, closer in left:
        closer()
    assert not left, [(k, n) for k, n, _ in left]


class ObsWorld:
    """The jobs of ``jobs`` in one world of P ranks, started now, in
    ``wdir`` (every path a job names is relative to it)."""

    def __init__(self, wdir, P, jobs, data):
        self.dir, self.P = wdir, P
        spec = {"base": INT8, "data": str(data), "jobs": jobs,
                "out": str(wdir / "out.%d.json")}
        (wdir / "spec.json").write_text(json.dumps(spec))
        (wdir / "worker.py").write_text(WORKER)
        self.world = World([sys.executable, "worker.py", "spec.json"], P,
                           wdir, timeout=WORLD_TIMEOUT)

    def result(self):
        """([rank] -> {job: record}, [rank] -> exit code)."""
        ranks = self.world.wait()
        recs = []
        for r, (rc, text) in enumerate(ranks):
            assert rc in (0, 3), "rank %d exited %d:\n%s" % (r, rc,
                                                           text[-3000:])
            with open(str(self.dir / ("out.%d.json" % r))) as f:
                recs.append(json.load(f))
        return recs, [rc for rc, _ in ranks]


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    path = tmp_path_factory.mktemp("obs_table") / "train.tsv"
    write_table(path)
    return path


@pytest.fixture(scope="module")
def worlds(table, tmp_path_factory):
    """World A (2 ranks, data): the leader-only sink with the profiler,
    the shards with the drain armed and the trace dumps, the halt; world
    B (4 ranks): hybrid 2 x 2 and feature, each with shards."""
    da = tmp_path_factory.mktemp("world_a")
    db = tmp_path_factory.mktemp("world_b")
    a = ObsWorld(da, 2, [
        {"name": "leader", "params": dict(
            DP2, metrics_out="leader.jsonl", timeline="false",
            profile_dir="prof")},
        {"name": "shards", "params": dict(
            DP2, metrics_out="tl.jsonl", timeline="auto",
            elastic_shrink="true", straggler_k="10", checkpoint_interval="1",
            checkpoint_dir="ck", trace_dump_dir="dumps",
            trace_run_id="world-a")},
        {"name": "halt", "params": dict(DP2, on_anomaly="halt"),
         "poison": [1]}], table)
    b = ObsWorld(db, 4, [
        {"name": name, "params": dict(GRIDS[name], metrics_out=name + ".jsonl",
                                      timeline="auto")}
        for name in ("hybrid", "feature")], table)
    out = {"a": a.result(), "b": b.result(), "dirs": {"a": da, "b": db}}
    return out


@pytest.fixture(scope="module")
def serial(table, tmp_path_factory):
    """The port's serial run with a sink: (its records, model text)."""
    path = tmp_path_factory.mktemp("obs_serial") / "serial.jsonl"
    cfg = lgt.OverallConfig()
    cfg.set(dict(INT8, data=str(table)))
    ds = lgt.Dataset.load_train(cfg.io_config)
    booster = lgt.train(dict(INT8, metrics_out=str(path)), ds, device="cpu")
    return read_jsonl(path), booster.model_to_string()


def read_jsonl(path):
    """Every line of ``path`` as JSON (a line that does not parse fails
    the test)."""
    with open(str(path)) as f:
        return [json.loads(line) for line in f]


def health_blocks(records):
    return ([r["health"] for r in records if "iter" in r],
            [r["health"] for r in records if r.get("summary")])


def test_leader_only_sink_c12(worlds, serial):
    """One file, every line JSON, the serial run's record count and
    health blocks; both ranks trained the serial run's trees."""
    (recs, _), wdir = worlds["a"], worlds["dirs"]["a"]
    assert sorted(p for p in os.listdir(str(wdir))
                  if p.startswith("leader")) == ["leader.jsonl"]
    records = read_jsonl(wdir / "leader.jsonl")
    assert len(records) == len(serial[0])
    assert [sorted(r) for r in records if "iter" not in r
            and not r.get("summary")] == [["residency"]]
    assert health_blocks(records) == health_blocks(serial[0])
    assert [r["leader"]["model"] for r in recs] == [serial[1]] * 2


def test_profile_writes_one_trace_a_rank(worlds):
    wdir = worlds["dirs"]["a"]
    assert sorted(os.listdir(str(wdir / "prof"))) == [
        "trace.rank0.json", "trace.rank1.json"]
    for r in range(2):
        with open(str(wdir / "prof" / ("trace.rank%d.json" % r))) as f:
            assert json.load(f)["traceEvents"]


def test_timeline_auto_writes_a_headed_shard_a_rank(worlds, serial):
    """Named by shard_path, headed by the shard record; the iteration and
    summary records carry ``t``; nothing reached ``tl.jsonl`` itself, so
    no record was written before the world formed."""
    wdir = worlds["dirs"]["a"]
    names = sorted(p for p in os.listdir(str(wdir)) if p.startswith("tl"))
    assert names == [os.path.basename(telemetry.shard_path(
        str(wdir / "tl.jsonl"), r, 2)) for r in range(2)]
    pids = set()
    for r, name in enumerate(names):
        records = read_jsonl(wdir / name)
        head = records[0]["shard"]
        assert (head["process_index"], head["process_count"]) == (r, 2)
        assert isinstance(head["clock_offset_s"], float)
        assert head["fingerprint"]["process_count"] == 2
        pids.add(head["pid"])
        body = records[1:]
        assert len(body) == len(serial[0])
        assert all(isinstance(x["t"], float) for x in body
                   if "iter" in x or x.get("summary"))
    assert len(pids) == 2


def test_timeline_true_on_one_process(table, tmp_path):
    cfg = lgt.OverallConfig()
    cfg.set(dict(INT8, data=str(table)))
    ds = lgt.Dataset.load_train(cfg.io_config)
    base = str(tmp_path / "one.jsonl")
    lgt.train(dict(INT8, num_iterations="1", metrics_out=base,
                   timeline="true"), ds, device="cpu")
    assert os.listdir(str(tmp_path)) == [os.path.basename(
        telemetry.shard_path(base, 0, 1))]
    records = read_jsonl(telemetry.shard_path(base, 0, 1))
    assert (records[0]["shard"]["process_index"],
            records[0]["shard"]["process_count"]) == (0, 1)
    assert telemetry.timeline_enabled() is False     # the session ended


def test_sink_opens_at_the_first_record(tmp_path):
    """``arm_session`` runs before the world forms in both entry points:
    it must write nothing, and ``timeline=auto`` stays off until
    ``resolve_world`` (here one process: off, the leader's file)."""
    io = IOConfig()
    io.metrics_out = str(tmp_path / "m.jsonl")
    try:
        assert telemetry.arm_session(io)
        assert os.listdir(str(tmp_path)) == []
        assert not telemetry.timeline_enabled()
        telemetry.resolve_world(io)
        assert not telemetry.timeline_enabled()
        assert tracing.identity()["process_count"] == 1
        telemetry.emit_iteration(1, {})
        assert os.listdir(str(tmp_path)) == ["m.jsonl"]
        assert telemetry.sink_path() == io.metrics_out
    finally:
        telemetry.disable()
        telemetry.reset()
    assert tracing.identity()["process_index"] is None


@pytest.mark.parametrize("timeline,metrics_out,want", [
    ("auto", "m.jsonl", False), ("auto", "", False), ("true", "", True),
    ("true", "m.jsonl", True), ("false", "m.jsonl", False)])
def test_timeline_rule_on_one_process(timeline, metrics_out, want):
    """``IOConfig.timeline_enabled`` is the JAX rule: auto needs a world
    of more than one rank and a sink; this process has no world."""
    cfg = lgt.OverallConfig()
    cfg.set({"objective": "binary", "timeline": timeline,
             "metrics_out": metrics_out}, require_data=False)
    assert cfg.io_config.timeline_enabled() is want
    with pytest.raises(log.Fatal, match="timeline must be auto"):
        cfg.set({"objective": "binary", "timeline": "often"},
                require_data=False)


def _shards(worlds, name):
    key = "a" if name in ("data", "tl") else "b"
    wdir = worlds["dirs"][key]
    base = "tl" if name == "data" else name
    P = 2 if key == "a" else 4
    return [read_jsonl(telemetry.shard_path(str(wdir / (base + ".jsonl")),
                                            r, P))[1:] for r in range(P)]


@pytest.mark.parametrize("learner", ["data", "hybrid", "feature"])
def test_every_rank_health_equals_serial_c13(worlds, serial, learner):
    """Each rank's per-iteration blocks and summary block are the serial
    run's, ``quant_sat`` included; each rank's trees are serial's."""
    want = health_blocks(serial[0])
    assert want[0][0]["quant_sat"] > 0
    for records in _shards(worlds, learner):
        assert health_blocks(records) == want
    recs = worlds["a" if learner == "data" else "b"][0]
    job = "shards" if learner == "data" else learner
    assert {r[job]["model"] for r in recs} == {serial[1]}


@pytest.mark.parametrize("learner", ["data", "hybrid", "feature"])
def test_health_sites(worlds, learner):
    """Where rows are sharded, one call of each health site an iteration
    over the data axis; under feature (every rank every row) none."""
    for records in _shards(worlds, learner):
        summary = [r for r in records if r.get("summary")][0]
        sites = {k: v for k, v in summary["interconnect"]["sites"].items()
                 if k.startswith("health/")}
        if learner == "feature":
            assert sites == {}
            continue
        want = {"health/vector_psum": 24, "health/score_pmax": 4,
                "health/quant_sat_pmax": 8, "health/quant_sat_reduce": 8}
        assert {k: (v["calls"], v["bytes_per_call"], v["axis"])
                for k, v in sites.items()} == {
            k: (int(BASE["num_iterations"]), b, "data")
            for k, b in want.items()}


def test_halt_stops_every_rank(worlds):
    """NaN in rank 1's gradients alone: both ranks raise at iteration 1,
    within seconds of the job's start, and exit nonzero; no rank waits
    in a collective for a peer that stopped."""
    recs, rcs = worlds["a"]
    assert rcs == [3, 3]
    for r in recs:
        assert "training halted by health monitor at iteration 1: " \
            "grad_nan=3" in r["halt"]["error"]
        assert r["halt"]["seconds"] < HALT_S


def _dumps(worlds):
    wdir = worlds["dirs"]["a"] / "dumps"
    return sorted(str(wdir / p) for p in os.listdir(str(wdir)))


def test_dumps_carry_rank_identity_and_sync_points(worlds):
    """Two dumps, one a rank: rank identity and run id in the header,
    the drain's exchange at each iteration as a collective sync over the
    world, and the wire model with the health sites."""
    dumps = [podtrace.load_dump(p) for p in _dumps(worlds)]
    assert sorted((d["header"]["process_index"],
                   d["header"]["process_count"],
                   d["header"]["run_id"]) for d in dumps) == [
        (0, 2, "world-a"), (1, 2, "world-a")]
    iters = int(BASE["num_iterations"])
    for d in dumps:
        syncs = [(e["site"], e["iter"], e["pod"]) for e in d["events"]
                 if e["kind"] == "collective_sync"]
        assert syncs == [("elastic/times_allgather", k, True)
                         for k in range(1, iters + 1)]
        (model,) = [e for e in d["events"] if e["kind"] == "wire_model"]
        assert model["sites"]["health/vector_psum"]["est_calls"] == iters
        assert "collective_sync_us" in d["header"]["sketches"]


def test_world_dumps_align_as_jax(worlds):
    paths = _dumps(worlds)
    port = [podtrace.load_dump(p) for p in paths]
    jax_ = [jpodtrace.load_dump(p) for p in paths]
    al = podtrace.align(port)
    assert al == jpodtrace.align(jax_)
    off = al["offsets"]["p1"]
    assert al["ok"] and off["sync_points"] == int(BASE["num_iterations"])
    assert 0.0 <= off["bound_s"] < 5.0
    assert podtrace.merge_timeline(port, al) == \
        jpodtrace.merge_timeline(jax_, al)
    assert podtrace.merge_sketches(port) == jpodtrace.merge_sketches(jax_)
    assert podtrace.check(port, al) == jpodtrace.check(jax_, al) == []


def test_report_scripts_equal_jax_on_the_world(worlds, capsys,
                                               monkeypatch):
    """The world's dumps through both pod reports (--json and --check),
    its shards through both timeline reports (--json)."""
    paths = _dumps(worlds)
    for mode in ("--json", "--check"):
        argv = [mode, "--device-kind", "cpu"] + paths
        monkeypatch.setattr(sys, "argv", ["pod_report.py"] + argv)
        want = pod_report.main(), capsys.readouterr().out
        got = port_pod_report.main(argv), capsys.readouterr().out
        assert got == want and got[0] == 0
    shards = [telemetry.shard_path(str(worlds["dirs"]["a"] / "tl.jsonl"),
                                   r, 2) for r in range(2)]
    want = timeline_report.main(["--json"] + shards), \
        capsys.readouterr().out
    got = port_timeline_report.main(["--json"] + shards), \
        capsys.readouterr().out
    assert got == want
    rep = json.loads(got[1])
    assert rep["iterations_compared"] == int(BASE["num_iterations"])
    assert rep["wire"]["est_bytes_total"] > 0
