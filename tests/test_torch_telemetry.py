"""lightgbm_tpu_torch.telemetry against lightgbm_tpu.telemetry, live.

One table made from a seed (2,000 training rows of 8 features and 500
validation rows; 15 leaves, 3 iterations) goes through both packages'
command lines with ``metrics_out`` (the JAX package on the CPU, the port
with ``device=cpu``, the kernels' plain versions), float32 and int8,
compacted, masked and depth-wise:

- **The schema is the same.**  Both sinks hold the same number of
  records; each record has the same keys and JSON types, recursively.
  Maps keyed by data (phase names, counter names, metric names) compare
  their values' types; keys a package writes only when they apply
  (memory deltas, roofline fractions, a compile record's analysis
  fields) may be absent on either side.  ``trace_times`` is always an
  empty dict in the port (it runs eagerly: nothing is traced); with it
  the port's records add ``wait_times`` (what its host reads waited) and
  ``device_times`` (its event-timed spans), which the JAX package has
  no counterpart of.
- ``eval_metrics`` agree within rtol 1e-5, and the counter names are
  equal after telemetry.JAX_COUNTER_NAMES (the pane entry's route folded
  into the float route it serves: the JAX package has no name for it),
  but for the port's count of its host reads, ``sync/d2h_reads``.
- **Arming changes nothing.**  With every observability key armed, the
  port's model text is byte-equal to the unarmed run under all three
  growers, float32 and int8.
- ``scripts/telemetry_report.py --json`` reads the port's sink, and
  ``scripts/port_report.py --json`` its host waits.
- Spans: event-timed device time (on fake CUDA events: no card here),
  host reads counted and their waits filed under the innermost span, a
  disarmed path that makes no event, ring entry or counter, nesting,
  exceptions, thread-safe counters, memory gauges that never fall back
  to host RSS for a CUDA device, the watchdog on a fake clock; and
  nothing leaks (``lifecycle.leaks()``).
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from lightgbm_tpu.cli import main as jcli

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import costmodel, lifecycle, telemetry
from lightgbm_tpu_torch.cli import main as tcli
from lightgbm_tpu_torch.ops import compact, hist_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TRAIN, N_VALID, F = 2000, 500, 8
CONFIGS = {
    "compacted_float32": ["leafwise_compact=true"],
    "masked_float32": ["leafwise_compact=false"],
    "depthwise_float32": ["grow_policy=depthwise"],
    "compacted_int8": ["leafwise_compact=true", "hist_dtype=int8"],
    "masked_int8": ["leafwise_compact=false", "hist_dtype=int8"],
    "depthwise_int8": ["grow_policy=depthwise", "hist_dtype=int8"],
}
BASE = ["task=train", "objective=binary", "num_leaves=15",
        "num_iterations=3", "min_data_in_leaf=20",
        "min_sum_hessian_in_leaf=0.01", "metric=binary_logloss,auc",
        "verbose=-1"]
# the pane entry serves the float route's child histograms; the JAX
# package counts those under the float route
FOLD = {"hist/plain_pane": "hist/plain_float",
        "hist/cuda_pane": "hist/cuda_float"}
# dicts keyed by data: their values' schemas are compared, not their keys
DATA_KEYED = {"phase_times", "phase_counts", "counters", "eval_metrics",
              "phase_delta_bytes", "phase_peak_bytes", "sketches", "phases",
              "trace_times", "wait_times", "device_times"}
# keys written only where they apply, by the name of the dict (or of the
# list whose entries they belong to)
OPTIONAL = {
    "": {"trace_times", "wait_times", "device_times"},
    "memory": {"phase_delta_bytes"},
    "phases": {"compile_seconds_excluded", "cost_analysis",
               "attained_flops_per_sec", "attained_hbm_gbps",
               "arithmetic_intensity", "frac_of_peak_flops",
               "frac_of_peak_bw"},
    "programs": {"flops", "bytes_accessed", "memory", "error", "warm"},
    "health": {"eval_divergence"},
    "roofline": {"traced_passes"},
}


@pytest.fixture(autouse=True)
def no_leaks():
    """No thread, armed recorder or monitor outlives a test."""
    yield
    left = lifecycle.leaks()
    for _, _, closer in left:
        closer()
    assert not left, [(k, n) for k, n, _ in left]


def make_table(seed=7):
    rng = np.random.RandomState(seed)
    x = rng.randn(N_TRAIN + N_VALID, F)
    z = x[:, 0] - 0.8 * x[:, 1] + 0.5 * x[:, 2] * x[:, 3] \
        + 0.4 * rng.randn(len(x))
    return x, (z > 0).astype(np.float32)


def write_tsv(path, x, y):
    np.savetxt(path, np.column_stack([y, x]), delimiter="\t", fmt="%.6g")


@pytest.fixture(scope="module")
def table_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("telemetry_table")
    x, y = make_table()
    train, valid = str(d / "train.tsv"), str(d / "valid.tsv")
    write_tsv(train, x[:N_TRAIN], y[:N_TRAIN])
    write_tsv(valid, x[N_TRAIN:], y[N_TRAIN:])
    return d, train, valid


def run_both(table_files, name, extra=()):
    """Both command lines on the table: (JAX records, port records, port
    model text, JAX model text)."""
    d, train, valid = table_files
    out = {}
    for pkg, main in (("jax", jcli), ("port", tcli)):
        sink = str(d / ("%s_%s.jsonl" % (name, pkg)))
        model = str(d / ("%s_%s.txt" % (name, pkg)))
        args = BASE + CONFIGS[name] + list(extra) + [
            "data=" + train, "valid_data=" + valid, "metrics_out=" + sink,
            "output_model=" + model]
        if pkg == "port":
            args.append("device=cpu")
        assert main(args) == 0
        with open(sink) as f:
            recs = [json.loads(line) for line in f]
        with open(model) as f:
            out[pkg] = (recs, f.read())
    return out["jax"][0], out["port"][0], out["port"][1], out["jax"][1]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request, table_files):
    return (request.param,) + run_both(table_files, request.param)


def _kind(v):
    """The JSON type (a number is a number, however Python wrote it: the
    JAX package writes ``round(0, 3)`` as 0 and ``round(0.5, 3)`` as
    0.5 in one field)."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "str"
    if isinstance(v, list):
        return "list"
    return "dict"


def assert_same_schema(j, t, name="", path="record"):
    """``t`` (the port's) has ``j``'s (the JAX package's) schema."""
    assert _kind(t) == _kind(j), (path, j, t)
    if isinstance(j, dict):
        if name in DATA_KEYED:
            if j and t:
                template = next(iter(j.values()))
                for k, v in t.items():
                    assert_same_schema(template, v, name + "[]",
                                       "%s.%s" % (path, k))
            return
        opt = OPTIONAL.get(name.rstrip("[]"), set()) | OPTIONAL[""]
        assert set(t) - opt == set(j) - opt, (path, sorted(j), sorted(t))
        for k in set(t) & set(j):
            assert_same_schema(j[k], t[k], k, "%s.%s" % (path, k))
    elif isinstance(j, list):
        if j and t:
            for i, v in enumerate(t):
                assert_same_schema(j[0], v, name + "[]",
                                   "%s[%d]" % (path, i))


def record_kind(r):
    return ("residency" if "residency" in r else
            "summary" if r.get("summary") else "iter")


def test_record_schema_matches_jax(pair):
    name, jrecs, trecs, _, _ = pair
    assert [record_kind(r) for r in trecs] == \
        [record_kind(r) for r in jrecs] == \
        ["residency", "iter", "iter", "iter", "summary"]
    for j, t in zip(jrecs, trecs):
        assert_same_schema(j, t)
        if "iter" in t:
            assert t["trace_times"] == {}
            assert set(telemetry.CANONICAL_PHASES) <= set(t["phase_times"])


def test_eval_metrics_and_counter_names_match_jax(pair):
    name, jrecs, trecs, _, _ = pair
    for j, t in zip(jrecs, trecs):
        if "iter" not in t:
            continue
        assert t["iter"] == j["iter"]
        assert sorted(t["eval_metrics"]) == sorted(j["eval_metrics"])
        for k, v in j["eval_metrics"].items():
            np.testing.assert_allclose(t["eval_metrics"][k], v, rtol=1e-5)
    jnames = {telemetry.JAX_COUNTER_NAMES.get(n, n)
              for n in jrecs[-1]["counters"]} - {None}
    tnames = {FOLD.get(n, n) for n in trecs[-1]["counters"]}
    assert tnames - {"sync/d2h_reads"} == jnames
    # every grower reads its results through telemetry.host_read
    assert trecs[-1]["counters"]["sync/d2h_reads"] > 0
    assert trecs[-1]["wait_times"]
    # a CPU run counts only plain routes, one per wrapper call
    assert not any("/cuda" in n for n in trecs[-1]["counters"])


def test_health_blocks_match_jax(pair):
    """The health blocks' counts are the JAX package's; the first
    iteration's gradients are the same bits in both, so its block is
    equal outright (int8: ``quant_sat`` too)."""
    name, jrecs, trecs, _, _ = pair
    jit = [r for r in jrecs if "iter" in r]
    tit = [r for r in trecs if "iter" in r]
    for k, (j, t) in enumerate(zip(jit, tit)):
        assert sorted(t["health"]) == sorted(j["health"])
        for key in ("grad_nan", "grad_inf", "hess_nan", "hess_inf",
                    "score_nan", "score_inf", "zero_gain_splits",
                    "empty_leaves", "degenerate_trees"):
            assert t["health"][key] == j["health"][key], (k, key)
        np.testing.assert_allclose(t["health"]["score_max_abs"],
                                   j["health"]["score_max_abs"], rtol=1e-5)
    assert tit[0]["health"] == jit[0]["health"]
    if name.endswith("int8"):
        assert tit[0]["health"]["quant_sat"] > 0


def test_telemetry_report_reads_the_port_sink(pair, table_files):
    name = pair[0]
    d = table_files[0]
    sink = str(d / ("%s_port.jsonl" % name))
    out = subprocess.run([sys.executable,
                          os.path.join(REPO, "scripts", "telemetry_report.py"),
                          "--json", sink], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    rendered = json.loads(out.stdout)
    assert rendered
    # the port's own blocks: the waits of the growers' host reads, by span
    out = subprocess.run([sys.executable,
                          os.path.join(REPO, "scripts", "port_report.py"),
                          "--json", sink], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    blocks = json.loads(out.stdout)
    assert blocks["iterations"] > 0 and blocks["wait_times"]


ARMED = {"metrics_fence": "true", "memory_stats": "true", "health": "true",
         "trace_run_id": "armed", "stall_timeout": "30",
         "monitor_interval_s": "0.2", "slo_p99_us": "1000",
         "health_divergence_rounds": "2"}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_arming_changes_no_model(name, tmp_path):
    """Every observability key armed: the model text is the unarmed
    run's, byte for byte; the profiler's Chrome trace carries the span
    names."""
    x, y = make_table()
    ds = lgt.Dataset.from_arrays(x[:N_TRAIN], y[:N_TRAIN], max_bin=255)
    params = {"objective": "binary", "num_leaves": 15, "num_iterations": 3,
              "min_data_in_leaf": 20, "min_sum_hessian_in_leaf": 0.01,
              "verbose": -1}
    for arg in CONFIGS[name]:
        k, v = arg.split("=")
        params[k] = v
    plain = lgt.train(params, ds, device="cpu").model_to_string()
    armed = dict(params, **ARMED, metrics_out=str(tmp_path / "m.jsonl"),
                 profile_dir=str(tmp_path / "prof"),
                 trace_dump_dir=str(tmp_path / "dumps"),
                 monitor_out=str(tmp_path / "mon.jsonl"))
    booster = lgt.train(armed, ds, device="cpu")
    assert booster.model_to_string() == plain
    assert not telemetry.enabled() and lifecycle.leaks() == []
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"grow", "histogram", "split_find", "gradient"} <= names
    assert os.listdir(tmp_path / "dumps")


def test_arming_changes_no_model_cli(table_files, tmp_path):
    """The same through the command line, with the stall watchdog and
    the profiler: the model file is the unarmed run's."""
    d, train, _ = table_files
    plain, armed = str(tmp_path / "plain.txt"), str(tmp_path / "armed.txt")
    args = BASE + ["data=" + train, "device=cpu"]
    assert tcli(args + ["output_model=" + plain]) == 0
    assert tcli(args + ["output_model=" + armed] + [
        "%s=%s" % kv for kv in ARMED.items()] + [
        "metrics_out=" + str(tmp_path / "m.jsonl"),
        "profile_dir=" + str(tmp_path / "prof"),
        "trace_dump_dir=" + str(tmp_path / "dumps")]) == 0
    with open(plain) as f1, open(armed) as f2:
        assert f1.read() == f2.read()


# ---- spans, counters and gauges


@pytest.fixture
def armed_registry():
    telemetry.enable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()
    telemetry.set_device(None)


def test_disarmed_span_is_a_shared_noop():
    telemetry.reset()
    assert not telemetry.enabled()
    assert telemetry.span("histogram") is telemetry.span("grow")
    with telemetry.span("histogram") as sp:
        assert sp.fence(3) == 3
    assert telemetry.snapshot()["phase_times"] == {}


class FakeStream:
    """A stream whose queued device time (ms) the test advances."""

    def __init__(self):
        self.t = 0.0


class FakeEvent:
    """torch.cuda.Event's surface the spans use; ``done`` is set by the
    test (the device reached it) or by ``synchronize``."""
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.at, self.done = None, False

    def record(self, stream):
        self.at, self.done = stream.t, False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return end.at - self.at


@pytest.fixture
def fake_card(monkeypatch):
    """A CUDA telemetry device on fake events, streams and NVTX."""
    stream = FakeStream()
    FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(telemetry, "_current_stream", lambda dev: stream)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: None)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: None)
    monkeypatch.setattr(telemetry, "_event_pool", [])
    telemetry.set_device(torch.device("cuda"))
    yield stream
    telemetry.disable()
    telemetry.reset()
    telemetry.set_device(None)


def test_fenced_spans_time_the_device_between_events(fake_card, tmp_path,
                                                    monkeypatch):
    """``fence=True`` on a CUDA device: each span records an event at
    enter and at exit and nothing waits; once ``_READ_BATCH`` pairs are
    pending (2 here), a span exit reads those whose end event has
    completed; ``snapshot`` and the iteration record wait for the rest;
    read pairs go back to the pool.  ``phase_times`` stays host time,
    and an iteration record carries the iteration's ``device_times``."""
    stream = fake_card
    monkeypatch.setattr(telemetry, "_READ_BATCH", 2)
    telemetry.enable(str(tmp_path / "m.jsonl"), fence=True)
    telemetry.reset()
    with telemetry.span("grow") as sp:
        stream.t += 5.0
        with telemetry.span("histogram"):
            stream.t += 2.0
        assert sp.fence(7) == 7
    assert FakeEvent.made == 4 and len(telemetry._pending) == 2
    assert telemetry._device_times == {}
    snap = telemetry.snapshot()
    assert snap["device_times"] == {"grow": 0.007, "histogram": 0.002}
    assert set(snap["phase_times"]) == {"grow", "histogram"}
    assert len(telemetry._event_pool) == 2 and not telemetry._pending
    # completed pairs are read at the next span exit, without a wait
    with telemetry.span("gradient"):
        stream.t += 1.0
    with telemetry.span("eval"):
        telemetry._pending[0][2].done = True
    assert FakeEvent.made == 4
    assert telemetry._device_times["gradient"] == pytest.approx(0.001)
    assert "eval" not in telemetry._device_times
    telemetry.take_phase_deltas()
    rec = telemetry.emit_iteration(1, {"grow": 0.5})
    # the eval span queued no device time: its delta is 0 and left out
    assert rec["device_times"] == {"gradient": 0.001, "grow": 0.007,
                                   "histogram": 0.002}
    with telemetry.span("gradient"):
        stream.t += 3.0
    assert telemetry.emit_iteration(2, {})["device_times"] == \
        {"gradient": 0.003}
    summary = telemetry.emit_summary()
    assert summary["device_times"]["gradient"] == pytest.approx(0.004)
    assert summary["roofline"]["fenced_spans"] is False   # no launch notes


def test_unfenced_spans_make_no_events(fake_card):
    telemetry.enable()
    telemetry.reset()
    with telemetry.span("grow"):
        fake_card.t += 1.0
    assert FakeEvent.made == 0
    assert telemetry.snapshot()["device_times"] == {}


def test_disarmed_run_makes_no_event_ring_entry_or_counter(fake_card,
                                                          tmp_path):
    """Disarmed, a span is the shared no-op and ``host_read`` a plain
    ``.cpu()``: a training run and the spans and reads of a card make
    no CUDA event, no ring event and no counter."""
    from lightgbm_tpu_torch import tracing
    telemetry.disable()
    telemetry.reset()
    assert not tracing.active()
    x, y = make_table()
    ds = lgt.Dataset.from_arrays(x[:N_TRAIN], y[:N_TRAIN], max_bin=255)
    lgt.train({"objective": "binary", "num_leaves": 15,
               "num_iterations": 2, "verbose": -1}, ds, device="cpu")
    telemetry.set_device(torch.device("cuda"))
    with telemetry.span("grow") as sp:
        assert sp is telemetry._NULL_SPAN
        assert telemetry.host_read(torch.ones(3)).sum() == 3
    snap = telemetry.snapshot()
    assert FakeEvent.made == 0 and not telemetry._pending
    assert snap["counters"] == {} and snap["wait_times"] == {}
    assert snap["device_times"] == {} and snap["phase_times"] == {}
    assert tracing.events() == [] and tracing.snapshot() == {}


class SlowRead:
    """A device result whose read blocks ``delay`` seconds."""

    def __init__(self, delay):
        self.delay = delay

    def cpu(self):
        threading.Event().wait(self.delay)
        return "read"


def test_host_read_counts_reads_and_files_waits(armed_registry):
    """Each read counts ``sync/d2h_reads`` and adds what it blocked to
    ``wait_times`` under the innermost span open on its thread (its
    host time stays in that span's ``phase_times``)."""
    with telemetry.span("grow"):
        assert telemetry.host_read(SlowRead(0.0)) == "read"
        with telemetry.span("split_find"):
            telemetry.host_read(SlowRead(0.05))
            telemetry.host_read(SlowRead(0.0))
        with telemetry.span("partition"):
            telemetry.host_read(SlowRead(0.02))
    telemetry.host_read(torch.arange(4))
    snap = telemetry.snapshot()
    assert snap["counters"] == {"sync/d2h_reads": 5}
    waits = snap["wait_times"]
    assert set(waits) == {"grow", "split_find", "partition",
                          "outside_spans"}
    assert 0.05 <= waits["split_find"] <= snap["phase_times"]["split_find"]
    assert 0.02 <= waits["partition"] <= snap["phase_times"]["partition"]
    assert waits["grow"] < 0.02
    assert snap["phase_times"]["grow"] >= sum(
        waits[k] for k in ("grow", "split_find", "partition"))


def test_training_reads_go_through_host_read(armed_registry):
    """The compacted grower's reads: the root's stats and split record,
    then a partition count and a split record for each split; and the
    health vector's one read an iteration (armed telemetry turns the
    health monitor on)."""
    x, y = make_table()
    ds = lgt.Dataset.from_arrays(x[:N_TRAIN], y[:N_TRAIN], max_bin=255)
    booster = lgt.train({"objective": "binary", "num_leaves": 15,
                         "num_iterations": 1, "verbose": -1}, ds,
                        device="cpu")
    telemetry.reset()
    booster.train_one_iter(is_eval=False)
    splits = booster.models[-1].num_leaves - 1
    snap = telemetry.snapshot()
    health = booster._health_monitor is not None
    assert snap["counters"]["sync/d2h_reads"] == 2 + 2 * splits + health
    assert set(snap["wait_times"]) == {"grow", "split_find", "partition"} \
        | ({"model_readback"} if health else set())


def test_spans_nest_and_suppress_reentry(armed_registry):
    with telemetry.span("grow"):
        with telemetry.span("histogram"):
            inner = telemetry.span("histogram")
            assert isinstance(inner, telemetry._NullSpan)
            with inner:
                pass
    snap = telemetry.snapshot()
    assert snap["phase_counts"] == {"grow": 1, "histogram": 1}
    assert snap["phase_times"]["grow"] >= snap["phase_times"]["histogram"]
    assert snap["trace_times"] == {}


def test_span_never_swallows_an_exception(armed_registry):
    with pytest.raises(ValueError, match="boom"):
        with telemetry.span("histogram"):
            raise ValueError("boom")
    assert telemetry.snapshot()["phase_counts"] == {"histogram": 1}
    # a wrapper's refusal still raises with telemetry armed
    bins = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="uint8, int16"):
        with telemetry.span("histogram"):
            hist_cuda.hist_float(bins, torch.zeros(8), torch.zeros(8),
                                 torch.zeros(8, dtype=torch.int32), 1, 4)


def test_counters_are_exact_across_threads(armed_registry):
    """Counters bumped from many threads at a short switch interval keep
    every increment."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(2000):
                telemetry.count("serve/rows", 3)
                with telemetry.span("predict"):
                    pass

        threads = [threading.Thread(target=bump) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    snap = telemetry.snapshot()
    assert snap["counters"]["serve/rows"] == 16 * 2000 * 3
    assert snap["phase_counts"]["predict"] == 16 * 2000


def test_count_route_counts_decisions(armed_registry):
    for _ in range(3):
        telemetry.count_route("hist_layout", "hist/mixedbin_off")
    telemetry.count_route("hist_layout", "hist/mixedbin_on")
    assert telemetry.counters() == {"hist/mixedbin_off": 1,
                                    "hist/mixedbin_on": 1}


def test_plain_routes_count_each_call(armed_registry):
    """On CPU tensors every wrapper counts its plain route once a call,
    with the analytic cost of the function it computes."""
    rng = np.random.RandomState(0)
    F, N, B = 4, 1000, 16
    bins = torch.as_tensor(rng.randint(0, B, (F, N)).astype(np.uint8))
    g = torch.as_tensor(rng.randn(N).astype(np.float32))
    cid = torch.zeros(N, dtype=torch.int32)
    hist_cuda.hist_float(bins, g, g.abs(), cid, 1, B)
    hist_cuda.hist_float(bins, g, g.abs(), cid, 1, B)
    lev = torch.zeros((3, N), dtype=torch.int8)
    hist_cuda.hist_int8(bins, lev, cid, 1, B)
    pane = compact.pack_planes(bins, g, g.abs(), torch.ones(N, dtype=bool),
                               2048)
    hist_cuda.hist_pane_float(pane, F, 10, 500, B)
    compact.partition_pane(pane, torch.empty_like(pane), F, 1, 7, 10, 500)
    assert telemetry.counters() == {
        "hist/plain_float": 2, "hist/plain_int8": 1, "hist/plain_pane": 1,
        "partition/plain": 1}
    passes = {tuple(p["key"]): p for p in costmodel.roofline(
        {}, kind="cpu")["traced_passes"]}
    assert passes[("hist/plain_float",)]["bytes_moved"] == 2 * (
        N * F + 12 * N + F * B * 3 * 4)
    assert passes[("partition/plain",)]["bytes_moved"] == \
        2 * compact.pane_rows(F) * 500


def test_memory_gauges_never_read_host_rss_for_a_card(armed_registry):
    """A CPU device reads the host RSS, as the JAX package does for a
    backend without stats; a CUDA device reads its allocator or reports
    ``unavailable`` — never RSS."""
    telemetry.set_memory(True)
    telemetry.set_device(torch.device("cpu"))
    rec = telemetry.take_memory_record()
    assert rec["source"] == "host_rss" and rec["bytes_in_use"] > 0
    telemetry.reset()
    telemetry.set_device(torch.device("cuda"))
    rec = telemetry.take_memory_record()
    if torch.cuda.is_available():
        assert rec["source"] == "device"
    else:
        assert rec["source"] == "unavailable" and rec["bytes_in_use"] == 0


def test_memory_block_and_residency_on_cpu(tmp_path):
    x, y = make_table()
    ds = lgt.Dataset.from_arrays(x[:N_TRAIN], y[:N_TRAIN], max_bin=255)
    sink = tmp_path / "m.jsonl"
    lgt.train({"objective": "binary", "num_leaves": 15,
               "num_iterations": 2, "metrics_out": str(sink),
               "verbose": -1}, ds, device="cpu")
    recs = [json.loads(line) for line in open(sink)]
    res = recs[0]["residency"]
    assert res["bin_matrix_bytes"] == N_TRAIN * F
    assert res["score_bytes"] == N_TRAIN * 4
    mem = recs[-1]["memory"]
    assert mem["source"] == "host_rss" and mem["residency"] == res
    assert mem["peak_bytes_in_use"] >= mem["bytes_in_use"] > 0


def test_watchdog_dumps_on_a_fake_clock(armed_registry, tmp_path):
    """No progress for the timeout: one flight record, naming the
    in-flight phase; the thread is tracked while it runs and joined on
    disarm."""
    now = [0.0]
    telemetry.enable(str(tmp_path / "m.jsonl"))
    assert telemetry.arm_watchdog(5.0, clock=lambda: now[0], poll_s=0.01)
    assert telemetry.watchdog_active()
    assert [k for k, _, _ in lifecycle.leaks()] == ["watchdog"]
    telemetry.watchdog_checkin(phase="grow", iteration=4)
    now[0] = 10.0
    for _ in range(500):
        if telemetry.last_flight_record() is not None:
            break
        threading.Event().wait(0.01)
    rec = telemetry.last_flight_record()["flight_recorder"]
    assert rec["phase"] == "grow" and rec["iteration"] == 4
    assert rec["stalled_for_s"] >= 5.0
    telemetry.disarm_watchdog()
    assert not telemetry.watchdog_active() and lifecycle.leaks() == []
    telemetry.disable()
    lines = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert [list(r) for r in lines] == [["flight_recorder"]]


def test_stall_in_training_leaves_a_flight_dump(tmp_path):
    """``stall_timeout`` with a stall injected at an iteration boundary:
    the sink gets the stall's flight record, naming the iteration, and the
    trace dump dir a dump of reason ``stall``; training continues to the
    same model."""
    from lightgbm_tpu_torch import faults
    x, y = make_table()
    ds = lgt.Dataset.from_arrays(x[:N_TRAIN], y[:N_TRAIN], max_bin=255)
    params = {"objective": "binary", "num_leaves": 7, "num_iterations": 3,
              "verbose": -1}
    plain = lgt.train(params, ds, device="cpu").model_to_string()
    faults.arm(1, "stall", stall_s=2.5)
    try:
        booster = lgt.train(dict(
            params, metrics_out=str(tmp_path / "m.jsonl"),
            stall_timeout="1.0", trace_dump_dir=str(tmp_path / "dumps")),
            ds, device="cpu")
    finally:
        faults.disarm()
    assert booster.model_to_string() == plain
    recs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    # the stall's record; a loaded host may add one (the watchdog re-arms
    # when progress resumes), never without the stall's
    flights = [r["flight_recorder"] for r in recs if "flight_recorder" in r]
    assert any(f["iteration"] == 1 and f["phase"] == "run_training"
               and f["stalled_for_s"] >= 1.0 for f in flights)
    reasons = []
    for name in os.listdir(tmp_path / "dumps"):
        with open(tmp_path / "dumps" / name) as f:
            reasons.append(json.loads(f.readline())["trace_header"]
                           ["reason"])
    assert "stall" in reasons
