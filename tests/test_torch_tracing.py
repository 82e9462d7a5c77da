"""lightgbm_tpu_torch.tracing (the flight recorder) against
lightgbm_tpu.tracing, live.

The recorder is the port's own copy of a stdlib-only module, so the same
calls must give the same answers bit for bit: sketch quantiles, means
and serialized buckets; the attribution of a request's wall time into
its components (the port splits the JAX package's ``coalesce`` into
``coalesce`` and ``encode``: the rest agree, and the two sum to the JAX
package's one); the ring's occupancy, drops and dump contents (all but
the wall-clock stamps, the process identity and the port's ``encode``).
Then the port's own sites: every ServingFront request's seven components
sum exactly to its wall time, its encode non-zero, the training loop's
events and its spans on the profiler's clock, the crash dumps of the
fault hatch and of ``run_training``, and ``scripts/port_report.py
--check`` accepting what the port writes.  A file-level guard checks the port's
``lifecycle.leaks()`` after every test.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from lightgbm_tpu import telemetry as jtelemetry
from lightgbm_tpu import tracing as jtracing

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import faults, lifecycle, serving, telemetry, tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_leaks():
    yield
    left = lifecycle.leaks()
    for _, _, closer in left:
        closer()
    assert not left, [(k, n) for k, n, _ in left]


@pytest.fixture
def both_armed():
    """Both recorders armed beside their telemetry registries, with no
    process identity (a training run earlier in the process sets one:
    the identity outlives a recorder's arming)."""
    tracing.set_identity(process_index=None, process_count=None)
    jtracing.set_identity(process_index=None, process_count=None)
    telemetry.enable()
    telemetry.reset()
    jtelemetry.enable()
    jtelemetry.reset()
    yield
    tracing.disarm()
    jtracing.disarm()
    telemetry.disable()
    telemetry.reset()
    jtelemetry.disable()
    jtelemetry.reset()


def _values(seed, n=5000):
    rng = np.random.RandomState(seed)
    v = np.exp(rng.randn(n) * 2.0 + 3.0)
    v[::97] = 0.0
    v[::131] = -1.5
    return [float(x) for x in v]


@pytest.mark.parametrize("growth", [1.05, 1.2, 1.0005, 2.0])
def test_sketch_matches_jax_bitwise(growth):
    vals = _values(int(growth * 1000))
    a, b = tracing.LatencySketch(growth), jtracing.LatencySketch(growth)
    for v in vals:
        a.record(v)
        b.record(v)
    a.record(17.0, n=5)
    b.record(17.0, n=5)
    assert a.to_dict() == b.to_dict()
    assert a.percentiles() == b.percentiles()
    for q in (0.0, 0.001, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert a.quantile(q) == b.quantile(q)
    other = tracing.LatencySketch(growth)
    jother = jtracing.LatencySketch(growth)
    for v in _values(5):
        other.record(v)
        jother.record(v)
    assert a.merge(other).to_dict() == b.merge(jother).to_dict()
    assert tracing.LatencySketch.from_dict(a.to_dict()).to_dict() == \
        a.to_dict()


def test_sketch_rejects_what_jax_rejects():
    for g in (1.0, 2.5):
        with pytest.raises(ValueError):
            tracing.LatencySketch(g)
        with pytest.raises(ValueError):
            jtracing.LatencySketch(g)
    with pytest.raises(ValueError, match="different growth"):
        tracing.LatencySketch(1.05).merge(tracing.LatencySketch(1.1))


def test_attribution_matches_jax_and_telescopes():
    """The port's six bounds are the JAX package's five with the encode's
    start between the batch's forming and the encode's end, which stands
    where the JAX package's run start does: the seven components
    telescope, and where the encode starts no later than it ends they are
    the JAX package's six with its ``coalesce`` split in two."""
    rng = np.random.RandomState(3)
    for _ in range(500):
        t0 = int(rng.randint(0, 10**9))
        wall = int(rng.randint(0, 10**7))
        linger, formed, enc0, enc1, disp, done = [
            None if rng.rand() < 0.2 else
            int(t0 + rng.randint(-10**6, wall + 10**6)) for _ in range(6)]
        got = tracing.attribute(t0, t0 + wall,
                                (linger, formed, enc0, enc1, disp, done))
        want = jtracing.attribute(t0, t0 + wall,
                                  (linger, formed, enc1, disp, done))
        assert tuple(got) == tracing.COMPONENTS
        assert sum(got.values()) == wall
        assert min(got.values()) >= 0
        if enc0 is None or (enc1 is not None and enc0 <= enc1):
            assert got["coalesce"] + got["encode"] == want["coalesce"]
            assert {k: v for k, v in got.items()
                    if k not in ("coalesce", "encode")} == \
                {k: v for k, v in want.items() if k != "coalesce"}


def _drive(mod, n_events):
    mod.set_identity(run_id="same-run")
    for i in range(n_events):
        mod.event("step", i=i)
    for v in _values(9, 300):
        mod.observe("serve_wall_us", v)
    mod.bump("serve/dispatch_bucket_32", 3)
    mod.record_train_iteration(4, {"grow": 0.5, "gradient": 0.25})
    mod.record_ingest_pass(2, 1.5, 1000)
    mod.record_ingest_chunk(2, 0, 1000, 10.0, 20.0, 30.0, worker=77)
    # no encode marks: the port's encode is 0, the rest the JAX package's
    bounds = ((200, 300, None, None, 500, 800) if mod is tracing
              else (200, 300, None, 500, 800))
    mod.record_serve_request(5, None, 100, 900, bounds, rows=4, block_ns=10)


def _strip(ev):
    """An event without its wall-clock stamp and the port's encode."""
    ev = {k: v for k, v in ev.items() if k != "t"}
    if "components_ns" in ev:
        ev["components_ns"] = {k: v for k, v in ev["components_ns"].items()
                               if k != "encode"}
    return ev


def _no_encode(sketches):
    """The sketch families but the port's ``serve_encode_us``."""
    return {k: v for k, v in sketches.items() if k != "serve_encode_us"}


def test_ring_snapshot_and_dump_match_jax(both_armed, tmp_path):
    """A ring of 16 slots overflowed by the same calls: the same
    occupancy, exact drop count (mirrored into ``trace/dropped``), sketch
    percentiles and bump counters; dumps with the same header and the same
    events oldest-first, but for the wall-clock stamps and the process."""
    tracing.arm(ring_events=16, dump_dir=str(tmp_path / "port"))
    jtracing.arm(ring_events=16, dump_dir=str(tmp_path / "jax"))
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    _drive(tracing, 40)
    _drive(jtracing, 40)
    snap = tracing.snapshot()
    assert snap["sketches"]["serve_encode_us"]["count"] == 1
    snap["sketches"] = _no_encode(snap["sketches"])
    assert snap == jtracing.snapshot()
    assert tracing.dropped() == 44 - 16
    assert telemetry.counters()["trace/dropped"] == \
        jtelemetry.counters()["trace/dropped"] == 44 - 16
    paths = [tracing.dump(reason="test"), jtracing.dump(reason="test")]
    docs = []
    for path in paths:
        with open(path) as f:
            docs.append([json.loads(line) for line in f])
    (ph, *pev), (jh, *jev) = docs
    drop = {"t", "pid", "host"}
    ph["trace_header"]["sketches"] = _no_encode(
        ph["trace_header"]["sketches"])
    assert {k: v for k, v in ph["trace_header"].items() if k not in drop} \
        == {k: v for k, v in jh["trace_header"].items() if k not in drop}
    assert ph["trace_header"]["run_id"] == "same-run"
    assert [_strip(e) for e in pev] == [_strip(e) for e in jev]
    assert len(pev) == 16
    assert telemetry.counters()["trace/dumps"] == 1
    # each package's checker accepts its own dump
    for script, path in zip(("port_report.py", "trace_report.py"), paths):
        out = subprocess.run([sys.executable, os.path.join(
            REPO, "scripts", script), "--check", path],
            capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr


def test_cumulative_state_matches_jax(both_armed):
    tracing.arm(ring_events=64)
    jtracing.arm(ring_events=64)
    _drive(tracing, 10)
    _drive(jtracing, 10)
    a, b = tracing.cumulative_state(), jtracing.cumulative_state()
    assert {k: v.to_dict() for k, v in _no_encode(a["sketches"]).items()} \
        == {k: v.to_dict() for k, v in b["sketches"].items()}
    assert (a["counters"], a["appended"], a["dropped"]) == \
        (b["counters"], b["appended"], b["dropped"])


def test_disarmed_recorder_records_nothing():
    assert not tracing.active()
    tracing.event("x")
    tracing.observe("serve_wall_us", 3.0)
    assert tracing.next_trace_id() == 0
    assert tracing.snapshot() == {} and tracing.cumulative_state() is None
    comps = tracing.record_serve_request(1, None, 0, 10,
                                         (1, 2, 3, 4, 5, 6), 1)
    assert sum(comps.values()) == 10 and comps["encode"] == 1
    tracing.record_span("grow", 1, 2)
    assert tracing.events() == []
    assert tracing.disarm() is None


def test_armed_recorder_is_a_leak_until_disarmed(tmp_path):
    tracing.arm(ring_events=8, dump_dir=str(tmp_path))
    tracing.event("x")
    assert [k for k, _, _ in lifecycle.leaks()] == ["trace-recorder"]
    path = tracing.disarm()
    assert path and os.path.exists(path) and lifecycle.leaks() == []


def _model(n=3000, f=6, iters=8):
    rng = np.random.RandomState(11)
    x = rng.randn(n, f)
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.randn(n) > 0).astype(
        np.float32)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=63)
    booster = lgt.train({"objective": "binary", "num_leaves": 15,
                         "num_iterations": iters, "verbose": -1}, ds,
                        device="cpu")
    return booster, x


def test_front_attribution_is_exact(tmp_path):
    """Every request through the ServingFront files one
    ``serve_complete`` event whose seven components sum exactly to its
    wall time, its host encode non-zero, after its ``serve_enqueue`` in
    ring order; the dump passes ``port_report.py --check``."""
    booster, x = _model()
    telemetry.enable()
    telemetry.reset()
    tracing.arm(dump_dir=str(tmp_path))
    try:
        engine = booster.serving_engine(linger_us=2000)
        front = serving.ServingFront(engine)
        errors = []

        def client(i):
            rng = np.random.RandomState(i)
            try:
                for _ in range(40):
                    n = rng.randint(1, 20)
                    s0 = rng.randint(0, len(x) - n)
                    got = front.submit(x[s0:s0 + n]).result(30)
                    np.testing.assert_array_equal(
                        got, engine.scores(x[s0:s0 + n]))
            except Exception as e:  # failed on below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        front.close()
        assert not errors and not any(th.is_alive() for th in threads)
        snap = tracing.snapshot()
        assert snap["sketches"]["serve_wall_us"]["count"] == 240
        counters = telemetry.counters()
        assert counters["serve/front_requests"] == 240
        assert counters["serve/coalesced_requests"] == 240
        path = tracing.dump(reason="test")
    finally:
        tracing.disarm()
        telemetry.disable()
    events = [json.loads(line) for line in open(path)][1:]
    done = [e for e in events if e["kind"] == "serve_complete"]
    assert len(done) == 240
    seen = set()
    for e in events:
        if e["kind"] == "serve_enqueue":
            seen.add(e["trace"])
        elif e["kind"] == "serve_complete":
            assert e["trace"] in seen
            assert sum(e["components_ns"].values()) == e["wall_ns"]
            assert tuple(e["components_ns"]) == tracing.COMPONENTS
            assert e["components_ns"]["encode"] > 0
    out = subprocess.run([sys.executable, os.path.join(
        REPO, "scripts", "port_report.py"), "--check", path],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_training_events_and_crash_dumps(tmp_path):
    """A traced training run files one ``train_iter`` event an
    iteration; the fault hatch's raise dumps the ring (reason
    ``fault:injected_raise``), and ``run_training``'s crash path writes
    the summary marked ``aborted`` and a second dump naming the
    exception."""
    rng = np.random.RandomState(5)
    x = rng.randn(2000, 6)
    y = (x[:, 0] > 0).astype(np.float32)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=63)
    params = {"objective": "binary", "num_leaves": 7, "num_iterations": 6,
              "verbose": -1, "metrics_out": str(tmp_path / "m.jsonl"),
              "trace_dump_dir": str(tmp_path / "dumps"),
              "trace_run_id": "crash-run", "bagging_fraction": 0.5,
              "bagging_freq": 1}
    faults.arm(3, "raise")
    try:
        with pytest.raises(RuntimeError, match="injected fault"):
            lgt.train(params, ds, device="cpu")
    finally:
        faults.disarm()
    recs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert recs[-1]["summary"] and recs[-1]["aborted"] == "RuntimeError"
    assert recs[-1]["iterations"] == 3
    dumps = {}
    for name in os.listdir(tmp_path / "dumps"):
        with open(tmp_path / "dumps" / name) as f:
            lines = [json.loads(line) for line in f]
        dumps[lines[0]["trace_header"]["reason"]] = lines
    assert set(dumps) >= {"fault:injected_raise", "fault:RuntimeError"}
    head, *events = dumps["fault:injected_raise"]
    assert head["trace_header"]["run_id"] == "crash-run"
    kinds = [e["kind"] for e in events]
    assert kinds.count("train_iter") == 3
    assert kinds.count("bagging_draw") == 3
    for lines in dumps.values():
        path = str(tmp_path / "one.jsonl")
        with open(path, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in lines))
        out = subprocess.run([sys.executable, os.path.join(
            REPO, "scripts", "port_report.py"), "--check", path],
            capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr


def test_checkpoint_and_goss_events(tmp_path):
    """The checkpoint writer files ``ckpt_write`` events and the
    ``ckpt/*`` counters; GOSS files ``goss_draw`` and
    ``goss/iterations``."""
    rng = np.random.RandomState(6)
    x = rng.randn(3000, 6)
    y = (x[:, 0] > 0).astype(np.float32)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=63)
    sink = tmp_path / "m.jsonl"
    lgt.train({"objective": "binary", "num_leaves": 7, "num_iterations": 4,
               "verbose": -1, "metrics_out": str(sink), "goss": "true",
               "checkpoint_interval": 1, "checkpoint_keep": 1,
               "checkpoint_dir": str(tmp_path / "ck"),
               "trace_dump_dir": str(tmp_path / "dumps")}, ds, device="cpu")
    summary = [json.loads(line) for line in open(sink)][-1]
    ctr = summary["counters"]
    assert ctr["goss/iterations"] == 4
    assert ctr["ckpt/written"] >= 2 and ctr["ckpt/pruned"] >= 1
    assert ctr["ckpt/snapshots"] == 4
    assert ctr.get("ckpt/dropped", 0) + ctr["ckpt/written"] >= 2
    (name,) = os.listdir(tmp_path / "dumps")
    kinds = [json.loads(line).get("kind")
             for line in open(tmp_path / "dumps" / name)]
    assert kinds.count("goss_draw") == 4 and "ckpt_write" in kinds


def test_span_events_nest_in_order_within_the_dump_window(tmp_path):
    """Armed with the flight recorder, every telemetry span files one
    ``span`` event at its exit: an inner span's event comes before its
    outer span's and lies inside it, the events of one thread are in the
    order their spans closed, and every stamp falls between the arming
    and the dump's header stamp."""
    telemetry.enable()
    telemetry.reset()
    tracing.arm(dump_dir=str(tmp_path))
    try:
        t_arm = tracing.clock_ns()
        with telemetry.span("grow"):
            for _ in range(3):
                with telemetry.span("histogram"):
                    pass
                with telemetry.span("split_find"):
                    with telemetry.span("partition"):
                        pass
        other = threading.Thread(target=lambda: telemetry.span(
            "predict").__enter__().__exit__(None, None, None))
        other.start()
        other.join(30)
        path = tracing.dump(reason="test")
    finally:
        tracing.disarm()
        telemetry.disable()
        telemetry.reset()
    head, *events = [json.loads(line) for line in open(path)]
    spans = [e for e in events if e["kind"] == "span"]
    assert [e["name"] for e in spans] == \
        ["histogram", "partition", "split_find"] * 3 + ["grow", "predict"]
    t_dump = int(head["trace_header"]["t"] * 1e9) + 1000
    for e in spans:
        assert t_arm <= e["t0_ns"] <= e["t1_ns"] <= t_dump, e
    main = [e for e in spans if e["name"] != "predict"]
    assert {e["thread"] for e in main} == {threading.get_native_id()}
    assert spans[-1]["thread"] != threading.get_native_id()
    ends = [e["t1_ns"] for e in main]
    assert ends == sorted(ends)
    grow = main[-1]
    for e in main[:-1]:
        assert grow["t0_ns"] <= e["t0_ns"] <= e["t1_ns"] <= grow["t1_ns"]
    for k in range(3):
        part, split = main[3 * k + 1], main[3 * k + 2]
        assert split["t0_ns"] <= part["t0_ns"] <= part["t1_ns"] \
            <= split["t1_ns"]
        assert main[3 * k]["t1_ns"] <= split["t0_ns"]
    out = subprocess.run([sys.executable, os.path.join(
        REPO, "scripts", "port_report.py"), "--check", path],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_span_events_read_the_thread_id_once(monkeypatch):
    """The native thread id a span event carries is read once a thread:
    ``threading.get_native_id`` is a system call."""
    calls = []
    real = threading.get_native_id
    monkeypatch.setattr(threading, "get_native_id",
                        lambda: calls.append(1) or real())
    monkeypatch.setattr(tracing._tls, "native_id", None, raising=False)
    telemetry.enable()
    telemetry.reset()
    tracing.arm()
    try:
        for _ in range(5):
            with telemetry.span("histogram"):
                pass
        spans = tracing.events("span")
    finally:
        tracing.disarm()
        telemetry.disable()
        telemetry.reset()
    assert len(spans) == 5 and len(calls) == 1
    assert {e["thread"] for e in spans} == {real()}


def test_port_report_check_catches_violations(tmp_path):
    """``port_report.check`` passes a clean seven-component dump and
    finds a JAX package's six components, a negative encode, a broken
    identity and a span that ends before it starts."""
    from scripts import port_report
    comps = dict(zip(tracing.COMPONENTS, (5, 1, 2, 30, 4, 20, 1)))

    def findings(done, span):
        events = [{"kind": "serve_enqueue", "t": 1.0, "trace": 1}, done,
                  dict({"kind": "span", "t": 1.0, "name": "predict",
                        "thread": 7}, **span)]
        path = str(tmp_path / "d.jsonl")
        with open(path, "w") as f:
            f.write(json.dumps({"trace_header": {
                "events": 3, "appended": 3, "dropped": 0}}) + "\n")
            f.write("".join(json.dumps(e) + "\n" for e in events))
        return port_report.check(path, *port_report.trace_report.load(path))

    def done(c, wall=None):
        return {"kind": "serve_complete", "t": 1.0, "trace": 1,
                "components_ns": c,
                "wall_ns": sum(c.values()) if wall is None else wall}

    ok = {"t0_ns": 10, "t1_ns": 20}
    assert port_report.COMPONENTS == tracing.COMPONENTS
    assert findings(done(comps), ok) == []
    six = {k: v for k, v in comps.items() if k != "encode"}
    assert any("not queue" in f for f in findings(done(six), ok))
    neg = dict(comps, encode=-5, coalesce=37)
    assert any("negative encode" in f for f in findings(done(neg), ok))
    assert any("identity broken" in f
               for f in findings(done(comps, wall=1), ok))
    assert any("ends" in f for f in findings(
        done(comps), {"t0_ns": 20, "t1_ns": 10}))


def test_span_events_are_on_the_profilers_clock():
    """A span's ring stamps lie inside the ``record_function`` range
    ``torch.profiler`` stamps for it (the span opens the range before its
    first stamp and closes it after its last), to the profiler clock's
    conversion error."""
    import torch
    telemetry.enable()
    telemetry.reset()
    tracing.arm()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(5):
                with telemetry.span("histogram"):
                    sum(range(20000))
        ring = tracing.events("span")
    finally:
        tracing.disarm()
        telemetry.disable()
        telemetry.reset()
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "histogram")
    assert len(ranges) == len(ring) == 5
    slack = 200_000
    for (a, b), e in zip(ranges, ring):
        assert a - slack <= e["t0_ns"] <= e["t1_ns"] <= b + slack
        assert e["t1_ns"] - e["t0_ns"] <= (b - a) + slack


def test_train_iteration_sketch_sums_the_top_level_phases():
    """``grow`` holds ``histogram``, ``split_find`` and ``partition``:
    the ``train_iter_us`` sketch takes the iteration's top-level phases
    alone, so an iteration counts once."""
    telemetry.enable()
    tracing.arm(ring_events=8, sketch_growth=1.0005)
    try:
        phases = {"gradient": 0.25, "grow": 1.0, "histogram": 0.5,
                  "split_find": 0.25, "partition": 0.125,
                  "score_update": 0.0625, "eval": 0.0}
        tracing.record_train_iteration(1, phases)
        snap = tracing.snapshot()["sketches"]["train_iter_us"]
    finally:
        tracing.disarm()
        telemetry.disable()
        telemetry.reset()
    assert snap["count"] == 1
    assert snap["p50"] == pytest.approx(1.3125e6, rel=1e-3)
