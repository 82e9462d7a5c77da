"""The lean traced window (lean.py): on the CPU, its host ranges from the
program's span events and the share of kernels launched inside them; on
the card, each cell at a small size under the lean window with telemetry
event-timed and the flight recorder armed: the histogram and partition
kernels launched inside the program's own spans (the shared clock), a
copy a counted read, and the serving components summing to the clients'
latency."""
import statistics

import pytest

from portbench import lean, run, serve, train
from portbench.trace import Trace
from portbench.tests.test_portbench_card import SEED, SMALL


def test_span_events_become_host_ranges():
    events = [{"name": "histogram", "t0_ns": 50, "t1_ns": 60},
              {"name": "grow", "t0_ns": 0, "t1_ns": 100},
              {"name": "histogram", "t0_ns": 10, "t1_ns": 20}]
    assert lean.span_ranges(events) == {"histogram": [(10, 20), (50, 60)],
                                        "grow": [(0, 100)]}


def test_kernels_launched_inside_their_spans():
    # (name, start, duration, launch stamp)
    ops = [("hist_kernel_f32<4>", 100, 5, 12),
           ("fixed_to_f32", 110, 1, 55),
           ("hist_kernel_f32<4>", 120, 5, 70),       # outside: a stray
           ("partition_move", 130, 2, 81),
           ("Memcpy DtoH (Device -> Pageable)", 140, 1, 85),
           ("elementwise", 150, 1, 15)]
    tr = Trace(ops, lean.span_ranges([
        {"name": "histogram", "t0_ns": 10, "t1_ns": 20},
        {"name": "histogram", "t0_ns": 50, "t1_ns": 60},
        {"name": "partition", "t0_ns": 80, "t1_ns": 90}]), 1.0)
    got = lean.launched_inside(tr)
    assert got["histogram"] == {"kernels": 3, "share": 2 / 3}
    assert got["partition"] == {"kernels": 1, "share": 1.0}
    block = lean.lean_block(tr, 0.5)
    assert block["window_s"] == 1.0 and block["untraced_s"] == 0.5
    assert block["busy_s"] == pytest.approx(15e-9)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def armed(fn):
    """``fn()`` with telemetry armed event-timed and the flight recorder
    armed: its result, the telemetry snapshot and the ring's events."""
    from lightgbm_tpu_torch import telemetry, tracing
    telemetry.enable(fence=True)
    telemetry.reset()
    tracing.arm()
    try:
        return fn(), telemetry.snapshot(), tracing.events()
    finally:
        tracing.disarm()
        telemetry.disable()
        telemetry.reset()


def small(workload):
    _, cfg, traffic, _, _, _ = run.resolve(run.load_benchmark(), workload)
    over = SMALL[workload]
    return (dict(cfg, **over.get("config", {})),
            dict(traffic, **over.get("traffic", {})))


@pytest.mark.cuda
def test_lean_window_on_the_card_train(card):
    """Two ``mslr.train`` iterations at a small size: every histogram
    and partition kernel launched inside its program span (one clock),
    one device-to-host copy a ``host_read``, device time in
    ``gradient``."""
    cfg, traffic = small("mslr.train")
    st = train.setup(cfg, traffic, SEED, card)
    b = st["booster"]

    def window():
        with lean.LeanWindow(b.device) as w:
            for _ in range(2):
                b.train_one_iter(is_eval=False)
        return w

    w, snap, events = armed(window)
    spans = [e for e in events if e["kind"] == "span"]
    tr = lean.lean_trace(w.prof, w.window_s, spans)
    for span, got in lean.launched_inside(tr).items():
        assert got["kernels"] > 0 and got["share"] >= 0.99, (span, got)
    assert snap["counters"]["sync/d2h_reads"] == tr.count("Memcpy DtoH")
    assert snap["device_times"]["gradient"] > 0
    block = lean.lean_block(tr, w.window_s)
    assert 0 < block["busy_s"] <= block["window_s"]
    train.release(st)


@pytest.mark.cuda
def test_lean_window_on_the_card_serve(card):
    """Three seconds of ``higgs.serve`` at a small size: every request
    answered, and the mean of its seven components within 5% of the
    clients' mean latency."""
    cfg, traffic = small("higgs.serve")
    st = serve.setup(cfg, traffic, SEED, card)

    def window():
        with lean.LeanWindow(st["engine"].device) as w:
            recs, _, _ = serve.window(st, float(traffic["trace_seconds"]))
        return w, recs

    (w, recs), _, events = armed(window)
    serve.release(st)
    assert recs and all(r[4] is not None for r in recs)
    done = [e["components_ns"] for e in events
            if e["kind"] == "serve_complete"]
    assert done and all(tuple(c) == (
        "queue", "linger", "coalesce", "encode", "dispatch", "walk",
        "scatter") for c in done)
    ring_ms = statistics.fmean(sum(c.values()) for c in done) / 1e6
    client_ms = statistics.fmean((r[1] - r[0]) * 1e3 for r in recs)
    assert ring_ms == pytest.approx(client_ms, rel=0.05)
    tr = lean.lean_trace(w.prof, w.window_s, [])
    assert 0 < tr.busy_s() <= tr.window_s
