"""lightgbm_tpu_torch.monitor and the ``score_reference=`` line, against
lightgbm_tpu live.

- The stdlib parts agree bit for bit: ``ScoreHistogram.to_dict`` (signed
  buckets, clamps, NaN / Inf / tiny values), ``psi``, ``drift_verdict``,
  ``aa_verdict``, ``sketch_subtract``, ``bad_count``; and the monitor's
  windows on a fake clock: the same counter and sketch deltas, SLO burn
  rates and breaches, the same JSONL lines but for the wall-clock stamps
  and the process identity.
- ``scripts/monitor_report.py --check`` accepts the port's file, after a
  clean close and after a fault flush.
- The ``score_reference=`` line: the port's capture, fed the JAX
  package's exact scores, writes the JAX package's line byte for byte; a
  JAX model file loaded by the port keeps its reference, and the port's
  engine uses it as the drift baseline; the two command lines' files on
  the same data agree in their reference to a PSI of at most 1e-4, with
  equal totals (their leaf values may differ in the last bit).
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from lightgbm_tpu import monitor as jmonitor
from lightgbm_tpu import telemetry as jtelemetry
from lightgbm_tpu import tracing as jtracing
from lightgbm_tpu.cli import main as jcli
from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.objectives import create_objective as jobjective

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import lifecycle, monitor, serving, telemetry, tracing
from lightgbm_tpu_torch.cli import main as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_leaks():
    yield
    left = lifecycle.leaks()
    for _, _, closer in left:
        closer()
    assert not left, [(k, n) for k, n, _ in left]


def _scores(seed, n=20000):
    rng = np.random.RandomState(seed)
    v = rng.randn(n) * 3 + 0.5
    v[::50] = 0.0
    v[::77] = 1e-14
    v[::91] = np.nan
    v[::113] = np.inf
    v[::127] = -np.inf
    v[::139] = 1e9
    v[::149] = -1e-5
    return v


@pytest.mark.parametrize("growth", [2.0, 1.5, 1.0005, 4.0])
def test_score_histogram_matches_jax(growth):
    v = _scores(int(growth * 10))
    a, b = monitor.ScoreHistogram(growth), jmonitor.ScoreHistogram(growth)
    assert a.record_many(v) == b.record_many(v) == len(v)
    for x in v[:300]:
        a.record(x)
        b.record(x)
    assert a.to_dict() == b.to_dict()
    assert a.count == b.count
    c = monitor.ScoreHistogram.from_dict(a.to_dict())
    assert c.merge(a).to_dict() == jmonitor.ScoreHistogram.from_dict(
        b.to_dict()).merge(b).to_dict()


def test_psi_and_verdicts_match_jax():
    ref, live = _scores(1), _scores(2) * 1.3 + 0.2
    hists = []
    for mod in (monitor, jmonitor):
        r, l2 = mod.ScoreHistogram(), mod.ScoreHistogram()
        r.record_many(ref)
        l2.record_many(live)
        hists.append((r, l2))
    (r, l2), (jr, jl) = hists
    assert monitor.psi(r, l2) == jmonitor.psi(jr, jl)
    assert monitor.psi(r.to_dict(), l2.to_dict()) == monitor.psi(r, l2)
    assert monitor.drift_verdict(r, l2) == jmonitor.drift_verdict(jr, jl)
    assert monitor.psi(r, monitor.ScoreHistogram()) is None
    assert monitor.drift_verdict(None, None) == \
        jmonitor.drift_verdict(None, None)


def test_sketch_subtract_and_bad_count_match_jax():
    rng = np.random.RandomState(4)
    out = []
    for trace_mod, mod in ((tracing, monitor), (jtracing, jmonitor)):
        prev, cur = trace_mod.LatencySketch(), trace_mod.LatencySketch()
        for v in rng.exponential(300, 2000):
            prev.record(v)
            cur.record(v)
        for v in rng.exponential(800, 500):
            cur.record(v)
        d = mod.sketch_subtract(cur, prev)
        out.append((d.to_dict(), mod.bad_count(d, 500.0),
                    mod.sketch_subtract(cur, None).to_dict()))
        with pytest.raises(ValueError, match="negative"):
            mod.sketch_subtract(prev, cur)
        rng = np.random.RandomState(4)
    assert out[0] == out[1]


def _session(pkg, path, values, breaches):
    """Arm (telemetry, tracing, monitor) of one package, drive 8 windows
    on a fake clock, return the ring, the drift verdicts and the file's
    lines."""
    tel, trc, mon = pkg
    tel.enable()
    tel.reset()
    trc.arm(ring_events=4096)
    mon.arm(out_path=path, interval_s=1.0, slo_p99_us=500.0,
            slo_window_s=6.0, emitter=False)
    try:
        key = mon.engine_key()
        mon.register_reference(key, values["ref"])
        for w in range(8):
            for v in values["lat"][w]:
                trc.observe("serve_wall_us", float(v))
            tel.count("serve/front_requests", len(values["lat"][w]))
            mon.record_scores(key, values["live"][w])
            mon.tick(now=1000.0 + w)
        ring = mon.monitor_snapshot()["windows"]
        drift = mon.engine_drift(key)
        breaches.append(mon.monitor_snapshot()["breaches"])
    finally:
        mon.disarm()
        trc.disarm()
        tel.disable()
        tel.reset()
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    return ring, drift, lines


def test_windows_match_jax_on_a_fake_clock(tmp_path):
    rng = np.random.RandomState(12)
    ref = monitor.ScoreHistogram()
    ref.record_many(rng.randn(5000))
    values = {"ref": ref.to_dict(),
              "lat": [rng.exponential(200 if w < 4 else 900, 200)
                      for w in range(8)],
              "live": [rng.randn(300) * (1 + w / 4.0) for w in range(8)]}
    breaches = []
    got = _session((telemetry, tracing, monitor), str(tmp_path / "p.jsonl"),
                   values, breaches)
    want = _session((jtelemetry, jtracing, jmonitor),
                    str(tmp_path / "j.jsonl"), values, breaches)
    strip = lambda w: {k: v for k, v in w.items() if k != "t0"}  # noqa
    assert [strip(w) for w in got[0]] == [strip(w) for w in want[0]]
    assert [w["t0"] for w in got[0][1:]] == [w["t0"] for w in want[0][1:]]
    assert got[1] == want[1]
    assert breaches[0] == breaches[1] > 0
    assert [list(r) for r in got[2]] == [list(r) for r in want[2]]
    hp, hj = got[2][0]["monitor_header"], want[2][0]["monitor_header"]
    drop = {"t", "host", "pid", "run_id"}
    assert {k: v for k, v in hp.items() if k not in drop} == \
        {k: v for k, v in hj.items() if k not in drop}
    cp, cj = got[2][-1]["monitor_close"], want[2][-1]["monitor_close"]
    assert {k: v for k, v in cp.items() if k not in ("t", "drift")} == \
        {k: v for k, v in cj.items() if k not in ("t", "drift")}
    assert list(cp["drift"].values()) == list(cj["drift"].values())
    out = subprocess.run([sys.executable, os.path.join(
        REPO, "scripts", "monitor_report.py"), "--check",
        str(tmp_path / "p.jsonl")], capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_armed_monitor_is_a_leak_until_disarmed(tmp_path):
    monitor.arm(out_path=str(tmp_path / "m.jsonl"), interval_s=0.05)
    kinds = sorted(k for k, _, _ in lifecycle.leaks())
    assert kinds == ["monitor", "monitor-emitter"]
    threading.Event().wait(0.3)
    assert monitor.disarm() == str(tmp_path / "m.jsonl")
    assert lifecycle.leaks() == []
    lines = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert sum("monitor_window" in r for r in lines) >= 2
    assert "monitor_close" in lines[-1]


def test_fault_flush_leaves_a_checked_file(tmp_path):
    """The fault hatch's raise closes the monitor's window first: the
    file ends with a ``fault:*`` close record that monitor_report.py
    accepts."""
    from lightgbm_tpu_torch import faults
    rng = np.random.RandomState(1)
    x = rng.randn(1500, 5)
    y = (x[:, 0] > 0).astype(np.float32)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=63)
    path = str(tmp_path / "m.jsonl")
    faults.arm(2, "raise")
    try:
        with pytest.raises(RuntimeError, match="injected fault"):
            lgt.train({"objective": "binary", "num_leaves": 7,
                       "num_iterations": 5, "verbose": -1,
                       "monitor_out": path, "monitor_interval_s": 0.05},
                      ds, device="cpu")
    finally:
        faults.disarm()
    lines = [json.loads(line) for line in open(path)]
    closes = [r["monitor_close"]["reason"] for r in lines
              if "monitor_close" in r]
    assert closes[0] == "fault:injected_raise"
    out = subprocess.run([sys.executable, os.path.join(
        REPO, "scripts", "monitor_report.py"), "--check", path],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ---- the score_reference= line


def _table(seed=3, n=2500, f=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f)
    y = (x[:, 0] - 0.5 * x[:, 1] + 0.3 * rng.randn(n) > 0).astype(
        np.float32)
    return x, y


def _jax_booster(x, y, params, tmp_path):
    cfg = JConfig()
    cfg.set({k: str(v) for k, v in params.items()}, require_data=False)
    ds = JDataset.from_arrays(x, y, max_bin=63)
    booster = JGBDT()
    booster.init(cfg.boosting_config, ds,
                 jobjective(cfg.objective_type, cfg.objective_config), [])
    for _ in range(3):
        booster.train_one_iter(is_eval=False)
    path = str(tmp_path / "jax_model.txt")
    booster.save_model_to_file(True, path)
    return booster, path


def _line(text):
    (line,) = [ln for ln in text.split("\n")
               if ln.startswith("score_reference=")]
    return line


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_capture_of_jax_scores_writes_the_jax_line(objective, tmp_path):
    x, y = _table()
    params = {"objective": objective, "num_leaves": 7, "verbose": -1}
    if objective == "multiclass":
        y = np.digitize(x[:, 0], [-0.5, 0.5]).astype(np.float32)
        params.update(num_class=3)
    jb, jpath = _jax_booster(x, y, params, tmp_path)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=63)
    tb = lgt.train(dict(params, num_iterations=1), ds, device="cpu")
    tb.score = torch.from_numpy(np.array(jb.score, dtype=np.float32))
    with open(jpath) as f:
        assert tb._score_reference_line() == _line(f.read()) + "\n"


def test_jax_model_file_keeps_its_reference_in_the_port(tmp_path):
    """Loaded by the port, a JAX model file keeps its reference; its
    engine carries it, a saved copy writes it again, and a front with the
    monitor armed computes drift against it."""
    x, y = _table()
    _, jpath = _jax_booster(x, y, {"objective": "binary", "num_leaves": 7},
                            tmp_path)
    with open(jpath) as f:
        want = json.loads(_line(f.read()).split("=", 1)[1])
    tb = lgt.GBDT.from_model_file(jpath, device="cpu")
    assert tb.score_reference == want
    assert _line(tb.model_to_string()) == "score_reference=" + json.dumps(
        want, separators=(",", ":"))
    engine = tb.serving_engine()
    assert engine.flat.score_reference == want
    monitor.arm()
    try:
        with serving.ServingFront(engine) as front:
            for s in range(0, 2000, 100):
                front.predict(x[s:s + 100], timeout=30)
        (key,) = monitor.monitor_snapshot()["drift"]
        verdict = monitor.engine_drift(key)
    finally:
        monitor.disarm()
    assert verdict["ref_count"] == monitor.ScoreHistogram.from_dict(
        want).count == 2500
    assert verdict["live_count"] == 2000
    assert verdict["psi"] is not None and verdict["psi"] < 0.2


def test_two_command_lines_agree_in_their_reference(tmp_path):
    x, y = _table(seed=8)
    train = str(tmp_path / "train.tsv")
    np.savetxt(train, np.column_stack([y, x]), delimiter="\t", fmt="%.6g")
    refs = []
    for main, extra in ((jcli, []), (tcli, ["device=cpu"])):
        model = str(tmp_path / ("m%d.txt" % len(refs)))
        assert main(["task=train", "data=" + train, "objective=binary",
                     "num_leaves=15", "num_iterations=5",
                     "leafwise_compact=true", "verbose=-1",
                     "output_model=" + model] + extra) == 0
        with open(model) as f:
            refs.append(json.loads(_line(f.read()).split("=", 1)[1]))
    a, b = (monitor.ScoreHistogram.from_dict(r) for r in refs)
    assert a.count == b.count == len(y)
    assert monitor.psi(a, b) <= 1e-4


def test_port_model_file_round_trips_its_reference(tmp_path):
    x, y = _table()
    ds = lgt.Dataset.from_arrays(x, y, max_bin=63)
    booster = lgt.train({"objective": "binary", "num_leaves": 7,
                         "num_iterations": 3, "verbose": -1}, ds,
                        device="cpu")
    path = str(tmp_path / "m.txt")
    booster.save_model_to_file(True, path)
    with open(path) as f:
        text = f.read()
    assert text == booster.model_to_string()
    loaded = lgt.GBDT.from_model_file(path, device="cpu")
    assert loaded.score_reference == booster.score_reference
    assert loaded.model_to_string() == text
    # the JAX package reads the port's line back
    jb = JGBDT.from_model_file(path)
    assert jb.score_reference == booster.score_reference
