"""Live monitoring: windowed metrics, the SLO burn rate, serving-side
score drift.

The port's copy of lightgbm_tpu/monitor.py (stdlib, numpy for bulk
bucketing).  Telemetry counters are cumulative since enable and the
flight recorder's sketches all-time; this module is the live tier on top
of them.  It owns no instrumentation sites: it differences the
cumulative state those layers keep.

1. **Windowed metrics.**  A fixed-memory ring of per-interval snapshots.
   Each closed window carries the counter deltas (telemetry registry) and
   the per-family latency-sketch deltas since the previous window: a
   window sketch is the exact per-bucket subtraction of two cumulative
   sketches (:func:`sketch_subtract`), both read under one lock
   (``tracing.cumulative_state``), so ``sum(window deltas) == cumulative
   total`` holds exactly; ``scripts/monitor_report.py --check`` validates
   it per window.  Exposed live by :func:`monitor_snapshot` and appended
   per window to a JSONL file by an emitter thread (``monitor_out=`` /
   ``monitor_interval_s=``; the thread is tracked by ``lifecycle``).  The
   file is closed by ``telemetry.disable()`` and from the faults.py crash
   path (:func:`flush_on_fault`).

2. **SLO burn rate.**  A latency objective for one serve family
   (``slo_p99_us=`` target, ``slo_window_s=`` budget window).  A p99
   objective grants a 1% error budget (``SLO_BUDGET``); a window's bad
   fraction is the sketch mass in buckets whose representative exceeds
   the target.  A breach needs both the short window (long/12) burning
   at >= 5x (``FAST_BURN``) and the long window at >= 1x
   (``SLOW_BURN``).  Each breach files an ``slo_breach`` event into the
   trace ring next to a per-window ``monitor_window`` marker.

3. **Score drift.**  :class:`ScoreHistogram` is a signed log-bucket
   histogram.  ``ServingFront`` feeds predicted scores into a per-engine
   live histogram; :func:`drift_verdict` computes a PSI over the matched
   bucket union against the training-time reference of the model file's
   ``score_reference=`` line.  An A/A self-check (alternate scores split
   into two halves, :func:`aa_verdict`) bounds the false-positive rate.

The armed monitor is process-global state: a lifecycle probe
(``monitor``) makes a leak check fail a test that leaves it armed.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, List, Optional

from . import lifecycle, telemetry, tracing

DEFAULT_INTERVAL_S = 1.0
DEFAULT_SLO_WINDOW_S = 60.0
DEFAULT_WINDOW_RING = 240
DEFAULT_SLO_FAMILY = "serve_wall_us"

# a p99 latency objective grants a 1% error budget; burn rate is the
# window's bad fraction divided by this budget
SLO_BUDGET = 0.01
FAST_BURN = 5.0       # short-window burn threshold (the "is it NOW" arm)
SLOW_BURN = 1.0       # long-window burn threshold (the "does it matter" arm)
SHORT_WINDOW_RATIO = 12   # short window = slo_window_s / 12 (SRE convention)

DRIFT_GROWTH = 2.0        # score-bucket growth (much coarser than latency:
#                           PSI sampling noise grows with bucket count, so
#                           drift wants few well-filled buckets, not tails)
DRIFT_MIN_BUCKET = -6     # |score| < growth**-6 collapses into one bucket
DRIFT_MAX_BUCKET = 24     # ... and the far overflow tail into another;
#                           both clamps bound the PSI union size (and with
#                           it the A/A noise floor) regardless of score range
DRIFT_PSI_THRESHOLD = 0.2  # industry PSI rule: > 0.2 = significant shift
AA_PSI_BOUND = 0.05        # documented A/A false-positive bound
_TINY = 1e-12              # |score| below this lands in the zero bucket
_PSI_EPSILON = 1e-4        # additive smoothing over the bucket union


# ------------------------------------------------------------ score buckets

class ScoreHistogram:
    """Signed log-bucket histogram for model scores.

    Latency sketches are positive-only; raw ensemble margins are
    signed, so this keeps SEPARATE positive and negative bucket maps
    around a zero bucket: value ``v`` lands in bucket
    ``floor(log(|v|)/log(g))`` of its sign's map, clamped into
    ``[DRIFT_MIN_BUCKET, DRIFT_MAX_BUCKET]`` (non-finite and
    ``|v| < 1e-12`` land in zero).  The clamp bounds the PSI bucket
    union — sparse log-tail buckets would otherwise dominate the PSI
    sampling-noise floor and sink the A/A bound.  ``merge`` is per-sign
    bucket
    addition — associative, the cross-batch fold — and
    ``to_dict``/``from_dict`` round-trip through the model file's
    ``score_reference=`` metadata line."""

    __slots__ = ("growth", "_log_g", "zero", "pos", "neg")

    def __init__(self, growth: float = DRIFT_GROWTH):
        growth = float(growth)
        if not (1.0005 <= growth <= 4.0):
            raise ValueError("score-histogram growth must be in "
                             "[1.0005, 4.0], got %g" % growth)
        self.growth = growth
        self._log_g = math.log(growth)
        self.zero = 0
        self.pos: Dict[int, int] = {}
        self.neg: Dict[int, int] = {}

    def record(self, value: float, n: int = 1) -> None:
        v = float(value)
        if not math.isfinite(v) or abs(v) < _TINY:
            self.zero += n
            return
        i = int(math.floor(math.log(abs(v)) / self._log_g))
        i = min(max(i, DRIFT_MIN_BUCKET), DRIFT_MAX_BUCKET)
        d = self.pos if v > 0 else self.neg
        d[i] = d.get(i, 0) + n

    def record_many(self, values) -> int:
        """Bulk record (numpy-vectorized when available; bucket indices
        are identical to scalar :meth:`record` — both float64).
        Returns the number of values recorded."""
        try:
            import numpy as np
        except Exception:  # pragma: no cover - numpy is always present
            np = None
        if np is None:  # pragma: no cover
            cnt = 0
            for x in values:
                self.record(float(x))
                cnt += 1
            return cnt
        v = np.asarray(values, dtype=np.float64).ravel()
        if v.size == 0:
            return 0
        keep = np.isfinite(v)
        self.zero += int(v.size - keep.sum())
        v = v[keep]
        tiny = np.abs(v) < _TINY
        self.zero += int(tiny.sum())
        v = v[~tiny]
        if v.size:
            idx = np.floor(np.log(np.abs(v)) / self._log_g).astype(np.int64)
            idx = np.clip(idx, DRIFT_MIN_BUCKET, DRIFT_MAX_BUCKET)
            sign = v > 0
            for mask, d in ((sign, self.pos), (~sign, self.neg)):
                ii, cc = np.unique(idx[mask], return_counts=True)
                for i, c in zip(ii.tolist(), cc.tolist()):
                    d[i] = d.get(i, 0) + int(c)
        return int(keep.size)

    @property
    def count(self) -> int:
        return self.zero + sum(self.pos.values()) + sum(self.neg.values())

    def merge(self, other: "ScoreHistogram") -> "ScoreHistogram":
        if abs(other.growth - self.growth) > 1e-12:
            raise ValueError("cannot merge score histograms with different "
                             "growth (%g vs %g)" % (self.growth, other.growth))
        self.zero += other.zero
        for src, dst in ((other.pos, self.pos), (other.neg, self.neg)):
            for i, c in src.items():
                dst[i] = dst.get(i, 0) + c
        return self

    def to_dict(self) -> dict:
        return {"growth": self.growth, "zero": self.zero,
                "pos": {str(i): c for i, c in self.pos.items()},
                "neg": {str(i): c for i, c in self.neg.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "ScoreHistogram":
        h = cls(d.get("growth", DRIFT_GROWTH))
        h.zero = int(d.get("zero", 0))
        h.pos = {int(i): int(c) for i, c in (d.get("pos") or {}).items()}
        h.neg = {int(i): int(c) for i, c in (d.get("neg") or {}).items()}
        return h


def psi(reference, live, epsilon: float = _PSI_EPSILON) -> Optional[float]:
    """PSI-style divergence over the matched bucket union of two score
    histograms (dicts or :class:`ScoreHistogram`).  Each term is
    ``(q - p) * ln(q / p)`` with additive ``epsilon`` smoothing, so the
    sum is >= 0 and symmetric.  None when either side is empty (no
    verdict without data)."""
    ref = ScoreHistogram.from_dict(reference) if isinstance(reference, dict) \
        else reference
    liv = ScoreHistogram.from_dict(live) if isinstance(live, dict) else live
    if ref is None or liv is None:
        return None
    if ref.count == 0 or liv.count == 0:
        return None
    if abs(ref.growth - liv.growth) > 1e-12:
        raise ValueError("cannot compare score histograms with different "
                         "growth (%g vs %g)" % (ref.growth, liv.growth))
    keys = {("z", 0)}
    for h in (ref, liv):
        keys.update(("p", i) for i in h.pos)
        keys.update(("n", i) for i in h.neg)
    k = len(keys)
    rt, lt = float(ref.count), float(liv.count)
    total = 0.0
    for sign, i in keys:
        if sign == "z":
            rc, lc = ref.zero, liv.zero
        elif sign == "p":
            rc, lc = ref.pos.get(i, 0), liv.pos.get(i, 0)
        else:
            rc, lc = ref.neg.get(i, 0), liv.neg.get(i, 0)
        p = (rc + epsilon) / (rt + epsilon * k)
        q = (lc + epsilon) / (lt + epsilon * k)
        total += (q - p) * math.log(q / p)
    return total


def drift_verdict(reference, live,
                  threshold: float = DRIFT_PSI_THRESHOLD) -> dict:
    """The swap-gate primitive: PSI of live scores against the
    training-time reference, plus the boolean verdict.  ``psi`` is None
    (and ``drift`` False) when either histogram is empty."""
    ref = ScoreHistogram.from_dict(reference) if isinstance(reference, dict) \
        else reference
    liv = ScoreHistogram.from_dict(live) if isinstance(live, dict) else live
    value = psi(ref, liv)
    return {
        "psi": value,
        "threshold": float(threshold),
        "drift": bool(value is not None and value > threshold),
        "ref_count": 0 if ref is None else ref.count,
        "live_count": 0 if liv is None else liv.count,
    }


# --------------------------------------------------------- window subtraction

def sketch_subtract(cur: "tracing.LatencySketch",
                    prev: Optional["tracing.LatencySketch"]
                    ) -> "tracing.LatencySketch":
    """Exact window sketch: per-bucket subtraction of two cumulative
    sketches (the inverse of the associative merge).  Raises when the
    growth factors differ or any count would go negative — a cumulative
    sketch is monotone, so a negative delta means the caller mixed
    baselines, never a rounding artifact."""
    delta = tracing.LatencySketch(cur.growth)
    if prev is None:
        delta.zero = cur.zero
        delta.buckets = dict(cur.buckets)
        return delta
    if abs(cur.growth - prev.growth) > 1e-12:
        raise ValueError("cannot subtract sketches with different growth "
                         "(%g vs %g)" % (cur.growth, prev.growth))
    delta.zero = cur.zero - prev.zero
    if delta.zero < 0:
        raise ValueError("window sketch subtraction went negative "
                         "(zero bucket)")
    for i, c in cur.buckets.items():
        d = c - prev.buckets.get(i, 0)
        if d < 0:
            raise ValueError("window sketch subtraction went negative "
                             "(bucket %d)" % i)
        if d:
            delta.buckets[i] = d
    for i, c in prev.buckets.items():
        if i not in cur.buckets and c > 0:
            raise ValueError("window sketch subtraction went negative "
                             "(bucket %d vanished)" % i)
    return delta


def bad_count(sketch: "tracing.LatencySketch", threshold_us: float) -> int:
    """Observations whose bucket representative exceeds the SLO target —
    the window's error count at sketch resolution (the zero bucket is
    always good)."""
    return sum(c for i, c in sketch.buckets.items()
               if sketch.growth ** (i + 0.5) > threshold_us)


# ------------------------------------------------------------- monitor state

_lock = threading.RLock()
_armed = False
_closed = False               # a close/fault record was already written
_out_path = ""
_file = None
_interval_s = DEFAULT_INTERVAL_S
_ring: List[dict] = []
_ring_cap = DEFAULT_WINDOW_RING
_window_seq = 0
_emitted = 0
_breaches = 0
_prev: Optional[dict] = None  # previous cumulative baseline
_slo_p99_us = 0.0
_slo_window_s = DEFAULT_SLO_WINDOW_S
_slo_family = DEFAULT_SLO_FAMILY
_short_n = 1
_long_n = 1
_thread: Optional[threading.Thread] = None
_stop: Optional[threading.Event] = None
_drift: Dict[str, dict] = {}
_engine_seq = 0


def active() -> bool:
    """True while the monitor is armed — the hot-path gate serving
    checks before feeding scores (one module-global read)."""
    return _armed


def engine_key() -> str:
    """Fresh per-engine drift key — the front takes one at install and
    at every swap flip, so a swapped-in candidate starts a clean live
    histogram instead of inheriting the old model's score mass."""
    global _engine_seq
    with _lock:
        _engine_seq += 1
        return "engine-%d" % _engine_seq


def _capture_locked() -> dict:
    """One cumulative baseline: telemetry counters + tracing sketches,
    each from a single consistent read."""
    return {
        "t": time.time(),
        "counters": dict(telemetry.counters()),
        "trace": tracing.cumulative_state(),
    }


def arm(out_path: str = "", interval_s: float = DEFAULT_INTERVAL_S,
        slo_p99_us: float = 0.0,
        slo_window_s: float = DEFAULT_SLO_WINDOW_S,
        ring_windows: int = DEFAULT_WINDOW_RING,
        slo_family: str = DEFAULT_SLO_FAMILY,
        emitter: Optional[bool] = None) -> None:
    """Arm (or re-arm, resetting ring/drift state) the live monitor.

    ``out_path`` (optional) is the JSONL the emitter appends one line
    per window to; ``interval_s`` the window length; ``slo_p99_us`` > 0
    enables SLO tracking for ``slo_family`` with budget window
    ``slo_window_s``.  ``emitter`` forces the background thread on/off
    (default: on iff ``out_path`` is set).  Invalid values raise —
    config.py rejects them loudly before they ever reach here."""
    global _armed, _closed, _out_path, _file, _interval_s, _ring, _ring_cap
    global _window_seq, _emitted, _breaches, _prev, _slo_p99_us
    global _slo_window_s, _slo_family, _short_n, _long_n, _thread, _stop
    interval_s = float(interval_s)
    slo_window_s = float(slo_window_s)
    slo_p99_us = float(slo_p99_us)
    ring_windows = int(ring_windows)
    if interval_s <= 0:
        raise ValueError("monitor_interval_s must be > 0, got %g"
                         % interval_s)
    if slo_window_s <= 0:
        raise ValueError("slo_window_s must be > 0, got %g" % slo_window_s)
    if slo_p99_us < 0:
        raise ValueError("slo_p99_us must be >= 0, got %g" % slo_p99_us)
    if ring_windows <= 0:
        raise ValueError("monitor ring_windows must be > 0, got %d"
                         % ring_windows)
    disarm()
    long_n = max(1, int(math.ceil(slo_window_s / interval_s)))
    short_n = max(1, int(math.ceil(
        slo_window_s / SHORT_WINDOW_RATIO / interval_s)))
    # the slow window must fit in the ring or its burn rate lies
    ring_cap = max(ring_windows, long_n)
    out_path = str(out_path or "")
    slo_family = str(slo_family or DEFAULT_SLO_FAMILY)
    # the open + header append run OUTSIDE the lock: arm follows disarm
    # so nothing ticks yet, and slow IO must never stall a reader
    fh = None
    if out_path:
        fh = open(out_path, "a")
        ident = tracing.identity()
        header = {"monitor_header": {
            "t": round(time.time(), 6),
            "interval_s": interval_s,
            "ring_windows": ring_cap,
            "host": ident.get("host"),
            "pid": ident.get("pid"),
            "run_id": ident.get("run_id"),
            "slo": None if slo_p99_us <= 0 else {
                "family": slo_family,
                "p99_us": slo_p99_us,
                "window_s": slo_window_s,
                "budget": SLO_BUDGET,
                "short_windows": short_n,
                "long_windows": long_n,
                "fast_burn": FAST_BURN,
                "slow_burn": SLOW_BURN,
            },
            "drift_growth": DRIFT_GROWTH,
            "drift_threshold": DRIFT_PSI_THRESHOLD,
            "aa_bound": AA_PSI_BOUND,
        }}
        fh.write(json.dumps(header) + "\n")
        fh.flush()
    with _lock:
        _interval_s = interval_s
        _slo_p99_us = slo_p99_us
        _slo_window_s = slo_window_s
        _slo_family = slo_family
        _long_n = long_n
        _short_n = short_n
        _ring_cap = ring_cap
        _ring = []
        _window_seq = 0
        _emitted = 0
        _breaches = 0
        _drift.clear()
        _out_path = out_path
        _file = fh
        _closed = False
        _prev = _capture_locked()
        _armed = True
    run_emitter = bool(_out_path) if emitter is None else bool(emitter)
    if run_emitter:
        _stop = threading.Event()
        _thread = threading.Thread(
            target=_emit_loop, args=(_stop, interval_s),
            name="lgbm-torch-monitor-emitter", daemon=True)
        lifecycle.track("monitor-emitter", _thread, disarm)
        _thread.start()


def _emit_loop(stop: threading.Event, interval_s: float) -> None:
    while not stop.wait(interval_s):
        try:
            tick()
        except Exception:  # pragma: no cover - emitter must never die loud
            pass


def _counter_deltas(cur: Dict[str, int], prev: Dict[str, int]):
    """(deltas, rebased) — a counter running backwards means the
    registry was reset under us; rebase to a zero baseline instead of
    reporting a negative delta."""
    for k, v in prev.items():
        if cur.get(k, 0) < v:
            prev = {}
            break
    deltas = {}
    for k, v in cur.items():
        d = v - prev.get(k, 0)
        if d:
            deltas[k] = d
    return deltas, prev


def tick(now: Optional[float] = None) -> Optional[dict]:
    """Close the current window: difference the cumulative state
    against the previous baseline, evaluate the SLO burn rule, file the
    ``monitor_window`` (and any ``slo_breach``) trace event, append the
    window to the ring and the JSONL file.  Returns the window record
    (None while disarmed).  The emitter thread calls this once per
    interval; tests call it directly for deterministic
    windows."""
    global _window_seq, _emitted, _breaches, _prev
    with _lock:
        if not _armed:
            return None
        now = time.time() if now is None else float(now)
        cur = _capture_locked()
        prev = _prev or {"t": now, "counters": {}, "trace": None}
        counters, prev_counters = _counter_deltas(
            cur["counters"], prev["counters"])
        prev_trace = prev.get("trace")
        cur_trace = cur.get("trace")
        if (prev_trace is not None and cur_trace is not None
                and (cur_trace["appended"] < prev_trace["appended"]
                     or abs(cur_trace["sketch_growth"]
                            - prev_trace["sketch_growth"]) > 1e-12)):
            prev_trace = None  # recorder re-armed: rebase to zero
        sketches: Dict[str, "tracing.LatencySketch"] = {}
        totals: Dict[str, int] = {}
        if cur_trace is not None:
            prev_sk = {} if prev_trace is None else prev_trace["sketches"]
            for fam, sk in cur_trace["sketches"].items():
                sketches[fam] = sketch_subtract(sk, prev_sk.get(fam))
                totals[fam] = sk.count
        _window_seq += 1
        wid = _window_seq
        rec = {
            "window": wid,
            "t0": round(prev["t"], 6),
            "t1": round(now, 6),
            "counters": counters,
            "counters_total": {k: v for k, v in cur["counters"].items()
                               if v},
            "sketches": {f: sk.to_dict()
                         for f, sk in sorted(sketches.items())},
            "sketch_counts_total": dict(sorted(totals.items())),
        }
        _ring.append(rec)
        if len(_ring) > _ring_cap:
            del _ring[0]
        if _slo_p99_us > 0:
            sk = sketches.get(_slo_family)
            bad = 0 if sk is None else bad_count(sk, _slo_p99_us)
            total = 0 if sk is None else sk.count
            # the ring already holds this window, so both trailing
            # sums include it — the same arithmetic monitor_report
            # recomputes from the emitted records
            fast = _burn_rate(_short_n)
            slow = _burn_rate(_long_n)
            breach = fast >= FAST_BURN and slow >= SLOW_BURN
            rec["slo"] = {
                "family": _slo_family,
                "p99_us": _slo_p99_us,
                "bad": bad,
                "total": total,
                "fast_burn": fast,
                "slow_burn": slow,
                "breach": breach,
            }
            if breach:
                _breaches += 1
                telemetry.count("monitor/slo_breaches")
                tracing.event("slo_breach", window=wid,
                              family=_slo_family, p99_us=_slo_p99_us,
                              fast_burn=round(fast, 4),
                              slow_burn=round(slow, 4))
        telemetry.count("monitor/windows")
        tracing.event("monitor_window", window=wid,
                      t0=rec["t0"], t1=rec["t1"])
        if _file is not None and not _closed:
            _file.write(json.dumps({"monitor_window": rec}) + "\n")
            _file.flush()
            _emitted += 1
        del prev_counters  # rebase already folded into the deltas
        _prev = {"t": now, "counters": dict(cur["counters"]),
                 "trace": cur_trace}
        return rec


def _burn_rate(n_windows: int) -> float:
    """Error-budget burn over the trailing ``n_windows`` ring entries:
    (sum bad / sum total) / budget.  0.0 with no traffic — an idle
    service is not burning budget.  Caller holds the lock; the window
    under evaluation must already be in the ring.

    NOTE: ``slo`` blocks are attached after ring insertion, so this
    reads each window's delta sketch directly — the same arithmetic
    monitor_report recomputes from the emitted records."""
    bad = 0
    total = 0
    for rec in _ring[-n_windows:]:
        skd = (rec.get("sketches") or {}).get(_slo_family)
        if not skd:
            continue
        sk = tracing.LatencySketch.from_dict(skd)
        bad += bad_count(sk, _slo_p99_us)
        total += sk.count
    if total == 0:
        return 0.0
    return (bad / total) / SLO_BUDGET


# ------------------------------------------------------------------- drift

def _new_drift_state() -> dict:
    return {"hist": ScoreHistogram(), "a": ScoreHistogram(),
            "b": ScoreHistogram(), "n": 0, "reference": None}


def register_reference(key: str, reference: Optional[dict]) -> None:
    """Attach a model's training-time reference histogram (the parsed
    ``score_reference=`` block) to an engine drift key.  None clears —
    a model without a captured reference still gets the A/A lane."""
    with _lock:
        st = _drift.setdefault(str(key), _new_drift_state())
        st["reference"] = dict(reference) if reference else None


def record_scores(key: str, values, reference: Optional[dict] = None
                  ) -> int:
    """Feed a batch of predicted scores into the engine's live
    histogram.  Alternate stream positions split into the A/A halves
    (deterministic — the parity of the global per-key sequence, not a
    random draw).  ``reference`` lazily attaches the engine's
    training-time histogram on first contact, so the feed works
    whichever of front/monitor armed first.  Returns the number
    recorded; no-op while disarmed."""
    if not _armed:
        return 0
    with _lock:
        if not _armed:
            return 0
        st = _drift.setdefault(str(key), _new_drift_state())
        if st["reference"] is None and reference:
            st["reference"] = dict(reference)
        try:
            import numpy as np
            vals = np.asarray(values, dtype=np.float64).ravel()
        except Exception:  # pragma: no cover - numpy is always present
            vals = [float(v) for v in values]
        n0 = st["n"]
        cnt = st["hist"].record_many(vals)
        st["a"].record_many(vals[(n0 % 2)::2])
        st["b"].record_many(vals[((n0 + 1) % 2)::2])
        st["n"] = n0 + len(vals)
    telemetry.count("monitor/drift_scores", cnt)
    return cnt


def aa_verdict(key: str) -> dict:
    """The A/A self-check: PSI between the two alternate halves of one
    engine's OWN live scores.  Both halves are draws from the same
    distribution, so a healthy pipeline keeps this under
    ``AA_PSI_BOUND`` — the measured false-positive floor the real
    drift threshold must clear."""
    with _lock:
        st = _drift.get(str(key))
        if st is None:
            return {"psi": None, "bound": AA_PSI_BOUND, "ok": True,
                    "count": 0}
        value = psi(st["a"], st["b"])
        return {"psi": value, "bound": AA_PSI_BOUND,
                "ok": bool(value is None or value <= AA_PSI_BOUND),
                "count": st["hist"].count}


def engine_drift(key: str) -> dict:
    """Live drift verdict for one engine key (reference vs live), plus
    the A/A lane."""
    with _lock:
        st = _drift.get(str(key))
        if st is None:
            return drift_verdict(None, None)
        out = drift_verdict(st["reference"], st["hist"])
    out["aa"] = aa_verdict(key)
    return out


def _drift_block_locked() -> dict:
    """Serializable close-record drift state: reference + live + A/A
    histograms with their recomputable verdicts (monitor_report
    --check re-derives every PSI from the serialized buckets, so a
    tampered reference cannot hide)."""
    block = {}
    for key, st in sorted(_drift.items()):
        value = psi(st["reference"], st["hist"]) \
            if st["reference"] else None
        aa = psi(st["a"], st["b"])
        block[key] = {
            "reference": st["reference"],
            "live": st["hist"].to_dict(),
            "a": st["a"].to_dict(),
            "b": st["b"].to_dict(),
            "n": st["n"],
            "psi": value,
            "threshold": DRIFT_PSI_THRESHOLD,
            "drift": bool(value is not None
                          and value > DRIFT_PSI_THRESHOLD),
            "aa_psi": aa,
            "aa_bound": AA_PSI_BOUND,
        }
    return block


# ------------------------------------------------------------------ output

def monitor_snapshot() -> dict:
    """Live monitor state: the window ring, SLO posture, per-engine
    drift verdicts.  {} while disarmed."""
    with _lock:
        if not _armed:
            return {}
        out = {
            "interval_s": _interval_s,
            "ring_windows": _ring_cap,
            "windows": [dict(w) for w in _ring],
            "window_seq": _window_seq,
            "emitted": _emitted,
            "breaches": _breaches,
            "out_path": _out_path,
        }
        if _slo_p99_us > 0:
            out["slo"] = {
                "family": _slo_family,
                "p99_us": _slo_p99_us,
                "window_s": _slo_window_s,
                "budget": SLO_BUDGET,
                "short_windows": _short_n,
                "long_windows": _long_n,
                "fast_burn": _burn_rate(_short_n),
                "slow_burn": _burn_rate(_long_n),
            }
        out["drift"] = {
            key: {"count": st["hist"].count, "n": st["n"],
                  "psi": psi(st["reference"], st["hist"])
                  if st["reference"] else None,
                  "aa_psi": psi(st["a"], st["b"])}
            for key, st in sorted(_drift.items())
        }
        return out


def _write_close_locked(reason: str) -> None:
    global _closed, _emitted
    if _file is None or _closed:
        return
    rec = {"monitor_close": {
        "reason": str(reason),
        "t": round(time.time(), 6),
        "windows": _window_seq,
        "emitted": _emitted,
        "breaches": _breaches,
        "counters_total": {
            k: v for k, v in (_prev or {}).get("counters", {}).items()
            if v},
        "drift": _drift_block_locked(),
    }}
    _file.write(json.dumps(rec) + "\n")
    _file.flush()
    try:
        os.fsync(_file.fileno())
    except OSError:  # pragma: no cover
        pass
    _closed = True


def disarm(reason: str = "close") -> Optional[str]:
    """Stop the emitter, close the tail window, append the close record
    (drift state + final totals) and release the file.  Returns the
    JSONL path (or None).  Idempotent — a leak check's closer and
    ``telemetry.disable()`` both call it."""
    global _armed, _thread, _stop, _file, _out_path, _prev, _ring
    if not _armed:
        return None
    thread, stop = _thread, _stop
    _thread = None
    _stop = None
    if stop is not None:
        stop.set()
    if thread is not None:
        thread.join(timeout=5.0)
        lifecycle.untrack(thread)
    tick()  # capture the partial tail window
    with _lock:
        if not _armed:
            return None
        path = _out_path or None
        _write_close_locked(reason)
        if _file is not None:
            try:
                _file.close()
            except OSError:  # pragma: no cover
                pass
            _file = None
        _armed = False
        _out_path = ""
        _prev = None
        _ring = list(_ring)  # keep a post-mortem copy harmless to reads
        _drift.clear()
    return path


def flush_on_fault(reason: str) -> Optional[str]:
    """Best-effort crash flush — the faults.py raise hatch calls this
    next to the trace dump.  Closes the in-flight window and appends a
    ``fault:*`` close record so the JSONL stays parseable by
    ``monitor_report.py --check``.  The monitor stays armed (the
    process is about to die anyway; a test harness can still disarm
    cleanly).  Never raises."""
    try:
        if not _armed:
            return None
        tick()
        with _lock:
            if not _armed:
                return None
            path = _out_path or None
            _write_close_locked("fault:%s" % reason)
        return path
    except Exception:  # pragma: no cover - absolute last resort
        return None


# the armed monitor is process-global state: the lifecycle registry
# surfaces a test that leaves it armed
lifecycle.probe("monitor", active, disarm)
