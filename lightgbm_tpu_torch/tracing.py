"""Flight recorder and per-request latency attribution.

The port's own copy of lightgbm_tpu/tracing.py (pure stdlib; the port
imports nothing of the JAX package).  The telemetry registry
(telemetry.py) answers "how much, cumulatively"; this module is the
per-event tier under it, armed and disarmed with the telemetry session
and mirrored into its counters:

1. **Exact attribution.**  Every ``ServingFront`` request gets a trace
   id and a monotonic event timeline — enqueue → queue-wait →
   linger-wait → coalesce (batch id, bucket, pad-waste rows) → dispatch
   → device walk → scatter → complete.  All boundaries are integer
   ``time.perf_counter_ns()`` stamps; :func:`attribute` clamps the
   batch-level boundaries into each request's [enqueue, complete] window
   and takes consecutive differences, so the six named components
   telescope to exactly the observed wall time.  Backpressure-block and
   swap events ride the same timeline.

2. **Bounded overhead, crash-safe.**  The recorder is a preallocated ring
   (``trace_ring_events`` slots; drops oldest, counts ``trace/dropped``
   exactly).  ``trace_dump_dir=`` flushes the ring to JSONL atomically
   (tmp + rename) on clean close, from the faults.py raise hatch, from
   ``run_training``'s crash path and from the telemetry watchdog when
   training stalls.  ``scripts/trace_report.py`` renders dumps and
   ``--check``-validates the identity and the event ordering.

3. **Streaming percentiles.**  :class:`LatencySketch` is a fixed-memory
   log-bucket histogram: bucket ``i`` holds values in ``[g**i,
   g**(i+1))`` for growth factor ``g`` (``trace_sketch_growth``, default
   1.05), so any quantile is available live within a factor ``sqrt(g)``
   of the true sample quantile, and merging is plain count addition.

Training events land in the same ring: per-iteration records
(``record_train_iteration`` from ``telemetry.emit_iteration``), checkpoint
writes and drops, GOSS and bagging draws; ingest attribution
(:func:`record_ingest_chunk` / :func:`record_ingest_pass`) and the small
monotone :func:`bump` counters (serialized in the header) too.

Every dump header carries the recording process's identity (hostname,
pid, the operator-assigned ``run_id`` and, in a world, the rank as
``process_index`` of ``process_count``: :func:`set_identity`, which
``telemetry.resolve_world`` calls once the world has formed), so
podtrace.py can align the ranks' clocks on matched ``collective_sync``
events (:func:`record_collective_sync` stamps both edges of a blocking
collective, the offset's error bound) and merge their rings into one
timeline.

The recorder mirrors ``trace/dropped`` (ring overwrites) and
``trace/dumps`` (dump files written) into the telemetry registry; the
dump writer runs under the ``trace_dump`` telemetry span, except when
the watchdog thread writes it (``span=False``: that thread touches
nothing of CUDA).  Pure stdlib.  The armed recorder is process-global
state: a lifecycle probe (``trace-recorder``) makes a leak check fail a
test that leaves it armed.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import socket
import threading
import time
from typing import Dict, List, Optional

from . import lifecycle, telemetry

DEFAULT_RING_EVENTS = 65536
DEFAULT_SKETCH_GROWTH = 1.05
# growth-factor bounds: below the floor the bucket table stops being
# "fixed-memory" in any useful sense (~1.4M buckets over a ns..hour
# range); above 2.0 a "percentile" is off by up to 2x — useless
SKETCH_GROWTH_MIN = 1.0005
SKETCH_GROWTH_MAX = 2.0

# the six per-request latency components, in timeline order; attribute()
# guarantees their sum telescopes exactly to the request wall time
COMPONENTS = ("queue", "linger", "coalesce", "dispatch", "walk", "scatter")


# ------------------------------------------------------------------ sketches

class LatencySketch:
    """Fixed-memory log-bucket histogram (HDR-style).

    ``record(v)`` lands ``v`` in bucket ``floor(log(v)/log(g))``; the
    representative of a bucket is its geometric midpoint ``g**(i+0.5)``,
    so any reported quantile is within a factor ``sqrt(g)`` of the true
    sample value at the same rank (relative error <= g - 1).  Values
    <= 0 land in a dedicated zero bucket and report as 0.0.  ``merge``
    is bucket-count addition — associative and commutative, the
    cross-thread / cross-host fold."""

    __slots__ = ("growth", "_log_g", "zero", "buckets")

    def __init__(self, growth: float = DEFAULT_SKETCH_GROWTH):
        growth = float(growth)
        if not (SKETCH_GROWTH_MIN <= growth <= SKETCH_GROWTH_MAX):
            raise ValueError(
                "sketch growth must be in [%g, %g], got %g"
                % (SKETCH_GROWTH_MIN, SKETCH_GROWTH_MAX, growth))
        self.growth = growth
        self._log_g = math.log(growth)
        self.zero = 0
        self.buckets: Dict[int, int] = {}

    def record(self, value: float, n: int = 1) -> None:
        if value <= 0:
            self.zero += n
            return
        idx = int(math.floor(math.log(value) / self._log_g))
        self.buckets[idx] = self.buckets.get(idx, 0) + n

    @property
    def count(self) -> int:
        return self.zero + sum(self.buckets.values())

    def merge(self, other: "LatencySketch") -> "LatencySketch":
        if abs(other.growth - self.growth) > 1e-12:
            raise ValueError("cannot merge sketches with different growth "
                             "factors (%g vs %g)"
                             % (self.growth, other.growth))
        self.zero += other.zero
        for i, c in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + c
        return self

    def quantile(self, q: float) -> Optional[float]:
        """The value at rank ``ceil(q * count) - 1`` of the sorted sample
        (the "nearest-rank" convention), to bucket resolution.  None on
        an empty sketch."""
        total = self.count
        if total == 0:
            return None
        rank = min(total - 1, max(0, int(math.ceil(q * total)) - 1))
        if rank < self.zero:
            return 0.0
        seen = self.zero
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if rank < seen:
                return self.growth ** (i + 0.5)
        return self.growth ** (max(self.buckets) + 0.5)  # pragma: no cover

    def mean(self) -> Optional[float]:
        """Approximate mean (each bucket at its representative) — same
        sqrt(growth) relative-resolution contract as the quantiles."""
        total = self.count
        if total == 0:
            return None
        s = sum(c * self.growth ** (i + 0.5)
                for i, c in self.buckets.items())
        return s / total

    def percentiles(self) -> dict:
        return {
            "count": self.count,
            "mean": self.mean(),
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
            "p999": self.quantile(0.999),
        }

    def to_dict(self) -> dict:
        return {"growth": self.growth, "zero": self.zero,
                "buckets": {str(i): c for i, c in self.buckets.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "LatencySketch":
        sk = cls(d.get("growth", DEFAULT_SKETCH_GROWTH))
        sk.zero = int(d.get("zero", 0))
        sk.buckets = {int(i): int(c)
                      for i, c in d.get("buckets", {}).items()}
        return sk


# ------------------------------------------------------------ recorder state

_lock = threading.Lock()
_armed = False
_ring: List[Optional[dict]] = []
_cap = 0
_appended = 0                 # events ever appended since arm (monotone)
_dropped_synced = 0           # portion already mirrored into telemetry
_dump_dir = ""
_default_ring = True          # armed at DEFAULT_RING_EVENTS
_growth = DEFAULT_SKETCH_GROWTH
_sketches: Dict[str, LatencySketch] = {}
_trace_seq = 0
_batch_seq = 0
_dumps = 0
_counters: Dict[str, int] = {}
_tls = threading.local()

# host/process identity stamped into every dump header.  Survives
# arm/disarm — it describes the PROCESS, not the session — and is
# overwritten, never merged: latest set_identity() wins.
_host = socket.gethostname()
_process_index: Optional[int] = None
_process_count: Optional[int] = None
_run_id = ""
_UNSET = object()


def set_identity(process_index=_UNSET, process_count=_UNSET,
                 run_id=_UNSET) -> None:
    """Install the recorder's identity: ``(process_index,
    process_count)`` (None on one process) and the operator-assigned
    ``run_id`` (``trace_run_id`` knob) that marks which dumps belong to
    one run.  Omitted arguments keep their current value; pass ``None``
    (or ``""`` for run_id) to clear.  Callable before or after
    :func:`arm`."""
    global _process_index, _process_count, _run_id
    with _lock:
        if process_index is not _UNSET:
            _process_index = (None if process_index is None
                              else int(process_index))
        if process_count is not _UNSET:
            _process_count = (None if process_count is None
                              else int(process_count))
        if run_id is not _UNSET:
            _run_id = str(run_id or "")


def identity() -> dict:
    """The header identity block as it would be dumped right now."""
    with _lock:
        return {"host": _host, "pid": os.getpid(),
                "process_index": _process_index,
                "process_count": _process_count, "run_id": _run_id}


def active() -> bool:
    """True while the recorder is armed — the hot-path gate every
    instrumentation site checks first (one module-global read)."""
    return _armed


def arm(ring_events: int = DEFAULT_RING_EVENTS, dump_dir: str = "",
        sketch_growth: float = DEFAULT_SKETCH_GROWTH) -> None:
    """Arm (or re-arm, resetting ring/sketches/ids) the recorder.

    ``ring_events`` is the preallocated event capacity (> 0);
    ``dump_dir`` (optional) is where disarm/fault dumps land;
    ``sketch_growth`` the log-bucket factor.  Invalid values raise —
    config.py rejects them loudly before they ever reach here."""
    global _armed, _ring, _cap, _appended, _dropped_synced, _dump_dir
    global _growth, _trace_seq, _batch_seq, _dumps, _default_ring
    ring_events = int(ring_events)
    if ring_events <= 0:
        raise ValueError("trace_ring_events must be > 0, got %d"
                         % ring_events)
    if not (SKETCH_GROWTH_MIN <= float(sketch_growth) <= SKETCH_GROWTH_MAX):
        raise ValueError("trace_sketch_growth must be in [%g, %g], got %g"
                         % (SKETCH_GROWTH_MIN, SKETCH_GROWTH_MAX,
                            float(sketch_growth)))
    with _lock:
        _cap = ring_events
        _default_ring = ring_events == DEFAULT_RING_EVENTS
        _ring = [None] * _cap
        _appended = 0
        _dropped_synced = 0
        _dump_dir = str(dump_dir or "")
        _growth = float(sketch_growth)
        _sketches.clear()
        _counters.clear()
        _trace_seq = 0
        _batch_seq = 0
        _dumps = 0
        _armed = True


def disarm() -> Optional[str]:
    """Disarm and clear the recorder.  When a dump dir is configured and
    any event was recorded, the ring is flushed first (reason "close") —
    the clean-shutdown half of the crash-safety contract.  Returns the
    dump path (or None).  Idempotent."""
    global _armed, _ring, _cap, _appended, _dump_dir
    if not _armed:
        return None
    path = None
    if _dump_dir and _appended > 0:
        path = dump(reason="close")
    with _lock:
        _sync_dropped_locked()
        _armed = False
        _ring = []
        _cap = 0
        _appended = 0
        _dump_dir = ""
        _sketches.clear()
        _counters.clear()
    _tls.batch = None
    return path


# the armed recorder is process-global state: the lifecycle registry
# surfaces a test that leaves it armed
lifecycle.probe("trace-recorder", active, disarm)


def _append_locked(ev: dict) -> None:
    global _appended
    _ring[_appended % _cap] = ev
    _appended += 1


def _events_locked() -> List[dict]:
    """Ring contents oldest-first (the deterministic oldest-drop
    contract the overflow test pins)."""
    if _appended <= _cap:
        return [e for e in _ring[:_appended]]
    start = _appended % _cap
    return _ring[start:] + _ring[:start]


def _sync_dropped_locked() -> None:
    """Mirror ring overwrites into the telemetry counter as a delta, so
    ``trace/dropped`` is exact however often snapshots/dumps run."""
    global _dropped_synced
    d = max(0, _appended - _cap)
    if d > _dropped_synced:
        telemetry.count("trace/dropped", d - _dropped_synced)
        _dropped_synced = d


def _observe_locked(family: str, value_us: float) -> None:
    sk = _sketches.get(family)
    if sk is None:
        sk = _sketches[family] = LatencySketch(_growth)
    sk.record(value_us)


def event(kind: str, **fields) -> None:
    """Append one timeline event.  No-op while disarmed; hot-path cost
    is one dict build + one locked list store."""
    if not _armed:
        return
    ev = {"kind": str(kind), "t": round(time.time(), 6)}
    ev.update(fields)
    with _lock:
        if _armed:
            _append_locked(ev)


def observe(family: str, value_us: float) -> None:
    """Record one latency observation (microseconds) into the family's
    streaming sketch.  No-op while disarmed."""
    if not _armed:
        return
    with _lock:
        if _armed:
            _observe_locked(family, value_us)


def bump(name: str, n: int = 1) -> None:
    """Increment a small monotone per-session counter (serialized into
    the dump header's ``counters`` block — per-bucket dispatch counts
    and other SLO-prep tallies too cheap and too many for the telemetry
    registry's censused families).  No-op while disarmed."""
    if not _armed:
        return
    with _lock:
        if _armed:
            _counters[name] = _counters.get(name, 0) + int(n)


def record_collective_sync(site: str, iteration: int,
                           t_begin_s: float, t_end_s: float,
                           pod: bool = False) -> None:
    """File one executed blocking collective with both wall-clock edges
    of the host's block (lightgbm_tpu/tracing.py:393-417).  Every rank
    leaves a collective within its own blocked window of the last
    arrival, so the exit stamps of one ``(site, iter)`` on two ranks
    estimate their clock offset within ``max(duration_a, duration_b)``,
    the bound podtrace records.  ``pod=True`` marks a collective over
    more than one process, the only kind that is a sync point.  Its
    duration goes to the ``collective_sync_us`` sketch."""
    if not _armed:
        return
    t0, t1 = float(t_begin_s), float(t_end_s)
    dur_us = max(t1 - t0, 0.0) * 1e6
    ev = {"kind": "collective_sync", "t": round(t1, 6),
          "site": str(site), "iter": int(iteration),
          "t0": round(t0, 6), "t1": round(t1, 6),
          "dur_us": round(dur_us, 1), "pod": bool(pod)}
    with _lock:
        if _armed:
            _append_locked(ev)
            _observe_locked("collective_sync_us", dur_us)


def record_ingest_pass(pass_no: int, seconds: float, rows: int) -> None:
    """File one completed ingest pass (0 = row count, 1 = feature/label
    scan, 2 = tokenize+bin+H2D) — the coarse lane of the ingest
    attribution story."""
    if not _armed:
        return
    ev = {"kind": "ingest_pass", "t": round(time.time(), 6),
          "pass": int(pass_no), "seconds": round(float(seconds), 6),
          "rows": int(rows)}
    with _lock:
        if _armed:
            _append_locked(ev)


def record_ingest_chunk(pass_no: int, chunk: int, rows: int,
                        parse_us: float, bin_us: float,
                        h2d_us: float, worker: int = None) -> None:
    """File one streamed chunk's phase split — tokenizer (parse) vs
    value->bin mapping vs H2D handoff (device_put + row-writer append;
    the async tail is priced by the ``ingest_h2d`` span at finish).
    Sketches accumulate each phase so a dump explains WHERE the
    declining ingest_rows_per_sec lane spends its time.  ``worker``
    tags events from the parallel byte-range loader with the worker
    process id, so per-worker parse spans are reconstructable from the
    ring."""
    if not _armed:
        return
    ev = {"kind": "ingest_chunk", "t": round(time.time(), 6),
          "pass": int(pass_no), "chunk": int(chunk), "rows": int(rows),
          "parse_us": round(float(parse_us), 1),
          "bin_us": round(float(bin_us), 1),
          "h2d_us": round(float(h2d_us), 1)}
    if worker is not None:
        ev["worker"] = int(worker)
    with _lock:
        if _armed:
            _append_locked(ev)
            _observe_locked("ingest_parse_us", float(parse_us))
            _observe_locked("ingest_bin_us", float(bin_us))
            _observe_locked("ingest_h2d_us", float(h2d_us))


def next_trace_id() -> int:
    """Fresh per-request trace id (0 while disarmed — requests are not
    traced, and 0 marks them so)."""
    global _trace_seq
    if not _armed:
        return 0
    with _lock:
        _trace_seq += 1
        return _trace_seq


def dropped() -> int:
    return max(0, _appended - _cap) if _armed else 0


def cumulative_state() -> Optional[dict]:
    """One consistent copy of the recorder's cumulative tallies —
    per-family sketches (deep-copied, caller-owned) and the small bump
    counters — read under a SINGLE lock acquisition, so a windowed
    consumer (monitor.py) can subtract two calls and get exact interval
    deltas: no counter can advance between the sketch copy and the
    counter copy.  None while disarmed."""
    if not _armed:
        return None
    with _lock:
        if not _armed:
            return None
        sketches = {}
        for fam, sk in _sketches.items():
            cp = LatencySketch(sk.growth)
            cp.zero = sk.zero
            cp.buckets = dict(sk.buckets)
            sketches[fam] = cp
        return {
            "sketches": sketches,
            "counters": dict(_counters),
            "appended": _appended,
            "dropped": max(0, _appended - _cap),
            "sketch_growth": _growth,
        }


# ------------------------------------------------------- batch trace (TLS)

class BatchTrace:
    """Per-coalesced-batch marks the engine fills in while scoring on
    the worker thread.  Installed thread-locally by the front
    (``begin_batch``) and consulted by ``ServingEngine._bucketed`` via
    ``current_batch()`` — direct engine calls see None and skip."""

    __slots__ = ("batch_id", "bucket", "pad_rows", "run_begin_ns",
                 "dispatched_ns", "run_end_ns")

    def __init__(self, batch_id: int):
        self.batch_id = batch_id
        self.bucket = 0
        self.pad_rows = 0
        self.run_begin_ns: Optional[int] = None
        self.dispatched_ns: Optional[int] = None
        self.run_end_ns: Optional[int] = None

    def mark_run_begin(self) -> None:
        if self.run_begin_ns is None:
            self.run_begin_ns = time.perf_counter_ns()

    def mark_dispatched(self) -> None:
        self.dispatched_ns = time.perf_counter_ns()

    def mark_run_end(self) -> None:
        self.run_end_ns = time.perf_counter_ns()

    def add_pad(self, rows: int) -> None:
        self.pad_rows += int(rows)

    def set_bucket(self, bucket: int) -> None:
        self.bucket = max(self.bucket, int(bucket))


def begin_batch() -> BatchTrace:
    global _batch_seq
    with _lock:
        _batch_seq += 1
        bid = _batch_seq
    bt = BatchTrace(bid)
    _tls.batch = bt
    return bt


def current_batch() -> Optional[BatchTrace]:
    return getattr(_tls, "batch", None)


def end_batch() -> None:
    _tls.batch = None


# ------------------------------------------------------------- attribution

def attribute(t_enq_ns: int, t_done_ns: int,
              bounds_ns) -> Dict[str, int]:
    """Decompose one request's wall time into the six COMPONENTS.

    ``bounds_ns`` is the five batch-level boundary stamps
    (linger_begin, batch_formed, run_begin, dispatched, scores_returned)
    — any may be None (a missing mark inherits its predecessor).  Each
    boundary is clamped monotonically into [t_enq_ns, t_done_ns]; the
    components are consecutive INTEGER differences of the clamped
    edges, so ``sum(components) == t_done_ns - t_enq_ns`` holds exactly
    — the identity trace_report --check and the tests pin."""
    ts = int(t_enq_ns)
    td = max(int(t_done_ns), ts)
    prev = ts
    edges = [ts]
    for b in bounds_ns:
        b = prev if b is None else int(b)
        b = min(max(b, prev), td)
        edges.append(b)
        prev = b
    edges.append(td)
    return {name: edges[i + 1] - edges[i]
            for i, name in enumerate(COMPONENTS)}


def record_serve_request(trace_id: int, batch: Optional[BatchTrace],
                         t_enq_ns: int, t_done_ns: int, bounds_ns,
                         rows: int, block_ns: int = 0) -> Dict[str, int]:
    """File one completed request: the ``serve_complete`` timeline event
    plus sketch observations for the wall and every component.  Returns
    the component dict (the tests' identity probe).  Safe to call while
    disarmed (pure computation, nothing recorded)."""
    comps = attribute(t_enq_ns, t_done_ns, bounds_ns)
    if not _armed:
        return comps
    wall_ns = max(int(t_done_ns) - int(t_enq_ns), 0)
    ev = {"kind": "serve_complete", "t": round(time.time(), 6),
          "trace": int(trace_id), "rows": int(rows),
          "t_enq_ns": int(t_enq_ns), "wall_ns": wall_ns,
          "components_ns": comps}
    if batch is not None:
        ev["batch"] = batch.batch_id
        ev["bucket"] = batch.bucket
        ev["pad_rows"] = batch.pad_rows
    if block_ns > 0:
        ev["block_ns"] = int(block_ns)
    with _lock:
        if not _armed:
            return comps
        _append_locked(ev)
        _observe_locked("serve_wall_us", wall_ns / 1e3)
        for name in COMPONENTS:
            _observe_locked("serve_%s_us" % name, comps[name] / 1e3)
    return comps


def record_train_iteration(iteration: int,
                           phase_times: Dict[str, float]) -> None:
    """File one boosting iteration into the ring (same record keys as
    the timeline shards: iter / phase_times / t) and its total phase
    seconds into the ``train_iter_us`` sketch.  Called from
    ``telemetry.emit_iteration``."""
    if not _armed:
        return
    total_us = 1e6 * float(sum(phase_times.values()))
    ev = {"kind": "train_iter", "t": round(time.time(), 6),
          "iter": int(iteration), "phase_times": dict(phase_times)}
    with _lock:
        if not _armed:
            return
        _append_locked(ev)
        _observe_locked("train_iter_us", total_us)


# ------------------------------------------------------------------ output

def snapshot() -> dict:
    """Live recorder state: ring occupancy, exact drop count, per-family
    sketch percentiles.  {} while disarmed."""
    if not _armed:
        return {}
    with _lock:
        if not _armed:
            return {}
        _sync_dropped_locked()
        return {
            "ring_events": _cap,
            "events": min(_appended, _cap),
            "appended": _appended,
            "dropped": max(0, _appended - _cap),
            "dumps": _dumps,
            "default_ring": _default_ring,
            "sketch_growth": _growth,
            "sketches": {f: sk.percentiles()
                         for f, sk in sorted(_sketches.items())},
            "counters": dict(sorted(_counters.items())),
        }


def dump(path: Optional[str] = None, reason: str = "close",
         span: bool = True) -> Optional[str]:
    """Flush the ring to JSONL atomically (tmp + rename): one
    ``trace_header`` line (reason, counts, serialized sketches), then
    every retained event oldest-first.  ``path`` defaults to a fresh
    ``trace-<pid>-<k>.jsonl`` under the armed dump dir.  ``span=False``
    writes outside the ``trace_dump`` span (the watchdog thread's dump:
    a span would enter the profiler and read the allocator).  Never
    raises — an unwritable target warns and returns None."""
    global _dumps
    with _lock:
        if not _armed:
            return None
        _sync_dropped_locked()
        events = _events_locked()
        _dumps += 1
        seq = _dumps
        header = {"trace_header": {
            "reason": str(reason),
            "pid": os.getpid(),
            "host": _host,
            "process_index": _process_index,
            "process_count": _process_count,
            "run_id": _run_id,
            "t": round(time.time(), 6),
            "ring_events": _cap,
            "events": len(events),
            "appended": _appended,
            "dropped": max(0, _appended - _cap),
            "sketch_growth": _growth,
            "sketches": {f: sk.to_dict()
                         for f, sk in sorted(_sketches.items())},
            "counters": dict(sorted(_counters.items())),
        }}
        dump_dir = _dump_dir
    if path is None:
        if not dump_dir:
            return None
        path = os.path.join(dump_dir,
                            "trace-%d-%03d.jsonl" % (os.getpid(), seq))
    tmp = "%s.tmp-%d" % (path, os.getpid())
    try:
        with (telemetry.span("trace_dump") if span
              else contextlib.nullcontext()):
            with open(tmp, "w") as f:
                f.write(json.dumps(header) + "\n")
                for ev in events:
                    f.write(json.dumps(ev) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
    except OSError as e:
        from .utils import log
        log.warning("tracing: dump to %s failed (%s); dump skipped"
                    % (path, e))
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None
    telemetry.count("trace/dumps")
    return path


def dump_on_fault(reason: str) -> Optional[str]:
    """Best-effort crash dump — the faults.py raise hatch and
    ``run_training``'s crash path call this with the exception kind.
    Never raises (a broken dump must not mask the real fault)."""
    try:
        if _armed and _dump_dir:
            return dump(reason="fault:%s" % reason)
    except Exception:  # pragma: no cover - absolute last resort
        pass
    return None
