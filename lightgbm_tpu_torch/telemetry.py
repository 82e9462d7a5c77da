"""Process-wide telemetry: phase spans, route counters, memory gauges,
the stall watchdog and the per-iteration JSONL sink.

The single-process part of lightgbm_tpu/telemetry.py, for a port that
runs eagerly.  Records carry the JAX package's schema: the same keys,
nesting and JSON types, so ``scripts/telemetry_report.py`` reads either
package's sink.  What differs, and why:

1. **Spans are host-side wall timers, and every span is an execution
   span.**  ``span("histogram")`` times the enclosed host call with
   ``time.perf_counter``: ``phase_times`` is host wall time, always.
   Nothing is traced here, so every span lands in ``phase_times``;
   ``trace_times`` stays in every record as an empty dict (the JAX
   package files spans entered while tracing there).  The spans nest:
   ``grow`` holds ``histogram``, ``split_find`` and ``partition`` (the
   growers' host loop), so a sum over all phases counts those three
   twice; the per-iteration phases are ``ITERATION_PHASES``
   (``gradient``, ``bagging``, ``goss``, ``grow``, ``score_update``,
   ``valid_update``, ``model_readback`` and ``eval``).  The canonical
   keys ``histogram``, ``split_find``, ``partition`` and ``eval`` are
   always present.

2. **Device time** (``metrics_fence=true``, ``enable(fence=True)``): on
   a CUDA telemetry device (``set_device``) each span records a CUDA
   event on that device's current stream at its enter and another at
   its exit, so ``device_times[name]`` sums the stream time between
   them: the device work the span queued, and any idle stretch of the
   stream inside it.  Nothing waits: once 64 pairs are pending, a span
   exit reads those whose end event has completed (``Event.query()``),
   and :func:`snapshot` and the iteration record wait for the rest.
   Event pairs are pooled.  Snapshots carry ``device_times`` beside
   ``phase_times``, iteration records their per-iteration deltas.
   ``Span.fence(x)`` returns ``x`` and does nothing else (its call sites
   mark the value a phase produced).
   **Host waits**: :func:`host_read` is every device-to-host read of the
   training iteration's path; armed, it counts ``sync/d2h_reads`` and
   adds the seconds it blocked to ``wait_times`` under the innermost
   span open on its thread.  **Span events**: while the flight recorder
   (tracing.py) is armed, every span exit files a ``span`` event (name,
   thread, start and end: the span's own ``perf_counter_ns`` stamps,
   moved by one offset onto the clock ``torch.profiler`` stamps its
   events with), so a ``profile_dir`` trace and a ``trace_dump_dir``
   dump align.

3. **Profiler alignment.**  An armed span runs its body under
   ``torch.profiler.record_function(name)`` and, on a CUDA device,
   ``torch.cuda.nvtx.range(name)`` — the counterparts of
   ``jax.named_scope`` and ``TraceAnnotation`` — so a ``profile_dir=``
   trace carries the same names as ``phase_times``.  Disarmed,
   :func:`span` returns a shared no-op after one flag check.

4. **Memory gauges** (``memory_stats=``): spans sample the allocator of
   the device ``set_device`` names at their boundaries.  On a CUDA device
   ``torch.cuda.memory_stats`` (read in its nested form, the same
   counters without the flattening) gives ``bytes_in_use``
   (``allocated_bytes.all.current``) and the allocator's peak
   (``allocated_bytes.all.peak``), which the module baselines at its
   first sample and never resets (chip_smoke.py reads the allocator's own
   peak).  Only a CPU device reads the host
   RSS, as the JAX package does for a backend with no stats; on a CUDA
   device a failed read reports ``unavailable``, never RSS.  Records gain
   a ``memory`` block; ``set_residency`` files the dataset-residency
   report once at train start.

5. **Route counters count kernel launches.**  The JAX package counts a
   route once per traced decision; here each kernel wrapper counts one
   at its launch site, and each plain version (a CPU tensor) under a
   ``*/plain*`` name, so a CPU run never passes for a card route:

   ==========================================  ========================
   JAX package                                 port
   ==========================================  ========================
   ``hist/pallas_f32``, ``hist/pallas_bf16``   ``hist/cuda_float``
   ``hist/pallas_int8``                        ``hist/cuda_int8``
   ``hist/pallas_kernel_*``                    ``hist/cuda_*``
   (child passes of the compacted grower)      ``hist/cuda_pane``
   ``hist/xla_einsum``, ``hist/xla_matmul``    ``hist/plain_float``
   ``hist/xla_int8``, ``hist/xla_int_kernel``  ``hist/plain_int8``
   (its pane entry's plain version)            ``hist/plain_pane``
   ``partition/pallas``                        ``partition/cuda``
   ``partition/xla``                           ``partition/plain``
   (none: dense ops in objectives/rank.py)     ``rank/cuda``, ``rank/plain``
   ==========================================  ========================

   ``JAX_COUNTER_NAMES`` holds this table; a JAX name it maps to None has
   no counterpart (TPU eligibility and XLA compile counters: the port has
   one route per device, and its builds are the ``compile`` block of
   costmodel.py).  The counters ``hist/mixedbin_on|off``,
   ``hist/mixedbin_leafbatch``, ``bagging/device|host``,
   ``goss/iterations``, ``serve/*``, ``ingest/*``, ``ckpt/*``,
   ``health/*``, ``monitor/*`` and ``trace/*`` keep the JAX names.  Every
   launch also files its analytic bytes and operations with
   costmodel.py (``note_launch``), the summary's ``roofline`` block.

6. **The stall watchdog** (``stall_timeout=``): ``run_training`` arms a
   thread that, when no span or check-in lands for the timeout, writes a
   ``flight_recorder`` record (in-flight phase and iteration, the recent
   event ring, every thread's stack) to the sink and, with the flight
   recorder armed and a dump dir set, a ``tracing`` dump.  The thread
   reads host state only and never touches CUDA (a stalled stream would
   block it); ``disarm_watchdog`` joins it, and it is tracked by
   ``lifecycle`` while it runs.

Counters are bumped from the ServingFront worker, the checkpoint writer
and the ingest threads as well as the training loop, so every update of
the registry takes one lock.  Each thread keeps its own span stack.

7. **Collective sites** (the parallel learners, parallel/): every
   collective a learner runs files its site (``record_collective``,
   through ``collective_span``) with the JAX package's site names
   (``dp_psum/<policy>/hist_allreduce``, ``dp_rs/<policy>/hist_scatter``,
   ``.../splitinfo_allreduce``, ``fp/splitinfo_allreduce``,
   ``hist/quant_scale_pmax``, ``hist/int8_cuda_psum``; the hybrid
   learner's ``hybrid/<policy>/hist_allreduce``,
   ``hybrid/leafcompact/own_block_allreduce`` and
   ``.../own_block_int_allreduce``, ``.../root_hist``,
   ``.../root_stats``, ``.../splitinfo_allreduce``; the voting learner's
   ``voting/<policy>/votes_allgather``, ``.../voted_hist_allreduce``,
   ``.../splitinfo_allreduce`` and their ``root_`` twins, and
   ``.../root_stats``; GOSS's row scores in serial row order,
   ``dp/goss_score_allgather``, 4 bytes a row of the largest shard; the
   checkpoint's scores, ``ckpt/score_allgather``, 4·K bytes a row of it;
   the straggler drain's ``elastic/times_allgather``, 4 bytes, and
   ``elastic/survivor_pmin``, 4 bytes a rank, both under the ``elastic``
   span, which ``elastic/shrinks`` counts the drains of; a gloo
   collective staged through host memory adds ``/host_staged``), over
   the axis it reduces (``data`` or, for a
   grid's split records and int8 root stats, ``feature``), with the
   payload this rank sends a call (a best-first split's two children
   in one call under voting).  The port runs eagerly, so a record is
   an executed call, not a trace: the summary's ``interconnect`` block
   holds each site's calls, logical payload bytes and host seconds (the
   call's wall time, a wait included).  ``set_clock_offset`` keeps the
   leader-relative clock offset of parallel/mesh.clock_handshake;
   ``merge_host_counters`` and ``merge_host_memory`` install the
   cross-rank sums of parallel/learners.aggregate_telemetry under
   ``allhosts/`` keys.  A site's ``est_bytes`` and ``est_calls`` (the
   JAX block's estimates, which report scripts read) are its executed
   bytes and calls.

8. **The sink in a world** (lightgbm_tpu/telemetry.py:1425-1469).  The
   sink opens at the first record, after the world has formed.  Without
   timeline mode only rank 0 opens ``metrics_out``; a rank other than 0
   builds its records and writes none.  In timeline mode (``timeline=``,
   :func:`set_timeline`) every rank opens its own shard,
   ``<metrics_out>.shard-<i>of<n>.jsonl`` (:func:`shard_path`), headed
   by a ``shard`` record (rank, world size, pid, host, the clock offset
   of parallel/mesh.clock_handshake, costmodel.host_fingerprint), and
   iteration and summary records carry a wall-clock ``t``.
   :func:`resolve_world` settles the mode and the flight recorder's
   rank identity once the world has formed.  ``profile_dir`` writes one
   trace a rank in a world (``trace.rank<r>.json``).  :func:`disable`
   stamps the session's per-site wire model into the flight recorder's
   ring (a ``wire_model`` event) before its close dump, so a dump
   carries what podtrace.seam_roofline joins its spans against.

Pure stdlib at import (torch is imported where a span or gauge
first needs it): the exec'd ingest workers import this module without
torch.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
import traceback
from typing import Dict, List, Optional

from . import lifecycle

# Canonical per-iteration phase keys: always present in iteration records
CANONICAL_PHASES = ("histogram", "split_find", "partition", "eval")
# the top-level phases of a boosting iteration (module docstring, 1): the
# others nest inside ``grow``
ITERATION_PHASES = ("gradient", "bagging", "goss", "grow", "score_update",
                    "valid_update", "model_readback", "eval")

# the JAX package's route counter names -> the port's (module docstring);
# None: no counterpart in the port
JAX_COUNTER_NAMES = {
    "hist/pallas_f32": "hist/cuda_float",
    "hist/pallas_bf16": "hist/cuda_float",
    "hist/pallas_int8": "hist/cuda_int8",
    "hist/pallas_kernel_f32": "hist/cuda_float",
    "hist/pallas_kernel_bf16": "hist/cuda_float",
    "hist/pallas_kernel_int8": "hist/cuda_int8",
    "hist/xla_einsum": "hist/plain_float",
    "hist/xla_matmul": "hist/plain_float",
    "hist/xla_int8": "hist/plain_int8",
    "hist/xla_int_kernel": "hist/plain_int8",
    "partition/pallas": "partition/cuda",
    "partition/xla": "partition/plain",
    "hist/pallas_eligible": None,
    "hist/pallas_ineligible": None,
    "hist/env_force_einsum": None,
    "hist/env_no_pallas": None,
    "hist/mixedbin_pallas_int": None,
    "hist/mixedbin_pallas_float": None,
    "hist/mixedbin_xla_int": None,
    "hist/mixedbin_matmul": None,
    "hist/mixedbin_blocked": None,
    "partition/pallas_eligible": None,
    "partition/pallas_ineligible": None,
    "partition/dma_overlap": None,
    "partition/dma_serial": None,
    "partition/wide_f_fallback": None,
    "partition/env_no_pallas": None,
    "jit/backend_compile": None,
    "jit/persistent_cache_hit": None,
    "jit/midrun_recompile": None,
    "costmodel/aot_call_fallback": None,
    "costmodel/capture_failed": None,
}

_lock = threading.RLock()
_enabled = False
_fence = False
_sink_path: Optional[str] = None
_sink_file = None
_sink_error = False
# timeline mode (module docstring, 8): one shard a rank, records stamped
# with a wall-clock "t"; the path the open shard took; an override of
# the shard identity (tests simulate ranks from one process)
_timeline = False
_shard_path_used: Optional[str] = None
_shard_identity: "Optional[tuple]" = None

_counters: Dict[str, int] = {}
_phase_times: Dict[str, float] = {}
_phase_counts: Dict[str, int] = {}
# span stacks, one per thread (thread ident -> names, outermost first): a
# span whose name is already open on its thread is suppressed, so nested
# helper calls do not count one phase twice
_span_stacks: Dict[int, List[str]] = {}
_mark_phase: Dict[str, float] = {}
# event-timed spans (module docstring, 2): seconds by span name, the
# marks of _take_device_deltas, the (name, start, end) event pairs not yet
# read (oldest first) and the free pairs
_device_times: Dict[str, float] = {}
_mark_device: Dict[str, float] = {}
_pending: "collections.deque" = collections.deque()
_event_pool: list = []
_streams: Dict[object, object] = {}
# a span exit reads the completed pairs once this many are pending, and
# waits on the oldest past _PENDING_CAP
_READ_BATCH = 64
_PENDING_CAP = 4096
# seconds host_read blocked, by the innermost span open at the read
_wait_times: Dict[str, float] = {}
_route_state: Dict[str, str] = {}

# memory gauges: armed separately so spans pay the allocator read only
# when asked for
_memory = False
_mem_device = None            # torch.device of set_device, or None
_mem_source: Optional[str] = None
_mem_peak = 0
# the allocator's peak at the first sample since reset: the stat runs
# since the allocator's creation (or its last reset, which this module
# never does), so only growth past it belongs to this run
_mem_dev_peak_base: Optional[int] = None
_mem_phase_delta: Dict[str, int] = {}
_mem_phase_peak: Dict[str, int] = {}
_mark_mem: Dict[str, int] = {}
_residency: Optional[dict] = None

# stall watchdog and its event ring
_RING_CAP = 256
_ring: "collections.deque" = collections.deque(maxlen=_RING_CAP)
_ring_armed = False           # cheap hot-path gate: watchdog running
_wd_timeout_cfg = 0.0
_wd_thread: Optional[threading.Thread] = None
_wd_stop: Optional[threading.Event] = None
_wd_clock = time.monotonic
_wd_timeout = 0.0
_wd_last = 0.0
_wd_context: Dict[str, object] = {}
_wd_dump: Optional[dict] = None
_WD_THREAD_NAME = "lgbm-torch-watchdog"
# a long host pause (a kernel build) can fire a dump with no real hang;
# the watchdog re-arms when progress resumes, up to this many dumps
_WD_MAX_DUMPS = 3

# collective sites (module docstring, 7): site -> record
_collectives: Dict[str, dict] = {}
_last_collective: Optional[str] = None
_clock_offset = 0.0
_clock_rtt: Optional[float] = None
_allhosts_mem_peak = 0

_torch_mod = None
_tracing_mod = None


def _torch():
    global _torch_mod
    if _torch_mod is None:
        import torch
        _torch_mod = torch
    return _torch_mod


def _tracing():
    global _tracing_mod
    if _tracing_mod is None:
        from . import tracing
        _tracing_mod = tracing
    return _tracing_mod


# --------------------------------------------------------------- life cycle

def enabled() -> bool:
    return _enabled


def enable(jsonl_path: Optional[str] = None, fence: bool = False,
           memory: Optional[bool] = None,
           timeline: Optional[bool] = None) -> None:
    """Arm the registry (and optionally a JSONL sink at ``jsonl_path``,
    opened at the first record: by rank 0 alone in a world, or by every
    rank into its own shard in timeline mode).  Idempotent; a second call
    can attach a sink or toggle fence mode.  ``memory`` arms or disarms
    the memory gauges and ``timeline`` the shard mode (None leaves
    them)."""
    global _enabled, _fence, _sink_path, _sink_error, _sink_file, _memory
    if timeline is not None:
        set_timeline(timeline)
    with _lock:
        _enabled = True
        _fence = bool(fence)
        if memory is not None:
            _memory = bool(memory)
        if jsonl_path:
            if _sink_file is not None and jsonl_path != _sink_path:
                try:
                    _sink_file.close()
                except OSError:
                    pass
                _sink_file = None
            _sink_path = jsonl_path
            _sink_error = False
    from . import costmodel
    costmodel.enable()


def disable() -> None:
    """Stop recording and close the sink.  Also disarms the watchdog
    (joining its thread), the live monitor (its tail window first: it
    files events into the trace ring) and the flight recorder (which
    dumps its ring when a dump dir is set, after the ``wire_model``
    event), and leaves timeline mode and the rank identity."""
    global _enabled, _fence, _sink_file, _sink_path, _memory
    global _wd_timeout_cfg, _timeline, _shard_path_used
    disarm_watchdog()
    from . import costmodel, monitor, tracing
    monitor.disarm()
    snap = interconnect_snapshot()
    if snap and tracing.active():
        tracing.event("wire_model", sites={
            site: {"est_bytes": rec["est_bytes"],
                   "bytes_per_call": rec["bytes_per_call"],
                   "est_calls": rec["est_calls"], "kind": rec["kind"],
                   "axis": rec["axis"]}
            for site, rec in snap["sites"].items()})
    tracing.disarm()
    _timeline = False
    _shard_path_used = None
    set_shard_identity(None)
    with _lock:
        _wd_timeout_cfg = 0.0
        _enabled = False
        _fence = False
        _memory = False
        if _sink_file is not None:
            try:
                _sink_file.close()
            except OSError:
                pass
        _sink_file = None
        _sink_path = None
    costmodel.disable()


def reset() -> None:
    """Zero every counter, timer and gauge (the sink and the enabled
    state stay)."""
    global _mem_peak, _residency, _mem_dev_peak_base, _mem_source
    global _last_collective, _allhosts_mem_peak
    from . import costmodel
    costmodel.reset()
    _last_collective = None
    _allhosts_mem_peak = 0
    with _lock:
        _counters.clear()
        _phase_times.clear()
        _phase_counts.clear()
        _mark_phase.clear()
        _device_times.clear()
        _mark_device.clear()
        _pending.clear()
        _wait_times.clear()
        _route_state.clear()
        _mem_phase_delta.clear()
        _mem_phase_peak.clear()
        _mark_mem.clear()
        _mem_peak = 0
        _mem_dev_peak_base = None
        _mem_source = None
        _residency = None
        _ring.clear()
        _span_stacks.clear()
        _collectives.clear()


def arm_session(io_config) -> bool:
    """Arm what an IOConfig's observability keys ask for, as
    lightgbm_tpu/cli.py:263-310 does: the registry and its sink
    (``metrics_out``, or ``memory_stats=true`` alone), the flight
    recorder with it (``trace_*``), the live monitor (``monitor_out`` or
    an SLO), the stall watchdog's timeout.  Returns True when it armed
    anything, and the caller then ends the session with
    :func:`disable`."""
    from . import monitor, tracing
    io = io_config
    armed = False
    mem_on = io.memory_stats_enabled()
    if io.metrics_out or mem_on:
        # timeline=auto settles once the world has formed (resolve_world);
        # a forced true arms the shard mode at once
        enable(io.metrics_out or None, fence=io.metrics_fence, memory=mem_on,
               timeline=io.timeline == "true")
        reset()
        tracing.set_identity(run_id=io.trace_run_id)
        tracing.arm(ring_events=io.trace_ring_events,
                    dump_dir=io.trace_dump_dir or None,
                    sketch_growth=io.trace_sketch_growth)
        armed = True
    if io.monitor_out or io.slo_p99_us > 0:
        if not tracing.active():
            tracing.set_identity(run_id=io.trace_run_id)
            tracing.arm(ring_events=io.trace_ring_events,
                        dump_dir=io.trace_dump_dir or None,
                        sketch_growth=io.trace_sketch_growth)
        monitor.arm(out_path=io.monitor_out,
                    interval_s=io.monitor_interval_s,
                    slo_p99_us=io.slo_p99_us, slo_window_s=io.slo_window_s)
        armed = True
    if io.stall_timeout > 0:
        configure_watchdog(io.stall_timeout)
        armed = True
    return armed


def resolve_world(io_config) -> None:
    """Once the world has formed and before its first record (the CLI
    and ``train`` call it from ``init_parallel``), as lightgbm_tpu/
    cli.py:337-351 does: turn timeline mode on where ``timeline=``
    resolves on over the world (``IOConfig.timeline_enabled``), and give
    the flight recorder this rank's identity, which its dumps carry."""
    from . import tracing
    from .parallel import mesh
    if io_config.timeline_enabled():
        set_timeline(True)
    tracing.set_identity(process_index=mesh.get_rank(),
                         process_count=mesh.get_num_machines())


class profile:
    """``profile_dir``: run the body under ``torch.profiler.profile``
    with the CPU and (with a card) CUDA activities, and write its Chrome
    trace to ``<profile_dir>/trace.json`` (lightgbm_tpu/cli.py:471-503
    writes a ``jax.profiler`` trace there), or in a world of more than
    one rank to ``<profile_dir>/trace.rank<r>.json``, one file a rank.
    A no-op for an empty ``profile_dir``."""

    def __init__(self, profile_dir: str):
        self.profile_dir = profile_dir
        self._prof = None
        self.path = None

    def __enter__(self):
        if not self.profile_dir:
            return self
        from .parallel import mesh
        self.path = os.path.join(self.profile_dir, "trace.json"
                                 if mesh.get_num_machines() <= 1
                                 else "trace.rank%d.json" % mesh.get_rank())
        torch = _torch()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(self.profile_dir, exist_ok=True)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._prof is None:
            return False
        self._prof.__exit__(exc_type, exc, tb)
        self._prof.export_chrome_trace(self.path)
        from .utils import log
        log.info("Profiler trace written to %s" % self.path)
        return False


def set_memory(on: bool) -> None:
    global _memory
    _memory = bool(on)


def memory_enabled() -> bool:
    return _memory


def set_device(device) -> None:
    """The device whose allocator the memory gauges read and whose spans
    carry NVTX ranges (the booster's or the serving engine's)."""
    global _mem_device, _mem_dev_peak_base
    with _lock:
        if device is not None and device != _mem_device:
            _mem_dev_peak_base = None
        _mem_device = device


def sink_active() -> bool:
    """True when records have somewhere to go — the boosting loop's cheap
    guard around record assembly."""
    return _enabled and _sink_path is not None


# ---------------------------------------------------------- memory sampling

def _mem_sample() -> int:
    """Current bytes of the gauged device, updating the watermark: the
    CUDA caching allocator's allocated bytes, or the process RSS for a
    CPU device.  A host read of counters: no device work, no sync."""
    global _mem_source, _mem_peak, _mem_dev_peak_base
    dev = _mem_device
    if dev is None:
        _mem_source = "unavailable"
        return 0
    if dev.type == "cuda":
        # torch.cuda.memory_stats flattens this nested dict in Python:
        # the same counters, at 142 us a call against 26 (H100,
        # scripts/telemetry_overhead.py), twice a span
        try:
            alloc = _torch().cuda.memory_stats_as_nested_dict(dev)[
                "allocated_bytes"]["all"]
            b, dev_peak = int(alloc["current"]), int(alloc["peak"])
        except (KeyError, RuntimeError):
            _mem_source = "unavailable"      # never the host's RSS
            return 0
        with _lock:
            if _mem_dev_peak_base is None:
                _mem_dev_peak_base = dev_peak
            if dev_peak > _mem_dev_peak_base:
                _mem_peak = max(_mem_peak, dev_peak)
            _mem_peak = max(_mem_peak, b)
            _mem_source = "device"
        return b
    try:
        with open("/proc/self/statm") as f:
            b = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        _mem_source = "unavailable"
        return 0
    with _lock:
        _mem_peak = max(_mem_peak, b)
        _mem_source = "host_rss"
    return b


def take_memory_record() -> Optional[dict]:
    """Per-iteration ``memory`` block: current and peak bytes plus the
    per-phase byte deltas since the previous call.  None while the
    gauges are off."""
    if not _memory:
        return None
    b = _mem_sample()
    with _lock:
        deltas = {k: v - _mark_mem.get(k, 0)
                  for k, v in _mem_phase_delta.items()
                  if v - _mark_mem.get(k, 0) != 0}
        _mark_mem.clear()
        _mark_mem.update(_mem_phase_delta)
        rec = {"bytes_in_use": int(b), "peak_bytes_in_use": int(_mem_peak),
               "source": _mem_source or "unavailable"}
    if deltas:
        rec["phase_delta_bytes"] = {k: int(v)
                                    for k, v in sorted(deltas.items())}
    return rec


def memory_snapshot() -> Optional[dict]:
    """Cumulative memory block (summary record, ``snapshot()``): the
    watermark, per-phase deltas and peaks, the residency report."""
    if not (_memory or _mem_phase_delta or _residency is not None):
        return None
    b = int(_mem_sample()) if _memory else 0
    with _lock:
        out = {"bytes_in_use": b, "peak_bytes_in_use": int(_mem_peak),
               "source": _mem_source or "unavailable"}
        if _mem_phase_delta:
            out["phase_delta_bytes"] = {k: int(v) for k, v
                                        in sorted(_mem_phase_delta.items())}
            out["phase_peak_bytes"] = {k: int(v) for k, v
                                       in sorted(_mem_phase_peak.items())}
        if _residency is not None:
            out["residency"] = _residency
        if _allhosts_mem_peak:
            out["allhosts_peak_bytes_in_use"] = int(_allhosts_mem_peak)
    return out


def mem_peak_bytes() -> int:
    return int(_mem_peak)


def merge_host_memory(peak: int) -> None:
    """Install the cross-rank peak bytes (parallel/learners.
    aggregate_telemetry): the memory block's
    ``allhosts_peak_bytes_in_use``."""
    global _allhosts_mem_peak
    _allhosts_mem_peak = int(peak)


def set_residency(report: dict) -> None:
    """File the one-shot dataset-residency report: it rides
    ``memory_snapshot()`` and goes to the sink at once as a
    ``{"residency": ...}`` record."""
    global _residency
    _residency = dict(report)
    if sink_active():
        write_record({"residency": _residency})


# ------------------------------------------------------------ stall watchdog

def _update_ring_armed() -> None:
    global _ring_armed
    _ring_armed = _wd_thread is not None


def _ring_event(kind: str, name: str) -> None:
    """One event into the watchdog's ring; feeds its progress clock."""
    global _wd_last
    _ring.append((time.time(), kind, name, _wd_context.get("iteration")))
    if _wd_thread is not None:
        _wd_last = _wd_clock()


def configure_watchdog(timeout_s: float) -> None:
    """Store the ``stall_timeout=`` setting; ``run_training`` arms the
    watchdog around training when it is > 0."""
    global _wd_timeout_cfg
    _wd_timeout_cfg = max(float(timeout_s), 0.0)


def watchdog_checkin(phase: Optional[str] = None,
                     iteration: Optional[int] = None,
                     detail: Optional[str] = None) -> None:
    """Mark progress, and the in-flight context a dump would name."""
    global _wd_last
    if phase is not None:
        _wd_context["phase"] = phase
    if iteration is not None:
        _wd_context["iteration"] = int(iteration)
    if detail is not None:
        _wd_context["detail"] = detail
    if _wd_thread is not None:
        _wd_last = _wd_clock()


def arm_watchdog(timeout_s: Optional[float] = None, clock=None,
                 poll_s: float = 0.05) -> bool:
    """Start the watchdog thread (idempotent; False when no timeout is
    set or one already runs).  ``clock`` is injectable, so tests drive a
    fake clock.  Once no ring event or check-in lands for the timeout,
    the thread writes a flight-recorder dump; if progress resumes it
    re-arms, up to ``_WD_MAX_DUMPS`` dumps an arming."""
    global _wd_thread, _wd_stop, _wd_clock, _wd_timeout, _wd_last, _wd_dump
    timeout = _wd_timeout_cfg if timeout_s is None else float(timeout_s)
    if timeout <= 0 or _wd_thread is not None:
        return False
    _wd_clock = clock or time.monotonic
    _wd_timeout = timeout
    _wd_last = _wd_clock()
    _wd_dump = None
    _wd_stop = threading.Event()
    _wd_thread = threading.Thread(target=_wd_run, args=(_wd_stop, poll_s),
                                  name=_WD_THREAD_NAME, daemon=True)
    lifecycle.track("watchdog", _wd_thread, disarm_watchdog)
    _wd_thread.start()
    _update_ring_armed()
    return True


def disarm_watchdog(join_s: float = 2.0) -> None:
    global _wd_thread, _wd_stop
    t, ev = _wd_thread, _wd_stop
    _wd_thread, _wd_stop = None, None
    _update_ring_armed()
    if ev is not None:
        ev.set()
    if t is not None:
        if t.is_alive():
            t.join(join_s)
        if not t.is_alive():
            lifecycle.untrack(t)


def watchdog_active() -> bool:
    return _wd_thread is not None and _wd_thread.is_alive()


def last_flight_record() -> Optional[dict]:
    return _wd_dump


def _wd_run(stop: "threading.Event", poll_s: float) -> None:
    dumps = 0
    dumped_at: Optional[float] = None   # _wd_last at the last dump
    while not stop.is_set():
        stop.wait(poll_s)
        try:
            if dumped_at is not None:
                if _wd_last > dumped_at:
                    dumped_at = None    # progress resumed: re-arm
                else:
                    continue
            if _wd_clock() - _wd_last >= _wd_timeout > 0:
                _flight_dump(_wd_clock() - _wd_last, dumps + 1)
                dumps += 1
                dumped_at = _wd_last
                if dumps >= _WD_MAX_DUMPS:
                    return
        except Exception:  # pragma: no cover - never kill the host loop
            return


def _flight_dump(stalled_s: float, dump_index: int = 1) -> None:
    """The flight-recorder dump: in-flight phase and iteration, the event
    ring, every thread's stack.  Host state only: nothing of CUDA (the
    device is what is presumed stuck)."""
    global _wd_dump
    import sys
    events = [{"t": round(t, 6), "kind": k, "name": n, "iter": it}
              for (t, k, n, it) in list(_ring)]
    stacks = [list(s) for s in list(_span_stacks.values()) if s]
    open_spans = max(stacks, key=len) if stacks else []
    in_flight_phase = (open_spans[-1] if open_spans
                       else _wd_context.get("phase"))
    threads = {}
    try:
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid, frame in sys._current_frames().items():
            name = names.get(tid, str(tid))
            if name == _WD_THREAD_NAME:
                continue
            threads[name] = [ln.rstrip() for ln in
                             traceback.format_stack(frame)[-8:]]
    except Exception:
        pass
    dump = {
        "flight_recorder": {
            "dump_index": int(dump_index),
            "stalled_for_s": round(float(stalled_s), 3),
            "stall_timeout_s": _wd_timeout,
            "phase": in_flight_phase,
            "iteration": _wd_context.get("iteration"),
            "detail": _wd_context.get("detail"),
            "last_collective": _last_collective,
            "open_spans": open_spans,
            "ring": events[-_RING_CAP:],
            "threads": threads,
        }
    }
    _wd_dump = dump
    try:
        from .utils import log
        log.warning(
            "telemetry watchdog: no progress for %.1fs (stall_timeout=%.1fs)"
            " — in-flight phase=%s iter=%s; flight-recorder dump written"
            % (stalled_s, _wd_timeout, in_flight_phase,
               _wd_context.get("iteration")))
    except Exception:
        pass
    try:
        write_record(dump)
    except Exception:
        pass
    from . import tracing
    if tracing.active():
        tracing.dump(reason="stall", span=False)


# ------------------------------------------------------------------- spans

class _NullSpan:
    """No-op span returned while telemetry is disabled (or re-entrant)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def fence(self, value):
        return value


_NULL_SPAN = _NullSpan()


def _event_pair():
    """A (start, end) pair of timing events, from the pool."""
    if _event_pool:
        return _event_pool.pop()
    cuda = _torch().cuda
    return cuda.Event(enable_timing=True), cuda.Event(enable_timing=True)


def _current_stream(dev):
    """``torch.cuda.current_stream(dev)``, one Stream object a stream:
    building one for each span cost more than its two events."""
    torch = _torch()
    key = torch._C._cuda_getCurrentStream(
        dev.index if dev.index is not None else torch.cuda.current_device())
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream(dev)
    return stream


def _read_events(wait: bool) -> None:
    """Fold the device seconds of the pending pairs into
    ``device_times``, oldest first, while their end events have
    completed; with ``wait`` (or past ``_PENDING_CAP`` pairs) wait for
    them.  The lock is held."""
    while _pending:
        name, start, end = _pending[0]
        if wait or len(_pending) > _PENDING_CAP:
            end.synchronize()
        elif not end.query():
            return
        _pending.popleft()
        _device_times[name] = (_device_times.get(name, 0.0)
                               + start.elapsed_time(end) / 1e3)
        _event_pool.append((start, end))


class Span:
    """Context-managed phase timer (module docstring: host time, device
    time, span events, profiler ranges, memory gauges).  An exception in
    the body propagates: the span records its time and re-raises nothing
    of its own."""
    __slots__ = ("name", "_t0", "_events", "_stream", "_rf", "_nvtx",
                 "_mem0", "_stack")

    def __init__(self, name: str, stack: List[str]):
        self.name = name
        self._stack = stack
        self._t0 = 0
        self._events = None
        self._stream = None
        self._rf = None
        self._nvtx = False
        self._mem0 = None

    def __enter__(self):
        torch = _torch()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        dev = _mem_device
        if dev is not None and dev.type == "cuda":
            torch.cuda.nvtx.range_push(self.name)
            self._nvtx = True
            if _fence:
                with _lock:
                    self._events = _event_pair()
                self._stream = _current_stream(dev)
                self._events[0].record(self._stream)
        if _memory:
            self._mem0 = _mem_sample()
        self._stack.append(self.name)
        if _ring_armed:
            _ring_event("span_enter", self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def fence(self, value):
        """``value``, unchanged (module docstring, 2)."""
        return value

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        events = self._events
        if events is not None:
            events[1].record(self._stream)
            self._events = self._stream = None
        tracing = _tracing()
        if tracing.active():
            tracing.record_span(self.name, self._t0, t1)
        dt = (t1 - self._t0) * 1e-9
        if self._nvtx:
            _torch().cuda.nvtx.range_pop()
            self._nvtx = False
        self._rf.__exit__(exc_type, exc, tb)
        self._rf = None
        if self._stack and self._stack[-1] == self.name:
            self._stack.pop()
        b1 = _mem_sample() if self._mem0 is not None else None
        with _lock:
            if b1 is not None:
                _mem_phase_delta[self.name] = (
                    _mem_phase_delta.get(self.name, 0) + (b1 - self._mem0))
                _mem_phase_peak[self.name] = max(
                    _mem_phase_peak.get(self.name, 0), b1, self._mem0)
            _phase_times[self.name] = _phase_times.get(self.name, 0.0) + dt
            _phase_counts[self.name] = _phase_counts.get(self.name, 0) + 1
            if events is not None:
                _pending.append((self.name,) + events)
                if len(_pending) >= _READ_BATCH:
                    _read_events(False)
        self._mem0 = None
        if _ring_armed:
            _ring_event("span_exit", self.name)
        return False


def span(name: str):
    """Phase timer: ``with telemetry.span("histogram") as sp: ...``.

    A shared no-op while telemetry is disabled or a span of the same name
    is already open on this thread."""
    if not _enabled:
        return _NULL_SPAN
    tid = threading.get_ident()
    stack = _span_stacks.get(tid)
    if stack is None:
        with _lock:
            stack = _span_stacks.setdefault(tid, [])
    if name in stack:
        return _NULL_SPAN
    return Span(name, stack)


def host_read(t):
    """``t.cpu()``: the host's read of a device result, which waits for
    the work queued before it.  Armed, it counts ``sync/d2h_reads`` and
    adds the seconds the call took to ``wait_times`` under the innermost
    span open on this thread (``outside_spans`` when none)."""
    if not _enabled:
        return t.cpu()
    t0 = time.perf_counter()
    out = t.cpu()
    dt = time.perf_counter() - t0
    stack = _span_stacks.get(threading.get_ident())
    name = stack[-1] if stack else "outside_spans"
    with _lock:
        _counters["sync/d2h_reads"] = _counters.get("sync/d2h_reads", 0) + 1
        _wait_times[name] = _wait_times.get(name, 0.0) + dt
    return out


# ----------------------------------------------------------------- counters

def count(name: str, n: int = 1) -> None:
    """Bump a monotonic counter.  No-op while disabled."""
    if _enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def count_route(group: str, name: str) -> None:
    """Count a routing outcome of a rule host code evaluates every call
    once per change of outcome within ``group`` (decisions, not
    evaluations)."""
    if not _enabled:
        return
    with _lock:
        if _route_state.get(group) == name:
            return
        _route_state[group] = name
    count(name)


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def merge_host_counters(totals: Dict[str, int]) -> None:
    """Install cross-rank counter sums (parallel/learners.
    aggregate_telemetry) under ``allhosts/`` keys."""
    with _lock:
        for k, v in totals.items():
            _counters["allhosts/" + k] = int(v)


# ------------------------------------------------------- collective sites

def record_collective(site: str, kind: str, axis: Optional[str],
                      nbytes: int, seconds: float = 0.0,
                      phase: Optional[str] = None) -> None:
    """File one executed collective at ``site``: its kind (``psum``,
    ``psum_scatter``, ``all_gather``, ``pmax``), the axis it reduces over,
    its logical payload bytes and host seconds.  ``phase`` defaults to
    the outermost open span on this thread (``grow`` in training).  No-op
    while disabled."""
    global _last_collective
    if not _enabled:
        return
    if phase is None:
        stack = _span_stacks.get(threading.get_ident())
        phase = stack[0] if stack else None
    with _lock:
        rec = _collectives.get(site)
        if rec is None:
            rec = _collectives[site] = {
                "kind": kind, "axis": axis, "bytes_per_call": 0,
                "calls": 0, "bytes": 0, "seconds": 0.0, "phase": phase}
        rec["calls"] += 1
        rec["bytes"] += int(nbytes)
        rec["bytes_per_call"] = max(rec["bytes_per_call"], int(nbytes))
        rec["seconds"] += float(seconds)
        _last_collective = site
    if _ring_armed:
        _ring_event("collective", site)


def _nbytes(args) -> int:
    """Logical payload bytes of the tensors in ``args`` (nested tuples,
    lists)."""
    torch = _torch()
    total, stack = 0, [args]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif isinstance(v, (tuple, list)):
            stack.extend(v)
    return total


def collective_span(site: str, fn, *, kind: str, axis: Optional[str] = None,
                    phase: Optional[str] = None):
    """``fn`` wrapped so that each call files ``site`` with the payload
    bytes of its tensor arguments and the call's host seconds; the call
    itself is unchanged.  ``None`` passes through."""
    if fn is None:
        return None

    def wrapped(*args, **kwargs):
        if not _enabled:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        record_collective(site, kind, axis, _nbytes(args),
                          time.perf_counter() - t0, phase)
        return out

    wrapped.site = site
    return wrapped


def interconnect_snapshot() -> Optional[dict]:
    """The ``interconnect`` block: per site its calls, bytes and host
    seconds with the attained rate, and per phase the bytes and
    collective seconds beside the phase's span seconds.  None while no
    collective ran."""
    with _lock:
        if not _collectives:
            return None
        recs = {k: dict(v) for k, v in _collectives.items()}
        phase_times = dict(_phase_times)
    sites, phases = {}, {}
    for site, rec in sorted(recs.items()):
        secs = rec["seconds"]
        entry = {"kind": rec["kind"], "axis": rec["axis"],
                 "bytes_per_call": int(rec["bytes_per_call"]),
                 "calls": int(rec["calls"]), "bytes": int(rec["bytes"]),
                 "est_calls": int(rec["calls"]),
                 "est_bytes": int(rec["bytes"]),
                 "seconds": round(secs, 6),
                 "attained_gb_per_s": (round(rec["bytes"] / secs / 1e9, 6)
                                       if secs > 0 else None)}
        if rec["phase"]:
            entry["phase"] = rec["phase"]
            ph = phases.setdefault(rec["phase"], {"bytes": 0,
                                                  "collective_seconds": 0.0})
            ph["bytes"] += rec["bytes"]
            ph["collective_seconds"] += secs
        sites[site] = entry
    for name, ph in phases.items():
        ph["est_bytes"] = ph["bytes"]
        ph["collective_seconds"] = round(ph["collective_seconds"], 6)
        ph["span_seconds"] = round(phase_times.get(name, 0.0), 6)
    return {"sites": sites, "phases": dict(sorted(phases.items())),
            "clock_offset_s": _clock_offset, "clock_rtt_s": _clock_rtt,
            "note": "logical payload bytes; host seconds of each call"}


def set_clock_offset(offset_s: float, rtt_s: Optional[float] = None) -> None:
    """Install the leader-relative clock offset measured by
    parallel/mesh.clock_handshake: seconds to add to this rank's
    ``time.time()`` to land on rank 0's clock, with the handshake's
    round trip as its error bar."""
    global _clock_offset, _clock_rtt
    _clock_offset = float(offset_s)
    _clock_rtt = None if rtt_s is None else float(rtt_s)


# ------------------------------------------------------------ timeline mode

def set_timeline(on: bool) -> None:
    """Arm or disarm the shard mode (module docstring, 8).  It takes
    effect at the next sink open; an open sink keeps its file."""
    global _timeline
    _timeline = bool(on)


def timeline_enabled() -> bool:
    return _timeline


def set_shard_identity(index: Optional[int] = None,
                       count: Optional[int] = None) -> None:
    """Override the (rank, world size) a shard is named by, so a test
    can write several ranks' shards from one process; ``None`` returns
    to the world's own.  The flight recorder's identity follows, so
    dumps and shards name a rank alike (podtrace's merge key)."""
    global _shard_identity
    from . import tracing
    _shard_identity = (None if index is None or count is None
                       else (int(index), int(count)))
    if _shard_identity is None:
        tracing.set_identity(process_index=None, process_count=None)
    else:
        tracing.set_identity(process_index=_shard_identity[0],
                             process_count=_shard_identity[1])


def _shard_suffix() -> "tuple":
    """(rank, world size) of this process's shard."""
    if _shard_identity is not None:
        return _shard_identity
    from .parallel import mesh
    return mesh.get_rank(), mesh.get_num_machines()


def shard_path(base: str, index: int, count: int) -> str:
    """A rank's shard file: one file a rank for the run, named so that
    ``<base>.shard-*.jsonl`` globs a run's shards."""
    return "%s.shard-%05dof%05d.jsonl" % (base, index, count)


def sink_path() -> Optional[str]:
    """The file records land in: the shard's in timeline mode."""
    return _shard_path_used if _timeline else _sink_path



# ---------------------------------------------------------------- snapshots

def snapshot() -> dict:
    """Cumulative registry state for library users (no sink needed):
    waits for the pending event pairs, so ``device_times`` is whole."""
    with _lock:
        _read_events(True)
        out = {
            "phase_times": dict(_phase_times),
            "phase_counts": dict(_phase_counts),
            "device_times": dict(_device_times),
            "wait_times": dict(_wait_times),
            "trace_times": {},
            "counters": dict(_counters),
        }
    mem = memory_snapshot()
    if mem is not None:
        out["memory"] = mem
    _attach_cost_blocks(out)
    ic = interconnect_snapshot()
    if ic is not None:
        out["interconnect"] = ic
    return out


def _attach_cost_blocks(record: dict) -> None:
    """The ``roofline`` and ``compile`` blocks (costmodel.py) of a
    summary-shaped record, while the cost registry has anything."""
    from . import costmodel
    if costmodel.active():
        with _lock:
            _read_events(True)
            phases = dict(_phase_times)
            device = dict(_device_times)
        record["roofline"] = costmodel.roofline(phases,
                                                device_times=device or None)
        record["compile"] = costmodel.compile_block()


def take_phase_deltas() -> "tuple[Dict[str, float], Dict[str, float]]":
    """(phase_times, trace_times) accumulated since the previous call,
    and re-mark; trace_times is always empty (module docstring)."""
    with _lock:
        dp = {k: v - _mark_phase.get(k, 0.0)
              for k, v in _phase_times.items()
              if v - _mark_phase.get(k, 0.0) > 0.0}
        _mark_phase.clear()
        _mark_phase.update(_phase_times)
    return dp, {}


def _take_device_deltas() -> Dict[str, float]:
    """``device_times`` accumulated since the previous call, and re-mark
    (the iteration record's block; empty unless spans are event-timed)."""
    with _lock:
        _read_events(True)
        dd = {k: v - _mark_device.get(k, 0.0)
              for k, v in _device_times.items()
              if v - _mark_device.get(k, 0.0) > 0.0}
        _mark_device.clear()
        _mark_device.update(_device_times)
    return dd


# -------------------------------------------------------------------- sink

def _ensure_sink():
    """Open the sink on the first write, line-buffered (module
    docstring, 8): rank 0's ``metrics_out``, or in timeline mode this
    rank's shard, headed by its ``shard`` record.  A rank other than 0
    without timeline mode never opens it."""
    global _sink_file, _sink_error, _shard_path_used
    if _sink_file is not None or _sink_path is None or _sink_error:
        return _sink_file
    path, header = _sink_path, None
    if _timeline:
        idx, count = _shard_suffix()
        path = _shard_path_used = shard_path(_sink_path, idx, count)
        header = _shard_header(idx, count)
    else:
        from .parallel import mesh
        if mesh.get_rank() != 0:
            _sink_error = True          # not the leader: never write
            return None
    try:
        # line-buffered: a killed rank's shard reads up to its last
        # whole record
        _sink_file = open(path, "w", buffering=1)
    except OSError:
        from .utils import log
        log.warning("telemetry: cannot open metrics_out=%s; sink disabled"
                    % path)
        _sink_error = True
        return None
    if header is not None:
        try:
            _sink_file.write(json.dumps(header) + "\n")
        except OSError:
            pass
    return _sink_file


def _shard_header(idx: int, count: int) -> dict:
    """A shard's first record: the rank that wrote it and the clock
    offset that maps its ``t`` stamps onto rank 0's clock."""
    import socket
    from . import costmodel
    info = {"process_index": int(idx), "process_count": int(count),
            "pid": os.getpid(), "clock_offset_s": round(_clock_offset, 6),
            "started_unix": round(time.time(), 6)}
    if _clock_rtt is not None:
        info["clock_rtt_s"] = round(_clock_rtt, 6)
    try:
        info["host"] = socket.gethostname()
    except OSError:
        info["host"] = "unknown"
    info["fingerprint"] = costmodel.host_fingerprint()
    return {"shard": info}


def _round_times(d: Dict[str, float]) -> Dict[str, float]:
    return {k: round(v, 6) for k, v in sorted(d.items())}


def write_record(record: dict) -> None:
    """Append one JSON line to the sink and flush it (no-op without a
    sink).  An I/O failure disables the sink with a warning: telemetry
    never stops training."""
    global _sink_error, _sink_file
    line = json.dumps(record) + "\n"
    with _lock:
        f = _ensure_sink()
        if f is None:
            return
        try:
            f.write(line)
            f.flush()
        except OSError as e:
            from .utils import log
            log.warning("telemetry: write to metrics_out failed (%s); "
                        "sink disabled" % e)
            _sink_error = True
            try:
                f.close()
            except OSError:
                pass
            _sink_file = None


def emit_iteration(iteration: int, phase_times: Dict[str, float],
                   trace_times: Optional[Dict[str, float]] = None,
                   eval_metrics: Optional[dict] = None,
                   health: Optional[dict] = None,
                   memory: Optional[dict] = None,
                   extra: Optional[dict] = None) -> dict:
    """Build and write one per-iteration record.  Canonical phase keys
    are always present; counters are cumulative; ``trace_times`` is
    always an empty dict (module docstring)."""
    pt = {k: 0.0 for k in CANONICAL_PHASES}
    pt.update(phase_times)
    record = {
        "iter": int(iteration),
        "phase_times": _round_times(pt),
        "counters": dict(sorted(counters().items())),
        "eval_metrics": eval_metrics or {},
        "trace_times": {},
    }
    device = _take_device_deltas()
    if device:
        record["device_times"] = _round_times(device)
    if _timeline:
        # this rank's wall clock; the shard header's clock_offset_s maps
        # it onto rank 0's
        record["t"] = round(time.time(), 6)
    if _ring_armed:
        _ring_event("iteration", str(iteration))
    from . import tracing
    if tracing.active():
        tracing.record_train_iteration(iteration, record["phase_times"])
    watchdog_checkin(iteration=iteration)
    if health is not None:
        record["health"] = health
    if memory is not None:
        record["memory"] = memory
    if extra:
        record.update(extra)
    write_record(record)
    return record


def emit_summary(extra: Optional[dict] = None) -> dict:
    """Write the end-of-run totals record."""
    with _lock:
        record = {
            "summary": True,
            "phase_times": _round_times(_phase_times),
            "phase_counts": dict(sorted(_phase_counts.items())),
            "trace_times": {},
            "counters": dict(sorted(_counters.items())),
        }
        _read_events(True)
        for key, times in (("device_times", _device_times),
                           ("wait_times", _wait_times)):
            if times:
                record[key] = _round_times(times)
    if _timeline:
        record["t"] = round(time.time(), 6)
    mem = memory_snapshot()
    if mem is not None:
        record["memory"] = mem
    _attach_cost_blocks(record)
    ic = interconnect_snapshot()
    if ic is not None:
        record["interconnect"] = ic
    from . import tracing
    trace = tracing.snapshot()
    if trace:
        record["trace"] = trace
    if extra:
        record.update(extra)
    write_record(record)
    return record
