"""The kernel roofline and the build record, with no compiler to ask.

The port's counterpart of lightgbm_tpu/costmodel.py.  The JAX module
gets each program's flops and bytes from XLA's ``cost_analysis()`` and
files analytic per-pass costs for its Pallas kernels, which XLA cannot
see into (``note_traced_pass``).  The port's device work that matters is
its three hand-written kernels, so every launch files analytic costs
(:func:`note_launch`, called beside the launch's route counter in
ops/hist_cuda.py, ops/compact.py and objectives/rank.py; a plain version
files the same work under its ``*/plain*`` route), from the byte and
operation formulas PERF.md's kernel table bounds each kernel by, so the
roofline reads the same work whatever implements it:

- histogram: ``bin_bytes·N·F + side·N + F·B·3·C·4`` bytes (side 12 for
  the float mode, 7 for int8, 9 for the pane entry: its grad, hess and
  validity planes) and ``3·N·F`` adds;
- partition: ``2·R·cnt`` bytes (the segment's pane rows read and
  written), ``cnt`` compares;
- lambdarank gradient (phase ``gradient``): ``16·N`` bytes (score and
  label read, gradient and hessian written) and 20 operations a pair of
  documents of one query with different labels.

:func:`roofline` joins them to the telemetry layer's measured spans of
the same phase: attained GB/s and operations per second, and with a
known device the fractions of its peaks.  The span of a phase holds more
than its kernels (the growers' host loop, quantization, assembly), so
the attained rate is a floor on the kernels' own; with
``metrics_fence=true`` on a card it divides by the spans' device time
(CUDA events at their edges), else by their host wall time, which times
the dispatch, and the block says which.

Peak table keyed on ``torch.cuda.get_device_name()``; an unknown kind,
the CPU included, reports ``peaks: "unavailable"`` and skips only the
fractions.

:func:`compile_block` reports the port's only compiles: the ``nvcc``
builds of ops/cuda_build.py and the ``g++`` build of native/, seconds per
source, and loads of a library an earlier process built (cached).

The JAX module's ``instrument()`` wraps a jitted program to capture its
compiled cost analysis; the port runs eagerly and has no compiled
program to wrap, so it has no counterpart here.

:func:`host_fingerprint` describes the process for a timeline shard's
header (telemetry.py): the device, the torch and CUDA versions, the
world's size and the checkout's commit.
"""
from __future__ import annotations

import os
import subprocess
import threading
from typing import Any, Dict, List, Optional

_enabled = False
_lock = threading.Lock()
# (phase, kernel) -> {"launches", "bytes", "flops"}
_launch_notes: Dict[tuple, dict] = {}
# the builds and cached loads of this process (kept across reset: a
# library loads once a process)
_builds: List[dict] = []

# Per-device ceilings.  NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU
# datasheet, dense rates without sparsity): BF16 tensor 989.4 TFLOP/s,
# INT8 tensor 1,978.9 TOP/s, FP32 outside the tensor cores 66.9 TFLOP/s,
# HBM3 3.35 TB/s, NVLink 900 GB/s both directions (450 GB/s one way).
# The histogram's adds and the partition's compares run on the CUDA
# cores, so fractions of the operation peak use the FP32 rate.
_PEAK_TABLE = (
    (("h100 80gb hbm3", "h100 sxm"),
     {"flops_per_sec": 989.4e12, "int8_ops_per_sec": 1978.9e12,
      "fp32_flops_per_sec": 66.9e12, "hbm_bytes_per_sec": 3.35e12,
      "ici_bytes_per_sec": 450e9}),
)


def active() -> bool:
    """True when there is anything to report."""
    return _enabled or bool(_launch_notes)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    """Stop recording; the notes stay readable."""
    global _enabled
    _enabled = False


def reset() -> None:
    with _lock:
        _launch_notes.clear()


def device_kind() -> str:
    """``torch.cuda.get_device_name(0)``, or "cpu" without a card."""
    import torch
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def resolve_peaks(kind: str) -> Optional[Dict[str, float]]:
    """Peak table lookup by device-name substring; None for an unknown
    kind (not an error)."""
    k = (kind or "").lower()
    for subs, peaks in _PEAK_TABLE:
        if any(s in k for s in subs):
            return dict(peaks)
    return None


def host_fingerprint() -> dict:
    """Self-describing host and run metadata (lightgbm_tpu/costmodel.py:
    162-189, for the card): the device kind, the backend (``cuda`` or
    ``cpu``), the torch and CUDA versions, the world's process count,
    the local device count and the checkout's short commit, each left
    out when it cannot be read."""
    out: Dict[str, Any] = {}
    try:
        import torch
        out["device_kind"] = device_kind()
        out["backend"] = "cuda" if torch.cuda.is_available() else "cpu"
        out["torch_version"] = torch.__version__
        out["cuda_version"] = torch.version.cuda
        out["local_device_count"] = torch.cuda.device_count()
        from .parallel import mesh
        out["process_count"] = mesh.get_num_machines()
    except Exception:
        pass
    try:
        sha = subprocess.run(
            ["git", "-C", os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5)
        if sha.returncode == 0 and sha.stdout.strip():
            out["git_sha"] = sha.stdout.strip()
    except Exception:
        pass
    return out


def note_launch(phase: str, kernel: str, bytes: float,
                flops: float) -> None:
    """File one kernel launch's analytic cost under ``phase`` (the span
    whose seconds it joins) and ``kernel`` (its route name)."""
    if not _enabled:
        return
    with _lock:
        note = _launch_notes.get((phase, kernel))
        if note is None:
            note = _launch_notes[(phase, kernel)] = {
                "launches": 0, "bytes": 0.0, "flops": 0.0}
        note["launches"] += 1
        note["bytes"] += float(bytes)
        note["flops"] += float(flops)


def hist_cost(bin_bytes: int, n: int, f: int, b: int, c: int,
              side: int) -> tuple:
    """(bytes, adds) of one histogram launch (module docstring)."""
    return (bin_bytes * n * f + side * n + f * b * 3 * c * 4, 3 * n * f)


def note_build(name: str, seconds: float, cached: bool) -> None:
    """File one library load: a build of ``seconds``, or a cached load
    of a library already on disk."""
    with _lock:
        _builds.append({"name": name, "seconds": round(float(seconds), 3),
                        "cached": bool(cached)})


def roofline(phase_times: Dict[str, float], kind: Optional[str] = None,
             device_times: Optional[Dict[str, float]] = None) -> dict:
    """The launch notes joined to the measured phase seconds (the JAX
    block's keys; ``traced_passes`` lists one entry per phase and kernel,
    its ``traces`` counting launches).  A phase's seconds are its device
    time where ``device_times`` (telemetry's event-timed spans) has it,
    else its host wall time; ``method`` and ``fenced_spans`` say which
    divided."""
    kind = kind if kind is not None else device_kind()
    peaks = resolve_peaks(kind)
    device_times = device_times or {}
    with _lock:
        notes = {k: dict(v) for k, v in _launch_notes.items()}
    agg: Dict[str, dict] = {}
    for (phase, _kernel), n in notes.items():
        a = agg.setdefault(phase, {"flops": 0.0, "bytes": 0.0,
                                   "programs": 0, "calls": 0})
        a["programs"] += 1
        a["calls"] += n["launches"]
        a["flops"] += n["flops"]
        a["bytes"] += n["bytes"]
    phases: Dict[str, dict] = {}
    for p, a in sorted(agg.items()):
        secs = float(device_times.get(p, phase_times.get(p, 0.0)))
        blk = {"flops": round(a["flops"], 1),
               "bytes_accessed": round(a["bytes"], 1),
               "programs": a["programs"], "calls": a["calls"],
               "seconds": round(secs, 6)}
        if secs > 0.0:
            blk["attained_flops_per_sec"] = round(a["flops"] / secs, 1)
            blk["attained_hbm_gbps"] = round(a["bytes"] / secs / 1e9, 4)
            if a["bytes"] > 0.0:
                blk["arithmetic_intensity"] = round(a["flops"] / a["bytes"],
                                                    4)
            if peaks:
                blk["frac_of_peak_flops"] = round(
                    a["flops"] / secs / peaks["fp32_flops_per_sec"], 6)
                blk["frac_of_peak_bw"] = round(
                    a["bytes"] / secs / peaks["hbm_bytes_per_sec"], 6)
        phases[p] = blk
    timed = bool(device_times) and any(p in device_times for p in agg)
    out = {
        "device_kind": kind,
        "peaks": peaks if peaks else "unavailable",
        "phases": phases,
        "method": "analytic per-launch bytes and operations of the "
                  "hand-written kernels (PERF.md's bound formulas) over "
                  + ("the device time of the phase spans (CUDA events at "
                     "their edges, metrics_fence=true)" if timed else
                     "the host wall time of the phase spans (on a card "
                     "that times the dispatch, not the execution: "
                     "metrics_fence=true times the device)")
                  + "; fractions of the HBM and FP32 peaks",
        "fenced_spans": timed,
    }
    if notes:
        out["traced_passes"] = [
            {"phase": phase, "key": [kernel], "traces": n["launches"],
             "macs": n["flops"], "bytes_moved": n["bytes"]}
            for (phase, kernel), n in sorted(notes.items())]
    return out


def compile_block() -> dict:
    """The process's kernel and parser library loads: built (cold
    seconds) or cached (the library was on disk)."""
    with _lock:
        builds = [dict(b) for b in _builds]
    programs = [{"name": b["name"], "phase": "build",
                 "compile_seconds": b["seconds"], "calls": 1}
                for b in builds]
    for p, b in zip(programs, builds):
        if b["cached"]:
            p["warm"] = True
    return {
        "program_count": len(builds),
        "total_compile_seconds": round(
            sum((b["seconds"] for b in builds if not b["cached"]), 0.0), 3),
        "warm_programs": sum(1 for b in builds if b["cached"]),
        "backend_compiles": sum(1 for b in builds if not b["cached"]),
        "persistent_cache_hits": sum(1 for b in builds if b["cached"]),
        "midrun_recompiles": 0,
        "programs": programs,
    }
