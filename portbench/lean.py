"""The lean traced window: CUDA activity alone, with the program's own
spans for host ranges.

``torch.profiler`` over CUDA activity only records kernels, copies and
the CUDA runtime's calls (each kernel's launch, by correlation id), and
none of the ~150,000 CPU ops an ``mslr.train`` iteration runs, so it
stretches the window far less than ``trace.Window``.  Its host ranges
are the ``span`` events the program files into its flight recorder
(``lightgbm_tpu_torch.tracing``), stamped on the clock the profiler
stamps its events with.

The pieces a traced run calls: :class:`LeanWindow` around the work,
:func:`lean_trace` to join its device operations to the program's spans,
:func:`lean_block` for the run's ``profiler`` block, and
:func:`launched_inside`, which checks the shared clock.  The benchmark's
runs do not call them yet.
"""
from __future__ import annotations

import time

from . import train
from .trace import Trace

# kernels of the histogram and partition layers, and the program spans
# that launch them (the shared clock's check)
SPAN_KERNELS = {"histogram": ("hist_kernel", "fixed_to_f32"),
                "partition": ("partition_",)}


def span_ranges(events) -> dict:
    """Program ``span`` events -> {name: [(start_ns, end_ns)]}, sorted."""
    out: dict = {}
    for e in events:
        out.setdefault(e["name"], []).append((int(e["t0_ns"]),
                                              int(e["t1_ns"])))
    return {k: sorted(v) for k, v in out.items()}


def lean_trace(prof, window_s: float, events) -> Trace:
    """The window's device operations, each with its runtime launch
    stamp, and the program's spans as host ranges."""
    tr = Trace.from_profiler(prof, window_s, ())
    tr.ranges = span_ranges(events)
    return tr


def launched_inside(tr: Trace) -> dict:
    """Per span of SPAN_KERNELS: its kernels, and the share of them whose
    launch stamp lies inside one of its ranges."""
    out = {}
    for span, parts in SPAN_KERNELS.items():
        ks = [o for o in tr.kernels() if any(p in o[0] for p in parts)]
        inside = tr._inside(span, ks)
        out[span] = {"kernels": len(ks),
                     "share": len(inside) / len(ks) if ks else None}
    return out


class LeanWindow:
    """``with LeanWindow(device) as w: ...``; ``w.prof`` and ``w.window_s``
    after exit.  The window ends with a device synchronise."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        import torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        train._sync(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        train._sync(self.device)
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(*exc)
        return False


def lean_block(tr: Trace, untraced_s: float) -> dict:
    """The run's ``profiler.lean`` block: window, untraced and busy
    seconds, and the idle gaps by program span."""
    return {"window_s": tr.window_s, "untraced_s": untraced_s,
            "busy_s": tr.busy_s(),
            "idle_gaps": tr.breakdown()["idle_gaps"]}
