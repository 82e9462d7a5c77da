"""The device trace of a traced window, reduced to what the per-layer
metrics read.

``Window`` runs ``torch.profiler`` over CPU and CUDA activity.  After it
closes, ``Trace`` keeps

- device operations: every CUDA kernel, memcpy and memset, with its
  start, duration and the host time of its launch (the PyTorch op it is
  linked to, else the runtime call of the same correlation id: the
  port's own kernels launch through ``ctypes``, under no op);
- host ranges: the ``record_function`` ranges of the program's armed
  telemetry spans (``gradient``, ``split_find``, ``predict``, ...).

Busy time is the union of the device operations' intervals, so work on
overlapping streams counts once.  A device operation belongs to a host
range when its launch lies inside one.  Thread ids are not compared:
the runtime's and PyTorch's number threads apart, and in every cell one
thread launches all device work (the training loop, or the serving
front's worker).
"""
from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Optional, Tuple

RUNTIME_PREFIXES = ("cuda", "cu")
# a kernel's name in the breakdown, cut (template names run to 1,000s)
NAME_CHARS = 200


def _ns(e, what: str) -> int:
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, what + "_us")() * 1000)


def _duration_ns(e) -> int:
    f = getattr(e, "duration_ns", None)
    if f is not None:
        return int(f())
    return int(e.duration_us() * 1000)


def _is_cuda(e) -> bool:
    return str(e.device_type()).split(".")[-1].upper() == "CUDA"


class Trace:
    """Device operations and host ranges of one profiled window."""

    def __init__(self, ops, ranges, window_s: float):
        # ops: (name, start_ns, dur_ns, launch_ns); launch -1 unknown
        self.ops = ops
        # ranges: name -> [(start_ns, end_ns)], sorted
        self.ranges = ranges
        self.window_s = window_s

    @classmethod
    def from_profiler(cls, prof, window_s: float,
                      range_names) -> "Trace":
        events = prof.profiler.kineto_results.events()
        names = set(range_names)
        for e in events:
            if (not _is_cuda(e)
                    and getattr(e, "is_user_annotation", lambda: False)()):
                names.add(e.name())
        ranges: Dict[str, List[Tuple[int, int]]] = \
            collections.defaultdict(list)
        runtime: Dict[int, int] = {}
        frontend: Dict[int, int] = {}
        device = []
        for e in events:
            name = e.name()
            if _is_cuda(e):
                device.append(e)
                continue
            start = _ns(e, "start")
            if name in names:
                ranges[name].append((start, start + _duration_ns(e)))
            elif name.startswith(RUNTIME_PREFIXES):
                runtime[e.correlation_id()] = start
            else:
                frontend[e.correlation_id()] = start
        ops = []
        for e in device:
            name = e.name()
            act = getattr(e, "activity_type", None)
            if (name in names or name.startswith("ProfilerStep")
                    or (act is not None and "annotation" in str(act()).lower())):
                continue          # device-side copies of host ranges
            linked = getattr(e, "linked_correlation_id", None)
            lid = linked() if linked is not None else 0
            at = frontend.get(lid) if lid > 0 else None
            if at is None:
                at = runtime.get(e.correlation_id(), -1)
            ops.append((name, _ns(e, "start"), _duration_ns(e), at))
        return cls(ops, {k: sorted(v) for k, v in ranges.items()},
                   window_s)

    # ------------------------------------------------------------ queries

    @staticmethod
    def is_copy(name: str) -> bool:
        return name.startswith(("Memcpy", "Memset"))

    def kernels(self):
        return [o for o in self.ops if not self.is_copy(o[0])]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (interval union)."""
        iv = sorted((o[1], o[1] + o[2]) for o in self.ops)
        total, end = 0, None
        start = None
        for a, b in iv:
            if end is None or a > end:
                if end is not None:
                    total += end - start
                start, end = a, b
            else:
                end = max(end, b)
        if end is not None:
            total += end - start
        return total / 1e9

    def _inside(self, range_name: str, ops):
        iv = self.ranges.get(range_name, [])
        out = []
        for o in ops:
            k = bisect.bisect_right(iv, (o[3], float("inf"))) - 1
            if k >= 0 and iv[k][0] <= o[3] <= iv[k][1]:
                out.append(o)
        return out

    def kernel_s_in(self, range_name: str) -> Optional[float]:
        """Device seconds of the kernels launched inside a host range;
        None when the range never ran in the window."""
        if not self.ranges.get(range_name):
            return None
        return sum(o[2] for o in self._inside(range_name,
                                              self.kernels())) / 1e9

    def kernel_s_named(self, *parts: str) -> float:
        """Device seconds of the kernels whose name holds one of
        ``parts``."""
        return sum(o[2] for o in self.kernels()
                   if any(p in o[0] for p in parts)) / 1e9

    def count(self, prefix: Optional[str] = None) -> int:
        """Kernels (``prefix`` None) or copies whose name starts so."""
        if prefix is None:
            return len(self.kernels())
        return sum(1 for o in self.ops if o[0].startswith(prefix))

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the idle
        time between device operations summed by the innermost host
        range covering each gap's middle: the ten largest sums."""
        per = collections.Counter()
        for o in self.ops:
            per[o[0]] += o[2] / 1e9
        iv = sorted((o[1], o[1] + o[2]) for o in self.ops)
        gaps = []
        end = None
        for a, b in iv:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        host = sorted((a, b, n) for n, v in self.ranges.items()
                      for a, b in v)
        idle = collections.Counter()
        stack, k = [], 0
        for a, b in gaps:
            mid = (a + b) // 2
            while k < len(host) and host[k][0] <= mid:
                stack.append(host[k])
                k += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "outside spans"
            idle[name] += (b - a) / 1e9
        return {"device_ops": [[n[:NAME_CHARS], s]
                               for n, s in per.most_common(10)],
                "idle_gaps": [[n, s] for n, s in idle.most_common(10)]}


class Window:
    """``with Window(range_names) as w: ...``; ``w.trace`` after exit.
    The window ends with a device synchronise."""

    def __init__(self, range_names):
        self.range_names = tuple(range_names)
        self.trace: Optional[Trace] = None

    def __enter__(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        try:
            # the serving front's worker thread launches the walk: record
            # the ops and ranges of every thread where torch can
            extra = {"experimental_config": torch._C._profiler
                     ._ExperimentalConfig(profile_all_threads=True)}
        except (AttributeError, TypeError):
            extra = {}
        self._prof = torch.profiler.profile(activities=acts, **extra)
        self._prof.__enter__()
        self._sync()
        self._t0 = time.perf_counter()
        return self

    @staticmethod
    def _sync():
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def __exit__(self, *exc):
        self._sync()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = Trace.from_profiler(self._prof, window_s,
                                             self.range_names)
        return False
