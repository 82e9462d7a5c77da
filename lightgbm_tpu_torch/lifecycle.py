"""Live-object inventory for the port's thread-owning objects.

A copy of lightgbm_tpu/lifecycle.py (pure stdlib; the port imports
nothing of the JAX package).  Every object that owns a thread — a
``serving.ServingFront``, the prefetch thread of
``io/parser.prefetch_chunks``, the telemetry watchdog and the monitor's
emitter — registers here while it lives, so a test can assert after
itself that :func:`leaks` is empty and close what leaked.

Two registration shapes:

- :func:`track`/:func:`untrack` — a live OBJECT owning a thread.
  ``closer`` must be idempotent: a guard calls it on a leaked entry, and
  owners may close twice (context manager + explicit).
- :func:`probe` — process-global state that is not an object (the armed
  flight recorder of ``tracing.py``, the armed live ``monitor.py``):
  ``check()`` returning truthy is a leak; ``closer()`` clears it.

Threadsafe: track/untrack run on worker threads.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

_lock = threading.Lock()
# id(handle) -> (kind, name, closer, handle).  The handle reference is
# deliberately strong: an owner that drops its last reference without
# closing is exactly the leak the registry exists to surface.
_LIVE: Dict[int, Tuple[str, str, Callable[[], None], object]] = {}
_PROBES: List[Tuple[str, Callable[[], bool], Callable[[], None]]] = []


def track(kind: str, handle: object, closer: Callable[[], None],
          name: Optional[str] = None) -> object:
    """Register a live thread-owning object.  Returns ``handle`` so the
    call can wrap a constructor expression.  Re-tracking the same handle
    replaces its entry (idempotent)."""
    with _lock:
        _LIVE[id(handle)] = (str(kind), name or type(handle).__name__,
                             closer, handle)
    return handle


def untrack(handle: object) -> None:
    """Deregister (idempotent — closing twice must not raise)."""
    with _lock:
        _LIVE.pop(id(handle), None)


def tracked(handle: object) -> bool:
    with _lock:
        return id(handle) in _LIVE


def probe(kind: str, check: Callable[[], bool],
          closer: Callable[[], None]) -> None:
    """Register a process-global leak probe (module import time; never
    deregistered: ``check`` decides liveness per call)."""
    with _lock:
        for i, (k, _c, _cl) in enumerate(_PROBES):
            if k == kind:                 # module reload: replace, not stack
                _PROBES[i] = (kind, check, closer)
                return
        _PROBES.append((str(kind), check, closer))


def leaks() -> List[Tuple[str, str, Callable[[], None]]]:
    """Everything leaked: live tracked objects plus tripped probes, as
    (kind, name, closer)."""
    with _lock:
        out = [(k, n, c) for (k, n, c, _h) in _LIVE.values()]
        probes = list(_PROBES)
    for kind, check, closer in probes:
        try:
            if check():
                out.append((kind, kind, closer))
        except Exception:  # a broken probe is itself a leak to surface
            out.append((kind, kind + " (probe raised)", closer))
    return out
