"""Live-object inventory for the port's thread-owning objects.

A copy of lightgbm_tpu/lifecycle.py (pure stdlib; the port imports
nothing of the JAX package).  Every object that owns a thread — a
``serving.ServingFront`` and the prefetch thread of
``io/parser.prefetch_chunks`` — registers here while it lives, so a test
can assert after itself that :func:`leaks` is empty and close what
leaked.

:func:`track`/:func:`untrack` register a live OBJECT owning a thread.
``closer`` must be idempotent: a guard calls it on a leaked entry, and
owners may close twice (context manager + explicit).  The JAX package's
process-global probes are not copied: nothing in the port registers one.

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


def leaks() -> List[Tuple[str, str, Callable[[], None]]]:
    """Every live tracked object, as (kind, name, closer)."""
    with _lock:
        return [(k, n, c) for (k, n, c, _h) in _LIVE.values()]
