"""Fault injection at an iteration boundary, for checkpoint tests.

The programmatic half of lightgbm_tpu/faults.py: ``arm(iteration,
kind)`` arms a one-shot fault that ``GBDT.run_training`` fires at the
first iteration boundary at or past ``iteration`` (between iterations,
never inside one).  Kinds:

- ``kill``: ``SIGKILL`` this process, the preemption checkpoints exist
  for.  No Python cleanup runs: what survives is what the atomic
  checkpoint files already hold.
- ``stall``: sleep ``stall_s`` seconds once (1.0 by default).
- ``raise``: raise ``RuntimeError("injected fault ...")``, which takes
  the training loop's exception path.  Before the raise the live monitor
  closes its in-flight window and the flight recorder dumps its ring
  (lightgbm_tpu/faults.py:159-163), so a raise escaping outside
  ``run_training`` still leaves a timeline.

There is no environment switch: a process that must be killed arms the
hatch itself, e.g. ``python -c "from lightgbm_tpu_torch import faults,
cli; faults.arm(6, 'kill'); cli.main([...])"``.  An armed hatch is
process-wide state, so it is tracked by ``lifecycle`` until it fires or
is disarmed: a test that leaves it armed shows as a leak.
"""
from __future__ import annotations

import os
import signal
import sys
import time
from typing import Optional, Tuple

from . import lifecycle
from .utils import log

KINDS = ("kill", "stall", "raise")
HATCH_KIND = "fault-hatch"


class _Hatch:
    """The armed fault: (iteration, kind, stall seconds)."""

    def __init__(self):
        self.spec: Optional[Tuple[int, str, float]] = None


_hatch = _Hatch()


def arm(iteration: int, kind: str = "kill", stall_s: float = 1.0) -> None:
    """Arm a one-shot fault at the first boundary at or past
    ``iteration``."""
    if kind not in KINDS:
        log.fatal("fault kind must be one of %s, got %r"
                  % ("/".join(KINDS), kind))
    if int(iteration) < 0:
        log.fatal("fault iteration must be >= 0, got %d" % int(iteration))
    _hatch.spec = (int(iteration), kind, float(stall_s))
    lifecycle.track(HATCH_KIND, _hatch, disarm, name="faults.arm")


def disarm() -> None:
    _hatch.spec = None
    lifecycle.untrack(_hatch)


def armed() -> bool:
    return _hatch.spec is not None


def maybe_fire(iteration: int) -> None:
    """Fire the armed fault once the training loop reaches its iteration
    (``run_training`` calls this at each iteration boundary)."""
    spec = _hatch.spec
    if spec is None or iteration < spec[0]:
        return
    _, kind, stall_s = spec
    disarm()                                   # one-shot
    if kind == "kill":
        log.warning("fault injection: SIGKILL at iteration %d" % iteration)
        sys.stdout.flush()
        sys.stderr.flush()
        os.kill(os.getpid(), signal.SIGKILL)
    elif kind == "stall":
        log.warning("fault injection: stalling %.3fs at iteration %d"
                    % (stall_s, iteration))
        time.sleep(stall_s)
    else:
        log.warning("fault injection: raising at iteration %d" % iteration)
        # the monitor's close window files its events into the ring, so
        # it goes before the recorder's dump
        from . import monitor, tracing
        monitor.flush_on_fault("injected_raise")
        tracing.dump_on_fault("injected_raise")
        raise RuntimeError("injected fault at iteration %d" % iteration)
