"""Elastic training: the straggler rule and the two small collectives of
the drain, over a world of ranks.

The port's copy of lightgbm_tpu/elastic.py.  The pure logic is the JAX
module's, line for line, so the live policy flags exactly the rank that
``scripts/timeline_report.py`` flags post mortem:

- ``slowest_unique`` — the strictly slowest host of one iteration (a tie
  is no straggler);
- ``StragglerTracker`` — the run-length state machine: one host strictly
  slowest ``k`` consecutive iteration numbers, a gap or a tie resetting
  the run;
- ``skew_from_rows`` — the per-phase skew, barrier-wait and straggler
  report over ``{iteration: {host: {phase: seconds}}}`` rows;
- ``StragglerMonitor`` — the trainer's consumer: fed one observation an
  iteration boundary (label -> seconds), read at the boundary;
- ``host_times_from_gather`` — a gathered vector to ``p<i>`` labels.

One rule is the port's own (ROADMAP C11): ``clear_lead``.  The JAX
trainer feeds the monitor each host's seconds from one boundary to the
next.  Its hosts meet at every collective of the iteration, so each
host's interval is the world's period and the strictly slowest host is
noise, which a long run drains on by chance.  The port's trainer feeds
each rank's own work instead (the interval less the seconds it waited in
collectives, ``parallel.mesh.collective_seconds``), and ``clear_lead``
keeps a boundary's reading only when one rank's work exceeds every
other's by more than the drain could gain back.

The collectives run over the world's ``parallel.mesh.Comm`` (the JAX
module ``shard_map``s them over a 1-D mesh), each under an ``elastic``
telemetry span, filed at its wire site and, given the iteration, as a
``collective_sync`` event of the flight recorder with both edges of the
call (``tracing.record_collective_sync``, ``pod`` in a world of more
than one rank): the sync points on which podtrace.align puts the ranks'
dumps on one clock.

- ``exchange_times`` — every rank's iteration seconds, all-gathered
  (site ``elastic/times_allgather``), so every rank holds one vector and
  the deterministic rule reaches one verdict everywhere;
- ``agree_survivors`` — the elementwise minimum of every rank's int32
  keep/drop votes (site ``elastic/survivor_pmin``): a rank that
  disagrees can only make the plan more conservative.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from . import telemetry, tracing

CANONICAL_PHASES = ("histogram", "split_find", "partition", "eval")


def median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def slowest_unique(totals: Dict[str, float]) -> Optional[str]:
    """The strictly slowest host of one iteration, or None on a tie or
    all-zero totals (a tie is not a straggler)."""
    if not totals:
        return None
    t_max = max(totals.values())
    if t_max <= 0:
        return None
    if sum(1 for v in totals.values() if v == t_max) != 1:
        return None
    return max(totals, key=lambda h: totals[h])


class StragglerTracker:
    """The persistent-straggler rule: one host strictly slowest >= k
    consecutive iteration numbers.  A gap in the fed iteration numbers
    resets the run, and so does ``None`` (a tie, no signal)."""

    def __init__(self, k: int = 3):
        self.k = max(int(k), 1)
        self.run_host: Optional[str] = None
        self.run_len = 0
        self.prev_it: Optional[int] = None
        self.flagged: Optional[str] = None

    def update(self, iteration: int, slowest: Optional[str]) -> Optional[str]:
        """Feed one iteration's strictly slowest host (or None); the
        flagged host once the run reaches k, else None."""
        if (slowest is not None and slowest == self.run_host
                and self.prev_it is not None
                and iteration == self.prev_it + 1):
            self.run_len += 1
        else:
            self.run_host, self.run_len = slowest, 1
        self.prev_it = iteration
        if self.run_host is not None and self.run_len >= self.k:
            self.flagged = self.run_host
            return self.run_host
        return None

    def reset(self) -> None:
        self.run_host, self.run_len, self.prev_it = None, 0, None
        self.flagged = None


def skew_from_rows(rows: Dict[int, Dict[str, Dict[str, float]]],
                   straggler_k: int = 3) -> dict:
    """Per-phase cross-host skew, barrier wait and the persistent
    straggler over ``{iteration: {host: {phase: s}}}`` rows.  Needs two
    or more hosts in an iteration; degrades to an empty report."""
    multi = {it: hosts for it, hosts in rows.items() if len(hosts) >= 2}
    phases: Dict[str, dict] = {}
    barrier_wait: Dict[str, float] = {}
    tracker = StragglerTracker(straggler_k)
    for it in sorted(multi):
        hosts = multi[it]
        it_phases = sorted({p for pt in hosts.values() for p in pt})
        totals = {h: sum(pt.values()) for h, pt in hosts.items()}
        t_max = max(totals.values())
        tracker.update(it, slowest_unique(totals))
        for h, tot in totals.items():
            # the time this host waits at the collectives for the
            # iteration's slowest peer
            barrier_wait[h] = barrier_wait.get(h, 0.0) + (t_max - tot)
        for p in it_phases:
            vals = [pt.get(p, 0.0) for pt in hosts.values()]
            med = median(vals)
            if med <= 0:
                continue
            ratio = max(vals) / med
            blk = phases.setdefault(p, {"max_skew": 0.0, "ratios": []})
            blk["max_skew"] = max(blk["max_skew"], ratio)
            blk["ratios"].append(ratio)
    for p, blk in phases.items():
        blk["mean_skew"] = round(sum(blk["ratios"]) / len(blk["ratios"]), 4)
        blk["iterations"] = len(blk.pop("ratios"))
        blk["max_skew"] = round(blk["max_skew"], 4)
    return {
        "iterations_compared": len(multi),
        "hosts": sorted({h for hosts in multi.values() for h in hosts}),
        "phases": phases,
        "max_phase_skew": round(max(
            [b["max_skew"] for b in phases.values()] or [0.0]), 4),
        "barrier_wait_s": {h: round(v, 6)
                           for h, v in sorted(barrier_wait.items())},
        "straggler_k": tracker.k,
        "persistent_straggler": tracker.flagged,
    }


def clear_lead(totals: Dict[str, float]) -> Dict[str, float]:
    """One boundary's per-host seconds of own work as the live rule reads
    them: ``totals`` when its slowest host's exceed every other host's by
    more than the factor P/(P-1) over P hosts, else ``{}`` (no straggler:
    the tracker's run starts over).  A drain leaves each of the P - 1
    survivors P/(P-1) times its work, so a lower lead drains at a loss,
    and hosts of equal work differ by their noise alone."""
    p = len(totals)
    if p < 2:
        return {}
    slow, runner_up = sorted(totals.values())[-1:-3:-1]
    return dict(totals) if slow > runner_up * p / (p - 1) else {}


class StragglerMonitor:
    """The trainer's live policy: ``observe`` one boundary's per-host
    seconds (label -> seconds), ``take_flagged`` at the boundary.  The
    trainer's observations come from ``exchange_times`` through
    ``clear_lead``; no observation is no straggler.  Consecutive
    observations count (the monitor feeds the tracker its own counter),
    so a boundary that is not every iteration still counts."""

    def __init__(self, k: int = 3):
        self._tracker = StragglerTracker(k)
        self._flagged: Optional[str] = None
        self._obs_n = 0

    @property
    def k(self) -> int:
        return self._tracker.k

    def observe(self, iteration: int,
                host_totals: Dict[str, float]) -> Optional[str]:
        self._obs_n += 1
        flagged = self._tracker.update(self._obs_n,
                                       slowest_unique(host_totals))
        if flagged is not None:
            self._flagged = flagged
        return flagged

    def take_flagged(self) -> Optional[str]:
        """The flagged host, consumed: the caller acts on it, so the run
        starts over for the new topology."""
        flagged, self._flagged = self._flagged, None
        if flagged is not None:
            self._tracker.reset()
        return flagged

    def reset(self) -> None:
        self._tracker.reset()
        self._flagged = None
        self._obs_n = 0


def exchange_times(comm, seconds: float,
                   iteration: Optional[int] = None) -> np.ndarray:
    """Every rank's iteration ``seconds``, all-gathered over ``comm`` (a
    world's ``parallel.mesh.Comm``; collective): the same [world]
    float32 vector on every rank.  A world of one gives its own
    seconds, and the strictly-slowest rule then never fires.
    ``iteration`` files the call as a ``collective_sync`` event."""
    import torch
    with telemetry.span("elastic"):
        t0 = time.time()
        out = comm.all_gather(torch.tensor([seconds], dtype=torch.float32),
                              "elastic/times_allgather")
        if iteration is not None:
            tracing.record_collective_sync("elastic/times_allgather",
                                           iteration, t0, time.time(),
                                           pod=comm.size > 1)
    return out.reshape(-1).numpy()


def agree_survivors(comm, votes,
                    iteration: Optional[int] = None) -> np.ndarray:
    """The elementwise minimum of every rank's int32 ``votes`` (1 keep, 0
    drop, one a rank) over ``comm`` (collective): the plan every rank
    acts on.  ``iteration`` files the call as a ``collective_sync``
    event, as :func:`exchange_times` does."""
    import torch
    with telemetry.span("elastic"):
        t0 = time.time()
        out = comm.all_reduce(
            torch.as_tensor(np.asarray(votes, np.int32)),
            "elastic/survivor_pmin", op="min")
        if iteration is not None:
            tracing.record_collective_sync("elastic/survivor_pmin",
                                           iteration, t0, time.time(),
                                           pod=comm.size > 1)
    return out.numpy()


def host_times_from_gather(gathered,
                           slots_per_host: int = 1) -> Dict[str, float]:
    """The gathered per-slot vector -> per-host seconds labeled ``p<i>``
    (timeline_report's shard labels), one host per ``slots_per_host``
    consecutive slots."""
    gathered = np.asarray(gathered, np.float64).reshape(-1)
    sph = max(int(slots_per_host), 1)
    out: Dict[str, float] = {}
    for i in range(0, gathered.size, sph):
        out["p%d" % (i // sph)] = float(gathered[i])
    return out


__all__ = ["CANONICAL_PHASES", "StragglerMonitor", "StragglerTracker",
           "agree_survivors", "clear_lead", "exchange_times",
           "host_times_from_gather", "median", "skew_from_rows",
           "slowest_unique"]
