"""Merge per-rank telemetry shards into one job timeline + skew report.

The port's copy of scripts/timeline_report.py: the same arguments,
report, ``--json`` output and exit codes, over lightgbm_tpu_torch alone
(its ``elastic.skew_from_rows``, the rule of the trainer's straggler
drain).

Input: the JSONL shards the port's timeline mode writes
(``lightgbm_tpu_torch.telemetry.set_timeline`` / the ``timeline=``
config option) — ``<metrics_out>.shard-<i>of<n>.jsonl``,
each headed by a ``shard`` record carrying the writer's host fingerprint
and the clock offset measured by ``parallel/mesh.clock_handshake`` at
setup.  Every iteration/summary record carries a LOCAL wall-clock ``t``;
the merge maps each shard's stamps onto the leader's clock
(``t + clock_offset_s``) before ordering, so cross-host event order
survives deliberately skewed clocks (tested).

Outputs:

- an ordered job timeline (one line per record, leader-clock time,
  host-tagged),
- a per-phase SKEW table: for each canonical phase, the cross-host
  dispersion of per-iteration compute time — ``skew = max/median`` per
  iteration, reported as the per-phase maximum and mean — plus a
  barrier-wait estimate per host (``max_host_iter_time - own``: time a
  host spends waiting for the slowest peer inside the collectives) and,
  when the summary carries an ``interconnect`` block, the wire-time
  decomposition (estimated bytes at the attained GB/s),
- a PERSISTENT-STRAGGLER flag: one host slowest ≥ K consecutive
  iterations (``--straggler-k``, default 3) is a host problem, not noise
  — a slow wire slows everyone, a slow host shows up here,
- ``--perfetto out.json``: a Chrome/Perfetto trace (one track per
  process, one slice per phase per iteration) for eyeball debugging.

Crash tolerance: a shard whose writer was killed mid-write ends in one
truncated line — skipped with a note, never a crash (the sink flushes
per record, so at most the LAST line of a shard can be partial; a
malformed line anywhere else is reported as corruption).

Usage::

    python scripts/port_timeline_report.py run.jsonl.shard-*.jsonl
    python scripts/port_timeline_report.py --glob 'run.jsonl.shard-*' \
        --perfetto trace.json

Exit codes: 0 = report printed, 1 = persistent straggler flagged,
2 = unreadable/malformed input.
"""
from __future__ import annotations

import argparse
import glob as globmod
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

# the skew/straggler logic is shared with the trainer's straggler drain:
# one implementation, lightgbm_tpu_torch/elastic.py; this script merges
# shards into the row shape and delegates
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from lightgbm_tpu_torch import elastic  # noqa: E402

CANONICAL_PHASES = elastic.CANONICAL_PHASES


class ReportError(Exception):
    """Malformed input (exit code 2)."""


def load_shard(path: str) -> dict:
    """One shard -> {path, header, records, truncated}.

    The FINAL line may be truncated (killed writer); anything malformed
    before it is corruption and raises."""
    records: List[dict] = []
    truncated = False
    try:
        with open(path) as f:
            lines = f.read().split("\n")
    except OSError as e:
        raise ReportError(f"{path}: unreadable ({e})")
    # drop the artifact of the trailing newline
    if lines and lines[-1] == "":
        lines.pop()
    for i, line in enumerate(lines):
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict):
                raise ValueError("not an object")
        except ValueError:
            if i == len(lines) - 1:
                truncated = True   # killed mid-write: expected, skip
                break
            raise ReportError(
                f"{path}:{i + 1}: malformed JSONL mid-file (corruption, "
                "not a crash tail)")
        records.append(rec)
    header = None
    if records and "shard" in records[0]:
        header = records[0]["shard"]
        records = records[1:]
    return {"path": path, "header": header or {}, "records": records,
            "truncated": truncated}


def shard_label(shard: dict) -> str:
    h = shard["header"]
    if "process_index" in h:
        label = "p%d" % h["process_index"]
        if h.get("host") and h["host"] != "unknown":
            label += "@" + str(h["host"])
        return label
    return shard["path"].rsplit("/", 1)[-1]


def merge_timeline(shards: List[dict]) -> List[dict]:
    """All records on the LEADER's clock, time-ordered.  Each event gains
    ``_host`` (shard label) and ``_t`` (leader-clock stamp; records
    without a local ``t`` sort by arrival order at the end)."""
    events = []
    for order, shard in enumerate(shards):
        off = float(shard["header"].get("clock_offset_s", 0.0))
        label = shard_label(shard)
        for seq, rec in enumerate(shard["records"]):
            ev = dict(rec)
            ev["_host"] = label
            ev["_seq"] = (order, seq)
            if isinstance(rec.get("t"), (int, float)):
                ev["_t"] = float(rec["t"]) + off
            events.append(ev)
    stamped = [e for e in events if "_t" in e]
    loose = [e for e in events if "_t" not in e]
    stamped.sort(key=lambda e: (e["_t"], e["_seq"]))
    return stamped + loose


def _phase_rows(shards: List[dict]) -> Dict[int, Dict[str, Dict[str, float]]]:
    """{iteration: {host: {phase: seconds}}} from the iteration records."""
    rows: Dict[int, Dict[str, Dict[str, float]]] = {}
    for shard in shards:
        label = shard_label(shard)
        for rec in shard["records"]:
            if "iter" not in rec or "phase_times" not in rec:
                continue
            rows.setdefault(int(rec["iter"]), {})[label] = {
                k: float(v) for k, v in rec["phase_times"].items()}
    return rows


def skew_report(shards: List[dict], straggler_k: int = 3) -> dict:
    """Per-phase cross-host skew + barrier-wait decomposition + the
    persistent-straggler flag.  Needs ≥2 shards with overlapping
    iteration records; degrades to an empty report otherwise.  The
    computation itself is ``lightgbm_tpu_torch.elastic.skew_from_rows`` —
    the SAME implementation the trainer's straggler drain consumes,
    so post-mortem and live verdicts can never diverge."""
    out = elastic.skew_from_rows(_phase_rows(shards),
                                 straggler_k=straggler_k)
    wire = _wire_decomposition(shards)
    if wire:
        out["wire"] = wire
    return out


def _wire_decomposition(shards: List[dict]) -> Optional[dict]:
    """Barrier-wait vs wire-time: the interconnect block's estimated
    bytes at the attained aggregate rate give the floor wire seconds;
    barrier wait (skew_report) is everything above it."""
    for shard in shards:
        for rec in reversed(shard["records"]):
            ic = rec.get("interconnect")
            if not isinstance(ic, dict):
                continue
            total_bytes = sum(b.get("est_bytes", 0)
                              for b in ic.get("phases", {}).values())
            secs = sum(b.get("span_seconds") or 0.0
                       for b in ic.get("phases", {}).values())
            return {
                "est_bytes_total": int(total_bytes),
                "collective_span_s": round(secs, 6),
                "attained_gb_per_s": (round(total_bytes / secs / 1e9, 6)
                                      if secs > 0 else None),
                "host": shard_label(shard),
            }
    return None


def perfetto_trace(shards: List[dict]) -> List[dict]:
    """Chrome-trace events: one pid per shard, one complete slice ("X")
    per phase per iteration.  Phase slices are laid out back-to-back
    ENDING at the record's leader-clock stamp (the record is written at
    iteration end); start times inside an iteration are therefore
    approximate, durations and cross-host alignment exact."""
    events = []
    for pid, shard in enumerate(shards):
        off = float(shard["header"].get("clock_offset_s", 0.0))
        label = shard_label(shard)
        events.append({"ph": "M", "pid": pid, "name": "process_name",
                       "args": {"name": label}})
        for rec in shard["records"]:
            if "iter" not in rec or "phase_times" not in rec \
                    or not isinstance(rec.get("t"), (int, float)):
                continue
            end_us = (float(rec["t"]) + off) * 1e6
            cursor = end_us - sum(v for v in rec["phase_times"].values()) \
                * 1e6
            for phase in sorted(rec["phase_times"]):
                dur = float(rec["phase_times"][phase]) * 1e6
                if dur <= 0:
                    continue
                events.append({
                    "ph": "X", "pid": pid, "tid": 0,
                    "name": phase, "ts": round(cursor, 1),
                    "dur": round(dur, 1),
                    "args": {"iter": rec["iter"]},
                })
                cursor += dur
    return events


def render(shards: List[dict], skew: dict, timeline_rows: int = 40) -> str:
    lines = []
    lines.append("shards: %d" % len(shards))
    for shard in shards:
        h = shard["header"]
        note = " [truncated tail]" if shard["truncated"] else ""
        lines.append("  %-16s offset=%+.6fs records=%d%s"
                     % (shard_label(shard),
                        float(h.get("clock_offset_s", 0.0)),
                        len(shard["records"]), note))
    events = merge_timeline(shards)
    stamped = [e for e in events if "_t" in e]
    if stamped:
        t0 = stamped[0]["_t"]
        lines.append("")
        lines.append("timeline (leader clock, first %d of %d records):"
                     % (min(timeline_rows, len(stamped)), len(stamped)))
        for ev in stamped[:timeline_rows]:
            what = ("iter %s" % ev["iter"] if "iter" in ev
                    else "summary" if ev.get("summary")
                    else "/".join(sorted(set(ev)
                                         - {"_host", "_seq", "_t", "t"})))
            lines.append("  +%8.3fs  %-16s %s"
                         % (ev["_t"] - t0, ev["_host"], what))
    lines.append("")
    lines.append("per-phase cross-host skew (%d iterations, %d hosts):"
                 % (skew["iterations_compared"], len(skew["hosts"])))
    if skew["phases"]:
        lines.append("  %-12s %10s %10s %6s"
                     % ("phase", "max_skew", "mean_skew", "iters"))
        for p, blk in sorted(skew["phases"].items()):
            lines.append("  %-12s %10.3f %10.3f %6d"
                         % (p, blk["max_skew"], blk["mean_skew"],
                            blk["iterations"]))
    else:
        lines.append("  (need >= 2 shards with overlapping iteration "
                     "records)")
    if skew["barrier_wait_s"]:
        lines.append("barrier wait (s idle at collectives, per host):")
        for h, v in skew["barrier_wait_s"].items():
            lines.append("  %-16s %10.4f" % (h, v))
    if skew.get("wire"):
        w = skew["wire"]
        lines.append("wire estimate: %d bytes over %.4fs collective span"
                     " -> %s GB/s attained"
                     % (w["est_bytes_total"], w["collective_span_s"],
                        w["attained_gb_per_s"]))
    if skew["persistent_straggler"]:
        lines.append("PERSISTENT STRAGGLER: %s slowest >= %d consecutive "
                     "iterations" % (skew["persistent_straggler"],
                                     skew["straggler_k"]))
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("shards", nargs="*", help="shard JSONL paths")
    p.add_argument("--glob", action="append", default=[],
                   help="shard path glob(s), e.g. 'run.jsonl.shard-*'")
    p.add_argument("--straggler-k", type=int, default=3,
                   help="consecutive slowest-host iterations that flag a "
                        "persistent straggler (default %(default)s)")
    p.add_argument("--perfetto", metavar="OUT.json",
                   help="write a Chrome/Perfetto trace JSON")
    p.add_argument("--json", action="store_true",
                   help="machine-readable skew report")
    args = p.parse_args(argv)
    paths = sorted(set(args.shards)
                   | {f for g in args.glob for f in globmod.glob(g)})
    if not paths:
        print("timeline_report error: no shard files", file=sys.stderr)
        return 2
    try:
        shards = [load_shard(pth) for pth in paths]
    except ReportError as e:
        print(f"timeline_report error: {e}", file=sys.stderr)
        return 2
    skew = skew_report(shards, straggler_k=args.straggler_k)
    if args.perfetto:
        with open(args.perfetto, "w") as f:
            json.dump({"traceEvents": perfetto_trace(shards)}, f)
    if args.json:
        print(json.dumps(skew))
    else:
        print(render(shards, skew))
    return 1 if skew["persistent_straggler"] else 0


if __name__ == "__main__":
    sys.exit(main())
