"""Check lightgbm_tpu_torch's flight-recorder dumps, and report what its
telemetry sink adds to the JAX package's.

Usage:
    python scripts/port_report.py --check trace-1234-001.jsonl [more...]
    python scripts/port_report.py metrics.jsonl
    python scripts/port_report.py --json metrics.jsonl

The port's dumps and sink differ from the JAX package's, which
scripts/trace_report.py and scripts/telemetry_report.py read:

  - a ``serve_complete`` event holds seven components
    (``lightgbm_tpu_torch.tracing.COMPONENTS``): ``encode``, the
    engine's host encode of the batch, lies between ``coalesce`` and
    ``dispatch``, where the JAX package's ``coalesce`` holds both;
  - every telemetry span files a ``span`` event (name, thread,
    ``t0_ns``, ``t1_ns``) while the recorder is armed;
  - the sink's records carry ``device_times`` (the spans' device
    seconds between CUDA events, ``metrics_fence=true``) and the
    summary ``wait_times`` (the seconds the host's reads of device
    results blocked, by the innermost span open at the read).

``--check`` runs trace_report's checks on each dump with ``encode``
folded into ``coalesce`` (header bookkeeping, event order, the
attribution identity, monitor linkage, run mixing), then its own: every
completion holds the seven components in timeline order, ``encode`` is
not negative, and no span ends before it starts.  Exits 1 on any
finding, 2 on an unreadable sink.

Without ``--check`` it reads one sink and prints the device time and the
host waits by span, in total and per iteration (telemetry_report.py
renders everything else of it).

A standard-library script, like the two it builds on.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from scripts import telemetry_report, trace_report  # noqa: E402

# mirrors lightgbm_tpu_torch.tracing.COMPONENTS (timeline order)
COMPONENTS = ("queue", "linger", "coalesce", "encode", "dispatch", "walk",
              "scatter")


def folded(events: list) -> list:
    """The events with each completion's ``encode`` added to its
    ``coalesce``: the JAX package's six components."""
    out = []
    for ev in events:
        comps = ev.get("components_ns")
        if (ev.get("kind") == "serve_complete" and isinstance(comps, dict)
                and "encode" in comps and "coalesce" in comps):
            comps = dict(comps)
            comps["coalesce"] += comps.pop("encode")
            ev = dict(ev, components_ns=comps)
        out.append(ev)
    return out


def check(path: str, header: dict, events: list) -> list:
    """Every contract violation in one of the port's dumps."""
    bad = trace_report.check(path, header, folded(events))
    for ev in events:
        kind = ev.get("kind")
        if kind == "serve_complete":
            comps = ev.get("components_ns")
            if not isinstance(comps, dict):
                continue  # trace_report reported it
            if tuple(comps) != COMPONENTS:
                bad.append("%s: trace %s components %s, not %s"
                           % (path, ev.get("trace"), ",".join(comps),
                              ",".join(COMPONENTS)))
            elif comps["encode"] < 0:
                bad.append("%s: trace %s negative encode %d"
                           % (path, ev.get("trace"), comps["encode"]))
        elif kind == "span":
            t0, t1 = ev.get("t0_ns"), ev.get("t1_ns")
            if not (isinstance(t0, int) and isinstance(t1, int)
                    and t0 <= t1):
                bad.append("%s: span %r ends (%r) before it starts (%r)"
                           % (path, ev.get("name"), t1, t0))
    return bad


def sink_blocks(path: str) -> dict:
    """{iterations, device_times, wait_times} of one sink: the summary's
    totals where the run wrote one, else the iteration records' sum."""
    iters, summary, _ = telemetry_report.load(path)
    summary = summary or {}
    device = summary.get("device_times")
    if device is None:
        device = telemetry_report._sum_phase(iters, "device_times")
    return {"iterations": len(iters), "device_times": dict(device),
            "wait_times": dict(summary.get("wait_times") or {})}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("paths", nargs="+",
                   help="trace dumps (--check) or one metrics sink")
    p.add_argument("--check", action="store_true",
                   help="validate dumps; exit 1 on any violation")
    p.add_argument("--json", action="store_true",
                   help="the sink's blocks as one JSON line")
    args = p.parse_args(argv)
    if not args.check:
        try:
            blocks = sink_blocks(args.paths[0])
        except telemetry_report.MalformedJSONL as e:
            print("port_report error: %s" % e, file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(blocks))
            return 0
        n = blocks["iterations"]
        out = telemetry_report._table(
            "Device time of the phases (CUDA events)",
            blocks["device_times"], n)
        out.append("")
        out += telemetry_report._table(
            "Host waits on device reads, by span", blocks["wait_times"], n)
        print("\n".join(out))
        return 0
    findings, loaded = [], []
    for path in args.paths:
        try:
            loaded.append((path,) + trace_report.load(path))
        except trace_report.BadDump as e:
            findings.append(str(e))
    mix = trace_report.check_run_mix([(p_, h) for p_, h, _ in loaded])
    if mix is not None:
        findings.append(mix)
    for path, header, events in loaded:
        findings.extend(check(path, header, events))
    for f in findings:
        print("TRACE-CHECK FAIL %s" % f)
    if findings:
        return 1
    print("trace-check ok: %d dump(s) clean" % len(args.paths))
    return 0


if __name__ == "__main__":
    sys.exit(main())
