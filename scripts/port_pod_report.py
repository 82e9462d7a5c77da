"""Merge + render the flight-recorder dumps of a world's ranks.

The port's copy of scripts/pod_report.py: the same arguments, report,
``--json`` output and exit codes, over lightgbm_tpu_torch alone.

Usage:
    python scripts/port_pod_report.py trace-*.jsonl
    python scripts/port_pod_report.py --json  trace-*.jsonl
    python scripts/port_pod_report.py --check trace-*.jsonl
    python scripts/port_pod_report.py --wire wire.json trace-*.jsonl

Takes the per-rank dumps one run's processes flushed (tracing.py; one
``trace_header`` line carrying host/process/run identity, then ring
events) and produces the pod view lightgbm_tpu_torch/podtrace.py
computes:

  - clock alignment: per-host offset onto the reference host's clock,
    WITH its collective-duration error bound (matched pod-wide
    ``collective_sync`` events; the bound is part of the answer);
  - the merged global timeline (order-independent, event-conserving)
    and pod-wide latency sketch percentiles (associative bucket merge);
  - the per-seam roofline table: measured collective span seconds
    joined against the dumps' wire byte model, attained GB/s and the
    fraction of the card's interconnect peak (None where no peak is
    known, the CPU included);
  - per-host compute vs collective-wait per iteration, and the skew /
    persistent-straggler verdict via ``elastic.skew_from_rows`` — the
    SAME rule the trainer's straggler drain applies, so post-mortem and
    live verdicts cannot drift;
  - per-host ingest attribution: tokenizer vs bin vs H2D percentages.

``--check`` exits 1 on any violated contract: header bookkeeping drift
or mixed run ids, a host whose clock cannot be aligned or whose
alignment estimates disagree beyond their recorded bounds, a merged
timeline that drops/invents events or breaks any per-request
sum(components)==wall identity, or a measured seam missing from the
byte model (byte-model drift).  Exits 2 on unreadable input.

``--wire`` merges extra per-site bytes into the model (a
MULTICHIP_WIRE ``{"sites": {"data": {site: bytes}}}`` record, an
interconnect snapshot, or a plain ``{site: bytes}`` map) so the
roofline covers every site the wire smoke prices.

Needs only this repo, numpy and torch (the package imports torch).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from lightgbm_tpu_torch import (costmodel, elastic, podtrace,  # noqa: E402
                                tracing)


def _load_wire_arg(path: str) -> dict:
    """Extra byte-model sites from a --wire file: accepts a plain
    {site: bytes} map, an interconnect snapshot ({"sites": {site:
    {est_bytes...}}}) or a MULTICHIP_WIRE record ({"sites": {"data":
    {site: bytes}, ...}} — every schema's map unions in)."""
    with open(path) as f:
        rec = json.load(f)
    sites = rec.get("sites", rec) if isinstance(rec, dict) else {}
    out = {}
    for k, v in sites.items():
        if isinstance(v, dict) and "est_bytes" not in v:
            for site, b in v.items():       # MULTICHIP_WIRE per-schema
                cur = out.get(site)
                if cur is None or int(b) > int(cur.get("est_bytes", 0)):
                    out[site] = {"est_bytes": int(b)}
        elif isinstance(v, dict):
            out[k] = v
        else:
            out[k] = {"est_bytes": int(v)}
    return out


def build_report(dumps, extra_sites=None, device_kind=None,
                 straggler_k: int = 3) -> dict:
    alignment = podtrace.align(dumps)
    merged = podtrace.merge_timeline(dumps, alignment)
    kind = device_kind or costmodel.device_kind()
    peaks = costmodel.resolve_peaks(kind)
    roofline = podtrace.seam_roofline(dumps, peaks=peaks,
                                      extra_sites=extra_sites)
    rows = podtrace.skew_rows(dumps)
    return {
        "hosts": sorted(d["label"] for d in dumps),
        "run_id": dumps[0]["header"].get("run_id", "") if dumps else "",
        "events": len(merged),
        "alignment": alignment,
        "merged": merged,
        "sketches": podtrace.merge_sketches(dumps),
        "roofline": roofline,
        "device_kind": kind,
        "compute_wait": podtrace.compute_wait(dumps),
        "ingest": podtrace.ingest_breakdown(dumps),
        # one measurement, one rule: the same rows the live
        # StragglerTracker saw, judged by the shared elastic logic
        "skew": (elastic.skew_from_rows(rows, straggler_k=straggler_k)
                 if rows else None),
        "counters": {d["label"]: d["header"].get("counters") or {}
                     for d in dumps},
    }


def _fmt(x, pat="%10.3f"):
    return (pat % x) if isinstance(x, (int, float)) else "%10s" % "-"


def render(rep: dict, timeline_rows: int = 20) -> str:
    lines = ["pod report: %d host(s) %s  run_id=%r  %d merged events"
             % (len(rep["hosts"]), ",".join(rep["hosts"]),
                rep.get("run_id", ""), rep["events"])]
    al = rep["alignment"]
    lines += ["", "Clock alignment (reference %s)" % al["reference"],
              "------------------------------",
              "%-8s  %12s  %12s  %6s  %s"
              % ("host", "offset_s", "bound_s", "syncs", "consistent")]
    for lab, off in sorted(al["offsets"].items()):
        lines.append("%-8s  %s  %s  %6d  %s"
                     % (lab, _fmt(off.get("offset_s"), "%12.6f"),
                        _fmt(off.get("bound_s"), "%12.6f"),
                        off.get("sync_points", 0),
                        off.get("consistent")))
    lines += ["", "Seam roofline (device_kind=%s, ici peak=%s)"
              % (rep.get("device_kind"),
                 rep["roofline"].get("ici_bytes_per_sec")),
              "-" * 46,
              "%-28s  %12s  %6s  %10s  %12s  %10s"
              % ("site", "est_bytes", "calls", "span_s", "attained_GB/s",
                 "frac_peak")]
    for site, row in sorted(rep["roofline"]["sites"].items()):
        lines.append("%-28s  %12s  %6d  %s  %s  %s%s"
                     % (site, row.get("est_bytes"), row.get("calls", 0),
                        _fmt(row.get("span_s"), "%10.4f"),
                        _fmt(row.get("attained_gb_per_s"), "%12.4f"),
                        _fmt(row.get("frac_of_ici_peak"), "%10.4f"),
                        "" if row.get("modeled") else "  UNMODELED"))
    cw = rep.get("compute_wait") or {}
    if cw:
        lines += ["", "Compute vs collective wait (totals)",
                  "-----------------------------------"]
        for lab, row in sorted(cw.items()):
            lines.append("%-8s  compute %10.4fs  collective wait %10.4fs"
                         % (lab, row["compute_s"],
                            row["collective_wait_s"]))
    ing = rep.get("ingest") or {}
    if ing:
        lines += ["", "Ingest attribution (tokenizer vs bin vs H2D)",
                  "--------------------------------------------"]
        for lab, row in sorted(ing.items()):
            p = row["pcts"]
            lines.append("%-8s  %d chunks / %d rows   parse %s%%  "
                         "bin %s%%  h2d %s%%"
                         % (lab, row["chunks"], row["rows"],
                            p.get("parse_pct"), p.get("bin_pct"),
                            p.get("h2d_pct")))
    skew = rep.get("skew")
    if skew:
        lines += ["", "Skew (elastic.skew_from_rows — live-rule parity)",
                  "------------------------------------------------",
                  "iterations=%s max_phase_skew=%s barrier_wait_s=%s "
                  "persistent_straggler=%s"
                  % (skew.get("iterations_compared"),
                     skew.get("max_phase_skew"),
                     skew.get("barrier_wait_s"),
                     skew.get("persistent_straggler"))]
    sk = rep.get("sketches") or {}
    if sk:
        lines += ["", "Pod-wide sketches (merged percentiles)",
                  "--------------------------------------"]
        width = max(len(f) for f in sk)
        for fam, d in sorted(sk.items()):
            s = tracing.LatencySketch.from_dict(d)
            lines.append("%s  count %8d  p50 %s  p99 %s"
                         % (fam.ljust(width), s.count,
                            _fmt(s.quantile(0.5), "%10.1f"),
                            _fmt(s.quantile(0.99), "%10.1f")))
    lines += ["", "Merged timeline (first %d events)" % timeline_rows,
              "-" * 33]
    for ev in rep["merged"][:timeline_rows]:
        lines.append("%14.6f  %-6s  %s"
                     % (ev.get("t", 0.0), ev.get("_host"),
                        ev.get("kind")))
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("paths", nargs="+", help="per-host trace dump JSONL")
    p.add_argument("--check", action="store_true",
                   help="validate pod-merge contracts; exit 1 on any "
                        "violation")
    p.add_argument("--json", action="store_true")
    p.add_argument("--wire", default=None,
                   help="extra per-site byte model (MULTICHIP_WIRE / "
                        "interconnect-snapshot / plain map JSON)")
    p.add_argument("--device-kind", default=None,
                   help="roofline peak lookup override (default: local "
                        "device kind)")
    p.add_argument("--straggler-k", type=int, default=3)
    p.add_argument("--timeline", type=int, default=20,
                   help="merged-timeline rows to render")
    args = p.parse_args(argv)
    dumps = []
    findings = []
    for path in args.paths:
        try:
            dumps.append(podtrace.load_dump(path))
        except podtrace.PodTraceError as e:
            if args.check:
                findings.append(str(e))
                continue
            print("pod_report error: %s" % e, file=sys.stderr)
            return 2
    extra = None
    if args.wire:
        try:
            extra = _load_wire_arg(args.wire)
        except (OSError, ValueError) as e:
            print("pod_report error: --wire %s: %s" % (args.wire, e),
                  file=sys.stderr)
            return 2
    if args.check:
        if dumps:
            alignment = podtrace.align(dumps)
            merged = podtrace.merge_timeline(dumps, alignment)
            findings.extend(podtrace.check(dumps, alignment, merged))
            roof = podtrace.seam_roofline(
                dumps, peaks=costmodel.resolve_peaks(
                    args.device_kind or costmodel.device_kind()),
                extra_sites=extra)
            for site in roof["unmodeled"]:
                findings.append(
                    "seam %s has measured collective_sync spans but no "
                    "entry in the wire byte model — byte-model drift"
                    % site)
        for f in findings:
            print("POD-CHECK FAIL %s" % f)
        if findings:
            return 1
        print("pod-check ok: %d dump(s), merged clean" % len(dumps))
        return 0
    if not dumps:
        print("pod_report error: no dumps", file=sys.stderr)
        return 2
    rep = build_report(dumps, extra_sites=extra,
                       device_kind=args.device_kind,
                       straggler_k=args.straggler_k)
    if args.json:
        # the merged timeline dominates size; summarize it for JSON
        out = dict(rep)
        out["merged"] = {"events": len(rep["merged"])}
        print(json.dumps(out))
    else:
        print(render(rep, timeline_rows=args.timeline))
    return 0


if __name__ == "__main__":
    sys.exit(main())
