"""Merge the ranks' flight-recorder dumps: clock alignment, one
timeline, the seam roofline and ingest attribution.

The port's copy of lightgbm_tpu/podtrace.py, its functions line for line
(stdlib and the port's tracing.py; no torch, no numpy): the flight
recorder writes one dump a process, and a world of ranks needs one
answer over all of them.

**Clock alignment.**  The ranks' ``time.time()`` clocks disagree.  Every
rank of a blocking collective leaves it within that collective's own
blocked window of the last arrival, so matched ``collective_sync``
events (same site, same iteration, filed by
``tracing.record_collective_sync`` with ``pod=True``) estimate the
pairwise offset with an error of at most ``max(duration_a,
duration_b)``.  :func:`align` picks, per rank, the matched event with
the smallest such bound, records ``offset_s`` and ``bound_s``, and
checks every other estimate against it (two estimates of one offset
may differ by at most the sum of their bounds; more means the dumps are
not of one run, or a clock stepped mid-run).  The port files these
events at the straggler drain's two exchanges (elastic.py), so a
world's dumps align where the drain is armed; without it a dump has no
sync point and :func:`align` reports ``ok: False``.

**Merge algebra.**  :func:`merge_timeline` shifts each rank's events
onto the reference clock and sorts by the total order ``(t_aligned,
host_label, per-host sequence)``: independent of the order of the dumps
and associative.  Latency families merge by the sketches' bucket
addition (:func:`merge_sketches`).  Events are copied, never changed,
so each request's ``sum(components) == wall`` identity survives the
merge, and :func:`check` checks it again on the merged timeline.

**Seam roofline.**  The ``wire_model`` event (telemetry stamps each
site's bytes into the ring at the session's close) joined to the
measured ``collective_sync`` seconds gives each seam's attained GB/s;
over the caller's interconnect peak
(``costmodel.resolve_peaks(kind)['ici_bytes_per_sec']``) the fraction
of it, and None where no peak is known, the CPU included.

**File barrier.**  :func:`file_barrier` is a stdlib rendezvous of
processes over a shared directory with a collective's exit-window
property, so its edges are honest sync points too.

``scripts/port_pod_report.py`` is the command-line face.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

from . import tracing


class PodTraceError(Exception):
    """Unusable input: junk dump, mixed runs, unmergeable sketches."""


# ------------------------------------------------------------------ loading

def load_dump(path: str) -> dict:
    """One per-host dump -> {path, header, events, label}.  Raises
    PodTraceError on junk (mirrors trace_report.load, kept in-package
    so the merge library works without the script)."""
    try:
        f = open(path)
    except OSError as e:
        raise PodTraceError("cannot read %s: %s" % (path, e))
    header, events = None, []
    with f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise PodTraceError("%s:%d: unparseable JSONL (%s)"
                                    % (path, lineno, e))
            if lineno == 1:
                if not isinstance(rec, dict) or "trace_header" not in rec:
                    raise PodTraceError(
                        "%s:1: first line is not a trace_header" % path)
                header = rec["trace_header"]
            elif not isinstance(rec, dict) or "kind" not in rec:
                raise PodTraceError("%s:%d: event line without a kind"
                                    % (path, lineno))
            else:
                events.append(rec)
    if header is None:
        raise PodTraceError("%s: empty dump (no trace_header line)" % path)
    return {"path": path, "header": header, "events": events,
            "label": host_label(header)}


def host_label(header: dict) -> str:
    """Stable per-host merge label: ``p<i>`` when the dump carries a
    process index (matches timeline_report's shard labels, so skew rows
    compare across both artifact kinds), else ``<host>-<pid>``."""
    idx = header.get("process_index")
    if isinstance(idx, int):
        return "p%d" % idx
    return "%s-%s" % (header.get("host", "unknown"), header.get("pid", 0))


def check_headers(dumps: List[dict]) -> List[str]:
    """Cross-host header bookkeeping (empty list = mergeable): one run
    id, consistent process_count, distinct in-range process indices."""
    bad: List[str] = []
    run_ids = {}
    counts = {}
    labels: Dict[str, str] = {}
    for d in dumps:
        h, path = d["header"], d["path"]
        run_ids.setdefault(str(h.get("run_id") or ""), []).append(path)
        idx, cnt = h.get("process_index"), h.get("process_count")
        if cnt is not None:
            if not isinstance(cnt, int) or cnt < 1:
                bad.append("%s: header process_count=%r is not a "
                           "positive int" % (path, cnt))
            else:
                counts.setdefault(cnt, []).append(path)
        if idx is not None:
            if not isinstance(idx, int) or idx < 0 or (
                    isinstance(cnt, int) and cnt >= 1 and idx >= cnt):
                bad.append("%s: header process_index=%r out of range for "
                           "process_count=%r" % (path, idx, cnt))
        prev = labels.get(d["label"])
        if prev is not None:
            bad.append("%s: duplicate host identity %s (also %s) — two "
                       "dumps from one process cannot merge as a pod"
                       % (path, d["label"], prev))
        labels[d["label"]] = path
    if len(run_ids) > 1:
        bad.append("mixing dumps from different runs: run_id %s — a "
                   "cross-run merge would be silently wrong"
                   % (" vs ".join(repr(r) for r in sorted(run_ids))))
    if len(counts) > 1:
        bad.append("inconsistent process_count across dumps: %s"
                   % sorted(counts))
    return bad


# ------------------------------------------------------------ clock alignment

def sync_points(dumps: List[dict]) -> Dict[Tuple[str, int], Dict[str, dict]]:
    """Matched pod-wide sync events: {(site, iter): {label: event}}.
    Only ``pod=True`` collective_sync events qualify — a process-local
    collective says nothing about another host's clock.  The LAST event
    per key wins (re-recorded iterations supersede)."""
    out: Dict[Tuple[str, int], Dict[str, dict]] = {}
    for d in dumps:
        for ev in d["events"]:
            if ev.get("kind") != "collective_sync" or not ev.get("pod"):
                continue
            key = (str(ev.get("site")), int(ev.get("iter", -1)))
            out.setdefault(key, {})[d["label"]] = ev
    return {k: v for k, v in out.items() if len(v) > 1}


def align(dumps: List[dict]) -> dict:
    """Per-host clock offsets onto the reference host's clock.

    Reference = lexicographically smallest label.  For host ``h``, each
    matched sync key gives the estimate ``t1_ref - t1_h`` (exit-stamp
    difference; add ``offset_s`` to h's clock to land on the
    reference's) with error bound ``max(dur_ref, dur_h)``.  The
    estimate with the smallest bound wins and its bound is recorded —
    ``bound_s`` is the honest error bar, never better than the slowest
    of the two matched collectives.  ``consistent`` is False when any
    other estimate disagrees by more than the sum of the two bounds
    (impossible for one run with stable clocks)."""
    labels = sorted(d["label"] for d in dumps)
    ref = labels[0] if labels else None
    points = sync_points(dumps)
    offsets: Dict[str, dict] = {}
    ok = True
    for lab in labels:
        if lab == ref:
            offsets[lab] = {"offset_s": 0.0, "bound_s": 0.0,
                            "sync_points": 0, "consistent": True}
            continue
        ests: List[Tuple[float, float]] = []  # (bound, estimate)
        for key, by_host in points.items():
            a, b = by_host.get(ref), by_host.get(lab)
            if a is None or b is None:
                continue
            dur_a = max(float(a["t1"]) - float(a["t0"]), 0.0)
            dur_b = max(float(b["t1"]) - float(b["t0"]), 0.0)
            ests.append((max(dur_a, dur_b),
                         float(a["t1"]) - float(b["t1"])))
        if not ests:
            offsets[lab] = {"offset_s": None, "bound_s": None,
                            "sync_points": 0, "consistent": False}
            ok = False
            continue
        ests.sort()
        bound, offset = ests[0]
        consistent = all(abs(e - offset) <= b + bound + 1e-9
                        for b, e in ests)
        offsets[lab] = {"offset_s": round(offset, 6),
                        "bound_s": round(bound, 6),
                        "sync_points": len(ests),
                        "consistent": consistent}
        ok = ok and consistent
    return {"reference": ref, "offsets": offsets, "ok": ok,
            "matched_keys": len(points)}


# ------------------------------------------------------------------- merging

def merge_timeline(dumps: List[dict],
                   alignment: Optional[dict] = None) -> List[dict]:
    """All hosts' events on the reference clock, one global timeline.

    Each event is COPIED with ``_host`` (label) added and ``t`` shifted
    by the host's alignment offset (unaligned hosts shift by 0 — their
    events still merge, on their own clock, and --check flags it).  The
    sort key ``(t, _host, _seq)`` is a total order, so the result is
    independent of the order dumps are passed in and the merge is
    associative (merging [A,B] then C equals merging [A,[B,C]] equals
    one [A,B,C] pass) — the algebra tests pin this."""
    if alignment is None:
        alignment = align(dumps)
    out: List[dict] = []
    for d in sorted(dumps, key=lambda d: d["label"]):
        off = (alignment["offsets"].get(d["label"], {}) or {}) \
            .get("offset_s") or 0.0
        for seq, ev in enumerate(d["events"]):
            ev = dict(ev)
            ev["_host"] = d["label"]
            ev["_seq"] = seq
            if isinstance(ev.get("t"), (int, float)):
                ev["t"] = round(float(ev["t"]) + off, 6)
            out.append(ev)
    out.sort(key=lambda e: (e.get("t", 0.0), e["_host"], e["_seq"]))
    return out


def merge_sketch_dicts(a: dict, b: dict) -> dict:
    """Serialized-form sketch merge (growth/zero/buckets dicts) — the
    same bucket-count addition LatencySketch.merge performs, usable on
    dumps without rehydrating.  Raises on growth mismatch."""
    ga, gb = float(a.get("growth", 0)), float(b.get("growth", 0))
    if abs(ga - gb) > 1e-12:
        raise PodTraceError("cannot merge sketches with different growth "
                            "factors (%g vs %g)" % (ga, gb))
    buckets = {str(i): int(c) for i, c in (a.get("buckets") or {}).items()}
    for i, c in (b.get("buckets") or {}).items():
        buckets[str(i)] = buckets.get(str(i), 0) + int(c)
    return {"growth": ga, "zero": int(a.get("zero", 0)) + int(b.get("zero", 0)),
            "buckets": buckets}


def merge_sketches(dumps: List[dict]) -> Dict[str, dict]:
    """Per-family pod-wide sketches: associative fold of every host's
    serialized sketches (order-independent because bucket addition
    commutes — pinned together with the timeline algebra)."""
    out: Dict[str, dict] = {}
    for d in sorted(dumps, key=lambda d: d["label"]):
        for fam, sk in (d["header"].get("sketches") or {}).items():
            out[fam] = (merge_sketch_dicts(out[fam], sk)
                        if fam in out else merge_sketch_dicts(
                            sk, {"growth": sk.get("growth"), "zero": 0,
                                 "buckets": {}}))
    return out


def merged_quantile(sk: dict, q: float) -> Optional[float]:
    """Nearest-rank quantile of one serialized sketch."""
    return tracing.LatencySketch.from_dict(sk).quantile(q)


# ------------------------------------------------------------ derived reports

def skew_rows(dumps: List[dict]) -> Dict[int, Dict[str, Dict[str, float]]]:
    """``{iteration: {host: {phase: seconds}}}`` from train_iter events
    — the exact row shape ``elastic.skew_from_rows`` consumes, so the
    post-mortem verdict and the live StragglerTracker share one rule."""
    rows: Dict[int, Dict[str, Dict[str, float]]] = {}
    for d in dumps:
        for ev in d["events"]:
            if ev.get("kind") != "train_iter":
                continue
            phases = ev.get("phase_times") or {}
            rows.setdefault(int(ev.get("iter", -1)), {})[d["label"]] = {
                str(k): float(v) for k, v in phases.items()}
    return rows


def compute_wait(dumps: List[dict]) -> Dict[str, dict]:
    """Per-host compute vs collective-wait split per iteration:
    compute_s from train_iter phase seconds, collective_wait_s from the
    same iteration's collective_sync blocked windows."""
    out: Dict[str, dict] = {}
    for d in sorted(dumps, key=lambda d: d["label"]):
        iters: Dict[int, Dict[str, float]] = {}
        for ev in d["events"]:
            if ev.get("kind") == "train_iter":
                it = iters.setdefault(int(ev.get("iter", -1)),
                                      {"compute_s": 0.0,
                                       "collective_wait_s": 0.0})
                it["compute_s"] += float(
                    sum((ev.get("phase_times") or {}).values()))
            elif ev.get("kind") == "collective_sync":
                it = iters.setdefault(int(ev.get("iter", -1)),
                                      {"compute_s": 0.0,
                                       "collective_wait_s": 0.0})
                it["collective_wait_s"] += max(
                    float(ev.get("t1", 0)) - float(ev.get("t0", 0)), 0.0)
        out[d["label"]] = {
            "iterations": {k: {m: round(v, 6) for m, v in it.items()}
                           for k, it in sorted(iters.items())},
            "compute_s": round(sum(i["compute_s"]
                                   for i in iters.values()), 6),
            "collective_wait_s": round(sum(i["collective_wait_s"]
                                           for i in iters.values()), 6),
        }
    return out


def ingest_breakdown(dumps: List[dict]) -> Dict[str, dict]:
    """Per-host tokenizer/bin/H2D attribution summed over ingest_chunk
    events, with phase percentages, plus the coarse per-pass seconds."""
    out: Dict[str, dict] = {}
    for d in sorted(dumps, key=lambda d: d["label"]):
        tot = {"parse_us": 0.0, "bin_us": 0.0, "h2d_us": 0.0}
        chunks = rows = 0
        passes: Dict[int, dict] = {}
        for ev in d["events"]:
            if ev.get("kind") == "ingest_chunk":
                chunks += 1
                # rows counts ingested rows: pass-2 chunks only — the
                # pass-1 label/sample chunks cover the same rows again
                # and would double the count (phase sums stay all-pass)
                if int(ev.get("pass", 2)) == 2:
                    rows += int(ev.get("rows", 0))
                for k in tot:
                    tot[k] += float(ev.get(k, 0.0))
            elif ev.get("kind") == "ingest_pass":
                passes[int(ev.get("pass", -1))] = {
                    "seconds": float(ev.get("seconds", 0.0)),
                    "rows": int(ev.get("rows", 0))}
        if not chunks and not passes:
            continue
        total = sum(tot.values())
        out[d["label"]] = {
            "chunks": chunks, "rows": rows,
            **{k: round(v, 1) for k, v in tot.items()},
            "pcts": {k.replace("_us", "_pct"):
                     (round(100.0 * v / total, 2) if total > 0 else None)
                     for k, v in tot.items()},
            "passes": passes,
        }
    return out


def wire_model(dumps: List[dict],
               extra_sites: Optional[dict] = None) -> Dict[str, dict]:
    """Union per-site byte model from the dumps' ``wire_model`` events
    (largest est_bytes wins across hosts — same shape-superseding rule
    telemetry applies) plus caller-supplied ``extra_sites``
    ({site: est_bytes} or {site: {est_bytes, ...}})."""
    model: Dict[str, dict] = {}
    for d in dumps:
        for ev in d["events"]:
            if ev.get("kind") != "wire_model":
                continue
            for site, rec in (ev.get("sites") or {}).items():
                cur = model.get(site)
                if cur is None or int(rec.get("est_bytes", 0)) > \
                        int(cur.get("est_bytes", 0)):
                    model[site] = dict(rec)
    for site, rec in (extra_sites or {}).items():
        rec = rec if isinstance(rec, dict) else {"est_bytes": int(rec)}
        cur = model.get(site)
        if cur is None or int(rec.get("est_bytes", 0)) > \
                int(cur.get("est_bytes", 0)):
            model[site] = {**(cur or {}), **rec}
    return model


def seam_roofline(dumps: List[dict],
                  peaks: Optional[dict] = None,
                  extra_sites: Optional[dict] = None) -> dict:
    """Per-seam attained-vs-roofline table: measured collective_sync
    seconds joined against the per-site byte model; divided by the
    interconnect peak (``peaks['ici_bytes_per_sec']``, from
    costmodel.resolve_peaks) when one exists — ``frac_of_ici_peak`` is
    None on CPU/unknown chips rather than a made-up number.  Sites in
    the byte model without a measured span stay in the table (coverage
    is the contract) with null attained columns; measured sites MISSING
    from the model are flagged ``unmodeled`` — that's byte-model drift,
    port_pod_report --check fails on it."""
    model = wire_model(dumps, extra_sites)
    spans: Dict[str, dict] = {}
    for d in dumps:
        for ev in d["events"]:
            if ev.get("kind") != "collective_sync":
                continue
            site = str(ev.get("site"))
            rec = spans.setdefault(site, {"calls": 0, "span_s": 0.0})
            rec["calls"] += 1
            rec["span_s"] += max(float(ev.get("t1", 0))
                                 - float(ev.get("t0", 0)), 0.0)
    ici = None
    if peaks and peaks.get("ici_bytes_per_sec"):
        ici = float(peaks["ici_bytes_per_sec"])
    sites: Dict[str, dict] = {}
    unmodeled: List[str] = []
    for site in sorted(set(model) | set(spans)):
        m, sp = model.get(site), spans.get(site)
        row = {
            "est_bytes": int(m.get("est_bytes", 0)) if m else None,
            "kind": m.get("kind") if m else None,
            "calls": sp["calls"] if sp else 0,
            "span_s": round(sp["span_s"], 6) if sp else None,
            "attained_gb_per_s": None,
            "frac_of_ici_peak": None,
            "modeled": m is not None,
        }
        if m is None:
            unmodeled.append(site)
        elif sp and sp["span_s"] > 0:
            per_call = int(m.get("bytes_per_call",
                                 m.get("est_bytes", 0)))
            rate = per_call * sp["calls"] / sp["span_s"]
            row["attained_gb_per_s"] = round(rate / 1e9, 6)
            if ici:
                row["frac_of_ici_peak"] = round(rate / ici, 6)
        sites[site] = row
    return {"sites": sites, "unmodeled": unmodeled,
            "ici_bytes_per_sec": ici,
            "note": "logical payload bytes over host-blocked seconds; "
                    "fraction is a lower bound on link saturation"}


# ----------------------------------------------------------------- validation

# mirrors tracing.COMPONENTS — the merged-timeline identity re-check; a
# JAX package's dump has no ``encode`` (its ``coalesce`` holds it)
_COMPONENTS = ("queue", "linger", "coalesce", "encode", "dispatch", "walk",
               "scatter")
_OPTIONAL_COMPONENTS = ("encode",)


def check(dumps: List[dict], alignment: Optional[dict] = None,
          merged: Optional[List[dict]] = None) -> List[str]:
    """Every pod-merge contract violation (empty list = clean):

    - header bookkeeping drift / run mixing (:func:`check_headers`);
    - alignment: a host with no pod-wide sync points, or estimates
      inconsistent beyond their recorded bounds;
    - the merged timeline: event conservation (merge drops/invents
      nothing) and the per-request sum(components)==wall identity on
      every merged serve_complete — a tampered per-host dump fails
      here even though its own header still parses."""
    bad = check_headers(dumps)
    if alignment is None:
        alignment = align(dumps)
    for lab, off in sorted(alignment["offsets"].items()):
        if off.get("offset_s") is None:
            bad.append("%s: no pod-wide collective_sync points match the "
                       "reference %s — clocks cannot be aligned"
                       % (lab, alignment["reference"]))
        elif not off.get("consistent", True):
            bad.append("%s: alignment estimates disagree beyond their "
                       "recorded collective-duration bounds "
                       "(offset=%ss bound=%ss over %d sync points)"
                       % (lab, off["offset_s"], off["bound_s"],
                          off["sync_points"]))
    if merged is None:
        merged = merge_timeline(dumps, alignment)
    want = sum(len(d["events"]) for d in dumps)
    if len(merged) != want:
        bad.append("merge conservation broken: %d input events -> %d "
                   "merged" % (want, len(merged)))
    for ev in merged:
        if ev.get("kind") != "serve_complete":
            continue
        comps, wall = ev.get("components_ns"), ev.get("wall_ns")
        if not isinstance(comps, dict) or not isinstance(wall, int):
            bad.append("%s: merged trace %s serve_complete missing "
                       "components_ns/wall_ns"
                       % (ev.get("_host"), ev.get("trace")))
            continue
        missing = [c for c in _COMPONENTS
                   if c not in comps and c not in _OPTIONAL_COMPONENTS]
        if missing:
            bad.append("%s: merged trace %s missing component(s) %s"
                       % (ev.get("_host"), ev.get("trace"),
                          ",".join(missing)))
            continue
        total = sum(int(comps[c]) for c in _COMPONENTS if c in comps)
        if total != wall:
            bad.append("%s: merged trace %s attribution identity broken: "
                       "sum(components)=%d != wall=%d"
                       % (ev.get("_host"), ev.get("trace"), total, wall))
    return bad


# ---------------------------------------------------------------- file barrier

def file_barrier(dirpath: str, name: str, index: int, count: int,
                 payload=None, timeout: float = 120.0,
                 poll: float = 0.002) -> Tuple[dict, float, float]:
    """Cross-process rendezvous over a shared directory.

    Each participant atomically publishes ``<name>.<index>`` (JSON
    ``payload``) and polls until all ``count`` files exist.  Everyone
    exits within one poll interval (plus read latency) of the LAST
    arrival — the same exit-window property a real blocking collective
    has — so feeding the returned ``(t0, t1)`` edges to
    ``tracing.record_collective_sync(..., pod=True)`` yields an HONEST
    alignment bound: ``max`` of the participants' blocked windows
    covers their exit-stamp spread.  Returns ``({index: payload}, t0,
    t1)``.  Raises TimeoutError when a peer never shows."""
    t0 = time.time()
    mine = os.path.join(dirpath, "%s.%d" % (name, int(index)))
    tmp = "%s.tmp-%d" % (mine, os.getpid())
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, mine)
    peers: Dict[int, object] = {}
    deadline = t0 + float(timeout)
    while len(peers) < int(count):
        for i in range(int(count)):
            if i in peers:
                continue
            p = os.path.join(dirpath, "%s.%d" % (name, i))
            try:
                with open(p) as f:
                    peers[i] = json.load(f)
            except (OSError, ValueError):
                pass  # not published yet (or mid-replace) — keep polling
        if len(peers) < int(count):
            if time.time() > deadline:
                raise TimeoutError(
                    "file_barrier %s: %d/%d peers after %.0fs"
                    % (name, len(peers), count, timeout))
            time.sleep(poll)
    return peers, t0, time.time()
