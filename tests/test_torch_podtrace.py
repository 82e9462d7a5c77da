"""lightgbm_tpu_torch.podtrace and the port's report scripts against the
JAX package's lightgbm_tpu/podtrace.py and scripts, live, on the same
dumps and shards (no world here: tests/test_torch_world_telemetry.py
runs the worlds).

- Dumps written by either package's flight recorder (``writer``) load
  alike through both modules, and ``check_headers``, ``sync_points``,
  ``align``, ``merge_timeline``, ``merge_sketches``, ``merged_quantile``,
  ``skew_rows``, ``compute_wait``, ``ingest_breakdown``, ``wire_model``,
  ``seam_roofline`` and ``check`` give the JAX module's results, exactly.
- Alignment recovers a skewed clock within its recorded bound; only
  ``pod=True`` events are sync points; the merge is independent of the
  dumps' order; a tampered request identity, a run mix and a rank
  identity out of range are caught.
- ``tracing.record_collective_sync`` files the JAX event and sketch.
- ``file_barrier``'s blocked windows cover its participants' exit spread.
- ``seam_roofline`` takes the H100's interconnect peak from the port's
  ``costmodel.resolve_peaks`` and none on the CPU.
- ``scripts/port_pod_report.py`` and ``scripts/port_timeline_report.py``
  print the JAX scripts' ``--json`` and exit with their codes.
- ``costmodel.host_fingerprint`` describes the card's stack, no TPU
  field; ``telemetry.shard_path`` is the JAX name; ``telemetry.disable``
  stamps the ``wire_model`` event before the close dump.
"""
import json
import sys
import threading
import time

import pytest

from lightgbm_tpu import podtrace as jpodtrace
from lightgbm_tpu import telemetry as jtelemetry
from lightgbm_tpu import tracing as jtracing

from lightgbm_tpu_torch import (costmodel, elastic, lifecycle, podtrace,
                                telemetry, tracing)
from scripts import (pod_report, port_pod_report, port_timeline_report,
                     timeline_report)

BASE_T = 1_700_000_000.0       # a synthetic wall-clock origin
H100 = "NVIDIA H100 80GB HBM3"
TRACERS = {"port": tracing, "jax": jtracing}


@pytest.fixture(autouse=True)
def clean():
    """Both recorders disarmed and without identity around each test."""
    for mod in TRACERS.values():
        mod.disarm()
        mod.set_identity(process_index=None, process_count=None, run_id="")
    yield
    for mod in TRACERS.values():
        mod.disarm()
        mod.set_identity(process_index=None, process_count=None, run_id="")
    left = lifecycle.leaks()
    for _, _, closer in left:
        closer()
    assert not left, [(k, n) for k, n, _ in left]


def make_dump(tmp_path, writer, name, index, fill, count=2, run_id="run-a"):
    """One dump from ``writer``'s recorder: arm, set the identity, run
    ``fill(tracing_module)``, dump, disarm; returns its path."""
    mod = TRACERS[writer]
    mod.arm(ring_events=4096)
    mod.set_identity(process_index=index, process_count=count,
                     run_id=run_id)
    fill(mod)
    path = str(tmp_path / name)
    assert mod.dump(path=path, reason="test") == path
    mod.disarm()
    return path


def sync_fill(index, skew_s=0.0, iters=3, dur_s=0.010, jitter_s=0.001):
    """Collectives over the world at iterations 1..iters: every rank
    leaves at nearly the same true instant, and a skewed rank's clock
    reads truth + skew_s; plus a sketch, a train_iter and a mark."""
    def fill(mod):
        for k in range(1, iters + 1):
            t1 = BASE_T + k + skew_s + (jitter_s if index else 0.0)
            mod.record_collective_sync("elastic/times_allgather", k,
                                       t1 - dur_s, t1, pod=True)
            mod.observe("train_iter_us", 1000.0 * (index + k))
            mod.record_train_iteration(k, {p: 0.01 * (1 + index)
                                           for p in elastic.CANONICAL_PHASES})
            mod.event("mark", host_tag=index, k=k)
    return fill


def serve_fill(mod):
    comps = {"queue": 10, "linger": 5, "coalesce": 0, "dispatch": 7,
             "walk": 40, "scatter": 3}
    mod.event("serve_complete", trace=1, wall_ns=sum(comps.values()),
              components_ns=comps)


def ingest_fill(mod):
    for c, (p, b, h) in enumerate(((30.0, 10.0, 5.0), (20.0, 12.0, 4.0))):
        mod.record_ingest_chunk(2, c, 100, p, b, h)
    mod.record_ingest_chunk(1, 0, 200, 8.0, 0.0, 0.0)
    mod.record_ingest_pass(2, 0.25, 200)


def wire_fill(mod):
    mod.record_collective_sync("hist/psum", 1, BASE_T, BASE_T + 0.5,
                               pod=True)
    mod.record_collective_sync("hist/psum", 2, BASE_T + 1, BASE_T + 1.5,
                               pod=True)
    mod.record_collective_sync("orphan/seam", 1, BASE_T, BASE_T + 0.1,
                               pod=False)
    mod.event("wire_model", sites={
        "hist/psum": {"est_bytes": 2_000_000, "bytes_per_call": 1_000_000,
                      "est_calls": 2, "kind": "psum"},
        "unmeasured/seam": {"est_bytes": 7}})


def model_fill(mod):
    """Ingest events and the wire model of sync_fill's seam."""
    ingest_fill(mod)
    mod.event("wire_model", sites={"elastic/times_allgather": {
        "est_bytes": 12, "bytes_per_call": 4, "est_calls": 3,
        "kind": "all_gather", "axis": "data"}})


def loaded(paths):
    """The dumps through each module's loader: (port's, JAX's)."""
    return ([podtrace.load_dump(p) for p in paths],
            [jpodtrace.load_dump(p) for p in paths])


def pod_dumps(tmp_path, writer, skew=1.5, extra=None, count=3):
    paths = []
    for i in range(count):
        def fill(mod, i=i):
            sync_fill(i, skew_s=skew * i)(mod)
            if extra is not None:
                extra(mod)
        paths.append(make_dump(tmp_path, writer, "d%d.jsonl" % i, i, fill,
                               count=count))
    return paths


WRITERS = pytest.mark.parametrize("writer", ["port", "jax"])


@WRITERS
def test_load_and_headers_equal_jax(tmp_path, writer):
    paths = pod_dumps(tmp_path, writer, extra=serve_fill)
    port, jax_ = loaded(paths)
    assert port == jax_
    assert [d["label"] for d in port] == ["p0", "p1", "p2"]
    assert podtrace.check_headers(port) == jpodtrace.check_headers(jax_) \
        == []
    assert podtrace.sync_points(port) == jpodtrace.sync_points(jax_)


@WRITERS
def test_align_equals_jax_within_bound(tmp_path, writer):
    """Rank 1's clock 1.5 s ahead, rank 2's 3 s: the offsets come back
    within their recorded bounds, as the JAX module gives them."""
    port, jax_ = loaded(pod_dumps(tmp_path, writer))
    al = podtrace.align(port)
    assert al == jpodtrace.align(jax_)
    assert al["ok"] and al["reference"] == "p0"
    for i in (1, 2):
        off = al["offsets"]["p%d" % i]
        assert off["consistent"] and off["sync_points"] == 3
        assert abs(off["offset_s"] + 1.5 * i) <= off["bound_s"] + 1e-9


@WRITERS
def test_merge_equals_jax_and_order_free(tmp_path, writer):
    port, jax_ = loaded(pod_dumps(tmp_path, writer, extra=serve_fill))
    merged = podtrace.merge_timeline(port)
    assert merged == jpodtrace.merge_timeline(jax_)
    for order in ((2, 0, 1), (1, 2, 0), (2, 1, 0)):
        assert podtrace.merge_timeline([port[i] for i in order]) == merged
    assert len(merged) == sum(len(d["events"]) for d in port)
    sk = podtrace.merge_sketches(port)
    assert sk == jpodtrace.merge_sketches(jax_)
    assert podtrace.merge_sketches(port[::-1]) == sk
    for fam, d in sk.items():
        for q in (0.5, 0.99):
            assert podtrace.merged_quantile(d, q) == \
                jpodtrace.merged_quantile(d, q)


@WRITERS
def test_derived_reports_equal_jax(tmp_path, writer):
    port, jax_ = loaded(pod_dumps(tmp_path, writer, extra=ingest_fill))
    for fn in ("skew_rows", "compute_wait", "ingest_breakdown",
               "wire_model"):
        assert getattr(podtrace, fn)(port) == getattr(jpodtrace, fn)(jax_)
    rows = podtrace.skew_rows(port)
    assert elastic.skew_from_rows(rows, straggler_k=3)[
        "persistent_straggler"] == "p2"
    assert podtrace.ingest_breakdown(port)["p0"]["rows"] == 200


@WRITERS
def test_check_equals_jax(tmp_path, writer):
    """Clean, a tampered request identity, a run mix and a rank out of
    range: the same findings from both modules."""
    paths = pod_dumps(tmp_path, writer, extra=serve_fill, count=2)
    port, jax_ = loaded(paths)
    assert podtrace.check(port) == jpodtrace.check(jax_) == []
    lines = open(paths[1]).read().splitlines()
    out = []
    for line in lines:
        rec = json.loads(line)
        if rec.get("kind") == "serve_complete":
            rec["components_ns"]["walk"] += 1
        out.append(json.dumps(rec))
    with open(paths[1], "w") as f:
        f.write("\n".join(out) + "\n")
    port, jax_ = loaded(paths)
    bad = podtrace.check(port)
    assert bad == jpodtrace.check(jax_)
    assert any("attribution identity broken" in b for b in bad)
    mixed = [make_dump(tmp_path, writer, "m%d.jsonl" % i, i, sync_fill(i),
                       run_id="run-%d" % i) for i in range(2)]
    mixed.append(make_dump(tmp_path, writer, "m2.jsonl", 5, sync_fill(0)))
    port, jax_ = loaded(mixed)
    bad = podtrace.check(port)
    assert bad == jpodtrace.check(jax_)
    assert any("different runs" in b for b in bad)
    assert any("process_index=5 out of range" in b for b in bad)


@WRITERS
def test_rank_local_collectives_are_no_sync_points(tmp_path, writer):
    def local(mod):
        for k in range(1, 4):
            mod.record_collective_sync("elastic/times_allgather", k,
                                       BASE_T + k - 0.01, BASE_T + k,
                                       pod=False)
    paths = [make_dump(tmp_path, writer, "l%d.jsonl" % i, i, local)
             for i in range(2)]
    port, jax_ = loaded(paths)
    al = podtrace.align(port)
    assert al == jpodtrace.align(jax_)
    assert not al["ok"] and al["offsets"]["p1"]["offset_s"] is None
    assert any("cannot be aligned" in f for f in podtrace.check(port, al))


@WRITERS
def test_seam_roofline_equals_jax(tmp_path, writer):
    path = make_dump(tmp_path, writer, "w.jsonl", 0, wire_fill, count=1)
    port, jax_ = loaded([path])
    for peaks in (None, {"ici_bytes_per_sec": 8_000_000.0}):
        assert podtrace.seam_roofline(port, peaks=peaks) == \
            jpodtrace.seam_roofline(jax_, peaks=peaks)
    roof = podtrace.seam_roofline(port,
                                  peaks={"ici_bytes_per_sec": 8_000_000.0})
    row = roof["sites"]["hist/psum"]
    assert row["modeled"] and row["calls"] == 2
    assert abs(row["frac_of_ici_peak"] - 0.25) < 1e-9
    assert roof["unmodeled"] == ["orphan/seam"]


def test_seam_roofline_reads_the_ports_peak(tmp_path):
    """The interconnect peak comes from the port's costmodel: the H100's
    NVLink rate; the CPU has none, and the fraction stays None."""
    path = make_dump(tmp_path, "port", "w.jsonl", 0, wire_fill, count=1)
    d = [podtrace.load_dump(path)]
    h100 = podtrace.seam_roofline(d, peaks=costmodel.resolve_peaks(H100))
    assert h100["ici_bytes_per_sec"] == 450e9
    assert h100["sites"]["hist/psum"]["frac_of_ici_peak"] == round(
        2_000_000 / 1.0 / 450e9, 6)
    cpu = podtrace.seam_roofline(d, peaks=costmodel.resolve_peaks("cpu"))
    assert cpu["ici_bytes_per_sec"] is None
    assert cpu["sites"]["hist/psum"]["frac_of_ici_peak"] is None


def test_record_collective_sync_equals_jax():
    for mod in TRACERS.values():
        mod.arm(ring_events=16)
        mod.record_collective_sync("elastic/survivor_pmin", 4, BASE_T,
                                   BASE_T + 0.0025, pod=True)
    evs = [mod._events_locked() for mod in TRACERS.values()]
    sks = [mod.cumulative_state()["sketches"]["collective_sync_us"]
           .to_dict() for mod in TRACERS.values()]
    assert evs[0] == evs[1] and sks[0] == sks[1]
    assert abs(evs[0][0]["dur_us"] - 2500.0) < 1.0 and evs[0][0]["pod"]
    for mod in TRACERS.values():
        mod.disarm()
        mod.record_collective_sync("x", 1, 0.0, 1.0)       # disarmed
        assert mod.active() is False


def test_file_barrier_bound_covers_exit_spread(tmp_path):
    """Rank 0 arrives 50 ms late; both leave within the larger blocked
    window, which is the bound align records from the two edges."""
    res = {}

    def worker(i):
        res[i] = podtrace.file_barrier(str(tmp_path), "it", i, 2,
                                       payload={"v": i}, timeout=30.0)

    t = threading.Thread(target=worker, args=(1,))
    t.start()
    time.sleep(0.05)
    worker(0)
    t.join(30)
    (p0, a0, b0), (p1, a1, b1) = res[0], res[1]
    assert p0 == p1 == {0: {"v": 0}, 1: {"v": 1}}
    assert abs(b0 - b1) <= max(b0 - a0, b1 - a1) + 1e-9
    paths = []
    for i, (a, b) in enumerate(((a0, b0), (a1, b1))):
        def fill(mod, a=a, b=b):
            mod.record_collective_sync("barrier", 1, a, b, pod=True)
        paths.append(make_dump(tmp_path, "port", "b%d.jsonl" % i, i, fill))
    al = podtrace.align([podtrace.load_dump(p) for p in paths])
    off = al["offsets"]["p1"]
    assert al["ok"] and abs(off["offset_s"]) <= off["bound_s"] + 1e-6
    with pytest.raises(TimeoutError):
        podtrace.file_barrier(str(tmp_path), "alone", 0, 2, timeout=0.2)


def _run(main, argv, capsys, monkeypatch, takes_argv):
    """A report script's exit code and standard output."""
    if takes_argv:
        rc = main(argv)
    else:
        monkeypatch.setattr(sys, "argv", ["pod_report.py"] + argv)
        rc = main()
    return rc, capsys.readouterr().out


@WRITERS
@pytest.mark.parametrize("mode", ["--json", "--check"])
def test_port_pod_report_equals_jax(tmp_path, writer, mode, capsys,
                                    monkeypatch):
    paths = pod_dumps(tmp_path, writer, extra=model_fill)
    argv = [mode, "--device-kind", "cpu"] + paths
    want = _run(pod_report.main, argv, capsys, monkeypatch, False)
    got = _run(port_pod_report.main, argv, capsys, monkeypatch, True)
    assert got == want
    assert got[0] == 0
    if mode == "--json":
        rep = json.loads(got[1])
        assert rep["alignment"]["ok"] and rep["events"] > 0


def test_port_pod_report_exit_codes(tmp_path, capsys, monkeypatch):
    """Unalignable dumps fail --check (1) and junk is unreadable (2),
    as the JAX script says."""
    local = [make_dump(tmp_path, "port", "l%d.jsonl" % i, i,
                       lambda mod: mod.event("mark")) for i in range(2)]
    junk = tmp_path / "junk.jsonl"
    junk.write_text("not json\n")
    for argv, code in ((["--check"] + local, 1), ([str(junk)], 2)):
        want = _run(pod_report.main, argv, capsys, monkeypatch, False)
        got = _run(port_pod_report.main, argv, capsys, monkeypatch, True)
        assert got == want and got[0] == code


def write_shards(tmp_path, slow_rank=1, iters=5):
    """Two ranks' timeline shards through the port's sink, one process
    standing for each rank (``set_shard_identity``): rank ``slow_rank``
    slowest every iteration, with collective sites in the summary."""
    base = str(tmp_path / "run.jsonl")
    for rank in range(2):
        telemetry.enable(base, timeline=True)
        telemetry.reset()
        telemetry.set_shard_identity(rank, 2)
        telemetry.set_clock_offset(0.25 * rank, rtt_s=0.001)
        telemetry.record_collective("dp_psum/leafwise/hist_allreduce",
                                    "psum", "data", 4096, 0.002, "grow")
        for it in range(1, iters + 1):
            pt = {p: 0.01 * (2 if rank == slow_rank else 1)
                  for p in elastic.CANONICAL_PHASES}
            telemetry.emit_iteration(it, pt)
        telemetry.emit_summary()
        assert telemetry.sink_path() == telemetry.shard_path(base, rank, 2)
        telemetry.disable()
        telemetry.reset()
    telemetry.set_clock_offset(0.0)
    return base


def test_shard_path_equals_jax():
    for args in (("m.jsonl", 0, 1), ("/a/b.jsonl", 3, 12)):
        assert telemetry.shard_path(*args) == jtelemetry.shard_path(*args)


@pytest.mark.parametrize("flags", [["--json"], ["--json", "--straggler-k",
                                                "9"]])
def test_port_timeline_report_equals_jax(tmp_path, flags, capsys):
    """The port's shards through both scripts: one --json, one exit code
    (1: rank 1 slowest in every one of 5 iterations, unless k is 9)."""
    base = write_shards(tmp_path)
    argv = flags + ["--glob", base + ".shard-*"]
    want = timeline_report.main(argv), capsys.readouterr().out
    got = port_timeline_report.main(argv), capsys.readouterr().out
    assert got == want
    rep = json.loads(got[1])
    assert rep["hosts"] == ["p0@" + rep["hosts"][0].split("@")[1],
                            "p1@" + rep["hosts"][1].split("@")[1]]
    assert rep["wire"]["est_bytes_total"] == 4096
    assert got[0] == (1 if "9" not in flags else 0)
    assert (rep["persistent_straggler"] or "").startswith(
        "p1" if "9" not in flags else "")


def test_port_timeline_report_exit_codes(tmp_path, capsys):
    base = write_shards(tmp_path)
    bad = tmp_path / "bad.jsonl.shard-00000of00001.jsonl"
    bad.write_text('{"iter": 1}\nnot json\n{"iter": 2}\n')
    for argv in ([], [str(bad)], ["--perfetto", str(tmp_path / "p.json"),
                                  base + ".shard-00000of00002.jsonl"]):
        want = timeline_report.main(argv), capsys.readouterr().out
        got = port_timeline_report.main(argv), capsys.readouterr().out
        assert got == want
    assert port_timeline_report.main([]) == 2
    assert port_timeline_report.main([str(bad)]) == 2


def test_host_fingerprint_describes_the_card_stack():
    fp = costmodel.host_fingerprint()
    assert fp["device_kind"] == "cpu" and fp["backend"] == "cpu"
    assert fp["torch_version"] and fp["process_count"] == 1
    assert "cuda_version" in fp and fp["local_device_count"] == 0
    assert not any(k.startswith(("jax", "tpu")) for k in fp)


def test_disable_stamps_the_wire_model_before_the_close_dump(tmp_path):
    """The session's sites go into the ring as the JAX ``wire_model``
    event, and the close dump carries it, so a dump's seams are
    modeled."""
    telemetry.enable()
    telemetry.reset()
    tracing.arm(ring_events=64, dump_dir=str(tmp_path))
    telemetry.record_collective("health/vector_psum", "psum", "data", 24,
                                0.001)
    tracing.record_collective_sync("health/vector_psum", 1, BASE_T,
                                   BASE_T + 0.001, pod=True)
    telemetry.disable()
    telemetry.reset()
    (dump,) = tmp_path.glob("trace-*.jsonl")
    d = podtrace.load_dump(str(dump))
    (ev,) = [e for e in d["events"] if e["kind"] == "wire_model"]
    assert ev["sites"] == {"health/vector_psum": {
        "est_bytes": 24, "bytes_per_call": 24, "est_calls": 1,
        "kind": "psum", "axis": "data"}}
    roof = podtrace.seam_roofline([d])
    assert roof["unmodeled"] == [] and \
        roof["sites"]["health/vector_psum"]["calls"] == 1
