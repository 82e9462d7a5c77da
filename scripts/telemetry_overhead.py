#!/usr/bin/env python3
"""What arming lightgbm_tpu_torch's telemetry costs the main path, on one
CUDA card.

    python3 scripts/telemetry_overhead.py [--rows 1000000] [--iters 5]
        [--reps 2] [--world P] [--out FILE]

Trains chip_smoke.py's main path (1M x 28 Higgs-shaped binary table,
255 leaves, float32, compacted) through ``lightgbm_tpu_torch.train``
under each arming in turns, ``--reps`` times:

- ``unarmed``: no observability key;
- ``sink_nomem``: ``metrics_out`` with ``memory_stats=false`` (spans,
  counters, the flight recorder, one record an iteration);
- ``sink``: ``metrics_out`` (memory gauges on, as ``auto`` resolves);
- ``sink_fence``: ``metrics_out`` and ``metrics_fence=true`` (two CUDA
  events a span, read without a wait);
- ``full``: the sink fenced, ``health=true``, a trace dump directory.

With ``--world P`` the armings run instead as the jobs of one world of
P ranks sharing the card over gloo (``tree_learner=data``, int8, the
main path's table and 255 leaves; chip_smoke.py's world workers), in
turns:

- ``unarmed``: no telemetry in the rank's process;
- ``spans``: the registry armed, no sink, ``health=false`` (spans,
  counters, collective sites);
- ``health``: that and ``health=true`` (the world's health vector, four
  small all-reduces an iteration);
- ``sink_nomem``, ``sink``: ``metrics_out`` (rank 0's file) without and
  with the memory gauges, ``health=false``;
- ``full``: ``metrics_out``, ``timeline=auto`` (a shard a rank) and
  ``health=true``.

Prints each arming's median seconds per iteration on the host clock
(the first iteration of each run left out), their ratio to ``unarmed``,
the spans an iteration opens, and the cost of one call of each thing a
span does on the card, timed over 2,000 calls: an allocator read
(``torch.cuda.memory_stats``, and the nested form it flattens), a
``record_function`` range, an NVTX range, an armed span on an idle
stream with and without its events.  Then the card's name and power
limit, and one JSON line; ``--out`` also writes the report to FILE.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ARMINGS = ("unarmed", "sink_nomem", "sink", "sink_fence", "full")
WORLD_ARMINGS = ("unarmed", "spans", "health", "sink_nomem", "sink", "full")


def arming_params(name: str, tmp: str) -> dict:
    sink = {"metrics_out": os.path.join(tmp, name + ".jsonl")}
    return {"unarmed": {},
            "sink_nomem": dict(sink, memory_stats="false"),
            "sink": sink,
            "sink_fence": dict(sink, metrics_fence="true"),
            "full": dict(sink, metrics_fence="true", health="true",
                         trace_dump_dir=os.path.join(tmp, "dumps"))}[name]


def world_params(name: str) -> dict:
    """One ``--world`` arming's keys (paths relative to the world's
    directory)."""
    sink = {"metrics_out": name + ".jsonl"}
    return {"unarmed": {}, "spans": {"health": "false"},
            "health": {"health": "true"},
            "sink_nomem": dict(sink, memory_stats="false", health="false"),
            "sink": dict(sink, health="false"),
            "full": dict(sink, timeline="auto", health="true")}[name]


def world_seconds(args, tmp, say, dev) -> dict:
    """Each ``--world`` arming's seconds an iteration, every rank's, the
    first iteration of each run left out; the armings' jobs run in turns
    in one world (chip_smoke.start_world), and must train one model."""
    from chip_smoke import SEED, finish_world, make_data, start_world
    x, y = make_data(args.rows, 28, SEED)
    data = (os.path.join(tmp, "x.npy"), os.path.join(tmp, "y.npy"))
    np.save(data[0], x.astype(np.float32))
    np.save(data[1], y)
    base = {"objective": "binary", "num_leaves": 255,
            "num_iterations": args.iters, "learning_rate": 0.1,
            "max_bin": 255, "hist_dtype": "int8", "tree_learner": "data",
            "num_machines": args.world}
    jobs = []
    for rep in range(args.reps):
        order = WORLD_ARMINGS if rep % 2 == 0 else WORLD_ARMINGS[::-1]
        jobs += [{"name": "%s_%d" % (name, rep), "unarmed": name == "unarmed",
                  "params": dict(base, **world_params(name))}
                 for name in order]
    say("world of %d ranks, jobs in turns: %s" % (
        args.world, " ".join(j["name"] for j in jobs)))
    ranks, wdir, _ = finish_world(start_world(
        tmp, "world", args.world, jobs, dev, data,
        timeout=3000, threads=2), 0)
    texts = {open(os.path.join(wdir, "%s.rank%d.txt" % (j["name"], r))
                  ).read() for j in jobs for r in range(args.world)}
    if len(texts) != 1:
        raise SystemExit("telemetry_overhead: the armings trained "
                         "different models")
    return {name: [s for rk in ranks for rep in range(args.reps)
                   for s in rk["%s_%d" % (name, rep)]["iter_s"][1:]]
            for name in WORLD_ARMINGS}


def per_call_us(fn, calls: int = 2000) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--world", type=int, default=0,
                    help="ranks of a tree_learner=data world (module "
                         "docstring); 0: the serial main path")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("telemetry_overhead: no CUDA device", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lgt
    from chip_smoke import SEED, make_data
    from lightgbm_tpu_torch import telemetry
    from lightgbm_tpu_torch.ops import cuda_build

    lines = []

    def say(msg):
        print(msg, flush=True)
        lines.append(msg)

    cuda_build.build()
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="telemetry_overhead_")
    if args.world:
        secs = world_seconds(args, tmp, say, dev)
        med = {name: float(np.median(v)) for name, v in secs.items()}
        for name in WORLD_ARMINGS:
            say("%-10s median %.4f s an iteration a rank (x%.3f unarmed) "
                "over %d rank-iterations: %s" % (
                    name, med[name], med[name] / med["unarmed"],
                    len(secs[name]), " ".join("%.3f" % v
                                              for v in secs[name])))
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        say(smi.stdout.strip() or smi.stderr.strip())
        say(json.dumps({"telemetry_overhead_world": {
            "median_s_per_iter": med, "world": args.world,
            "rows": args.rows, "iters": args.iters, "reps": args.reps}}))
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                f.write("\n".join(lines) + "\n")
        return 0
    x, y = make_data(args.rows, 28, SEED)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=255)
    base = {"objective": "binary", "num_leaves": 255,
            "num_iterations": args.iters, "learning_rate": 0.1,
            "max_bin": 255}
    secs = {name: [] for name in ARMINGS}
    spans_per_iter = None
    texts = set()
    for rep in range(args.reps):
        order = ARMINGS if rep % 2 == 0 else ARMINGS[::-1]
        for name in order:
            stamps = []

            def progress(_it):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())

            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            booster = lgt.train(dict(base, **arming_params(name, tmp)), ds,
                                device=dev, progress_fn=progress)
            texts.add(booster.model_to_string())
            secs[name] += list(np.diff(stamps)[1:])
            if name == "sink" and spans_per_iter is None:
                counts = telemetry.snapshot()["phase_counts"]
                spans_per_iter = sum(counts.values()) / args.iters
            del booster
    if len(texts) != 1:
        say("FAIL: the armings trained different models")
        return 1
    med = {name: float(np.median(v)) for name, v in secs.items()}
    for name in ARMINGS:
        say("%-10s median %.4f s an iteration (x%.3f unarmed) over %d "
            "iterations: %s" % (name, med[name], med[name] / med["unarmed"],
                                len(secs[name]), " ".join(
                                    "%.3f" % v for v in secs[name])))
    say("spans an iteration (sink): %.1f" % spans_per_iter)

    # what one span does, per call, on an idle stream
    torch.cuda.synchronize()
    costs = {
        "memory_stats": per_call_us(lambda: torch.cuda.memory_stats(dev)),
        "memory_stats_nested": per_call_us(
            lambda: torch.cuda.memory_stats_as_nested_dict(dev)),
    }

    def rf():
        with torch.profiler.record_function("histogram"):
            pass

    def nvtx():
        torch.cuda.nvtx.range_push("histogram")
        torch.cuda.nvtx.range_pop()

    costs["record_function"] = per_call_us(rf)
    costs["nvtx_range"] = per_call_us(nvtx)
    probe = torch.zeros(1, device=dev)
    telemetry.set_device(dev)
    for fence in (False, True):
        telemetry.enable(fence=fence, memory=False)

        def one_span():
            with telemetry.span("histogram") as sp:
                sp.fence(probe)

        costs["span" + ("_fenced" if fence else "")] = per_call_us(one_span)
        telemetry.disable()
    telemetry.enable(memory=True)
    costs["span_with_gauges"] = per_call_us(
        lambda: telemetry.span("histogram").__enter__().__exit__(
            None, None, None))
    telemetry.disable()
    telemetry.reset()
    for k, v in costs.items():
        say("one %s: %.2f us" % (k, v))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    say(smi.stdout.strip() or smi.stderr.strip())
    say(json.dumps({"telemetry_overhead": {
        "median_s_per_iter": med, "spans_per_iter": spans_per_iter,
        "per_call_us": costs, "rows": args.rows, "iters": args.iters,
        "reps": args.reps}}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
