#!/usr/bin/env python3
"""Where the time goes on lightgbm_tpu_torch's main path, on one CUDA card.

    python3 scripts/port_profile.py [--rows 1000000] [--iters 2] [--out FILE]
        [--narrow 24] [--max-bin 1023] [--set KEY=VALUE ...]

Trains the chip_smoke.py main-path configuration (Higgs-shaped binary
table, 28 features, max_bin 255, 255 leaves, float32 histograms), or
that configuration with the training keys of ``--set`` added (e.g.
``--set grow_policy=depthwise hist_dtype=int8`` or ``--set
objective=multiclass num_class=5``; ``objective=lambdarank`` adds
chip_smoke.py's queries of 50-190 documents; the sampling keys too, e.g.
the reference example's ``--set num_leaves=63 feature_fraction=0.8
bagging_fraction=0.8 bagging_freq=5``, whose redraws fall on iterations
0, 5, 10, ... of the run, the warm-up being iteration 0; or ``--set
goss=true``).  ``--narrow 24`` trains bench.py's headline table
instead (chip_smoke.make_mixed: 24 of the 28 columns narrow, so
``mixed_bin=auto`` packs it; ``--set mixed_bin=false`` keeps it
uniform).  ``--max-bin 1023`` bins the table with 16-bit bins (1022 a
continuous column; default 255).  One
warm-up iteration, ``--iters`` iterations timed on the host clock without
the profiler, then ``--iters`` more under ``torch.profiler``.  Prints the
wall time per iteration of both, the device time per kernel name (top
20), the device time of the port's histogram and partition kernels with
all their instantiations summed and of torch's copy and other elementwise
kernels, the device busy and idle shares of the profiled window, and the
card's name and power limit; ``--out`` also writes the report to FILE.
"""
from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--narrow", type=int, default=0,
                    help="narrow columns of bench.py's headline table "
                         "(0: the all-continuous main-path table)")
    ap.add_argument("--max-bin", type=int, default=255,
                    help="max_bin of the table (above 256: 16-bit bins)")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                    help="training keys added to the main-path ones")
    args = ap.parse_args()
    extra = dict(kv.split("=", 1) for kv in args.set)
    import torch
    if not torch.cuda.is_available():
        print("port_profile: no CUDA device", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lgt
    from chip_smoke import SEED, make_data, make_mixed, rank_queries
    from lightgbm_tpu_torch.ops import cuda_build

    cuda_build.build()
    x, y = (make_mixed(args.rows, 28, SEED, args.narrow) if args.narrow
            else make_data(args.rows, 28, SEED))
    qb = (rank_queries(args.rows, np.random.RandomState(SEED))
          if extra.get("objective") == "lambdarank" else None)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=args.max_bin,
                                 query_boundaries=qb)
    booster = lgt.train(dict({"objective": "binary", "num_leaves": 255,
                              "num_iterations": 1, "max_bin": args.max_bin},
                             **extra), ds)
    torch.cuda.synchronize()
    plain_s = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        booster.train_one_iter(is_eval=False)
        torch.cuda.synchronize()
        plain_s.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            booster.train_one_iter(is_eval=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    per_name = collections.Counter()
    calls = collections.Counter()
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "device_time", None)
        if us is None:
            us = getattr(evt, "cuda_time", 0.0)
        per_name[evt.name] += us
        calls[evt.name] += 1
    busy_s = sum(per_name.values()) / 1e6
    lines = ["rows %d, 28 features (%d narrow), max_bin %d (num_bin max "
             "%d), %s leaves, %s: %d iterations profiled" % (
                 args.rows, args.narrow, args.max_bin,
                 int(ds.num_bins.max()), extra.get("num_leaves", 255),
                 " ".join(args.set) or "float32", args.iters),
             "wall per iteration without the profiler: %.4f s (%s)" % (
                 sum(plain_s) / args.iters,
                 ", ".join("%.4f" % t for t in plain_s)),
             "wall per iteration under the profiler: %.4f s" % (
                 wall / args.iters),
             "device kernel time per iteration: %.4f s; busy share %.3f, "
             "idle share %.3f" % (busy_s / args.iters, busy_s / wall,
                                  1 - busy_s / wall),
             "top kernels by device time (ms per iteration, launches per "
             "iteration):"]
    for name, us in per_name.most_common(20):
        lines.append("  %10.3f ms %7d  %s" % (
            us / 1e3 / args.iters, calls[name] // args.iters, name[:100]))
    # the port's own kernels, every instantiation summed; then torch's
    # copies and its other elementwise kernels (the glue around them)
    families = (
        ("histogram", "hist_kernel*", lambda n: "hist_kernel" in n),
        # part_*: the three kernels of the earlier partition design, so
        # the script reads an older checkout too
        ("partition", "partition_* or part_*",
         lambda n: "partition_" in n or "part_" in n),
        ("copy", "*copy*", lambda n: "copy" in n),
        ("elementwise", "*elementwise* but not *copy*",
         lambda n: "elementwise" in n and "copy" not in n))
    for label, pattern, match in families:
        names = [n for n in per_name if match(n)]
        lines.append("%s kernels (%s): %.3f ms per iteration, %d launches "
                     "per iteration" % (
                         label, pattern,
                         sum(per_name[n] for n in names) / 1e3 / args.iters,
                         sum(calls[n] for n in names) // args.iters))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines.append(smi.stdout.strip())
    report = "\n".join(lines)
    print(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(report + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
