#!/usr/bin/env python3
"""Where the time goes on lightgbm_tpu_torch's main path, on one CUDA card.

    python3 scripts/port_profile.py [--rows 1000000] [--iters 2] [--out FILE]

Trains the chip_smoke.py main-path configuration (Higgs-shaped binary
table, 28 features, max_bin 255, 255 leaves, float32 histograms): one
warm-up iteration, then ``--iters`` iterations under ``torch.profiler``.
Prints the wall time per iteration, the device time per kernel name (top
20), the device busy and idle shares of the profiled window, and the
card's name and power limit; ``--out`` also writes the report to FILE.
"""
from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("port_profile: no CUDA device", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lgt
    from chip_smoke import SEED, make_data
    from lightgbm_tpu_torch.ops import cuda_build

    cuda_build.build()
    x, y = make_data(args.rows, 28, SEED)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=255)
    booster = lgt.train({"objective": "binary", "num_leaves": 255,
                         "num_iterations": 1, "max_bin": 255}, ds)
    torch.cuda.synchronize()
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
    lines = ["rows %d, 28 features, 255 leaves, float32: %d iterations "
             "profiled" % (args.rows, args.iters),
             "wall per iteration: %.4f s" % (wall / args.iters),
             "device kernel time per iteration: %.4f s; busy share %.3f, "
             "idle share %.3f" % (busy_s / args.iters, busy_s / wall,
                                  1 - busy_s / wall),
             "top kernels by device time (ms per iteration, launches per "
             "iteration):"]
    for name, us in per_name.most_common(20):
        lines.append("  %10.3f ms %7d  %s" % (
            us / 1e3 / args.iters, calls[name] // args.iters, name[:100]))
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
