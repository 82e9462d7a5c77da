#!/usr/bin/env python3
"""The partition kernel (csrc/partition.cu) alone, on one CUDA card.

    python3 scripts/partition_port_bench.py [--out FILE]

Times the pane entry's kernel at main-path shapes: a 28-feature pane (40
rows) at the root's 1M lanes and at parent sizes from 2,000 to 300,000
lanes, and a 200-feature pane (216 rows) at 250,000 lanes.  Each segment
starts at an unaligned lane.  For each: the plan's tiles, rows per block
(``group``) and kernel launches; the kernel with ``group`` set to each of
several values (the rest of the plan kept) through the library entry;
``compact.partition_pane`` with its own plan; and the bound, the
segment's bytes read and written once over 3.35 TB/s.  Then segments of 2
to 12 tiles in one launch against a count pass first.
Prints one table and the card's name and power limit; ``--out`` also
writes it to FILE.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GROUPS = (1, 2, 4, 8, 16)
SIZES = ((28, 1_000_000), (28, 300_000), (28, 100_000), (28, 40_000),
         (28, 30_000), (28, 8_000), (28, 4_000), (28, 2_000),
         (200, 250_000))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("partition_port_bench: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import HBM_BYTES_PER_S, cuda_ms
    from lightgbm_tpu_torch.ops import compact, cuda_build

    lib = cuda_build.load("partition")
    dev = torch.device("cuda")
    rng = np.random.RandomState(7)
    panes = {}
    lines = ["F rows lanes tiles group launches | "
             + " ".join("g=%-6d" % g for g in GROUPS)
             + " | entry  | bound   (ms)"]
    for F, cnt in SIZES:
        R = compact.pane_rows(F)
        if F not in panes:
            W = -(-(max(n for f, n in SIZES if f == F) + 1001) // 2048) * 2048
            src = torch.as_tensor(rng.randint(-128, 128, (R, W))
                                  .astype(np.int8), device=dev)
            panes[F] = (src, torch.empty_like(src))
        src, dst = panes[F]
        start, feat, thr = 1001, 0, 127
        s, d = src[:, start:], dst[:, start:]
        left = torch.empty((), dtype=torch.int32, device=dev)
        tiles, group, count_pass = compact.plan(
            cnt, s.data_ptr() % 16, R, cuda_build.num_sms(dev))
        counts = torch.empty(tiles, dtype=torch.int32, device=dev)
        counts_ptr = counts.data_ptr() if count_pass else None
        stream = torch.cuda.current_stream().cuda_stream
        times = []
        for g in GROUPS:
            def run(g=g):
                rc = lib.lgbm_partition_pane(
                    s.data_ptr(), s.stride(0), d.data_ptr(), d.stride(0), R,
                    cnt, feat, F, 1, thr, tiles, g, counts_ptr,
                    left.data_ptr(), stream)
                cuda_build.check(rc, "partition kernel")
            times.append(cuda_ms(run))
        entry = cuda_ms(lambda: compact.partition_pane(src, dst, F, feat, thr,
                                                       start, cnt))
        bound = 2 * R * cnt / HBM_BYTES_PER_S * 1e3
        lines.append("%-3d %-4d %-7d %-5d %-2d %d | %s | %.4f | %.4f" % (
            F, R, cnt, tiles, group, 1 + count_pass,
            " ".join("%.4f" % t for t in times), entry, bound))
    # a short segment in one launch (every block counts the other tiles'
    # sides) against a count pass first, at the best of three groups
    lines.append("tiles lanes | one launch g=1 2 4 | count pass g=1 2 4 (ms)")
    src, dst = panes[28]
    R = compact.pane_rows(28)
    s, d = src[:, 1001:], dst[:, 1001:]
    for tiles in (2, 3, 4, 5, 6, 8, 12):
        cnt = tiles * compact.TILE - 16
        counts = torch.empty(tiles, dtype=torch.int32, device=dev)
        row = []
        for ptr in (None, counts.data_ptr()):
            for g in (1, 2, 4):
                def run(g=g, ptr=ptr):
                    rc = lib.lgbm_partition_pane(
                        s.data_ptr(), s.stride(0), d.data_ptr(), d.stride(0),
                        R, cnt, 0, 28, 1, 127, tiles, g, ptr, left.data_ptr(),
                        stream)
                    cuda_build.check(rc, "partition kernel")
                row.append(cuda_ms(run))
        lines.append("%-5d %-6d | %s | %s" % (
            tiles, cnt, " ".join("%.4f" % t for t in row[:3]),
            " ".join("%.4f" % t for t in row[3:])))
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
