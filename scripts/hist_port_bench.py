#!/usr/bin/env python3
"""What each step of the histogram kernel's launch plan buys, on one CUDA
card: device time per launch of lightgbm_tpu_torch/csrc/hist.cu at the
main path's shapes, under the wrapper's plan (``ops/hist_cuda.plan``) and
under variants of it that undo one step each.

    python3 scripts/hist_port_bench.py [--out FILE]

Shapes: the root pass (F=28, N=1M, B=256, C=1) through each entry (float,
int8, pane; the pane with every row valid, as on the main path, and with
16% of its rows dropped, as a row sample would), the pane entry on
children of 150,000, 50,000 and 4,000 rows (most of the main path's
children have a few thousand to a few tens of thousands of rows) and on
one row (the fixed cost of a launch), and the wide shapes (C=42, C=64,
F=200).  A variant is this script's copy of the plan with one argument
changed, launched through the library's entries directly; the copy's
default must equal the wrapper's plan at every shape, or the script
stops.  Prints one line per (variant, shape), then the card's name and
power limit and the SASS opcodes of the kernels' shared-memory atomics
where ``cuobjdump`` is installed.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12

# variant name -> arguments of bench_plan that undo one step of the design
VARIANTS = {
    "final plan": {},
    "one accumulator copy": {"copies_cells": 0},
    "always 16 rows per thread": {"vec": 16},
    "always 4 rows per thread": {"vec": 4},
    "256 threads at wide C": {"threads": 256},
    "4 blocks per SM": {"blocks_per_sm": 4},
    "8-tile chunk floor": {"min_chunk_tiles": 8},
    "8 features per block": {"group_cells": 8 * 256},
    "no resident-block floor": {"min_resident": 1},
}


def bench_plan(n, F, B, C, mode, shift, sms, hc, group_cells=None,
               copies_cells=None, blocks_per_sm=None, min_chunk_tiles=None,
               vec=None, threads=None, min_resident=None):
    """``hist_cuda.plan`` (module ``hc``) written out, with each of its
    choices open to an override."""
    group_cells = group_cells or hc.GROUP_CELLS
    copies_cells = hc.COPIES_CELLS if copies_cells is None else copies_cells
    blocks_per_sm = blocks_per_sm or hc.BLOCKS_PER_SM
    min_chunk_tiles = min_chunk_tiles or hc.MIN_CHUNK_TILES
    min_resident = min_resident or hc.MIN_RESIDENT
    cell, side_words = hc.CELL_BYTES[mode], hc.SIDE_WORDS[mode]
    slices = -(-B * C * cell // hc.SLICE_BYTES)
    slice_cells = -(-B * C // slices)
    g = max(1, min(8, F, group_cells // slice_cells))
    groups = -(-F // g)
    g = -(-F // groups)
    copies = 2 if 2 * g * slice_cells <= copies_cells else 1
    acc = -(-copies * g * slice_cells * cell // 16) * 16
    threads = threads or (512 if 2 * (acc + 1024) > hc.SM_SMEM else 256)
    rows = max(n + shift, 1)
    room = hc.SM_SMEM // min_resident - 1024 - acc

    def tile_of(v):
        row_bytes = side_words * 4 * (v + 1) / v
        cap = int(room // row_bytes) if room >= 16 * row_bytes else 1 << 30
        return min(threads * v // g, int((hc.MAX_SMEM - acc) // row_bytes),
                   cap) // 16 * 16

    vec = vec or (16 if F * rows >= 16 * hc.SM_THREADS * sms
                  and tile_of(16) * g >= 12 * threads else 4)
    tile = tile_of(vec)
    smem = acc + side_words * 4 * (tile + tile // vec)
    per_sm = min(hc.SM_THREADS // threads, hc.SM_SMEM // (smem + 1024),
                 blocks_per_sm)
    chunks = -(-per_sm * sms // (groups * slices))
    chunk = max(min_chunk_tiles * tile, -(-rows // chunks))
    chunk = -(-chunk // tile) * tile
    chunks = -(-rows // chunk)
    return (vec, threads, g, copies, tile, chunk, groups, chunks, smem,
            slices, slice_cells)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("hist_port_bench: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import cuda_ms
    from lightgbm_tpu_torch.ops import compact, cuda_build
    from lightgbm_tpu_torch.ops import hist_cuda as hc

    cuda_build.build()
    lib = cuda_build.load("hist")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.RandomState(0)
    F, N, B = 28, 1_000_000, 256
    P = compact.bucket_table(N)[0]

    def arrays(F, N, C):
        return (torch.as_tensor(rng.randint(0, B, (F, N)).astype(np.uint8),
                                device=dev),
                torch.as_tensor(rng.randn(N).astype(np.float32), device=dev),
                torch.as_tensor(rng.rand(N).astype(np.float32), device=dev),
                torch.as_tensor(rng.randint(0, C, N).astype(np.int32),
                                device=dev))

    bins, grad, hess, cid1 = arrays(F, N, 1)
    cid1.zero_()
    levels, _ = hc.quantize_values(grad, hess, cid1 >= 0)
    pane = compact.pack_planes(bins, grad, hess, cid1 == 0, P)
    pane84 = compact.pack_planes(bins, grad, hess, grad > -1.0, P)
    wide = {C: arrays(F, N, C) for C in (42, 64)}
    f200 = arrays(200, 250_000, 1)
    # 16-bit bins (max_bin=1023: 1022 bins), as int16 views
    B16 = 1022
    bins16 = torch.as_tensor(rng.randint(0, B16, (F, N)).astype(np.int16),
                             device=dev)

    # (entry, bins, pointer arguments, bin layout argument, C, mode, out
    # dtype); the uint8 layout throughout.  The float modes share one
    # exponent, the root's, as a tree's launches do
    exponent = hc.fixed_exponent(grad, hess, N)

    def float_call(b, g, h, c, C):
        return (lib.lgbm_hist_f32, b, (g.data_ptr(), h.data_ptr(),
                                       c.data_ptr()), (1,), C, "float",
                torch.float32)

    def pane_call(p, sstart, n):
        seg = p[:, sstart:sstart + n]
        return (lib.lgbm_hist_pane, seg[:F].view(torch.uint8),
                (0, seg[F].data_ptr()), (), 1, "float", torch.float32)

    def bound(n, f, c, row_bytes):
        return (n * (f + row_bytes) + f * B * 3 * c * 4) / HBM_BYTES_PER_S \
            * 1e3

    def float16_call(C):
        return (lib.lgbm_hist_f32, bins16, (grad.data_ptr(), hess.data_ptr(),
                                            cid1.data_ptr()), (2,), C,
                "float", torch.float32, B16)

    shapes = [
        ("root float F=28 N=1M C=1", bound(N, F, 1, 12),
         float_call(bins, grad, hess, cid1, 1)),
        ("root int8 F=28 N=1M C=1", bound(N, F, 1, 7),
         (lib.lgbm_hist_i8, bins, (levels.data_ptr(), levels.stride(0),
                                   cid1.data_ptr()), (1,), 1, "int8",
          torch.int32)),
        ("root pane F=28 N=1M", bound(N, F, 1, 9), pane_call(pane, 1001, N)),
        ("root pane 84% valid", bound(N, F, 1, 9),
         pane_call(pane84, 1001, N)),
    ] + [("child pane N=%d" % n, bound(n, F, 1, 9), pane_call(pane, 1001, n))
         for n in (150_000, 50_000, 4000, 1)] + [
        ("float F=28 N=1M C=42", bound(N, F, 42, 12),
         float_call(*wide[42], 42)),
        ("float F=28 N=1M C=64", bound(N, F, 64, 12),
         float_call(*wide[64], 64)),
        ("float F=200 N=250K C=1", bound(250_000, 200, 1, 12),
         float_call(*f200, 1)),
        ("float16 F=28 N=1M B=1022 C=1",
         (N * (2 * F + 12) + F * B16 * 3 * 4) / HBM_BYTES_PER_S * 1e3,
         float16_call(1)),
    ]

    def launcher(entry, b, ptrs, layout, C, mode, dtype, nb=B, over=None):
        nf, n = b.shape
        shift = b.data_ptr() % 16 // b.element_size()
        pl = bench_plan(n, nf, nb, C, mode, shift, sms, hc, **over)
        if not over and pl != hc.plan(n, nf, nb, C, mode, shift, sms):
            raise SystemExit("bench_plan differs from hist_cuda.plan at "
                             "F=%d n=%d C=%d: update this script" % (nf, n, C))
        out = torch.empty((nf, nb, 3 * C), dtype=dtype, device=dev)
        scratch = torch.empty(nf * nb * C * 5, dtype=torch.int32, device=dev)
        fixed = (exponent.data_ptr(), scratch.data_ptr()) \
            if mode == "float" else ()

        def call():
            cuda_build.check(entry(b.data_ptr(), b.stride(0), *ptrs, n, nf,
                                   nb, C, shift, *layout, *pl, *fixed,
                                   out.data_ptr(), stream), "hist kernel")
        return call

    lines = []
    for name, over in VARIANTS.items():
        for label, bnd, call in shapes:
            lines.append("%-26s %-26s %8.4f ms  (bound %.4f)" % (
                name, label, cuda_ms(launcher(*call, over=over)), bnd))
            print(lines[-1], flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines.append(smi.stdout.strip())
    lines.append(sass_atomics(cuda_build.library_path("hist")))
    print("\n".join(lines[-2:]))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


def sass_atomics(lib_path):
    """Distinct shared-memory atomic opcodes in the built kernels."""
    exe = "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return "cuobjdump not found"
    text = subprocess.run([exe, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120).stdout
    ops = sorted(set(re.findall(r"\b(ATOMS[.\w]*)", text)))
    return "shared atomics in SASS: %s" % (", ".join(ops) or "none")


if __name__ == "__main__":
    sys.exit(main())
