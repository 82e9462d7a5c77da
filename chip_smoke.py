#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from lightgbm_tpu_torch/csrc/, holds
each against its plain PyTorch version on the card, drives the port's main
path (``lightgbm_tpu_torch.train`` on a 1M x 28 Higgs-shaped binary table,
255 leaves, float32 histograms; save, reload, predict held-out rows), runs
the int8 path on the card and on the CPU and requires identical trees, and
prints one JSON line of kernel measurements.  Every phase must pass; the
last line of standard output is ``{"ok": true, "device": {...}}``.  Exits
nonzero, printing no result, when there is no CUDA device or the package
is not beside this script.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
SEED = 42
# the main path's sizes; a rehearsal on the CPU may pass smaller ones
FULL = {"n_train": 1_000_000, "n_test": 100_000, "n_int8": 200_000,
        "hist_shapes": ((28, 1_000_000, 256, 1), (28, 1_000_000, 256, 42),
                        (28, 1_000_000, 256, 64), (200, 250_000, 256, 1))}


def make_data(rows: int, features: int, seed: int):
    """Higgs-like synthetic table: bench.py's make_data (all-continuous
    default), copied."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, features).astype(np.float32)
    w = rng.randn(features) / np.sqrt(features)
    logits = x @ w + 0.5 * np.sin(x[:, 0] * 2) + 0.3 * x[:, 1] * x[:, 2]
    y = (logits + rng.randn(rows) * 0.5 > 0).astype(np.float32)
    return x.astype(np.float64), y


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    say("FAIL: " + msg)
    sys.exit(1)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import lightgbm_tpu_torch  # noqa: F401
    except ImportError as e:
        print("chip_smoke: lightgbm_tpu_torch not found beside this script "
              "(%s)" % e, file=sys.stderr)
        return 2
    from lightgbm_tpu_torch.ops import cuda_build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("python %s torch %s cuda %s device %s" % (
        sys.version.split()[0], torch.__version__, torch.version.cuda,
        torch.cuda.get_device_name(0)))

    # ---- phase 1: build
    t0 = time.perf_counter()
    cuda_build.build()
    say("phase 1 build: %.1f s" % (time.perf_counter() - t0))
    for name, text in sorted(cuda_build.build_log.items()):
        for line in text.splitlines():
            if "registers" in line or "bytes stack" in line:
                say("  ptxas %s: %s" % (name, line.strip()))
    kernels = run(torch.device("cuda"), FULL)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    say(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else "nvidia-smi: " + smi.stderr.strip())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(dev, sizes, timer=None):
    """Phases 2-6 on ``dev``; returns the kernel records.  ``timer``
    replaces the CUDA-event timer (a CPU rehearsal passes a host clock)."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.metrics import AUCMetric
    from lightgbm_tpu_torch.ops import compact, hist_cuda
    from lightgbm_tpu_torch.ops.hist_cuda import quantize_values
    timer = timer or cuda_ms
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    # ---- phase 2: histogram kernel vs its plain version
    gen = np.random.RandomState(SEED)

    def hist_inputs(F, N, B, C):
        bins = torch.as_tensor(gen.randint(0, B, (F, N)).astype(np.uint8),
                               device=dev)
        grad = torch.as_tensor(gen.randn(N).astype(np.float32), device=dev)
        hess = torch.as_tensor(gen.rand(N).astype(np.float32), device=dev)
        cid = torch.as_tensor(np.where(gen.rand(N) < 0.9,
                                       gen.randint(0, C, N), -1)
                              .astype(np.int32), device=dev)
        return bins, grad, hess, cid

    hist_err = {}
    for F, N, B, C in sizes["hist_shapes"]:
        bins, grad, hess, cid = hist_inputs(F, N, B, C)
        got = hist_cuda.hist_float(bins, grad, hess, cid, C, B)
        want = hist_cuda.hist_plain(
            bins, torch.stack([grad, hess, torch.ones_like(grad)], 1), cid,
            C, B)
        mag = hist_cuda.hist_plain(
            bins, torch.stack([grad.abs(), hess.abs(),
                               torch.ones_like(grad)], 1), cid, C, B)
        err = (got - want).abs()
        # f32 atomics add in a run-dependent order: each cell may differ
        # from the plain sum by the rounding of its terms, bounded here by
        # 1e-5 of the cell's absolute sum; counts are sums of 1.0, exact
        tol = 1e-5 * mag + 1e-6
        counts_exact = torch.equal(got[..., 2::3], want[..., 2::3])
        if not (bool((err <= tol).all()) and counts_exact):
            fail("hist float F=%d N=%d C=%d: max err %g" % (
                F, N, C, float(err.max())))
        ok = cid >= 0
        levels, _ = quantize_values(grad, hess, ok)
        got_i = hist_cuda.hist_int8(bins, levels, cid, C, B)
        want_i = hist_cuda.hist_plain(bins, levels.t().to(torch.int32), cid,
                                      C, B)
        if not torch.equal(got_i, want_i):
            fail("hist int8 F=%d N=%d C=%d not bitwise" % (F, N, C))
        hist_err[(F, N, B, C)] = float(err.max())
        say("phase 2 hist F=%d N=%d B=%d C=%d: float max abs err %.3g "
            "(tol 1e-5 x cell |sum|), counts exact, int8 bitwise"
            % (F, N, B, C, hist_err[(F, N, B, C)]))

    # ---- phase 3: partition kernel vs its plain version
    n_train, n_test, F = sizes["n_train"], sizes["n_test"], 28
    R = compact.pane_rows(F)
    W = compact.bucket_table(n_train)[0]
    seg_full = torch.as_tensor(gen.randint(-128, 128, (R, W))
                               .astype(np.int8), device=dev)
    part_err = 0
    for name, delta, cnt, kind in (
            ("full", 0, n_train, "random"),
            ("offset", 1000, n_train // 2, "random"),
            ("offset-edge", 1023, 4097, "random"),
            ("empty", 777, 0, "random"),
            ("all-left", 5000, n_train // 3, "left"),
            ("all-right", 2048, n_train // 3, "right")):
        lane = np.arange(W)
        m = {"random": gen.randint(0, 2, W), "left": np.ones(W),
             "right": np.zeros(W)}[kind]
        mask3 = np.where((lane >= delta) & (lane < delta + cnt), m, -1)
        mask3 = torch.as_tensor(mask3.astype(np.int8), device=dev)
        plcnt = int((mask3 == 1).sum())
        got = compact.partition_segment(seg_full, mask3, delta, cnt, plcnt)
        want = compact.partition_plain(seg_full, mask3, delta, cnt)
        part_err = max(part_err, int((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            fail("partition %s not byte-exact" % name)
        say("phase 3 partition %s R=%d W=%d delta=%d cnt=%d: byte-exact"
            % (name, R, W, delta, cnt))

    # ---- phase 4: full-width training through the user entry points
    x, y = make_data(n_train + n_test, F, SEED)
    t0 = time.perf_counter()
    train_set = lgt.Dataset.from_arrays(x[:n_train], y[:n_train],
                                        max_bin=255)
    say("phase 4 dataset: %d x %d binned in %.1f s (max num_bin %d)" % (
        n_train, F, time.perf_counter() - t0, int(train_set.num_bins.max())))
    params = {"objective": "binary", "num_leaves": 255,
              "num_iterations": 5, "learning_rate": 0.1,
              "hist_dtype": "float32", "max_bin": 255}
    iter_s = []
    clock = [0.0]

    def progress(it):
        sync()
        now = time.perf_counter()
        iter_s.append(now - clock[0])
        clock[0] = now

    hist_cuda.launches = 0
    compact.launches = 0
    sync()
    clock[0] = time.perf_counter()
    booster = lgt.train(params, train_set, device=dev, progress_fn=progress)
    sync()
    launches = {"hist": hist_cuda.launches, "partition": compact.launches}
    trees = len(booster.models)
    if trees != 5:
        fail("trained %d trees, expected 5" % trees)
    leaves = [t.num_leaves for t in booster.models]
    say("phase 4 train: %d trees, leaves %s, seconds per iteration %s" % (
        trees, leaves, ["%.3f" % s for s in iter_s]))
    say("phase 4 launches per tree: hist %.1f, partition %.1f" % (
        launches["hist"] / trees, launches["partition"] / trees))
    if launches["hist"] == 0 or launches["partition"] == 0:
        fail("a kernel was not launched on the main path: %s" % launches)
    label = y[:n_train]
    losses = []
    for k in range(1, trees + 1):
        p = np.clip(booster.predict(x[:n_train], k), 1e-15, 1 - 1e-15)
        losses.append(float(-np.mean(label * np.log(p)
                                     + (1 - label) * np.log(1 - p))))
    say("phase 4 train logloss per iteration: %s" % (
        " ".join("%.6f" % v for v in losses)))
    if not all(b < a for a, b in zip(losses, losses[1:])):
        fail("train logloss does not fall")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.txt")
        booster.save_model_to_file(True, path)
        loaded = lgt.GBDT.from_model_file(path, device=dev)
    pred = loaded.predict(x[n_train:])
    if not (pred.shape == (n_test,) and np.isfinite(pred).all()):
        fail("held-out predictions are not finite [N]")
    if not np.allclose(pred, booster.predict(x[n_train:]), rtol=0,
                       atol=1e-12):
        fail("reloaded model predicts differently")

    class _Md:
        label = y[n_train:]
        weights = None

    auc = AUCMetric(None)
    auc.init("test", _Md, n_test)
    held_auc = auc.eval(pred)[0]
    say("phase 4 saved + reloaded model, held-out AUC %.6f on %d rows"
        % (held_auc, n_test))
    if not held_auc > 0.7:
        fail("held-out AUC %.4f too low" % held_auc)

    # ---- phase 5: int8 end to end, kernels on the card vs plain on the CPU
    n5 = sizes["n_int8"]
    small = lgt.Dataset.from_arrays(x[:n5], y[:n5], max_bin=255)
    p5 = {"objective": "binary", "num_leaves": 63, "num_iterations": 2,
          "hist_dtype": "int8", "max_bin": 255}
    on_card = lgt.train(p5, small, device=dev)
    on_cpu = lgt.train(p5, small, device="cpu")
    if len(on_card.models) != len(on_cpu.models):
        fail("int8: tree counts differ")
    value_diff = 0.0
    for k, (a, b) in enumerate(zip(on_card.models, on_cpu.models)):
        for field in ("split_feature", "threshold_bin", "left_child",
                      "right_child", "leaf_count"):
            if not np.array_equal(getattr(a, field), getattr(b, field)):
                fail("int8 tree %d: %s differs between cuda and cpu"
                     % (k, field))
        value_diff = max(value_diff,
                         float(np.abs(a.leaf_value - b.leaf_value).max()))
    if value_diff > 1e-6:
        fail("int8 leaf values differ by %g" % value_diff)
    say("phase 5 int8 %d x %d, 63 leaves, 2 trees: cuda == cpu in structure "
        "and leaf_count; leaf values max abs diff %g"
        % (n5, F, value_diff))

    # ---- phase 6: kernel times at the main-path shape
    N, B = n_train, 256
    kernels = {}
    bins, grad, hess, _ = hist_inputs(F, N, B, 1)
    cid = torch.zeros(N, dtype=torch.int32, device=dev)
    vals3 = torch.stack([grad, hess, torch.ones_like(grad)], 1)
    idx = (torch.arange(F, device=dev)[:, None] * B + bins.long()).reshape(-1)
    idx3 = idx[:, None].expand(-1, 3)
    src3 = vals3[None].expand(F, N, 3).reshape(-1, 3)
    acc = torch.zeros((F * B, 3), dtype=torch.float32, device=dev)
    kernels["hist"] = {
        "name": "hist", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/hist.cu",
        "replaces": "lightgbm_tpu/ops/hist_pallas.py:86",
        "launches": launches["hist"],
        "max_abs_err": hist_err[sizes["hist_shapes"][0]],
        "ms": timer(lambda: hist_cuda.hist_float(bins, grad, hess, cid,
                                                 1, B)),
        "plain_ms": timer(lambda: hist_cuda.hist_plain(bins, vals3, cid,
                                                       1, B)),
        "bound_ms": (N * F + 12 * N + F * B * 3 * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": timer(lambda: acc.scatter_add_(0, idx3, src3)),
    }
    W = compact.bucket_table(N)[0]
    seg = seg_full[:, :W]
    mask3 = torch.as_tensor(gen.randint(0, 2, W).astype(np.int8),
                            device=dev)
    mask3[N:] = -1
    plcnt = int((mask3 == 1).sum())
    keys = torch.where(mask3 == 1, 0, torch.where(mask3 == 0, 1, 2))
    kernels["partition"] = {
        "name": "partition", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/partition.cu",
        "replaces": "lightgbm_tpu/ops/compact.py:393",
        "launches": launches["partition"],
        "max_abs_err": part_err,
        "ms": timer(lambda: compact.partition_segment(seg, mask3, 0, N,
                                                      plcnt)),
        "plain_ms": timer(lambda: compact.partition_plain(seg, mask3, 0,
                                                          N)),
        "bound_ms": (2 * R * W + W) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": timer(lambda: seg[:, torch.sort(
            keys, stable=True).indices]),
    }
    for k in kernels.values():
        say("phase 6 %s: %.4f ms (plain %.4f, library %.4f, bound %.4f)"
            % (k["name"], k["ms"], k["plain_ms"], k["library_ms"],
               k["bound_ms"]))
    return list(kernels.values())


if __name__ == "__main__":
    sys.exit(main())
