#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from lightgbm_tpu_torch/csrc/, holds
each against its plain PyTorch version on the card, drives the port's main
path (``lightgbm_tpu_torch.train`` on a 1M x 28 Higgs-shaped binary table,
255 leaves, float32 histograms; save, reload, predict held-out rows), runs
the int8 path on the card and on the CPU and requires identical trees, and
prints one JSON line of kernel measurements: each kernel at the main-path
shape and replayed at the first tree's launch sizes through its pane entry
(``tree_ms``), and the histogram kernel at the wide shapes of phase 2.
Phase 3 holds both partition entries against their plain versions, lanes
outside the segment included; phase 4 checks that every split went
through the pane entry in one kernel launch, or two where the segment
spans more than a few tiles.  Phase 5 then drives the other growth
policies through the same entry point, each with every count set to 0
just before it: depth-wise (bench.py's headline configuration, int8 and
float32; one histogram launch at the root and one per level pass, at most
64 columns each), and masked leaf-wise (one launch per leaf over all
rows); neither may launch the partition kernel.  Depth-wise int8 must grow
the same trees on the card as on the CPU, and masked int8 the same trees
as compacted int8.  Phase 6 adds the int8 mode at the depth-wise widths
(``int8_shapes``) and the first depth-wise tree's launches replayed
(``depthwise_tree_ms``).  Phase 7 trains the other objectives at
the main path's settings on its features: regression on the table's
continuous latent (held-out RMSE must fall every iteration), multiclass
with K = 5 (held-out multi_logloss must fall; 5 trees an iteration,
interleaved per class; softmax rows sum to 1; the saved model reloads
and predicts identically) and lambdarank over queries of 50-190
documents (held-out NDCG@5 must rise), each with one histogram launch per
leaf and one partition per split; then int8 regression and multiclass
trees on the card against the CPU (equal) and lambdarank gradients on
both (rtol 1e-5 / atol 1e-7).  Phase 8 runs the sampling slice at the
main path's width: the reference binary example's hot path (63 leaves,
feature_fraction 0.8, bagging 0.8 every 5 iterations, the threefry draw
on the card; exactly 800,000 in-bag rows a draw, a new bag each redraw,
every tree over the in-bag rows, 63 histogram launches and 62
partitions a tree, held-out AUC > 0.7) beside the same configuration
unsampled, the mask draw timed on the host (numpy) and on the card;
GOSS (trees over exactly top + other rows); early stopping on a
validation set (3 trees popped, the saved file holding the kept trees
and reloading to the same predictions); continued training through the
CLI (3 + 3 iterations, the input trees first and byte-equal, the score
starting from the input model's float64 sum); multiclass K = 5 with one
draw per class tree; and int8 sampled trees (threefry bagging, GOSS,
feature_fraction) on the card equal to the CPU's for the compacted and
depth-wise growers.  Phase 9 runs the modes of the histogram kernel
that the mixed-bin slice added, on bench.py's headline table (24 of 28
columns narrow): the per-class launches (B = 64 and 254) and the pane
entry over a class's rows against their plain versions, timed; the
headline configuration (depth-wise int8, 255 leaves, ``mixed_bin=auto``,
two launches a pass) with the same model text as ``mixed_bin=false``,
both timed in turns; int8 with stochastic rounding on the card equal to
the CPU's; and bfloat16 histograms at full width.  Phase 10 runs 16-bit
bins (``max_bin=1023``, 1022 bins a continuous column): the histogram
kernel's float and int8 modes at C = 1, 8 and 64 (cell slices where an
accumulator passes shared memory), the pane entry over a 16-bit pane and
the partition on a 16-bit key, and a B = 50,000 corner
(``max_bin=65535``), each against its plain version and timed; the main
path at ``max_bin=1023`` (one histogram launch a leaf, one partition a
split, held-out AUC, save and reload); int8 compacted and depth-wise
trees on the card equal to the CPU's and compacted equal to masked; and
the headline configuration packed (widths 64 and 1022) with the model
text of ``mixed_bin=false``.  Phase 11 serves three models through
``lightgbm_tpu_torch.serving`` on the card (phase 4's, a depth-wise int8
model of 200 trees trained there, and phase 7's multiclass one): scores
and leaf indices at every bucket of the default ladder, float32 and
int8, bitwise the CPU engine's; latency per bucket and the walk's device
time beside its bound; a coalescing front with 8 clients and a hot swap,
no request lost or misrouted; and ``task=predict`` result files on the
card byte-equal to ``device=cpu``'s; it launches neither kernel (see
``serving_phase``).  Phase 12 runs the ingest layer on a 2M-row CSV
file of make_data's table over 256 MB (a header, the label mid-file, a
weight and an ignored column): resident, ``streaming=auto``, four parse
workers, two-round, the native cache direct and as a sibling, a
reference-format cache; every route's bin matrix, read back from the
card, equal to the resident one; the streamed cache byte-equal to the
resident cache; the native parser tier only; one histogram launch a
leaf and one partition a split from four routes, one float32 model text
(from the resident route trained twice too) and one int8 model text;
``task=predict`` on the cache equal to the text's (see
``ingest_phase``).  The float histogram sums in 64-bit fixed point, so
every float launch of phases 2, 6, 9 and 10 runs twice and must give
the same bits.  Phase 13 checkpoints and resumes the main path
(float32) and the sampled path (int8, threefry bagging) on phase 4's
table: stopped by a raise at iteration 6 and resumed to the unbroken
model text, launching the kernels for the remaining trees only, and a
CLI run SIGKILLed at iteration 6 and rerun to the unbroken model file
(see ``checkpoint_phase``).  Phase 14 arms the observability layer
around the main path (the JSONL sink fenced, memory gauges, health, the
profiler, the flight recorder, the stall watchdog with a stall injected)
and requires the unarmed model text, route counters equal to the kernel
counts, fenced phases within each iteration's wall, a memory block and a
roofline that read the H100, both kernels' events in the profiler trace,
one flight dump, clean health blocks, and a ServingFront's monitor
windows and drift against the model's ``score_reference=`` line, checked
by ``scripts/trace_report.py`` and ``scripts/monitor_report.py`` (see
``observability_phase``).  Phase 9 also times int8 with stochastic
rounding (the hash and quantization, then the launch) beside its plain
version and ``scatter_add_`` of the same levels.  Every phase must
pass; the last line of standard output is ``{"ok": true, "device":
{...}}``.  Exits nonzero,
printing no result, when there is no CUDA device or the package is not
beside this script.
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
# the float histogram's root and first-tree times when it added f32 values
# with atomics, before its fixed-point sums (PERF.md section 6: NVIDIA
# H100 80GB HBM3, 700 W); phase 6 prints the fixed-point times beside them
F32_ATOMICS_MS = {"root": 0.1414, "tree": 3.3380}
SEED = 42
# the main path's sizes; a rehearsal on the CPU may pass smaller ones.
# hist_shapes: (F, N, B, C, offset); offset > 0 slices the bins out of
# wider rows at that lane, as the grower slices the pane
FULL = {"n_train": 1_000_000, "n_test": 100_000, "n_int8": 200_000,
        "serve_iters": 200, "serve_cpu_rows": 10_000, "front_s": 5.0,
        "hist_shapes": ((28, 1_000_000, 256, 1, 0), (28, 1_000_000, 256, 42, 0),
                        (28, 1_000_000, 256, 64, 0), (200, 250_000, 256, 1, 0),
                        (28, 2047, 256, 1, 0), (28, 300_001, 256, 1, 13)),
        "pane_segment": (12_345, 300_001), "n_f200": 250_000,
        "int8_cols": (1, 8, 32, 64), "n_es": 40_000, "n_cli": 100_000,
        "class_cols": (1, 8, 64), "wide_cols": (1, 8, 64),
        "n_ingest": 2_000_000, "ingest_parse_rows": 200_000,
        "obs_front_s": 2.0, "stall_timeout": 1.5, "stall_s": 3.5,
        "monitor_interval_s": 0.5}


def make_table(rows: int, features: int, seed: int):
    """Higgs-like synthetic table: bench.py's make_data (all-continuous
    default), copied, with its continuous latent (logits + noise), whose
    sign is the binary label."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, features).astype(np.float32)
    w = rng.randn(features) / np.sqrt(features)
    logits = x @ w + 0.5 * np.sin(x[:, 0] * 2) + 0.3 * x[:, 1] * x[:, 2]
    return x.astype(np.float64), logits + rng.randn(rows) * 0.5


def make_data(rows: int, features: int, seed: int):
    """make_table's features and binary labels."""
    x, latent = make_table(rows, features, seed)
    return x, (latent > 0).astype(np.float32)


def make_mixed(rows: int, features: int, seed: int, narrow_features: int):
    """bench.py's make_data with ``narrow_features`` > 0 (bench.py:78-121,
    the headline table), copied: that many columns quantized to 2-61
    values, the rest continuous."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, features).astype(np.float32)
    narrow_idx = np.linspace(0, features - 1, narrow_features).astype(int)
    for j, f in enumerate(narrow_idx):
        card = (2, 3, 5, 9, 17, 33, 61)[j % 7]
        q = np.clip(((x[:, f] + 3.0) * (card / 6.0)).astype(np.int32),
                    0, card - 1)
        x[:, f] = q.astype(np.float32)
    w = rng.randn(features) / np.sqrt(features)
    xs = (x - x.mean(axis=0)) / (x.std(axis=0) + 1e-9)
    logits = (xs @ w + 0.5 * np.sin(xs[:, 0] * 2)
              + 0.3 * xs[:, 1] * xs[:, 2])
    y = (logits + rng.randn(rows) * 0.5 > 0).astype(np.float32)
    return x.astype(np.float64), y


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    say("FAIL: " + msg)
    sys.exit(1)


def cuda_ms(fn, reps: int = 20, sleep: int = 200_000) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up.
    The stream first sleeps ``sleep`` cycles a call (200,000: about 0.1
    ms) while the host enqueues the calls, so a call shorter than its own
    enqueue is timed by its device work alone."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reset_counts() -> None:
    """Every kernel count to 0."""
    from lightgbm_tpu_torch.ops import compact, hist_cuda
    hist_cuda.launches = 0
    hist_cuda.launch_rows.clear()
    hist_cuda.launch_cols.clear()
    compact.launches = 0
    compact.kernel_launches = 0
    compact.launch_rows.clear()


def drive(params, train_set, dev, sync):
    """Train through ``lightgbm_tpu_torch.train`` with every kernel count
    set to 0 just before and read just after.  Returns the booster, the
    seconds of each iteration and the counts: launches of each kernel,
    each histogram launch's rows and columns, each partition's lanes, and
    the histogram launch count at the end of each iteration."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import compact, hist_cuda
    iter_s, ends = [], []
    clock = [0.0]

    def progress(it):
        sync()
        now = time.perf_counter()
        iter_s.append(now - clock[0])
        clock[0] = now
        ends.append(hist_cuda.launches)

    reset_counts()
    sync()
    clock[0] = time.perf_counter()
    booster = lgt.train(params, train_set, device=dev, progress_fn=progress)
    sync()
    counts = {"hist": hist_cuda.launches, "partition": compact.launches,
              "partition_kernels": compact.kernel_launches,
              "hist_rows": list(hist_cuda.launch_rows),
              "hist_cols": list(hist_cuda.launch_cols),
              "part_rows": list(compact.launch_rows), "ends": ends}
    return booster, iter_s, counts


def check_model(what, booster, x, y, n_train, dev):
    """Train logloss must fall with every tree, the saved and reloaded
    model must predict the held-out rows as the booster does, and their
    AUC must exceed 0.7.  Returns (losses, held-out AUC)."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.metrics import AUCMetric
    label = y[:n_train]
    losses = []
    for k in range(1, len(booster.models) + 1):
        p = np.clip(booster.predict(x[:n_train], k), 1e-15, 1 - 1e-15)
        losses.append(float(-np.mean(label * np.log(p)
                                     + (1 - label) * np.log(1 - p))))
    say("%s train logloss per iteration: %s" % (
        what, " ".join("%.6f" % v for v in losses)))
    if not all(b < a for a, b in zip(losses, losses[1:])):
        fail("%s: train logloss does not fall" % what)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.txt")
        booster.save_model_to_file(True, path)
        loaded = lgt.GBDT.from_model_file(path, device=dev)
    n_test = len(y) - n_train
    pred = loaded.predict(x[n_train:])
    if not (pred.shape == (n_test,) and np.isfinite(pred).all()):
        fail("%s: held-out predictions are not finite [N]" % what)
    if not np.allclose(pred, booster.predict(x[n_train:]), rtol=0,
                       atol=1e-12):
        fail("%s: reloaded model predicts differently" % what)

    class _Md:
        label = y[n_train:]
        weights = None

    auc = AUCMetric(None)
    auc.init("test", _Md, n_test)
    held_auc = auc.eval(pred)[0]
    say("%s saved + reloaded model, held-out AUC %.6f on %d rows"
        % (what, held_auc, n_test))
    if not held_auc > 0.7:
        fail("%s: held-out AUC %.4f too low" % (what, held_auc))
    return losses, held_auc


def same_trees(what, a, b, fields=("split_feature", "threshold_bin",
                                   "left_child", "right_child",
                                   "leaf_count")):
    """Fail unless two boosters' trees agree in ``fields``; returns the
    largest leaf value difference."""
    if len(a.models) != len(b.models):
        fail("%s: tree counts differ" % what)
    diff = 0.0
    for k, (ta, tb) in enumerate(zip(a.models, b.models)):
        for field in fields:
            if not np.array_equal(getattr(ta, field), getattr(tb, field)):
                fail("%s tree %d: %s differs" % (what, k, field))
        diff = max(diff, float(np.abs(ta.leaf_value - tb.leaf_value).max()))
    return diff


def float64_err(what, got, bins, grad, hess, cid, C, B):
    """A float histogram against the plain version summed in float64
    (phases 9 and 10): a cell may hold half a million rows, and the f32
    plain version's own atomic sums then stray further than the kernel's
    block-wise ones.  Each cell is held within 1e-5 of its absolute sum;
    counts exact.  Returns the largest error."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda
    ones = torch.ones_like(grad, dtype=torch.float64)
    want = hist_cuda.hist_plain(bins, torch.stack(
        [grad.double(), hess.double(), ones], 1), cid, C, B)
    mag = hist_cuda.hist_plain(bins, torch.stack(
        [grad.double().abs(), hess.double().abs(), ones], 1), cid, C, B)
    err = (got.double() - want).abs()
    if not (bool((err <= 1e-5 * mag + 1e-6).all())
            and torch.equal(got[..., 2::3].double(), want[..., 2::3])):
        fail("hist float %s: max err %g" % (what, float(err.max())))
    return float(err.max())


def twice(what, fn):
    """The float histogram's result, launched twice: its fixed-point sums
    do not depend on the order of the atomics, so the two launches must
    be bitwise equal."""
    import torch
    got = fn()
    if not torch.equal(got, fn()):
        fail("hist float %s: two launches on the same inputs differ" % what)
    return got


def pane_library_ms(timer, seg, F, B, rows=None, bin_bytes=1):
    """The library call beside a pane-entry launch: ``scatter_add_`` of
    the segment's valid rows' (grad, hess, 1) on an index prebuilt from
    its bin rows (``rows`` = (first, count) of the F), the same function
    as ``hist_cuda.pane_plain``."""
    import torch
    from lightgbm_tpu_torch.ops import compact
    from lightgbm_tpu_torch.ops.bins import widen
    first, Fr = rows if rows is not None else (0, F)
    pb, pg, ph, valid = compact.unpack_values(seg, F, bin_bytes)
    pb = pb[first:first + Fr]
    n = pb.shape[1]
    idx = torch.arange(Fr, device=seg.device)[:, None] * B \
        + widen(pb).long()
    idx = torch.where(valid[None, :], idx, Fr * B).reshape(-1, 1) \
        .expand(-1, 3)
    src = torch.stack([pg, ph, torch.ones_like(pg)], 1)[None] \
        .expand(Fr, n, 3).reshape(-1, 3)
    acc = torch.zeros((Fr * B + 1, 3), dtype=torch.float32,
                      device=seg.device)
    return timer(lambda: acc.scatter_add_(0, idx, src))


def level_passes(tree, num_leaves: int) -> int:
    """The level passes the depth-wise grower runs for ``tree``: one
    after each level that chose a slot, unless it was the last level or
    spent the leaf budget (models/grower_depthwise.py)."""
    from lightgbm_tpu_torch.models.grower_depthwise import num_levels
    n = tree.num_leaves - 1
    depth = np.zeros(max(n, 1), np.int64)
    for k in range(n):
        for child in (tree.left_child[k], tree.right_child[k]):
            if child >= 0:
                depth[child] = depth[k] + 1
    per_level = np.bincount(depth[:n], minlength=64)
    passes, nodes = 0, 0
    for d in range(num_levels(num_leaves)):
        nodes += per_level[d]
        if per_level[d] == 0 or d + 1 >= num_levels(num_leaves) \
                or nodes >= num_leaves - 1:
            break
        passes += 1
    return passes


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
    say("chip_smoke: phases 1-14 in %.1f s" % (time.perf_counter() - t0))
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
    """Phases 2-14 on ``dev``; returns the kernel records.  ``timer``
    replaces the CUDA-event timer (a CPU rehearsal passes a host clock)."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import compact, hist_cuda
    from lightgbm_tpu_torch.ops.hist_cuda import quantize_values
    timer = timer or cuda_ms
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    # ---- phase 2: histogram kernel vs its plain version
    gen = np.random.RandomState(SEED)

    def hist_inputs(F, N, B, C, offset=0):
        rows = gen.randint(0, B, (F, N + 2 * offset)).astype(np.uint8)
        bins = torch.as_tensor(rows, device=dev)[:, offset:offset + N]
        grad = torch.as_tensor(gen.randn(N).astype(np.float32), device=dev)
        hess = torch.as_tensor(gen.rand(N).astype(np.float32), device=dev)
        cid = torch.as_tensor(np.where(gen.rand(N) < 0.9,
                                       gen.randint(0, C, N), -1)
                              .astype(np.int32), device=dev)
        return bins, grad, hess, cid

    def float_err(what, got, bins, grad, hess, cid, C, B):
        want = hist_cuda.hist_plain(
            bins, torch.stack([grad, hess, torch.ones_like(grad)], 1), cid,
            C, B)
        mag = hist_cuda.hist_plain(
            bins, torch.stack([grad.abs(), hess.abs(),
                               torch.ones_like(grad)], 1), cid, C, B)
        err = (got - want).abs()
        # the kernel's fixed-point sums are exact on a grid far finer than
        # f32 (the same bits on every run, which twice() checks); the
        # plain version's f32 index_add_ rounds in its own order: each cell
        # may differ by that rounding, bounded here by 1e-5 of the cell's
        # absolute sum; counts are exact
        tol = 1e-5 * mag + 1e-6
        counts_exact = torch.equal(got[..., 2::3], want[..., 2::3])
        if not (bool((err <= tol).all()) and counts_exact):
            fail("hist float %s: max err %g" % (what, float(err.max())))
        return float(err.max())

    hist_err = {}
    shape_inputs = {}
    for F, N, B, C, offset in sizes["hist_shapes"]:
        bins, grad, hess, cid = hist_inputs(F, N, B, C, offset)
        shape_inputs[(F, N, B, C, offset)] = (bins, grad, hess, cid)
        what = "F=%d N=%d B=%d C=%d offset=%d" % (F, N, B, C, offset)
        got = twice(what, lambda: hist_cuda.hist_float(bins, grad, hess, cid,
                                                       C, B))
        err = float_err(what, got, bins, grad, hess, cid, C, B)
        ok = cid >= 0
        levels, _ = quantize_values(grad, hess, ok)
        got_i = hist_cuda.hist_int8(bins, levels, cid, C, B)
        want_i = hist_cuda.hist_plain(bins, levels.t().to(torch.int32), cid,
                                      C, B)
        if not torch.equal(got_i, want_i):
            fail("hist int8 %s not bitwise" % what)
        hist_err[(F, N, B, C, offset)] = err
        say("phase 2 hist %s: float max abs err %.3g (tol 1e-5 x cell "
            "|sum|), two launches bitwise equal, counts exact, int8 bitwise"
            % (what, err))

    # the pane entry on a segment at an unaligned lane of a 28-feature pane
    F = 28
    bins, grad, hess, _ = shape_inputs[sizes["hist_shapes"][0]]
    P = compact.bucket_table(bins.shape[1])[0]
    pane = compact.pack_planes(bins, grad, hess, grad > -1.0, P)
    sstart, scnt = sizes["pane_segment"]
    got = twice("pane", lambda: hist_cuda.hist_pane_float(pane, F, sstart,
                                                          scnt, 256))
    pb, pg, ph, pvalid = compact.unpack_values(
        pane[:, sstart:sstart + scnt], F)
    pane_err = float_err("pane sstart=%d scnt=%d" % (sstart, scnt),
                         got.reshape(F, 256, 3), pb, pg, ph,
                         torch.where(pvalid, 0, -1).to(torch.int32), 1, 256)
    say("phase 2 hist pane F=%d P=%d sstart=%d scnt=%d: float max abs err "
        "%.3g, two launches bitwise equal, counts exact" % (
            F, P, sstart, scnt, pane_err))

    # ---- phase 3: partition kernel vs its plain version, both entries
    n_train, n_test, F = sizes["n_train"], sizes["n_test"], 28
    R = compact.pane_rows(F)
    W = compact.bucket_table(n_train)[0]
    seg_full = torch.as_tensor(gen.randint(-128, 128, (R, W))
                               .astype(np.int8), device=dev)
    # row F - 1 holds bins of 1 or more: threshold 0 sends every lane right
    seg_full[F - 1] = torch.as_tensor(gen.randint(1, 256, W).astype(np.uint8),
                                      device=dev).view(torch.int8)
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
        say("phase 3 partition mask3 entry %s R=%d W=%d delta=%d cnt=%d: "
            "byte-exact" % (name, R, W, delta, cnt))

    # the pane entry: lanes of one pane into the same lanes of another.
    # Both panes must keep every other lane
    def check_pane(what, src, dst0, F_, feat, thr, start, cnt):
        src0 = src.clone()
        got, want = dst0.clone(), dst0.clone()
        left = compact.partition_pane(src, got, F_, feat, thr, start, cnt)
        want_left = compact.pane_plain(src, want, feat, thr, start, cnt)
        sync()
        err = int((got.int() - want.int()).abs().max())
        if not (torch.equal(got, want) and int(left) == int(want_left)):
            fail("partition pane %s not byte-exact (max abs err %d, left "
                 "%d vs %d)" % (what, err, int(left), int(want_left)))
        if not (torch.equal(got[:, :start], dst0[:, :start])
                and torch.equal(got[:, start + cnt:], dst0[:, start + cnt:])
                and torch.equal(src, src0)):
            fail("partition pane %s wrote a lane outside its segment" % what)
        say("phase 3 partition pane entry %s R=%d start=%d cnt=%d feat=%d "
            "thr=%d: byte-exact, left %d, other lanes untouched"
            % (what, src.shape[0], start, cnt, feat, thr, int(left)))
        return err

    dst0 = torch.as_tensor(gen.randint(-128, 128, (R, W)).astype(np.int8),
                           device=dev)
    tile = compact.TILE
    for what, start, cnt, feat, thr in (
            ("root", 0, n_train, 3, 127),
            ("offset", 1001, n_train // 2, 5, 200),
            ("one tile", 13, tile - 13, 0, 128),
            ("two tiles", 13, tile - 12, 1, 64),
            ("one launch", 3, compact.ONE_LAUNCH_TILES * tile - 3, 2, 140),
            ("count pass", 3, compact.ONE_LAUNCH_TILES * tile - 2, 5, 90),
            ("one lane", 7, 1, 2, 100),
            ("all-left", 5000, n_train // 3, 4, 255),
            ("all-right", 2048, n_train // 3, F - 1, 0),
            ("empty", 777, 0, 0, 0)):
        part_err = max(part_err, check_pane(what, seg_full, dst0, F, feat,
                                            thr, start, cnt))
    F200, n200 = 200, sizes["n_f200"]
    W200 = compact.bucket_table(n200)[0]
    src200 = torch.as_tensor(gen.randint(-128, 128, (compact.pane_rows(
        F200), W200)).astype(np.int8), device=dev)
    part_err = max(part_err, check_pane(
        "F=200", src200, torch.zeros_like(src200), F200, 150, 128, 3,
        n200))
    del src200

    # ---- phase 4: full-width training through the user entry points
    x, latent = make_table(n_train + n_test, F, SEED)
    y = (latent > 0).astype(np.float32)
    t0 = time.perf_counter()
    train_set = lgt.Dataset.from_arrays(x[:n_train], y[:n_train],
                                        max_bin=255)
    say("phase 4 dataset: %d x %d binned in %.1f s (max num_bin %d)" % (
        n_train, F, time.perf_counter() - t0, int(train_set.num_bins.max())))
    params = {"objective": "binary", "num_leaves": 255,
              "num_iterations": 5, "learning_rate": 0.1,
              "hist_dtype": "float32", "max_bin": 255}
    booster, iter_s, counts = drive(params, train_set, dev, sync)
    launches = {"hist": counts["hist"], "partition": counts["partition"]}
    part_kernels = counts["partition_kernels"]
    launch_rows = counts["hist_rows"]
    part_rows = counts["part_rows"]
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
    # one histogram launch per leaf: the root, then each split's smaller
    # child
    first_tree = launch_rows[:leaves[0]]
    if len(launch_rows) != sum(leaves):
        fail("histogram launches %d != leaves %d" % (len(launch_rows),
                                                      sum(leaves)))
    q = np.percentile(first_tree, [50, 90])
    say("phase 4 first tree's histogram launch rows: %d launches, root %d, "
        "children median %d, p90 %d, %d under 10,000" % (
            len(first_tree), first_tree[0], q[0], q[1],
            sum(n < 10_000 for n in first_tree)))
    # one partition per split, every one through the pane entry; one kernel
    # launch where the segment spans at most ONE_LAUNCH_TILES tiles (from
    # the 16-byte boundary at or below its first lane), two otherwise
    splits = sum(leaves) - trees
    if not launches["partition"] == len(part_rows) == splits:
        fail("partition launches %d, pane-entry launches %d, splits %d"
             % (launches["partition"], len(part_rows), splits))
    span = compact.ONE_LAUNCH_TILES * compact.TILE
    one = sum(n <= span - 15 for n in part_rows)
    two = sum(n > span for n in part_rows)
    if not splits + two <= part_kernels <= 2 * splits - one:
        fail("partition kernel launches %d outside [%d, %d]" % (
            part_kernels, splits + two, 2 * splits - one))
    first_parts = part_rows[:leaves[0] - 1]
    q = np.percentile(first_parts, [50, 90])
    say("phase 4 partition: %d calls, %d kernel launches (%.3f per split), "
        "%d of one launch, %d of one tile; first tree's parents: root %d, "
        "median %d, p90 %d, lanes summed %d" % (
            splits, part_kernels, part_kernels / splits,
            2 * splits - part_kernels,
            sum(n <= compact.TILE - 15 for n in part_rows), first_parts[0],
            q[0], q[1], sum(first_parts)))
    check_model("phase 4", booster, x, y, n_train, dev)
    # phase 11 serves this model, and phase 7's multiclass one
    served = {"a": booster.model_to_string()}

    # ---- phase 5: int8 end to end, kernels on the card vs plain on the CPU
    n5 = sizes["n_int8"]
    small = lgt.Dataset.from_arrays(x[:n5], y[:n5], max_bin=255)
    p5 = {"objective": "binary", "num_leaves": 63, "num_iterations": 2,
          "hist_dtype": "int8", "max_bin": 255}
    on_card = lgt.train(p5, small, device=dev)
    on_cpu = lgt.train(p5, small, device="cpu")
    value_diff = same_trees("int8 cuda vs cpu", on_card, on_cpu)
    if value_diff > 1e-6:
        fail("int8 leaf values differ by %g" % value_diff)
    say("phase 5 int8 %d x %d, 63 leaves, 2 trees: cuda == cpu in structure "
        "and leaf_count; leaf values max abs diff %g"
        % (n5, F, value_diff))

    # ---- phase 5, the other growth policies through the user entry
    # point, each with every count set to 0 just before it.  Neither moves
    # rows, so neither may launch the partition kernel.
    launches_by_path = {"leafcompact_float32": launches["hist"]}
    seconds_by_path = {"leafcompact_float32": iter_s}
    depthwise_first = None
    for dtype, iters in (("int8", 5), ("float32", 3)):
        what = "phase 5 depthwise %s" % dtype
        # bench.py's headline configuration (bench.py:1277-1289)
        pd = {"objective": "binary", "grow_policy": "depthwise",
              "hist_dtype": dtype, "num_leaves": 255,
              "min_data_in_leaf": 100, "min_sum_hessian_in_leaf": 10,
              "learning_rate": 0.1, "max_bin": 255, "num_iterations": iters}
        booster, iter_s, counts = drive(pd, train_set, dev, sync)
        if len(booster.models) != iters:
            fail("%s: %d trees, expected %d" % (what, len(booster.models),
                                                 iters))
        if counts["hist"] == 0 or counts["partition"] != 0:
            fail("%s: launches %s, expected histograms and no partition"
                 % (what, {k: counts[k] for k in ("hist", "partition")}))
        # per tree: the root, then one pass per level that chose a slot,
        # C = 1, 2, 4, ... <= 64 columns, every pass over all rows
        per_tree = []
        for k, tree in enumerate(booster.models):
            lo = counts["ends"][k - 1] if k else 0
            rows = counts["hist_rows"][lo:counts["ends"][k]]
            cols = counts["hist_cols"][lo:counts["ends"][k]]
            passes = level_passes(tree, 255)
            if not (len(rows) == 1 + passes <= 8
                    and cols == [1] + [1 << d for d in range(passes)]
                    and all(r == n_train for r in rows)):
                fail("%s tree %d: histogram launches (rows, cols) %s, "
                     "expected the root and %d level passes of %d rows"
                     % (what, k, list(zip(rows, cols)), passes, n_train))
            per_tree.append(list(zip(rows, cols)))
        say("%s: %d trees, leaves %s, seconds per iteration %s" % (
            what, iters, [t.num_leaves for t in booster.models],
            ["%.3f" % v for v in iter_s]))
        say("%s histogram launches per tree %s (0 partitions); first tree's "
            "(rows, columns): %s" % (what, [len(t) for t in per_tree],
                                     per_tree[0]))
        check_model(what, booster, x, y, n_train, dev)
        launches_by_path["depthwise_" + dtype] = counts["hist"]
        seconds_by_path["depthwise_" + dtype] = iter_s
        if dtype == "int8":
            depthwise_first = per_tree[0]

    # depth-wise int8 on the card and on the CPU: the same trees, a 64-
    # column level pass included
    pd = {"objective": "binary", "grow_policy": "depthwise",
          "hist_dtype": "int8", "num_leaves": 255, "min_data_in_leaf": 100,
          "min_sum_hessian_in_leaf": 10, "max_bin": 255, "num_iterations": 2}
    reset_counts()
    on_card = lgt.train(pd, small, device=dev)
    widest = max(hist_cuda.launch_cols)
    on_cpu = lgt.train(pd, small, device="cpu")
    value_diff = same_trees("depthwise int8 cuda vs cpu", on_card, on_cpu)
    if widest != 64 or value_diff > 1e-6:
        fail("depthwise int8 cuda vs cpu: widest pass %d columns, leaf "
             "values differ by %g" % (widest, value_diff))
    say("phase 5 depthwise int8 %d x %d, 255 leaves %s, 2 trees: cuda == cpu "
        "in structure and leaf_count, widest pass %d columns; leaf values max "
        "abs diff %g" % (n5, F, [t.num_leaves for t in on_card.models],
                         widest, value_diff))

    # the masked leaf-wise grower: one histogram launch over all rows per
    # leaf
    what = "phase 5 masked leafwise float32"
    pm = dict(params, leafwise_compact="false", num_iterations=3)
    booster, iter_s, counts = drive(pm, train_set, dev, sync)
    mleaves = [t.num_leaves for t in booster.models]
    if len(mleaves) != 3:
        fail("%s: %d trees, expected 3" % (what, len(mleaves)))
    if not (counts["hist"] == sum(mleaves) and counts["partition"] == 0
            and set(counts["hist_rows"]) == {n_train}
            and set(counts["hist_cols"]) == {1}):
        fail("%s: %d histogram launches over rows %s, %d partitions; "
             "expected %d over %d rows and none" % (
                 what, counts["hist"], sorted(set(counts["hist_rows"])),
                 counts["partition"], sum(mleaves), n_train))
    say("%s: 3 trees, leaves %s, seconds per iteration %s; histogram "
        "launches per tree %.1f over %d rows each, 0 partitions" % (
            what, mleaves, ["%.3f" % v for v in iter_s],
            counts["hist"] / 3, n_train))
    check_model(what, booster, x, y, n_train, dev)
    launches_by_path["leafwise_float32"] = counts["hist"]
    seconds_by_path["leafwise_float32"] = iter_s
    # masked against compacted in int8 on the card: the same trees
    pi = {"objective": "binary", "num_leaves": 63, "num_iterations": 2,
          "hist_dtype": "int8", "max_bin": 255}
    masked = lgt.train(dict(pi, leafwise_compact="false"), small, device=dev)
    compacted = lgt.train(pi, small, device=dev)
    value_diff = same_trees("masked vs compacted int8", masked, compacted)
    say("phase 5 masked vs compacted int8 %d x %d, 63 leaves, 2 trees on the "
        "card: equal in structure and leaf_count; leaf values max abs diff "
        "%g" % (n5, F, value_diff))

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
    twice("phase 6 root", lambda: hist_cuda.hist_float(bins, grad, hess, cid,
                                                       1, B))
    # timed as the main path launches it: with the tree's fixed-point
    # exponent, computed once a tree (the wrapper's default computes it
    # on every call)
    tree_e = hist_cuda.fixed_exponent(grad, hess, N)
    kernels["hist"] = {
        "name": "hist", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/hist.cu",
        "replaces": "lightgbm_tpu/ops/hist_pallas.py:86",
        "launches": launches["hist"],
        "max_abs_err": hist_err[sizes["hist_shapes"][0]],
        "ms": timer(lambda: hist_cuda.hist_float(bins, grad, hess, cid,
                                                 1, B, tree_e)),
        "plain_ms": timer(lambda: hist_cuda.hist_plain(bins, vals3, cid,
                                                       1, B)),
        "bound_ms": (N * F + 12 * N + F * B * 3 * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": timer(lambda: acc.scatter_add_(0, idx3, src3)),
    }
    # the pane entry at the root: N lanes of the 28-feature pane into the
    # second pane; its bound is the segment's bytes read and written once
    feat, thr = 3, 127
    keys = (seg_full[feat, :N].view(torch.uint8) > thr).to(torch.int8)
    kernels["partition"] = {
        "name": "partition", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/partition.cu",
        "replaces": "lightgbm_tpu/ops/compact.py:393",
        "launches": launches["partition"],
        "kernel_launches": part_kernels,
        "max_abs_err": part_err,
        "ms": timer(lambda: compact.partition_pane(seg_full, dst0, F, feat,
                                                   thr, 0, N)),
        "plain_ms": timer(lambda: compact.pane_plain(seg_full, dst0, feat,
                                                     thr, 0, N)),
        "bound_ms": 2 * R * N / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": timer(lambda: seg_full[:, :N][:, torch.sort(
            keys, stable=True).indices]),
    }
    # the first tree's partitions replayed through the pane entry at their
    # own sizes, each at an unaligned lane
    tree_ms = tree_bound_ms = 0.0
    for n in first_parts:
        start = min(1001, W - n)
        tree_ms += timer(lambda: compact.partition_pane(
            seg_full, dst0, F, feat, thr, start, n), reps=5)
        tree_bound_ms += 2 * R * n / HBM_BYTES_PER_S * 1e3
    kernels["partition"]["tree_ms"] = tree_ms
    kernels["partition"]["tree_bound_ms"] = tree_bound_ms
    # the first tree's histogram launches replayed through the pane entry,
    # each segment at an unaligned lane of a 28-feature pane whose rows are
    # all valid, as on the main path.  First the entry against its plain
    # version there at the root's size and at the smallest, median and
    # p90 child sizes
    P = compact.bucket_table(N)[0]
    pane = compact.pack_planes(bins, grad, hess,
                               torch.ones(N, dtype=torch.bool, device=dev),
                               P)
    children = sorted(first_tree[1:]) or [1]
    for what, n in (("root", first_tree[0]), ("smallest child", children[0]),
                    ("median child", children[len(children) // 2]),
                    ("p90 child", children[len(children) * 9 // 10])):
        start = min(1001, P - n)
        got = twice("pane " + what, lambda: hist_cuda.hist_pane_float(
            pane, F, start, n, B))
        pb, pg, ph, pvalid = compact.unpack_values(
            pane[:, start:start + n], F)
        err = float_err("pane %s sstart=%d scnt=%d" % (what, start, n), got,
                        pb, pg, ph, torch.where(pvalid, 0, -1)
                        .to(torch.int32), 1, B)
        say("phase 6 hist pane, rows all valid, %s sstart=%d scnt=%d: float "
            "max abs err %.3g, two launches bitwise equal, counts exact"
            % (what, start, n, err))
    tree_ms = tree_bound_ms = 0.0
    for n in first_tree:
        start = min(1001, P - n)
        tree_ms += timer(lambda: hist_cuda.hist_pane_float(
            pane, F, start, n, B, None, 1, tree_e), reps=5)
        tree_bound_ms += (n * (F + 9) + F * B * 3 * 4) / HBM_BYTES_PER_S * 1e3
    kernels["hist"]["tree_ms"] = tree_ms
    kernels["hist"]["tree_bound_ms"] = tree_bound_ms
    shapes = []
    for (F_, N_, B_, C_, off), (sb, sg, sh, sc) in shape_inputs.items():
        if off or N_ < 100_000:
            continue
        shape_e = hist_cuda.fixed_exponent(sg, sh, N_)
        shapes.append({
            "F": F_, "N": N_, "B": B_, "C": C_,
            "ms": timer(lambda: hist_cuda.hist_float(sb, sg, sh, sc, C_, B_,
                                                     shape_e)),
            "bound_ms": (N_ * F_ + 12 * N_ + F_ * B_ * 3 * C_ * 4)
            / HBM_BYTES_PER_S * 1e3})
    kernels["hist"]["shapes"] = shapes
    # the int8 mode at the depth-wise widths, each beside its bound (the
    # bin bytes, a side band of 3 int8 levels and a 4-byte column id per
    # row, the accumulator written once) and the library call for the same
    # function: a scatter_add_ of int32 levels on a prebuilt index
    def int8_inputs(n, C, keep):
        cid_c = torch.as_tensor(np.where(gen.rand(n) < keep,
                                         gen.randint(0, C, n), -1)
                                .astype(np.int32), device=dev)
        levels, _ = quantize_values(grad[:n], hess[:n], cid_c >= 0)
        return cid_c, levels

    def int8_bound(n, C):
        return (n * F + 7 * n + F * B * 3 * C * 4) / HBM_BYTES_PER_S * 1e3

    int8_shapes = []
    for C in sizes["int8_cols"]:
        cid_c, levels = int8_inputs(N, C, 0.9)
        lev32 = levels.t().to(torch.int32)
        got = hist_cuda.hist_int8(bins, levels, cid_c, C, B)
        if not torch.equal(got, hist_cuda.hist_plain(bins, lev32, cid_c, C,
                                                     B)):
            fail("hist int8 F=%d N=%d C=%d not bitwise" % (F, N, C))
        cidx = (torch.arange(F, device=dev)[:, None] * B + bins.long()) * C \
            + cid_c.long().clamp(0, C - 1)[None, :]
        cidx = torch.where((cid_c >= 0)[None, :], cidx, F * B * C)
        cidx3 = cidx.reshape(-1, 1).expand(-1, 3)
        csrc3 = lev32[None].expand(F, N, 3).reshape(-1, 3)
        cacc = torch.zeros((F * B * C + 1, 3), dtype=torch.int32, device=dev)
        int8_shapes.append({
            "F": F, "N": N, "B": B, "C": C, "max_abs_err": 0,
            "ms": timer(lambda: hist_cuda.hist_int8(bins, levels, cid_c, C,
                                                    B)),
            "plain_ms": timer(lambda: hist_cuda.hist_plain(bins, lev32, cid_c,
                                                           C, B)),
            "bound_ms": int8_bound(N, C), "bound_by": "bytes",
            "library_ms": timer(lambda: cacc.scatter_add_(0, cidx3, csrc3))})
        del cidx, cidx3, csrc3, cacc
    kernels["hist"]["int8_shapes"] = int8_shapes
    # the first depth-wise int8 tree's launches replayed at their own rows
    # and columns; a level pass keeps the smaller children, about half of
    # the rows
    dw_ms = dw_bound_ms = 0.0
    for k, (n, C) in enumerate(depthwise_first):
        cid_c, levels = int8_inputs(n, C, 1.0 if k == 0 else 0.5)
        dw_ms += timer(lambda: hist_cuda.hist_int8(bins[:, :n], levels, cid_c,
                                                   C, B), reps=5)
        dw_bound_ms += int8_bound(n, C)
    kernels["hist"]["depthwise_tree_ms"] = dw_ms
    kernels["hist"]["depthwise_tree_bound_ms"] = dw_bound_ms
    kernels["hist"]["depthwise_tree_launches"] = depthwise_first
    kernels["hist"]["launches_by_path"] = launches_by_path
    kernels["partition"]["launches_by_path"] = dict(
        {k: 0 for k in launches_by_path},
        leafcompact_float32=launches["partition"])
    for path, secs in seconds_by_path.items():
        say("phase 6 seconds per iteration, %s: %s (launches: hist %d)" % (
            path, " ".join("%.3f" % v for v in secs),
            launches_by_path[path]))
    for k in kernels.values():
        say("phase 6 %s: %.4f ms (plain %.4f, library %.4f, bound %.4f)"
            % (k["name"], k["ms"], k["plain_ms"], k["library_ms"],
               k["bound_ms"]))
    for k in kernels.values():
        say("phase 6 %s first tree replayed: %.4f ms, bound %.4f ms"
            % (k["name"], k["tree_ms"], k["tree_bound_ms"]))
    say("phase 6 hist float (fixed point) root %.4f ms (f32 atomics %.4f, "
        "bound %.4f), first tree replayed %.4f ms (f32 atomics %.4f, bound "
        "%.4f) [%s]" % (kernels["hist"]["ms"], F32_ATOMICS_MS["root"],
                        kernels["hist"]["bound_ms"],
                        kernels["hist"]["tree_ms"], F32_ATOMICS_MS["tree"],
                        kernels["hist"]["tree_bound_ms"], card_name()))
    for sh_ in shapes:
        say("phase 6 hist F=%d N=%d B=%d C=%d: %.4f ms (bound %.4f)" % (
            sh_["F"], sh_["N"], sh_["B"], sh_["C"], sh_["ms"],
            sh_["bound_ms"]))
    for sh_ in int8_shapes:
        say("phase 6 hist int8 F=%d N=%d B=%d C=%d: %.4f ms (plain %.4f, "
            "library %.4f, bound %.4f)" % (
                sh_["F"], sh_["N"], sh_["B"], sh_["C"], sh_["ms"],
                sh_["plain_ms"], sh_["library_ms"], sh_["bound_ms"]))
    say("phase 6 hist first depthwise int8 tree replayed (%d launches): "
        "%.4f ms, bound %.4f ms" % (len(depthwise_first), dw_ms, dw_bound_ms))

    # ---- phase 7: the other objectives through the same kernels
    for path, counts in objectives_phase(dev, sizes, x, latent, train_set,
                                         sync, timer, served).items():
        kernels["hist"]["launches_by_path"][path] = counts["hist"]
        kernels["partition"]["launches_by_path"][path] = counts["partition"]
    # ---- phase 8: sampling, early stopping and continued training
    for path, counts in sampling_phase(dev, sizes, x, y, train_set,
                                       sync).items():
        kernels["hist"]["launches_by_path"][path] = counts["hist"]
        kernels["partition"]["launches_by_path"][path] = counts["partition"]
    # ---- phase 9: mixed-bin packing, bfloat16 and stochastic rounding
    by_path, records = mixed_phase(dev, sizes, sync, timer)
    for path, counts in by_path.items():
        kernels["hist"]["launches_by_path"][path] = counts["hist"]
        kernels["partition"]["launches_by_path"][path] = counts["partition"]
    kernels["hist"].update(records)
    # ---- phase 10: 16-bit bins (max_bin = 1023)
    kernels.update(wide_phase(dev, sizes, x, y, sync, timer))
    # ---- phase 11: serving, which launches neither kernel; (b)'s training
    # is an 8-bit path
    for path, counts in serving_phase(dev, sizes, x, train_set, served, sync,
                                      timer).items():
        for name, k in kernels.items():
            if path == "serving" or not name.endswith("16"):
                k["launches_by_path"][path] = counts[
                    "hist" if name.startswith("hist") else "partition"]
    # ---- phase 12: the ingest layer, every load route onto the card
    for path, counts in ingest_phase(dev, sizes, sync).items():
        kernels["hist"]["launches_by_path"][path] = counts["hist"]
        kernels["partition"]["launches_by_path"][path] = counts["partition"]
    # ---- phase 13: checkpoints and resume on phase 4's table
    for path, counts in checkpoint_phase(dev, sizes, train_set,
                                         sync).items():
        kernels["hist"]["launches_by_path"][path] = counts["hist"]
        kernels["partition"]["launches_by_path"][path] = counts["partition"]
    # ---- phase 14: observability around the main path
    for path, counts in observability_phase(dev, sizes, x, y, train_set,
                                            served, sync).items():
        kernels["hist"]["launches_by_path"][path] = counts["hist"]
        kernels["partition"]["launches_by_path"][path] = counts["partition"]
    return list(kernels.values())


def mixed_phase(dev, sizes, sync, timer):
    """Phase 9 on bench.py's headline table (``make_mixed``: 24 narrow
    columns of 2-61 values, 4 continuous; a two-class plan, 24 features
    at 64 bins and 4 at 254):

    (a) the histogram kernel's per-class launches (F = 24 at B = 64, F = 4
        at B = 254; float, int8 and int8 with stochastic rounding, its
        hash and quantization timed with the launch; C = 1, 8, 64) and
        the pane entry over each class's bin rows, against their plain
        versions, timed beside their bounds and the library call; a
        packed pass against the uniform one;
    (b) bench.py's headline configuration (depth-wise int8, 255 leaves,
        ``mixed_bin=auto``), 5 iterations: the plan, two launches a pass,
        held-out AUC, and the same model text as ``mixed_bin=false``;
        both in turns for seconds per iteration, and the first tree's
        launches replayed in both layouts (``depthwise_tree_ms``);
    (c) int8_sr compacted and depth-wise, 63 leaves, 2 trees: the card's
        model text equals the CPU's;
    (d) bfloat16 compacted and depth-wise, 255 leaves, 3 iterations:
        seconds per iteration, falling logloss, held-out AUC.

    Returns (launch counts by path, the records for the kernels line)."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import compact, hist_cuda
    from lightgbm_tpu_torch.ops.hist_cuda import quantize_values
    from lightgbm_tpu_torch.ops.histogram import histogram_leafbatch
    n_train, n_test, F = sizes["n_train"], sizes["n_test"], 28
    t0 = time.perf_counter()
    x, y = make_mixed(n_train + n_test, F, SEED, 24)
    train_set = lgt.Dataset.from_arrays(x[:n_train], y[:n_train],
                                        max_bin=255)
    spec = train_set.plan_packing("auto")
    if spec is None or spec.counts != (24, 4) or spec.widths[0] != 64:
        fail("phase 9: plan %s, expected 24 features at 64 bins and 4 wide"
             % (spec,))
    nb_max = spec.widths[1]
    say("phase 9 headline table: %d x %d (24 narrow columns) binned in "
        "%.1f s; plan: %d features at %d bins, %d at %d"
        % (n_train, F, time.perf_counter() - t0, spec.counts[0],
           spec.widths[0], spec.counts[1], nb_max))

    # ---- 9a: the class launches against their plain versions
    gen = np.random.RandomState(SEED + 9)
    N = n_train
    canon = torch.as_tensor(train_set.bins, device=dev)
    pbins = canon[torch.as_tensor(spec.perm, device=dev)].contiguous()
    grad = torch.as_tensor(gen.randn(N).astype(np.float32), device=dev)
    hess = torch.as_tensor(gen.rand(N).astype(np.float32), device=dev)
    # the float launches are timed with one exponent, as a tree's are
    tree_e = hist_cuda.fixed_exponent(grad, hess, N)

    def bound(n, Fc, B, C, side):
        return (n * Fc + side * n + Fc * B * 3 * C * 4) / HBM_BYTES_PER_S \
            * 1e3

    class_shapes, pass_shapes = [], []
    for C in sizes["class_cols"]:
        cid = torch.as_tensor(np.where(gen.rand(N) < 0.9,
                                       gen.randint(0, C, N), -1)
                              .astype(np.int32), device=dev)
        ok = cid >= 0
        levels, _ = quantize_values(grad, hess, ok)
        lev32 = levels.t().to(torch.int32)
        vals3 = torch.stack([grad, hess, torch.ones_like(grad)], 1)
        for first, cnt, width in spec.ranges:
            cb = pbins[first:first + cnt]
            # the library call: a scatter_add_ on a prebuilt index, rows
            # outside [0, C) into a dropped bucket
            idx = (torch.arange(cnt, device=dev)[:, None] * width
                   + cb.long()) * C + cid.long().clamp(0, C - 1)[None, :]
            idx = torch.where(ok[None, :], idx, cnt * width * C)
            idx3 = idx.reshape(-1, 1).expand(-1, 3)
            for mode in ("float32", "int8"):
                what = "F=%d B=%d C=%d %s" % (cnt, width, C, mode)
                if mode == "int8":
                    got = hist_cuda.hist_int8(cb, levels, cid, C, width)
                    plain = lambda: hist_cuda.hist_plain(cb, lev32, cid, C,
                                                         width)
                    if not torch.equal(got, plain()):
                        fail("phase 9a hist %s not bitwise" % what)
                    err = 0.0
                    run_k = lambda: hist_cuda.hist_int8(cb, levels, cid, C,
                                                        width)
                    src = lev32
                else:
                    got = twice("phase 9a " + what, lambda: hist_cuda
                                .hist_float(cb, grad, hess, cid, C, width))
                    err = float64_err("phase 9a " + what, got, cb, grad,
                                      hess, cid, C, width)
                    plain = lambda: hist_cuda.hist_plain(cb, vals3, cid, C,
                                                         width)
                    run_k = lambda: hist_cuda.hist_float(cb, grad, hess,
                                                         cid, C, width,
                                                         tree_e)
                    src = vals3
                src3 = src[None].expand(cnt, N, 3).reshape(-1, 3)
                acc = torch.zeros((cnt * width * C + 1, 3), dtype=src.dtype,
                                  device=dev)
                class_shapes.append({
                    "F": cnt, "N": N, "B": width, "C": C, "mode": mode,
                    "max_abs_err": err, "ms": timer(run_k),
                    "plain_ms": timer(plain),
                    "bound_ms": bound(N, cnt, width, C,
                                      7 if mode == "int8" else 12),
                    "bound_by": "bytes",
                    "library_ms": timer(lambda: acc.scatter_add_(0, idx3,
                                                                 src3))})
                if mode == "int8":
                    # stochastic rounding: the value-keyed hash and the
                    # quantization, then the int8 launch; plain: the
                    # same quantization, then the plain version; library:
                    # scatter_add_ of the same levels
                    sr, _ = quantize_values(grad, hess, ok, True, 7)
                    sr32 = sr.t().to(torch.int32)
                    if not torch.equal(hist_cuda.hist_int8(cb, sr, cid, C,
                                                           width),
                                       hist_cuda.hist_plain(cb, sr32, cid,
                                                            C, width)):
                        fail("phase 9a hist %s int8_sr not bitwise" % what)
                    sr3 = sr32[None].expand(cnt, N, 3).reshape(-1, 3)
                    class_shapes.append({
                        "F": cnt, "N": N, "B": width, "C": C,
                        "mode": "int8_sr", "max_abs_err": 0.0,
                        "ms": timer(lambda: hist_cuda.hist_int8(
                            cb, quantize_values(grad, hess, ok, True, 7)[0],
                            cid, C, width)),
                        "plain_ms": timer(lambda: hist_cuda.hist_plain(
                            cb, quantize_values(grad, hess, ok, True, 7)[0]
                            .t().to(torch.int32), cid, C, width)),
                        "bound_ms": bound(N, cnt, width, C, 7),
                        "bound_by": "bytes",
                        "library_ms": timer(lambda: acc.scatter_add_(
                            0, idx3, sr3))})
                    del sr3
                del src3, acc
            del idx, idx3
        # a whole pass, packed (two launches, assembled) against uniform
        for mode in ("float32", "int8"):
            packed_h = histogram_leafbatch(pbins, grad, hess, cid, ok, C,
                                           nb_max, mode, packing=spec)
            uniform_h = histogram_leafbatch(canon, grad, hess, cid, ok, C,
                                            nb_max, mode)
            if mode == "int8" and not torch.equal(packed_h, uniform_h):
                fail("phase 9a packed int8 pass C=%d differs from uniform"
                     % C)
            # the float mode too: every launch of both layouts sums the
            # same rows' values at the same exponent, in fixed point
            if mode == "float32" and not torch.equal(packed_h, uniform_h):
                fail("phase 9a packed float pass C=%d differs from uniform"
                     % C)
            pass_shapes.append({
                "C": C, "mode": mode,
                "packed_ms": timer(lambda: histogram_leafbatch(
                    pbins, grad, hess, cid, ok, C, nb_max, mode,
                    packing=spec, exponent=tree_e)),
                "uniform_ms": timer(lambda: histogram_leafbatch(
                    canon, grad, hess, cid, ok, C, nb_max, mode,
                    exponent=tree_e)),
                "packed_bound_ms": (N * F + (7 if mode == "int8" else 12) * N
                                    + (24 * 64 + 4 * nb_max) * 3 * C * 4)
                / HBM_BYTES_PER_S * 1e3,
                "uniform_bound_ms": bound(N, F, nb_max, C,
                                          7 if mode == "int8" else 12)})
    for r in class_shapes:
        say("phase 9a hist %s F=%d N=%d B=%d C=%d: %.4f ms (plain %.4f, "
            "library %.4f, bound %.4f), max abs err %.3g" % (
                r["mode"], r["F"], r["N"], r["B"], r["C"], r["ms"],
                r["plain_ms"], r["library_ms"], r["bound_ms"],
                r["max_abs_err"]))
    for r in pass_shapes:
        say("phase 9a %s pass C=%d: packed %.4f ms (bound %.4f), uniform "
            "%.4f ms (bound %.4f)" % (r["mode"], r["C"], r["packed_ms"],
                                      r["packed_bound_ms"], r["uniform_ms"],
                                      r["uniform_bound_ms"]))
    # the pane entry over each class's rows, all rows valid, at the root
    P = compact.bucket_table(N)[0]
    pane = compact.pack_planes(pbins, grad, hess,
                               torch.ones(N, dtype=torch.bool, device=dev), P)
    n = N - 2000
    pane_shapes = []
    for first, cnt, width in spec.ranges:
        got = twice("phase 9a pane rows %d-%d" % (first, first + cnt),
                    lambda: hist_cuda.hist_pane_float(pane, F, 1001, n, width,
                                                      (first, cnt)))
        pb, pg, ph, pvalid = compact.unpack_values(pane[:, 1001:1001 + n], F)
        err = float64_err("phase 9a pane rows %d-%d" % (first, first + cnt),
                          got, pb[first:first + cnt], pg, ph,
                          torch.where(pvalid, 0, -1).to(torch.int32), 1,
                          width)
        pane_shapes.append({
            "F": cnt, "N": n, "B": width, "C": 1, "max_abs_err": err,
            "ms": timer(lambda: hist_cuda.hist_pane_float(
                pane, F, 1001, n, width, (first, cnt), 1, tree_e)),
            "plain_ms": timer(lambda: hist_cuda.pane_plain(
                pane[:, 1001:1001 + n], F, width, (first, cnt))),
            "bound_ms": (n * (cnt + 9) + cnt * width * 3 * 4)
            / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": pane_library_ms(timer, pane[:, 1001:1001 + n], F,
                                          width, (first, cnt))})
        say("phase 9a hist pane rows %d-%d (F=%d B=%d) over %d lanes: %.4f "
            "ms (plain %.4f, library %.4f, bound %.4f), max abs err %.3g" % (
                first, first + cnt - 1, cnt, width, n,
                pane_shapes[-1]["ms"], pane_shapes[-1]["plain_ms"],
                pane_shapes[-1]["library_ms"], pane_shapes[-1]["bound_ms"],
                err))
    del pane, canon

    # ---- 9b: bench.py's headline configuration, packed and uniform in
    # turns (bench.py:1277-1289)
    pd = {"objective": "binary", "grow_policy": "depthwise",
          "hist_dtype": "int8", "num_leaves": 255, "min_data_in_leaf": 100,
          "min_sum_hessian_in_leaf": 10, "learning_rate": 0.1,
          "max_bin": 255, "num_iterations": 5}
    by_path, runs, secs = {}, {}, {"packed": [], "uniform": []}
    for name, mixed_bin in (("packed", "auto"), ("uniform", "false"),
                            ("uniform", "false"), ("packed", "auto")):
        what = "phase 9b headline %s" % name
        booster, iter_s, counts = drive(dict(pd, mixed_bin=mixed_bin),
                                        train_set, dev, sync)
        secs[name].append(iter_s)
        if (booster._pack_spec is not None) != (name == "packed"):
            fail("%s: layout %s" % (what, booster._pack_spec))
        per_pass = 2 if name == "packed" else 1
        first_tree = None
        for k, tree in enumerate(booster.models):
            lo = counts["ends"][k - 1] if k else 0
            rows = counts["hist_rows"][lo:counts["ends"][k]]
            cols = counts["hist_cols"][lo:counts["ends"][k]]
            passes = level_passes(tree, 255)
            want = [c for c in [1] + [1 << d for d in range(passes)]
                    for _ in range(per_pass)]
            if not (cols == want and all(r == n_train for r in rows)
                    and counts["partition"] == 0):
                fail("%s tree %d: histogram launches (rows, cols) %s, "
                     "expected %d a pass over %d rows, passes %d" % (
                         what, k, list(zip(rows, cols)), per_pass,
                         n_train, 1 + passes))
            if k == 0:
                first_tree = list(zip(rows, cols))
        if name not in runs:
            runs[name] = (booster, first_tree)
            by_path["headline_depthwise_int8_" + name] = counts
            say("%s: leaves %s, seconds per iteration %s, histogram "
                "launches per tree %s (%d a pass), 0 partitions" % (
                    what, [t.num_leaves for t in booster.models],
                    " ".join("%.3f" % v for v in iter_s),
                    [b - a for a, b in zip([0] + counts["ends"][:-1],
                                           counts["ends"])], per_pass))
            if name == "packed":
                check_model(what, booster, x, y, n_train, dev)
        else:
            say("%s (again): seconds per iteration %s" % (
                what, " ".join("%.3f" % v for v in iter_s)))
    if runs["packed"][0].model_to_string() != \
            runs["uniform"][0].model_to_string():
        fail("phase 9b: the packed model differs from mixed_bin=false's")
    say("phase 9b headline: packed and mixed_bin=false model text byte-equal")
    # the first packed tree's launches replayed in both layouts, on the
    # table's own bins; a level pass keeps the smaller children, about
    # half of the rows
    pbins_d = runs["packed"][0].bins_device
    ubins_d = runs["uniform"][0].bins_device
    replay = {"packed": [0.0, 0.0], "uniform": [0.0, 0.0]}
    passes = runs["packed"][1][::2]
    for k, (n, C) in enumerate(passes):
        cid = torch.as_tensor(np.where(gen.rand(n) < (1.0 if k == 0 else 0.5),
                                       gen.randint(0, C, n), -1)
                              .astype(np.int32), device=dev)
        levels, _ = quantize_values(grad[:n], hess[:n], cid >= 0)

        def packed_pass():
            for first, cnt, width in spec.ranges:
                hist_cuda.hist_int8(pbins_d[first:first + cnt, :n], levels,
                                    cid, C, width)

        replay["packed"][0] += timer(packed_pass, reps=5)
        replay["packed"][1] += (n * F + 7 * n + (24 * 64 + 4 * nb_max) * 3
                                * C * 4) / HBM_BYTES_PER_S * 1e3
        replay["uniform"][0] += timer(lambda: hist_cuda.hist_int8(
            ubins_d[:, :n], levels, cid, C, nb_max), reps=5)
        replay["uniform"][1] += bound(n, F, nb_max, C, 7)
    for name in ("packed", "uniform"):
        say("phase 9b headline %s: first tree's %d passes replayed %.4f ms "
            "(bound %.4f); seconds per iteration, both runs: %s" % (
                name, len(passes), replay[name][0], replay[name][1],
                " / ".join(" ".join("%.3f" % v for v in r)
                           for r in secs[name])))

    # ---- 9c: int8_sr on the card against the CPU, packed
    n5 = sizes["n_int8"]
    small = lgt.Dataset.from_arrays(x[:n5], y[:n5], max_bin=255)
    for name, extra in (("compacted", {}),
                        ("depthwise", {"grow_policy": "depthwise"})):
        what = "phase 9c int8_sr %s" % name
        p = dict({"objective": "binary", "num_leaves": 63,
                  "num_iterations": 2, "hist_dtype": "int8",
                  "quant_rounding": "stochastic", "max_bin": 255}, **extra)
        on_card, _, counts = drive(p, small, dev, sync)
        on_cpu = lgt.train(p, small, device="cpu")
        if on_card._pack_spec is None or counts["hist"] == 0:
            fail("%s: not packed or no histogram launch" % what)
        if on_card.model_to_string() != on_cpu.model_to_string():
            fail("%s: card and CPU models differ" % what)
        by_path["int8_sr_%s_packed" % name] = counts
        say("%s %d x %d, 63 leaves %s, 2 trees: model text on the card "
            "equals the CPU's; %d histogram launches, %d partitions" % (
                what, n5, F, [t.num_leaves for t in on_card.models],
                counts["hist"], counts["partition"]))

    # ---- 9d: bfloat16 at full width
    for name, extra in (("compacted", {}),
                        ("depthwise", {"grow_policy": "depthwise",
                                       "min_data_in_leaf": 100,
                                       "min_sum_hessian_in_leaf": 10})):
        what = "phase 9d bfloat16 %s" % name
        p = dict({"objective": "binary", "num_leaves": 255,
                  "num_iterations": 3, "hist_dtype": "bfloat16",
                  "learning_rate": 0.1, "max_bin": 255}, **extra)
        booster, iter_s, counts = drive(p, train_set, dev, sync)
        leaves = [t.num_leaves for t in booster.models]
        if name == "compacted":
            ok_counts = (counts["hist"] == 2 * sum(leaves)
                         and counts["partition"] == sum(leaves) - 3)
        else:
            ok_counts = counts["partition"] == 0 and counts["hist"] == sum(
                2 * (1 + level_passes(t, 255)) for t in booster.models)
        if len(leaves) != 3 or not ok_counts:
            fail("%s: %d trees, launches hist %d partition %d"
                 % (what, len(leaves), counts["hist"], counts["partition"]))
        say("%s: leaves %s, seconds per iteration %s; launches per tree: "
            "hist %.1f, partition %.1f" % (
                what, leaves, " ".join("%.3f" % v for v in iter_s),
                counts["hist"] / 3, counts["partition"] / 3))
        check_model(what, booster, x, y, n_train, dev)
        by_path["bfloat16_%s_packed" % name] = counts
        secs["bfloat16_" + name] = [iter_s]
    records = {"class_shapes": class_shapes, "pass_shapes": pass_shapes,
               "pane_class_shapes": pane_shapes,
               "headline_tree_ms": {k: v[0] for k, v in replay.items()},
               "headline_tree_bound_ms": {k: v[1] for k, v in replay.items()},
               "headline_tree_launches": runs["packed"][1],
               "seconds_by_path_phase9": secs}
    return ({k: {"hist": v["hist"], "partition": v["partition"]}
             for k, v in by_path.items()}, records)


def rank_queries(rows: int, rng) -> np.ndarray:
    """Boundaries of queries of 50-190 documents, uniform, over ``rows``
    (MSLR-WEB10K averages about 120 documents a query); the last query
    takes what is left."""
    ends = np.cumsum(rng.randint(50, 191, rows // 50 + 1))
    return np.concatenate([[0], ends[ends < rows], [rows]]).astype(np.int32)


def held_out(metric, booster, x_test, iterations):
    """The metric's first value on the held-out rows after each of the
    first ``iterations`` iterations (K trees each)."""
    out = []
    for k in range(1, iterations + 1):
        raw = booster.predict_raw(x_test, k)
        out.append(metric.eval(raw.reshape(-1))[0])
    return out


def objectives_phase(dev, sizes, x, latent, train_set, sync, timer,
                     served):
    """Phase 7: regression, multiclass (K = 5) and lambdarank at the main
    path's settings (compacted leaf-wise, float32, 255 leaves) on the
    main path's features, each driven with every count set to 0 just
    before it; then the int8 trees of regression and multiclass on the
    card against the CPU, and the lambdarank gradients on both devices.
    Returns the launch counts of each objective's run; the multiclass
    model's text goes into ``served["c"]``."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.config import OverallConfig
    from lightgbm_tpu_torch.io.metadata import Metadata
    from lightgbm_tpu_torch.metrics import (L2Metric, MultiLoglossMetric,
                                            NDCGMetric)
    from lightgbm_tpu_torch.objectives import create_objective
    n_train, n_test, F = sizes["n_train"], sizes["n_test"], x.shape[1]
    K = 5
    rng = np.random.RandomState(SEED + 7)
    proj = rng.randn(F, K) / np.sqrt(F)
    y_multi = np.argmax(x @ proj + 0.5 * rng.randn(len(x), K), 1) \
        .astype(np.float32)
    cuts = np.quantile(latent[:n_train], [0.4, 0.7, 0.9, 0.97])
    y_rank = np.digitize(latent, cuts).astype(np.float32)
    qb_train = rank_queries(n_train, rng)
    qb_test = rank_queries(n_test, rng)

    def metadata(label, qb=None):
        md = Metadata()
        md.set_label(label)
        md.query_boundaries = qb
        md.finalize(len(label))
        return md

    def config(params):
        cfg = OverallConfig()
        cfg.set({k: str(v) for k, v in params.items()}, require_data=False)
        return cfg

    base = {"num_leaves": 255, "learning_rate": 0.1, "hist_dtype": "float32",
            "max_bin": 255}
    runs = (
        ("regression", {"objective": "regression", "num_iterations": 5},
         latent.astype(np.float32), None, None, L2Metric, "RMSE"),
        ("multiclass", {"objective": "multiclass", "num_class": K,
                        "num_iterations": 3}, y_multi, None, None,
         MultiLoglossMetric, "multi_logloss"),
        ("lambdarank", {"objective": "lambdarank", "num_iterations": 3,
                        "ndcg_eval_at": 5}, y_rank, qb_train, qb_test,
         NDCGMetric, "NDCG@5"))
    by_path = {}
    for name, extra, label, qb, qb_held, metric_cls, metric_name in runs:
        what = "phase 7 %s" % name
        params = dict(base, **extra)
        t0 = time.perf_counter()
        ds = lgt.Dataset.from_arrays(x[:n_train], label[:n_train],
                                     max_bin=255, query_boundaries=qb,
                                     reference=train_set)
        say("%s dataset: %d rows%s, labels from the main path's bins in "
            "%.1f s" % (what, n_train, "" if qb is None else
                        " in %d queries" % (len(qb) - 1),
                        time.perf_counter() - t0))
        booster, iter_s, counts = drive(params, ds, dev, sync)
        per_iter = K if name == "multiclass" else 1
        iters = extra["num_iterations"]
        leaves = [t.num_leaves for t in booster.models]
        if len(leaves) != iters * per_iter:
            fail("%s: %d trees, expected %d" % (what, len(leaves),
                                                 iters * per_iter))
        # one histogram launch per leaf and one pane-entry partition per
        # split, tree by tree, as phase 4 counts them
        ends = [0] + counts["ends"]
        for it in range(iters):
            got = ends[it + 1] - ends[it]
            want = sum(leaves[it * per_iter:(it + 1) * per_iter])
            if got != want:
                fail("%s iteration %d: %d histogram launches, %d leaves"
                     % (what, it + 1, got, want))
        splits = sum(leaves) - len(leaves)
        if not (counts["hist"] == len(counts["hist_rows"]) == sum(leaves)
                and counts["partition"] == len(counts["part_rows"])
                == splits):
            fail("%s: %d histogram launches for %d leaves, %d partitions "
                 "for %d splits" % (what, counts["hist"], sum(leaves),
                                    counts["partition"], splits))
        say("%s: %d trees, %d of them of 255 leaves, seconds per iteration %s; "
            "launches per tree: hist %.1f, partition %.1f" % (
                what, len(leaves), sum(n == 255 for n in leaves),
                " ".join("%.3f" % v for v in iter_s),
                counts["hist"] / len(leaves),
                counts["partition"] / len(leaves)))
        # held-out metric after each iteration, from the predictor
        metric_params = {k: extra[k] for k in ("objective", "num_class",
                                               "ndcg_eval_at") if k in extra}
        metric = metric_cls(config(metric_params).metric_config)
        metric.init("test", metadata(label[n_train:], qb_held), n_test)
        curve = held_out(metric, booster, x[n_train:], iters)
        zero = metric.eval(np.zeros(n_test * per_iter))[0]
        say("%s held-out %s per iteration: %s (score 0: %.6f)" % (
            what, metric_name, " ".join("%.6f" % v for v in curve), zero))
        if name == "lambdarank":
            if not curve[-1] > curve[0]:
                fail("%s: held-out NDCG@5 does not rise" % what)
        elif not (all(b < a for a, b in zip(curve, curve[1:]))
                  and curve[0] < zero):
            fail("%s: held-out %s does not fall every iteration"
                 % (what, metric_name))
        if name == "multiclass":
            check_multiclass(what, booster, x, n_train, dev)
            served["c"] = booster.model_to_string()
        score = booster.score if per_iter > 1 else booster.score[0]
        grad_ms = timer(lambda: booster.objective.get_gradients(score),
                        reps=5)
        say("%s gradients at full width: %.4f ms" % (what, grad_ms))
        by_path[name] = {"hist": counts["hist"],
                         "partition": counts["partition"]}
        del booster, ds

    # int8 on the card against the CPU at the smaller size: regression
    # and multiclass trees equal; lambdarank gradients within tolerance
    n5 = sizes["n_int8"]
    small = {"num_leaves": 63, "num_iterations": 2, "hist_dtype": "int8",
             "max_bin": 255}
    for name, extra, label in (
            ("regression", {"objective": "regression"}, latent),
            ("multiclass", {"objective": "multiclass", "num_class": K},
             y_multi)):
        ds = lgt.Dataset.from_arrays(x[:n5], label[:n5].astype(np.float32),
                                     max_bin=255)
        params = dict(small, **extra)
        on_card = lgt.train(params, ds, device=dev)
        on_cpu = lgt.train(params, ds, device="cpu")
        value_diff = same_trees("phase 7 %s int8 cuda vs cpu" % name,
                                on_card, on_cpu)
        if value_diff > 1e-6:
            fail("phase 7 %s int8 leaf values differ by %g"
                 % (name, value_diff))
        say("phase 7 %s int8 %d x %d, 63 leaves, %d trees: cuda == cpu in "
            "structure and leaf_count; leaf values max abs diff %g" % (
                name, n5, F, len(on_card.models), value_diff))
    qb5 = rank_queries(n5, rng)
    ds = lgt.Dataset.from_arrays(x[:n5], y_rank[:n5], max_bin=255,
                                 query_boundaries=qb5)
    cfg = config({"objective": "lambdarank"})
    cpu = torch.device("cpu")
    objs = {}
    for d in (dev, cpu):
        objs[d.type] = create_objective("lambdarank", cfg.objective_config)
        objs[d.type].init(ds.metadata, n5, d)
    one = lgt.train(dict(small, objective="lambdarank", num_iterations=1,
                         hist_dtype="float32"), ds, device=dev)
    for what, score in (("score 0", torch.zeros(n5)),
                        ("after one iteration", one.score[0].cpu())):
        on_card = [t.cpu() for t in objs[dev.type].get_gradients(
            score.to(dev))]
        on_cpu = objs["cpu"].get_gradients(score)
        errs = []
        for a, b in zip(on_card, on_cpu):
            err = (a - b).abs()
            if not bool((err <= 1e-5 * b.abs() + 1e-7).all()):
                fail("phase 7 lambdarank gradients %s: cuda vs cpu max abs "
                     "err %g outside rtol 1e-5 / atol 1e-7"
                     % (what, float(err.max())))
            errs.append((float(err.max()), float((a == b).double().mean())))
        say("phase 7 lambdarank gradients %d rows in %d queries, %s: cuda "
            "vs cpu max abs err grad %g, hess %g (rtol 1e-5 / atol 1e-7); "
            "bitwise equal share %.6f, %.6f" % (
                n5, len(qb5) - 1, what, errs[0][0], errs[1][0], errs[0][1],
                errs[1][1]))
    params = dict(small, objective="lambdarank")
    same = (lgt.train(params, ds, device=dev).model_to_string()
            == lgt.train(params, ds, device="cpu").model_to_string())
    say("phase 7 lambdarank int8 %d rows, 63 leaves, 2 trees: cuda and cpu "
        "models %s (not required)" % (n5, "equal" if same else "differ"))
    return by_path


def per_tree_launches(what, booster, counts, per_iter=1):
    """Fail unless every tree took one histogram launch per leaf and one
    pane-entry partition per split (the compacted grower), iteration by
    iteration as ``drive`` counts them."""
    leaves = [t.num_leaves for t in booster.models]
    ends = [0] + counts["ends"]
    for it in range(len(leaves) // per_iter):
        got = ends[it + 1] - ends[it]
        want = sum(leaves[it * per_iter:(it + 1) * per_iter])
        if got != want:
            fail("%s iteration %d: %d histogram launches, %d leaves"
                 % (what, it + 1, got, want))
    splits = sum(leaves) - len(leaves)
    if not (counts["hist"] == sum(leaves)
            and counts["partition"] == len(counts["part_rows"]) == splits):
        fail("%s: %d histogram launches for %d leaves, %d partitions for "
             "%d splits" % (what, counts["hist"], sum(leaves),
                            counts["partition"], splits))
    return leaves


def record_bag_draws():
    """Wrap the device bagging draw so each draw's in-bag count and mask
    are kept; returns the list they go into."""
    from lightgbm_tpu_torch.ops import sampling
    draws = []
    inner = sampling.bag_mask_for_draw

    def recorded(*args, **kwargs):
        mask = inner(*args, **kwargs)
        draws.append(mask)
        return mask

    recorded.inner = getattr(inner, "inner", inner)
    sampling.bag_mask_for_draw = recorded
    return draws


def sampling_phase(dev, sizes, x, y, train_set, sync):
    """Phase 8: the reference example's sampled hot path (bagging and
    feature_fraction, the threefry draw on the card), GOSS, early
    stopping, continued training through the CLI, multiclass bagging
    (K draws a redraw), and int8 sampled trees on the card against the
    CPU.  Returns the launch counts of each path driven."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import compact, hist_cuda, sampling
    n_train, F = sizes["n_train"], x.shape[1]
    by_path = {}
    draws = record_bag_draws()
    try:
        # (a) examples/binary_classification/train.conf's hot path
        what = "phase 8a bagged"
        pa = {"objective": "binary", "num_leaves": 63, "max_bin": 255,
              "hist_dtype": "float32", "learning_rate": 0.1,
              "num_iterations": 10, "feature_fraction": 0.8,
              "bagging_fraction": 0.8, "bagging_freq": 5}
        booster, iter_s, counts = drive(pa, train_set, dev, sync)
        bag_cnt = int(0.8 * n_train)
        if not (len(draws) == 2 and all(int(m.sum()) == bag_cnt
                                        for m in draws)
                and not torch.equal(draws[0], draws[1])):
            fail("%s: %d draws with in-bag counts %s, expected 2 different "
                 "draws of %d" % (what, len(draws),
                                  [int(m.sum()) for m in draws], bag_cnt))
        leaves = per_tree_launches(what, booster, counts)
        if leaves != [63] * 10:
            fail("%s: leaves %s, expected 10 trees of 63" % (what, leaves))
        sums = [int(t.leaf_count.sum()) for t in booster.models]
        if not all(v == bag_cnt for v in sums):
            fail("%s: leaf counts sum to %s, not the %d in-bag rows"
                 % (what, sums, bag_cnt))
        say("%s %d x %d, 63 leaves, feature_fraction 0.8, bagging 0.8 "
            "every 5 (threefry on the card): 2 draws of %d rows, different; "
            "10 trees of 63 leaves over exactly the in-bag rows; 63 "
            "histogram launches and 62 partitions a tree; seconds per "
            "iteration %s" % (what, n_train, F, bag_cnt,
                              " ".join("%.3f" % v for v in iter_s)))
        check_model(what, booster, x, y, n_train, dev)
        by_path["bagged_leafcompact_float32"] = counts
        unsampled = {k: v for k, v in pa.items()
                     if k not in ("feature_fraction", "bagging_fraction",
                                  "bagging_freq")}
        unsampled["num_iterations"] = 5
        _, plain_s, _ = drive(unsampled, train_set, dev, sync)
        say("phase 8a unsampled, same settings, seconds per iteration %s "
            "(sampled mean %.4f, unsampled mean %.4f)" % (
                " ".join("%.3f" % v for v in plain_s),
                float(np.mean(iter_s)), float(np.mean(plain_s))))
        # the draw alone at 1M rows, host clock, synchronized: numpy's
        # choice plus the upload, against threefry on the card
        key = sampling.bag_key(3)
        reps = 5
        t0 = time.perf_counter()
        for r in range(reps):
            sampling.bag_mask_for_draw.inner(key, r, n_train, bag_cnt, dev)
        sync()
        device_ms = (time.perf_counter() - t0) / reps * 1e3
        rng = np.random.RandomState(3)
        t0 = time.perf_counter()
        for _ in range(reps):
            mask = np.zeros(n_train, dtype=bool)
            mask[rng.choice(n_train, bag_cnt, replace=False)] = True
            torch.from_numpy(mask).to(dev)
        sync()
        host_ms = (time.perf_counter() - t0) / reps * 1e3
        say("phase 8a mask draw at %d rows, %d in-bag: numpy choice + "
            "upload %.3f ms, threefry on the card %.3f ms (host clock, "
            "synchronized, mean of %d)" % (n_train, bag_cnt, host_ms,
                                           device_ms, reps))

        # (b) GOSS
        what = "phase 8b goss"
        pb = dict(unsampled, goss="true", top_rate=0.2, other_rate=0.1,
                  num_iterations=3)
        booster, iter_s, counts = drive(pb, train_set, dev, sync)
        leaves = per_tree_launches(what, booster, counts)
        top_cnt, other_cnt, _ = sampling.goss_counts(n_train, 0.2, 0.1)
        sums = [int(t.leaf_count.sum()) for t in booster.models]
        if len(leaves) != 3 or not all(v == top_cnt + other_cnt
                                       for v in sums):
            fail("%s: %d trees over %s rows, expected 3 over %d"
                 % (what, len(leaves), sums, top_cnt + other_cnt))
        say("%s 0.2 / 0.1: 3 trees of %s leaves, each over exactly %d + %d "
            "rows; one histogram launch a leaf, one partition a split; "
            "seconds per iteration %s" % (
                what, leaves, top_cnt, other_cnt,
                " ".join("%.3f" % v for v in iter_s)))
        by_path["goss_leafcompact_float32"] = counts

        # (c) early stopping on a training slice small enough to overfit,
        # against the held-out rows
        what = "phase 8c early stopping"
        n_es = sizes["n_es"]
        es_train = lgt.Dataset.from_arrays(x[:n_es], y[:n_es], max_bin=255,
                                           reference=train_set)
        es_valid = lgt.Dataset.from_arrays(x[n_train:], y[n_train:],
                                           max_bin=255, reference=train_set)
        pc = {"objective": "binary", "metric": "binary_logloss",
              "num_leaves": 255, "min_data_in_leaf": 5,
              "min_sum_hessian_in_leaf": 0.001, "learning_rate": 0.5,
              "max_bin": 255, "early_stopping_round": 3,
              "bagging_fraction": 0.8, "bagging_freq": 1}
        from lightgbm_tpu_torch.config import OverallConfig
        from lightgbm_tpu_torch.metrics import create_metrics
        from lightgbm_tpu_torch.objectives import create_objective
        cfg = OverallConfig()
        cfg.set({k: str(v) for k, v in pc.items()}, require_data=False)
        es = lgt.GBDT()
        es.init(cfg.boosting_config, es_train,
                create_objective("binary", cfg.objective_config),
                device=dev)
        es.add_valid_dataset(es_valid, create_metrics(cfg))
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "model.txt")
            reset_counts()
            es.run_training(60, True,
                            save_fn=lambda: es.save_model_to_file(False,
                                                                  path))
            sync()
            es_counts = {"hist": hist_cuda.launches,
                         "partition": compact.launches}
            es.save_model_to_file(True, path)
            with open(path) as f:
                text = f.read()
            loaded = lgt.GBDT.from_model_file(path, device=dev)
        best = es.best_iter[0][0]
        if not (es.iter < 60 and es.iter - best == 3
                and len(es.models) == es.iter - 3 == best):
            fail("%s: stopped at %d (best %d) with %d trees, expected a "
                 "stop 3 past the best and %d trees"
                 % (what, es.iter, best, len(es.models), es.iter - 3))
        if not (text.count("Tree=") == len(es.models)
                and text == es.model_to_string()):
            fail("%s: the saved file holds %d trees, the booster %d"
                 % (what, text.count("Tree="), len(es.models)))
        pred = loaded.predict(x[n_train:])
        if not np.allclose(pred, es.predict(x[n_train:]), rtol=0,
                           atol=1e-12):
            fail("%s: the reloaded model predicts differently" % what)
        say("%s: %d-row training slice, held-out logloss best at "
            "iteration %d (%.6f), stopped at %d, 3 trees popped; the saved "
            "file holds the %d kept trees and reloads to the same "
            "predictions" % (what, n_es, best, es.best_score[0][0], es.iter,
                             len(es.models)))
        by_path["early_stopping_leafcompact_float32"] = es_counts
        del es, loaded, es_train, es_valid

        # (d) continued training through the CLI on the card
        by_path.update(continue_phase(dev, sizes, x, y, sync))

        # (e) multiclass K = 5 with bagging: K draws a redraw iteration
        what = "phase 8e multiclass bagged"
        K = 5
        rng = np.random.RandomState(SEED + 8)
        proj = rng.randn(F, K) / np.sqrt(F)
        y_multi = np.argmax(x[:n_train] @ proj + 0.5 * rng.randn(n_train, K),
                            1).astype(np.float32)
        ds = lgt.Dataset.from_arrays(x[:n_train], y_multi, max_bin=255,
                                     reference=train_set)
        pe = dict(unsampled, objective="multiclass", num_class=K,
                  num_iterations=2, bagging_fraction=0.8, bagging_freq=1)
        draws.clear()
        booster, iter_s, counts = drive(pe, ds, dev, sync)
        leaves = per_tree_launches(what, booster, counts, per_iter=K)
        masks = [m for m in draws]
        if not (len(leaves) == 2 * K and len(masks) == 2 * K
                and all(int(m.sum()) == bag_cnt for m in masks)
                and all(not torch.equal(a, b)
                        for a, b in zip(masks, masks[1:]))):
            fail("%s: %d trees, %d draws (%s in-bag), expected %d of each, "
                 "all different" % (what, len(leaves), len(masks),
                                    [int(m.sum()) for m in masks], 2 * K))
        say("%s K = %d, bagging 0.8 every iteration: %d class trees, %d "
            "draws of %d rows (one per class tree), all different; one "
            "histogram launch a leaf, one partition a split; seconds per "
            "iteration %s" % (what, K, len(leaves), len(masks), bag_cnt,
                              " ".join("%.3f" % v for v in iter_s)))
        by_path["multiclass_bagged_leafcompact_float32"] = counts
        del booster, ds, masks
        draws.clear()
    finally:
        sampling.bag_mask_for_draw = sampling.bag_mask_for_draw.inner

    # (f) int8 sampled trees on the card against the CPU
    n5 = sizes["n_int8"]
    small = lgt.Dataset.from_arrays(x[:n5], y[:n5], max_bin=255)
    for grower in ({}, {"grow_policy": "depthwise"}):
        for extra in ({"bagging_device": "true", "bagging_fraction": 0.8,
                       "bagging_freq": 1, "feature_fraction": 0.8},
                      {"goss": "true", "feature_fraction": 0.8}):
            pf = dict({"objective": "binary", "num_leaves": 63,
                       "num_iterations": 2, "hist_dtype": "int8",
                       "max_bin": 255}, **grower, **extra)
            name = "%s %s" % (grower.get("grow_policy", "compacted"),
                              "goss" if "goss" in extra else "bagging")
            on_card = lgt.train(pf, small, device=dev)
            on_cpu = lgt.train(pf, small, device="cpu")
            value_diff = same_trees("phase 8f int8 %s cuda vs cpu" % name,
                                    on_card, on_cpu)
            if value_diff > 1e-6 or \
                    on_card.model_to_string() != on_cpu.model_to_string():
                fail("phase 8f int8 %s: cuda and cpu models differ (leaf "
                     "values by %g)" % (name, value_diff))
            say("phase 8f int8 %s + feature_fraction 0.8, %d x %d, 63 "
                "leaves, 2 trees: cuda == cpu, model text byte for byte"
                % (name, n5, F))
    return {k: {"hist": v["hist"], "partition": v["partition"]}
            for k, v in by_path.items()}


def continue_phase(dev, sizes, x, y, sync):
    """Phase 8d: ``task=train input_model=...`` on the card: 3 + 3
    iterations give 6 trees, the first 3 as the input model wrote them,
    and the training score starts from the continuation score (every
    input tree summed in float64, rounded once)."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.cli import main as cli_main
    from lightgbm_tpu_torch.models.predictor import continuation_score
    from lightgbm_tpu_torch.ops import compact, hist_cuda
    what = "phase 8d continued training"
    n = sizes["n_cli"]
    starts = []
    init = lgt.GBDT.init

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        starts.append(self.score.clone())

    with tempfile.TemporaryDirectory() as tmp:
        train = os.path.join(tmp, "train.tsv")
        np.savetxt(train, np.column_stack([y[:n], x[:n]]), delimiter="\t",
                   fmt="%.17g")
        base = ["task=train", "data=" + train, "objective=binary",
                "num_leaves=63", "max_bin=255", "num_iterations=3",
                "feature_fraction=0.8", "bagging_fraction=0.8",
                "bagging_freq=1", "device=" + str(dev)]
        m1, m2 = os.path.join(tmp, "m1.txt"), os.path.join(tmp, "m2.txt")
        if cli_main(base + ["output_model=" + m1]) != 0:
            fail("%s: the first CLI run failed" % what)
        lgt.GBDT.init = recording_init
        try:
            reset_counts()
            rc = cli_main(base + ["input_model=" + m1, "output_model=" + m2])
            sync()
            counts = {"hist": hist_cuda.launches,
                      "partition": compact.launches}
        finally:
            lgt.GBDT.init = init
        if rc != 0:
            fail("%s: the continuing CLI run failed" % what)
        with open(m1) as f:
            first = f.read()
        with open(m2) as f:
            second = f.read()
    blocks = lambda text: ["Tree=" + b.split("\n\n")[0]    # noqa: E731
                           for b in text.split("\nTree=")[1:]]
    b1, b2 = blocks(first), blocks(second)
    if not (len(b1) == 3 and len(b2) == 6 and b2[:3] == b1):
        fail("%s: %d + 3 iterations gave %d trees; the first 3 %s the "
             "input model's" % (what, len(b1), len(b2),
                                "equal" if b2[:3] == b1 else "differ from"))
    cont = lgt.GBDT()
    cont.models_from_string(first)
    want = continuation_score(cont.models, x[:n], dev)
    got = starts[0][0].cpu().numpy() if starts else None
    if got is None or not np.array_equal(got, want):
        fail("%s: the training score does not start from the continuation "
             "score" % what)
    say("%s through the CLI on the card, %d rows, bagging and "
        "feature_fraction: 3 + 3 iterations give 6 trees, the first 3 the "
        "input model's text; the start score equals the float64 sum of "
        "the input trees (rounded once) on all %d rows" % (what, n, n))
    return {"continued_leafcompact_float32": counts}


def check_multiclass(what, booster, x, n_train, dev):
    """Trees interleaved per class (tree i updated score[i % K]), softmax
    rows that sum to 1, and a saved model that reloads and predicts the
    held-out rows identically."""
    import lightgbm_tpu_torch as lgt
    K = booster.num_class
    n = min(n_train, 20_000)
    raw = booster.predict_raw(x[:n])
    err = float(np.abs(raw - booster.score[:, :n].cpu().numpy()).max())
    if not err < 1e-4:
        fail("%s: trees do not replay the per-class training scores (max "
             "abs err %g)" % (what, err))
    prob = booster.predict_multiclass(x[n_train:])
    row_err = float(np.abs(prob.sum(1) - 1.0).max())
    if not (prob.shape == (len(x) - n_train, K) and row_err <= 1e-6):
        fail("%s: predicted rows are not [N, %d] summing to 1 (%g)"
             % (what, K, row_err))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.txt")
        booster.save_model_to_file(True, path)
        loaded = lgt.GBDT.from_model_file(path, device=dev)
    if not (loaded.num_class == K
            and np.allclose(loaded.predict_multiclass(x[n_train:]), prob,
                            rtol=0, atol=1e-12)):
        fail("%s: reloaded model predicts differently" % what)
    say("%s: %d trees interleaved per class (training scores replayed, max "
        "abs err %g); held-out rows sum to 1 within %g; saved + reloaded "
        "model predicts identically" % (what, len(booster.models), err,
                                        row_err))


def wide_phase(dev, sizes, x, y, sync, timer):
    """Phase 10, 16-bit bins, on the main path's table binned at
    ``max_bin=1023`` (1022 bins a column):

    (a) the histogram kernel's float and int8 modes at C = 1, 8 and 64
        on all rows (C = 64 cuts each feature's cells into slices), the
        pane entry over a full segment of a 16-bit pane and the
        partition of the root on a 16-bit key, and the B = 50,000 corner
        (``max_bin=65535``; the 50,000-row bin sample caps num_bin) at
        C = 1: each against its plain version (int8 and the partition
        exact; float within 1e-5 of each cell's absolute sum, against a
        float64 plain sum), timed beside its bound (2 bytes a bin) and
        the library call (``scatter_add_`` on a prebuilt index; a stable
        ``torch.sort`` and gather for the partition);
    (b) the main path at ``max_bin=1023`` (255 leaves, float32,
        compacted, 5 iterations): one histogram launch a leaf and one
        partition a split, held-out AUC, falling logloss, save and
        reload; the first tree's launches replayed (``tree_ms``); then
        at ``n_int8`` rows int8 compacted and depth-wise trees on the
        card equal to the CPU's, and compacted equal to masked;
    (c) bench.py's headline configuration (depth-wise int8, 255 leaves)
        on its table at ``max_bin=1023``, packed (widths 64 and 1022, two
        launches a pass) against ``mixed_bin=false``: model text
        byte-equal.

    Returns the records of the 16-bit modes for the kernels line."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import compact, hist_cuda
    from lightgbm_tpu_torch.ops.bins import widen
    from lightgbm_tpu_torch.ops.hist_cuda import quantize_values
    n_train, n_test, F = sizes["n_train"], sizes["n_test"], x.shape[1]
    N = n_train
    t0 = time.perf_counter()
    train_set = lgt.Dataset.from_arrays(x[:n_train], y[:n_train],
                                        max_bin=1023)
    B = int(train_set.num_bins.max())
    bins = train_set.to_device(dev)["bins"]
    if bins.dtype != torch.int16 or B <= 256:
        fail("phase 10: %s bins, num_bin max %d; expected 16-bit bins"
             % (bins.dtype, B))
    say("phase 10 dataset: %d x %d binned at max_bin=1023 in %.1f s "
        "(uint16, num_bin max %d)" % (N, F, time.perf_counter() - t0, B))
    gen = np.random.RandomState(SEED + 10)
    grad = torch.as_tensor(gen.randn(N).astype(np.float32), device=dev)
    hess = torch.as_tensor(gen.rand(N).astype(np.float32), device=dev)
    # the pane's float launches are timed with one exponent, as a tree's
    tree_e = hist_cuda.fixed_exponent(grad, hess, N)

    def hbound(n, Fc, Bc, C, side, bin_bytes=2):
        return (bin_bytes * n * Fc + side * n + Fc * Bc * 3 * C * 4) \
            / HBM_BYTES_PER_S * 1e3

    def kernel_shape(b, Bc, C, mode):
        """One launch of a mode at (F, N, B, C) against its plain
        version, timed; returns its record."""
        Fc, n = b.shape
        cid = torch.as_tensor(np.where(gen.rand(n) < 0.9,
                                       gen.randint(0, C, n), -1)
                              .astype(np.int32), device=dev)
        ok = cid >= 0
        if mode == "int8":
            levels, _ = quantize_values(grad[:n], hess[:n], ok)
            src = levels.t().to(torch.int32)
            run_k = lambda: hist_cuda.hist_int8(b, levels, cid, C, Bc)
            plain = lambda: hist_cuda.hist_plain(b, src, cid, C, Bc)
            if not torch.equal(run_k(), plain()):
                fail("phase 10a hist int8 F=%d B=%d C=%d not bitwise"
                     % (Fc, Bc, C))
            err = 0.0
        else:
            src = torch.stack([grad[:n], hess[:n], torch.ones_like(grad[:n])],
                              1)
            shape_e = hist_cuda.fixed_exponent(grad[:n], hess[:n], n)
            run_k = lambda: hist_cuda.hist_float(b, grad[:n], hess[:n], cid,
                                                 C, Bc, shape_e)
            plain = lambda: hist_cuda.hist_plain(b, src, cid, C, Bc)
            what = "phase 10a F=%d B=%d C=%d" % (Fc, Bc, C)
            err = float64_err(what, twice(what, run_k), b, grad[:n],
                              hess[:n], cid, C, Bc)
        idx = (torch.arange(Fc, device=dev)[:, None] * Bc
               + widen(b).long()) * C + cid.long().clamp(0, C - 1)[None, :]
        idx = torch.where(ok[None, :], idx, Fc * Bc * C)
        idx3 = idx.reshape(-1, 1).expand(-1, 3)
        src3 = src[None].expand(Fc, n, 3).reshape(-1, 3)
        acc = torch.zeros((Fc * Bc * C + 1, 3), dtype=src.dtype, device=dev)
        rec = {"F": Fc, "N": n, "B": Bc, "C": C, "mode": mode,
               "slices": -(-Bc * C * hist_cuda.CELL_BYTES[
                   "int8" if mode == "int8" else "float"]
                   // hist_cuda.SLICE_BYTES),
               "max_abs_err": err, "ms": timer(run_k),
               "plain_ms": timer(plain),
               "bound_ms": hbound(n, Fc, Bc, C, 7 if mode == "int8" else 12),
               "bound_by": "bytes",
               "library_ms": timer(lambda: acc.scatter_add_(0, idx3, src3))}
        del idx, idx3, src3, acc
        say("phase 10a hist %s F=%d N=%d B=%d C=%d (%d slices): %.4f ms "
            "(plain %.4f, library %.4f, bound %.4f), max abs err %.3g" % (
                mode, Fc, n, Bc, C, rec["slices"], rec["ms"],
                rec["plain_ms"], rec["library_ms"], rec["bound_ms"], err))
        return rec

    # ---- 10a: the kernels at 16-bit widths
    shapes = [kernel_shape(bins, B, C, mode)
              for C in sizes["wide_cols"] for mode in ("float32", "int8")]
    # the pane entry over a full segment of the 16-bit pane (72 rows at
    # F = 28), all rows valid
    P = compact.bucket_table(N)[0]
    pane = compact.pack_planes(bins, grad, hess,
                               torch.ones(N, dtype=torch.bool, device=dev), P)
    R = pane.shape[0]
    if R != compact.pane_rows(F, 2):
        fail("phase 10a: 16-bit pane of %d rows" % R)
    n = N - 2000
    got = twice("phase 10a pane", lambda: hist_cuda.hist_pane_float(
        pane, F, 1001, n, B, None, 2))
    pb, pg, ph, pvalid = compact.unpack_values(pane[:, 1001:1001 + n], F, 2)
    pane_err = float64_err("phase 10a pane", got.reshape(F, B, 3), pb, pg,
                           ph, torch.where(pvalid, 0, -1).to(torch.int32),
                           1, B)
    del pb
    pane_rec = {
        "F": F, "N": n, "B": B, "C": 1, "max_abs_err": pane_err,
        "ms": timer(lambda: hist_cuda.hist_pane_float(pane, F, 1001, n, B,
                                                      None, 2, tree_e)),
        "plain_ms": timer(lambda: hist_cuda.pane_plain(
            pane[:, 1001:1001 + n], F, B, None, 2)),
        "bound_ms": (n * (2 * F + 9) + F * B * 3 * 4)
        / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": pane_library_ms(timer, pane[:, 1001:1001 + n], F, B,
                                      None, 2)}
    say("phase 10a hist pane, 16-bit pane of %d rows, %d lanes: %.4f ms "
        "(plain %.4f, library %.4f, bound %.4f), max abs err %.3g" % (
            R, n, pane_rec["ms"], pane_rec["plain_ms"],
            pane_rec["library_ms"], pane_rec["bound_ms"], pane_err))
    # the partition of the root on a 16-bit key: bins of feature 3 against
    # a threshold whose low byte alone would split the rows otherwise
    feat, thr = 3, 511
    dst0 = torch.as_tensor(gen.randint(-128, 128, (R, P)).astype(np.int8),
                           device=dev)
    for what, start, cnt, thr_ in (("root", 0, N, thr),
                                   ("offset", 1001, N // 2, 700),
                                   ("one launch", 3,
                                    compact.ONE_LAUNCH_TILES * compact.TILE
                                    - 3, 300),
                                   ("one tile", 13, compact.TILE - 13, 256)):
        got_d, want_d = dst0.clone(), dst0.clone()
        left = compact.partition_pane(pane, got_d, F, feat, thr_, start, cnt,
                                      2)
        want_left = compact.pane_plain(pane, want_d, feat, thr_, start, cnt,
                                       F + feat)
        sync()
        if not (torch.equal(got_d, want_d)
                and int(left) == int(want_left)):
            fail("phase 10a partition 16-bit %s not byte-exact" % what)
        say("phase 10a partition pane 16-bit %s R=%d start=%d cnt=%d thr=%d:"
            " byte-exact, left %d, other lanes untouched" % (
                what, R, start, cnt, thr_, int(left)))
    keys = (widen(bins[feat]) > thr).to(torch.int8)
    part_rec = {
        "name": "partition16", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/partition.cu",
        "replaces": "lightgbm_tpu/ops/compact.py:393",
        "max_abs_err": 0,
        "ms": timer(lambda: compact.partition_pane(pane, dst0, F, feat, thr,
                                                   0, N, 2)),
        "plain_ms": timer(lambda: compact.pane_plain(pane, dst0, feat, thr,
                                                     0, N, F + feat)),
        "bound_ms": 2 * R * N / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": timer(lambda: pane[:, :N][:, torch.sort(
            keys, stable=True).indices])}
    say("phase 10a partition16 root R=%d cnt=%d: %.4f ms (plain %.4f, "
        "library %.4f, bound %.4f)" % (R, N, part_rec["ms"],
                                       part_rec["plain_ms"],
                                       part_rec["library_ms"],
                                       part_rec["bound_ms"]))
    del dst0, keys
    # the B = 50,000 corner: max_bin=65535 on the same columns
    t0 = time.perf_counter()
    corner_set = lgt.Dataset.from_arrays(x[:n_train], y[:n_train],
                                         max_bin=65535)
    B50 = int(corner_set.num_bins.max())
    bins50 = corner_set.to_device(dev)["bins"]
    say("phase 10a corner: max_bin=65535 binned in %.1f s, num_bin max %d"
        % (time.perf_counter() - t0, B50))
    if B50 < 40_000:
        fail("phase 10a corner: num_bin max %d, expected about 50,000" % B50)
    corner = [kernel_shape(bins50, B50, 1, mode)
              for mode in ("float32", "int8")]
    del bins50, corner_set

    # ---- 10b: the main path at max_bin=1023
    params = {"objective": "binary", "num_leaves": 255, "num_iterations": 5,
              "learning_rate": 0.1, "hist_dtype": "float32",
              "max_bin": 1023}
    booster, main_s, counts = drive(params, train_set, dev, sync)
    leaves = [t.num_leaves for t in booster.models]
    splits = sum(leaves) - len(leaves)
    if len(leaves) != 5 or booster.bins_device.dtype != torch.int16:
        fail("phase 10b: %d trees on %s bins" % (len(leaves),
                                                 booster.bins_device.dtype))
    if not (counts["hist"] == len(counts["hist_rows"]) == sum(leaves)
            and counts["partition"] == len(counts["part_rows"]) == splits):
        fail("phase 10b: launches hist %d partition %d, expected %d and %d"
             % (counts["hist"], counts["partition"], sum(leaves), splits))
    say("phase 10b main path at max_bin=1023: %d trees, leaves %s, seconds "
        "per iteration %s; launches: hist %d (one a leaf), partition %d "
        "(one a split), %d partition kernels" % (
            len(leaves), leaves, " ".join("%.3f" % v for v in main_s),
            counts["hist"], counts["partition"],
            counts["partition_kernels"]))
    check_model("phase 10b", booster, x, y, n_train, dev)
    by_path = {"leafcompact_float32_maxbin1023": counts}
    # the first tree's launches replayed: each histogram through the pane
    # entry, each partition through the 16-bit key, at their own sizes
    first_rows = counts["hist_rows"][:leaves[0]]
    first_parts = counts["part_rows"][:leaves[0] - 1]
    hist_tree = [0.0, 0.0]
    for n_ in first_rows:
        start = min(1001, P - n_)
        hist_tree[0] += timer(lambda: hist_cuda.hist_pane_float(
            pane, F, start, n_, B, None, 2, tree_e), reps=5)
        hist_tree[1] += (n_ * (2 * F + 9) + F * B * 3 * 4) \
            / HBM_BYTES_PER_S * 1e3
    dst = torch.empty_like(pane)
    part_tree = [0.0, 0.0]
    for n_ in first_parts:
        start = min(1001, P - n_)
        part_tree[0] += timer(lambda: compact.partition_pane(
            pane, dst, F, feat, thr, start, n_, 2), reps=5)
        part_tree[1] += 2 * R * n_ / HBM_BYTES_PER_S * 1e3
    del dst
    say("phase 10b first tree replayed: hist %d launches %.4f ms (bound "
        "%.4f), partition %d launches %.4f ms (bound %.4f)" % (
            len(first_rows), hist_tree[0], hist_tree[1], len(first_parts),
            part_tree[0], part_tree[1]))
    # int8 at n_int8 rows: card == CPU (compacted, depth-wise), compacted
    # == masked on the card
    n5 = sizes["n_int8"]
    small = lgt.Dataset.from_arrays(x[:n5], y[:n5], max_bin=1023)
    p5 = {"objective": "binary", "num_leaves": 63, "num_iterations": 2,
          "hist_dtype": "int8", "max_bin": 1023}
    models = {}
    for name, extra in (("compacted", {}),
                        ("depthwise", {"grow_policy": "depthwise",
                                       "num_leaves": 255,
                                       "min_data_in_leaf": 100,
                                       "min_sum_hessian_in_leaf": 10}),
                        ("masked", {"leafwise_compact": "false"})):
        on_card, _, c = drive(dict(p5, **extra), small, dev, sync)
        if c["hist"] == 0 or (c["partition"] == 0) != (name != "compacted"):
            fail("phase 10b int8 %s: launches %s" % (
                name, {k: c[k] for k in ("hist", "partition")}))
        by_path["%s_int8_maxbin1023" % name] = c
        models[name] = on_card.model_to_string()
        if name != "masked":
            on_cpu = lgt.train(dict(p5, **extra), small, device="cpu")
            if models[name] != on_cpu.model_to_string():
                fail("phase 10b int8 %s: card and CPU models differ" % name)
            say("phase 10b int8 %s %d x %d, leaves %s, 2 trees: model text "
                "on the card equals the CPU's; launches hist %d, partition "
                "%d" % (name, n5, F, [t.num_leaves for t in on_card.models],
                        c["hist"], c["partition"]))
    if models["compacted"] != models["masked"]:
        fail("phase 10b int8: compacted and masked models differ")
    say("phase 10b int8 compacted and masked: model text equal on the card")
    del pane, bins, train_set, small

    # ---- 10c: the headline configuration at max_bin=1023
    xm, ym = make_mixed(n_train + n_test, F, SEED, 24)
    mixed = lgt.Dataset.from_arrays(xm[:n_train], ym[:n_train],
                                    max_bin=1023)
    spec = mixed.plan_packing("auto")
    if spec is None or spec.widths != (64, int(mixed.num_bins.max())) \
            or spec.widths[1] <= 256:
        fail("phase 10c: plan %s, expected widths 64 and about 1022"
             % (spec,))
    pd = {"objective": "binary", "grow_policy": "depthwise",
          "hist_dtype": "int8", "num_leaves": 255, "min_data_in_leaf": 100,
          "min_sum_hessian_in_leaf": 10, "learning_rate": 0.1,
          "max_bin": 1023, "num_iterations": 5}
    texts, secs = {}, {}
    for name, mixed_bin in (("packed", "auto"), ("uniform", "false")):
        booster, iter_s, c = drive(dict(pd, mixed_bin=mixed_bin), mixed,
                                   dev, sync)
        # per tree: the root, then each level pass in groups of at most
        # 42 columns, each launched once per bin-width class
        per_pass = 2 if name == "packed" else 1
        want = sum(per_pass * (1 + sum(-(-(1 << d) // 42)
                                       for d in range(level_passes(t, 255))))
                   for t in booster.models)
        if c["hist"] != want or c["partition"] != 0:
            fail("phase 10c %s: launches hist %d partition %d, expected %d "
                 "and 0" % (name, c["hist"], c["partition"], want))
        if max(c["hist_cols"]) > 42:
            fail("phase 10c %s: a pass of %d columns; 16-bit passes group "
                 "at 42" % (name, max(c["hist_cols"])))
        texts[name] = booster.model_to_string()
        secs[name] = iter_s
        by_path["headline_depthwise_int8_maxbin1023_" + name] = c
        say("phase 10c headline %s at max_bin=1023 (plan %s): leaves %s, "
            "seconds per iteration %s, histogram launches %d (widest pass "
            "%d columns)" % (name, "x".join(map(str, spec.widths))
                             if name == "packed" else "uniform",
                             [t.num_leaves for t in booster.models],
                             " ".join("%.3f" % v for v in iter_s), c["hist"],
                             max(c["hist_cols"])))
        if name == "packed":
            check_model("phase 10c", booster, xm, ym, n_train, dev)
    if texts["packed"] != texts["uniform"]:
        fail("phase 10c: the packed model differs from mixed_bin=false's")
    say("phase 10c headline at max_bin=1023: packed and mixed_bin=false "
        "model text byte-equal")

    main_rec = next(r for r in shapes if r["C"] == 1 and r["mode"] ==
                    "float32")
    launches_by_path = {k: v["hist"] for k, v in by_path.items()}
    hist16 = dict(
        {"name": "hist16", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/hist.cu",
         "replaces": "lightgbm_tpu/ops/hist_pallas.py:86",
         "launches": by_path["leafcompact_float32_maxbin1023"]["hist"]},
        **{k: main_rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
        shapes=shapes, pane=pane_rec, corner_b50000=corner,
        tree_ms=hist_tree[0], tree_bound_ms=hist_tree[1],
        launches_by_path=launches_by_path,
        seconds_by_path={"leafcompact_float32_maxbin1023": main_s,
                         **{"headline_" + k: v for k, v in secs.items()}})
    part_rec.update(
        launches=by_path["leafcompact_float32_maxbin1023"]["partition"],
        kernel_launches=by_path["leafcompact_float32_maxbin1023"][
            "partition_kernels"],
        tree_ms=part_tree[0], tree_bound_ms=part_tree[1],
        launches_by_path={k: v["partition"] for k, v in by_path.items()})
    return {"hist16": hist16, "partition16": part_rec}


def scan_vs_bfs(flat, codes, tables):
    """The JAX package's ``predict_algo=scan`` walk
    (lightgbm_tpu/ops/scoring.py:89-117), rebuilt from the port's
    ``leaf_ids_by_replay``: each tree's splits replayed in turn, its leaf
    values added into its class row in tree order.  The port refuses
    ``scan``; this records why.  On all of ``codes``' rows the replay
    must give the breadth-first walk's float32 scores bitwise; then both
    are timed at 1, 1,024 and all the rows on the host clock with a
    device synchronize (the better of 2 calls: one replay call launches
    ~5 small operations a split)."""
    import torch
    from lightgbm_tpu_torch.ops import scoring

    def replay(c):
        out = torch.zeros((flat.num_class, c.shape[1]), dtype=torch.float32,
                          device=c.device)
        for t in range(flat.num_trees):
            n = int(flat.num_leaves[t]) - 1
            leaf = scoring.leaf_ids_by_replay(
                c, flat.split_feature[t, :n], flat.threshold_rank[t, :n],
                flat.left_child[t, :n], flat.right_child[t, :n])
            out[int(flat.tree_class[t])].add_(tables["lv"][t][leaf])
        return out

    def bfs(c):
        return scoring.bfs_scores(
            c, tables["sf"], tables["tr"], tables["lc"], tables["rc"],
            tables["lv"], tables["root"], flat.tree_class,
            max_depth=flat.max_depth, num_class=flat.num_class)

    def wall_ms(fn, c):
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(c)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    if not torch.equal(replay(codes), bfs(codes)):
        fail("phase 11 (b): the per-tree replay's scores differ from the "
             "breadth-first walk's")
    rec = {}
    for n in (1, 1024, codes.shape[1]):
        c = codes[:, :n].contiguous()
        rec[str(n)] = {"scan_ms": wall_ms(replay, c),
                       "bfs_ms": wall_ms(bfs, c)}
    say("phase 11 (b) float32, the walk alone on the host clock, per-tree "
        "replay (predict_algo=scan, refused) against breadth-first, equal "
        "bitwise: %s" % " ".join(
            "%s rows %.3f / %.3f ms" % (n, v["scan_ms"], v["bfs_ms"])
            for n, v in rec.items()))
    return rec


def serving_phase(dev, sizes, x, train_set, served, sync, timer):
    """Phase 11: the serving engine on the card, over three models at
    full width (28 features, 255 leaves): (a) phase 4's compacted model,
    the deepest trees; (b) a depth-wise int8 model of ``serve_iters``
    iterations (bench.py's headline configuration on the main-path
    table), trained here; (c) phase 7's multiclass K = 5 model.

    For each model and leaf table (float32, int8), the held-out rows go
    through ``ServingEngine`` on the card at every bucket of the default
    ladder (1, 32, 1024 and 65,536 rows, the last in two chunks);
    scores and leaf indices must be bitwise the CPU engine's on the same
    rows (for (b) on ``serve_cpu_rows`` of them), and float32 scores
    within rtol 1e-5 / atol 1e-5 of the float64 raw-feature walk
    (``GBDT.predict_raw``).  ``scores()`` is timed per bucket on the
    host clock, encode and read-back included (p50 and p99 of 50 calls,
    10 at 65,536), and the walk alone on the device at 65,536 rows
    beside its bound, the least it must move (the codes and node tables
    read once, the [K, N] scores written once) over the card's memory
    rate, and beside this implementation's own traffic (max_depth x 6
    [T, N] int32 intermediates and the codes).  On (b) float32 the JAX
    package's per-tree replay (``predict_algo=scan``, which the port
    refuses) is timed beside the breadth-first walk at 1, 1,024 and
    65,536 rows, and must give its scores bitwise.  Then a ServingFront
    over (b) float32 with 8 client threads for ``front_s`` seconds, each
    submitting 1-32 rows and waiting for them, swaps to (b) int8 half
    way: every request must resolve, on float32 before the swap began
    and on int8 after it ended, never back, and equal to its rows scored
    on that engine: every request within one batch of all requests'
    rows, and 1,000 of them alone.  Last, ``python -m lightgbm_tpu_torch
    task=predict`` on the held-out rows with (b), with
    ``predict_leaf_index=true`` and with ``predict_quantize=int8``: the
    card's result files byte-equal to ``device=cpu``'s.  Neither kernel
    may launch in this process while it serves: the counts cover the
    engines and the front; the ``task=predict`` runs are subprocesses,
    whose launches these counts cannot see.  Prints a ``{"serving": ...}``
    line; returns the launch counts of (b)'s training and of serving."""
    import threading
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import serving
    from lightgbm_tpu_torch.ops import compact, hist_cuda, scoring
    n_train, n_test = sizes["n_train"], sizes["n_test"]
    x_test = x[n_train:]
    t_phase = time.perf_counter()
    by_path = {}
    # (b): bench.py's headline configuration (bench.py:1277-1289) on the
    # main-path table, at a realistic ensemble size
    pd = {"objective": "binary", "grow_policy": "depthwise",
          "hist_dtype": "int8", "num_leaves": 255, "min_data_in_leaf": 100,
          "min_sum_hessian_in_leaf": 10, "learning_rate": 0.1,
          "max_bin": 255, "num_iterations": sizes["serve_iters"]}
    booster, iter_s, counts = drive(pd, train_set, dev, sync)
    if len(booster.models) != sizes["serve_iters"] or counts["hist"] == 0 \
            or counts["partition"] != 0:
        fail("phase 11 (b): %d trees, launches hist %d partition %d"
             % (len(booster.models), counts["hist"], counts["partition"]))
    by_path["depthwise_int8_serving_model"] = counts
    served["b"] = booster.model_to_string()
    say("phase 11 (b) depthwise int8 %d x 28, 255 leaves, %d trees trained "
        "in %.1f s (median %.4f s an iteration), histogram launches %d"
        % (n_train, len(booster.models), sum(iter_s), np.median(iter_s),
           counts["hist"]))
    del booster

    def rows_per_bucket(eng):
        return [(b, x_test[:min(b, n_test)]) for b in eng.buckets[:-1]] \
            + [(eng.buckets[-1], x_test)]

    rec = {"models": {}}
    tmp = tempfile.mkdtemp()
    paths, boosters = {}, {}
    reset_counts()
    for name in ("a", "b", "c"):
        paths[name] = os.path.join(tmp, "model_%s.txt" % name)
        with open(paths[name], "w") as f:
            f.write(served[name])
        booster = lgt.GBDT.from_model_file(paths[name], device=dev)
        boosters[name] = booster
        flat = booster.export_flat()
        T, K, F_used = flat.num_trees, flat.num_class, len(flat.used)
        cpu_rows = n_test if name != "b" else sizes["serve_cpu_rows"]
        mrec = {"trees": T, "num_class": K, "max_depth": flat.max_depth,
                "max_leaves": int(flat.num_leaves.max()),
                "features_used": F_used, "tables": {}}
        raw = booster.predict_raw(x_test).reshape(K, -1)
        for quantize in ("float32", "int8"):
            card = serving.ServingEngine(flat, quantize=quantize, device=dev)
            cpu = serving.ServingEngine(flat, quantize=quantize,
                                        device="cpu")
            what = "phase 11 (%s) %s" % (name, quantize)
            for b, rows in rows_per_bucket(card):
                got = card.scores(rows)
                if not (got.shape == (K, len(rows))
                        and np.isfinite(got).all()):
                    fail("%s bucket %d: scores not finite [K, N]" % (what, b))
                n_cmp = min(len(rows), cpu_rows)
                if not np.array_equal(got[:, :n_cmp],
                                      cpu.scores(rows[:n_cmp])):
                    fail("%s bucket %d: card scores differ from the CPU "
                         "engine's" % (what, b))
                if quantize == "float32":
                    leaves = card.leaf_indices(rows)
                    if not np.array_equal(leaves[:n_cmp],
                                          cpu.leaf_indices(rows[:n_cmp])):
                        fail("%s bucket %d: card leaf indices differ from "
                             "the CPU engine's" % (what, b))
                    if not ((leaves >= 0).all() and (leaves < flat.num_leaves[
                            None, :]).all()):
                        fail("%s: a leaf index out of range" % what)
            if quantize == "float32":
                err = np.abs(got - raw)
                if not (err <= 1e-5 * np.abs(raw) + 1e-5).all():
                    fail("%s: scores off the float64 walk by %g" % (
                        what, float(err.max())))
                mrec["f64_max_abs_err"] = float(err.max())
            # latency per bucket, encode and read-back included
            lat = {}
            for b, reps in zip(card.buckets, (50, 50, 50, 10)):
                rows = x_test[:b]
                card.scores(rows)
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    card.scores(rows)
                    times.append(time.perf_counter() - t0)
                p50, p99 = np.percentile(times, [50, 99]) * 1e3
                lat[str(b)] = {"rows": len(rows), "calls": reps,
                               "p50_ms": p50, "p99_ms": p99,
                               "rows_per_s": len(rows) / p50 * 1e3}
            # the walk alone on the device at the top bucket
            N = card.buckets[-1]
            codes = torch.as_tensor(flat.encode(x_test[:N]), device=dev)
            t = card._device_tables()
            if quantize == "int8":
                walk = lambda: scoring.bfs_scores_int8(  # noqa: E731
                    codes, t["sf"], t["tr"], t["lc"], t["rc"], t["lv_q"],
                    t["lv_scale"], t["root"], flat.tree_class,
                    max_depth=flat.max_depth, num_class=K)
            else:
                walk = lambda: scoring.bfs_scores(  # noqa: E731
                    codes, t["sf"], t["tr"], t["lc"], t["rc"], t["lv"],
                    t["root"], flat.tree_class, max_depth=flat.max_depth,
                    num_class=K)
            # one call at a time behind a 10 ms stream sleep, which
            # outlasts the host's enqueue of the walk's few hundred
            # launches; the median of 5
            walk_ms = float(np.median([timer(walk, reps=1,
                                             sleep=20_000_000)
                                       for _ in range(5)]))
            table_bytes = sum(v.numel() * v.element_size()
                              for v in t.values())
            bound_ms = (codes.numel() * 4 + K * codes.shape[1] * 4
                        + table_bytes) / HBM_BYTES_PER_S * 1e3
            traffic_ms = (flat.max_depth * 6 * T * codes.shape[1] * 4
                          + codes.numel() * 4) / HBM_BYTES_PER_S * 1e3
            mrec["tables"][quantize] = {
                "latency": lat, "walk_rows": int(codes.shape[1]),
                "walk_cuda_ms": walk_ms, "walk_bound_ms": bound_ms,
                "walk_bound_by": "bytes", "walk_traffic_ms": traffic_ms}
            say("%s: card == CPU bitwise at buckets %s (CPU on %d rows)%s; "
                "scores() p50/p99 ms %s; walk at %d rows %.4f ms (bound "
                "%.4f, this implementation's traffic %.4f)" % (
                    what, list(card.buckets), cpu_rows,
                    ", leaf indices too" if quantize == "float32" else "",
                    " ".join("%s: %.3f/%.3f" % (b, v["p50_ms"], v["p99_ms"])
                             for b, v in lat.items()),
                    codes.shape[1], walk_ms, bound_ms, traffic_ms))
            if name == "b" and quantize == "float32":
                rec["scan_vs_bfs"] = scan_vs_bfs(flat, codes, t)
            del codes, t
        rec["models"][name] = mrec
        say("phase 11 (%s): %d trees, K = %d, max_depth %d, %d features "
            "used; float32 scores within %.3g of the float64 walk"
            % (name, T, K, flat.max_depth, F_used, mrec["f64_max_abs_err"]))

    # the front over (b), 8 clients, one swap half way
    flat_b = boosters["b"].export_flat()
    f32 = serving.ServingEngine(flat_b, device=dev).warmup()
    i8 = serving.ServingEngine(flat_b, quantize="int8", device=dev)
    front = serving.ServingFront(f32)
    logs = [[] for _ in range(8)]
    errors = []
    stop = threading.Event()

    def client(i):
        r = np.random.RandomState(SEED + 100 + i)
        try:
            while not stop.is_set():
                n = r.randint(1, 33)
                s0 = r.randint(0, n_test - n)
                t0 = time.perf_counter()
                got = front.submit(x_test[s0:s0 + n]).result(60)
                logs[i].append((s0, n, t0, time.perf_counter(), got))
        except Exception as e:  # reported and failed on below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(8)]
    t_start = time.perf_counter()
    for th in threads:
        th.start()
    time.sleep(sizes["front_s"] / 2)
    t_swap0 = time.perf_counter()
    drain_s = front.swap_engine(i8, timeout=60)
    t_swap1 = time.perf_counter()
    time.sleep(sizes["front_s"] / 2)
    stop.set()
    for th in threads:
        th.join(120)
    elapsed = time.perf_counter() - t_start
    front.close()
    if errors or any(th.is_alive() for th in threads):
        fail("phase 11 front: a client failed or hung: %r" % errors[:3])
    reqs = [q for lg in logs for q in lg]
    if front.stats["requests"] != len(reqs) or front.stats["swaps"] != 1:
        fail("phase 11 front: %d submitted, %d resolved, %d swaps"
             % (front.stats["requests"], len(reqs), front.stats["swaps"]))
    allrows = np.concatenate([x_test[s0:s0 + n] for s0, n, _, _, _ in reqs])
    whole = {"float32": f32.scores(allrows), "int8": i8.scores(allrows)}
    ofs, routed = 0, []
    for s0, n, t0, t1, got in reqs:
        on = [k for k, v in whole.items()
              if np.array_equal(got, v[:, ofs:ofs + n])]
        if not on:
            fail("phase 11 front: a request's scores match neither engine")
        routed.append(on)
        ofs += n
    k = 0
    for lg in logs:
        seen_int8 = False
        for s0, n, t0, t1, got in lg:
            on = routed[k]
            k += 1
            if on == ["int8"]:
                seen_int8 = True
            if (t1 < t_swap0 and "float32" not in on) \
                    or (t0 > t_swap1 and "int8" not in on) \
                    or (seen_int8 and "int8" not in on):
                fail("phase 11 front: a request scored on the wrong engine")
    pick = np.random.RandomState(SEED).choice(len(reqs),
                                              min(1000, len(reqs)), False)
    for j in pick:
        s0, n, _, _, got = reqs[j]
        eng = f32 if routed[j][0] == "float32" else i8
        if not np.array_equal(got, eng.scores(x_test[s0:s0 + n])):
            fail("phase 11 front: request %d differs from its rows scored "
                 "alone" % j)
    lat_ms = np.array([t1 - t0 for _, _, t0, t1, _ in reqs]) * 1e3
    on_f32 = sum(r == ["float32"] for r in routed)
    rec["front"] = {
        "clients": 8, "seconds": elapsed, "requests": len(reqs),
        "rows": int(sum(n for _, n, _, _, _ in reqs)),
        "requests_per_s": len(reqs) / elapsed,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "batches": front.stats["batches"], "swap_drain_ms": drain_s * 1e3,
        "on_float32": on_f32, "on_int8": len(reqs) - on_f32,
        "checked_alone": len(pick)}
    fr = rec["front"]
    say("phase 11 front over (b), 8 clients, %.1f s: %d requests (%d rows) "
        "in %d batches, %.1f requests/s, latency p50 %.3f ms p99 %.3f ms; "
        "swap float32 -> int8 drained in %.3f ms, %d requests on float32 "
        "and %d on int8, none lost or routed back; every request equal to "
        "its rows in one batch, %d scored alone" % (
            elapsed, fr["requests"], fr["rows"], fr["batches"],
            fr["requests_per_s"], fr["p50_ms"], fr["p99_ms"],
            fr["swap_drain_ms"], fr["on_float32"], fr["on_int8"],
            fr["checked_alone"]))

    # task=predict through the CLI, on the card and on the CPU at once
    data = os.path.join(tmp, "held_out.tsv")
    np.savetxt(data, np.column_stack([np.zeros(n_test), x_test]),
               delimiter="\t", fmt="%.17g")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    runs, logs_out = {}, {}
    t0 = time.perf_counter()
    try:
        for mode in ("predict_leaf_index=true", "predict_quantize=int8"):
            for where, device in (("card", dev.type), ("cpu", "cpu")):
                out = os.path.join(tmp, "%s_%s.txt" % (mode.split("=")[0],
                                                       where))
                runs[(mode, where)] = (out, subprocess.Popen(
                    [sys.executable, "-m", "lightgbm_tpu_torch",
                     "task=predict", "data=" + data,
                     "input_model=" + paths["b"], "output_result=" + out,
                     mode, "device=" + device],
                    env=env, cwd=tmp, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT))
        for key, (out, proc) in runs.items():
            logs_out[key] = proc.communicate(timeout=600)[0].decode()
    finally:
        for _out, proc in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cli_s = time.perf_counter() - t0
    texts = {}
    for key, (out, proc) in runs.items():
        if proc.returncode != 0:
            fail("phase 11 task=predict %s on the %s exited %d: %s" % (
                key + (proc.returncode, logs_out[key][-2000:])))
        with open(out, "rb") as f:
            texts[key] = f.read()
    for mode in ("predict_leaf_index=true", "predict_quantize=int8"):
        card_text, cpu_text = texts[(mode, "card")], texts[(mode, "cpu")]
        if card_text != cpu_text or card_text.count(b"\n") != n_test:
            fail("phase 11 task=predict %s: the card's result file differs "
                 "from device=cpu's" % mode)
        say("phase 11 task=predict %s, (b) on %d rows: the card's result "
            "file (%d bytes) byte-equal to device=cpu's" % (
                mode, n_test, len(card_text)))
    rec["cli_s"] = cli_s
    # the engines and the front in this process; the CLI runs are not
    # counted here
    by_path["serving"] = {"hist": hist_cuda.launches,
                          "partition": compact.launches}
    if hist_cuda.launches or compact.launches:
        fail("phase 11: a kernel launched while serving: %s"
             % by_path["serving"])
    for path in paths.values():
        os.unlink(path)
    os.unlink(data)
    for key in runs:
        os.unlink(runs[key][0])
    os.rmdir(tmp)
    rec["phase_s"] = time.perf_counter() - t_phase
    say("phase 11 serving: %.1f s (task=predict runs %.1f s), no kernel "
        "launch by the engines and the front in this process (the "
        "task=predict subprocesses are not counted)" % (rec["phase_s"],
                                                        cli_s))
    say(json.dumps({"serving": rec}))
    return by_path


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the card, or a note
    where it does not answer."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi did not answer"


INGEST_LABEL_COL = 3   # the label's column in the phase-12 file


def write_ingest_csv(path: str, rows: int, seed: int) -> None:
    """make_data's table as CSV text with a header: 28 features named
    f0-f27, the label as column 3 (``label``), then a weight column
    (``weight``, 0.5-1.5) and a column to ignore (``skip``)."""
    x, y = make_data(rows, 28, seed)
    rng = np.random.RandomState(seed + 1)
    w = 0.5 + rng.rand(rows)
    skip = rng.randn(rows)
    names = ["f%d" % i for i in range(28)]
    names.insert(INGEST_LABEL_COL, "label")
    fmt = ["%.6f"] * 28
    fmt.insert(INGEST_LABEL_COL, "%d")
    block = 2000
    row_fmt = ",".join(fmt + ["%.4f", "%.3f"]) + "\n"
    with open(path, "w") as f:
        f.write(",".join(names + ["weight", "skip"]) + "\n")
        for s in range(0, rows, block):
            e = min(s + block, rows)
            cols = np.column_stack([x[s:e, :INGEST_LABEL_COL], y[s:e],
                                    x[s:e, INGEST_LABEL_COL:], w[s:e],
                                    skip[s:e]])
            f.write((row_fmt * (e - s)) % tuple(cols.ravel()))


def streamed_load(io, dev, depth: int):
    """A streamed load whose DeviceRowWriter this script builds at
    ``depth``: Dataset.load_train's own steps for a text file, with the
    depth passed to io/streaming.load_train_streaming."""
    from lightgbm_tpu_torch.io import dataset as dataset_mod
    from lightgbm_tpu_torch.io import parser as parser_mod
    from lightgbm_tpu_torch.io import streaming
    ds = dataset_mod.Dataset()
    ds.data_filename = io.data_filename
    ds.max_bin = io.max_bin
    label_idx, weight_idx, group_idx, ignore_set, header = \
        dataset_mod._resolve_columns(io)
    ds.label_idx = label_idx
    ds.metadata.init_from_files(io.data_filename)
    parser = parser_mod.create_parser(io.data_filename, io.has_header, 0,
                                      label_idx)
    streaming.load_train_streaming(ds, io, parser, None, weight_idx,
                                   group_idx, ignore_set, header, dev,
                                   depth=depth)
    ds.metadata.finalize(ds.num_data)
    return ds


def ingest_phase(dev, sizes, sync):
    """Phase 12: the ingest layer on the card.  make_data's table of
    ``n_ingest`` rows (2M, cut from the Higgs file's 11M to fit this
    script's time limit) written as CSV text over 256 MB with a header,
    the label as column 3, a weight column and an ignored column, so
    ``streaming=auto`` streams it by itself; loaded through (a) resident,
    (b) ``streaming=auto`` serial, (c) ``streaming=true ingest_workers=4``,
    (d) two-round, (e) (a)'s native cache as ``data=``, streamed, (f) the
    same cache as a ``<data>.bin`` sibling, (g) a reference-format cache
    sibling.  Each bin matrix, read back from where it lives, must be
    (a)'s, with the same mappers, labels, weights and names; (b)'s
    streamed cache must be (a)'s byte for byte; (a)-(d) must parse in the
    native tier only; the main-path configuration (255 leaves, float32,
    compacted, 5 iterations) from (a), (b), (c) and (e) must launch the
    histogram once a leaf and the partition once a split, and in int8
    (order-free sums) give one model text; the float32 models are held
    against (a)'s tree by tree, beside a second float32 run of (a) (the
    float histogram's f32 atomics add in a run-dependent order);
    ``task=predict`` on (e)'s cache must write the text file's result.
    Recorded: each route's seconds and rows/s, the feed's h2d_bytes /
    wait_s / hidden_s for (b) and for (b) again at depth 0 and 2 in
    turns, the native and the exact tier on one chunk, and the card
    beside them."""
    import filecmp
    import shutil
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.cli import main as cli_main
    from lightgbm_tpu_torch.config import IOConfig
    from lightgbm_tpu_torch.io import parallel_ingest, streaming
    from lightgbm_tpu_torch.io import parser as parser_mod
    from lightgbm_tpu_torch.native import lib as native_lib

    t_phase = time.perf_counter()
    card = card_name()
    if not native_lib.available():
        fail("phase 12: the native parser did not build: %s"
             % native_lib.build_error)
    n = sizes["n_ingest"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    rec = {"card": card, "rows": n, "routes": {}}
    by_path = {}
    try:
        data = os.path.join(tmp, "higgs.csv")
        t0 = time.perf_counter()
        write_ingest_csv(data, n, SEED + 12)
        rec["write_s"] = time.perf_counter() - t0
        rec["file_bytes"] = os.path.getsize(data)
        say("phase 12 ingest: %d rows x 31 columns written as CSV, %d bytes "
            "in %.1f s [%s]" % (n, rec["file_bytes"], rec["write_s"], card))
        if rec["file_bytes"] < streaming.AUTO_MIN_BYTES:
            fail("phase 12: the file is %d bytes, under streaming=auto's "
                 "%d" % (rec["file_bytes"], streaming.AUTO_MIN_BYTES))
        cols = dict(data_filename=data, has_header=True, max_bin=255,
                    label_column="name:label", weight_column="name:weight",
                    ignore_column="name:skip")

        def load(route, io_kw, text=True):
            for tier in parser_mod.tier_calls:
                parser_mod.tier_calls[tier] = 0
            sync()
            t0 = time.perf_counter()
            ds = lgt.Dataset.load_train(IOConfig(**dict(cols, **io_kw)),
                                        device=dev)
            sync()
            secs = time.perf_counter() - t0
            r = {"s": secs, "rows_per_s": ds.num_data / secs}
            if text:
                r["tiers"] = dict(parser_mod.tier_calls)
                if (r["tiers"]["native"] == 0
                        or r["tiers"]["pandas"] or r["tiers"]["exact"]):
                    fail("phase 12 (%s): parsed outside the native tier: "
                         "%s" % (route, r["tiers"]))
            w = ds.ingest_writer
            if w is not None:
                r.update(h2d_bytes=w.h2d_bytes, wait_s=w.wait_s,
                         hidden_s=w.hidden_s, depth=w.depth)
            rec["routes"][route] = r
            say("phase 12 (%s): %d rows in %.3f s, %.0f rows/s%s%s [%s]" % (
                route, ds.num_data, secs, r["rows_per_s"],
                "" if w is None else ", h2d %d bytes, wait %.3f s, hidden "
                "%.3f s (depth %d)" % (w.h2d_bytes, w.wait_s, w.hidden_s,
                                        w.depth),
                ", tiers %s" % r["tiers"] if text else "", card))
            return ds

        # (b) first: its pass 2 streams the cache out before (a) writes one
        b = load("b_streamed_auto", {"is_save_binary_file": True})
        if b.bins is not None or b.device_bins.device.type != dev.type:
            fail("phase 12 (b): streaming=auto did not stream onto the card")
        os.replace(data + ".bin", os.path.join(tmp, "streamed.bin"))
        a = load("a_resident", {"streaming": "false",
                                "is_save_binary_file": True})
        native_cache = os.path.join(tmp, "native.bin")
        os.replace(data + ".bin", native_cache)
        if not filecmp.cmp(native_cache, os.path.join(tmp, "streamed.bin"),
                           shallow=False):
            fail("phase 12: (b)'s streamed cache differs from (a)'s")
        os.unlink(os.path.join(tmp, "streamed.bin"))
        say("phase 12: (b)'s streamed cache byte-equal to (a)'s (%d bytes)"
            % os.path.getsize(native_cache))
        want = a.read_bins()

        def same(route, ds):
            got = ds.read_bins()
            ok = (got.dtype == want.dtype and np.array_equal(got, want)
                  and [m.to_bytes() for m in ds.bin_mappers]
                  == [m.to_bytes() for m in a.bin_mappers]
                  and ds.feature_names == a.feature_names
                  and np.array_equal(ds.metadata.label, a.metadata.label)
                  and np.array_equal(ds.metadata.weights,
                                     a.metadata.weights))
            if not ok:
                fail("phase 12 (%s): the dataset differs from (a)'s" % route)

        same("b", b)
        c = load("c_workers4", {"streaming": "true", "ingest_workers": 4})
        same("c", c)
        d = load("d_two_round", {"streaming": "false",
                                 "use_two_round_loading": True})
        same("d", d)
        del d
        # (b) again with the feed built by this script, at depth 0 and at
        # depth 2 in turns (no cache written)
        for depth in (0, 2):
            sync()
            t0 = time.perf_counter()
            bd = streamed_load(IOConfig(**dict(cols, streaming="true")), dev,
                               depth)
            sync()
            secs = time.perf_counter() - t0
            w = bd.ingest_writer
            rec["routes"]["b_depth%d" % depth] = {
                "s": secs, "rows_per_s": n / secs, "h2d_bytes": w.h2d_bytes,
                "wait_s": w.wait_s, "hidden_s": w.hidden_s, "depth": depth}
            same("b depth %d" % depth, bd)
            say("phase 12 (b, depth %d): %d rows in %.3f s, %.0f rows/s, "
                "h2d %d bytes, wait %.4f s, hidden %.3f s [%s]" % (
                    depth, n, secs, n / secs, w.h2d_bytes, w.wait_s,
                    w.hidden_s, card))
            del bd
        e = load("e_cache_direct_streamed",
                 {"data_filename": native_cache, "streaming": "true"},
                 text=False)
        same("e", e)
        shutil.copyfile(native_cache, data + ".bin")
        f_ = load("f_cache_sibling", {}, text=False)
        same("f", f_)
        del f_
        os.unlink(data + ".bin")
        a.save_binary_reference(data + ".bin")
        g = load("g_reference_sibling", {}, text=False)
        same("g", g)
        del g
        os.unlink(data + ".bin")
        say("phase 12: routes (b)-(g) give (a)'s bin matrix, mappers, "
            "labels, weights and names")

        # the main path from (a), (b), (c) and (e), in float32 and in
        # int8.  Both histogram modes sum in integers (the float mode in
        # fixed point), in an order-free way, so each mode must give one
        # model text from every route, and from (a) trained twice.
        params = {"objective": "binary", "num_leaves": 255,
                  "num_iterations": 5, "learning_rate": 0.1,
                  "hist_dtype": "float32", "max_bin": 255}
        texts = {"float32": {}, "int8": {}}
        for dtype in ("float32", "int8"):
            runs = (("a", a), ("a_again", a), ("b", b), ("c", c),
                    ("e", e)) if dtype == "float32" else \
                (("a", a), ("b", b), ("c", c), ("e", e))
            for route, ds in runs:
                booster, iter_s, counts = drive(
                    dict(params, hist_dtype=dtype), ds, dev, sync)
                leaves = sum(t.num_leaves for t in booster.models)
                splits = leaves - len(booster.models)
                if not (len(booster.models) == 5
                        and counts["hist"] == leaves
                        and counts["partition"] == splits):
                    fail("phase 12 (%s, %s): %d trees, %d histogram "
                         "launches for %d leaves, %d partitions for %d "
                         "splits" % (route, dtype, len(booster.models),
                                     counts["hist"], leaves,
                                     counts["partition"], splits))
                if dtype == "float32" and route != "a_again":
                    by_path["ingest_" + route] = {
                        "hist": counts["hist"],
                        "partition": counts["partition"]}
                texts[dtype][route] = booster.model_to_string()
                say("phase 12 (%s) main path %s: %d histogram launches (one "
                    "a leaf), %d partitions (one a split), seconds per "
                    "iteration %s [%s]" % (
                        route, dtype, counts["hist"], counts["partition"],
                        " ".join("%.3f" % v for v in iter_s), card))
                del booster
        for dtype, by_route in texts.items():
            rec[dtype + "_text_equal"] = {
                r: t == by_route["a"] for r, t in by_route.items()}
            if len(set(by_route.values())) != 1:
                fail("phase 12: %s model text differs from (a)'s on %s" % (
                    dtype, [r for r in by_route
                            if by_route[r] != by_route["a"]]))
            say("phase 12: %s trains byte-equal %s model text (%d bytes)"
                % (", ".join("(%s)" % r for r in by_route), dtype,
                   len(by_route["a"])))
        text_a = texts["float32"]["a"]
        model = os.path.join(tmp, "model.txt")
        with open(model, "w") as fm:
            fm.write(text_a)
        del a, b, c, e

        # task=predict on the cache and on the text: one result file
        outs = {}
        t0 = time.perf_counter()
        for what, args in (("cache", ["data=" + native_cache]),
                           ("text", ["data=" + data, "has_header=true"])):
            out = os.path.join(tmp, "%s.out" % what)
            if cli_main(["task=predict", "input_model=" + model,
                         "output_result=" + out, "device=" + dev.type]
                        + args) != 0:
                fail("phase 12: task=predict on the %s failed" % what)
            with open(out, "rb") as fo:
                outs[what] = fo.read()
        rec["predict_s"] = time.perf_counter() - t0
        if outs["cache"] != outs["text"] or outs["text"].count(b"\n") != n:
            fail("phase 12: task=predict on the cache differs from the "
                 "text file's result")
        say("phase 12: task=predict on (e)'s cache byte-equal to the text "
            "file's (%d rows, %d bytes; both in %.1f s) [%s]" % (
                n, len(outs["text"]), rec["predict_s"], card))

        # the native tier against the exact tier on one chunk
        lines = next(iter(parser_mod.read_line_chunks(
            data, skip_header=True, chunk_lines=sizes["ingest_parse_rows"])))
        t0 = time.perf_counter()
        fast = native_lib.parse_delimited(lines, ",")
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        exact = parser_mod._parse_delimited_exact(lines, ",")
        exact_s = time.perf_counter() - t0
        if fast is None or not np.array_equal(fast, exact):
            fail("phase 12: the native and exact tiers parse the chunk "
                 "differently")
        rec["parse"] = {"rows": len(lines), "native_s": native_s,
                        "exact_s": exact_s}
        say("phase 12 parse of %d rows x 31 columns: native %.3f s, exact "
            "%.3f s (%.1fx), equal values [%s]" % (
                len(lines), native_s, exact_s, exact_s / native_s, card))
    finally:
        parallel_ingest.shutdown_workers()
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    say("phase 12 ingest: %.1f s [%s]" % (rec["phase_s"], card))
    say(json.dumps({"ingest": rec}))
    return by_path


def checkpoint_phase(dev, sizes, train_set, sync):
    """Phase 13: checkpoints and resume on phase 4's table, through
    ``lightgbm_tpu_torch.train`` and the CLI.  Two paths in process: the
    main path (float32, compacted, 255 leaves) and the reference
    example's sampled path in int8 (63 leaves, bagging 0.8 every 5 with
    the threefry draw on the card, feature_fraction 0.8), 10 iterations
    each.  Each trains unbroken twice, the second time writing a
    checkpoint every iteration: one model text (the float histogram's
    sums are the same on every run).  Then a run with
    ``checkpoint_interval=1`` is stopped by ``faults.arm(6, "raise")`` and
    the same call resumes it: the unbroken run's model text, with one
    histogram launch a leaf and one partition a split of the four
    remaining trees and no more.  Then a CLI run on the table's native
    cache, SIGKILLed at iteration 6 (rc -9), and the same command again:
    the unbroken CLI run's model file, byte for byte.  Recorded, not
    gated: checkpoint bytes, seconds per iteration with a checkpoint
    every iteration against none, restore seconds, the writer's written
    and dropped counts.  Returns the kernel launches of each resumed
    run."""
    import shutil
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import checkpoint, faults
    from lightgbm_tpu_torch.objectives import create_objective
    card = card_name()
    t_phase = time.perf_counter()
    rec, by_path = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    iters, stop = sizes.get("ckpt_iters", 10), 6
    main_path = {"objective": "binary", "num_leaves": 255,
                 "num_iterations": iters, "learning_rate": 0.1,
                 "hist_dtype": "float32", "max_bin": 255}
    sampled = {"objective": "binary", "num_leaves": 63,
               "num_iterations": iters, "learning_rate": 0.1,
               "hist_dtype": "int8", "max_bin": 255,
               "bagging_fraction": 0.8, "bagging_freq": 5,
               "feature_fraction": 0.8}
    try:
        for name, params in (("float32_main", main_path),
                             ("int8_sampled", sampled)):
            what = "phase 13 %s" % name
            whole, whole_s, _ = drive(params, train_set, dev, sync)
            text = whole.model_to_string()
            every = dict(params, checkpoint_interval=1,
                         checkpoint_dir=os.path.join(tmp, name + "_whole"))
            again, every_s, _ = drive(every, train_set, dev, sync)
            if again.model_to_string() != text:
                fail("%s: two unbroken runs (the second writing "
                     "checkpoints) give different model text" % what)
            writer = again.checkpoint_writer
            del again
            ck = dict(params, checkpoint_interval=1,
                      checkpoint_dir=os.path.join(tmp, name))
            faults.arm(stop, "raise")
            try:
                drive(ck, train_set, dev, sync)
            except RuntimeError as e:
                if "injected fault" not in str(e):
                    raise
            else:
                fail("%s: the armed raise did not stop training" % what)
            finally:
                faults.disarm()
            latest = checkpoint.latest_checkpoint(ck["checkpoint_dir"])
            ckpt_bytes = os.path.getsize(latest)
            payload = checkpoint.load_checkpoint(latest)
            if payload["iteration"] != stop:
                fail("%s: latest checkpoint at iteration %d, expected %d"
                     % (what, payload["iteration"], stop))
            # the restore alone, on a fresh booster
            cfg = lgt.OverallConfig()
            cfg.set({k: str(v) for k, v in params.items()},
                    require_data=False)
            fresh = lgt.GBDT()
            fresh.init(cfg.boosting_config, train_set,
                       create_objective(cfg.objective_type,
                                        cfg.objective_config), device=dev)
            sync()
            t0 = time.perf_counter()
            fresh.restore_checkpoint(latest)
            sync()
            restore_s = time.perf_counter() - t0
            del fresh
            resumed, resumed_s, counts = drive(ck, train_set, dev, sync)
            rest = whole.models[stop:]
            leaves = sum(t.num_leaves for t in rest)
            if resumed.model_to_string() != text:
                fail("%s: the resumed model text differs from the "
                     "unbroken run's" % what)
            if not (len(resumed_s) == iters - stop
                    and counts["hist"] == leaves
                    and counts["partition"] == leaves - len(rest)):
                fail("%s: resumed run of %d iterations launched hist %d, "
                     "partition %d; the %d remaining trees have %d leaves"
                     % (what, len(resumed_s), counts["hist"],
                        counts["partition"], len(rest), leaves))
            # (a CPU rehearsal draws on the host stream: "auto" there)
            if name == "int8_sampled" and dev.type == "cuda" and not (
                    resumed._bag_device
                    and resumed._bag_draw_idx == whole._bag_draw_idx > 1):
                fail("%s: the threefry draw counter was not restored "
                     "(%d draws, unbroken %d)" % (
                         what, resumed._bag_draw_idx, whole._bag_draw_idx))
            by_path["checkpoint_resume_" + name] = {
                "hist": counts["hist"], "partition": counts["partition"]}
            rec[name] = {
                "ckpt_bytes": ckpt_bytes,
                "s_per_iter_interval0": float(np.median(whole_s)),
                "s_per_iter_interval1": float(np.median(every_s)),
                "restore_s": restore_s,
                "written": writer.written, "dropped": writer.dropped,
                "resumed_launches": {"hist": counts["hist"],
                                     "partition": counts["partition"]},
                "model_bytes": len(text)}
            say("%s: resumed at iteration %d to the unbroken model text "
                "(%d bytes); resumed run launched hist %d, partition %d "
                "for the %d remaining trees; checkpoint %d bytes, restore "
                "%.3f s; s/iteration %s without checkpoints, %s with one "
                "every iteration (writer: %d written, %d dropped) [%s]" % (
                    what, stop, len(text), counts["hist"],
                    counts["partition"], len(rest),
                    rec[name]["ckpt_bytes"], restore_s,
                    " ".join("%.3f" % v for v in whole_s),
                    " ".join("%.3f" % v for v in every_s), writer.written,
                    writer.dropped, card))
            del whole, resumed

        # the CLI on the table's native cache: SIGKILLed at iteration 6,
        # then the same command again
        cache = os.path.join(tmp, "train.bin")
        train_set.save_binary(cache)

        def cli_args(out, ckdir):
            return (["task=train", "data=" + cache, "objective=binary",
                     "num_leaves=255", "num_iterations=%d" % iters,
                     "learning_rate=0.1", "max_bin=255",
                     "device=" + dev.type, "output_model=" + out,
                     "checkpoint_interval=1", "checkpoint_dir=" + ckdir])

        def run_cli(args, arm=None):
            code = ("import sys\n"
                    "from lightgbm_tpu_torch import cli, faults\n"
                    + ("faults.arm(%d, 'kill')\n" % arm if arm else "")
                    + "sys.exit(cli.main(%r))\n" % (args,))
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-c", code],
                                 cwd=os.path.dirname(os.path.abspath(
                                     __file__)), capture_output=True,
                                 text=True, timeout=600)
            return out, time.perf_counter() - t0

        whole_out = os.path.join(tmp, "whole.txt")
        out, whole_cli_s = run_cli(cli_args(whole_out,
                                            os.path.join(tmp, "cli0")))
        if out.returncode != 0:
            fail("phase 13 CLI unbroken run exited %d: %s"
                 % (out.returncode, out.stderr[-2000:]))
        model, ckdir = os.path.join(tmp, "model.txt"), os.path.join(tmp,
                                                                    "cli1")
        out, killed_s = run_cli(cli_args(model, ckdir), arm=stop)
        if out.returncode != -9:
            fail("phase 13 CLI run armed to kill at %d exited %d: %s"
                 % (stop, out.returncode, out.stderr[-2000:]))
        at_kill = checkpoint.load_checkpoint(
            checkpoint.latest_checkpoint(ckdir))["iteration"]
        out, resumed_cli_s = run_cli(cli_args(model, ckdir))
        if out.returncode != 0 or "resuming from checkpoint" not in \
                out.stdout + out.stderr:
            fail("phase 13 CLI rerun exited %d without resuming: %s"
                 % (out.returncode, out.stderr[-2000:]))
        with open(model, "rb") as f1, open(whole_out, "rb") as f2:
            if f1.read() != f2.read():
                fail("phase 13 CLI: the resumed model file differs from "
                     "the unbroken run's")
        rec["cli"] = {"killed_rc": -9, "latest_at_kill": at_kill,
                      "unbroken_s": whole_cli_s, "killed_s": killed_s,
                      "resumed_s": resumed_cli_s}
        say("phase 13 CLI: SIGKILLed at iteration %d (rc -9, latest "
            "checkpoint %d), rerun resumed to the unbroken run's model "
            "file byte for byte; subprocess seconds unbroken %.1f, killed "
            "%.1f, resumed %.1f [%s]" % (stop, at_kill, whole_cli_s,
                                         killed_s, resumed_cli_s, card))
    finally:
        faults.disarm()
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    say("phase 13 checkpoints: %.1f s [%s]" % (rec["phase_s"], card))
    say(json.dumps({"checkpoint": rec}))
    return by_path


# the top-level phases of one boosting iteration (telemetry.py's
# docstring): histogram, split_find and partition nest inside grow
ITERATION_PHASES = ("gradient", "bagging", "goss", "grow", "score_update",
                    "valid_update", "model_readback", "eval")
GROWER_PHASES = ("histogram", "split_find", "partition")
# the __global__ functions of csrc/hist.cu and csrc/partition.cu
KERNEL_NAMES = {"hist": ("hist_kernel",),
                "partition": ("partition_move", "partition_count")}


def report_check(script: str, path: str) -> str:
    """``python3 scripts/<script> --check <path>`` must exit 0."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable,
                          os.path.join(here, "scripts", script), "--check",
                          path], capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        fail("%s --check %s exited %d: %s" % (
            script, path, out.returncode, (out.stdout + out.stderr)[-2000:]))
    return out.stdout.strip()


def observability_phase(dev, sizes, x, y, train_set, served, sync):
    """Phase 14: the observability layer around the main path.

    (a) The main path (255 leaves, float32, compacted, 5 iterations) is
        trained unarmed; with the sink armed (``metrics_out``,
        ``metrics_fence=true``, ``memory_stats=true``, ``health=true``,
        ``trace_dump_dir``, ``trace_run_id``); and fully armed, adding
        ``profile_dir`` and ``stall_timeout`` with ``faults.arm(3,
        "stall")`` sleeping longer than the timeout: the model text must
        be byte-equal.  Checks (b)-(g) read the fully armed run.
    (b) The summary's ``hist/cuda_*`` counters sum to the histogram
        kernel's launches and ``partition/cuda`` equals the partition
        kernel's (``*/plain*`` on a CPU rehearsal); no plain route counts
        on the card.
    (c) Every iteration record has the canonical phase keys; under the
        fence an iteration's top-level phases sum to at most its wall
        time (host clock between iterations), and the grower's phases to
        at most its ``grow``.  Their share of the wall is printed.
    (d) The memory block reads the card: its peak is at least the bin
        matrix and at most ``torch.cuda.max_memory_allocated()``.
    (e) The roofline resolves the H100's peaks, and the histogram's and
        the partition's fractions of the HBM peak lie in (0, 1.05].
    (f) The Chrome trace in ``profile_dir`` holds the span names and the
        kernel events of both kernels.
    (g) The stall left one flight record naming iteration 3 in the sink
        and a flight dump (reason ``stall``) that
        ``scripts/trace_report.py --check`` accepts.
    (h) The health blocks: no NaN or Inf; then the int8 depth-wise
        headline with ``health=true`` reads ``quant_sat`` > 0.
    (i) Phase 11's ServingFront over model (b), loaded from its file,
        with ``monitor_out`` and ``slo_p99_us``: at least 2 windows that
        ``scripts/monitor_report.py --check`` accepts, drift computed
        against the file's ``score_reference=`` line, and the front's
        request traces accepted by ``trace_report.py --check`` (the
        components of every request sum to its wall time).

    Recorded, not gated: seconds an iteration armed against unarmed (host
    clock), the sink's bytes, the phase's seconds.  Returns the launch
    counts of the armed run and of the serving session."""
    import shutil
    import threading
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import faults, lifecycle, monitor, telemetry
    from lightgbm_tpu_torch.ops import compact, hist_cuda
    card = card_name()
    on_card = dev.type == "cuda"
    fam = "cuda" if on_card else "plain"
    t_phase = time.perf_counter()
    rec, by_path = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        base = {"objective": "binary", "num_leaves": 255,
                "num_iterations": 5, "learning_rate": 0.1,
                "hist_dtype": "float32", "max_bin": 255}
        plain_booster, plain_s, _ = drive(base, train_set, dev, sync)
        plain_text = plain_booster.model_to_string()
        del plain_booster
        sink = os.path.join(tmp, "metrics.jsonl")
        prof, dumps = os.path.join(tmp, "prof"), os.path.join(tmp, "dumps")
        # the sink armed alone (fenced, with memory gauges, health and
        # the flight recorder): the cost of arming, beside the unarmed run
        lite = dict(base, metrics_out=os.path.join(tmp, "lite.jsonl"),
                    metrics_fence="true", memory_stats="true",
                    health="true", trace_dump_dir=os.path.join(tmp, "lite"),
                    trace_run_id="chip_smoke_14")
        lite_booster, lite_s, _ = drive(lite, train_set, dev, sync)
        if lite_booster.model_to_string() != plain_text:
            fail("phase 14a: the sink-armed model text differs from the "
                 "unarmed run's")
        del lite_booster
        armed = dict(lite, metrics_out=sink, profile_dir=prof,
                     trace_dump_dir=dumps,
                     stall_timeout=sizes["stall_timeout"])
        faults.arm(3, "stall", stall_s=sizes["stall_s"])
        try:
            booster, armed_s, counts = drive(armed, train_set, dev, sync)
        finally:
            faults.disarm()
        by_path["observability_main_armed"] = counts
        # (a)
        if booster.model_to_string() != plain_text:
            fail("phase 14a: the armed model text differs from the "
                 "unarmed run's")
        say("phase 14a armed main path: model text byte-equal to the "
            "unarmed run, sink-armed and fully armed; seconds per "
            "iteration unarmed %s, sink armed %s, fully armed %s (the "
            "profiler on, a %.1f s stall at iteration 3) [%s]" % (
                " ".join("%.3f" % v for v in plain_s),
                " ".join("%.3f" % v for v in lite_s),
                " ".join("%.3f" % v for v in armed_s), sizes["stall_s"],
                card))
        recs = [json.loads(line) for line in open(sink)]
        iters = [r for r in recs if "iter" in r]
        summary = [r for r in recs if r.get("summary")]
        flights = [r for r in recs if "flight_recorder" in r]
        if len(iters) != 5 or len(summary) != 1 or \
                not any("residency" in r for r in recs):
            fail("phase 14: sink holds %d iteration records, %d summaries"
                 % (len(iters), len(summary)))
        summary = summary[0]
        # (b)
        ctr = summary["counters"]
        hist_routes = {k: v for k, v in ctr.items()
                       if k.startswith("hist/%s_" % fam)}
        other = "plain" if on_card else "cuda"
        if sum(hist_routes.values()) != counts["hist"] \
                or ctr.get("partition/" + fam, 0) != counts["partition"] \
                or any(k.startswith(("hist/" + other, "partition/" + other))
                       for k in ctr):
            fail("phase 14b: route counters %s against launches hist %d "
                 "partition %d" % (ctr, counts["hist"], counts["partition"]))
        say("phase 14b route counters %s equal the kernel counts (hist %d, "
            "partition %d)" % ({k: v for k, v in sorted(ctr.items())
                                if k.startswith(("hist/", "partition/"))},
                               counts["hist"], counts["partition"]))
        # (c)
        shares = []
        for k, r in enumerate(iters):
            pt = r["phase_times"]
            if not set(telemetry.CANONICAL_PHASES) <= set(pt) \
                    or r["trace_times"] != {}:
                fail("phase 14c: record %d lacks canonical keys: %s"
                     % (k, sorted(pt)))
            top = sum(pt.get(p, 0.0) for p in ITERATION_PHASES)
            inner = sum(pt.get(p, 0.0) for p in GROWER_PHASES)
            if top > armed_s[k] or inner > pt.get("grow", 0.0):
                fail("phase 14c: iteration %d phases %.4f s over its wall "
                     "%.4f s (grower %.4f over grow %.4f)" % (
                         k + 1, top, armed_s[k], inner, pt.get("grow", 0)))
            shares.append(top / armed_s[k])
        rec["phase_share"] = shares
        say("phase 14c canonical keys in every record; fenced phases cover "
            "%s of each iteration's wall" % " ".join(
                "%.3f" % v for v in shares))
        # (d)
        mem = summary["memory"]
        bins_bytes = train_set.num_data * train_set.num_features
        peak = mem["peak_bytes_in_use"]
        if on_card:
            top_alloc = torch.cuda.max_memory_allocated()
            if mem["source"] != "device" or not bins_bytes <= peak \
                    <= top_alloc:
                fail("phase 14d: memory block %s, peak %d outside [%d, %d]"
                     % (mem["source"], peak, bins_bytes, top_alloc))
        elif mem["source"] != "host_rss":
            fail("phase 14d: a CPU run reads %s" % mem["source"])
        say("phase 14d memory: source %s, peak %d bytes (bin matrix %d, "
            "allocator peak %s)" % (mem["source"], peak, bins_bytes,
                                    torch.cuda.max_memory_allocated()
                                    if on_card else "n/a"))
        # (e)
        roof = summary["roofline"]
        fr = {p: roof["phases"].get(p, {}).get("frac_of_peak_bw")
              for p in ("histogram", "partition")}
        if on_card and (not isinstance(roof["peaks"], dict)
                        or not all(v is not None and 0 < v <= 1.05
                                   for v in fr.values())):
            fail("phase 14e: roofline peaks %s, fractions %s"
                 % (roof["peaks"], fr))
        rec["roofline"] = {p: roof["phases"].get(p) for p in fr}
        say("phase 14e roofline on %s: %s" % (roof["device_kind"], json.dumps(
            {p: {k: v for k, v in (roof["phases"].get(p) or {}).items()
                 if k in ("calls", "bytes_accessed", "seconds",
                          "attained_hbm_gbps", "frac_of_peak_bw")}
             for p in fr})))
        # (f)
        with open(os.path.join(prof, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        kernel_names = {e["name"] for e in events
                        if e.get("cat") == "kernel"}
        missing = [s for s in ("grow", "histogram", "split_find",
                               "partition") if s not in names]
        for which, fns in KERNEL_NAMES.items():
            if on_card and not any(fn in k for k in kernel_names
                                   for fn in fns):
                missing.append(which + " kernel")
        if missing:
            fail("phase 14f: the profiler trace lacks %s" % missing)
        say("phase 14f profiler trace: %d events, spans and both kernels' "
            "events present (%d kernel events)" % (
                len(events), sum(1 for e in events
                                 if e.get("cat") == "kernel")))
        del events
        # (g)
        stall = []
        for name in sorted(os.listdir(dumps)):
            with open(os.path.join(dumps, name)) as f:
                head = json.loads(f.readline())["trace_header"]
            if head["reason"] == "stall":
                stall.append(os.path.join(dumps, name))
        # the stall's record names its iteration; a loaded host could add
        # a dump elsewhere (the watchdog re-arms once progress resumes)
        at_stall = [r["flight_recorder"] for r in flights
                    if r["flight_recorder"]["iteration"] == 3]
        if len(at_stall) != 1 or not stall \
                or telemetry.last_flight_record() is None:
            fail("phase 14g: %d stall dumps, %d flight records (%d at the "
                 "stall)" % (len(stall), len(flights), len(at_stall)))
        for path in stall:
            report_check("trace_report.py", path)
        say("phase 14g stall: %d flight dump(s), %d at the stall (in-flight "
            "phase %s, iteration 3, %.1f s), accepted by trace_report.py "
            "--check" % (len(stall), len(at_stall), at_stall[0]["phase"],
                         at_stall[0]["stalled_for_s"]))
        # (h)
        health = summary["health"]
        bad = {k: health[k] for k in ("grad_nan", "grad_inf", "hess_nan",
                                      "hess_inf", "score_nan", "score_inf")
               if health[k]}
        pd = {"objective": "binary", "grow_policy": "depthwise",
              "hist_dtype": "int8", "num_leaves": 255,
              "min_data_in_leaf": 100, "min_sum_hessian_in_leaf": 10,
              "learning_rate": 0.1, "max_bin": 255, "num_iterations": 5,
              "health": "true"}
        b8, _, counts8 = drive(pd, train_set, dev, sync)
        h8 = b8.health_summary()
        by_path["observability_depthwise_int8_health"] = counts8
        bad.update({"int8 " + k: h8[k] for k in ("grad_nan", "score_nan",
                                                 "score_inf") if h8[k]})
        if bad or not h8["quant_sat"] > 0:
            fail("phase 14h: health %s, int8 quant_sat %s"
                 % (bad, h8["quant_sat"]))
        say("phase 14h health: no NaN or Inf; score_max_abs %.4f; int8 "
            "depth-wise quant_sat %d over 5 iterations" % (
                health["score_max_abs"], h8["quant_sat"]))
        del b8, booster
        # (i)
        path_b = os.path.join(tmp, "model_b.txt")
        with open(path_b, "w") as f:
            f.write(served["b"])
        line = [ln for ln in served["b"].split("\n")
                if ln.startswith("score_reference=")]
        if len(line) != 1:
            fail("phase 14i: model (b) has %d score_reference lines"
                 % len(line))
        mon_path = os.path.join(tmp, "monitor.jsonl")
        serve_dumps = os.path.join(tmp, "serve_dumps")
        cfg = lgt.OverallConfig()
        cfg.set({"monitor_out": mon_path,
                 "monitor_interval_s": sizes["monitor_interval_s"],
                 "slo_p99_us": 20000, "metrics_out": os.path.join(
                     tmp, "serve_metrics.jsonl"),
                 "trace_dump_dir": serve_dumps}, require_data=False)
        reset_counts()
        telemetry.arm_session(cfg.io_config)
        try:
            bb = lgt.GBDT.from_model_file(path_b, device=dev)
            if bb.score_reference != json.loads(line[0].split("=", 1)[1]):
                fail("phase 14i: the loaded reference is not the file's")
            front = lgt.ServingFront(bb.serving_engine().warmup())
            x_test = x[sizes["n_train"]:]
            stop, errors, served_n = threading.Event(), [], [0] * 4

            def client(i):
                r = np.random.RandomState(SEED + 200 + i)
                try:
                    while not stop.is_set():
                        n = r.randint(1, 33)
                        s0 = r.randint(0, len(x_test) - n)
                        front.submit(x_test[s0:s0 + n]).result(60)
                        served_n[i] += 1
                except Exception as e:  # failed on below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(i,),
                                        daemon=True) for i in range(4)]
            for th in threads:
                th.start()
            time.sleep(sizes["obs_front_s"])
            stop.set()
            for th in threads:
                th.join(60)
            front.close()
            if errors:
                fail("phase 14i: a client failed: %r" % errors[:3])
            drift = [monitor.engine_drift(key) for key in
                     monitor.monitor_snapshot()["drift"]]
            drift = [d for d in drift if d["psi"] is not None]
            if not drift or drift[0]["ref_count"] != \
                    monitor.ScoreHistogram.from_dict(
                        bb.score_reference).count:
                fail("phase 14i: no drift against the reference: %s"
                     % drift)
        finally:
            telemetry.disable()
        by_path["observability_serving"] = {
            "hist": hist_cuda.launches, "partition": compact.launches}
        if any(v for v in by_path["observability_serving"].values()):
            fail("phase 14i: serving launched a kernel")
        mon_recs = [json.loads(ln) for ln in open(mon_path)]
        windows = sum(1 for r in mon_recs if "monitor_window" in r)
        if windows < 2:
            fail("phase 14i: %d monitor windows" % windows)
        report_check("monitor_report.py", mon_path)
        for name in sorted(os.listdir(serve_dumps)):
            report_check("trace_report.py", os.path.join(serve_dumps, name))
        say("phase 14i monitor: %d requests, %d windows accepted by "
            "monitor_report.py --check, drift psi %.6f against the "
            "score_reference line (%d reference scores, %d live), "
            "request traces accepted by trace_report.py --check" % (
                sum(served_n), windows, drift[0]["psi"],
                drift[0]["ref_count"], drift[0]["live_count"]))
        left = lifecycle.leaks()
        if left:
            fail("phase 14: leaked %s" % [(k, n) for k, n, _ in left])
        rec["s_per_iter"] = {"unarmed": float(np.median(plain_s)),
                             "sink_armed": float(np.median(lite_s)),
                             "fully_armed": float(np.median(armed_s))}
        rec["sink_bytes"] = os.path.getsize(sink)
        rec["health_int8_quant_sat"] = h8["quant_sat"]
        rec["monitor_windows"] = windows
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    say("phase 14 observability: median seconds per iteration unarmed "
        "%.4f, sink armed %.4f, fully armed %.4f (the profiler and the "
        "stall included); sink %d bytes; %.1f s [%s]" % (
            rec["s_per_iter"]["unarmed"], rec["s_per_iter"]["sink_armed"],
            rec["s_per_iter"]["fully_armed"], rec["sink_bytes"],
            rec["phase_s"], card))
    say(json.dumps({"observability": rec}))
    return {k: {"hist": v["hist"], "partition": v["partition"]}
            for k, v in by_path.items()}


if __name__ == "__main__":
    sys.exit(main())
