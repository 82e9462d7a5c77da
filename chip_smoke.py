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
``serving_phase``).  Phase 12 runs the ingest layer on a 1M-row CSV
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
table: stopped by a raise at iteration 3 and resumed to the unbroken
model text, launching the kernels for the remaining trees only, and a
CLI run SIGKILLed at iteration 3 and rerun to the unbroken model file
(see ``checkpoint_phase``).  Phase 14 arms the observability layer
around the main path (the JSONL sink fenced, memory gauges, health, the
profiler, the flight recorder, the stall watchdog with a stall injected)
and requires the unarmed model text, route counters equal to the kernel
counts, fenced phases within each iteration's wall, a memory block and a
roofline that read the H100, both kernels' events in the profiler trace,
one flight dump, clean health blocks, and a ServingFront's monitor
windows and drift against the model's ``score_reference=`` line, checked
by ``scripts/trace_report.py`` and ``scripts/monitor_report.py`` (see
``observability_phase``).  Phase 15 runs the parallel learners in worker
processes (this script with ``--parallel-worker``): a one-rank NCCL world
on the main path under ``tree_learner=data`` (phase 4's model text), two
ranks sharing the card over gloo under both data-parallel schedules
(int8 byte-equal to serial, float32 alike to serial's), the
feature-parallel learner (byte-equal to serial), and the CLI under
``torch.distributed.run`` (rank files byte-equal); every rank launches
the kernels on its own rows (see ``parallel_phase``;
``chip_smoke.py --phase15`` runs the build, phase 4's main path and
phase 15 alone).  Phase 16 runs the hybrid and voting learners in one
world of four ranks sharing the card over gloo, a 2-D grid of ranks
(rank r at data index r // fs, feature index r % fs): hybrid 2 x 2
compacted float32 (alike to serial, AUC within 1e-4) and int8
(byte-equal), hybrid ``mixed_bin=true`` int8 on a table of narrow and
wide columns in each block, masked and compacted (the block-local plan,
byte-equal to the serial uniform text), voting 4 x 1 depth-wise int8
(``top_k=20``, exact: byte-equal), voting 2 x 2 compacted float32
(``top_k=4``, PV-tree: AUC within 0.01), and the CLI under
``torch.distributed.run`` with ``tree_learner=hybrid`` (four rank files
byte-equal); every rank's kernel launches and wire bytes per site are
checked (see ``hybrid_voting_phase``; ``chip_smoke.py --phase16`` runs
the build and phase 16 alone).  Phase 17 runs GOSS, checkpoints and the
straggler drain across worlds sharing the card over gloo: GOSS under
``tree_learner=data`` at 2 ranks (int8 byte-equal to serial GOSS,
float32 serial's first tree and AUC) and under hybrid 2 x 2; rank 1
SIGKILLed at iteration 2 and the world restarted from its checkpoints
(int8 and float32 byte-equal to the unbroken runs); a 2-rank checkpoint
resumed on 3 ranks and on one (serial's int8 text; the 3 ranks armed
with the drain, which equal work must not set off); and the drain of a
3-rank world whose rank 2 sleeps before every iteration, flagged from
the ranks' measured work, every rank stopped by the named ``Fatal``
after the checkpoint and the survivors' 2-rank restart serial's text,
all at the main path's 255 leaves;
each rank's launches of both kernels are checked per path (see
``goss_elastic_phase``; ``chip_smoke.py --phase17`` runs the build and
phase 17 alone).  Phase 18 runs observability over worlds sharing the
card over gloo, at 255 leaves, int8: a 2-rank ``tree_learner=data``
world whose ``metrics_out`` rank 0 alone writes (every line JSON, the
serial run's record count) and whose ``timeline=auto`` writes a headed
shard a rank, read by ``scripts/port_timeline_report.py``; every rank's
health blocks, ``quant_sat`` included, the serial run's there and in a
hybrid 2 x 2 world; a 2-rank world whose rank 1 has NaN gradients
stopped on both ranks at iteration 1 by ``on_anomaly=halt``; the ranks'
trace dumps under the armed drain aligned by the port's podtrace
(``scripts/port_pod_report.py --check``); each rank's launches of both
kernels checked (see ``observability_world_phase``; ``chip_smoke.py
--phase18`` runs the build and phase 18 alone).  Phase 19 loads a 1M-row
CSV of about 281 MB through every load route in two 2-rank
``tree_learner=data`` worlds sharing the card over gloo: resident text,
``streaming=auto``, two byte-range workers a rank, two-round writing a
reference-format cache, resident writing the native cache (rank 0
alone, byte-equal to a serial load's), that cache as ``data=`` and as
the sibling, and the reference-format sibling; every rank's rows, bins,
labels and weights (a)'s, one int8 model text at 255 leaves from every
route, each rank's launches of both kernels checked (see
``world_ingest_phase``; ``chip_smoke.py --phase19`` runs the build and
phase 19 alone).  Phase 20 runs in this process while phase 19's world
loads and trains.  It serves every lane of the JAX engine on the
card: phase 4's, phase 11's (b) and phase 7's multiclass models on 2, 3
and 4 tree shards placed on the one card (``["cuda:0"] * k``; 5 trees
at 4 shards leave one shard empty), float32 and int8, at every bucket,
scores and leaf indices bitwise the one-device engine's and the CPU
sharded engine's; ``scores()`` latency at 1, 2 and 4 shards; the
``serve/tree_carry`` hops; the device rule (``shards`` past the device
count fails with the JAX message, through the engine and
``task=predict``); ``predict_algo=scan`` bitwise ``bfs``, timed beside
it, and its ``task=predict`` file byte-equal to ``bfs``'s; a front
hot-swapped from 2 float32 shards to 4 int8 shards; no kernel launch
while serving (see ``sharded_phase``; ``chip_smoke.py --phase20`` runs
the build, the three models trained anew and phase 20 alone).  Phase 9
also times int8 with stochastic rounding (the hash and quantization,
then the launch) beside its plain version and ``scatter_add_`` of the
same levels.

The worlds of phases 15-19 train ``WORLD_ITERS`` (2) trees a job where
the check holds a world against a serial run (phase 19's routes one,
phase 13 six iterations), and start before the serial runs they are held
against, so that the script stays well inside its time limit; it prints
each phase's wall seconds and a ``{"phase_seconds": ...}`` line.  Every
phase must pass; the last line of standard output is ``{"ok": true,
"device": {...}}``.  Exits nonzero, printing no result, when there is no
CUDA device or the package is not beside this script.
"""
from __future__ import annotations

import atexit
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
FULL = {"n_train": 1_000_000, "n_test": 100_000, "n_int8": 100_000,
        "serve_iters": 200, "serve_cpu_rows": 10_000, "front_s": 5.0,
        "predict_rows": 20_000,
        "shard_front_s": 3.0,
        "hist_shapes": ((28, 1_000_000, 256, 1, 0), (28, 1_000_000, 256, 42, 0),
                        (28, 1_000_000, 256, 64, 0), (200, 250_000, 256, 1, 0),
                        (28, 2047, 256, 1, 0), (28, 300_001, 256, 1, 13)),
        "pane_segment": (12_345, 300_001), "n_f200": 250_000,
        "int8_cols": (1, 8, 32, 64), "n_es": 40_000, "n_cli": 100_000,
        "class_cols": (1, 8, 64), "wide_cols": (1, 8, 64),
        "n_ingest": 1_000_000, "ingest_parse_rows": 200_000,
        "n_world_ingest": 1_000_000,
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
    say("chip_smoke: phases 1-20 in %.1f s" % (time.perf_counter() - t0))
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
    """Phases 2-20 on ``dev``; returns the kernel records.  ``timer``
    replaces the CUDA-event timer (a CPU rehearsal passes a host clock)."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import compact, hist_cuda
    from lightgbm_tpu_torch.ops.hist_cuda import quantize_values
    timer = timer or cuda_ms
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    laps, clock = {}, [time.perf_counter()]

    def lap(phase):
        """Print and keep the wall seconds of the phase that just ended."""
        now = time.perf_counter()
        laps[phase] = round(now - clock[0], 1)
        clock[0] = now
        say("phase %s wall: %.1f s" % (phase, laps[phase]))

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

    lap("2")
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

    lap("3")
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

    lap("4")
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

    lap("5")
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

    lap("6")
    # ---- phase 7: the other objectives through the same kernels
    for path, counts in objectives_phase(dev, sizes, x, latent, train_set,
                                         sync, timer, served).items():
        kernels["hist"]["launches_by_path"][path] = counts["hist"]
        kernels["partition"]["launches_by_path"][path] = counts["partition"]
    lap("7")
    # ---- phase 8: sampling, early stopping and continued training
    for path, counts in sampling_phase(dev, sizes, x, y, train_set,
                                       sync).items():
        kernels["hist"]["launches_by_path"][path] = counts["hist"]
        kernels["partition"]["launches_by_path"][path] = counts["partition"]
    lap("8")
    # ---- phase 9: mixed-bin packing, bfloat16 and stochastic rounding
    by_path, records = mixed_phase(dev, sizes, sync, timer)
    for path, counts in by_path.items():
        kernels["hist"]["launches_by_path"][path] = counts["hist"]
        kernels["partition"]["launches_by_path"][path] = counts["partition"]
    kernels["hist"].update(records)
    lap("9")
    # ---- phase 10: 16-bit bins (max_bin = 1023)
    kernels.update(wide_phase(dev, sizes, x, y, sync, timer))
    lap("10")
    # ---- phase 11: serving, which launches neither kernel; (b)'s training
    # is an 8-bit path
    for path, counts in serving_phase(dev, sizes, x, train_set, served, sync,
                                      timer).items():
        for name, k in kernels.items():
            if path == "serving" or not name.endswith("16"):
                k["launches_by_path"][path] = counts[
                    "hist" if name.startswith("hist") else "partition"]
    lap("11")
    # ---- phase 12: the ingest layer, every load route onto the card
    for path, counts in ingest_phase(dev, sizes, sync).items():
        kernels["hist"]["launches_by_path"][path] = counts["hist"]
        kernels["partition"]["launches_by_path"][path] = counts["partition"]
    lap("12")
    # ---- phase 13: checkpoints and resume on phase 4's table
    for path, counts in checkpoint_phase(dev, sizes, train_set,
                                         sync).items():
        kernels["hist"]["launches_by_path"][path] = counts["hist"]
        kernels["partition"]["launches_by_path"][path] = counts["partition"]
    lap("13")
    # ---- phase 14: observability around the main path
    for path, counts in observability_phase(dev, sizes, x, y, train_set,
                                            served, sync).items():
        kernels["hist"]["launches_by_path"][path] = counts["hist"]
        kernels["partition"]["launches_by_path"][path] = counts["partition"]
    lap("14")
    # ---- phase 15: the parallel learners, worker processes on the card
    for path, counts in parallel_phase(dev, sizes, x, y, served,
                                       sync).items():
        kernels["hist"]["launches_by_path"][path] = counts["hist"]
        kernels["partition"]["launches_by_path"][path] = counts["partition"]
    lap("15")
    # ---- phase 16: the hybrid and voting learners, a grid of 4 ranks
    for path, counts in hybrid_voting_phase(dev, sizes, x, y,
                                            sync).items():
        kernels["hist"]["launches_by_path"][path] = counts["hist"]
        kernels["partition"]["launches_by_path"][path] = counts["partition"]
    lap("16")
    # ---- phase 17: GOSS, checkpoints and the drain across worlds
    for path, counts in goss_elastic_phase(dev, sizes, x, y, sync).items():
        kernels["hist"]["launches_by_path"][path] = counts["hist"]
        kernels["partition"]["launches_by_path"][path] = counts["partition"]
    lap("17")
    # ---- phase 18: observability over worlds
    for path, counts in observability_world_phase(dev, sizes, x, y,
                                                  sync).items():
        kernels["hist"]["launches_by_path"][path] = counts["hist"]
        kernels["partition"]["launches_by_path"][path] = counts["partition"]
    lap("18")
    # ---- phase 19: every load route in a world, whose ranks load and
    # train beside phase 20 in this process
    # ---- phase 20: tree-sharded and per-tree replay serving, which
    # launch neither kernel
    by_path, serving_counts = world_ingest_phase(
        dev, sizes, sync,
        beside=lambda: sharded_phase(dev, sizes, x, served, sync))
    for path, counts in by_path.items():
        kernels["hist"]["launches_by_path"][path] = counts["hist"]
        kernels["partition"]["launches_by_path"][path] = counts["partition"]
    for path, counts in serving_counts.items():
        for name, k in kernels.items():
            k["launches_by_path"][path] = counts[
                "hist" if name.startswith("hist") else "partition"]
    lap("19-20")
    say(json.dumps({"phase_seconds": laps}))
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


# served model (b): bench.py's headline configuration (bench.py:1277-1289)
# on the main-path table, at a realistic ensemble size (``serve_iters``)
SERVE_B = {"objective": "binary", "grow_policy": "depthwise",
           "hist_dtype": "int8", "num_leaves": 255, "min_data_in_leaf": 100,
           "min_sum_hessian_in_leaf": 10, "learning_rate": 0.1,
           "max_bin": 255}


def scan_vs_bfs(flat, codes, tables):
    """The per-tree replay (``predict_algo=scan``, served by the port's
    engine since the walk of lightgbm_tpu/ops/scoring.py:89-117 was
    ported): ``scoring.ensemble_scores``, each tree's splits replayed in
    turn and its leaf values added into its class row in tree order.  At
    1, 1,024 and all of ``codes``' rows it must give the breadth-first
    walk's float32 scores bitwise; each replay call is timed on the host
    clock between device synchronizes (one call launches ~5 small
    operations a split), the walk as the better of 2 calls."""
    import torch
    from lightgbm_tpu_torch.ops import scoring

    def replay(c):
        return scoring.ensemble_scores(
            c, flat.split_feature, flat.threshold_rank, flat.left_child,
            flat.right_child, tables["lv"], flat.num_leaves,
            flat.tree_class, num_class=flat.num_class)

    def bfs(c):
        return scoring.bfs_scores(
            c, tables["sf"], tables["tr"], tables["lc"], tables["rc"],
            tables["lv"], tables["root"], flat.tree_class,
            max_depth=flat.max_depth, num_class=flat.num_class)

    rec = {}
    for n in (1, 1024, codes.shape[1]):
        c = codes[:, :n].contiguous()
        scan_ms, got = timed_call(replay, c)
        if not torch.equal(got, bfs(c)):
            fail("phase 11 (b): the per-tree replay's scores differ from "
                 "the breadth-first walk's at %d rows" % n)
        rec[str(n)] = {"scan_ms": scan_ms, "bfs_ms": wall_ms(bfs, c)}
    say("phase 11 (b) float32, the walk alone on the host clock, per-tree "
        "replay (predict_algo=scan) against breadth-first, equal bitwise: "
        "%s" % " ".join(
            "%s rows %.3f / %.3f ms" % (n, v["scan_ms"], v["bfs_ms"])
            for n, v in rec.items()))
    return rec


def timed_call(fn, *args):
    """``(ms, fn(*args))``: one call on the host clock between two device
    synchronizes."""
    import torch
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn(*args)
    sync()
    return (time.perf_counter() - t0) * 1e3, out


def wall_ms(fn, *args, calls: int = 2) -> float:
    """The better of ``calls`` ``timed_call``s of ``fn(*args)``, in ms."""
    return min(timed_call(fn, *args)[0] for _ in range(calls))


def front_swap(what, old, new, x_test, seconds, n_alone):
    """A ServingFront over the ``old`` engine (a ``(name, engine)`` pair)
    with 8 client threads for ``seconds``, each submitting 1-32 held-out
    rows and waiting for them, hot-swapped to ``new`` half way: every
    request must resolve, on ``old`` before the swap began and on
    ``new`` after it ended, never back, and equal to its rows scored on
    that engine: every request within one batch of all requests' rows,
    and ``n_alone`` of them alone.  Returns the front's record."""
    import threading
    from lightgbm_tpu_torch import serving
    n_test = len(x_test)
    engines = dict((old, new))
    front = serving.ServingFront(old[1].warmup())
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
    time.sleep(seconds / 2)
    t_swap0 = time.perf_counter()
    drain_s = front.swap_engine(new[1], timeout=60)
    t_swap1 = time.perf_counter()
    time.sleep(seconds / 2)
    stop.set()
    for th in threads:
        th.join(120)
    elapsed = time.perf_counter() - t_start
    front.close()
    if errors or any(th.is_alive() for th in threads):
        fail("%s: a client failed or hung: %r" % (what, errors[:3]))
    reqs = [q for lg in logs for q in lg]
    if front.stats["requests"] != len(reqs) or front.stats["swaps"] != 1:
        fail("%s: %d submitted, %d resolved, %d swaps"
             % (what, front.stats["requests"], len(reqs),
                front.stats["swaps"]))
    allrows = np.concatenate([x_test[s0:s0 + n] for s0, n, _, _, _ in reqs])
    whole = {k: eng.scores(allrows) for k, eng in engines.items()}
    ofs, routed = 0, []
    for s0, n, t0, t1, got in reqs:
        on = [k for k, v in whole.items()
              if np.array_equal(got, v[:, ofs:ofs + n])]
        if not on:
            fail("%s: a request's scores match neither engine" % what)
        routed.append(on)
        ofs += n
    k = 0
    for lg in logs:
        seen_new = False
        for s0, n, t0, t1, got in lg:
            on = routed[k]
            k += 1
            if on == [new[0]]:
                seen_new = True
            if (t1 < t_swap0 and old[0] not in on) \
                    or (t0 > t_swap1 and new[0] not in on) \
                    or (seen_new and new[0] not in on):
                fail("%s: a request scored on the wrong engine" % what)
    pick = np.random.RandomState(SEED).choice(len(reqs),
                                              min(n_alone, len(reqs)), False)
    for j in pick:
        s0, n, _, _, got = reqs[j]
        if not np.array_equal(got, engines[routed[j][0]].scores(
                x_test[s0:s0 + n])):
            fail("%s: request %d differs from its rows scored alone"
                 % (what, j))
    lat_ms = np.array([t1 - t0 for _, _, t0, t1, _ in reqs]) * 1e3
    on_old = sum(r == [old[0]] for r in routed)
    fr = {"clients": 8, "seconds": elapsed, "requests": len(reqs),
          "rows": int(sum(n for _, n, _, _, _ in reqs)),
          "requests_per_s": len(reqs) / elapsed,
          "p50_ms": float(np.percentile(lat_ms, 50)),
          "p99_ms": float(np.percentile(lat_ms, 99)),
          "batches": front.stats["batches"], "swap_drain_ms": drain_s * 1e3,
          "on_" + old[0]: on_old, "on_" + new[0]: len(reqs) - on_old,
          "checked_alone": len(pick)}
    say("%s, 8 clients, %.1f s: %d requests (%d rows) in %d batches, %.1f "
        "requests/s, latency p50 %.3f ms p99 %.3f ms; swap %s -> %s "
        "drained in %.3f ms, %d requests on %s and %d on %s, none lost or "
        "routed back; every request equal to its rows in one batch, %d "
        "scored alone" % (
            what, elapsed, fr["requests"], fr["rows"], fr["batches"],
            fr["requests_per_s"], fr["p50_ms"], fr["p99_ms"], old[0],
            new[0], fr["swap_drain_ms"], on_old, old[0],
            len(reqs) - on_old, new[0], fr["checked_alone"]))
    return fr


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
    [T, N] int32 intermediates and the codes).  On (b) float32 the
    per-tree replay (``predict_algo=scan``, ``scoring.ensemble_scores``,
    which the port serves) is timed beside the breadth-first walk at 1,
    1,024 and 65,536 rows, and must give its scores bitwise.  Then a
    ServingFront over (b) float32 with 8 client threads for ``front_s``
    seconds swaps to (b) int8 half way (``front_swap``: no request lost
    or routed back, each equal to its rows on its engine, 1,000 scored
    alone).  Last, ``python -m lightgbm_tpu_torch
    task=predict`` on the first ``predict_rows`` held-out rows with (b),
    with ``predict_leaf_index=true`` and with ``predict_quantize=int8``:
    the card's result files byte-equal to ``device=cpu``'s.  Neither kernel
    may launch in this process while it serves: the counts cover the
    engines and the front; the ``task=predict`` runs are subprocesses,
    whose launches these counts cannot see.  Prints a ``{"serving": ...}``
    line; returns the launch counts of (b)'s training and of serving."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import serving
    from lightgbm_tpu_torch.ops import compact, hist_cuda, scoring
    n_train, n_test = sizes["n_train"], sizes["n_test"]
    x_test = x[n_train:]
    t_phase = time.perf_counter()
    by_path = {}
    booster, iter_s, counts = drive(
        dict(SERVE_B, num_iterations=sizes["serve_iters"]), train_set, dev,
        sync)
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
            (t,) = card._device_tables()
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
    rec["front"] = front_swap(
        "phase 11 front over (b)",
        ("float32", serving.ServingEngine(flat_b, device=dev)),
        ("int8", serving.ServingEngine(flat_b, quantize="int8", device=dev)),
        x_test, sizes["front_s"], 1000)

    # task=predict through the CLI, on the card and on the CPU at once
    data = os.path.join(tmp, "held_out.tsv")
    n_predict = min(n_test, sizes["predict_rows"])
    np.savetxt(data, np.column_stack([np.zeros(n_predict),
                                      x_test[:n_predict]]),
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
        if card_text != cpu_text or card_text.count(b"\n") != n_predict:
            fail("phase 11 task=predict %s: the card's result file differs "
                 "from device=cpu's" % mode)
        say("phase 11 task=predict %s, (b) on %d rows: the card's result "
            "file (%d bytes) byte-equal to device=cpu's" % (
                mode, n_predict, len(card_text)))
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
    ``n_ingest`` rows (1M, cut from the Higgs file's 11M to fit this
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
    compacted, 3 iterations) from (a), (b), (c) and (e) must launch the
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
        # model text from every route, and from (a) trained twice.  Three
        # iterations: each later tree grows from the scores of the ones
        # before
        params = {"objective": "binary", "num_leaves": 255,
                  "num_iterations": 3, "learning_rate": 0.1,
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
                if not (len(booster.models) == params["num_iterations"]
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
    the threefry draw on the card, feature_fraction 0.8), 6 iterations
    each (two bagging draws).  Each trains unbroken twice, the second
    time writing a checkpoint every iteration: one model text (the float
    histogram's sums are the same on every run).  Then a run with
    ``checkpoint_interval=1`` is stopped by ``faults.arm(3, "raise")`` and
    the same call resumes it: the unbroken run's model text, with one
    histogram launch a leaf and one partition a split of the three
    remaining trees (the second draw among them) and no more.  A CLI run
    on the table's native cache, SIGKILLed at iteration 3 (rc -9; it runs
    beside the unbroken CLI run, both beside the runs in this process),
    and the same command again: the unbroken CLI run's model file, byte
    for byte.  Recorded, not
    gated: checkpoint bytes, seconds per iteration with a checkpoint
    every iteration against none, restore seconds, the writer's written
    and dropped counts.  Returns the kernel launches of each resumed
    run."""
    import shutil
    import threading
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import checkpoint, faults
    from lightgbm_tpu_torch.objectives import create_objective
    card = card_name()
    t_phase = time.perf_counter()
    rec, by_path = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    clis = []     # every CLI run started, stopped by the end of the phase
    iters, stop = sizes.get("ckpt_iters", 6), 3
    main_path = {"objective": "binary", "num_leaves": 255,
                 "num_iterations": iters, "learning_rate": 0.1,
                 "hist_dtype": "float32", "max_bin": 255}
    sampled = {"objective": "binary", "num_leaves": 63,
               "num_iterations": iters, "learning_rate": 0.1,
               "hist_dtype": "int8", "max_bin": 255,
               "bagging_fraction": 0.8, "bagging_freq": 5,
               "feature_fraction": 0.8}
    try:
        # the CLI on the table's native cache: SIGKILLed at ``stop``, then
        # the same command again
        cache = os.path.join(tmp, "train.bin")
        train_set.save_binary(cache)

        def cli_args(out, ckdir):
            return (["task=train", "data=" + cache, "objective=binary",
                     "num_leaves=255", "num_iterations=%d" % iters,
                     "learning_rate=0.1", "max_bin=255",
                     "device=" + dev.type, "output_model=" + out,
                     "checkpoint_interval=1", "checkpoint_dir=" + ckdir])

        def start_cli(args, arm=None):
            code = ("import sys\n"
                    "from lightgbm_tpu_torch import cli, faults\n"
                    + ("faults.arm(%d, 'kill')\n" % arm if arm else "")
                    + "sys.exit(cli.main(%r))\n" % (args,))
            run = {"t0": time.perf_counter(), "proc": subprocess.Popen(
                [sys.executable, "-c", code],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}

            def wait():
                try:
                    run["out"] = run["proc"].communicate(timeout=600)
                except subprocess.TimeoutExpired:
                    run["proc"].kill()
                    run["out"] = run["proc"].communicate()
                run["s"] = time.perf_counter() - run["t0"]

            run["waiter"] = threading.Thread(target=wait, daemon=True)
            run["waiter"].start()
            clis.append(run)
            return run

        def finish_cli(run):
            """(the run's CompletedProcess, its own seconds)."""
            run["waiter"].join()
            proc = run["proc"]
            return subprocess.CompletedProcess(
                proc.args, proc.returncode, *run["out"]), run["s"]

        # the unbroken run and the one killed at ``stop`` side by side,
        # beside the runs in this process
        whole_out = os.path.join(tmp, "whole.txt")
        model, ckdir = os.path.join(tmp, "model.txt"), os.path.join(tmp,
                                                                    "cli1")
        cli_whole = start_cli(cli_args(whole_out, os.path.join(tmp, "cli0")))
        cli_killed = start_cli(cli_args(model, ckdir), arm=stop)

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

        out, whole_cli_s = finish_cli(cli_whole)
        killed_out, killed_s = finish_cli(cli_killed)
        if out.returncode != 0:
            fail("phase 13 CLI unbroken run exited %d: %s"
                 % (out.returncode, out.stderr[-2000:]))
        out = killed_out
        if out.returncode != -9:
            fail("phase 13 CLI run armed to kill at %d exited %d: %s"
                 % (stop, out.returncode, out.stderr[-2000:]))
        at_kill = checkpoint.load_checkpoint(
            checkpoint.latest_checkpoint(ckdir))["iteration"]
        out, resumed_cli_s = finish_cli(start_cli(cli_args(model, ckdir)))
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
        for run in clis:
            if run["proc"].poll() is None:
                run["proc"].kill()
            run["waiter"].join()
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


PARALLEL_WORKER = "--parallel-worker"
PARALLEL_TIMEOUT_S = 240     # a world's limit: killed, and the phase fails
# the iterations of most world jobs of phases 15-18: the second tree
# grows from the scores the first left on every rank
WORLD_ITERS = 2
PHASE16_TIMEOUT_S = 420      # phase 16's one world of 4 ranks and 6 jobs


def world_load(cfg, shard, dev, sync, job):
    """A phase-19 job's dataset: this rank's shard of the job's file by
    the route its keys choose (``Dataset.load_train`` with the world's
    bin finder; ``streaming=auto`` at the parent's threshold, the job's
    ``auto_min_bytes``), and what it loaded: seconds, sizes, the sha256
    of its row indices, bins (read back from where they live), labels and
    weights, where the bins live, the cache gather's bytes and seconds."""
    import hashlib
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.io import streaming
    from lightgbm_tpu_torch.parallel import learners
    streaming.AUTO_MIN_BYTES = job["auto_min_bytes"]

    def digest(a):
        return None if a is None else hashlib.sha256(
            np.ascontiguousarray(a).tobytes()).hexdigest()

    sync()
    t0 = time.perf_counter()
    ds = lgt.Dataset.load_train(
        cfg.io_config, rank=shard[1], num_machines=shard[2], device=dev,
        bin_finder=learners.distributed_bin_finder()
        if cfg.is_parallel_find_bin else None)
    sync()
    md = ds.metadata
    return ds, {
        "s": time.perf_counter() - t0, "num_data": int(ds.num_data),
        "global_num_data": int(ds.global_num_data),
        "rows": digest(ds.used_data_indices), "bins": digest(ds.read_bins()),
        "label": digest(md.label), "weights": digest(md.weights),
        "bins_on": ("host" if ds.bins is not None
                    else ds.device_bins.device.type),
        "world_cache": ds.world_cache}


def parallel_worker(spec_path: str) -> int:
    """One rank of a phase-15, 16, 17, 18 or 19 world (``chip_smoke.py
    --parallel-worker spec.json``, under torch's environment): join the
    world, train each job of the spec through ``lightgbm_tpu_torch.train``
    on this rank's rows of the job's table (``learners.row_shard``: its
    shard under ``tree_learner=data``, its data index's under ``hybrid``
    and ``voting``, every row under ``feature``) with every kernel count
    set to 0 just before and read just after, and write the model text
    and what was measured, job by job.  Telemetry is armed (no sink) for
    the collective sites and the route counters, unless the job is
    ``unarmed``; a job's own observability keys (a sink, ``timeline``,
    ``health``, trace dumps) arm its session, their paths relative to
    the world's directory.  Phase 17's jobs may arm a fault on some
    ranks (``fault``), expect an error, recorded (``expect_error``), and
    slow one rank down (``slow``: [rank, seconds of its own work before
    every iteration], a straggler as the drain measures it); the restore
    of a resumed run is timed.  Phase 18's may give some ranks NaN
    gradients in their first rows (``poison``: the ranks) and end the
    process with exit code 3 after the expected error (``halt``).  Phase
    19's load their rows by a route of ``Dataset.load_train`` (``load``:
    the job's keys name the file and the route; ``world_load``), job by
    job, and record what they loaded."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import elastic, faults, parallel, telemetry
    from lightgbm_tpu_torch.config import OverallConfig
    from lightgbm_tpu_torch.objectives import binary
    from lightgbm_tpu_torch.ops import compact, hist_cuda
    from lightgbm_tpu_torch.parallel import learners
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    spec = json.load(open(spec_path))
    dev = spec["device"]
    parallel.init_distributed()
    rank = parallel.get_rank()
    tables = spec["tables"]
    sync = torch.cuda.synchronize if dev != "cpu" else (lambda: None)
    restore_s = []
    resume = lgt.GBDT.resume_latest

    def timed_resume(self, directory):
        t0 = time.perf_counter()
        resume(self, directory)
        restore_s.append(time.perf_counter() - t0)

    lgt.GBDT.resume_latest = timed_resume
    exchanged, exchange = [], elastic.exchange_times

    def kept_exchange(comm, seconds, iteration=None):
        out = exchange(comm, seconds, iteration)
        exchanged.append([float(v) for v in out])
        return out

    elastic.exchange_times = kept_exchange
    train_one_iter = lgt.GBDT.train_one_iter

    def slowed(seconds):
        def slow_iter(self, *args, **kwargs):
            time.sleep(seconds)
            return train_one_iter(self, *args, **kwargs)
        return slow_iter

    gradients = binary.BinaryLogloss.get_gradients

    def poisoned(self, score):
        grad, hess = gradients(self, score)
        grad = grad.clone()
        grad[..., :3] = float("nan")
        return grad, hess

    sets, out, halted = {}, {}, False
    for job in spec["jobs"]:
        cfg = OverallConfig()
        cfg.set({k: str(v) for k, v in job["params"].items()},
                require_data=False)
        table = job.get("table", "main")
        shard = (table,) + learners.row_shard(cfg)
        loaded = None
        if job.get("load"):
            loaded = world_load(cfg, shard, dev, sync, job)
        elif shard not in sets:
            t0 = time.perf_counter()
            x = np.load(tables[table][0]).astype(np.float64)
            sets[shard] = lgt.Dataset.from_arrays(
                x, np.load(tables[table][1]), max_bin=255, rank=shard[1],
                num_machines=shard[2])
            del x
            say("rank %d: %s table, shard %d of %d: %d rows in %.1f s" % (
                rank, table, shard[1], shard[2], sets[shard].num_data,
                time.perf_counter() - t0))
        iter_s, clock = [], [0.0]

        def progress(it):
            sync()
            now = time.perf_counter()
            iter_s.append(now - clock[0])
            clock[0] = now

        fault = job.get("fault")
        if fault and rank in fault["ranks"]:
            faults.arm(fault["at"], fault["kind"])
        if job.get("slow", [None])[0] == rank:
            lgt.GBDT.train_one_iter = slowed(job["slow"][1])
        binary.BinaryLogloss.get_gradients = (
            poisoned if rank in job.get("poison", ()) else gradients)
        if not job.get("unarmed"):
            telemetry.enable()
            telemetry.reset()
        reset_counts()
        del restore_s[:]
        del exchanged[:]
        sync()
        clock[0] = t_job = time.perf_counter()
        booster, error = None, None
        try:
            booster = lgt.train(job["params"], sets[shard] if loaded is None
                                else loaded[0], device=dev,
                                progress_fn=progress)
        except Exception as e:
            if not job.get("expect_error"):
                raise
            error = "%s: %s" % (type(e).__name__, e)
            halted = halted or bool(job.get("halt"))
        finally:
            faults.disarm()
            lgt.GBDT.train_one_iter = train_one_iter
        sync()
        counts = {"hist": hist_cuda.launches, "partition": compact.launches,
                  "partition_kernels": compact.kernel_launches}
        counters = telemetry.counters()
        routes = {k: v for k, v in counters.items()
                  if k.startswith(("hist/", "partition/"))}
        ic = telemetry.interconnect_snapshot() or {"sites": {}}
        telemetry.disable()
        telemetry.reset()
        rec = {
            "iter_s": iter_s, "counts": counts, "routes": routes,
            "sites": {k: {"calls": v["calls"], "bytes": v["bytes"],
                          "bytes_per_call": v["bytes_per_call"],
                          "seconds": v["seconds"], "axis": v["axis"]}
                      for k, v in ic["sites"].items()},
            "counters": {k: v for k, v in counters.items()
                         if k.startswith(("ckpt/", "elastic/", "goss/"))},
            "restore_s": list(restore_s), "error": error,
            "job_s": time.perf_counter() - t_job,
            "busy_s": list(exchanged),
            "rows": (sets[shard] if loaded is None
                     else loaded[0]).num_data}
        if loaded is not None:
            rec["load"] = loaded[1]
            loaded = None
        if booster is not None:
            path = os.path.join(spec["dir"], "%s.rank%d.txt" % (job["name"],
                                                                rank))
            with open(path, "w") as f:
                f.write(booster.model_to_string())
            grid = getattr(booster._learner, "grid", None)
            rec.update(backend=booster._learner.comm.backend,
                       world=booster._learner.world,
                       grid=None if grid is None else list(grid[:4]),
                       leaves=[t.num_leaves for t in booster.models])
        out[job["name"]] = rec
        # job by job: a later job may lose this process (a SIGKILL)
        with open(os.path.join(spec["dir"], "out.%d.json" % rank),
                  "w") as f:
            json.dump(out, f)
    parallel.shutdown()
    return 3 if halted else 0


def run_world(tmp, name, nprocs, jobs, dev, data, phase=15,
              timeout=PARALLEL_TIMEOUT_S, threads=None):
    """A phase-15 (or 16) world of ``nprocs`` worker processes on ``dev``,
    each running ``jobs``; ``data``: the (x, y) .npy paths, or a dict of
    them by table name; ``threads``: each rank's intra-op threads
    (``OMP_NUM_THREADS``).  Fails the phase if a rank fails or the world
    runs past ``timeout``.  Returns ([rank] -> {job: record}, its
    directory)."""
    return finish_world(start_world(tmp, name, nprocs, jobs, dev, data,
                                    timeout, threads), phase)[:2]


def start_world(tmp, name, nprocs, jobs, dev, data,
                timeout=PARALLEL_TIMEOUT_S, threads=None):
    """``run_world``'s world, started and not waited for (worlds of one
    phase may run side by side): (world, directory, name, start)."""
    from lightgbm_tpu_torch.parallel.launch import LocalWorld
    wdir = os.path.join(tmp, name)
    os.makedirs(wdir)
    spec = os.path.join(wdir, "spec.json")
    tables = data if isinstance(data, dict) else {"main": list(data)}
    with open(spec, "w") as f:
        json.dump({"device": dev.type, "tables": tables, "dir": wdir,
                   "jobs": jobs}, f)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    t0 = time.perf_counter()
    world = LocalWorld([sys.executable, os.path.abspath(__file__),
                        PARALLEL_WORKER, spec], nprocs, wdir, timeout, env)
    if not STARTED_WORLDS:
        atexit.register(stop_started_worlds)
    STARTED_WORLDS.append(world)
    return world, wdir, name, t0


# every world start_world started: a phase that fails while one runs
# (``fail`` exits the script) leaves no rank behind
STARTED_WORLDS = []


def stop_started_worlds():
    for world in STARTED_WORLDS:
        world.kill()


def finish_world(started, phase, killed=(), rc_ok=0):
    """Wait for a ``start_world`` world: fails the phase if it runs past
    its limit or a rank exits with another code than ``rc_ok``, but for
    the ranks of ``killed`` (rank 1 SIGKILLed) and, where one was, rank
    0 (its peer gone mid collective).  Returns ([rank] -> {job: record},
    its directory, the exit codes)."""
    from lightgbm_tpu_torch.parallel.launch import WorldTimeout
    world, wdir, name, t0 = started
    try:
        ranks = world.wait()
    except WorldTimeout as e:
        fail("phase %d %s: %s" % (phase, name, e))
    rcs = [rc for rc, _ in ranks]
    for r, (rc, out) in enumerate(ranks):
        if rc != rc_ok and not killed:
            say(out[-6000:])
            fail("phase %d %s: rank %d exited %d" % (phase, name, r, rc))
    if killed and any(rcs[r] != -9 for r in killed):
        fail("phase %d %s: exit codes %s, ranks %s were to be killed"
             % (phase, name, rcs, list(killed)))
    say("phase %d %s: %d rank(s) in %.1f s (exit codes %s)" % (
        phase, name, world.nprocs, time.perf_counter() - t0, rcs))
    return [json.load(open(os.path.join(wdir, "out.%d.json" % r)))
            if os.path.exists(os.path.join(wdir, "out.%d.json" % r))
            else {} for r in range(world.nprocs)], wdir, rcs


def rank_texts(wdir, job, nprocs):
    return [open(os.path.join(wdir, "%s.rank%d.txt" % (job, r))).read()
            for r in range(nprocs)]


def held_out_auc(text, x_test, y_test, dev):
    """AUC of a model text's predictions on the held-out rows."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.metrics import AUCMetric
    booster = lgt.GBDT()
    booster.device = dev
    booster.models_from_string(text)

    class _Md:
        label = y_test
        weights = None

    auc = AUCMetric(None)
    auc.init("test", _Md, len(y_test))
    return float(auc.eval(booster.predict(x_test))[0])


def first_parting_split(text, want):
    """(tree, node, gain, want's gain) of the first split where two model
    texts part, or None."""
    import lightgbm_tpu_torch as lgt
    trees = []
    for t in (text, want):
        b = lgt.GBDT()
        b.models_from_string(t)
        trees.append(b.models)
    for k, (a, b) in enumerate(zip(*trees)):
        n = min(a.num_leaves, b.num_leaves) - 1
        for i in range(n):
            if (a.split_feature_real[i] != b.split_feature_real[i]
                    or a.threshold[i] != b.threshold[i]):
                return k, i, float(a.split_gain[i]), float(b.split_gain[i])
        if a.num_leaves != b.num_leaves:
            return k, n, float("nan"), float("nan")
    return None


def check_ranks(what, ranks, dev):
    """Every rank's route counters equal its own launches (``hist/cuda_*``
    and ``partition/cuda``), with no plain route, and it launched the
    histogram kernel.  On the CPU (a rehearsal) the plain routes stand
    for the launches, and ``counts`` takes them."""
    route = "cuda" if dev.type == "cuda" else "plain"
    for r, rec in enumerate(ranks):
        routes, c = rec["routes"], rec["counts"]
        hist_routes = sum(v for k, v in routes.items()
                          if k.startswith("hist/%s_" % route))
        part_routes = routes.get("partition/" + route, 0)
        if route == "plain":
            c.update(hist=hist_routes, partition=part_routes)
        other = [k for k in routes if k.startswith(("hist/", "partition/"))
                 and "/%s" % route not in k
                 and not k.startswith("hist/mixedbin")]
        if (other or hist_routes != c["hist"]
                or part_routes != c["partition"] or c["hist"] == 0):
            fail("%s rank %d: route counters %s against launches %s"
                 % (what, r, routes, c))


def parallel_phase(dev, sizes, x, y, served, sync):
    """Phase 15: the parallel learners in worker processes on the card,
    each rank through ``lightgbm_tpu_torch.train`` (and the CLI under
    ``torch.distributed.run``), every rank launching the kernels on its
    own rows:

    (a) a one-rank NCCL world on the main path (float32, compacted, 255
        leaves, 5 iterations) under ``tree_learner=data``: phase 4's
        model text;
    (b) two ranks sharing the card over gloo, ``tree_learner=data`` at
        main-path width under both schedules, ``WORLD_ITERS`` iterations:
        int8 model text byte-equal to a serial int8 run on the card;
        float32 against a serial float32 run of as many iterations: the
        first tree's structure exact and leaf values within rtol 1e-5,
        held-out AUC within 1e-4 (a later split that parts at a near-tie
        is printed with both gains); both ranks' texts equal; each rank's
        route counters equal its own launches (``hist/cuda_*`` and
        ``partition/cuda``, one histogram a leaf and one partition a
        split), no ``*/plain*``;
    (c) two ranks, ``tree_learner=feature``: masked float32
        (``WORLD_ITERS`` iterations) and depth-wise int8 (5), byte-equal
        to serial on the card;
    (d) the CLI through ``torch.distributed.run`` on the first n_cli rows
        of the table, ``WORLD_ITERS`` trees: the two ranks' model files
        byte-equal.

    The worlds of (a), (b) and (c) and (d)'s run side by side, and beside
    the serial runs they are held against.

    Prints each rank's seconds per iteration against serial, collective
    seconds per iteration and wire bytes per site, and each world's
    backend.  Returns the kernel launches of rank 0 of each path."""
    import shutil
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import telemetry
    from lightgbm_tpu_torch.ops import compact, hist_cuda
    card = card_name()
    t_phase = time.perf_counter()
    n_train = sizes["n_train"]
    x_test, y_test = x[n_train:], y[n_train:]
    main_params = {"objective": "binary", "num_leaves": 255,
                   "num_iterations": 5, "learning_rate": 0.1,
                   "hist_dtype": "float32", "max_bin": 255}
    dp = {"tree_learner": "data", "num_machines": 2}
    float32_params = dict(main_params, num_iterations=WORLD_ITERS)
    int8_params = dict(main_params, hist_dtype="int8",
                       num_iterations=WORLD_ITERS)
    masked = dict(main_params, leafwise_compact="false",
                  num_iterations=WORLD_ITERS)
    depthwise = dict(main_params, grow_policy="depthwise", hist_dtype="int8")
    rec, by_path = {"card": card}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    cli = None
    try:
        data = (os.path.join(tmp, "x.npy"), os.path.join(tmp, "y.npy"))
        # the table is float32 at heart (make_table): exact as float32
        np.save(data[0], x[:n_train].astype(np.float32))
        np.save(data[1], y[:n_train])

        # (a) one rank, NCCL on the card (CPU: gloo), (b) and (c) two
        # ranks sharing the card, and (d)'s CLI world, side by side
        one_started = start_world(tmp, "one_rank", 1, [
            {"name": "main", "params": dict(main_params, **dp)}], dev, data)
        # (d) the CLI under torch.distributed.run, device as the phase's
        n_cli = sizes["n_cli"]
        cli_dir = os.path.join(tmp, "cli")
        os.makedirs(cli_dir)
        np.savetxt(os.path.join(cli_dir, "train.tsv"),
                   np.column_stack([y[:n_cli], x[:n_cli]]), delimiter="\t",
                   fmt="%.9g")
        cli = start_cli_world(cli_dir, 2, [
            "task=train", "data=train.tsv", "objective=binary",
            "num_leaves=255", "num_trees=%d" % WORLD_ITERS,
            "hist_dtype=int8", "tree_learner=data", "num_machines=2",
            "output_model=m.txt", "device=%s" % dev.type])

        # (b) and (c): two ranks sharing the card
        jobs = [{"name": "dp_%s_%s" % (dt, s),
                 "params": dict(float32_params if dt == "float32"
                                else int8_params, dp_schedule=s, **dp)}
                for dt in ("int8", "float32")
                for s in ("psum", "reduce_scatter")]
        jobs += [{"name": "fp_masked_float32",
                  "params": dict(masked, tree_learner="feature",
                                 num_machines=2)},
                 {"name": "fp_depthwise_int8",
                  "params": dict(depthwise, tree_learner="feature",
                                 num_machines=2)}]
        two_started = start_world(tmp, "two_ranks", 2, jobs, dev, data)

        # the serial runs to hold the worlds against, armed as the workers
        train_set = lgt.Dataset.from_arrays(x[:n_train], y[:n_train],
                                            max_bin=255)
        serial, serial_s = {}, {}
        for name, params in (("main", main_params),
                             ("float32", float32_params),
                             ("int8", int8_params), ("masked", masked),
                             ("depthwise", depthwise)):
            telemetry.enable()
            booster, iter_s, _ = drive(params, train_set, dev, sync)
            telemetry.disable()
            telemetry.reset()
            serial[name] = booster.model_to_string()
            serial_s[name] = iter_s
        del train_set
        if serial["main"] != served["a"]:
            fail("phase 15: the serial main path differs from phase 4's")
        one, one_dir = finish_world(one_started, 15)[:2]
        ranks, wdir = finish_world(two_started, 15)[:2]

        # (a)'s checks
        a = one[0]["main"]
        want_backend = "nccl" if dev.type == "cuda" else "gloo"
        if a["backend"] != want_backend or a["world"] != 1:
            fail("phase 15a: backend %s, world %d" % (a["backend"],
                                                      a["world"]))
        if rank_texts(one_dir, "main", 1)[0] != served["a"]:
            fail("phase 15a: the one-rank data-parallel model text differs "
                 "from phase 4's")
        check_ranks("phase 15a", [a], dev)
        by_path["parallel_dp1_nccl"] = a["counts"]
        say("phase 15a one-rank %s world, tree_learner=data: phase 4's model "
            "text; seconds per iteration %s (serial %s)" % (
                a["backend"], ["%.3f" % v for v in a["iter_s"]],
                ["%.3f" % v for v in serial_s["main"]]))

        want_backend = "gloo"
        auc_serial = held_out_auc(serial["float32"], x_test, y_test, dev)
        for job in jobs:
            name = job["name"]
            recs = [r[name] for r in ranks]
            texts = rank_texts(wdir, name, 2)
            if texts[0] != texts[1]:
                fail("phase 15 %s: the ranks' model texts differ" % name)
            if any(r["backend"] != want_backend or r["world"] != 2
                   for r in recs):
                fail("phase 15 %s: backends %s" % (name, [
                    (r["backend"], r["world"]) for r in recs]))
            check_ranks("phase 15 " + name, recs, dev)
            leaves = recs[0]["leaves"]
            splits = sum(leaves) - len(leaves)
            for r, one in enumerate(recs):
                c = one["counts"]
                if name.startswith("dp_") and not (
                        c["hist"] == sum(leaves)
                        and c["partition"] == splits):
                    fail("phase 15 %s rank %d: %d histogram launches, %d "
                         "partitions; expected one a leaf (%d) and one a "
                         "split (%d)" % (name, r, c["hist"], c["partition"],
                                         sum(leaves), splits))
                if name.startswith("fp_") and c["partition"] != 0:
                    fail("phase 15 %s rank %d: %d partitions"
                         % (name, r, c["partition"]))
            if name.startswith("dp_int8"):
                if texts[0] != serial["int8"]:
                    fail("phase 15b %s: int8 model text differs from the "
                         "serial int8 run's" % name)
                verdict = "byte-equal to serial int8"
            elif name.startswith("dp_float32"):
                got = lgt.GBDT()
                got.models_from_string(texts[0])
                want = lgt.GBDT()
                want.models_from_string(serial["float32"])
                ta, tb = got.models[0], want.models[0]
                for field in ("split_feature_real", "threshold",
                              "left_child", "right_child", "leaf_parent"):
                    if not np.array_equal(getattr(ta, field),
                                          getattr(tb, field)):
                        fail("phase 15b %s: first tree's %s differs from "
                             "serial's" % (name, field))
                rel = float(np.max(np.abs(ta.leaf_value - tb.leaf_value)
                                   / np.maximum(np.abs(tb.leaf_value),
                                                1e-30)))
                if rel > 1e-5:
                    fail("phase 15b %s: first tree's leaf values rtol %g"
                         % (name, rel))
                auc = held_out_auc(texts[0], x_test, y_test, dev)
                if abs(auc - auc_serial) > 1e-4:
                    fail("phase 15b %s: held-out AUC %.6f against serial's "
                         "%.6f" % (name, auc, auc_serial))
                part = first_parting_split(texts[0], serial["float32"])
                verdict = ("first tree alike (leaf rtol %.3g), AUC %.6f vs "
                           "%.6f; %s" % (rel, auc, auc_serial,
                                         "every split equal" if part is None
                                         else "first parting split: tree %d "
                                         "node %d, gains %.6f vs %.6f"
                                         % part))
                rec[name + "_leaf_rtol"] = rel
                rec[name + "_auc"] = auc
            else:
                base = serial["masked" if "masked" in name else "depthwise"]
                if texts[0] != base:
                    fail("phase 15c %s: model text differs from the serial "
                         "run's" % name)
                verdict = "byte-equal to serial"
            by_path["parallel_" + name] = recs[0]["counts"]
            base_s = serial_s["int8" if name.startswith("dp_int8")
                              else "float32" if name.startswith("dp_")
                              else "masked" if "masked" in name
                              else "depthwise"]
            per_rank = []
            for r, one in enumerate(recs):
                coll_s = sum(v["seconds"] for v in one["sites"].values())
                iters = max(len(one["iter_s"]), 1)
                per_rank.append({
                    "rank": r, "rows": one["rows"],
                    "s_per_iter": one["iter_s"],
                    "collective_ms_per_iter": 1e3 * coll_s / iters,
                    "hist": one["counts"]["hist"],
                    "partition": one["counts"]["partition"],
                    "partition_kernels": one["counts"]["partition_kernels"],
                    "sites": one["sites"]})
            rec[name] = {"backend": recs[0]["backend"], "ranks": per_rank,
                         "serial_s_per_iter": base_s}
            say("phase 15 %s (%s): %s; median s/iteration rank 0 %.4f, rank "
                "1 %.4f, serial %.4f; collective ms/iteration %.1f / %.1f; "
                "launches per rank hist %s, partition %s" % (
                    name, recs[0]["backend"], verdict,
                    float(np.median(recs[0]["iter_s"])),
                    float(np.median(recs[1]["iter_s"])),
                    float(np.median(base_s)),
                    per_rank[0]["collective_ms_per_iter"],
                    per_rank[1]["collective_ms_per_iter"],
                    [p["hist"] for p in per_rank],
                    [p["partition"] for p in per_rank]))
            for site, v in sorted(recs[0]["sites"].items()):
                say("  site %s: %d calls, %d bytes (%d a call), %.4f s" % (
                    site, v["calls"], v["bytes"], v["bytes"] //
                    max(v["calls"], 1), v["seconds"]))

        # (d)'s CLI world
        out, cli_s = finish_cli_world(cli, "phase 15d")
        files = [open(os.path.join(cli_dir, f)).read()
                 for f in ("m.txt", "m.txt.rank1")]
        if files[0] != files[1] or files[0].count("Tree=") != WORLD_ITERS:
            fail("phase 15d: the ranks' model files differ or lack trees")
        rec["cli_s"] = cli_s
        say("phase 15d CLI under torch.distributed.run, 2 ranks, %d rows: "
            "rank files byte-equal (%d bytes), %.1f s" % (
                n_cli, len(files[0]), cli_s))
    finally:
        stop_cli_world(cli)
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    say("phase 15 parallel learners: %.1f s [%s]" % (rec["phase_s"], card))
    say(json.dumps({"parallel": rec}))
    return {k: {"hist": v["hist"], "partition": v["partition"]}
            for k, v in by_path.items()}


def start_cli_world(cli_dir, nprocs, args, threads=None):
    """``python -m torch.distributed.run --standalone`` of ``nprocs``
    ranks of the CLI with ``args`` in ``cli_dir``, started in its own
    session and not waited for (it runs beside a phase's world); a
    thread reaps it, killing it past PARALLEL_TIMEOUT_S, and notes its
    own seconds."""
    import threading
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nprocs), "-m", "lightgbm_tpu_torch"] \
        + list(args)
    run = {"t0": time.perf_counter(), "timed_out": False,
           "proc": subprocess.Popen(cmd, cwd=cli_dir, env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True,
                                    start_new_session=True)}

    def wait():
        proc = run["proc"]
        try:
            run["out"] = proc.communicate(timeout=PARALLEL_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            run["timed_out"] = True
            os.killpg(proc.pid, 9)
            run["out"] = proc.communicate()[0]
        run["s"] = time.perf_counter() - run["t0"]

    run["waiter"] = threading.Thread(target=wait, daemon=True)
    run["waiter"].start()
    return run


def finish_cli_world(run, what):
    """Wait for a ``start_cli_world`` world: fails ``what`` past
    PARALLEL_TIMEOUT_S or on a nonzero exit.  Returns (its output, its
    own seconds)."""
    run["waiter"].join()
    if run["timed_out"]:
        fail("%s: torch.distributed.run ran past %d s"
             % (what, PARALLEL_TIMEOUT_S))
    if run["proc"].returncode != 0:
        say(run["out"][-6000:])
        fail("%s: torch.distributed.run exited %d"
             % (what, run["proc"].returncode))
    return run["out"], run["s"]


def stop_cli_world(run):
    """Kill a ``start_cli_world`` world still running (a phase that
    failed before waiting for it), and reap it."""
    if run is not None:
        if run["proc"].poll() is None:
            os.killpg(run["proc"].pid, 9)
        run["waiter"].join(60)


def site_line(site, v):
    return "  site %s (%s): %d calls, %d bytes (%d a call, %d at most), " \
        "%.4f s" % (site, v["axis"], v["calls"], v["bytes"],
                    v["bytes"] // max(v["calls"], 1), v["bytes_per_call"],
                    v["seconds"])


def hybrid_voting_phase(dev, sizes, x, y, sync):
    """Phase 16: the hybrid and voting learners in one world of 4 worker
    processes sharing the card over gloo (a 2-D grid of ranks: rank r at
    data index r // fs, feature index r % fs), each rank through
    ``lightgbm_tpu_torch.train`` on its data index's rows of phase 4's
    table (or ``make_mixed``'s), launching both kernels on its own rows:

    (a) hybrid 2 x 2, compacted float32, 255 leaves, ``WORLD_ITERS``
        iterations: the structure of a serial run's trees, leaf values
        within rtol 1e-5, held-out AUC within 1e-4;
    (b) hybrid 2 x 2, compacted int8, ``WORLD_ITERS`` iterations: the
        serial int8 text;
    (c) hybrid 2 x 2, ``mixed_bin=true`` int8 on a mixed table (narrow
        and wide columns in each block), masked and compacted,
        ``WORLD_ITERS`` iterations: the rank log names the block-local
        plan, and the text is the serial int8 text under the uniform and
        the packed layout;
    (d) voting 4 x 1, ``top_k=20`` (2·top_k >= 28: exact), depth-wise
        int8, 5 iterations: the serial text;
    (e) voting 2 x 2, ``top_k=4`` (V = 8 < Fb = 14: PV-tree), compacted
        float32, 255 leaves, ``WORLD_ITERS`` iterations: held-out AUC
        within 0.01 of serial's, recorded beside it;
    (f) the CLI under ``torch.distributed.run``, 4 ranks,
        ``tree_learner=hybrid`` on n_cli rows, ``WORLD_ITERS`` trees,
        beside the grid: the four rank files byte-equal.

    The grid and (f)'s world run beside the serial twins.

    Every rank's text equals every other rank's; each rank launches the
    histogram kernel as its serial twin does (one a leaf, twice under
    the masked packed block's two classes, four times under the
    compacted packed pane's four segments; 1 + one a level pass
    depth-wise) and the partition kernel one a split (compacted), and
    files the predicted wire bytes per site.  Prints each rank's seconds
    per iteration beside a serial run's, collective seconds per
    iteration, wire bytes per site.  Returns rank 0's kernel launches
    per path."""
    import shutil
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import telemetry
    card = card_name()
    t_phase = time.perf_counter()
    n_train = sizes["n_train"]
    x_test, y_test = x[n_train:], y[n_train:]
    nl = sizes.get("parallel_leaves", 255)
    f32 = {"objective": "binary", "num_leaves": nl,
           "num_iterations": WORLD_ITERS, "learning_rate": 0.1,
           "hist_dtype": "float32", "max_bin": 255}
    int8 = dict(f32, hist_dtype="int8")
    masked = dict(int8, leafwise_compact="false")
    depthwise = dict(int8, grow_policy="depthwise", num_iterations=5)
    hybrid = {"tree_learner": "hybrid", "num_machines": 4,
              "feature_shards": 2}
    jobs = [
        ("a", "hybrid_compacted_float32", "main", dict(f32, **hybrid)),
        ("b", "hybrid_compacted_int8", "main", dict(int8, **hybrid)),
        ("c", "hybrid_masked_int8_mixed", "mixed",
         dict(masked, mixed_bin="true", **hybrid)),
        ("c", "hybrid_compacted_int8_mixed", "mixed",
         dict(int8, mixed_bin="true", **hybrid)),
        ("d", "voting_depthwise_int8", "main",
         dict(depthwise, tree_learner="voting", num_machines=4, top_k=20)),
        ("e", "voting_compacted_float32", "main",
         dict(f32, tree_learner="voting", num_machines=4,
              feature_shards=2, top_k=4))]
    rec, by_path = {"card": card}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hybrid_")
    cli = None
    try:
        xm, ym = make_mixed(n_train, 28, SEED + 1, 24)
        data = {}
        for name, (a, b) in (("main", (x[:n_train], y[:n_train])),
                             ("mixed", (xm, ym))):
            data[name] = [os.path.join(tmp, name + "_x.npy"),
                          os.path.join(tmp, name + "_y.npy")]
            np.save(data[name][0], a.astype(np.float32))
            np.save(data[name][1], b)
        # (f) the CLI under torch.distributed.run, 4 ranks, hybrid,
        # beside the grid
        n_cli = sizes["n_cli"]
        cli_dir = os.path.join(tmp, "cli")
        os.makedirs(cli_dir)
        np.savetxt(os.path.join(cli_dir, "train.tsv"),
                   np.column_stack([y[:n_cli], x[:n_cli]]), delimiter="\t",
                   fmt="%.9g")
        cli = start_cli_world(cli_dir, 4, [
            "task=train", "data=train.tsv", "objective=binary",
            "num_leaves=%d" % nl, "num_trees=%d" % WORLD_ITERS,
            "hist_dtype=int8",
            "tree_learner=hybrid", "num_machines=4", "output_model=m.txt",
            "device=%s" % dev.type], threads=2)
        grid = start_world(tmp, "grid", 4, [
            {"name": n, "table": t, "params": p} for _, n, t, p in jobs],
            dev, data, PHASE16_TIMEOUT_S, threads=2)

        sets = {"main": lgt.Dataset.from_arrays(x[:n_train], y[:n_train],
                                                max_bin=255),
                "mixed": lgt.Dataset.from_arrays(xm, ym, max_bin=255)}
        B = int(sets["main"].num_bins.max())

        # the serial twins, on the card, armed as the workers are
        serial, serial_s, serial_counts = {}, {}, {}
        for name, table, params in (
                ("float32", "main", f32), ("int8", "main", int8),
                ("masked_mixed", "mixed", masked),
                ("masked_mixed_packed", "mixed",
                 dict(masked, mixed_bin="true")),
                ("compacted_mixed", "mixed", dict(int8, mixed_bin="false")),
                ("depthwise", "main", depthwise)):
            telemetry.enable()
            booster, iter_s, counts = drive(params, sets[table], dev, sync)
            if dev.type == "cpu":
                # a rehearsal: the plain routes stand for the launches
                counts["hist"] = sum(
                    v for k, v in telemetry.counters().items()
                    if k.startswith("hist/plain_"))
            telemetry.disable()
            telemetry.reset()
            serial[name] = booster.model_to_string()
            serial_s[name] = iter_s
            serial_counts[name] = counts
        if serial["masked_mixed"] != serial["masked_mixed_packed"]:
            fail("phase 16: serial masked int8 packed differs from uniform")
        twin = {"hybrid_compacted_float32": "float32",
                "hybrid_compacted_int8": "int8",
                "hybrid_masked_int8_mixed": "masked_mixed",
                "hybrid_compacted_int8_mixed": "compacted_mixed",
                "voting_depthwise_int8": "depthwise",
                "voting_compacted_float32": "float32"}

        ranks, wdir = finish_world(grid, 16)[:2]
        logs = [open(os.path.join(wdir, "rank%d.log" % r)).read()
                for r in range(4)]
        if not all("mixed-bin packing (block-local, block=14)" in t
                   for t in logs):
            fail("phase 16c: a rank's log does not name the block-local "
                 "plan")
        auc_serial = held_out_auc(serial["float32"], x_test, y_test, dev)
        pred = {"hybrid_compacted_float32": {
                    "hybrid/leafcompact/own_block_allreduce": 14 * B * 12,
                    "hybrid/leafcompact/root_hist": 28 * B * 12,
                    "hybrid/leafcompact/splitinfo_allreduce": 88},
                "hybrid_compacted_int8": {
                    "hybrid/leafcompact/own_block_int_allreduce":
                        14 * B * 12,
                    "hist/quant_scale_pmax": 8},
                "voting_compacted_float32": {
                    "voting/leafcompact/votes_allgather": 2 * 4 * 4,
                    "voting/leafcompact/root_votes_allgather": 4 * 4,
                    "voting/leafcompact/voted_hist_allreduce":
                        2 * 8 * B * 12,
                    "voting/leafcompact/root_voted_hist_allreduce":
                        8 * B * 12},
                "voting_depthwise_int8": {
                    "voting/depthwise/splitinfo_allreduce": None}}
        for letter, name, table, params in jobs:
            recs = [r[name] for r in ranks]
            texts = rank_texts(wdir, name, 4)
            what = "phase 16%s %s" % (letter, name)
            if len(set(texts)) != 1:
                fail("%s: the ranks' model texts differ" % what)
            grids = [tuple(r["grid"]) for r in recs]
            fs = params.get("feature_shards", 1)
            want_grid = [(4 // fs, fs, r // fs, r % fs) for r in range(4)]
            if grids != want_grid or any(r["backend"] != "gloo"
                                         for r in recs):
                fail("%s: grids %s, backends %s" % (
                    what, grids, [r["backend"] for r in recs]))
            check_ranks(what, recs, dev)
            leaves = recs[0]["leaves"]
            splits = sum(leaves) - len(leaves)
            base = serial_counts[twin[name]]
            compacted = "compacted" in name
            for r, one in enumerate(recs):
                c = one["counts"]
                if name.startswith("voting_compacted"):
                    want_hist = sum(leaves)    # its own trees
                elif "mixed" in name:
                    # packed: 2 classes of the owned block (masked), 2
                    # segments of each of 2 blocks (the compacted pane)
                    want_hist = sum(leaves) * (4 if compacted else 2)
                else:
                    want_hist = base["hist"]
                if c["hist"] != want_hist or c["partition"] != (
                        splits if compacted else 0):
                    fail("%s rank %d: %d histogram launches, %d partitions;"
                         " expected %d and %d" % (
                             what, r, c["hist"], c["partition"], want_hist,
                             splits if compacted else 0))
            want = serial[twin[name]]
            if name == "hybrid_compacted_float32":
                got, ser = lgt.GBDT(), lgt.GBDT()
                got.models_from_string(texts[0])
                ser.models_from_string(want)
                # each data shard's f32 histogram rounds once before the
                # cross-shard add, so a leaf whose gradient sum cancels
                # can part from serial's by more than rtol 1e-5 alone:
                # the first tree is held to rtol 1e-5 (phase 15b's gate),
                # every tree to rtol 1e-5 / atol 5e-6 (the CPU tests'
                # budget, tests/test_torch_parallel.py)
                rels, abss = [], []
                for k, (ta, tb) in enumerate(zip(got.models, ser.models)):
                    for field in ("split_feature_real", "threshold",
                                  "left_child", "right_child",
                                  "leaf_parent"):
                        if not np.array_equal(getattr(ta, field),
                                              getattr(tb, field)):
                            fail("%s: tree %d's %s differs from serial's"
                                 % (what, k, field))
                    diff = np.abs(ta.leaf_value - tb.leaf_value)
                    rels.append(float(np.max(diff / np.maximum(
                        np.abs(tb.leaf_value), 1e-30))))
                    abss.append(float(np.max(diff)))
                    if not np.allclose(ta.leaf_value, tb.leaf_value,
                                       rtol=1e-5, atol=5e-6):
                        fail("%s: tree %d's leaf values beyond rtol 1e-5 / "
                             "atol 5e-6 (largest relative %g, absolute %g)"
                             % (what, k, rels[-1], abss[-1]))
                say("%s: leaf values against serial's, largest relative "
                    "difference per tree %s, absolute %s" % (what, rels,
                                                             abss))
                rel = rels[0]
                if rel > 1e-5:
                    fail("%s: the first tree's leaf values rtol %g" % (what,
                                                                       rel))
                auc = held_out_auc(texts[0], x_test, y_test, dev)
                if abs(auc - auc_serial) > 1e-4:
                    fail("%s: held-out AUC %.6f against serial's %.6f"
                         % (what, auc, auc_serial))
                verdict = ("structure of serial's trees, first tree's leaf "
                           "rtol %.3g, AUC %.6f vs %.6f" % (rel, auc,
                                                           auc_serial))
                rec[name + "_leaf_rtol"], rec[name + "_auc"] = rel, auc
            elif name == "voting_compacted_float32":
                auc = held_out_auc(texts[0], x_test, y_test, dev)
                if abs(auc - auc_serial) > 0.01:
                    fail("%s: held-out AUC %.6f against serial's %.6f"
                         % (what, auc, auc_serial))
                part = first_parting_split(texts[0], want)
                verdict = ("AUC %.6f vs serial %.6f; %s" % (
                    auc, auc_serial, "every split serial's" if part is None
                    else "first split parting from serial's: tree %d node "
                    "%d, gains %.6f vs %.6f" % part))
                rec[name + "_auc"] = auc
                rec[name + "_serial_auc"] = auc_serial
            else:
                if texts[0] != want:
                    fail("%s: model text differs from the serial int8 "
                         "run's" % what)
                verdict = "byte-equal to serial int8"
            for site, per_call in pred.get(name, {}).items():
                for r, one in enumerate(recs):
                    got = one["sites"].get(site)
                    if got is None or (per_call is not None
                                       and got["bytes_per_call"]
                                       != per_call):
                        fail("%s rank %d: site %s filed %s, predicted %s "
                             "bytes a call" % (what, r, site, got,
                                               per_call))
            by_path["parallel_" + name] = recs[0]["counts"]
            per_rank = []
            for r, one in enumerate(recs):
                coll_s = sum(v["seconds"] for v in one["sites"].values())
                iters = max(len(one["iter_s"]), 1)
                per_rank.append({
                    "rank": r, "grid": one["grid"], "rows": one["rows"],
                    "s_per_iter": one["iter_s"],
                    "collective_ms_per_iter": 1e3 * coll_s / iters,
                    "hist": one["counts"]["hist"],
                    "partition": one["counts"]["partition"],
                    "partition_kernels": one["counts"]["partition_kernels"]})
            base_s = serial_s[twin[name]]
            rec[name] = {"ranks": per_rank, "serial_s_per_iter": base_s,
                         "rank0_sites": recs[0]["sites"]}
            say("phase 16%s %s (gloo, grid %dx%d): %s; median s/iteration "
                "per rank %s, serial %.4f; collective ms/iteration %s; "
                "launches per rank hist %s, partition %s" % (
                    letter, name, 4 // fs, fs, verdict,
                    ["%.4f" % float(np.median(p["s_per_iter"]))
                     for p in per_rank], float(np.median(base_s)),
                    ["%.1f" % p["collective_ms_per_iter"] for p in per_rank],
                    [p["hist"] for p in per_rank],
                    [p["partition"] for p in per_rank]))
            for site, v in sorted(recs[0]["sites"].items()):
                say(site_line(site, v))

        # (f)'s CLI world
        out, cli_s = finish_cli_world(cli, "phase 16f")
        files = [open(os.path.join(cli_dir, f)).read()
                 for f in ("m.txt", "m.txt.rank1", "m.txt.rank2",
                           "m.txt.rank3")]
        if len(set(files)) != 1 or files[0].count("Tree=") != WORLD_ITERS:
            fail("phase 16f: the ranks' model files differ or lack trees")
        if "a 2 x 2 grid of ranks" not in out:
            fail("phase 16f: the CLI world did not run a 2 x 2 grid")
        rec["cli_s"] = cli_s
        say("phase 16f CLI under torch.distributed.run, 4 ranks, "
            "tree_learner=hybrid, %d rows: rank files byte-equal (%d "
            "bytes), %.1f s" % (n_cli, len(files[0]), cli_s))
    finally:
        stop_cli_world(cli)
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    say("phase 16 hybrid and voting learners: %.1f s [%s]"
        % (rec["phase_s"], card))
    say(json.dumps({"hybrid_voting": rec}))
    return {k: {"hist": v["hist"], "partition": v["partition"]}
            for k, v in by_path.items()}


PHASE17_TIMEOUT_S = 300      # each of phase 17's worlds
P17_SLOW_S = 4.0             # phase 17e's straggler: sleep a iteration


def grown_launches(what, recs, dev, compacted=True):
    """Every rank launched the histogram kernel once a leaf and the
    partition kernel once a split of the trees it grew in this run (the
    last ``len(iter_s)`` trees; a resumed run grows the remaining ones),
    its route counters equal to them (``check_ranks``)."""
    check_ranks(what, recs, dev)
    for r, one in enumerate(recs):
        grown = one["leaves"][len(one["leaves"]) - len(one["iter_s"]):]
        want = (sum(grown), sum(grown) - len(grown) if compacted else 0)
        got = (one["counts"]["hist"], one["counts"]["partition"])
        if got != want:
            fail("%s rank %d: %d histogram launches and %d partitions; "
                 "expected %d and %d" % ((what, r) + got + want))


def goss_elastic_phase(dev, sizes, x, y, sync):
    """Phase 17: GOSS, checkpoints and the elastic restart across worlds
    of worker processes sharing the card over gloo, each rank through
    ``lightgbm_tpu_torch.train`` on its rows of phase 4's table,
    launching both kernels on its own rows; worlds that do not depend on
    each other run side by side:

    (a) GOSS at full width (255 leaves, compacted, ``top_rate=0.2
        other_rate=0.1``), 2 ranks of ``tree_learner=data``,
        ``WORLD_ITERS`` iterations: int8 byte-equal to a serial GOSS run
        on the card;
        float32: the first tree serial's structure, held-out AUC within
        1e-4 of serial's, recorded beside it;
    (b) GOSS under hybrid 2 x 2, int8, ``WORLD_ITERS`` iterations:
        byte-equal to serial;
    (c) checkpoints every iteration, rank 1 SIGKILLed at iteration 2
        (rank 0 fails in its next collective), the world restarted from
        the checkpoint directory: int8 and float32 byte-equal to the
        unbroken run (serial's in int8, the unbroken world's in float32);
    (d) the 2-rank int8 checkpoint at iteration 2 resumed on 3 ranks
        (armed with the drain at ``straggler_k=2``, which ranks of equal
        work must not set off) and on one (this process): serial's int8
        text;
    (e) the drain: 3 ranks, ``elastic_shrink=true straggler_k=2``, rank 2
        sleeping ``P17_SLOW_S`` before every iteration, its own work as
        the ranks measure it (nothing injected): every rank stops with
        the named ``Fatal`` after the checkpoint; a 2-rank restart writes
        serial's int8 text.

    Every path grows the main path's 255 leaves a tree.  Each rank
    launches the histogram kernel once a leaf and the partition kernel
    once a split of the trees it grew.  Prints seconds per iteration,
    each rank's own work at each drain boundary, collective
    seconds and wire bytes per site, checkpoint bytes, background write
    and restore seconds.  Returns rank 0's kernel launches per path."""
    import re
    import shutil
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import checkpoint as ckpt
    card = card_name()
    t_phase = time.perf_counter()
    n_train = sizes["n_train"]
    x_test, y_test = x[n_train:], y[n_train:]
    nl = sizes.get("parallel_leaves", 255)
    base = {"objective": "binary", "num_iterations": 3, "learning_rate": 0.1,
            "max_bin": 255}
    goss = dict(base, num_leaves=nl, goss="true", top_rate=0.2,
                other_rate=0.1, num_iterations=WORLD_ITERS)
    small = dict(base, num_leaves=nl, hist_dtype="int8")
    dp2 = {"tree_learner": "data", "num_machines": 2}
    rec, by_path = {"card": card}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")

    def ck(name):
        return os.path.join(tmp, "ck_" + name)

    def ckpt_job(name, params, world=dp2, **extra):
        return dict({"name": name, "params": dict(
            params, checkpoint_interval=1, checkpoint_dir=ck(name),
            **world)}, **extra)

    kill = {"fault": {"at": 2, "kind": "kill", "ranks": [1]}}
    try:
        data = (os.path.join(tmp, "x.npy"), os.path.join(tmp, "y.npy"))
        np.save(data[0], x[:n_train].astype(np.float32))
        np.save(data[1], y[:n_train])
        # round 1: (a); the unbroken float32 world of (c) and (c)'s int8
        # kill; (b); side by side
        w1 = start_world(tmp, "goss", 2, [
            {"name": "a_goss_int8", "params": dict(goss, hist_dtype="int8",
                                                   **dp2)},
            {"name": "a_goss_float32",
             "params": dict(goss, hist_dtype="float32", **dp2)}], dev, data,
            PHASE17_TIMEOUT_S, threads=1)
        w1c = start_world(tmp, "ck", 2, [
            {"name": "c_whole_float32",
             "params": dict(small, hist_dtype="float32", **dp2)},
            ckpt_job("c_int8", small, **kill)], dev, data,
            PHASE17_TIMEOUT_S, threads=1)
        w3 = start_world(tmp, "goss_hybrid", 4, [
            {"name": "b_hybrid_goss_int8",
             "params": dict(goss, hist_dtype="int8", tree_learner="hybrid",
                            num_machines=4, feature_shards=2)}], dev, data,
            PHASE17_TIMEOUT_S, threads=1)
        train_set = lgt.Dataset.from_arrays(x[:n_train], y[:n_train],
                                            max_bin=255)
        serial, serial_s = {}, {}
        for name, params in (("goss_int8", dict(goss, hist_dtype="int8")),
                             ("goss_float32", dict(goss,
                                                   hist_dtype="float32")),
                             ("int8", small)):
            booster, iter_s, _ = drive(params, train_set, dev, sync)
            serial[name], serial_s[name] = booster.model_to_string(), iter_s
        r1, d1, _ = finish_world(w1, 17)
        rc_, dc, rc1 = finish_world(w1c, 17, killed=(1,))
        r3, d3, _ = finish_world(w3, 17)

        # round 2: (c)'s int8 restart and float32 kill; (d) 2 -> 3 and
        # (e)'s drain beside it; (d) 2 -> 1 here
        for dst in ("int8_3", "int8_1"):
            shutil.copytree(ck("c_int8"), ck(dst))
        w2 = start_world(tmp, "restart", 2, [
            dict(ckpt_job("c_int8", small), name="c_resume_int8"),
            ckpt_job("c_float32", dict(small, hist_dtype="float32"),
                     **kill)], dev, data, PHASE17_TIMEOUT_S, threads=2)
        drain = dict(small, elastic_shrink="true", straggler_k=2)
        w4 = start_world(tmp, "three", 3, [
            dict(ckpt_job("int8_3", drain, world={"tree_learner": "data",
                                                  "num_machines": 3}),
                 name="d_2to3_int8"),
            ckpt_job("e_drain", drain, world={"tree_learner": "data",
                                              "num_machines": 3},
                     slow=[2, P17_SLOW_S], expect_error=True)], dev, data,
            PHASE17_TIMEOUT_S, threads=2)
        t0 = time.perf_counter()
        resumed, resumed_s, resumed_counts = drive(
            dict(small, checkpoint_interval=1,
                 checkpoint_dir=ck("int8_1")), train_set, dev, sync)
        rec["d_2to1_s"] = time.perf_counter() - t0
        r2, d2, rc2 = finish_world(w2, 17, killed=(1,))
        r4, d4, _ = finish_world(w4, 17)
        shutil.copytree(ck("e_drain"), ck("e_restart"))

        # round 3: (c)'s float32 restart and (e)'s restart on 2 ranks
        r5, d5, _ = finish_world(start_world(tmp, "restart2", 2, [
            dict(ckpt_job("c_float32", dict(small, hist_dtype="float32")),
                 name="c_resume_float32"),
            ckpt_job("e_restart", small)], dev, data, PHASE17_TIMEOUT_S,
            threads=2), 17)

        # ---- the checks
        auc_serial = held_out_auc(serial["goss_float32"], x_test, y_test,
                                  dev)
        verdicts = {}
        for letter, name, ranks, wdir, want in (
                ("a", "a_goss_int8", r1, d1, serial["goss_int8"]),
                ("a", "a_goss_float32", r1, d1, None),
                ("b", "b_hybrid_goss_int8", r3, d3, serial["goss_int8"]),
                ("c", "c_resume_int8", r2, d2, serial["int8"]),
                ("c", "c_resume_float32", r5, d5, "c_whole_float32"),
                ("d", "d_2to3_int8", r4, d4, serial["int8"]),
                ("e", "e_restart", r5, d5, serial["int8"])):
            recs = [r[name] for r in ranks]
            texts = rank_texts(wdir, name, len(ranks))
            what = "phase 17%s %s" % (letter, name)
            if len(set(texts)) != 1:
                fail("%s: the ranks' model texts differ" % what)
            grown_launches(what, recs, dev)
            if want == "c_whole_float32":
                want = rank_texts(dc, want, 2)[0]
            if name == "a_goss_float32":
                got, ser = lgt.GBDT(), lgt.GBDT()
                got.models_from_string(texts[0])
                ser.models_from_string(serial["goss_float32"])
                for field in ("split_feature_real", "threshold",
                              "left_child", "right_child", "leaf_parent"):
                    if not np.array_equal(getattr(got.models[0], field),
                                          getattr(ser.models[0], field)):
                        fail("%s: the first tree's %s differs from "
                             "serial's" % (what, field))
                auc = held_out_auc(texts[0], x_test, y_test, dev)
                if abs(auc - auc_serial) > 1e-4:
                    fail("%s: held-out AUC %.6f against serial's %.6f"
                         % (what, auc, auc_serial))
                part = first_parting_split(texts[0], serial["goss_float32"])
                verdicts[name] = (
                    "first tree serial's structure; AUC %.6f, serial %.6f; "
                    "%s" % (auc, auc_serial, "every split serial's"
                            if part is None else "first split parting: "
                            "tree %d node %d, gains %.6f vs %.6f" % part))
                rec[name + "_auc"], rec[name + "_serial_auc"] = \
                    auc, auc_serial
            elif texts[0] != want:
                fail("%s: model text differs from the unbroken run's"
                     % what)
            else:
                verdicts[name] = "byte-equal to the unbroken run"
            if name.startswith(("a_", "b_")):
                widest = max(r["rows"] for r in recs)
                for r, one in enumerate(recs):
                    site = one["sites"].get("dp/goss_score_allgather")
                    if site is None or site["calls"] != WORLD_ITERS or \
                            site["bytes_per_call"] != 4 * widest:
                        fail("%s rank %d: dp/goss_score_allgather filed "
                             "%s, predicted %d calls of %d bytes"
                             % (what, r, site, WORLD_ITERS, 4 * widest))
            by_path["elastic_" + name] = recs[0]["counts"]
            per_rank = [{
                "rank": r, "rows": one["rows"], "s_per_iter": one["iter_s"],
                "collective_ms_per_iter": 1e3 * sum(
                    v["seconds"] for v in one["sites"].values())
                / max(len(one["iter_s"]), 1),
                "hist": one["counts"]["hist"],
                "partition": one["counts"]["partition"],
                "restore_s": one["restore_s"][0] if "resume" in name
                or "2to3" in name or "restart" in name else None,
                "counters": one["counters"]} for r, one in enumerate(recs)]
            rec[name] = {"ranks": per_rank, "rank0_sites": recs[0]["sites"]}
            say("phase 17%s %s (%d ranks): %s; median s/iteration per rank "
                "%s; collective ms/iteration %s; launches per rank hist %s, "
                "partition %s; restore s %s" % (
                    letter, name, len(recs), verdicts[name],
                    ["%.4f" % float(np.median(p["s_per_iter"]))
                     for p in per_rank],
                    ["%.1f" % p["collective_ms_per_iter"] for p in per_rank],
                    [p["hist"] for p in per_rank],
                    [p["partition"] for p in per_rank],
                    [p["restore_s"] for p in per_rank]))
            for site, v in sorted(recs[0]["sites"].items()):
                say(site_line(site, v))
        for name in ("goss_int8", "goss_float32", "int8"):
            say("phase 17 serial %s (%s): median s/iteration %.4f"
                % (name, dev.type, float(np.median(serial_s[name]))))
            rec["serial_" + name + "_s_per_iter"] = serial_s[name]

        # (c) the kills: rank 1 killed, rank 0 failed in its collective
        for name, rcs, ranks in (("c_int8", rc1, rc_), ("c_float32", rc2,
                                                        r2)):
            if rcs[0] == 0 or rcs[1] != -9:
                fail("phase 17c %s: exit codes %s" % (name, rcs))
            sizes_b = [os.path.getsize(p) for p in
                       ckpt.list_checkpoints(ck(name))]
            rec[name + "_ckpt_bytes"] = sizes_b
            say("phase 17c %s: rank 1 SIGKILLed at iteration 2, rank 0 "
                "exited %d; checkpoint files %s bytes" % (name, rcs[0],
                                                          sizes_b))
        # (d) 2 -> 1 in this process
        if resumed.model_to_string() != serial["int8"]:
            fail("phase 17d: the 2-rank checkpoint resumed on one rank "
                 "differs from serial's int8 text")
        grown = [t.num_leaves for t in resumed.models][-len(resumed_s):]
        if (resumed_counts["hist"], resumed_counts["partition"]) != (
                sum(grown), sum(grown) - len(grown)):
            fail("phase 17d 2 -> 1: launches %s" % resumed_counts)
        by_path["elastic_d_2to1_int8"] = resumed_counts
        say("phase 17d 2 -> 1 (this process): byte-equal to serial int8 "
            "(%d trees grown after the restore)" % len(grown))

        # (e) the drain: every rank stopped, named, after the checkpoint
        drained = [r["e_drain"] for r in r4]
        check_ranks("phase 17e e_drain", drained, dev)
        for r, one in enumerate(drained):
            err = one["error"] or ""
            if "persistent straggler p2: checkpoint written at iteration " \
                    "2" not in err or "restarting the 2 surviving " \
                    "processes" not in err:
                fail("phase 17e rank %d: %r" % (r, err))
            times = one["sites"].get("elastic/times_allgather", {})
            votes = one["sites"].get("elastic/survivor_pmin", {})
            if (times.get("calls"), times.get("bytes_per_call"),
                    votes.get("calls"), votes.get("bytes_per_call"),
                    one["counters"].get("elastic/shrinks")) != (2, 4, 1, 12,
                                                                1):
                fail("phase 17e rank %d: sites %s, counters %s"
                     % (r, one["sites"], one["counters"]))
            if one["counts"]["hist"] == 0 or one["counts"]["partition"] == 0:
                fail("phase 17e rank %d: launches %s" % (r, one["counts"]))
        if ckpt.load_checkpoint(ckpt.latest_checkpoint(ck("e_drain")))[
                "iteration"] != 2:
            fail("phase 17e: the drain's checkpoint is not iteration 2's")
        by_path["elastic_e_drain"] = drained[0]["counts"]
        logs = open(os.path.join(d5, "rank0.log")).read()
        if not re.search(r"elastic restart: checkpoint topology "
                         r"num_machines=3 -> 2", logs):
            fail("phase 17e: the restart did not log the topology change")
        rec["e_drain"] = {
            "sites": drained[0]["sites"], "counters": drained[0]["counters"],
            "iter_s": [d["iter_s"] for d in drained]}
        rec["busy_s"] = {"d_2to3_int8": r4[0]["d_2to3_int8"]["busy_s"],
                         "e_drain": drained[0]["busy_s"]}
        say("phase 17e drain, 3 ranks: every rank stopped with the named "
            "Fatal at iteration 2 after the checkpoint; exchange %s; vote "
            "%s; the 2-rank restart byte-equal to serial int8" % (
                drained[0]["sites"]["elastic/times_allgather"],
                drained[0]["sites"]["elastic/survivor_pmin"]))
        say("phase 17d/e each rank's own work at each boundary, s (p0, "
            "p1, p2): armed 2 -> 3 %s; drain, p2 sleeping %.1f s %s [%s]"
            % (rec["busy_s"]["d_2to3_int8"], P17_SLOW_S,
               rec["busy_s"]["e_drain"], card))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    say("phase 17 GOSS, checkpoints and the elastic restart: %.1f s [%s]"
        % (rec["phase_s"], card))
    say(json.dumps({"goss_elastic": rec}))
    return {k: {"hist": v["hist"], "partition": v["partition"]}
            for k, v in by_path.items()}


PHASE18_TIMEOUT_S = 300      # each of phase 18's worlds
# phase 18's health sites: bytes a call (health.py, 3)
HEALTH_SITES = {"health/vector_psum": 24, "health/score_pmax": 4,
                "health/quant_sat_pmax": 8, "health/quant_sat_reduce": 8}


def read_records(what, path):
    """Every line of a sink file as JSON; fails the phase on a line that
    does not parse."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            try:
                out.append(json.loads(line))
            except ValueError as e:
                fail("%s: %s line %d does not parse (%s)" % (what, path, i,
                                                            e))
    return out


def health_blocks(records):
    """(the per-iteration health blocks, the summary's) of a sink."""
    return ([r.get("health") for r in records if "iter" in r],
            [r.get("health") for r in records if r.get("summary")])


def shard_files(what, wdir, base, nprocs):
    """The shards of ``<wdir>/<base>``, one a rank, each headed by its
    ``shard`` record naming the rank; and the base path itself unwritten
    (no record went out before the world had formed).  Returns each
    rank's records after the header."""
    from lightgbm_tpu_torch import telemetry
    path = os.path.join(wdir, base)
    want = sorted(os.path.basename(telemetry.shard_path(path, r, nprocs))
                  for r in range(nprocs))
    got = sorted(p for p in os.listdir(wdir) if p.startswith(base))
    if got != want:
        fail("%s: files %s, expected the shards %s" % (what, got, want))
    out = []
    for r in range(nprocs):
        records = read_records(what, telemetry.shard_path(path, r, nprocs))
        head = records[0].get("shard", {})
        if (head.get("process_index"), head.get("process_count")) != (
                r, nprocs) or "clock_offset_s" not in head:
            fail("%s rank %d: shard header %s" % (what, r, head))
        out.append(records[1:])
    return out


def observability_world_phase(dev, sizes, x, y, sync):
    """Phase 18: observability over worlds of worker processes sharing
    the card over gloo, each rank through ``lightgbm_tpu_torch.train``
    on its rows of phase 4's table at the main path's 255 leaves, int8
    compacted, ``WORLD_ITERS`` iterations, launching both kernels on its
    own rows; (a)'s, (b)'s hybrid and (c)'s worlds run side by side,
    beside the serial reference (what arming a world costs alone is
    ``scripts/telemetry_overhead.py --world 2``'s to measure):

    (a) the sink, 2 ranks of ``tree_learner=data``: with ``metrics_out``
        and ``timeline=false`` rank 0's file alone exists, every line
        parses and it holds the serial run's record count (ROADMAP C12);
        with ``timeline=auto`` one shard a rank, each headed by its
        ``shard`` record, read by ``scripts/port_timeline_report.py
        --json``; an unarmed job before and after the armed ones times
        what arming costs;
    (b) the world's health vector (``health=true``): every rank's
        per-iteration and summary blocks equal the serial run's,
        ``quant_sat`` included, under (a)'s shards and a hybrid 2 x 2
        world's (ROADMAP C13), each health site one call an iteration;
    (c) halt: 2 ranks, rank 1's gradients NaN in its first rows from
        iteration 1, ``on_anomaly=halt``: both ranks raise
        ``TrainingHealthError`` at iteration 1 and exit (code 3) well
        inside the world's limit;
    (d) (a)'s shards job also arms the drain (``elastic_shrink=true``,
        checkpoints; ``straggler_k=10``, so none fires in ``WORLD_ITERS``
        iterations)
        and ``trace_dump_dir``: each rank's dump carries its rank, and
        the port's ``podtrace.align`` over them is ``ok`` with a finite
        bound (``scripts/port_pod_report.py --check`` passes).

    Every armed job's model text is serial's int8 text on every rank;
    each rank launches the histogram kernel once a leaf and the partition
    kernel once a split (510 and 508 in 2 trees of 255 leaves).  Prints
    the health sites' wire bytes and host seconds, and each job's
    seconds an iteration against the unarmed job's.  Returns rank 0's
    kernel launches per path."""
    import math
    import shutil
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import podtrace
    card = card_name()
    t_phase = time.perf_counter()
    n_train = sizes["n_train"]
    iters = WORLD_ITERS
    base = {"objective": "binary", "num_iterations": iters,
            "learning_rate": 0.1, "max_bin": 255,
            "num_leaves": sizes.get("parallel_leaves", 255),
            "hist_dtype": "int8"}
    armed = dict(base, health="true")
    dp2 = {"tree_learner": "data", "num_machines": 2}
    here = os.path.dirname(os.path.abspath(__file__))
    rec, by_path = {"card": card}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        data = (os.path.join(tmp, "x.npy"), os.path.join(tmp, "y.npy"))
        np.save(data[0], x[:n_train].astype(np.float32))
        np.save(data[1], y[:n_train])
        t_halt = time.perf_counter()
        w3 = start_world(tmp, "halt", 2, [
            {"name": "c_halt", "params": dict(armed, on_anomaly="halt",
                                              **dp2),
             "poison": [1], "expect_error": True, "halt": True}], dev, data,
            PHASE18_TIMEOUT_S, threads=1)
        w2 = start_world(tmp, "hybrid", 4, [
            {"name": "b_hybrid", "params": dict(
                armed, metrics_out="hy.jsonl", timeline="auto",
                tree_learner="hybrid", num_machines=4, feature_shards=2)}],
            dev, data, PHASE18_TIMEOUT_S, threads=1)
        unarmed = {"params": dict(base, **dp2), "unarmed": True}
        w1 = start_world(tmp, "sink", 2, [
            dict(unarmed, name="unarmed"),
            {"name": "a_leader", "params": dict(
                armed, metrics_out="leader.jsonl", timeline="false", **dp2)},
            {"name": "a_shards", "params": dict(
                armed, metrics_out="tl.jsonl", timeline="auto",
                elastic_shrink="true", straggler_k=10, checkpoint_interval=1,
                checkpoint_dir="ck", trace_dump_dir="dumps",
                trace_run_id="phase18", **dp2)},
            dict(unarmed, name="unarmed_after")], dev, data,
            PHASE18_TIMEOUT_S, threads=1)
        train_set = lgt.Dataset.from_arrays(x[:n_train], y[:n_train],
                                            max_bin=255)
        serial_sink = os.path.join(tmp, "serial.jsonl")
        booster, serial_s, _ = drive(dict(armed, metrics_out=serial_sink),
                                     train_set, dev, sync)
        serial_text = booster.model_to_string()
        serial = read_records("phase 18 serial", serial_sink)
        r3, d3, rc3 = finish_world(w3, 18, rc_ok=3)
        rec["c_world_s"] = time.perf_counter() - t_halt
        r2, d2, _ = finish_world(w2, 18)
        r1, d1, _ = finish_world(w1, 18)

        # every path: serial's text on every rank, the launches per rank
        want_health = health_blocks(serial)
        if not want_health[0] or not want_health[0][0]["quant_sat"]:
            fail("phase 18 serial: health blocks %s" % (want_health,))
        for name, ranks, wdir in (("unarmed", r1, d1), ("a_leader", r1, d1),
                                  ("a_shards", r1, d1),
                                  ("unarmed_after", r1, d1),
                                  ("b_hybrid", r2, d2)):
            recs = [r[name] for r in ranks]
            what = "phase 18 " + name
            if set(rank_texts(wdir, name, len(ranks))) != {serial_text}:
                fail("%s: a rank's model text differs from serial's int8 "
                     "text" % what)
            if name.startswith("unarmed"):
                # no telemetry: the kernel counts alone (a CPU rehearsal
                # launches nothing)
                for r, one in enumerate(recs if dev.type == "cuda" else ()):
                    leaves = one["leaves"]
                    want = (sum(leaves), sum(leaves) - len(leaves))
                    if (one["counts"]["hist"],
                            one["counts"]["partition"]) != want:
                        fail("%s rank %d: launches %s, expected %s"
                             % (what, r, one["counts"], want))
            else:
                grown_launches(what, recs, dev)
            by_path["obs_" + name] = recs[0]["counts"]
            rec[name] = {
                "s_per_iter": [one["iter_s"] for one in recs],
                "hist": [one["counts"]["hist"] for one in recs],
                "partition": [one["counts"]["partition"] for one in recs]}

        # (a) the leader-only sink and the shards
        got = sorted(p for p in os.listdir(d1) if p.startswith("leader"))
        if got != ["leader.jsonl"]:
            fail("phase 18a: sink files %s, expected rank 0's alone" % got)
        leader = read_records("phase 18a", os.path.join(d1, "leader.jsonl"))
        if len(leader) != len(serial):
            fail("phase 18a: %d records, the serial run wrote %d"
                 % (len(leader), len(serial)))
        if health_blocks(leader) != want_health:
            fail("phase 18a: rank 0's health blocks differ from serial's")
        shards = shard_files("phase 18a", d1, "tl.jsonl", 2)
        hybrid = shard_files("phase 18b", d2, "hy.jsonl", 4)
        report = subprocess.run(
            [sys.executable, os.path.join(here, "scripts",
                                          "port_timeline_report.py"),
             "--json", "--straggler-k", str(iters + 1), "--glob",
             os.path.join(d1, "tl.jsonl.shard-*")],
            capture_output=True, text=True, timeout=120)
        if report.returncode != 0:
            fail("phase 18a: port_timeline_report exited %d: %s"
                 % (report.returncode, report.stderr[-2000:]))
        skew = json.loads(report.stdout)
        if skew["iterations_compared"] != iters or len(skew["hosts"]) != 2:
            fail("phase 18a: port_timeline_report read %s" % skew)
        rec["a_records"] = len(leader)
        rec["a_skew"] = {"max_phase_skew": skew["max_phase_skew"],
                         "barrier_wait_s": skew["barrier_wait_s"]}

        # (b) every rank's health, the world's; the health sites
        for what, ranks in (("phase 18a shards", shards),
                            ("phase 18b hybrid", hybrid)):
            for r, records in enumerate(ranks):
                if health_blocks(records) != want_health:
                    fail("%s rank %d: health blocks differ from serial's: "
                         "%s against %s" % (what, r, health_blocks(records),
                                            want_health))
        for name, ranks in (("a_leader", r1), ("a_shards", r1),
                            ("b_hybrid", r2)):
            for r, one in enumerate(rk[name] for rk in ranks):
                got = {k.replace("/host_staged", ""):
                       (v["calls"], v["bytes_per_call"], v["axis"])
                       for k, v in one["sites"].items()
                       if k.startswith("health/")}
                want = {k: (iters, b, "data")
                        for k, b in HEALTH_SITES.items()}
                if got != want:
                    fail("phase 18b %s rank %d: health sites %s, expected %s"
                         % (name, r, got, want))
        health_sites = {k: v for k, v in r1[0]["a_leader"]["sites"].items()
                        if k.startswith("health/")}
        rec["health_sites"] = health_sites

        # (c) halt: every rank at iteration 1
        for r, one in enumerate(rk["c_halt"] for rk in r3):
            if "TrainingHealthError" not in (one["error"] or "") or \
                    "at iteration 1:" not in one["error"]:
                fail("phase 18c rank %d: %r" % (r, one["error"]))
        check_ranks("phase 18c c_halt", [rk["c_halt"] for rk in r3], dev)
        by_path["obs_c_halt"] = r3[0]["c_halt"]["counts"]
        rec["c_halt"] = {"rcs": rc3,
                         "hist": [rk["c_halt"]["counts"]["hist"]
                                  for rk in r3],
                         "partition": [rk["c_halt"]["counts"]["partition"]
                                       for rk in r3]}

        # (d) the ranks' dumps align
        ddir = os.path.join(d1, "dumps")
        paths = sorted(os.path.join(ddir, p) for p in os.listdir(ddir))
        dumps = [podtrace.load_dump(p) for p in paths]
        ids = sorted((d["header"].get("process_index"),
                      d["header"].get("process_count")) for d in dumps)
        if ids != [(0, 2), (1, 2)]:
            fail("phase 18d: dump identities %s" % ids)
        al = podtrace.align(dumps)
        off = al["offsets"].get("p1", {})
        if not al["ok"] or off.get("bound_s") is None or \
                not math.isfinite(off["bound_s"]):
            fail("phase 18d: alignment %s" % al)
        check = subprocess.run(
            [sys.executable, os.path.join(here, "scripts",
                                          "port_pod_report.py"),
             "--check"] + paths, capture_output=True, text=True,
            timeout=120)
        if check.returncode != 0:
            fail("phase 18d: port_pod_report --check: %s"
                 % check.stdout[-2000:])
        rec["d_alignment"] = off

        # what was measured: each job's median s/iteration a rank over
        # the mean of the two unarmed jobs' (beside the other worlds)
        unarmed = float(np.mean([np.median(s) for name in (
            "unarmed", "unarmed_after") for s in rec[name]["s_per_iter"]]))
        rec["unarmed_mean_s"] = unarmed
        for name in ("unarmed", "a_leader", "a_shards", "unarmed_after",
                     "b_hybrid"):
            med = [float(np.median(s)) for s in rec[name]["s_per_iter"]]
            rec[name]["median_s"] = med
            ratio = ("" if name == "b_hybrid" else
                     " (%.2f-%.2fx the unarmed jobs' %.4f)"
                     % (min(med) / unarmed, max(med) / unarmed, unarmed))
            say("phase 18 %s: median s/iteration per rank %s%s; launches "
                "per rank hist %s, partition %s" % (
                    name, ["%.4f" % m for m in med], ratio,
                    rec[name]["hist"], rec[name]["partition"]))
        say("phase 18 serial int8 (%s): median s/iteration %.4f"
            % (dev.type, float(np.median(serial_s))))
        rec["serial_s_per_iter"] = serial_s
        say("phase 18a: rank 0's sink alone, %d records, every line JSON, "
            "health blocks serial's; 2 shards headed; timeline report: "
            "max phase skew %s, barrier wait %s"
            % (len(leader), skew["max_phase_skew"], skew["barrier_wait_s"]))
        say("phase 18b: every rank's health blocks serial's (data 2 ranks, "
            "hybrid 2 x 2); quant_sat per iteration %s"
            % [b["quant_sat"] for b in want_health[0]])
        for site, v in sorted(health_sites.items()):
            say(site_line(site, v) + " (%.3f ms a call)"
                % (1e3 * v["seconds"] / max(v["calls"], 1)))
        say("phase 18c: both ranks halted at iteration 1 (exit codes %s), "
            "the world %.1f s from its start; jobs %s s"
            % (rc3, rec["c_world_s"],
               ["%.2f" % rk["c_halt"]["job_s"] for rk in r3]))
        say("phase 18d: dumps of ranks %s aligned: offset %s s, bound %s s "
            "over %d sync points" % ([i for i, _ in ids],
                                     off["offset_s"], off["bound_s"],
                                     off["sync_points"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    say("phase 18 observability over worlds: %.1f s [%s]"
        % (rec["phase_s"], card))
    say(json.dumps({"observability_worlds": rec}))
    return {k: {"hist": v["hist"], "partition": v["partition"]}
            for k, v in by_path.items()}


PHASE19_TIMEOUT_S = 360      # each of phase 19's two worlds of routes


def world_ingest_phase(dev, sizes, sync, beside=None):
    """Phase 19: every load route in a world.  make_data's table of
    ``n_world_ingest`` rows (1M, phase 4's row count) written as CSV text
    with a header, the label as column 3, a weight and an ignored column
    (about 281 MB, so ``streaming=auto`` streams it), loaded by two
    2-rank ``tree_learner=data`` worlds sharing the card over gloo side by
    side ((a)-(c) in one, (d)-(h), whose caches the later routes read, in
    the other), job by job, each rank its shard through
    ``Dataset.load_train`` with the
    distributed bin finder, then trained at the main path's 255 leaves,
    int8 compacted, one iteration (the route is what is held; the tree
    shows its bins serve), beside the serial load of the same file:

    (a) resident text, the reference;
    (b) ``streaming=auto``: the serial passes onto each rank's device;
    (c) ``streaming=true ingest_workers=2``: each rank's byte-range
        workers parse only its rows in pass 2;
    (d) ``use_two_round_loading=true``, writing a reference-format cache
        (``save_binary_format=reference``) of a second name of the file;
    (e) (a) with ``is_save_binary_file=true``: rank 0 alone writes the
        whole table's native cache, gathered from both ranks;
    (f) (e)'s cache as ``data=``; (g) as the ``<data>.bin`` sibling;
    (h) (d)'s reference-format cache as the sibling.

    Every route's rank must load (a)'s rank's rows, bins (read back from
    where they live), labels and weights, and write (a)'s model text on
    both ranks; each rank launches the histogram once a leaf and the
    partition once a split (255 and 254 in one tree of 255 leaves).  (e)
    must leave one ``<data>.bin`` and no temp file, equal byte for byte
    (``cmp``) to the cache a serial load of the same file writes in this
    process.  Prints each route's load seconds a rank, the file's rows a
    second, the gather's bytes and seconds.  ``beside``, if given, is
    called while the world runs (the whole script runs phase 20 there).
    Returns rank 0's kernel launches per route, and what ``beside``
    returned."""
    import filecmp
    import glob
    import shutil
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.config import IOConfig
    from lightgbm_tpu_torch.io import parallel_ingest, streaming
    from lightgbm_tpu_torch.io.dataset import Dataset
    card = card_name()
    t_phase = time.perf_counter()
    n = sizes["n_world_ingest"]
    rec, by_path = {"card": card, "rows": n, "routes": {}}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_world_ingest_")
    try:
        data = os.path.join(tmp, "ingest.csv")
        t0 = time.perf_counter()
        write_ingest_csv(data, n, SEED + 19)
        rec["write_s"] = time.perf_counter() - t0
        rec["file_bytes"] = os.path.getsize(data)
        if rec["file_bytes"] < streaming.AUTO_MIN_BYTES:
            fail("phase 19: the file is %d bytes, under streaming=auto's "
                 "%d" % (rec["file_bytes"], streaming.AUTO_MIN_BYTES))
        # other names of the file, for the caches beside them
        e, h, serial = (os.path.join(tmp, name)
                        for name in ("e.csv", "h.csv", "serial.csv"))
        for name in (e, h, serial):
            os.link(data, name)
        cols = {"has_header": "true", "label_column": "name:label",
                "weight_column": "name:weight", "ignore_column": "name:skip"}
        base = dict(cols, objective="binary", num_iterations=1,
                    learning_rate=0.1, max_bin=255, hist_dtype="int8",
                    num_leaves=sizes.get("parallel_leaves", 255),
                    tree_learner="data", num_machines=2)
        save = {"is_save_binary_file": "true"}
        routes = [
            ("a_resident", data, {"streaming": "false"}),
            ("b_streamed_auto", data, {}),
            ("c_workers2", data, {"streaming": "true", "ingest_workers": 2}),
            ("d_two_round", h, dict(save, streaming="false",
                                    use_two_round_loading="true",
                                    save_binary_format="reference")),
            ("e_save", e, dict(save, streaming="false")),
            ("f_cache_direct", e + ".bin", {}),
            ("g_cache_sibling", e, {}),
            ("h_reference_sibling", h, {})]
        jobs = [{"name": name, "load": True,
                 "auto_min_bytes": streaming.AUTO_MIN_BYTES,
                 "params": dict(base, data=path, **kw)}
                for name, path, kw in routes]
        worlds = [start_world(tmp, "routes_" + tag, 2, part, dev, {},
                              PHASE19_TIMEOUT_S, threads=2)
                  for tag, part in (("text", jobs[:3]),
                                    ("caches", jobs[3:]))]
        t0 = time.perf_counter()
        Dataset.load_train(IOConfig(
            data_filename=serial, has_header=True, max_bin=255,
            label_column="name:label", weight_column="name:weight",
            ignore_column="name:skip", streaming="false",
            is_save_binary_file=True))
        rec["serial_cache_s"] = time.perf_counter() - t0
        say("phase 19: %d rows x 31 columns written as CSV, %d bytes in "
            "%.1f s; the serial load and cache %.1f s, beside the world "
            "[%s]" % (n, rec["file_bytes"], rec["write_s"],
                      rec["serial_cache_s"], card))
        beside_out = beside() if beside else None
        ranks, wdirs = [{}, {}], {}
        for world in worlds:
            got, wdir, _ = finish_world(world, 19)
            for rk, one in zip(ranks, got):
                rk.update(one)
            wdirs.update((name, wdir) for name in got[0])

        want = [rk["a_resident"]["load"] for rk in ranks]
        text = rank_texts(wdirs["a_resident"], "a_resident", 2)[0]
        for name, _, _ in routes:
            what = "phase 19 " + name
            recs = [rk[name] for rk in ranks]
            if set(rank_texts(wdirs[name], name, 2)) != {text}:
                fail("%s: a rank's model text differs from (a)'s" % what)
            for r, one in enumerate(recs):
                got = one["load"]
                for key in ("rows", "bins", "label", "weights", "num_data",
                            "global_num_data"):
                    if got[key] != want[r][key]:
                        fail("%s rank %d: its %s differ from (a)'s rank's"
                             % (what, r, key))
            on = {one["load"]["bins_on"] for one in recs}
            if on != ({dev.type} if name[0] in "bc" else {"host"}):
                fail("%s: bins on %s" % (what, on))
            grown_launches(what, recs, dev)
            by_path["world_ingest_" + name] = recs[0]["counts"]
            secs = [one["load"]["s"] for one in recs]
            rec["routes"][name] = {
                "load_s": secs, "rows_per_s": [n / v for v in secs],
                "s_per_iter": [one["iter_s"] for one in recs],
                "hist": [one["counts"]["hist"] for one in recs],
                "partition": [one["counts"]["partition"] for one in recs]}
            say("%s: load s per rank %s (%s rows/s of the file), shard "
                "rows %s, bins on %s; s/iteration %s; launches per rank "
                "hist %s, partition %s [%s]" % (
                    what, ["%.3f" % v for v in secs],
                    ["%.0f" % (n / v) for v in secs],
                    [one["load"]["num_data"] for one in recs], sorted(on),
                    [["%.3f" % v for v in one["iter_s"]] for one in recs],
                    rec["routes"][name]["hist"],
                    rec["routes"][name]["partition"], card))

        # (e) one cache, rank 0's, the serial run's bytes; (d) one
        # reference-format cache
        left = sorted(os.path.basename(p) for p in glob.glob(
            os.path.join(tmp, "*.bin*")))
        if left != ["e.csv.bin", "h.csv.bin", "serial.csv.bin"]:
            fail("phase 19: cache files %s, expected e.csv.bin, h.csv.bin "
                 "and serial.csv.bin alone" % left)
        if not filecmp.cmp(e + ".bin", serial + ".bin", shallow=False):
            fail("phase 19 (e): the world's cache differs from the serial "
                 "load's")
        if Dataset._classify_binary_cache(h + ".bin") != "foreign":
            fail("phase 19 (d): h.csv.bin is not a reference-format cache")
        gather = ranks[0]["e_save"]["load"]["world_cache"]
        if not gather or ranks[1]["e_save"]["load"]["world_cache"]:
            fail("phase 19 (e): rank 0 alone must gather and write: %s"
                 % [rk["e_save"]["load"]["world_cache"] for rk in ranks])
        rec["e_gather"] = gather
        rec["e_cache_bytes"] = os.path.getsize(e + ".bin")
        say("phase 19 (e): one cache, rank 0's, %d bytes, cmp-equal to the "
            "serial load's; gathered %d bytes in %.3f s, written in %.3f s "
            "[%s]" % (rec["e_cache_bytes"], gather["gather_bytes"],
                      gather["gather_s"], gather["write_s"], card))
    finally:
        parallel_ingest.shutdown_workers()
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    say("phase 19 every load route in a world: %.1f s%s [%s]"
        % (rec["phase_s"], " (with what ran beside it)" if beside else "",
           card))
    say(json.dumps({"world_ingest": rec}))
    return {k: {"hist": v["hist"], "partition": v["partition"]}
            for k, v in by_path.items()}, beside_out


def sharded_phase(dev, sizes, x, served, sync):
    """Phase 20: every serving lane of the JAX engine, on the card at full
    width (28 features, 255 leaves), over three models: (a) phase 4's
    5-tree main-path model (at 4 shards a shard of no trees), (b) phase
    11's 200-tree depth-wise int8 model and (c) phase 7's multiclass K =
    5 model (a carry of 5 rows).

    Tree-axis sharding: for each model and leaf table (float32, int8),
    engines on ``["cuda:0"] * k`` (one card holds every shard) for k = 2,
    3 and 4 score every bucket of the default ladder on the held-out rows
    (the last bucket all of them, in two chunks): scores and leaf indices
    bitwise the card's one-device engine's, and on ``serve_cpu_rows``
    rows the CPU sharded engine's; each shard's node-table bytes are
    recorded.  ``scores()`` p50 at 1, 1,024 and 65,536 rows for k = 1, 2
    and 4 on (b) float32 (20, 20 and 5 calls), and ``serve/tree_carry``
    (calls, bytes a call, host seconds) over (b)'s 4-shard ladder.  The
    device rule: ``ServingEngine(flat, shards=device_count + 1)`` and
    ``task=predict serve_shards=<device_count + 1>`` fail with the JAX
    package's message.  The per-tree replay: ``algo="scan"`` bitwise
    ``bfs`` at 1, 1,024 and 65,536 rows for (a) and (c), float32 and int8
    (leaf indices too), and (b) int8 at 1,024 rows, each timed beside
    ``bfs`` (``scores()``, the better of 2 calls; (b)'s replay once);
    ``task=predict predict_algo=scan``'s result file byte-equal to
    ``bfs``'s on (c).  A
    front over (b) on 2 shards, float32, hot-swapped to 4 shards, int8
    (``front_swap``, 8 clients for ``shard_front_s`` seconds, 300
    requests scored alone).  Neither kernel may launch in this process
    while it serves (the ``task=predict`` subprocesses are not counted).
    Prints a ``{"serving_sharded": ...}`` line; returns the launch
    counts of serving."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import serving, telemetry
    from lightgbm_tpu_torch.ops import compact, hist_cuda
    from lightgbm_tpu_torch.utils import log
    n_train, cpu_rows = sizes["n_train"], sizes["serve_cpu_rows"]
    x_test = x[n_train:]
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp()
    ladder = serving.DEFAULT_BUCKETS

    def place(k):
        return [torch.device("cuda", 0) if on_card else dev] * k

    def ladder_rows(b):
        return x_test if b == ladder[-1] else x_test[:b]

    def table_bytes(eng):
        return [sum(v.numel() * v.element_size() for v in t.values())
                for t in eng._device_tables()]

    rec = {"card": card_name(), "models": {}}
    paths, flats = {}, {}
    reset_counts()
    for name in ("a", "b", "c"):
        paths[name] = os.path.join(tmp, "model_%s.txt" % name)
        with open(paths[name], "w") as f:
            f.write(served[name])
        flats[name] = lgt.GBDT.from_model_file(
            paths[name], device=dev).export_flat()

    # tree-axis sharding, every model, table and shard count
    ones = {}
    for name, flat in flats.items():
        K = flat.num_class
        mrec = {"trees": flat.num_trees, "num_class": K,
                "max_depth": flat.max_depth, "engines": {}}
        t0 = time.perf_counter()
        for quantize in ("float32", "int8"):
            one = ones[(name, quantize)] = serving.ServingEngine(
                flat, quantize=quantize, device=dev)
            want = {b: one.scores(ladder_rows(b)) for b in ladder}
            want_leaves = ({b: one.leaf_indices(ladder_rows(b))
                            for b in ladder} if quantize == "float32"
                           else {})
            mrec["engines"]["%s_1" % quantize] = {
                "table_bytes": table_bytes(one)}
            for k in (2, 3, 4):
                what = "phase 20 (%s) %s at %d shards" % (name, quantize, k)
                eng = serving.ServingEngine(flat, quantize=quantize,
                                            shards=k, device=place(k))
                cpu = serving.ServingEngine(flat, quantize=quantize,
                                            shards=k, device="cpu")
                for b in ladder:
                    rows = ladder_rows(b)
                    got = eng.scores(rows)
                    if not (got.shape == (K, len(rows))
                            and np.isfinite(got).all()):
                        fail("%s bucket %d: scores not finite [K, N]"
                             % (what, b))
                    if not np.array_equal(got, want[b]):
                        fail("%s bucket %d: scores differ from the "
                             "one-device engine's" % (what, b))
                    n_cmp = min(len(rows), cpu_rows)
                    if not np.array_equal(got[:, :n_cmp],
                                          cpu.scores(rows[:n_cmp])):
                        fail("%s bucket %d: card scores differ from the "
                             "CPU sharded engine's" % (what, b))
                    if quantize == "float32":
                        leaves = eng.leaf_indices(rows)
                        if not np.array_equal(leaves, want_leaves[b]):
                            fail("%s bucket %d: leaf indices differ from "
                                 "the one-device engine's" % (what, b))
                        if not np.array_equal(
                                leaves[:n_cmp],
                                cpu.leaf_indices(rows[:n_cmp])):
                            fail("%s bucket %d: card leaf indices differ "
                                 "from the CPU sharded engine's"
                                 % (what, b))
                mrec["engines"]["%s_%d" % (quantize, k)] = {
                    "tree_blocks": eng.tree_blocks,
                    "table_bytes": table_bytes(eng)}
        mrec["check_s"] = time.perf_counter() - t0
        rec["models"][name] = mrec
        say("phase 20 (%s): %d trees, K = %d: at 2, 3 and 4 shards on one "
            "card, float32 and int8, scores bitwise the one-device "
            "engine's at buckets %s (%d held-out rows) and the CPU sharded "
            "engine's on %d, leaf indices too; table bytes a shard at 4 "
            "shards %s (float32), one device %d; %.1f s" % (
                name, flat.num_trees, K, list(ladder), len(x_test),
                min(len(x_test), cpu_rows),
                mrec["engines"]["float32_4"]["table_bytes"],
                mrec["engines"]["float32_1"]["table_bytes"][0],
                mrec["check_s"]))
    blocks_a = rec["models"]["a"]["engines"]["float32_4"]["tree_blocks"]
    if flats["a"].num_trees == 5 and blocks_a[-1][0] != blocks_a[-1][1]:
        fail("phase 20 (a): 5 trees at 4 shards left no shard empty: %s"
             % blocks_a)

    # scores() latency at k = 1, 2 and 4 on (b) float32
    flat_b = flats["b"]
    lat_engines = {1: ones[("b", "float32")]}
    for k in (2, 4):
        lat_engines[k] = serving.ServingEngine(flat_b, shards=k,
                                               device=place(k)).warmup()
    lat = {}
    for n, reps in ((1, 20), (1024, 20), (65536, 5)):
        rows = x_test[:n]
        for k, eng in lat_engines.items():
            eng.scores(rows)
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                eng.scores(rows)
                times.append(time.perf_counter() - t0)
            lat.setdefault(str(k), {})[str(n)] = {
                "calls": reps, "p50_ms": float(np.median(times)) * 1e3}
    rec["latency_b_float32"] = lat
    say("phase 20 (b) float32 scores() p50 ms on the host clock at 1 / "
        "1,024 / 65,536 rows: %s" % "; ".join(
            "%s shard%s %s" % (k, "" if k == "1" else "s", " / ".join(
                "%.3f" % v["p50_ms"] for v in by_n.values()))
            for k, by_n in lat.items()))

    # serve/tree_carry over (b)'s 4-shard ladder
    telemetry.enable()
    telemetry.reset()
    try:
        for b in ladder:
            lat_engines[4].scores(ladder_rows(b))
        snap = telemetry.interconnect_snapshot()
    finally:
        telemetry.disable()
        telemetry.reset()
    site = (snap or {}).get("sites", {}).get("serve/tree_carry")
    # a top-bucket chunk at a time past the ladder's other buckets
    chunks = list(ladder[:-1]) \
        + [ladder[-1]] * -(-len(x_test) // ladder[-1])
    row_bytes = 4 * flat_b.num_class
    if not site or site["calls"] != 3 * len(chunks) \
            or site["bytes"] != 3 * row_bytes * sum(chunks) \
            or site["bytes_per_call"] != row_bytes * ladder[-1]:
        fail("phase 20: serve/tree_carry %r, expected 3 calls a chunk of "
             "%s bytes" % (site, [row_bytes * c for c in chunks]))
    rec["tree_carry"] = dict(site, calls_per_chunk=3,
                             seconds_per_call=site["seconds"]
                             / site["calls"])
    say("phase 20 serve/tree_carry, (b) at 4 shards over %d chunks: %d "
        "calls, %d bytes (%d a top-bucket call), %.6f host s (%.2f us a "
        "call)" % (len(chunks), site["calls"], site["bytes"],
                   site["bytes_per_call"], site["seconds"],
                   rec["tree_carry"]["seconds_per_call"] * 1e6))

    # the device rule
    if on_card:
        count = torch.cuda.device_count()
        want_msg = ("serve_shards=%d exceeds available devices (%d) — the "
                    "tree-sharded engine never silently shrinks its mesh"
                    % (count + 1, count))
        try:
            serving.ServingEngine(flats["a"], shards=count + 1)
            fail("phase 20: shards=%d built on %d devices" % (count + 1,
                                                              count))
        except log.Fatal as e:
            if str(e) != want_msg:
                fail("phase 20: over-subscribed shards said %r" % str(e))
        rec["device_rule"] = want_msg

    # the per-tree replay against bfs
    scan = {}
    ladder3 = (1, 1024, 65536)
    for name, quantize, sizes_n in (
            ("a", "float32", ladder3), ("a", "int8", ladder3),
            ("c", "float32", ladder3), ("c", "int8", ladder3),
            ("b", "int8", (1024,))):
        bfs = ones[(name, quantize)]
        eng = serving.ServingEngine(flats[name], quantize=quantize,
                                    algo="scan", device=dev)
        for n in sizes_n:
            rows = x_test[:n]
            what = "phase 20 (%s) %s scan at %d rows" % (name, quantize, n)
            scan_ms, got = timed_call(eng.scores, rows)
            if not np.array_equal(got, bfs.scores(rows)):
                fail("%s: scores differ from bfs" % what)
            if quantize == "float32" and not np.array_equal(
                    eng.leaf_indices(rows), bfs.leaf_indices(rows)):
                fail("%s: leaf indices differ from bfs" % what)
            if name != "b":          # (b)'s replay takes seconds a call
                scan_ms = min(scan_ms, wall_ms(eng.scores, rows, calls=1))
            scan["%s_%s_%d" % (name, quantize, n)] = {
                "scan_ms": scan_ms, "bfs_ms": wall_ms(bfs.scores, rows)}
    rec["scan_vs_bfs"] = scan
    say("phase 20 predict_algo=scan bitwise bfs (leaf indices too in "
        "float32); scores() ms scan / bfs: %s" % "; ".join(
            "%s %.3f / %.3f" % (k, v["scan_ms"], v["bfs_ms"])
            for k, v in scan.items()))

    # a front over (b): 2 shards float32, hot-swapped to 4 shards int8
    rec["front"] = front_swap(
        "phase 20 front over (b)",
        ("float32_2shards", serving.ServingEngine(flat_b, shards=2,
                                                  device=place(2))),
        ("int8_4shards", serving.ServingEngine(flat_b, quantize="int8",
                                               shards=4, device=place(4))),
        x_test, sizes["shard_front_s"], 300)
    by_path = {"serving_sharded": {"hist": hist_cuda.launches,
                                   "partition": compact.launches}}
    if hist_cuda.launches or compact.launches:
        fail("phase 20: a kernel launched while serving: %s"
             % by_path["serving_sharded"])

    # task=predict on (c): scan against bfs, and the device rule, at once
    data = os.path.join(tmp, "held_out.tsv")
    np.savetxt(data, np.column_stack([np.zeros(len(x_test)), x_test]),
               delimiter="\t", fmt="%.17g")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    modes = {"bfs": [], "scan": ["predict_algo=scan"]}
    if on_card:
        modes["over"] = ["serve_shards=%d" % (torch.cuda.device_count() + 1)]
    runs, outs = {}, {}
    t0 = time.perf_counter()
    try:
        for mode, extra in modes.items():
            out = os.path.join(tmp, "%s.txt" % mode)
            runs[mode] = (out, subprocess.Popen(
                [sys.executable, "-m", "lightgbm_tpu_torch", "task=predict",
                 "data=" + data, "input_model=" + paths["c"],
                 "output_result=" + out, "device=" + dev.type] + extra,
                env=env, cwd=tmp, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT))
        for mode, (out, proc) in runs.items():
            outs[mode] = proc.communicate(timeout=600)[0].decode()
    finally:
        for _out, proc in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rec["cli_s"] = time.perf_counter() - t0
    for mode in ("bfs", "scan"):
        if runs[mode][1].returncode != 0:
            fail("phase 20 task=predict %s exited %d: %s" % (
                mode, runs[mode][1].returncode, outs[mode][-2000:]))
    with open(runs["bfs"][0], "rb") as f:
        bfs_text = f.read()
    with open(runs["scan"][0], "rb") as f:
        scan_text = f.read()
    if scan_text != bfs_text or bfs_text.count(b"\n") != len(x_test):
        fail("phase 20 task=predict predict_algo=scan: the result file "
             "differs from bfs's")
    if on_card:
        over = runs["over"][1]
        if over.returncode == 0 or rec["device_rule"] not in outs["over"]:
            fail("phase 20 task=predict %s exited %d without the device "
                 "rule's message: %s" % (modes["over"][0], over.returncode,
                                         outs["over"][-2000:]))
    say("phase 20 task=predict on (c), %d rows: predict_algo=scan's file "
        "(%d bytes) byte-equal to bfs's%s; %.1f s" % (
            len(x_test), len(bfs_text),
            "; %s exited %d with the device rule's message" % (
                modes["over"][0], runs["over"][1].returncode)
            if on_card else "", rec["cli_s"]))
    for out, _proc in runs.values():
        if os.path.exists(out):
            os.unlink(out)
    for path in paths.values():
        os.unlink(path)
    os.unlink(data)
    os.rmdir(tmp)
    rec["phase_s"] = time.perf_counter() - t_phase
    say("phase 20 every serving lane: %.1f s, no kernel launch by the "
        "engines and the front in this process [%s]" % (rec["phase_s"],
                                                        rec["card"]))
    say(json.dumps({"serving_sharded": rec}))
    return by_path


def phase20_rehearsal() -> int:
    """``chip_smoke.py --phase20``: the build, the three served models
    trained anew (phase 4's main path, phase 11's (b) and phase 7's
    multiclass K = 5) and phase 20 alone (a short call for the serving
    lanes; the contract run is the script without arguments)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lightgbm_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.build()
    dev, sizes = torch.device("cuda"), FULL
    x, latent = make_table(sizes["n_train"] + sizes["n_test"], 28, SEED)
    served = train_served(dev, sizes, x, latent, torch.cuda.synchronize)
    sharded_phase(dev, sizes, x, served, torch.cuda.synchronize)
    say("chip_smoke --phase20: %.1f s" % (time.perf_counter() - t0))
    return 0


def train_served(dev, sizes, x, latent, sync):
    """The three models phase 20 serves, trained on ``dev``: (a) phase
    4's main path (5 iterations), (b) ``SERVE_B`` (``serve_iters``) and
    (c) phase 7's multiclass K = 5 (3 iterations, its labels)."""
    import lightgbm_tpu_torch as lgt
    n_train, F, K = sizes["n_train"], x.shape[1], 5
    y = (latent > 0).astype(np.float32)
    train_set = lgt.Dataset.from_arrays(x[:n_train], y[:n_train],
                                        max_bin=255)
    rng = np.random.RandomState(SEED + 7)
    proj = rng.randn(F, K) / np.sqrt(F)
    y_multi = np.argmax(x @ proj + 0.5 * rng.randn(len(x), K), 1) \
        .astype(np.float32)
    multi_set = lgt.Dataset.from_arrays(x[:n_train], y_multi[:n_train],
                                        max_bin=255, reference=train_set)
    base = {"num_leaves": 255, "learning_rate": 0.1,
            "hist_dtype": "float32", "max_bin": 255}
    served = {}
    for name, params, ds in (
            ("a", dict(base, objective="binary", num_iterations=5),
             train_set),
            ("b", dict(SERVE_B, num_iterations=sizes["serve_iters"]),
             train_set),
            ("c", dict(base, objective="multiclass", num_class=K,
                       num_iterations=3), multi_set)):
        booster, iter_s, _ = drive(params, ds, dev, sync)
        served[name] = booster.model_to_string()
        say("phase 20 model (%s): %d trees in %.1f s" % (
            name, len(booster.models), sum(iter_s)))
    return served


def phase19_rehearsal() -> int:
    """``chip_smoke.py --phase19``: the build and phase 19 alone (a short
    call for the load routes in a world; the contract run is the script
    without arguments)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lightgbm_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.build()
    world_ingest_phase(torch.device("cuda"), FULL, torch.cuda.synchronize)
    say("chip_smoke --phase19: %.1f s" % (time.perf_counter() - t0))
    return 0


def phase18_rehearsal() -> int:
    """``chip_smoke.py --phase18``: the build and phase 18 alone (a short
    call for observability over worlds; the contract run is the script
    without arguments)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lightgbm_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.build()
    sizes = FULL
    x, latent = make_table(sizes["n_train"] + sizes["n_test"], 28, SEED)
    y = (latent > 0).astype(np.float32)
    observability_world_phase(torch.device("cuda"), sizes, x, y,
                              torch.cuda.synchronize)
    say("chip_smoke --phase18: %.1f s" % (time.perf_counter() - t0))
    return 0


def phase17_rehearsal() -> int:
    """``chip_smoke.py --phase17``: the build and phase 17 alone (a short
    call for GOSS, checkpoints and the drain over worlds; the contract
    run is the script without arguments)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lightgbm_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.build()
    sizes = FULL
    x, latent = make_table(sizes["n_train"] + sizes["n_test"], 28, SEED)
    y = (latent > 0).astype(np.float32)
    goss_elastic_phase(torch.device("cuda"), sizes, x, y,
                       torch.cuda.synchronize)
    say("chip_smoke --phase17: %.1f s" % (time.perf_counter() - t0))
    return 0


def phase16_rehearsal() -> int:
    """``chip_smoke.py --phase16``: the build and phase 16 alone (a short
    call for the 2-D learners; the contract run is the script without
    arguments)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lightgbm_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.build()
    sizes = FULL
    x, latent = make_table(sizes["n_train"] + sizes["n_test"], 28, SEED)
    y = (latent > 0).astype(np.float32)
    hybrid_voting_phase(torch.device("cuda"), sizes, x, y,
                        torch.cuda.synchronize)
    say("chip_smoke --phase16: %.1f s" % (time.perf_counter() - t0))
    return 0


def phase15_rehearsal() -> int:
    """``chip_smoke.py --phase15``: the build, phase 4's main path and
    phase 15 alone (a short call for the parallel phase; the contract run
    is the script without arguments)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.build()
    dev, sizes = torch.device("cuda"), FULL
    x, latent = make_table(sizes["n_train"] + sizes["n_test"], 28, SEED)
    y = (latent > 0).astype(np.float32)
    train_set = lgt.Dataset.from_arrays(x[:sizes["n_train"]],
                                        y[:sizes["n_train"]], max_bin=255)
    booster, _, _ = drive({"objective": "binary", "num_leaves": 255,
                           "num_iterations": 5, "learning_rate": 0.1,
                           "hist_dtype": "float32", "max_bin": 255},
                          train_set, dev, torch.cuda.synchronize)
    parallel_phase(dev, sizes, x, y, {"a": booster.model_to_string()},
                   torch.cuda.synchronize)
    say("chip_smoke --phase15: %.1f s" % (time.perf_counter() - t0))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [PARALLEL_WORKER]:
        sys.exit(parallel_worker(sys.argv[2]))
    if sys.argv[1:] == ["--phase15"]:
        sys.exit(phase15_rehearsal())
    if sys.argv[1:] == ["--phase17"]:
        sys.exit(phase17_rehearsal())
    if sys.argv[1:] == ["--phase18"]:
        sys.exit(phase18_rehearsal())
    if sys.argv[1:] == ["--phase19"]:
        sys.exit(phase19_rehearsal())
    if sys.argv[1:] == ["--phase20"]:
        sys.exit(phase20_rehearsal())
    sys.exit(phase16_rehearsal() if sys.argv[1:] == ["--phase16"]
             else main())
