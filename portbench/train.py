"""A training cell: set-up, the measured window, the traced window and
the check of what they produced.

Set-up makes the table from the seed, bins it through the port
(``Dataset.from_arrays``), builds the booster with its first tree
(``lightgbm_tpu_torch.train`` with ``num_iterations=1``) and grows the
next ``check_trees - 1`` trees through ``GBDT.train_one_iter``, the
window's own call.  The window loops ``train_one_iter(is_eval=False)``
on that same booster.  Both keep the training scores ``[K, N]`` the
program held before the iterations the check replays: each set-up
iteration, and the first and the last iteration of the window (one
device copy of the scores an iteration, into one buffer).

The check, after the window, with the program's state freed but its
trees, its scores and the kept scores:

- ``split_gap``, ``root_gain_gap`` and ``leaf_gap``: the reference
  replays the trees of each kept iteration (reference/trees.py) from
  its own float64 gradients (reference/objectives/, found by the
  objective's name) of the program's scores before that iteration:
  each split against the best open split, the root split's gain
  against its own gain of that split, and each leaf's value against its
  own ``-G/H`` as a share of the larger of that leaf's and the median
  leaf's magnitude.  Tree 1 starts from zeros;
- ``score_gap``: the program's scores before each set-up iteration
  after the first against the reference's own sums of its leaf values,
  and its kept scores and its scores after the window against a walk of
  the trees it had grown by then over the table's level codes, as a
  share of the larger of the row's and the median row's magnitude;
- ``trees_short``: iterations run less iterations whose trees were kept.
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np

from . import cost, data
from .reference import objectives, trees as rtrees

SPAN_NAMES = ("gradient", "bagging", "goss", "grow", "histogram",
              "split_find", "partition", "score_update", "valid_update",
              "model_readback", "eval")


def rel_gap(a, b) -> float:
    """max |a - b| / max(|b|, median |b|), float64 tensors or arrays."""
    import torch
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    if b.numel() == 0:
        return 0.0
    mag = b.abs()
    floor = float(mag.median())
    den = torch.clamp(mag, min=max(floor, 1e-300))
    return float(((a - b).abs() / den).max())


class Program:
    """Hooks a check or a test can wrap around the program; the default
    runs it as it is."""

    def params(self, params: dict) -> dict:
        return params


def prepare(cfg: dict, seed: int, program: Program = Program()) -> dict:
    """The table from the seed, binned through the port."""
    import lightgbm_tpu_torch as lgt
    table = data.make_table(cfg, seed)
    params = program.params(dict(cfg["params"]))
    tb = time.perf_counter()
    ds = lgt.Dataset.from_arrays(table.x, table.y,
                                 max_bin=int(params["max_bin"]),
                                 query_boundaries=table.query_boundaries)
    return {"table": table, "params": params, "dataset": ds,
            "bin_s": time.perf_counter() - tb}


def start(prep: dict, traffic: dict, device: str) -> dict:
    """The booster with its first ``check_trees`` trees, and the training
    scores it held before each iteration after the first."""
    import torch
    import lightgbm_tpu_torch as lgt
    booster = lgt.train(dict(prep["params"], num_iterations=1),
                        prep["dataset"], device=device)
    points = []
    for _ in range(int(traffic["check_trees"]) - 1):
        points.append((len(booster.models), booster.score.clone()))
        booster.train_one_iter(is_eval=False)
    if booster.device.type == "cuda":
        torch.cuda.synchronize(booster.device)
    return dict(prep, booster=booster, points=points,
                iterations=int(traffic["check_trees"]), stops=0)


def setup(cfg: dict, traffic: dict, seed: int, device: str,
          program: Program = Program()) -> dict:
    st = start(prepare(cfg, seed, program), traffic, device)
    st["dataset"] = None
    return st


class Kept:
    """The scores before the first and before the last iteration of a
    loop, with the index of each one's first tree: ``mark()`` before
    every iteration copies the scores into one buffer."""

    def __init__(self, booster):
        import torch
        self.booster = booster
        self.first = (len(booster.models), booster.score.clone())
        self.last = torch.empty_like(booster.score)
        self.at = None

    def mark(self):
        self.at = len(self.booster.models)
        self.last.copy_(self.booster.score)

    def points(self):
        if self.at is None or self.at == self.first[0]:
            return [self.first]
        return [self.first, (self.at, self.last)]


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(st: dict, seconds: float):
    """Iterations until ``seconds`` have passed; (iterations, seconds)."""
    b = st["booster"]
    kept = Kept(b)
    _sync(b.device)
    t0 = time.perf_counter()
    n = 0
    while True:
        kept.mark()
        st["stops"] += bool(b.train_one_iter(is_eval=False))
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(b.device)
    el = time.perf_counter() - t0
    st["points"] += kept.points()
    st["iterations"] += n
    return n, el


def traced(st: dict, iters: int):
    """``iters`` iterations by the host clock, then ``iters`` under the
    profiler with telemetry armed: (Trace, telemetry snapshot, traced
    trees, seconds of the untraced iterations)."""
    from lightgbm_tpu_torch import telemetry
    from .trace import Window
    b = st["booster"]
    kept = Kept(b)
    _sync(b.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        kept.mark()
        st["stops"] += bool(b.train_one_iter(is_eval=False))
    _sync(b.device)
    plain_s = time.perf_counter() - t0
    before = len(b.models)
    telemetry.enable()
    telemetry.reset()
    try:
        with Window(SPAN_NAMES) as w:
            for _ in range(iters):
                kept.mark()
                st["stops"] += bool(b.train_one_iter(is_eval=False))
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
    st["points"] += kept.points()
    st["iterations"] += 2 * iters
    return w.trace, snap, b.models[before:], plain_s


def release(st: dict):
    """Keep what the check reads and free the program's state."""
    import torch
    b = st["booster"]
    kept = {"trees": list(b.models), "score": b.score.detach().clone(),
            "device": b.device}
    st["booster"] = None
    del b
    gc.collect()
    if kept["device"].type == "cuda":
        torch.cuda.empty_cache()
    return kept


def check(st: dict, kept: dict, cfg: dict, traffic: dict) -> dict:
    """The numbers compared (module docstring)."""
    import torch
    table, params = st["table"], st["params"]
    dev = kept["device"]
    codes = torch.as_tensor(table.codes, device=dev)
    levels = np.array([g.size for g in table.grids])
    grad_fn = objectives.load(params["objective"]).make(table, params, dev)
    trees = kept["trees"]
    K, N = kept["score"].shape
    f64 = torch.float64
    points = [(0, torch.zeros(K, N, dtype=f64, device=dev))] + st["points"]
    gaps = {"split_gap": 0.0, "root_gain_gap": 0.0, "leaf_gap": 0.0,
            "score_gap": 0.0,
            "trees_short": float(st["iterations"] - len(trees) // K)}
    lr = float(params["learning_rate"])
    hister = rtrees.Histogrammer(codes, levels)
    # the reference's own sums of its leaf values, while the replayed
    # iterations run on from tree 1 (the set-up's)
    ref, ref_upto = torch.zeros(K, N, dtype=f64, device=dev), 0
    for at, base in points:
        if at == ref_upto and at > 0:
            gaps["score_gap"] = max(gaps["score_gap"], rel_gap(base, ref))
        g, h = grad_fn(base.to(f64))
        for k, t in enumerate(trees[at:at + K]):
            rep = rtrees.replay(hister, g[k], h[k], t.split_feature_real,
                                rtrees.level_cuts(table.grids,
                                                  t.split_feature_real,
                                                  t.threshold),
                                t.left_child, t.right_child, t.leaf_value,
                                int(params["num_leaves"]), lr,
                                float(params["min_data_in_leaf"]),
                                float(params["min_sum_hessian_in_leaf"]))
            gaps["split_gap"] = max(gaps["split_gap"], rep.split_gap)
            if t.num_leaves > 1:
                prog = float(t.split_gain[0])
                gaps["root_gain_gap"] = max(
                    gaps["root_gain_gap"],
                    abs(prog - rep.root_gain) / abs(rep.root_gain)
                    if np.isfinite(rep.root_gain) and rep.root_gain != 0
                    else 1.0)
            gaps["leaf_gap"] = max(gaps["leaf_gap"],
                                   rel_gap(t.leaf_value, rep.leaf_values)
                                   if rep.assign else 1.0)
            if at == ref_upto:
                for leaf, rows in enumerate(rep.assign):
                    ref[k, rows] += float(rep.leaf_values[leaf])
        if at == ref_upto:
            ref_upto = at + K
        del g, h
    del ref
    del hister
    due = {at: base for at, base in points if at > 0}
    total = torch.zeros(K, N, dtype=f64, device=dev)
    for i, t in enumerate(trees):
        if i in due:
            gaps["score_gap"] = max(gaps["score_gap"],
                                    rel_gap(due.pop(i), total))
        cut = rtrees.level_cuts(table.grids, t.split_feature_real,
                                t.threshold)
        total[i % K] += rtrees.walk_codes(codes, t.split_feature_real, cut,
                                          t.left_child, t.right_child,
                                          t.leaf_value)
    if due:                     # a kept iteration that grew no tree
        gaps["score_gap"] = max([gaps["score_gap"]]
                                + [rel_gap(v, total) for v in due.values()])
    gaps["score_gap"] = max(gaps["score_gap"],
                            rel_gap(kept["score"].to(dev), total))
    return gaps


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: str, t_start: float, e2e, read_layer,
        program: Program = None) -> dict:
    """One run of a training cell (run.run_cell)."""
    st = setup(cfg, traffic, seed, device, program or Program())
    setup_s = time.perf_counter() - t_start
    dev = st["booster"].device
    out = {"device": dev, "extra": {}, "breakdown": None, "profiler": None}
    if trace:
        iters = int(traffic["trace_iters"])
        tr, snap, trs, plain_s = traced(st, iters)
        out["metrics"] = read_layer(SimpleNamespace(
            trace=tr, telemetry=snap, iters=len(trs), trees=trs,
            work=work(trs, st["table"], st["params"]),
            bin_s=st["bin_s"], window_s=tr.window_s))
        out["extra"] = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        out["breakdown"] = tr.breakdown()
        out["profiler"] = {"untraced_s": plain_s, "traced_s": tr.window_s,
                           "iterations": iters}
        out["attempted"] = 2 * iters
    else:
        n, el = window(st, seconds)
        values = {"train_iters_per_s": n / el, "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]} for m in e2e}
        out["attempted"] = n
    out["peak"] = peak(dev)
    kept = release(st)
    out["gaps"] = check(st, kept, cfg, traffic)
    out["failed"] = st["stops"]
    return out


def peak(dev) -> int:
    import torch
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def work(trees, table, params, bin_bytes: int = 1) -> dict:
    """Least seconds of the trees' layers (cost.py)."""
    F, N = table.codes.shape
    B = max(g.size for g in table.grids)
    out = {"hist_s": 0.0, "partition_s": 0.0, "objective_s": 0.0,
           "score_update_s": 0.0}
    pairs = objectives.load(params["objective"]).pairs(table)
    for t in trees:
        if t.leaf_count is None:
            continue
        w = cost.tree_work(t.left_child, t.right_child, t.leaf_count, F, B,
                           bin_bytes)
        out["hist_s"] += w["hist_s"]
        out["partition_s"] += w["partition_s"]
        out["objective_s"] += cost.objective_s(N, pairs)
        out["score_update_s"] += cost.score_update_s(N)
    return out
