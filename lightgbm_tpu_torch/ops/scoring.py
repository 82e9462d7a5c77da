"""Tree application in torch: score updates from a grown tree, and the
serving engine's walks.

``add_tree_score`` is the counterpart of lightgbm_tpu/ops/scoring.py:341
(Tree::AddPredictionToScore on a binned matrix): replay the tree's splits
in creation order to assign every row its leaf, then add that leaf's
value.  The training score needs no replay — the grower returns each
row's leaf id — and is a plain gather (``train_score_update``).

The serving walks (lightgbm_tpu/ops/scoring.py:89-232) run over the
integer rank codes of ``serving.FlatEnsemble.encode`` ([F, N] int32) and
the ensemble's stacked node tables ([T, max_nodes] int32):

- ``bfs_leaf_state`` walks all trees breadth-first in lockstep: the
  [T, N] frontier holds node ids in the tree encoding (>= 0 internal,
  ``~leaf`` once a row has reached a leaf), and each of ``max_depth``
  steps gathers every (tree, row) pair's next node;
- ``accumulate_tree_scores`` sums the per-tree values into their class
  rows one tree after another, in tree order — the f32 add sequence of
  the JAX package's scorers, so the scores are bitwise theirs.  A
  ``cumsum``, ``sum(dim=0)`` or ``index_add_`` over trees would regroup
  the sum;
- ``bfs_scores_sharded`` and ``bfs_leaf_indices_sharded`` walk contiguous
  tree blocks, each on its own device (see the sharding comment below);
- ``ensemble_scores`` and ``ensemble_leaf_indices`` are the per-tree
  replay (``predict_algo=scan``, lightgbm_tpu/ops/scoring.py:89-135):
  each tree's splits replayed in creation order by ``leaf_ids_by_replay``.

The JAX package's byte-split one-hot lookups (ops/lookup.py) work around
slow TPU gathers; their CPU route is the plain gather used here, for
f32 and int8 leaf tables alike.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import telemetry
from .bins import widen


def split_leaf_sequence(left_child: np.ndarray,
                        right_child: np.ndarray) -> np.ndarray:
    """Leaf id split by each node, in creation order: node k split leaf
    split_leaf[k] into (that leaf, k+1); a left edge keeps its parent's
    leaf id, a right edge carries parent+1 (models/tree.py)."""
    n = len(left_child)
    parent = np.full(n, -1, np.int64)
    is_left = np.zeros(n, bool)
    for k in range(n):
        if left_child[k] >= 0:
            parent[left_child[k]], is_left[left_child[k]] = k, True
        if right_child[k] >= 0:
            parent[right_child[k]] = k
    out = np.zeros(n, np.int64)
    for k in range(1, n):
        p = parent[k]
        out[k] = out[p] if is_left[k] else p + 1
    return out


def leaf_ids_by_replay(bins, split_feature, threshold_bin, left_child,
                       right_child) -> torch.Tensor:
    """[N] int64 leaf of every row of a binned [F, N] matrix (uint8, or
    int16 carrying 16-bit bins, or int32 rank codes)."""
    leaf = torch.zeros(bins.shape[1], dtype=torch.int64, device=bins.device)
    split_leaf = split_leaf_sequence(np.asarray(left_child),
                                     np.asarray(right_child))
    for k in range(len(split_leaf)):
        go_right = widen(bins[int(split_feature[k])]) > int(threshold_bin[k])
        leaf = torch.where((leaf == int(split_leaf[k])) & go_right, k + 1,
                           leaf)
    return leaf


def add_tree_score(bins, score, split_feature, threshold_bin, left_child,
                   right_child, leaf_value) -> torch.Tensor:
    """score + tree(bins): ``leaf_value`` [L] f32 tensor (already shrunk);
    the split arrays are host arrays of length L-1."""
    leaf = leaf_ids_by_replay(bins, split_feature, threshold_bin,
                              left_child, right_child)
    return score + leaf_value[leaf]


def train_score_update(score, leaf_value, leaf_ids) -> torch.Tensor:
    """score + leaf_value[leaf_ids] — the training rows' leaves come from
    the grower, so the update is one gather."""
    return score + leaf_value[leaf_ids.long()]


# ------------------------------------------------------------ serving walks


def bfs_leaf_state(codes, split_feature, threshold_rank, left_child,
                   right_child, root_state, max_depth: int) -> torch.Tensor:
    """[T, N] int32 leaf ids by the lockstep breadth-first walk
    (lightgbm_tpu/ops/scoring.py:155-178).  ``codes`` [F, N] int32; the
    node tables [T, max_nodes] int32 and ``root_state`` [T] int32 (0, or
    ~0 for a stump) on the same device.  Every row has reached a leaf
    after ``max_depth`` steps."""
    T, N = split_feature.shape[0], codes.shape[1]
    state = root_state[:, None].expand(T, N).contiguous()
    for _ in range(max_depth):
        node = state.clamp(min=0).long()
        sf = torch.gather(split_feature, 1, node)
        tr = torch.gather(threshold_rank, 1, node)
        lc = torch.gather(left_child, 1, node)
        rc = torch.gather(right_child, 1, node)
        code = torch.gather(codes, 0, sf.long())
        nxt = torch.where(code > tr, rc, lc)
        state = torch.where(state >= 0, nxt, state)
    return ~state


def accumulate_tree_scores(vals, tree_class, num_class: int,
                           total=None) -> torch.Tensor:
    """[num_class, N] f32: tree t's values ``vals[t]`` added to row
    ``tree_class[t]`` (a host array), one tree after another in tree
    order (lightgbm_tpu/ops/scoring.py:181-192), onto ``total`` (the
    running sums of the trees before these, updated in place) or onto
    zeros."""
    if total is None:
        total = torch.zeros((num_class, vals.shape[1]), dtype=torch.float32,
                            device=vals.device)
    for t in range(vals.shape[0]):
        total[int(tree_class[t])].add_(vals[t])
    return total


def bfs_scores(codes, split_feature, threshold_rank, left_child, right_child,
               leaf_value, root_state, tree_class, *, max_depth: int,
               num_class: int, total=None) -> torch.Tensor:
    """[num_class, N] f32 ensemble sums, breadth-first, over the [T, L]
    f32 leaf table (lightgbm_tpu/ops/scoring.py:195-208), onto
    ``total`` as ``accumulate_tree_scores`` adds."""
    leaf = bfs_leaf_state(codes, split_feature, threshold_rank, left_child,
                          right_child, root_state, max_depth)
    vals = torch.gather(leaf_value, 1, leaf.long())
    return accumulate_tree_scores(vals, tree_class, num_class, total)


def bfs_scores_int8(codes, split_feature, threshold_rank, left_child,
                    right_child, leaf_q, leaf_scale, root_state, tree_class,
                    *, max_depth: int, num_class: int,
                    total=None) -> torch.Tensor:
    """The int8 ensemble (lightgbm_tpu/ops/scoring.py:211-225): each leaf
    reads back as ``float(q) * scale[t]``, ``leaf_q`` [T, L] int8 and
    ``leaf_scale`` [T] f32; the read is exact, and the sums are the f32
    path's."""
    leaf = bfs_leaf_state(codes, split_feature, threshold_rank, left_child,
                          right_child, root_state, max_depth)
    qvals = torch.gather(leaf_q.float(), 1, leaf.long())
    vals = qvals * leaf_scale[:, None]
    return accumulate_tree_scores(vals, tree_class, num_class, total)


def bfs_leaf_indices(codes, split_feature, threshold_rank, left_child,
                     right_child, root_state, *,
                     max_depth: int) -> torch.Tensor:
    """[T, N] int32 leaf index per tree, breadth-first (PredictLeafIndex;
    lightgbm_tpu/ops/scoring.py:228-231)."""
    return bfs_leaf_state(codes, split_feature, threshold_rank, left_child,
                          right_child, root_state, max_depth)


# ------------------------------------------------------- tree-axis sharding
#
# The JAX package's tree-sharded engine (lightgbm_tpu/ops/scoring.py:
# 235-330) walks a contiguous tree block on each device of a 1-D ("tree",)
# mesh and carries the [C, N] partial sums from shard to shard: the
# single-device sum is a left fold over the trees in tree order, and f32
# addition is not associative, so summing per-shard partials would
# regroup it.  Here a shard is a tree block whose tables live on one
# torch device of this process.  Shard s folds its trees' values onto the
# running total of shards 0..s-1, and the total then moves to shard
# s+1's device (an exact copy): the single-device add sequence, so the
# scores are bitwise the one-device engine's.  Each hop is filed as the
# JAX site ``serve/tree_carry``; the host reads the last shard's total,
# so the JAX package's broadcast ``serve/tree_psum`` has no counterpart
# in one process.


def _on(codes, device, placed: dict):
    """``codes`` on ``device``, copied once a call per device."""
    c = placed.get(device)
    if c is None:
        c = placed[device] = codes.to(device)
    return c


def bfs_scores_sharded(codes, shards, tree_classes, *, max_depth: int,
                       num_class: int) -> torch.Tensor:
    """[num_class, N] f32 ensemble sums over tree blocks, in shard order:
    ``shards[s]`` holds block s's node tables on its device (``sf``,
    ``tr``, ``lc``, ``rc``, ``root``, and ``lv``, or ``lv_q`` and
    ``lv_scale``), ``tree_classes[s]`` its host slice of the class map.
    A block of no trees adds nothing to the total.  Returns the
    total on the last shard's device; each of the ``len(shards) - 1``
    hops files ``serve/tree_carry`` with C·N·4 bytes and its host
    seconds (the enqueue of the copy)."""
    placed: dict = {}
    total = None
    for s, (t, tc) in enumerate(zip(shards, tree_classes)):
        device = t["sf"].device
        if s:
            t0 = time.perf_counter()
            total = total.to(device)
            telemetry.record_collective(
                "serve/tree_carry", "ppermute", "tree",
                total.numel() * total.element_size(),
                time.perf_counter() - t0, phase="predict")
        c = _on(codes, device, placed)
        if "lv_q" in t:
            total = bfs_scores_int8(
                c, t["sf"], t["tr"], t["lc"], t["rc"], t["lv_q"],
                t["lv_scale"], t["root"], tc, max_depth=max_depth,
                num_class=num_class, total=total)
        else:
            total = bfs_scores(
                c, t["sf"], t["tr"], t["lc"], t["rc"], t["lv"], t["root"],
                tc, max_depth=max_depth, num_class=num_class, total=total)
    return total


def bfs_leaf_indices_sharded(codes, shards, *,
                             max_depth: int) -> torch.Tensor:
    """[T, N] int32 leaf indices: each block's [T_s, N] walk on its
    device, joined along the tree axis on the first shard's device (no
    exchange between the blocks)."""
    placed: dict = {}
    first = shards[0]["sf"].device
    return torch.cat([
        bfs_leaf_indices(_on(codes, t["sf"].device, placed), t["sf"],
                         t["tr"], t["lc"], t["rc"], t["root"],
                         max_depth=max_depth).to(first)
        for t in shards])


# ------------------------------------------------------ the per-tree replay


def ensemble_leaf_indices(codes, split_feature, threshold_rank, left_child,
                          right_child, num_leaves) -> torch.Tensor:
    """[T, N] int64 leaf index per tree by the per-tree replay
    (lightgbm_tpu/ops/scoring.py:120-135): tree t's ``num_leaves[t] - 1``
    splits replayed in creation order.  The node tables are the
    FlatEnsemble's host arrays; ``codes`` [F, N] int32 on the device."""
    out = torch.zeros((len(num_leaves), codes.shape[1]), dtype=torch.int64,
                      device=codes.device)
    for t in range(len(num_leaves)):
        n = int(num_leaves[t]) - 1
        out[t] = leaf_ids_by_replay(
            codes, split_feature[t, :n], threshold_rank[t, :n],
            left_child[t, :n], right_child[t, :n])
    return out


def ensemble_scores(codes, split_feature, threshold_rank, left_child,
                    right_child, leaf_value, num_leaves, tree_class, *,
                    num_class: int) -> torch.Tensor:
    """[num_class, N] f32 ensemble sums by the per-tree replay
    (lightgbm_tpu/ops/scoring.py:89-117): tree by tree, its leaves by
    ``leaf_ids_by_replay``, its values from ``leaf_value`` [T, L] (a
    device tensor) added into its class row in tree order — the add
    sequence of the breadth-first walk, so the scores are bitwise its."""
    leaf = ensemble_leaf_indices(codes, split_feature, threshold_rank,
                                 left_child, right_child, num_leaves)
    return accumulate_tree_scores(torch.gather(leaf_value, 1, leaf),
                                  tree_class, num_class)
