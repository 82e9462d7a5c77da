"""Depth-wise (level-batched) tree growth, in torch.

Counterpart of lightgbm_tpu/models/grower_unified.py::_grow_depthwise
(:621-903; shim models/grower_depthwise.py), selected by
``grow_policy=depthwise``.  Levels are unrolled with P = 2^d slots; slot
s of level d holds one candidate leaf and its children sit at 2s and
2s + 1.  Each level

1. searches the best split of all P slots in one batched call;
2. spends the ``num_leaves`` budget best-first within the level (a
   stable sort of the gains, so ties take the lower slot, as
   ``jnp.argsort`` does);
3. numbers the chosen slots in slot order: node k keeps its parent's
   leaf on the left and puts leaf k + 1 on the right;
4. moves every row to its child slot by gathers of its slot's split
   attributes and its own bin on the split feature;
5. histograms the smaller child of every chosen slot in one
   ``histogram_leafbatch`` pass with C = P columns (grouped at 64, as on
   the TPU, or at 42 with 16-bit bins, as the JAX package does there on
   every backend; salted d + 1 at level d, the root 0), and derives the
   siblings by subtraction.

Under mixed-bin packing step 4 reads each row's bin from the split
feature's storage row.

Under a parallel learner's ``schedule`` (models/grower_unified.
SeamSchedule) the root pass is reduced whole (``root_hist_reduce``; the
int8 accumulators before dequantization) and, with ``own_slice``, cut to
this rank's feature block; each level pass is reduced by
``hist_reduce_level`` (f32 ``[C, F, B, 3]``) or ``int_reduce_level``
(the int8 ``[F, B, 3C]`` accumulator, in the int domain), and the
level's search is the schedule's ``split_finder``.  The search's agreed
records are equal on every rank, so every rank takes the same slots and
stops at the same level; rows move on ``partition_bins``, every
feature's bins, when ``bins`` holds only owned features.

All of this runs on the device; the host reads one count per level, to
stop once no slot was chosen or the budget is spent (later levels could
change nothing), and reads the tree back once.  The partition kernel is
not used: rows never move in memory, only their slot ids change (the
``partition`` telemetry span times that slot update; ``histogram`` and
``split_find`` the level's passes and search).
"""
from __future__ import annotations

import math

import torch

from .. import telemetry
from ..ops.bins import widen
from ..ops.histogram import canonical_index, histogram_leafbatch, is_int8
from ..ops.split import find_best_split
from .grower_unified import SERIAL, TreeArrays, root_stats_of


def num_levels(num_leaves: int, max_depth: int = -1) -> int:
    """Number of split levels.  Matches the leaf-wise depth rule (a leaf
    at depth >= max_depth cannot split, root depth 1), so max_depth
    allows max_depth - 1 split levels."""
    d = max(1, math.ceil(math.log2(max(num_leaves, 2))))
    if max_depth > 0:
        d = min(d, max(max_depth - 1, 1))
    return d


def _interleave(a, b):
    """[P, ...] x 2 -> [2P, ...] with a at even and b at odd rows."""
    return torch.stack([a, b], dim=1).reshape(2 * a.shape[0], *a.shape[1:])


def grow_tree_depthwise(bins, grad, hess, row_mask, feature_mask, num_bins,
                        *, num_leaves: int, num_bins_max: int,
                        min_data_in_leaf: int,
                        min_sum_hessian_in_leaf: float, max_depth: int = -1,
                        compute_dtype: str = "float32",
                        packing=None, exponent=None, schedule=SERIAL,
                        partition_bins=None,
                        partition_packing=None) -> TreeArrays:
    """Grow one tree; the arguments are grow_tree_unified's."""
    F, N = bins.shape
    dev = bins.device
    L, B = num_leaves, num_bins_max
    M = L - 1                                   # node records
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
    s = schedule
    finder = s.split_finder or find_best_split
    if partition_bins is None:
        partition_bins = bins
    int8 = is_int8(compute_dtype)

    def level_hist(col_id, col_ok, C, salt):
        root = salt == 0
        with telemetry.span("histogram") as sp:
            red = s.root_hist_reduce if root else s.hist_reduce_level
            hist = histogram_leafbatch(
                bins, grad, hess, col_id, col_ok, C, B, compute_dtype,
                packing, salt, exponent, s.scale_reduce,
                s.root_hist_reduce if root else s.int_reduce_level,
                s.hist_feat_gather)
            if red is not None and not int8:
                hist = red(hist)
            return sp.fence(hist)

    # canonical split feature -> storage row of partition_bins
    if partition_packing is None:
        partition_packing = packing
    c2p = (None if partition_packing is None
           else canonical_index(partition_packing, dev))

    hists = level_hist(torch.zeros(N, dtype=i64, device=dev), row_mask, 1,
                       0)
    root = root_stats_of(hists[0], compute_dtype, grad, hess, row_mask, s)
    if s.own_slice is not None:
        # the root stats came from the whole histogram; from here on the
        # levels hold this rank's feature block
        hists = s.own_slice(hists, 1)

    # per-slot state of the current level
    alive = torch.ones(1, dtype=torch.bool, device=dev)
    leaf_of = torch.zeros(1, dtype=i64, device=dev)      # slot -> leaf
    parent_node = torch.full((1,), -1, dtype=i64, device=dev)
    slot_g, slot_h, slot_c = root[0:1], root[1:2], root[2:3]
    slot_id = torch.zeros(N, dtype=i64, device=dev)      # row -> slot
    out_leaf = torch.zeros(N, dtype=i32, device=dev)     # row -> leaf

    # tree records; the last entry of each takes the unchosen slots'
    # writes and is dropped
    split_feature = torch.zeros(M + 1, dtype=i32, device=dev)
    threshold_bin = torch.zeros(M + 1, dtype=i32, device=dev)
    split_gain = torch.zeros(M + 1, dtype=f32, device=dev)
    left_child = torch.zeros(M + 1, dtype=i32, device=dev)
    right_child = torch.zeros(M + 1, dtype=i32, device=dev)
    leaf_value = torch.zeros(L + 1, dtype=f32, device=dev)
    leaf_count = torch.zeros(L + 1, dtype=i32, device=dev)
    leaf_count[0] = root[2].to(i32)
    leaf_parent = torch.full((L + 1,), -1, dtype=i32, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=f32, device=dev)

    n_nodes = 0
    D = num_levels(L, max_depth)
    for d in range(D):
        P = 1 << d
        with telemetry.span("split_find") as sp:
            res = finder(hists, slot_g, slot_h, slot_c, num_bins,
                         feature_mask, float(min_data_in_leaf),
                         float(min_sum_hessian_in_leaf))
            sp.fence(res.gain)
        can = alive & (res.gain > 0.0) & torch.isfinite(res.gain)

        # ---- budget: the top-gain slots first
        order = torch.argsort(-torch.where(can, res.gain, neg_inf),
                              stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(P, device=dev)
        chosen = can & (rank < (L - 1) - n_nodes)

        # ---- numbering, in slot order
        csum = torch.cumsum(chosen.to(i64), 0)
        node_of = n_nodes + csum - 1
        right_leaf = node_of + 1
        bl = leaf_of
        nidx = torch.where(chosen, node_of, M)
        blx = torch.where(chosen, bl, L)
        rlx = torch.where(chosen, right_leaf, L)

        # ---- node records (Tree::Split, tree.cpp:50-83)
        split_feature[nidx] = res.feature.to(i32)
        threshold_bin[nidx] = res.threshold.to(i32)
        split_gain[nidx] = res.gain
        left_child[nidx] = (~bl).to(i32)
        right_child[nidx] = (~right_leaf).to(i32)
        if d > 0:
            # the parent's pointer to this slot's leaf becomes the node;
            # slot parity says which side (even = left)
            fix = chosen & (parent_node >= 0)
            is_left = (torch.arange(P, device=dev) % 2) == 0
            left_child[torch.where(fix & is_left, parent_node, M)] = \
                node_of.to(i32)
            right_child[torch.where(fix & ~is_left, parent_node, M)] = \
                node_of.to(i32)

        # ---- leaf records
        leaf_value[blx] = res.left_output
        leaf_value[rlx] = res.right_output
        leaf_count[blx] = res.left_count
        leaf_count[rlx] = res.right_count
        leaf_parent[blx] = node_of.to(i32)
        leaf_parent[rlx] = node_of.to(i32)

        # ---- rows to child slots: each row gathers its slot's split
        # attributes and its own bin on the split feature
        with telemetry.span("partition") as sp:
            small_is_right = res.right_count < res.left_count  # ties: left
            in_chosen = chosen[slot_id]
            row_feat = res.feature if c2p is None else c2p[res.feature]
            row_bin = widen(partition_bins.gather(
                0, row_feat[slot_id][None])[0])
            go_right = in_chosen & (row_bin > res.threshold[slot_id])
            out_leaf = torch.where(go_right, right_leaf[slot_id].to(i32),
                                   out_leaf)
            slot_id = sp.fence(2 * slot_id + go_right.to(i64))

        # the level's one host read
        n_chosen = int(csum[-1])
        n_nodes += n_chosen
        if d + 1 >= D or n_chosen == 0 or n_nodes >= L - 1:
            break

        # ---- next level: children of slot s at 2s and 2s + 1
        alive = _interleave(chosen, chosen)
        leaf_of = _interleave(bl, right_leaf)
        parent_node = _interleave(node_of, node_of)
        slot_g = _interleave(res.left_sum_grad, res.right_sum_grad)
        slot_h = _interleave(res.left_sum_hess, res.right_sum_hess)
        slot_c = _interleave(res.left_count.to(f32),
                             res.right_count.to(f32))

        # ---- the smaller child of every chosen slot in one pass, the
        # siblings by subtraction
        sel = (in_chosen & (go_right == small_is_right[slot_id // 2])
               & row_mask)
        small = level_hist(slot_id // 2, sel, P, d + 1)
        large = hists - small
        right = small_is_right[:, None, None, None]
        hists = _interleave(torch.where(right, large, small),
                            torch.where(right, small, large))

    # ---- read the tree back once
    ints = torch.cat([split_feature[:M], threshold_bin[:M], left_child[:M],
                      right_child[:M], leaf_parent[:L], leaf_count[:L]]
                     ).cpu().numpy()
    floats = torch.cat([split_gain[:M], leaf_value[:L]]).cpu().numpy()
    sf, tb, lc, rc = (ints[k * M:(k + 1) * M] for k in range(4))
    lp, cnt = ints[4 * M:4 * M + L], ints[4 * M + L:]
    return TreeArrays(n_nodes + 1, sf, tb, floats[:M], lc, rc, lp,
                      floats[M:], cnt, out_leaf)


__all__ = ["grow_tree_depthwise", "num_levels"]
