"""Compacted leaf-wise tree growth, in torch.

Counterpart of lightgbm_tpu/models/grower_unified.py::_grow_leafcompact
(:931-1279) under the serial schedule, and of its ``TreeArrays`` (:77-88).
The split order is the reference's strict best-first growth
(serial_tree_learner.cpp:119-153): each of ``num_leaves - 1`` splits takes
the leaf with the largest candidate gain.  Every leaf's rows stay
contiguous in one plane pane (ops/compact.py), so a split

1. stably partitions the parent's lane range in place, sliced at its
   bucketed width (``bucket_table``) — the partition kernel;
2. histograms only the smaller child's lanes — the histogram kernel;
3. derives the sibling's histogram by subtraction from the parent's;
4. searches both children's best splits in one batched call.

The root histogram runs over the original arrays, exactly as in the JAX
package, and row leaf ids are kept in original row order.

The JAX version is one ``fori_loop`` with every decision on the device.
Here the loop is eager Python, and the host reads back each split's
candidate record (and the left count of the partition) — two small
synchronisations per split.  The tree arrays and candidate table live on
the host as numpy f32/int32, with the same values as the device scalars
they come from, so the best-first choice (``np.argmax``, first maximum)
is the JAX package's ``jnp.argmax``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.compact import (BLOCK, bucket_table, pack_planes, pane_rows,
                           partition_segment, unpack_values)
from ..ops.histogram import build_histogram
from ..ops.split import find_best_split


class TreeArrays(NamedTuple):
    """One grown tree (tree.h:124-149); host arrays, device leaf ids."""
    num_leaves: int
    split_feature: np.ndarray    # [L-1] int32
    threshold_bin: np.ndarray    # [L-1] int32
    split_gain: np.ndarray       # [L-1] f32
    left_child: np.ndarray       # [L-1] int32 (~leaf encoding)
    right_child: np.ndarray      # [L-1] int32
    leaf_parent: np.ndarray      # [L] int32
    leaf_value: np.ndarray       # [L] f32
    leaf_count: np.ndarray       # [L] int32
    leaf_ids: torch.Tensor       # [N] int32 on the device: row -> leaf


_F, _T, _LO, _RO, _LC, _RC, _LG, _LH, _RG, _RH = range(1, 11)


def grow_tree_leafcompact(bins, grad, hess, row_mask, feature_mask,
                          num_bins, *, num_leaves: int, num_bins_max: int,
                          min_data_in_leaf: int,
                          min_sum_hessian_in_leaf: float,
                          max_depth: int = -1,
                          compute_dtype: str = "float32") -> TreeArrays:
    """Grow one tree.  bins [F, N] uint8, grad/hess [N] f32, row_mask [N]
    bool, feature_mask [F] bool, num_bins [F] int — tensors on one device.
    ``compute_dtype``: "float32" or "int8" histograms."""
    F, N = bins.shape
    dev = bins.device
    L, B = num_leaves, num_bins_max
    f32 = torch.float32
    table = bucket_table(N, min_width=max(BLOCK,
                                          (-(-N // BLOCK) * BLOCK) >> 9))
    P = table[0]

    def bucket_of(x: int) -> int:
        return sum(1 for w in table if w >= max(x, 1)) - 1

    def hist_of(hbins, hg, hh, hmask):
        return build_histogram(hbins, hg, hh, hmask, B, compute_dtype)

    def search(hist, g, h, c):
        """Best splits of a [k, F, B, 3] stack -> host [k, 11] f32."""
        totals = torch.tensor(np.stack([g, h, c], 0), dtype=f32, device=dev)
        res = find_best_split(hist, totals[0], totals[1], totals[2],
                              num_bins, feature_mask,
                              float(min_data_in_leaf),
                              float(min_sum_hessian_in_leaf))
        return res.packed().cpu().numpy()

    def gated(gain: np.float32, depth: int) -> np.float32:
        # depth-limited leaves cannot split (serial_tree_learner.cpp:240-249)
        if max_depth > 0 and depth >= max_depth:
            return np.float32(-np.inf)
        return gain

    # ---- root: full pass over the original arrays
    root_hist = hist_of(bins, grad, hess, row_mask)
    if compute_dtype == "int8":
        # int8: totals from the histogram (its cells are exact multiples
        # of the pass scale), as _root_stats_of does (grower_unified.py:221)
        root = root_hist[0].to(torch.float64).sum(0).to(f32)
    else:
        m = row_mask.to(torch.float64)
        root = torch.stack([(grad.to(torch.float64) * m).sum(),
                            (hess.to(torch.float64) * m).sum(),
                            m.sum()]).to(f32)
    root_g, root_h, root_c = root.cpu().numpy()
    best = search(root_hist[None], [root_g], [root_h], [root_c])[0]

    # ---- host state (grower_unified.py:908-928, 1036-1074)
    split_feature = np.zeros(L - 1, np.int32)
    threshold_bin = np.zeros(L - 1, np.int32)
    split_gain = np.zeros(L - 1, np.float32)
    left_child = np.zeros(L - 1, np.int32)
    right_child = np.zeros(L - 1, np.int32)
    leaf_parent = np.full(L, -1, np.int32)
    leaf_value = np.zeros(L, np.float32)
    leaf_count = np.zeros(L, np.int32)
    leaf_count[0] = np.int32(root_c)
    seg_start = np.zeros(L, np.int64)
    seg_cnt = np.zeros(L, np.int64)
    seg_cnt[0] = N
    leaf_depth = np.zeros(L, np.int32)
    leaf_depth[0] = 1
    cand = np.zeros((L, 11), np.float32)
    cand[:, 0] = -np.inf
    cand[0] = best
    cand[0, 0] = gated(best[0], 1)

    hist_cache = torch.empty((L,) + tuple(root_hist.shape), dtype=f32,
                             device=dev)
    hist_cache[0] = root_hist
    pane = pack_planes(bins, grad, hess, row_mask, P)
    leaf_ids = torch.zeros(N, dtype=torch.int32, device=dev)
    lane_w = {}
    nl = 1

    for _ in range(L - 1):
        bl = int(np.argmax(cand[:, 0]))
        best_gain = cand[bl, 0]
        if not best_gain > 0.0:
            break
        node, new = nl - 1, nl
        feat, thr = int(cand[bl, _F]), int(cand[bl, _T])

        # --- record the node (Tree::Split, tree.cpp:50-83)
        p = leaf_parent[bl]
        if p >= 0:
            if left_child[p] == ~bl:
                left_child[p] = node
            if right_child[p] == ~bl:
                right_child[p] = node
        left_child[node] = ~bl
        right_child[node] = ~new

        # --- original-order leaf ids
        leaf_ids = torch.where((leaf_ids == bl) & (bins[feat] > thr),
                               new, leaf_ids).to(torch.int32)

        # --- partition the parent's lanes at its bucket width
        start, cnt = int(seg_start[bl]), int(seg_cnt[bl])
        W = table[bucket_of(cnt)]
        cs = min(start, P - W)            # clamp the slice into the pane
        delta = start - cs
        seg = pane[:, cs:cs + W]
        if W not in lane_w:
            lane_w[W] = torch.arange(W, device=dev)
        lane = lane_w[W]
        inseg = (lane >= delta) & (lane < delta + cnt)
        go_right = seg[feat].view(torch.uint8) > thr
        mask3 = torch.where(inseg, torch.where(go_right, 0, 1),
                            -1).to(torch.int8)
        plcnt = int((inseg & ~go_right).sum())
        new_seg = partition_segment(seg, mask3, delta, cnt, plcnt)
        pane[:, start:start + cnt] = new_seg[:, delta:delta + cnt]
        prcnt = cnt - plcnt

        # --- smaller child's histogram; the sibling by subtraction.  The
        # directly built side is the smaller by valid count, as in the
        # JAX package (same direct/subtracted f32 rounding)
        lcnt, rcnt = int(cand[bl, _LC]), int(cand[bl, _RC])
        left_small = lcnt <= rcnt
        sstart = start if left_small else start + plcnt
        scnt = plcnt if left_small else prcnt
        hbins, hg, hh, hvalid = unpack_values(pane[:, sstart:sstart + scnt],
                                              F)
        small = hist_of(hbins, hg, hh, hvalid)
        large = hist_cache[bl] - small
        lhist, rhist = (small, large) if left_small else (large, small)
        depth = int(leaf_depth[bl]) + 1
        pair = search(torch.stack([lhist, rhist]),
                      cand[bl, [_LG, _RG]], cand[bl, [_LH, _RH]],
                      np.array([lcnt, rcnt], np.float32))
        hist_cache[bl] = lhist
        hist_cache[new] = rhist

        # --- tree and candidate bookkeeping
        split_feature[node] = feat
        threshold_bin[node] = thr
        split_gain[node] = best_gain
        leaf_parent[bl] = leaf_parent[new] = node
        leaf_value[bl] = cand[bl, _LO]
        leaf_value[new] = cand[bl, _RO]
        leaf_count[bl], leaf_count[new] = lcnt, rcnt
        seg_start[new] = start + plcnt
        seg_cnt[bl], seg_cnt[new] = plcnt, prcnt
        leaf_depth[bl] = leaf_depth[new] = depth
        cand[bl], cand[new] = pair[0], pair[1]
        cand[bl, 0] = gated(pair[0, 0], depth)
        cand[new, 0] = gated(pair[1, 0], depth)
        nl += 1

    return TreeArrays(nl, split_feature, threshold_bin, split_gain,
                      left_child, right_child, leaf_parent, leaf_value,
                      leaf_count, leaf_ids)


__all__ = ["TreeArrays", "grow_tree_leafcompact", "pane_rows"]
