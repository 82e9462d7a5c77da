"""Masked leaf-wise tree growth, in torch.

Counterpart of lightgbm_tpu/models/grower_unified.py::_grow_leafwise
(:384-606; shim models/grower.py), selected by ``grow_policy=leafwise
leafwise_compact=false``.  The split loop is the shared best-first loop
(models/grower_unified.grow_best_first).  DataPartition is the [N]
leaf-id vector alone: a split histograms its smaller child with one
histogram-kernel launch over all N rows, under ``row_mask & (leaf_ids ==
small_leaf)``, and derives the sibling from the [L, F, B, 3] cache.  No
row moves, so the partition kernel is not launched, and the host reads
back one record per split.

In the int8 modes the pass scale comes from the rows of that mask, the
same rows the compacted grower quantizes over its pane slice, and each
pass takes the same salt (the new leaf), so on one device both policies
grow the same trees bit for bit.
"""
from __future__ import annotations

from .. import telemetry
from ..ops.histogram import build_histogram
from .grower_unified import TreeArrays, grow_best_first


def grow_tree(bins, grad, hess, row_mask, feature_mask, num_bins, *,
              num_leaves: int, num_bins_max: int, min_data_in_leaf: int,
              min_sum_hessian_in_leaf: float, max_depth: int = -1,
              compute_dtype: str = "float32", packing=None,
              exponent=None) -> TreeArrays:
    """Grow one tree; the arguments are grow_tree_unified's."""

    def small_hist(bl, new, feat, thr, left_small, leaf_ids):
        small_leaf = bl if left_small else new
        with telemetry.span("histogram") as sp:
            return sp.fence(build_histogram(
                bins, grad, hess, row_mask & (leaf_ids == small_leaf),
                num_bins_max, compute_dtype, packing, new, exponent))

    return grow_best_first(
        bins, grad, hess, row_mask, feature_mask, num_bins, small_hist,
        num_leaves=num_leaves, num_bins_max=num_bins_max,
        min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
        max_depth=max_depth, compute_dtype=compute_dtype, packing=packing,
        exponent=exponent)


__all__ = ["grow_tree"]
