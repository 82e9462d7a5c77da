"""Compacted leaf-wise tree growth, in torch.

Counterpart of lightgbm_tpu/models/grower_unified.py::_grow_leafcompact
(:931-1279) under the serial schedule.  The split loop is the shared
best-first loop (models/grower_unified.grow_best_first); what this
policy adds is where a split's rows live.  Every leaf's rows stay
contiguous in a plane pane (ops/compact.py), so a split

1. stably partitions the parent's lane range — the partition kernel,
   which decides each lane from the pane's own bin row;
2. histograms only the smaller child's lanes — the histogram kernel,
   which in the float mode reads the pane in place.

The pane is double-buffered: a split reads the parent's lanes from the
pane that holds them and writes them, partitioned, to the same lanes of
the other pane, where both children then live.  Live leaves own disjoint
lane ranges, so neither pane's other lanes are ever read stale, and no
partitioned segment is copied back.  The partition's left count is read
by the host once the kernel is queued: with the split record, two small
synchronisations per split.

With 16-bit bins (max_bin > 256) the pane carries each bin as two byte
rows, and the partition keys on both (ops/compact.py): the JAX package's
compacted grower keys on the low byte alone there (ROADMAP C3), so its
masked grower is this policy's oracle at B > 256.

Under mixed-bin packing the pane's bin rows are in storage order: the
partition reads the split feature's storage row, and the float
histogram launches the pane entry once per bin-width class on that
class's rows.  Under bfloat16 the pane carries grad and hess already
rounded to bf16, since the histogram is the only reader of its values.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import telemetry
from ..ops.bins import bin_bytes
from ..ops.compact import BLOCK, pack_planes, partition_pane, unpack_values
from ..ops.hist_cuda import hist_pane_float
from ..ops.histogram import (assemble, build_histogram, class_ranges,
                             gather_features, is_int8, round_bf16)
from .grower_unified import SERIAL, TreeArrays, grow_best_first


class _Pane:
    """The double-buffered plane pane and each leaf's lane range."""

    def __init__(self, bins, grad, hess, row_mask, num_leaves: int,
                 num_bins_max: int, compute_dtype: str, packing, exponent,
                 schedule=SERIAL):
        F, N = bins.shape
        P = -(-N // BLOCK) * BLOCK          # pane width: the root bucket
        if compute_dtype == "bfloat16":
            grad, hess = round_bf16(grad), round_bf16(hess)
        pane = pack_planes(bins, grad, hess, row_mask, P)
        self.panes = (pane, torch.empty_like(pane))
        self.F, self.B, self.compute_dtype = F, num_bins_max, compute_dtype
        self.nb = bin_bytes(bins)                    # 2: a 16-bit pane
        self.packing = packing
        self.exponent = exponent                     # the tree's, float
        self.schedule = schedule
        self.seg_start = np.zeros(num_leaves, np.int64)
        self.seg_cnt = np.zeros(num_leaves, np.int64)
        self.seg_cnt[0] = N
        self.side = np.zeros(num_leaves, np.int64)   # pane holding a leaf

    def small_hist(self, bl, new, feat, thr, left_small, leaf_ids):
        """Partition the parent's lanes into the other pane on storage
        row ``feat``, then the smaller child's histogram from its lanes
        there, salted with the new leaf."""
        F = self.F
        start, cnt = int(self.seg_start[bl]), int(self.seg_cnt[bl])
        src, dst = self.panes[self.side[bl]], self.panes[1 - self.side[bl]]
        with telemetry.span("partition"):
            plcnt = int(telemetry.host_read(partition_pane(
                src, dst, F, feat, thr, start, cnt, self.nb)))
        sstart = start if left_small else start + plcnt
        scnt = plcnt if left_small else cnt - plcnt
        self.seg_start[new] = start + plcnt
        self.seg_cnt[bl], self.seg_cnt[new] = plcnt, cnt - plcnt
        self.side[bl] = self.side[new] = 1 - self.side[bl]
        with telemetry.span("histogram") as sp:
            if is_int8(self.compute_dtype):
                # quantization needs the pass maximum first: unpack, then
                # the int8 route
                return sp.fence(build_histogram(
                    *unpack_values(dst[:, sstart:sstart + scnt], F,
                                   self.nb),
                    self.B, self.compute_dtype, self.packing, new,
                    **self.schedule.hist_seams()))
            return sp.fence(gather_features(assemble(
                [hist_pane_float(dst, F, sstart, scnt, w, (s, n), self.nb,
                                 self.exponent)
                 for s, n, w in class_ranges(self.packing, F, self.B)],
                self.packing, self.B), self.schedule.hist_feat_gather))


def grow_tree_leafcompact(bins, grad, hess, row_mask, feature_mask,
                          num_bins, *, num_leaves: int, num_bins_max: int,
                          min_data_in_leaf: int,
                          min_sum_hessian_in_leaf: float,
                          max_depth: int = -1,
                          compute_dtype: str = "float32",
                          packing=None, exponent=None, schedule=SERIAL,
                          partition_bins=None,
                          partition_packing=None) -> TreeArrays:
    """Grow one tree; the arguments are grow_tree_unified's.  In a
    data-parallel, hybrid or voting world the pane holds this rank's rows
    and every feature, each split partitions them, and the smaller child
    is the one the agreed split record's global counts name, the same on
    every rank.  A block-local packed pane (io/binning.BlockedPackSpec)
    takes one histogram launch per ``ranges`` segment, 2 per ownership
    block."""
    if ((partition_bins is not None and partition_bins is not bins)
            or (partition_packing is not None
                and partition_packing is not packing)):
        raise ValueError("the compacted grower needs every feature's bins "
                         "(no feature-parallel ownership)")
    pane = _Pane(bins, grad, hess, row_mask, num_leaves, num_bins_max,
                 compute_dtype, packing, exponent, schedule)
    return grow_best_first(
        bins, grad, hess, row_mask, feature_mask, num_bins, pane.small_hist,
        num_leaves=num_leaves, num_bins_max=num_bins_max,
        min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
        max_depth=max_depth, compute_dtype=compute_dtype, packing=packing,
        exponent=exponent, schedule=schedule)


__all__ = ["grow_tree_leafcompact"]
