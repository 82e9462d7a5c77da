"""What the three growth policies share, and the policy dispatch.

Counterpart of lightgbm_tpu/models/grower_unified.py under the serial
schedule: ``TreeArrays`` (:77-88), the root-stats rule ``_root_stats_of``
(:203-231), the storage-row map ``partition_feature`` (:181-188), depth
gating ``_depth_gated`` (:260-265) and ``grow_tree_unified``
(:277-358).  The policies:

- ``leafcompact`` — best-first growth over a plane pane
  (models/grower_leafcompact.py), the default on the card;
- ``leafwise`` — the masked best-first grower (models/grower.py), which
  histograms the smaller child over all N rows under a leaf-id mask;
- ``depthwise`` — level-batched growth (models/grower_depthwise.py).

The two best-first policies differ only in how a split's smaller child
gets its histogram, so they share one split loop here
(``grow_best_first``), as in the JAX package they share the same split
body (:479-594 and :1036-1279).  The loop is eager Python: the host
reads back each split's candidate record once (under the ``split_find``
telemetry span; the histograms run under ``histogram`` and the
compacted grower's row moves under ``partition``), and keeps the tree
arrays and the candidate table as numpy f32/int32 with the same values
as the device scalars they come from, so the best-first choice
(``np.argmax``, first maximum) is the JAX package's ``jnp.argmax``.
Row leaf ids stay on the device, in original row order.

The parallel learners (parallel/learners.py) customize growth through a
``SeamSchedule`` (JAX :91-122), whose fields are the world's
collectives; the default, every field None, is the serial schedule:

- ``hist_reduce`` / ``int_hist_reduce``: a best-first split's smaller
  child, the f32 histogram (float modes) or the int32 accumulator
  (int8, before dequantization) -> the world's sum, whole (``psum``) or
  this rank's feature block of it (``reduce_scatter``);
  ``scale_reduce`` takes the int8 passes' maxima to the world's;
- ``root_hist_reduce``: the root's histogram or accumulator, whole;
  ``stat_reduce``: the float modes' f64 root partial sums [3];
- ``own_slice``: a whole histogram -> this rank's feature block
  (``dim`` is the feature axis); the cache then holds blocks;
- ``split_finder``: replaces ``ops/split.find_best_split``, returning
  the world's agreed split with global feature indices;
- ``hist_reduce_level`` / ``int_reduce_level``: the depth-wise level
  passes' reductions;
- ``int_root_stats``: the int8 root stats from a histogram of owned
  features only (feature-parallel, the masked and depth-wise hybrid and
  voting learners): the serial run's, which read feature 0
  (``root_stats_of``);
- ``root_split_finder``: the root's search, where it differs from
  ``split_finder`` (the voting learner files its root exchange at its
  own sites, JAX :100-107);
- ``hist_local``: the float caches and the sibling subtraction stay
  this rank's own (voting: the finder exchanges the voted features'
  histograms), so int8 root stats taken from a local histogram would be
  ``stat_reduce``d (JAX :108-110, :200-226);
- ``hist_feat_gather``: [F] int64 handed to every histogram build
  (ops/histogram.gather_features): a block-local packed owned block's
  storage rows back in canonical order, in the int domain before any
  reduction (JAX :111-122).

Every rank makes the same collectives in the same order: a histogram
over no local rows (a launch skipped) is still reduced, and the loop's
stops read the agreed candidate gains, which are equal on every rank.

Under mixed-bin packing (``packing``, io/binning.PackSpec) ``bins``
holds its features in bin-width-class order; histograms come back in
canonical order and split records stay canonical, and only the reads of
a split feature's bin row go through ``partition_feature``.  Histogram
passes are salted for ``int8_sr``: the root 0, a best-first split its
new leaf's index, a depth-wise level pass its level + 1.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import telemetry
from ..ops.bins import widen
from ..ops.hist_cuda import fixed_exponent
from ..ops.histogram import build_histogram, is_int8
from ..ops.split import find_best_split

GROW_POLICIES = ("leafwise", "depthwise", "leafcompact")


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


class SeamSchedule(NamedTuple):
    """The world's collectives at each seam of growth (module
    docstring); a field left None does nothing."""
    hist_reduce: Optional[Callable] = None
    int_hist_reduce: Optional[Callable] = None
    scale_reduce: Optional[Callable] = None
    stat_reduce: Optional[Callable] = None
    root_hist_reduce: Optional[Callable] = None
    own_slice: Optional[Callable] = None
    split_finder: Optional[Callable] = None
    hist_reduce_level: Optional[Callable] = None
    int_reduce_level: Optional[Callable] = None
    int_root_stats: Optional[Callable] = None
    root_split_finder: Optional[Callable] = None
    hist_local: bool = False
    hist_feat_gather: Optional[torch.Tensor] = None

    def hist_seams(self, root: bool = False) -> dict:
        """``build_histogram``'s world seams for a split's smaller child,
        or with ``root`` for the root (reduced whole): the int8 modes'
        reductions and the owned block's feature gather."""
        return {"scale_reduce": self.scale_reduce,
                "int_reduce": (self.root_hist_reduce if root
                               else self.int_hist_reduce),
                "feat_gather": self.hist_feat_gather}

    def float_reduce(self, hist, compute_dtype: str, root: bool = False):
        """A float mode's f32 histogram -> the world's (int8 histograms
        were reduced in the int domain already)."""
        fn = self.root_hist_reduce if root else self.hist_reduce
        if fn is None or is_int8(compute_dtype):
            return hist
        return fn(hist)


SERIAL = SeamSchedule()


def root_stats_of(root_hist, compute_dtype: str, grad, hess, row_mask,
                  schedule: SeamSchedule = SERIAL):
    """[3] f32 device tensor (sum grad, sum hess, count) of the root.

    int8 (either rounding): from the histogram — its cells are exact
    multiples of the pass scale, and any feature's bins sum to the
    quantized totals (a world's histogram is the world's already; under
    ``hist_local`` a local one, whose sums ``stat_reduce`` adds).
    float32 and bfloat16: from the (unrounded) gradient vectors, as the
    reference computes root sums once (serial_tree_learner.cpp:178-198);
    a world all-reduces the f64 partial sums (``stat_reduce``).  Both
    sum in f64 and round once, so the card and the CPU agree."""
    if is_int8(compute_dtype):
        if schedule.int_root_stats is not None:
            return schedule.int_root_stats(root_hist)
        stats = root_hist[0].to(torch.float64).sum(0)
        if schedule.hist_local and schedule.stat_reduce is not None:
            stats = schedule.stat_reduce(stats)
        return stats.to(torch.float32)
    m = row_mask.to(torch.float64)
    stats = torch.stack([(grad.to(torch.float64) * m).sum(),
                         (hess.to(torch.float64) * m).sum(), m.sum()])
    if schedule.stat_reduce is not None:
        stats = schedule.stat_reduce(stats)
    return stats.to(torch.float32)


def partition_feature(packing, feat: int) -> int:
    """The storage row of canonical feature ``feat``: its packed position
    under mixed-bin packing (the global layout's, ``partition_packing``,
    where the histograms see an owned block's), else itself."""
    return feat if packing is None else packing.c2p[feat]


def depth_gated(gain: np.float32, depth: int, max_depth: int) -> np.float32:
    """Depth-limited leaves cannot split (serial_tree_learner.cpp:240-249)."""
    if max_depth > 0 and depth >= max_depth:
        return np.float32(-np.inf)
    return gain


# columns of a packed split record (ops/split.SplitResult.packed)
_F, _T, _LO, _RO, _LC, _RC, _LG, _LH, _RG, _RH = range(1, 11)

# smaller-child histogram of a best-first split, this rank's own rows
# (the world's in the int8 modes, reduced in the int domain):
# (parent leaf, new leaf, split feature's storage row, threshold,
#  left is smaller, row leaf ids after the split) -> [F, B, 3] f32
SmallHist = Callable[[int, int, int, int, bool, torch.Tensor], torch.Tensor]


def grow_best_first(bins, grad, hess, row_mask, feature_mask, num_bins,
                    small_hist: SmallHist, *, num_leaves: int,
                    num_bins_max: int, min_data_in_leaf: int,
                    min_sum_hessian_in_leaf: float, max_depth: int,
                    compute_dtype: str, packing=None, exponent=None,
                    schedule: SeamSchedule = SERIAL,
                    partition_bins=None,
                    partition_packing=None) -> TreeArrays:
    """The reference's strict best-first growth
    (serial_tree_learner.cpp:119-153): each of ``num_leaves - 1`` splits
    takes the leaf with the largest candidate gain, builds the smaller
    child's histogram with ``small_hist``, derives the sibling by
    subtraction from the parent's and searches both children in one
    batched call.  The root histogram runs over the original arrays
    (salt 0, the tree's fixed-point ``exponent``); ``small_hist`` salts
    its pass with the new leaf.  ``schedule``: the world's seams (module
    docstring); ``partition_bins``: the whole bin matrix when ``bins``
    holds only this rank's owned features (feature-parallel, the masked
    hybrid and voting learners), read to move rows on a split's global
    feature; ``partition_packing``: the layout of ``partition_bins``
    where ``packing`` is an owned block's (default ``packing``)."""
    F, N = bins.shape
    dev = bins.device
    L = num_leaves
    f32 = torch.float32
    s = schedule
    finder = s.split_finder or find_best_split
    if partition_bins is None:
        partition_bins = bins
    if partition_packing is None:
        partition_packing = packing

    def search(hist, g, h, c, root=False):
        """Best splits of a [k, F, B, 3] stack -> host [k, 11] f32."""
        with telemetry.span("split_find"):
            totals = torch.tensor(np.stack([g, h, c], 0), dtype=f32,
                                  device=dev)
            res = ((s.root_split_finder or finder) if root else finder)(
                hist, totals[0], totals[1], totals[2], num_bins,
                feature_mask, float(min_data_in_leaf),
                float(min_sum_hessian_in_leaf))
            return telemetry.host_read(res.packed()).numpy()

    with telemetry.span("histogram") as sp:
        full = s.float_reduce(build_histogram(
            bins, grad, hess, row_mask, num_bins_max, compute_dtype,
            packing, 0, exponent, **s.hist_seams(root=True)),
            compute_dtype, root=True)
        root_hist = sp.fence(full if s.own_slice is None
                             else s.own_slice(full, 0))
    root_g, root_h, root_c = telemetry.host_read(root_stats_of(
        full, compute_dtype, grad, hess, row_mask, s)).numpy()
    best = search(root_hist[None], [root_g], [root_h], [root_c],
                  root=True)[0]

    # ---- host state (grower_unified.py:439-475)
    split_feature = np.zeros(L - 1, np.int32)
    threshold_bin = np.zeros(L - 1, np.int32)
    split_gain = np.zeros(L - 1, np.float32)
    left_child = np.zeros(L - 1, np.int32)
    right_child = np.zeros(L - 1, np.int32)
    leaf_parent = np.full(L, -1, np.int32)
    leaf_value = np.zeros(L, np.float32)
    leaf_count = np.zeros(L, np.int32)
    leaf_count[0] = np.int32(root_c)
    leaf_depth = np.zeros(L, np.int32)
    leaf_depth[0] = 1
    cand = np.zeros((L, 11), np.float32)
    cand[:, 0] = -np.inf
    cand[0] = best
    cand[0, 0] = depth_gated(best[0], 1, max_depth)

    hist_cache = torch.empty((L,) + tuple(root_hist.shape), dtype=f32,
                             device=dev)
    hist_cache[0] = root_hist
    leaf_ids = torch.zeros(N, dtype=torch.int32, device=dev)
    nl = 1

    for _ in range(L - 1):
        bl = int(np.argmax(cand[:, 0]))
        best_gain = cand[bl, 0]
        if not best_gain > 0.0:
            break
        node, new = nl - 1, nl
        feat, thr = int(cand[bl, _F]), int(cand[bl, _T])
        pfeat = partition_feature(partition_packing, feat)

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
        leaf_ids = torch.where((leaf_ids == bl)
                               & (widen(partition_bins[pfeat]) > thr),
                               new, leaf_ids).to(torch.int32)

        # --- the smaller child's histogram (smaller by valid count, as in
        # the JAX package); the sibling by subtraction
        lcnt, rcnt = int(cand[bl, _LC]), int(cand[bl, _RC])
        left_small = lcnt <= rcnt
        small = small_hist(bl, new, pfeat, thr, left_small, leaf_ids)
        if s.hist_reduce is not None and not is_int8(compute_dtype):
            with telemetry.span("histogram"):
                small = s.hist_reduce(small)
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
        leaf_depth[bl] = leaf_depth[new] = depth
        cand[bl], cand[new] = pair[0], pair[1]
        cand[bl, 0] = depth_gated(pair[0, 0], depth, max_depth)
        cand[new, 0] = depth_gated(pair[1, 0], depth, max_depth)
        nl += 1

    return TreeArrays(nl, split_feature, threshold_bin, split_gain,
                      left_child, right_child, leaf_parent, leaf_value,
                      leaf_count, leaf_ids)


def grow_tree_unified(bins, grad, hess, row_mask, feature_mask, num_bins,
                      *, policy: str, num_leaves: int, num_bins_max: int,
                      min_data_in_leaf: int, min_sum_hessian_in_leaf: float,
                      max_depth: int = -1, compute_dtype: str = "float32",
                      packing=None, schedule: SeamSchedule = SERIAL,
                      partition_bins=None,
                      partition_packing=None) -> TreeArrays:
    """Grow one tree under ``policy`` (GROW_POLICIES).  bins [F, N] uint8,
    or int16 carrying 16-bit bins (ops/bins.py), in ``packing``'s storage
    order, if any; grad/hess [N] f32, row_mask
    [N] bool, feature_mask [F] bool, num_bins [F] int — tensors on one
    device.  ``compute_dtype``: "float32", "bfloat16", "int8" or
    "int8_sr" histograms.  The float modes' histograms share one
    fixed-point exponent over the tree's gradients
    (ops/hist_cuda.fixed_exponent; a world's ranks each their own).
    ``schedule``, ``partition_bins`` and ``partition_packing``: a
    parallel learner's (module docstring; ``grow_best_first``).  ``feature_mask`` and ``num_bins``
    are then this rank's owned features' where the schedule has an
    ``own_slice`` or ``bins`` holds only owned features."""
    if policy not in GROW_POLICIES:
        raise ValueError("unknown grow policy %r" % (policy,))
    exponent = None if is_int8(compute_dtype) else \
        fixed_exponent(grad, hess, bins.shape[1])
    kwargs = dict(num_leaves=num_leaves, num_bins_max=num_bins_max,
                  min_data_in_leaf=min_data_in_leaf,
                  min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
                  max_depth=max_depth, compute_dtype=compute_dtype,
                  packing=packing, exponent=exponent, schedule=schedule,
                  partition_bins=partition_bins,
                  partition_packing=partition_packing)
    args = (bins, grad, hess, row_mask, feature_mask, num_bins)
    if policy == "depthwise":
        from .grower_depthwise import grow_tree_depthwise
        return grow_tree_depthwise(*args, **kwargs)
    if policy == "leafcompact":
        from .grower_leafcompact import grow_tree_leafcompact
        return grow_tree_leafcompact(*args, **kwargs)
    from .grower import grow_tree
    return grow_tree(*args, **kwargs)


__all__ = ["GROW_POLICIES", "SERIAL", "SeamSchedule", "TreeArrays",
           "depth_gated", "grow_best_first", "grow_tree_unified",
           "partition_feature", "root_stats_of"]
