"""The parallel tree learners, over ``torch.distributed``.

Counterpart of lightgbm_tpu/parallel/learners.py for ``tree_learner=data``,
``feature``, ``hybrid`` and ``voting``.  The JAX package runs them as SPMD programs
under ``shard_map``; here each rank is a process holding its own tensors,
and the seams of growth (models/grower_unified.SeamSchedule) call the
collectives of parallel/mesh.Comm on them explicitly.  Every rank grows
every tree through the histogram kernel, and under the compacted grower
moves its own rows through the partition kernel.

- **data** (``DataParallelLearner``, data_parallel_tree_learner.cpp): rows
  sharded, one shard a rank.  Each rank histograms its own rows; the
  histograms are summed over the world, by one of two schedules
  (``dp_schedule``; ``auto`` is ``reduce_scatter`` in a world of more
  than one rank, else ``psum``, JAX :574-585):

  - ``psum``: the whole histogram all-reduced, the split search
    replicated;
  - ``reduce_scatter``: the reference's ownership schedule (:135-235):
    each histogram reduce-scattered by contiguous feature block
    (``_owned_block``), the search run on the owned block only, and the
    packed split records all-gathered and reduced by
    ``allreduce_best_split`` (SplitInfo::MaxReducer).

  The int8 modes reduce the pass maxima (MAX) before quantizing and the
  int32 accumulators (SUM) before dequantizing, so int8 trees are the
  serial run's bit for bit.  The float modes add each rank's f32
  histogram, rounded once per rank, so float32 trees match serial within
  the f32 budget (a near-tie may part).  All three growers.

- **feature** (``FeatureParallelLearner``, feature_parallel_tree_learner
  .cpp): rows replicated, features owned by bin-count balance
  (``balanced_ownership``).  Each rank histograms and searches its owned
  features over all rows, and ``allreduce_best_split`` picks the
  winner, so every tree is the serial run's bit for bit.  Masked
  leaf-wise (``leafwise_compact=auto`` resolves to it, JAX :1596-1603)
  and depth-wise.

- **hybrid** (``HybridLearner``, the JAX package's own design): a 2-D
  grid of ``ds`` x ``fs`` ranks (parallel/mesh.grid_for, ``num_machines
  = ds x fs``, ``feature_shards``): rows sharded over the data index,
  contiguous feature blocks (``_owned_block``) owned over the feature
  index.  Histograms cover local rows x the owned block; the histogram
  sum runs over the data group and carries the owned block only, so a
  split's wire bytes are O(F·B / fs); the split record is reduced over
  the feature group (``hybrid_ownership_seams``).  The masked and
  depth-wise growers histogram the owned block's bin rows alone; the
  compacted grower's pane keeps every feature (its partition reads
  them) and the seam cuts the owned block out before the sum.
- **voting** (``VotingLearner``, PV-tree; the reference names it and
  Fatals): on the same grid (``feature_shards`` 1 unless asked), each
  data shard scores its owned features on its local histograms
  (``ops/split.per_feature_best_scores``), votes its ``top_k``, the votes
  are all-gathered, and the histograms of at most 2·top_k voted features
  are summed over the data group; the float caches stay local
  (``hist_local``).  Exact when 2·top_k covers the owned block.  int8
  keeps its global int32 exchange and restricts only the search
  (``voting_seams``).  Both tie-breaks are stable sorts: equal gains
  vote the smaller feature, equal counts take the smaller id.

Under the block-local mixed-bin layout (io/binning.BlockedPackSpec,
``pack_layout``) the masked and depth-wise hybrid and voting growers
histogram their block in storage order and ``hist_feat_gather``
(``_block_feat_gather``) puts each pass back in canonical order in the
int domain; rows move through the whole layout's map.  Their int8 root
stats come from feature 0's owner over the feature group, as under
``feature`` (another feature's f32 cells round apart).

Also here: ``distributed_bin_finder`` (dataset.cpp:353-415),
``aggregate_telemetry``, ``row_shard`` (the rows a rank loads),
``grid_shape`` (a grid over the ranks there are, as on a restart on
fewer ranks) and the factory ``create_parallel_learner``.  Not ported: the fused chunk
programs and ``_segmented_grow`` (ROADMAP "Not to port").
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import telemetry
from ..io.binning import BinMapper
from ..models.grower_unified import SeamSchedule, grow_tree_unified
from ..ops.histogram import is_int8
from ..ops.split import (SplitResult, find_best_split,
                         per_feature_best_scores)
from ..utils import log
from . import mesh


def aggregate_telemetry() -> None:
    """Every rank's counters summed by name, and the memory peaks' max,
    installed on every rank under ``allhosts/`` (JAX :57-110).
    Collective: every rank calls it at the end of training, telemetry
    armed or not.  A world of one returns at once."""
    if mesh.get_num_machines() <= 1:
        return
    blobs = mesh.all_gather_object({"c": telemetry.counters(),
                                    "mem_peak": telemetry.mem_peak_bytes()})
    totals: dict = {}
    for blob in blobs:
        for k, v in blob["c"].items():
            totals[k] = totals.get(k, 0) + int(v)
    peak = max(int(b["mem_peak"]) for b in blobs)
    if telemetry.enabled():
        telemetry.merge_host_counters(totals)
        if peak:
            telemetry.merge_host_memory(peak)


def unpack_split(packed: torch.Tensor) -> SplitResult:
    """``SplitResult.packed()``'s inverse: [..., 11] f32 -> the record
    (indices and counts are exact in f32 below 2^24)."""
    f = [packed[..., i] for i in range(packed.shape[-1])]
    return SplitResult(f[0], f[1].long(), f[2].long(), f[3], f[4],
                       f[5].to(torch.int32), f[6].to(torch.int32), f[7],
                       f[8], f[9], f[10])


def allreduce_best_split(res: SplitResult, comm: mesh.Comm, site: str,
                         axis: str = mesh.DATA_AXIS) -> SplitResult:
    """SplitInfo::MaxReducer (split_info.hpp:56-104) over the world: the
    largest gain wins, a tie goes to the smaller global feature; a batch
    of records reduces elementwise.  One all-gather of the packed
    records (JAX :126-143)."""
    stacked = comm.all_gather(res.packed(), site, axis)   # [P, ..., 11]
    gain = stacked[..., 0]
    max_gain = gain.max(0).values
    is_max = (gain == max_gain) & torch.isfinite(max_gain)
    key = torch.where(is_max, stacked[..., 1],
                      torch.full_like(gain, float(1 << 30)))
    pick = key.argmin(0)                                  # first minimum
    idx = pick[None, ..., None].expand(1, *pick.shape, stacked.shape[-1])
    return unpack_split(stacked.gather(0, idx)[0])


def ownership_finder(own_ids: torch.Tensor, comm: mesh.Comm, site: str,
                     axis: str = mesh.DATA_AXIS) -> Callable:
    """The split finder of an ownership schedule (JAX :146-158): the
    search over the owned block, its feature mapped to the global index
    (``own_ids`` [Fb] int64), then ``allreduce_best_split``."""
    def finder(hist, sg, sh, cnt, nb, fm, mind, minh):
        local = find_best_split(hist, sg, sh, cnt, nb, fm, mind, minh)
        local = local._replace(feature=own_ids[local.feature])
        return allreduce_best_split(local, comm, site, axis)
    return finder


def _owned_block(F: int, num_shards: int, rank: int):
    """Contiguous-block ownership (JAX :161-177): (Fb, Fpad, own ids
    [Fb], valid [Fb]); a padding block's ids clamp to F - 1 and are not
    valid."""
    Fb = -(-F // num_shards)
    idx = rank * Fb + np.arange(Fb)
    return Fb, Fb * num_shards, np.minimum(idx, F - 1), idx < F


def _pad_features(x: torch.Tensor, dim: int, Fpad: int) -> torch.Tensor:
    F = x.shape[dim]
    if F == Fpad:
        return x
    shape = list(x.shape)
    shape[dim] = Fpad - F
    return torch.cat([x, x.new_zeros(shape)], dim)


def dp_ownership_seams(comm: mesh.Comm, F: int, policy: str, fmask,
                       nbins) -> tuple:
    """The data-parallel ``reduce_scatter`` schedule (JAX :180-238, the
    depth-wise level seams of :624-684): (owned feature mask, owned bin
    counts, SeamSchedule).  The root is reduced whole, so its stats are
    exact on every rank, then cut to the owned block; each later
    histogram, f32 or int32, is reduce-scattered by block."""
    P, rank = comm.size, comm.rank
    Fb, Fpad, own, ok = _owned_block(F, P, rank)
    dev = fmask.device
    own_t = torch.as_tensor(own, device=dev)
    pre = "dp_rs/" + policy

    def scatter(site, dim):
        def fn(h):
            moved = _pad_features(h, dim, Fpad).movedim(dim, 0)
            return comm.reduce_scatter(moved, site).movedim(0, dim)
        return fn

    def psum(site):
        return lambda t: comm.all_reduce(t, site)

    def own_slice(h, dim):
        return _pad_features(h, dim, Fpad).narrow(dim, rank * Fb, Fb)

    schedule = SeamSchedule(
        hist_reduce=scatter(pre + "/hist_scatter", 0),
        int_hist_reduce=scatter(pre + "/hist_scatter", 0),
        scale_reduce=lambda t: comm.all_reduce(t, "hist/quant_scale_pmax",
                                               op="max"),
        stat_reduce=psum(pre + "/root_stats"),
        root_hist_reduce=psum(pre + "/root_hist"),
        own_slice=own_slice,
        split_finder=ownership_finder(own_t, comm,
                                      pre + "/splitinfo_allreduce"),
        hist_reduce_level=scatter(pre + "/level_hist_scatter", 1),
        int_reduce_level=scatter(pre + "/level_int_scatter", 0))
    fmask_own = fmask[own_t] & torch.as_tensor(ok, device=dev)
    return fmask_own, nbins[own_t], schedule


def dp_psum_seams(comm: mesh.Comm, policy: str) -> SeamSchedule:
    """The data-parallel ``psum`` schedule (JAX :425-462): every
    histogram all-reduced whole (int8: the int32 accumulator), the
    search replicated."""
    pre = "dp_psum/" + policy

    def psum(site):
        return lambda t: comm.all_reduce(t, site)

    return SeamSchedule(
        hist_reduce=psum(pre + "/hist_allreduce"),
        int_hist_reduce=psum("hist/int8_cuda_psum"),
        scale_reduce=lambda t: comm.all_reduce(t, "hist/quant_scale_pmax",
                                               op="max"),
        stat_reduce=psum(pre + "/root_stats"),
        root_hist_reduce=psum(pre + "/root_hist"),
        hist_reduce_level=psum(pre + "/hist_allreduce"),
        int_reduce_level=psum("hist/int8_cuda_psum"))


def _block_feat_gather(pack, own, f: int, Fb: int, device):
    """The ``hist_feat_gather`` of a block-local packed owned block (JAX
    :333-354): [Fb] int64, canonical block position -> the block's
    storage position; padding lanes clamp (the search masks them).  None
    under the uniform layout."""
    if pack is None:
        return None
    c2p = np.asarray(pack.c2p, np.int64)
    return torch.as_tensor(np.clip(c2p[own] - f * Fb, 0, Fb - 1),
                           device=device)


def _owner_root_stats(grid: mesh.Grid, site: str) -> Callable:
    """The int8 root stats of an owned-block histogram: feature 0's
    owner (f = 0) sends its f64 sums over the feature group and the
    others add zeros, so every rank takes the serial run's feature-0
    totals (``int_root_stats``)."""
    def fn(hist):
        part = (hist[0].to(torch.float64).sum(0) if grid.f == 0
                else hist.new_zeros(3, dtype=torch.float64))
        return grid.feature.all_reduce(part, site, axis=mesh.FEATURE_AXIS
                                       ).to(torch.float32)
    return fn


def hybrid_ownership_seams(grid: mesh.Grid, F: int, policy: str, fmask,
                           nbins, slice_hist: bool = False,
                           pack=None) -> tuple:
    """The hybrid learner's seams (JAX :241-330): (owned ids [Fb] int64,
    owned feature mask, owned bin counts, SeamSchedule).  The histograms
    are summed over the data group, the owned block only; the split
    record is reduced over the feature group.

    ``slice_hist=False`` (masked, depth-wise): the caller histograms the
    owned block's bin rows alone, so every sum is a plain data-group
    all-reduce (``pack``: the block-local layout, whose passes
    ``hist_feat_gather`` puts back in canonical order).
    ``slice_hist=True`` (compacted): the pane's histograms cover every
    feature; the root is summed whole (its stats exact on every rank),
    then each histogram's owned block is cut out before the sum."""
    Fb, Fpad, own, ok = _owned_block(F, grid.fs, grid.f)
    dev = fmask.device
    own_t = torch.as_tensor(own, device=dev)
    data = grid.data
    pre = "hybrid/" + policy

    def psum(site):
        return lambda t: data.all_reduce(t, site)

    def own_block(h, dim=0):
        return _pad_features(h, dim, Fpad).narrow(dim, grid.f * Fb, Fb)

    if slice_hist:
        seams = dict(
            hist_reduce=lambda h: data.all_reduce(
                own_block(h), pre + "/own_block_allreduce"),
            int_hist_reduce=lambda a: data.all_reduce(
                own_block(a), pre + "/own_block_int_allreduce"),
            own_slice=own_block)
    else:
        seams = dict(
            hist_reduce=psum(pre + "/hist_allreduce"),
            int_hist_reduce=psum("hist/int8_cuda_psum"),
            hist_reduce_level=psum(pre + "/hist_allreduce"),
            int_reduce_level=psum("hist/int8_cuda_psum"),
            int_root_stats=_owner_root_stats(grid, pre + "/root_stats"),
            hist_feat_gather=_block_feat_gather(pack, own, grid.f, Fb,
                                                dev))
    schedule = SeamSchedule(
        scale_reduce=lambda t: data.all_reduce(t, "hist/quant_scale_pmax",
                                               op="max"),
        stat_reduce=psum(pre + "/root_stats"),
        root_hist_reduce=psum(pre + "/root_hist"),
        split_finder=ownership_finder(own_t, grid.feature,
                                      pre + "/splitinfo_allreduce",
                                      mesh.FEATURE_AXIS),
        **seams)
    fmask_own = fmask[own_t] & torch.as_tensor(ok, device=dev)
    return own_t, fmask_own, nbins[own_t], schedule


def voting_seams(grid: mesh.Grid, F: int, top_k: int, int8: bool,
                 policy: str, fmask, nbins, presliced: bool,
                 pack=None) -> tuple:
    """The voting learner's seams (JAX :354-498): (owned ids [Fb] int64 or
    None, feature mask, bin counts, SeamSchedule), the mask and counts
    the owned block's where ``presliced``, else every feature's.  Its
    finder, for a
    batch of leaves (a best-first split's two children, a depth-wise
    level's slots), each on its own:

    1. scores the owned block's features on local evidence: the local
       histograms against local totals read from the histogram itself
       (any feature's bins sum to the leaf's rows), not the global
       totals, else a leaf whose local rows fall below
       ``min_data_in_leaf`` would vote only -inf (JAX :432-443);
    2. votes its top k = min(top_k, Fb) by a stable sort of the scores
       (equal gains: the smaller feature), -inf votes none;
    3. all-gathers the votes over the data group, counts them, and takes
       the V = min(2·top_k, Fb) most voted (a stable sort again: equal
       counts, the smaller id), in ascending order;
    4. sums those V features' histograms over the data group (float
       modes; int8 histograms are global already) and searches them;
    5. reduces the split record over the feature group.

    ``presliced``: the histograms hold the owned block alone (masked and
    depth-wise; their feature mask and bin counts are the block's), else
    every feature (the compacted pane).  The root's finder files its
    exchange at ``root_`` sites (best-first growers; depth-wise runs one
    finder).  The float caches stay local (``hist_local``); int8 sums
    its int32 accumulators over the data group at every pass."""
    Fb, Fpad, own, ok = _owned_block(F, grid.fs, grid.f)
    k, V = min(top_k, Fb), min(2 * top_k, Fb)
    data = grid.data
    pre = "voting/" + policy
    dev = fmask.device
    own_t = torch.as_tensor(own, device=dev)
    ok_t = torch.as_tensor(ok, device=dev)
    idx = grid.f * Fb + torch.arange(Fb, device=dev)

    def make_finder(tag):
        def finder(hist, sg, sh, cnt, nb, fm, mind, minh):
            if presliced:
                hist_own, nb_own, fm_own = hist, nb, fm
            else:
                hist_own = hist.index_select(-3, own_t)
                nb_own, fm_own = nb[own_t], fm[own_t] & ok_t
            B = hist.shape[-2]
            tot = hist_own[..., 0, :, :].to(torch.float64).sum(-2).to(
                torch.float32)                                # [..., 3]
            scores = per_feature_best_scores(
                hist_own, tot[..., 0], tot[..., 1], tot[..., 2], nb_own,
                fm_own, mind, minh)                           # [..., Fb]
            top = torch.argsort(-scores, dim=-1, stable=True)[..., :k]
            votes = torch.where(torch.isfinite(scores.gather(-1, top)),
                                idx[top], Fpad).to(torch.int32)
            votes = data.all_gather(votes, pre + "/%svotes_allgather"
                                    % tag)                    # [ds, ..., k]
            votes = votes.movedim(0, -2).flatten(-2)          # [..., ds*k]
            counts = (votes[..., None, :] == idx[:, None]).sum(-1)
            voted = torch.sort(torch.argsort(-counts, dim=-1, stable=True)
                               [..., :V], dim=-1).values      # [..., V]
            vh = hist_own.gather(-3, voted[..., None, None].expand(
                *voted.shape, B, 3))                          # [..., V, B, 3]
            if not int8:
                vh = data.all_reduce(vh, pre + "/%svoted_hist_allreduce"
                                     % tag)
            local = find_best_split(vh, sg, sh, cnt, nb_own[voted],
                                    fm_own[voted], mind, minh)
            gid = own_t[voted].gather(-1, local.feature[..., None])[..., 0]
            return allreduce_best_split(
                local._replace(feature=gid), grid.feature,
                pre + "/%ssplitinfo_allreduce" % tag, mesh.FEATURE_AXIS)
        return finder

    def psum(site):
        return lambda t: data.all_reduce(t, site)

    int_sum = psum("hist/int8_cuda_psum") if int8 else None
    schedule = SeamSchedule(
        scale_reduce=lambda t: data.all_reduce(t, "hist/quant_scale_pmax",
                                               op="max"),
        stat_reduce=psum(pre + "/root_stats"),
        int_hist_reduce=int_sum, root_hist_reduce=int_sum,
        int_reduce_level=int_sum,
        int_root_stats=(_owner_root_stats(grid, pre + "/root_stats")
                        if presliced else None),
        split_finder=make_finder(""),
        root_split_finder=(None if policy == "depthwise"
                           else make_finder("root_")),
        hist_local=not int8,
        hist_feat_gather=_block_feat_gather(pack, own, grid.f, Fb, dev))
    if not presliced:
        # the compacted pane: every feature; the finder cuts the block
        return None, fmask, nbins, schedule
    return own_t, fmask[own_t] & ok_t, nbins[own_t], schedule


def balanced_ownership(num_bins, num_shards: int):
    """Bin-count-balanced ownership (feature_parallel_tree_learner.cpp:
    27-44; JAX :1415-1441): features by bin count, each to the lightest
    shard with room.  (own [S, Fs] int32 feature ids, ownmask [S, Fs]);
    padding slots name feature 0 and are masked."""
    num_bins = np.asarray(num_bins)
    F = len(num_bins)
    Fs = -(-F // num_shards)
    order = np.argsort(-num_bins, kind="stable")
    loads = np.zeros(num_shards, np.int64)
    buckets = [[] for _ in range(num_shards)]
    for f in order:
        s = min((s for s in range(num_shards) if len(buckets[s]) < Fs),
                key=lambda s: (loads[s], s))
        buckets[s].append(int(f))
        loads[s] += int(num_bins[f])
    own = np.zeros((num_shards, Fs), np.int32)
    ownmask = np.zeros((num_shards, Fs), bool)
    for s, b in enumerate(buckets):
        own[s, :len(b)] = sorted(b)
        ownmask[s, :len(b)] = True
    return own, ownmask


def static_ownership(num_features: int, num_shards: int):
    """Contiguous-slice ownership, no balancing (JAX :1444-1449)."""
    Fs = -(-num_features // num_shards)
    own = np.minimum(np.arange(num_shards)[:, None] * Fs + np.arange(Fs),
                     num_features - 1).astype(np.int32)
    ownmask = (np.arange(num_shards)[:, None] * Fs
               + np.arange(Fs)) < num_features
    return own, ownmask


def create_parallel_learner(config):
    """TreeLearner::CreateTreeLearner (tree_learner.cpp:8-17) for the
    parallel learners (JAX :510-522)."""
    kind = config.boosting_config.tree_learner
    if kind == "data":
        return DataParallelLearner(config)
    if kind == "feature":
        return FeatureParallelLearner(config)
    if kind == "hybrid":
        return HybridLearner(config)
    if kind == "voting":
        return VotingLearner(config)
    log.fatal("Tree learner type error")


def row_shard(config) -> tuple:
    """(rank, num_machines) of the row draw this rank loads
    (``Dataset.load_train``): under data the rank's own of the world,
    under hybrid and voting its data index's of the data shards (the
    ranks of one feature group hold the same rows); (0, 1), every row,
    under feature and serial."""
    if not config.is_parallel_find_bin:
        return 0, 1
    rank, world = mesh.get_rank(), mesh.get_num_machines()
    kind = config.boosting_config.tree_learner
    if kind in ("hybrid", "voting"):
        ds, fs = grid_shape(config, world)
        return rank // fs, ds
    return rank, world


def grid_shape(config, world: int) -> tuple:
    """(data shards, feature shards) of a hybrid or voting world of
    ``world`` ranks (parallel/mesh.factor_machines).  A ``feature_shards``
    that divides ``num_machines`` but not the world, as on a restart on
    fewer ranks, is a ``Fatal`` that says so."""
    fs = config.boosting_config.tree_config.feature_shards
    if fs and world % fs:
        log.fatal("feature_shards=%d does not divide the world's %d ranks: "
                  "a restart on fewer ranks factors the grid over the "
                  "ranks it has (num_machines=%d shrinks to them); give "
                  "feature_shards a divisor of %d, or 0"
                  % (fs, world, config.network_config.num_machines, world))
    return mesh.factor_machines(
        world, fs, voting=config.boosting_config.tree_learner == "voting")


class _ParallelLearnerBase:
    """What the learners share: the world (``bind``) and the grow call."""
    route_name = ""
    # the learner's rows are this rank's shard (data) or every row
    shards_rows = False
    # ranks holding the same rows, next to each other in rank order (a
    # grid's feature group): gathers of the world's rows take every
    # row_step-th rank
    row_step = 1

    def __init__(self, config):
        self.config = config
        self.tree_config = config.boosting_config.tree_config
        self.world = mesh.world_size(config.network_config.num_machines)
        self.comm = None

    def bind(self, device: torch.device) -> torch.device:
        """This rank's device and its collective group (parallel/mesh
        backend rule); collective: every rank binds at booster init."""
        device = mesh.rank_device(device)
        self.comm = mesh.comm_for(device)
        self.world = self.comm.size
        return device

    @property
    def data_shards(self) -> int:
        """How many row shards the world holds."""
        return self.world

    @property
    def _depthwise(self) -> bool:
        return self.tree_config.grow_policy == "depthwise"

    def _grow(self, gbdt, bins, grad, hess, row_mask, feature_mask,
              num_bins, policy, schedule, partition_bins=None,
              packing="booster", partition_packing=None):
        tc = self.tree_config
        return grow_tree_unified(
            bins, grad, hess, row_mask, feature_mask, num_bins,
            policy=policy, num_leaves=gbdt._num_leaves(),
            num_bins_max=gbdt.num_bins_max,
            min_data_in_leaf=tc.min_data_in_leaf,
            min_sum_hessian_in_leaf=tc.min_sum_hessian_in_leaf,
            max_depth=tc.max_depth, compute_dtype=tc.compute_dtype,
            packing=gbdt._pack_spec if packing == "booster" else packing,
            schedule=schedule, partition_bins=partition_bins,
            partition_packing=partition_packing)


class DataParallelLearner(_ParallelLearnerBase):
    """Rows sharded, histograms summed over the world (module
    docstring), under any of the three growers."""
    route_name = "dp"
    shards_rows = True

    def schedule(self) -> str:
        """``dp_schedule``, with ``auto`` resolved (JAX :574-585)."""
        s = self.tree_config.dp_schedule
        if s == "auto":
            return "reduce_scatter" if self.world > 1 else "psum"
        return s

    def __call__(self, gbdt, bins, grad, hess, row_mask, feature_mask):
        policy = self.tree_config.policy
        rs = self.schedule() == "reduce_scatter"
        telemetry.count_route("learner_dp", "learner/dp_%s%s"
                              % (policy, "_rs" if rs else ""))
        nbins = gbdt.num_bins_device
        if rs:
            feature_mask, nbins, schedule = dp_ownership_seams(
                self.comm, bins.shape[0], policy, feature_mask, nbins)
        else:
            schedule = dp_psum_seams(self.comm, policy)
        return self._grow(gbdt, bins, grad, hess, row_mask, feature_mask,
                          nbins, policy, schedule)


class FeatureParallelLearner(_ParallelLearnerBase):
    """Features owned by bin-count balance, rows replicated (module
    docstring).  The owned bin rows are gathered once per bin matrix."""
    route_name = "fp"
    ownership = staticmethod(balanced_ownership)

    def _owned(self, gbdt, bins):
        """(owned ids [Fs] int64, valid [Fs], owned bins [Fs, N], the
        owned slot of feature 0 or -1) on the device, cached for the
        booster's bin matrix."""
        cache = getattr(self, "_own_cache", None)
        if cache is not None and cache[0] is bins:
            return cache[1]
        own, ownmask = type(self).ownership(
            np.asarray(gbdt.train_data.num_bins), self.comm.size)
        own, ownmask = own[self.comm.rank], ownmask[self.comm.rank]
        ids = torch.as_tensor(own, dtype=torch.int64, device=bins.device)
        slot0 = np.flatnonzero((own == 0) & ownmask)
        owned = (ids, torch.as_tensor(ownmask, device=bins.device),
                 bins.index_select(0, ids),
                 int(slot0[0]) if slot0.size else -1)
        self._own_cache = (bins, owned)
        return owned

    def __call__(self, gbdt, bins, grad, hess, row_mask, feature_mask):
        policy = "depthwise" if self._depthwise else "leafwise"
        telemetry.count_route("learner_fp", "learner/fp_" + policy)
        ids, ok, bins_own, slot0 = self._owned(gbdt, bins)
        comm = self.comm

        def int_root_stats(hist):
            # any feature's bins sum to the quantized totals, but their
            # f32 cells round apart; the serial run reads feature 0, so
            # its owner sends its f64 sums and the others add zeros
            part = (hist[slot0].to(torch.float64).sum(0) if slot0 >= 0
                    else hist.new_zeros(3, dtype=torch.float64))
            return comm.all_reduce(part, "fp/root_stats",
                                   axis=mesh.FEATURE_AXIS).to(torch.float32)

        schedule = SeamSchedule(
            split_finder=ownership_finder(ids, comm,
                                          "fp/splitinfo_allreduce",
                                          mesh.FEATURE_AXIS),
            int_root_stats=int_root_stats)
        return self._grow(gbdt, bins_own, grad, hess, row_mask,
                          feature_mask[ids] & ok,
                          gbdt.num_bins_device[ids], policy, schedule,
                          partition_bins=bins)


class HybridLearner(_ParallelLearnerBase):
    """Rows sharded over the grid's data index, feature blocks owned over
    its feature index (module docstring), under any of the three
    growers; 1 x 1 is the serial run."""
    route_name = "hybrid"
    shards_rows = True
    voting = False

    def __init__(self, config):
        super().__init__(config)
        self.ds, self.fs = grid_shape(config, self.world)
        self.row_step = self.fs
        self.grid = None

    @property
    def data_shards(self) -> int:
        return self.ds

    def bind(self, device: torch.device) -> torch.device:
        """This rank's device and its grid's groups (parallel/mesh.
        grid_for); collective: every rank binds at booster init."""
        device = mesh.rank_device(device)
        self.grid = mesh.grid_for(device, self.ds, self.fs)
        self.comm = self.grid.data
        return device

    def agree_rows(self, num_data: int) -> None:
        """Every rank of a feature group must hold the same rows (under
        ``is_pre_partition`` each reads its own file): their counts are
        compared over the world, a ``Fatal`` naming the group where they
        differ.  Collective."""
        counts = mesh.all_gather_object(int(num_data))
        for d in range(self.ds):
            group = counts[d * self.fs:(d + 1) * self.fs]
            if len(set(group)) > 1:
                log.fatal("tree_learner=%s: the ranks of data shard %d "
                          "(ranks %d-%d) hold %s rows; the ranks of one "
                          "feature group must load the same rows (with "
                          "is_pre_partition=true, the same file)"
                          % (self.route_name, d, d * self.fs,
                             (d + 1) * self.fs - 1, group))

    def pack_layout(self, num_features: int) -> tuple:
        """(block, feature shards) of the block-local mixed-bin plan: the
        ownership block width ceil(F / fs) (JAX :1226-1232)."""
        return -(-num_features // self.fs), self.fs

    def _owned_bins(self, bins, own):
        """The owned block's bin rows, cached for the booster's matrix."""
        cache = getattr(self, "_own_cache", None)
        if cache is None or cache[0] is not bins:
            cache = self._own_cache = (bins, bins.index_select(0, own))
        return cache[1]

    @staticmethod
    def _split_pack(gbdt):
        """(the owned block's layout, the whole matrix's) under the
        block-local layout (JAX :1234-1246), else (None, None)."""
        pack = gbdt._pack_spec
        if pack is None:
            return None, None
        return pack.block_view, pack

    def _seams(self, F, policy, fmask, nbins, slice_hist, pack):
        return hybrid_ownership_seams(self.grid, F, policy, fmask, nbins,
                                      slice_hist, pack)

    def __call__(self, gbdt, bins, grad, hess, row_mask, feature_mask):
        policy = self.tree_config.policy
        telemetry.count_route("learner_" + self.route_name, "learner/%s_%s"
                              % (self.route_name, policy))
        F = bins.shape[0]
        nbins = gbdt.num_bins_device
        if policy == "leafcompact":
            # the pane keeps every feature, in the booster's layout
            _, fmask, nbins, schedule = self._seams(
                F, policy, feature_mask, nbins, True, None)
            return self._grow(gbdt, bins, grad, hess, row_mask, fmask,
                              nbins, policy, schedule)
        block_pack, pack = self._split_pack(gbdt)
        own, fmask, nbins, schedule = self._seams(
            F, policy, feature_mask, nbins, False, pack)
        return self._grow(gbdt, self._owned_bins(bins, own), grad, hess,
                          row_mask, fmask, nbins, policy, schedule,
                          partition_bins=bins, packing=block_pack,
                          partition_packing=pack)


class VotingLearner(HybridLearner):
    """PV-tree voting over the grid's data shards (module docstring):
    ``feature_shards`` 1 unless asked; exact when 2·top_k covers the
    owned block, and in int8 always."""
    route_name = "voting"
    voting = True

    def _seams(self, F, policy, fmask, nbins, slice_hist, pack):
        return voting_seams(self.grid, F, self.tree_config.top_k,
                            is_int8(self.tree_config.compute_dtype), policy,
                            fmask, nbins, not slice_hist, pack)


def distributed_bin_finder():
    """Distributed bin finding (dataset.cpp:353-415; JAX :1617-1653): rank
    r finds the mappers of a contiguous feature slice from the sample,
    and every rank gathers all of them; None in a world of one (local
    finding gives the same mappers).  Collective: every rank loads at
    the same point."""
    if mesh.get_num_machines() <= 1:
        return None

    def finder(sample: np.ndarray, max_bin: int):
        P, rank = mesh.get_num_machines(), mesh.get_rank()
        F = sample.shape[1]
        step = -(-F // P)
        lo, hi = rank * step, min((rank + 1) * step, F)
        blobs = []
        for j in range(lo, hi):
            mapper = BinMapper()
            mapper.find_bin(sample[:, j], max_bin)
            blobs.append(mapper.to_bytes())
        return [BinMapper.from_bytes(b)
                for part in mesh.all_gather_object(blobs) for b in part]
    return finder


__all__ = ["DataParallelLearner", "FeatureParallelLearner", "HybridLearner",
           "VotingLearner", "aggregate_telemetry", "allreduce_best_split",
           "balanced_ownership", "create_parallel_learner",
           "distributed_bin_finder", "dp_ownership_seams", "dp_psum_seams",
           "grid_shape",
           "hybrid_ownership_seams", "ownership_finder", "row_shard",
           "static_ownership", "unpack_split", "voting_seams"]
