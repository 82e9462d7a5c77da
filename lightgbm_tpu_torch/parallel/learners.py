"""The reference's two parallel tree learners, over ``torch.distributed``.

Counterpart of lightgbm_tpu/parallel/learners.py for ``tree_learner=data``
and ``tree_learner=feature``.  The JAX package runs them as SPMD programs
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

Also here: ``distributed_bin_finder`` (dataset.cpp:353-415),
``aggregate_telemetry`` and the factory ``create_parallel_learner``.
Not ported: the fused chunk programs and ``_segmented_grow`` (ROADMAP
"Not to port"); the hybrid and voting learners (ROADMAP A9b).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import telemetry
from ..io.binning import BinMapper
from ..models.grower_unified import SeamSchedule, grow_tree_unified
from ..ops.split import SplitResult, find_best_split
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
    if kind in ("hybrid", "voting"):
        log.fatal("tree_learner=%s is not ported to lightgbm_tpu_torch "
                  "yet (ROADMAP A9b); it runs tree_learner=data and "
                  "feature" % kind)
    log.fatal("Tree learner type error")


class _ParallelLearnerBase:
    """What both learners share: the world (``bind``) and the grow call."""
    route_name = ""
    # the learner's rows are this rank's shard (data) or every row
    shards_rows = False

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
    def _depthwise(self) -> bool:
        return self.tree_config.grow_policy == "depthwise"

    def _grow(self, gbdt, bins, grad, hess, row_mask, feature_mask,
              num_bins, policy, schedule, partition_bins=None):
        tc = self.tree_config
        return grow_tree_unified(
            bins, grad, hess, row_mask, feature_mask, num_bins,
            policy=policy, num_leaves=gbdt._num_leaves(),
            num_bins_max=gbdt.num_bins_max,
            min_data_in_leaf=tc.min_data_in_leaf,
            min_sum_hessian_in_leaf=tc.min_sum_hessian_in_leaf,
            max_depth=tc.max_depth, compute_dtype=tc.compute_dtype,
            packing=gbdt._pack_spec, schedule=schedule,
            partition_bins=partition_bins)


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


__all__ = ["DataParallelLearner", "FeatureParallelLearner",
           "aggregate_telemetry", "allreduce_best_split",
           "balanced_ownership", "create_parallel_learner",
           "distributed_bin_finder", "dp_ownership_seams", "dp_psum_seams",
           "ownership_finder", "static_ownership", "unpack_split"]
