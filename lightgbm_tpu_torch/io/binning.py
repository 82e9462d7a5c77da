"""Feature binning: value -> bin quantization.

A copy of lightgbm_tpu/io/binning.py's ``BinMapper`` (:26-178) and
``find_bins_for_matrix`` (:401-409): the reference's FindBin
(bin.cpp:42-132) step for step, because the port must bin a dataset
exactly as the JAX package does for its trees to agree; with its
``sparse_rate``, its byte layout (``to_bytes``/``from_bytes``, bin.cpp:
144-175, so either package reads the other's dataset cache), the
``bin_representatives`` that decode a cache's bins for prediction and
``bin_features``, the quantization of a value matrix.  Also its serial
mixed-bin plan, ``PackSpec`` and ``plan_feature_packing``
(:180-244, :371-398): the block-local plan of the hybrid and voting
learners and the ``LGBM_TPU_NO_MIXEDBIN`` hatch (``mixed_bin=false``
does the same) are not ported.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import numpy as np


@dataclass
class BinMapper:
    """Quantization map for one feature (bin.h:47-119)."""
    num_bin: int = 0
    is_trivial: bool = False
    # the sample's share in bin 0 (bin.cpp:128); written to the caches
    sparse_rate: float = 0.0
    # bin i covers values <= bin_upper_bound[i]; last entry is +inf
    bin_upper_bound: np.ndarray = field(default_factory=lambda: np.zeros(0))

    def find_bin(self, values: np.ndarray, max_bin: int) -> None:
        """BinMapper::FindBin (bin.cpp:42-132), literal algorithm port.

        ``values`` are the sampled values for this feature, zeros included
        (dataset.cpp:278-305 pushes an explicit 0.0 per sampled row).
        """
        values = np.asarray(values, dtype=np.float64)
        sample_size = values.size
        distinct_values, counts = np.unique(values, return_counts=True)
        distinct_values = list(distinct_values)
        counts = [int(c) for c in counts]
        num_values = len(distinct_values)
        cnt_in_bin0 = 0

        if num_values <= max_bin:
            # distinct values are enough: midpoints as boundaries
            self.num_bin = num_values
            upper = np.empty(num_values, dtype=np.float64)
            for i in range(num_values - 1):
                upper[i] = (distinct_values[i] + distinct_values[i + 1]) / 2.0
            if num_values > 0:
                cnt_in_bin0 = counts[0]
                upper[num_values - 1] = np.inf
            self.bin_upper_bound = upper
        else:
            # hybrid: dedicated bins for large-count values, then
            # equal-frequency for the remainder
            mean_bin_size = sample_size / float(max_bin)
            rest_sample_cnt = sample_size
            bin_cnt = 0
            self.num_bin = max_bin
            upper_bounds = [np.inf] * max_bin
            lower_bounds = [np.inf] * max_bin
            # sort by count, descending.  Tie order among equal counts is
            # provably irrelevant to the resulting bounds (dedicated-bin
            # membership is a strict threshold over a contiguous tie run,
            # and both the remainder and the final bins are re-sorted by
            # value) — proven adversarially in tests/test_binning.py.
            # DELIBERATE DIVERGENCE (PARITY.md): the reference's remainder
            # value sort goes through Common::SortForPair
            # (common.h:362-381), whose write-back is off by `start`; with
            # start=bin_cnt>0 (bin.cpp:93) it DROPS the bin_cnt smallest
            # remainder values and leaves a stale std::sort-order-dependent
            # tail, silently losing bin boundaries on features with
            # dedicated bins.  We implement the intended algorithm
            # (tests/test_reference_differential.py::
            # test_binning_count_ties_reference_sortforpair_defect pins
            # both behaviors).
            order = sorted(range(num_values), key=lambda i: -counts[i])
            counts = [counts[i] for i in order]
            distinct_values = [distinct_values[i] for i in order]
            # fetch big slots as dedicated bins
            while bin_cnt < num_values and counts[bin_cnt] > mean_bin_size:
                upper_bounds[bin_cnt] = distinct_values[bin_cnt]
                lower_bounds[bin_cnt] = distinct_values[bin_cnt]
                rest_sample_cnt -= counts[bin_cnt]
                bin_cnt += 1
            # process remainder bins
            if bin_cnt < max_bin:
                # sort rest by value ascending
                rest = sorted(range(bin_cnt, num_values),
                              key=lambda i: distinct_values[i])
                distinct_values[bin_cnt:] = [distinct_values[i] for i in rest]
                counts[bin_cnt:] = [counts[i] for i in rest]
                mean_bin_size = rest_sample_cnt / float(max_bin - bin_cnt)
                lower_bounds[bin_cnt] = distinct_values[bin_cnt]
                cur_cnt_inbin = 0
                for i in range(bin_cnt, num_values - 1):
                    rest_sample_cnt -= counts[i]
                    cur_cnt_inbin += counts[i]
                    if cur_cnt_inbin >= mean_bin_size:
                        upper_bounds[bin_cnt] = distinct_values[i]
                        if bin_cnt == 0:
                            cnt_in_bin0 = cur_cnt_inbin
                        bin_cnt += 1
                        lower_bounds[bin_cnt] = distinct_values[i + 1]
                        if bin_cnt >= max_bin - 1:
                            break
                        cur_cnt_inbin = 0
                        mean_bin_size = rest_sample_cnt / float(max_bin - bin_cnt)
            # sort (lower, upper) pairs by lower bound
            pairs = sorted(zip(lower_bounds, upper_bounds), key=lambda p: p[0])
            lower_bounds = [p[0] for p in pairs]
            upper_bounds = [p[1] for p in pairs]
            self.num_bin = bin_cnt
            upper = np.empty(bin_cnt, dtype=np.float64)
            for i in range(bin_cnt - 1):
                upper[i] = (upper_bounds[i] + lower_bounds[i + 1]) / 2.0
            if bin_cnt > 0:
                upper[bin_cnt - 1] = np.inf
            self.bin_upper_bound = upper

        self.is_trivial = self.num_bin <= 1
        self.sparse_rate = (cnt_in_bin0 / float(sample_size)
                            if sample_size > 0 else 0.0)

    def value_to_bin(self, value):
        """ValueToBin binary search (bin.h:296-309): first bin whose upper
        bound >= value.  Vectorized: accepts scalars or arrays."""
        bounds = self.bin_upper_bound[:-1]  # last is +inf
        return np.searchsorted(bounds, np.asarray(value), side="left").astype(np.int32)

    def bin_representatives(self) -> np.ndarray:
        """One finite value per bin that ``value_to_bin`` maps back to it
        (lightgbm_tpu/io/binning.py:141-160), to score a dataset cache:
        bin b < num_bin - 1 its own upper bound (side="left"), the last
        bin the previous bound + 1 (0.0 for a single-bin mapper)."""
        vals = self.bin_upper_bound.astype(np.float64).copy()
        if vals.size and not np.isfinite(vals[-1]):
            vals[-1] = vals[-2] + 1.0 if vals.size > 1 else 0.0
        return vals

    # bin.cpp:144-175's fixed layout: int num_bin, bool is_trivial, 7
    # bytes of padding, double sparse_rate, then the upper bounds
    def to_bytes(self) -> bytes:
        head = struct.pack("<i?7x d", self.num_bin, self.is_trivial,
                           self.sparse_rate)
        return head + np.asarray(self.bin_upper_bound,
                                 dtype=np.float64).tobytes()

    @classmethod
    def from_bytes(cls, buffer: bytes) -> "BinMapper":
        num_bin, is_trivial, sparse_rate = struct.unpack_from("<i?7x d",
                                                              buffer, 0)
        upper = np.frombuffer(buffer, dtype=np.float64, count=num_bin,
                              offset=struct.calcsize("<i?7x d")).copy()
        return cls(num_bin=num_bin, is_trivial=bool(is_trivial),
                   sparse_rate=sparse_rate, bin_upper_bound=upper)


def bin_features(mappers: List[BinMapper], used_feature_map,
                 features: np.ndarray, dtype) -> np.ndarray:
    """[n, raw features] values -> the [F, n] bins of the used features
    (``used_feature_map``: raw column -> used feature)."""
    out = np.empty((len(mappers), features.shape[0]), dtype=dtype)
    for j_raw, j_inner in used_feature_map.items():
        out[j_inner] = mappers[j_inner].value_to_bin(
            features[:, j_raw]).astype(dtype)
    return out


def find_bins_for_matrix(sample: np.ndarray, max_bin: int) -> List[BinMapper]:
    """Compute a BinMapper per column of a dense sample matrix
    (ConstructBinMappers single-machine path, dataset.cpp:322-350)."""
    mappers = []
    for j in range(sample.shape[1]):
        mapper = BinMapper()
        mapper.find_bin(sample[:, j], max_bin)
        mappers.append(mapper)
    return mappers


# Mixed-bin feature packing.  The histogram kernel prices every feature
# at the pass's bin width B; a 3-value flag column costs what a
# continuous one does.  The fix is a layout chosen once per booster:
# features with num_bin <= NARROW_BINS form the narrow class, the rest
# the wide class at num_bins_max; the booster's bin matrix stores each
# class as a contiguous block of rows, a histogram pass launches once per
# class at its width, and the per-class histograms are put back in
# canonical feature order (zero bins padded) before split search, so
# trees are those of the uniform layout.
NARROW_BINS = 64


class PackSpec(NamedTuple):
    """A packed bin-matrix layout.

    widths : per-class histogram width, ascending (e.g. ``(64, 254)``)
    counts : features per class, same order; ``sum(counts) == F``
    perm   : packed position -> canonical feature index (stable within
             each class)
    """
    widths: tuple
    counts: tuple
    perm: tuple

    @property
    def ranges(self):
        """Per-class ``(start, count, width)`` in packed feature order."""
        out, start = [], 0
        for cnt, width in zip(self.counts, self.widths):
            out.append((start, cnt, width))
            start += cnt
        return tuple(out)

    @property
    def c2p(self) -> tuple:
        """Canonical feature index -> packed position (inverse of
        ``perm``)."""
        inv = [0] * len(self.perm)
        for p, f in enumerate(self.perm):
            inv[f] = p
        return tuple(inv)


class BlockedPackSpec(NamedTuple):
    """The block-local mixed-bin layout of a contiguous feature-block
    ownership (the hybrid and voting learners; lightgbm_tpu/io/
    binning.py:246-330): the bin-width-class permutation is planned per
    ownership block of width ``block`` and never crosses a block's edge,
    so the storage rows of block b are the canonical features
    ``[b * block, (b + 1) * block)`` in another inner order.  Every block
    has the same class counts: its first ``counts[0]`` narrow features
    (canonical order) in the narrow segment, everything else, surplus
    narrow features included, in the wide one.

    widths : ``(narrow_bins, num_bins_max)``
    counts : per-block features per class ``(c_n, block - c_n)``
    block  : the ownership block width ``ceil(F / feature_shards)``
    perm   : storage position -> canonical feature (global, len F)
    """
    widths: tuple
    counts: tuple
    block: int
    perm: tuple

    @property
    def c2p(self) -> tuple:
        """Canonical feature -> storage position (global)."""
        inv = [0] * len(self.perm)
        for p, f in enumerate(self.perm):
            inv[f] = p
        return tuple(inv)

    @property
    def ranges(self):
        """Global ``(start, count, width)`` segments in storage order: each
        block's narrow segment, then its wide one (2 per block), for the
        passes over every feature (the compacted grower's pane)."""
        F = len(self.perm)
        c_n = self.counts[0]
        out = []
        for start in range(0, F, self.block):
            width = min(self.block, F - start)
            if c_n:
                out.append((start, c_n, self.widths[0]))
            if width > c_n:
                out.append((start + c_n, width - c_n, self.widths[1]))
        return tuple(out)

    @property
    def block_view(self) -> PackSpec:
        """The layout of one owned block's ``[block, N]`` bin rows, as the
        masked and depth-wise hybrid and voting growers histogram them:
        two classes in the block's storage order (identity perm); the
        learner's ``hist_feat_gather`` puts the block back in canonical
        order."""
        return PackSpec(widths=self.widths,
                        counts=(self.counts[0], self.block - self.counts[0]),
                        perm=tuple(range(self.block)))


def plan_feature_packing_blocked(num_bins, num_bins_max: int, block: int,
                                 mode: str = "auto",
                                 narrow_bins: int = NARROW_BINS,
                                 shards: int = 0
                                 ) -> Optional[BlockedPackSpec]:
    """The block-local layout for ownership blocks of width ``block`` over
    ``shards`` feature shards (lightgbm_tpu/io/binning.py:333-370), or
    None (the uniform layout): where ``plan_feature_packing`` would give
    None, where a shard would own only padding (``block * (shards - 1)
    >= F``), or where some block has no narrow feature (the narrow count
    is the minimum over the blocks)."""
    if mode == "false":
        return None
    nb = np.asarray(num_bins)
    F = nb.size
    if F == 0 or num_bins_max <= narrow_bins or block <= 0:
        return None
    if shards > 1 and block * (shards - 1) >= F:
        return None
    narrow = nb <= narrow_bins
    if not narrow.any() or narrow.all():
        return None
    starts = range(0, F, block)
    c_n = min(int(narrow[s:s + block].sum()) for s in starts)
    if c_n == 0:
        return None
    perm = []
    for s in starts:
        local = np.arange(s, min(s + block, F))
        first_n = local[narrow[local]][:c_n]
        rest = local[~np.isin(local, first_n)]
        perm.extend(int(i) for i in np.concatenate([first_n, rest]))
    return BlockedPackSpec(widths=(int(narrow_bins), int(num_bins_max)),
                           counts=(int(c_n), int(block - c_n)),
                           block=int(block), perm=tuple(perm))


def plan_feature_packing(num_bins, num_bins_max: int, mode: str = "auto",
                         narrow_bins: int = NARROW_BINS
                         ) -> Optional[PackSpec]:
    """The packed layout for a dataset's per-feature bin counts, or None
    where packing cannot help: ``mode="false"``, or a single class (every
    feature wide, or ``num_bins_max`` already within the narrow width).
    "auto" and "true" plan alike."""
    if mode == "false":
        return None
    nb = np.asarray(num_bins)
    if nb.size == 0 or num_bins_max <= narrow_bins:
        return None
    narrow = nb <= narrow_bins
    if not narrow.any() or narrow.all():
        return None
    order = np.concatenate([np.nonzero(narrow)[0], np.nonzero(~narrow)[0]])
    return PackSpec(
        widths=(int(narrow_bins), int(num_bins_max)),
        counts=(int(narrow.sum()), int((~narrow).sum())),
        perm=tuple(int(i) for i in order))
