"""Feature binning: value -> bin quantization.

A copy of lightgbm_tpu/io/binning.py's ``BinMapper`` (:26-178) and
``find_bins_for_matrix`` (:401-409): the reference's FindBin
(bin.cpp:42-132) step for step, because the port must bin a dataset
exactly as the JAX package does for its trees to agree.  The mixed-bin
packing plans of that module (and their ``hatches`` dependency) are not
part of this slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class BinMapper:
    """Quantization map for one feature (bin.h:47-119)."""
    num_bin: int = 0
    is_trivial: bool = False
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

        if num_values <= max_bin:
            # distinct values are enough: midpoints as boundaries
            self.num_bin = num_values
            upper = np.empty(num_values, dtype=np.float64)
            for i in range(num_values - 1):
                upper[i] = (distinct_values[i] + distinct_values[i + 1]) / 2.0
            if num_values > 0:
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

    def value_to_bin(self, value):
        """ValueToBin binary search (bin.h:296-309): first bin whose upper
        bound >= value.  Vectorized: accepts scalars or arrays."""
        bounds = self.bin_upper_bound[:-1]  # last is +inf
        return np.searchsorted(bounds, np.asarray(value), side="left").astype(np.int32)


def find_bins_for_matrix(sample: np.ndarray, max_bin: int) -> List[BinMapper]:
    """Compute a BinMapper per column of a dense sample matrix
    (ConstructBinMappers single-machine path, dataset.cpp:322-350)."""
    mappers = []
    for j in range(sample.shape[1]):
        mapper = BinMapper()
        mapper.find_bin(sample[:, j], max_bin)
        mappers.append(mapper)
    return mappers
