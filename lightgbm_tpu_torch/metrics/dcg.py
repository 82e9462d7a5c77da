"""DCG/NDCG calculator (dcg_calculator.cpp:13-134).

A copy of lightgbm_tpu/metrics/dcg.py: the label-gain table from the
config (default 2^i − 1, config.cpp:226-232) and the 1/log2(2+i)
discount table to position 10000, in float64 on the host.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

K_MAX_POSITION = 10000


class DCGCalculator:
    def __init__(self, label_gain: Sequence[float]):
        self.label_gain = np.asarray(label_gain, dtype=np.float64)
        self.discount = 1.0 / np.log2(2.0 + np.arange(K_MAX_POSITION))

    def cal_max_dcg_at_k(self, k: int, label: np.ndarray) -> float:
        """Max DCG@k: greedily place highest labels first
        (dcg_calculator.cpp:32-54)."""
        label = np.asarray(label).astype(np.int64)
        k = min(k, label.size)
        sorted_gain = np.sort(self.label_gain[label])[::-1]
        return float(np.sum(sorted_gain[:k] * self.discount[:k]))

    def cal_max_dcg(self, ks: Sequence[int], label: np.ndarray) -> List[float]:
        label = np.asarray(label).astype(np.int64)
        sorted_gain = np.sort(self.label_gain[label])[::-1]
        weighted = sorted_gain * self.discount[:sorted_gain.size]
        cum = np.concatenate(([0.0], np.cumsum(weighted)))
        return [float(cum[min(k, label.size)]) for k in ks]

    def cal_dcg(self, ks: Sequence[int], label: np.ndarray,
                score: np.ndarray) -> List[float]:
        """DCG@ks under the score ordering (dcg_calculator.cpp:111-134)."""
        label = np.asarray(label).astype(np.int64)
        order = np.argsort(-np.asarray(score), kind="stable")
        gains = self.label_gain[label[order]]
        weighted = gains * self.discount[:gains.size]
        cum = np.concatenate(([0.0], np.cumsum(weighted)))
        return [float(cum[min(k, label.size)]) for k in ks]
