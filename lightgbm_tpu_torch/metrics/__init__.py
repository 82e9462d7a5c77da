"""Evaluation metrics: binary_logloss and auc.

Copies of lightgbm_tpu/metrics/__init__.py's ``BinaryLoglossMetric``
(:117) and ``AUCMetric`` (:154): host numpy evaluators over the score
vector, with the reference's display names and tie handling
(binary_metric.hpp).  The other metrics belong to objectives outside this
slice.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..utils import log


class Metric:
    name: str = ""

    def init(self, test_name, metadata, num_data):
        self.name = f"{test_name}'s {self.display_name}"
        self.num_data = num_data
        self.label = np.asarray(metadata.label)
        self.weights = (np.asarray(metadata.weights)
                        if metadata.weights is not None else None)
        self.sum_weights = (float(self.weights.sum())
                            if self.weights is not None else float(num_data))


class BinaryLoglossMetric(Metric):
    """Weighted mean log loss (binary_metric.hpp:18-141)."""
    display_name = "log loss"

    def __init__(self, config):
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            log.fatal("Sigmoid param %f should greater than zero"
                      % self.sigmoid)

    def eval(self, score):
        prob = 1.0 / (1.0 + np.exp(-2.0 * self.sigmoid * np.asarray(score)))
        # LossOnPoint (binary_metric.hpp:105-126): -log(p) label-sided
        prob = np.clip(prob, 1e-15, 1 - 1e-15)
        loss = np.where(self.label == 1, -np.log(prob), -np.log(1.0 - prob))
        if self.weights is not None:
            loss = loss * self.weights
        return [float(loss.sum()) / self.sum_weights]


class AUCMetric(Metric):
    """AUC with tie handling (binary_metric.hpp:146-254)."""
    display_name = "AUC"

    def __init__(self, config):
        pass

    def eval(self, score):
        score = np.asarray(score)
        label = self.label
        w = self.weights if self.weights is not None else np.ones_like(label)
        order = np.argsort(-score, kind="stable")
        s, l, wt = score[order], label[order], w[order]
        pos = l * wt
        neg = (1.0 - l) * wt
        # group ties: boundaries where score changes
        change = np.nonzero(s[1:] != s[:-1])[0] + 1
        starts = np.concatenate(([0], change))
        grp_pos = np.add.reduceat(pos, starts)
        grp_neg = np.add.reduceat(neg, starts)
        pos_before = np.cumsum(grp_pos) - grp_pos
        accum = float(np.sum(grp_neg * (grp_pos * 0.5 + pos_before)))
        sum_pos = float(grp_pos.sum())
        auc = 1.0
        if sum_pos > 0.0 and sum_pos != self.sum_weights:
            auc = accum / (sum_pos * (self.sum_weights - sum_pos))
        return [auc]


def create_metrics(config) -> List[Metric]:
    """CreateMetric (metric.cpp:9-28) for each of ``config.metric_types``
    (config.py refuses every metric outside this slice)."""
    kinds = {"auc": AUCMetric, "binary_logloss": BinaryLoglossMetric}
    return [kinds[t](config.metric_config) for t in config.metric_types]
