"""Evaluation metrics: l1, l2, binary_logloss, binary_error, auc,
multi_logloss, multi_error and ndcg.

Copies of lightgbm_tpu/metrics/__init__.py's evaluators (:37-344):
host numpy over the score the boosting loop reads back, with the
reference's display names, weighted means, L2 reported as RMSE, AUC tie
handling, multiclass scores flattened ``[K·N]`` class-major, and NDCG@k
per query with an all-negative query scoring 1.0 (metric.cpp:9-28).
The JAX package's in-program evaluation (``device_spec``) has no
counterpart here.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..utils import log
from .dcg import DCGCalculator


class Metric:
    display_name: str = ""
    # early stopping's direction (lightgbm_tpu/metrics/__init__.py:21)
    is_bigger_better: bool = False

    def init(self, test_name, metadata, num_data):
        self.name = f"{test_name}'s {self.display_name}"
        self.num_data = num_data
        self.label = np.asarray(metadata.label)
        self.weights = (np.asarray(metadata.weights)
                        if metadata.weights is not None else None)
        self.sum_weights = (float(self.weights.sum())
                            if self.weights is not None else float(num_data))


class _PointwiseMetric(Metric):
    """Weighted-mean pointwise losses (regression_metric.hpp:16-121,
    binary_metric.hpp:18-141, multiclass_metric.hpp:16-135)."""

    def __init__(self, config):
        pass

    def eval(self, score):
        loss = self._point_loss(np.asarray(score))
        if self.weights is not None:
            loss = loss * self.weights
        return [self._transform(float(loss.sum()) / self.sum_weights)]

    def _transform(self, mean_loss: float) -> float:
        return mean_loss

    def _point_loss(self, score):
        raise NotImplementedError


class L2Metric(_PointwiseMetric):
    display_name = "l2 loss"

    def _point_loss(self, score):
        d = score - self.label
        return d * d

    def _transform(self, mean_loss):
        # the L2 metric reports RMSE (regression_metric.hpp:100-103)
        return float(np.sqrt(mean_loss))


class L1Metric(_PointwiseMetric):
    display_name = "l1 loss"

    def _point_loss(self, score):
        return np.abs(score - self.label)


class _BinaryMetric(_PointwiseMetric):
    def __init__(self, config):
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            log.fatal("Sigmoid param %f should greater than zero"
                      % self.sigmoid)

    def _prob(self, score):
        return 1.0 / (1.0 + np.exp(-2.0 * self.sigmoid * score))


class BinaryLoglossMetric(_BinaryMetric):
    display_name = "log loss"

    def _point_loss(self, score):
        # LossOnPoint (binary_metric.hpp:105-126): -log(p) label-sided
        prob = np.clip(self._prob(score), 1e-15, 1 - 1e-15)
        return np.where(self.label == 1, -np.log(prob), -np.log(1.0 - prob))


class BinaryErrorMetric(_BinaryMetric):
    display_name = "error rate"

    def _point_loss(self, score):
        # binary_metric.hpp:131-141: prob > 0.5 is predicted positive
        pred_pos = self._prob(score) > 0.5
        return np.where(pred_pos == (self.label == 1), 0.0, 1.0)


class AUCMetric(Metric):
    """AUC with tie handling (binary_metric.hpp:146-254)."""
    display_name = "AUC"
    is_bigger_better = True

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


class _MulticlassMetric(_PointwiseMetric):
    """The score is [K, N] flattened class-major, as the reference's
    score[k * num_data + i] (multiclass_metric.hpp:49-94)."""

    def __init__(self, config):
        self.num_class = int(config.num_class)

    def init(self, test_name, metadata, num_data):
        super().init(test_name, metadata, num_data)
        self.label = self.label.astype(np.int64)

    def eval(self, score):
        return super().eval(np.asarray(score).reshape(self.num_class,
                                                      self.num_data))


class MultiErrorMetric(_MulticlassMetric):
    display_name = "multi error"

    def _point_loss(self, score):
        pred = np.argmax(score, axis=0)
        return np.where(pred == self.label, 0.0, 1.0)


class MultiLoglossMetric(_MulticlassMetric):
    display_name = "multi logloss"

    def _point_loss(self, score):
        z = score - score.max(axis=0, keepdims=True)
        p = np.exp(z)
        p = p / p.sum(axis=0, keepdims=True)
        picked = np.clip(p[self.label, np.arange(self.num_data)], 1e-15, 1.0)
        return -np.log(picked)


class NDCGMetric(Metric):
    """NDCG@ks (rank_metric.hpp:16-167)."""
    is_bigger_better = True

    def __init__(self, config):
        self.eval_at = list(config.eval_at)
        self.dcg = DCGCalculator(config.label_gain)

    def init(self, test_name, metadata, num_data):
        self.name = (f"{test_name}'s "
                     + " ".join(f"NDCG@{k}" for k in self.eval_at))
        self.num_data = num_data
        self.label = np.asarray(metadata.label)
        if metadata.query_boundaries is None:
            log.fatal("For NDCG metric, there should be query information")
        self.boundaries = np.asarray(metadata.query_boundaries)
        self.query_weights = metadata.query_weights
        nq = self.boundaries.size - 1
        self.sum_query_weights = (float(np.sum(self.query_weights))
                                  if self.query_weights is not None
                                  else float(nq))
        # inverse max DCG per query; <= 0: an all-negative query, NDCG 1
        self.inv_max = []
        for q in range(nq):
            lo, hi = self.boundaries[q], self.boundaries[q + 1]
            maxes = self.dcg.cal_max_dcg(self.eval_at, self.label[lo:hi])
            self.inv_max.append([1.0 / m if m > 0 else -1.0 for m in maxes])

    def eval(self, score):
        score = np.asarray(score)
        nq = self.boundaries.size - 1
        result = np.zeros(len(self.eval_at))
        for q in range(nq):
            lo, hi = self.boundaries[q], self.boundaries[q + 1]
            w = (float(self.query_weights[q])
                 if self.query_weights is not None else 1.0)
            if self.inv_max[q][0] <= 0.0:
                # an all-negative query counts 1.0 even when weighted
                # (rank_metric.hpp:98-101, 120-124)
                result += 1.0
                continue
            dcgs = self.dcg.cal_dcg(self.eval_at, self.label[lo:hi],
                                    score[lo:hi])
            for j, d in enumerate(dcgs):
                result[j] += d * self.inv_max[q][j] * w
        return [float(r / self.sum_query_weights) for r in result]


METRIC_CLASSES = {
    "l1": L1Metric, "l2": L2Metric, "binary_logloss": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric, "auc": AUCMetric, "ndcg": NDCGMetric,
    "multi_logloss": MultiLoglossMetric, "multi_error": MultiErrorMetric}


def create_metrics(config) -> List[Metric]:
    """CreateMetric (metric.cpp:9-28) for each of ``config.metric_types``
    (config.py refuses every other name)."""
    return [METRIC_CLASSES[t](config.metric_config)
            for t in config.metric_types]
