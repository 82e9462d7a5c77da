"""Prediction: a plain-torch tree walk over raw feature values, and the
batch predictor of ``task=predict``.

Counterpart of lightgbm_tpu/models/predictor.py.  Each tree replays its
splits in creation order over the rows (node k moves the rows of leaf
``split_leaf[k]`` whose value exceeds the real threshold to leaf k+1) in
float64, and the leaf values are summed tree by tree in the model's
order — the same comparisons and, in float64, the same sum as the JAX
package's host walk (models/tree.py ``Tree.predict``), on the chosen
device.  The JAX package's serving engine (bucket ladder, int8 tables,
sharding) is not ported; the batch predictor sums in f32 as that engine
does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..io import parser as parser_mod
from ..ops.scoring import split_leaf_sequence
from ..utils import log


def predict_raw_scores(models, features: np.ndarray, device: torch.device,
                       num_class: int = 1,
                       dtype: torch.dtype = torch.float64) -> np.ndarray:
    """[K, N] float64 sums of the trees' outputs on raw ``features``: tree
    i adds to class i % K, in model order, accumulated in ``dtype``."""
    x = torch.as_tensor(np.asarray(features, np.float64), device=device)
    out = torch.zeros((num_class, x.shape[0]), dtype=dtype, device=device)
    for i, tree in enumerate(models):
        values = torch.as_tensor(tree.leaf_value, dtype=dtype, device=device)
        if tree.num_leaves == 1:
            out[i % num_class] += values[0]
            continue
        leaf = torch.zeros(x.shape[0], dtype=torch.int64, device=device)
        split_leaf = split_leaf_sequence(tree.left_child, tree.right_child)
        for k in range(tree.num_leaves - 1):
            go_right = x[:, int(tree.split_feature_real[k])] \
                > float(tree.threshold[k])
            leaf = torch.where((leaf == int(split_leaf[k])) & go_right,
                               k + 1, leaf)
        out[i % num_class] += values[leaf]
    return out.to(torch.float64).cpu().numpy()


def continuation_score(models, features: np.ndarray,
                       device: torch.device) -> np.ndarray:
    """[N] float32 initial scores of continued training: "PredictRaw over
    all models", each row's float64 sum of every tree of the input model
    whatever its class, in model order, rounded once to float32 — the JAX
    package's host rule (lightgbm_tpu/models/gbdt.py:2553-2556 through
    its dataset's float32 cast), here at every size.  (Above 20M
    rows x trees the JAX package sums class 0's trees alone, in its
    serving engine: ROADMAP §C.)"""
    return predict_raw_scores(models, features, device)[0].astype(
        np.float32)


def softmax_rows(raw: np.ndarray) -> np.ndarray:
    """Softmax of each row of [N, K] raw scores (gbdt.cpp:496-508)."""
    z = raw - raw.max(axis=1, keepdims=True)
    p = np.exp(z)
    return p / p.sum(axis=1, keepdims=True)


class Predictor:
    """Predictor::Predict (predictor.hpp:109-197): parse, predict, write
    one line per row: the softmax probabilities tab-joined when K > 1,
    else the sigmoid probability or the raw score.

    The scores are summed per class in f32, tree by tree, as the JAX
    package's batch predictor sums them (its serving engine,
    lightgbm_tpu/ops/scoring.py ``_accumulate_tree_scores``), so both
    write the same result file; ``GBDT.predict`` sums in float64 as the
    JAX package's ``GBDT.predict`` does."""

    def __init__(self, boosting, is_sigmoid: bool, num_used_model: int):
        self.boosting = boosting
        self.is_sigmoid = is_sigmoid
        self.num_features = boosting.max_feature_idx + 1
        self.num_class = boosting.num_class
        # num_used_model counts iterations, K trees each
        self.models = boosting.models if num_used_model < 0 else \
            boosting.models[:num_used_model * self.num_class]

    def predict_matrix(self, features: np.ndarray) -> np.ndarray:
        """[N] predictions, or [N, K] probabilities when K > 1."""
        if features.shape[1] < self.num_features:
            pad = np.zeros((features.shape[0],
                            self.num_features - features.shape[1]),
                           dtype=features.dtype)
            features = np.concatenate([features, pad], axis=1)
        scores = predict_raw_scores(self.models, features,
                                    self.boosting.device, self.num_class,
                                    dtype=torch.float32)
        if self.num_class > 1:
            return softmax_rows(scores.T)
        raw = scores[0]
        if self.is_sigmoid and self.boosting.sigmoid > 0:
            return 1.0 / (1.0 + np.exp(-2.0 * self.boosting.sigmoid * raw))
        return raw

    def predict_file(self, data_filename: str, result_filename: str,
                     has_header: bool) -> None:
        parser = parser_mod.create_parser(data_filename, has_header,
                                          self.num_features,
                                          self.boosting.label_idx)
        features = parser.parse(parser_mod.read_lines(
            data_filename, skip_header=has_header)).features
        result = self.predict_matrix(features)
        with open(result_filename, "w") as f:
            # std::to_string(double) prints 6 decimals
            for row in result.reshape(result.shape[0], -1):
                f.write("\t".join("%.6f" % float(v) for v in row) + "\n")
        log.info("Finished prediction, result saved to %s" % result_filename)
