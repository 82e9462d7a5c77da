"""Prediction: a plain-torch tree walk over raw feature values, and the
batch predictor of ``task=predict``.

Counterpart of lightgbm_tpu/models/predictor.py.  Each tree replays its
splits in creation order over the rows (node k moves the rows of leaf
``split_leaf[k]`` whose value exceeds the real threshold to leaf k+1) in
float64, and the leaf values are summed tree by tree in the model's
order — the same comparisons and the same sum as the JAX package's host
walk (models/tree.py ``Tree.predict``), on the chosen device.  The JAX
package's serving engine (bucket ladder, int8 tables, sharding) is a
later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..io import parser as parser_mod
from ..ops.scoring import split_leaf_sequence
from ..utils import log


def predict_raw_scores(models, features: np.ndarray,
                       device: torch.device) -> np.ndarray:
    """[N] float64 sum of the trees' outputs on raw ``features``."""
    x = torch.as_tensor(np.asarray(features, np.float64), device=device)
    out = torch.zeros(x.shape[0], dtype=torch.float64, device=device)
    for tree in models:
        values = torch.as_tensor(tree.leaf_value, dtype=torch.float64,
                                 device=device)
        if tree.num_leaves == 1:
            out += values[0]
            continue
        leaf = torch.zeros(x.shape[0], dtype=torch.int64, device=device)
        split_leaf = split_leaf_sequence(tree.left_child, tree.right_child)
        for k in range(tree.num_leaves - 1):
            go_right = x[:, int(tree.split_feature_real[k])] \
                > float(tree.threshold[k])
            leaf = torch.where((leaf == int(split_leaf[k])) & go_right,
                               k + 1, leaf)
        out += values[leaf]
    return out.cpu().numpy()


class Predictor:
    """Predictor::Predict (predictor.hpp:109-197): parse, predict, write
    one line per row."""

    def __init__(self, boosting, is_sigmoid: bool, num_used_model: int):
        self.boosting = boosting
        self.is_sigmoid = is_sigmoid
        self.num_used_model = num_used_model
        self.num_features = boosting.max_feature_idx + 1

    def predict_matrix(self, features: np.ndarray) -> np.ndarray:
        if features.shape[1] < self.num_features:
            pad = np.zeros((features.shape[0],
                            self.num_features - features.shape[1]),
                           dtype=features.dtype)
            features = np.concatenate([features, pad], axis=1)
        raw = self.boosting.predict_raw(features, self.num_used_model)
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
            for v in result:
                # std::to_string(double) prints 6 decimals
                f.write("%.6f\n" % float(v))
        log.info("Finished prediction, result saved to %s" % result_filename)
