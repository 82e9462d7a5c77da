"""Prediction: a plain-torch tree walk over raw feature values, and the
batch predictor of ``task=predict`` over the serving engine.

Counterpart of lightgbm_tpu/models/predictor.py.  ``predict_raw_scores``
replays each tree's splits in creation order over the rows (node k moves
the rows of leaf ``split_leaf[k]`` whose value exceeds the real threshold
to leaf k+1) in float64, and sums the leaf values tree by tree in the
model's order — the same comparisons and, in float64, the same sum as the
JAX package's host walk (models/tree.py ``Tree.predict``), on the chosen
device; ``GBDT.predict*`` and continued training use it.  ``Predictor``
scores through the booster's serving engine (serving.py), in float32 as
the JAX package's Predictor does, so both write the same result file;
a native dataset cache given as ``data=`` is scored from its bins
(``_predict_binary_file``), to the same file as its text.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..io import parser as parser_mod
from ..io.binning import BinMapper
from ..io.dataset import Dataset, read_cache_header
from ..ops.scoring import split_leaf_sequence
from ..utils import log


def predict_raw_scores(models, features: np.ndarray, device: torch.device,
                       num_class: int = 1) -> np.ndarray:
    """[K, N] float64 sums of the trees' outputs on raw ``features``: tree
    i adds to class i % K, in model order."""
    x = torch.as_tensor(np.asarray(features, np.float64), device=device)
    out = torch.zeros((num_class, x.shape[0]), dtype=torch.float64,
                      device=device)
    for i, tree in enumerate(models):
        values = torch.as_tensor(tree.leaf_value, dtype=torch.float64,
                                 device=device)
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
    return out.cpu().numpy()


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
    the leaf index of every tree, the sigmoid probability, or the raw
    score (lightgbm_tpu/models/predictor.py:22-113, 159-173).

    The serving engine is built once, here; ``num_used_model`` counts
    iterations, K trees each."""

    def __init__(self, boosting, is_sigmoid: bool,
                 is_predict_leaf_index: bool, num_used_model: int,
                 serving_options: dict = None):
        self.boosting = boosting
        self.is_sigmoid = is_sigmoid
        self.is_predict_leaf_index = is_predict_leaf_index
        self.num_features = boosting.max_feature_idx + 1
        self.num_class = boosting.num_class
        num_models = (len(boosting.models) if num_used_model < 0
                      else num_used_model * max(self.num_class, 1))
        self.engine = boosting.serving_engine(num_models,
                                              **(serving_options or {}))

    def predict_matrix(self, features: np.ndarray) -> np.ndarray:
        """Dense [N, cols] raw features → the rows of the result file:
        [N] scores, or [N, K] probabilities, or [N, T] leaf indices."""
        if features.shape[1] < self.num_features:
            # pad in the input dtype: a float64 pad would upcast a
            # float32 matrix on concatenate
            pad = np.zeros((features.shape[0],
                            self.num_features - features.shape[1]),
                           dtype=features.dtype)
            features = np.concatenate([features, pad], axis=1)
        features = features[:, :max(self.num_features, 1)]
        if self.is_predict_leaf_index:
            return self.engine.leaf_indices(features)
        scores = self.engine.scores(features)
        if self.num_class > 1:
            return softmax_rows(scores.T)
        raw = scores[0]
        if self.is_sigmoid and self.boosting.sigmoid > 0:
            return 1.0 / (1.0 + np.exp(-2.0 * self.boosting.sigmoid * raw))
        return raw

    def predict_file(self, data_filename: str, result_filename: str,
                     has_header: bool, chunk_lines: int = 500_000) -> None:
        """Score a text file in chunks of ``chunk_lines`` rows: a
        background thread reads and parses up to ``engine.queue`` chunks
        ahead of the one being scored, so neither the features nor the
        scores of the whole file are held at once.  Rows are independent
        through the engine, so the file is byte-equal at any chunk
        length."""
        if (os.path.isfile(data_filename)
                and Dataset._classify_binary_cache(data_filename) == "ours"):
            return self._predict_binary_file(data_filename, result_filename,
                                             chunk_lines)
        parser = parser_mod.create_parser(data_filename, has_header,
                                          self.num_features,
                                          self.boosting.label_idx)
        chunks = (parser.parse(lines).features
                  for lines in parser_mod.read_line_chunks(
                      data_filename, skip_header=has_header,
                      chunk_lines=chunk_lines))
        with open(result_filename, "w") as f:
            for features in parser_mod.prefetch_chunks(
                    chunks, depth=max(int(self.engine.queue), 1)):
                self._write_chunk(f, self.predict_matrix(features))
        log.info("Finished prediction, result saved to %s" % result_filename)

    def _predict_binary_file(self, data_filename: str, result_filename: str,
                             chunk_lines: int) -> None:
        """Score a native dataset cache (lightgbm_tpu/models/predictor.py:
        115-157): its memmapped [F, N] bins, in row chunks, decoded to
        each mapper's ``bin_representatives`` in the raw column space,
        which put every row in the bins of its original values, so the
        trees, whose thresholds are bin upper bounds, go the same way;
        then the text path's writes."""
        try:
            header, offset = read_cache_header(data_filename)
        except Exception as e:   # any damage: name the file
            log.fatal("Binary file %s is a damaged lightgbm_tpu cache "
                      "(%s) — delete it to regenerate"
                      % (data_filename, e))
        reps = [BinMapper.from_bytes(b).bin_representatives()
                for b in header["mappers"]]
        used_map = header["used_feature_map"]
        num_total = int(header["num_total_features"])
        shape = tuple(header["bins_shape"])
        mm = (np.memmap(data_filename, dtype=np.dtype(header["bins_dtype"]),
                        mode="r", offset=offset, shape=shape)
              if shape[0] * shape[1] else None)
        with open(result_filename, "w") as f:
            for s in range(0, shape[1], chunk_lines):
                e = min(s + chunk_lines, shape[1])
                features = np.zeros((e - s, num_total), dtype=np.float64)
                if mm is not None:
                    for j_raw, j_inner in used_map.items():
                        features[:, j_raw] = \
                            reps[j_inner][np.asarray(mm[j_inner, s:e])]
                self._write_chunk(f, self.predict_matrix(features))
        log.info("Finished prediction, result saved to %s" % result_filename)

    @staticmethod
    def _write_chunk(f, result: np.ndarray) -> None:
        if result.ndim == 1:
            for v in result:
                f.write(_fmt(v) + "\n")
        else:
            for row in result:
                f.write("\t".join(_fmt(v) for v in row) + "\n")


def _fmt(v) -> str:
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    # std::to_string(double) prints 6 decimals
    return "%.6f" % float(v)
