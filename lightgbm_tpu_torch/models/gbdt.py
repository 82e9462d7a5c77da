"""GBDT boosting loop, in torch — the serial per-iteration subset of
lightgbm_tpu/models/gbdt.py.

Ported: ``init``, ``add_valid_dataset``, ``train_one_iter`` (:1141-1319
without sampling, health, telemetry or pipelining), ``run_training``'s
per-iteration loop, ``output_metric``, ``save_model_to_file``,
``models_from_string``, ``from_model_file``, ``predict_raw`` /
``predict`` and ``feature_importance``.  Every tree grows through the
compacted leaf-wise grower (models/grower_leafcompact.py), which is what
``leafwise_compact=auto`` resolves to on an accelerator in the JAX
package.  The fused chunk programs, the deferred-readback pipeline,
checkpoints and the elastic and health monitors are outside this slice.

The score is a [1, N] f32 tensor on the training device; gradients,
histograms, partitions and score updates run there, and the host holds
the trees and the metrics.
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.scoring import add_tree_score, train_score_update
from ..utils import log
from .grower_leafcompact import grow_tree_leafcompact
from .predictor import predict_raw_scores
from .tree import Tree


class GBDT:
    def __init__(self):
        self.models: List[Tree] = []
        self.num_class = 1
        self.label_idx = 0
        self.max_feature_idx = 0
        self.sigmoid = -1.0
        self.iter = 0
        self.train_data = None
        self.objective = None
        self.training_metrics = []
        self.valid_datasets = []
        self.valid_metrics = []
        self.device = None
        self._saved_model_size = -1
        self._model_file = None

    # ------------------------------------------------------------------ init

    def init(self, boosting_config, train_data, objective,
             training_metrics=(), device=None) -> None:
        """GBDT::Init (gbdt.cpp:41-89).  ``device``: "cuda" (default; a
        Fatal when there is no card) or "cpu"."""
        self.device = resolve_device(device)
        self.gbdt_config = boosting_config
        self.tree_config = boosting_config.tree_config
        self.train_data = train_data
        self.objective = objective
        self.training_metrics = list(training_metrics)
        self.max_feature_idx = train_data.num_total_features - 1
        self.label_idx = train_data.label_idx
        self.sigmoid = objective.sigmoid if objective is not None else -1.0
        self.num_data = train_data.num_data
        self.num_bins_max = int(train_data.num_bins.max())
        self._bin_upper_table = train_data.bin_upper_bounds_matrix()
        t = train_data.to_device(self.device)
        self.bins_device = t["bins"]
        self.num_bins_device = torch.as_tensor(train_data.num_bins,
                                               device=self.device)
        self.feature_mask = torch.ones(train_data.num_features,
                                       dtype=torch.bool, device=self.device)
        self.row_mask = torch.ones(self.num_data, dtype=torch.bool,
                                   device=self.device)
        self.score = torch.zeros((1, self.num_data), dtype=torch.float32,
                                 device=self.device)
        if self.tree_config.hist_dtype == "int8":
            # int32 accumulators: 127 x rows must not wrap (gbdt.py:42-54)
            if self.num_data > (1 << 31) // 127:
                log.fatal("hist_dtype=int8 supports at most %d rows"
                          % ((1 << 31) // 127))
        objective.init(train_data.metadata, self.num_data, self.device)
        for metric in self.training_metrics:
            metric.init("training", train_data.metadata, self.num_data)

    def add_valid_dataset(self, valid_data, valid_metrics,
                          name=None) -> None:
        """GBDT::AddDataset (gbdt.cpp:92-105)."""
        name = name or "valid_%d" % (len(self.valid_datasets) + 1)
        self.valid_datasets.append({
            "bins": valid_data.to_device(self.device)["bins"],
            "score": torch.zeros((1, valid_data.num_data),
                                 dtype=torch.float32, device=self.device),
            "name": name})
        for metric in valid_metrics:
            metric.init(name, valid_data.metadata, valid_data.num_data)
        self.valid_metrics.append(list(valid_metrics))

    # ------------------------------------------------------------- iteration

    def train_one_iter(self, is_eval: bool = True) -> bool:
        """GBDT::TrainOneIter (gbdt.cpp:167-214).  True when training must
        stop (no splittable leaf)."""
        grad, hess = self.objective.get_gradients(self.score[0])
        tc = self.tree_config
        num_leaves = tc.num_leaves
        if tc.max_depth > 0:    # config.h:159-163
            num_leaves = min(num_leaves, 1 << (tc.max_depth - 1))
        tree_arrays = grow_tree_leafcompact(
            self.bins_device, grad, hess, self.row_mask, self.feature_mask,
            self.num_bins_device, num_leaves=max(num_leaves, 2),
            num_bins_max=self.num_bins_max,
            min_data_in_leaf=tc.min_data_in_leaf,
            min_sum_hessian_in_leaf=tc.min_sum_hessian_in_leaf,
            max_depth=tc.max_depth, compute_dtype=tc.hist_dtype)
        n = tree_arrays.num_leaves
        if n <= 1:
            log.info("Can't training anymore, there isn't any leaf meets "
                     "split requirements.")
            return True
        # shrinkage in f32 on the device, as the JAX package does
        lr = torch.tensor(self.gbdt_config.learning_rate,
                          dtype=torch.float32, device=self.device)
        shrunk = torch.as_tensor(tree_arrays.leaf_value,
                                 device=self.device) * lr
        self.score[0] = train_score_update(self.score[0], shrunk,
                                           tree_arrays.leaf_ids)
        for entry in self.valid_datasets:
            entry["score"][0] = add_tree_score(
                entry["bins"], entry["score"][0],
                tree_arrays.split_feature[:n - 1],
                tree_arrays.threshold_bin[:n - 1],
                tree_arrays.left_child[:n - 1],
                tree_arrays.right_child[:n - 1], shrunk)
        tree = self._to_host_tree(tree_arrays)
        tree.shrinkage(self.gbdt_config.learning_rate)
        self.models.append(tree)
        if is_eval:
            self.output_metric(self.iter + 1)
        self.iter += 1
        return False

    def run_training(self, num_iterations: int, is_eval: bool,
                     save_fn: Optional[Callable] = None,
                     progress_fn: Optional[Callable] = None) -> None:
        """The per-iteration loop of Application::Train
        (application.cpp:239-257)."""
        for _ in range(num_iterations):
            finished = self.train_one_iter(is_eval=is_eval)
            if save_fn is not None:
                save_fn()
            if progress_fn is not None:
                progress_fn(self.iter)
            if finished:
                break

    def _to_host_tree(self, t) -> Tree:
        n = t.num_leaves
        sf = t.split_feature[:n - 1]
        tb = t.threshold_bin[:n - 1]
        return Tree(
            num_leaves=n, split_feature=sf,
            split_feature_real=self.train_data.real_feature_idx[sf],
            threshold_bin=tb, threshold=self._bin_upper_table[sf, tb],
            split_gain=np.asarray(t.split_gain, np.float64)[:n - 1],
            left_child=t.left_child[:n - 1],
            right_child=t.right_child[:n - 1],
            leaf_parent=t.leaf_parent[:n],
            leaf_value=np.asarray(t.leaf_value, np.float64)[:n],
            leaf_count=t.leaf_count[:n])

    # --------------------------------------------------------------- metrics

    def eval_values(self):
        """(train values, [valid values per dataset]) of the metrics."""
        train = [m.eval(self.score[0].cpu().numpy())
                 for m in self.training_metrics]
        valid = [[m.eval(e["score"][0].cpu().numpy()) for m in metrics]
                 for e, metrics in zip(self.valid_datasets,
                                       self.valid_metrics)]
        return train, valid

    def output_metric(self, iteration: int) -> bool:
        """GBDT::OutputMetric (gbdt.cpp:225-259), without early stopping."""
        freq = self.gbdt_config.output_freq
        if not (freq > 0 and iteration % freq == 0):
            return False
        train, valid = self.eval_values()
        lines = list(zip(self.training_metrics, train))
        for metrics, values in zip(self.valid_metrics, valid):
            lines += list(zip(metrics, values))
        for metric, values in lines:
            log.info("Iteration:%d, %s : %s" % (
                iteration, metric.name, " ".join(str(v) for v in values)))
        return False

    # ------------------------------------------------------------ prediction

    def predict_raw(self, features: np.ndarray,
                    num_used_model: int = -1) -> np.ndarray:
        """Batch PredictRaw (gbdt.cpp:470-479): [N] f64 raw scores from raw
        feature values, walked in torch on this booster's device."""
        if num_used_model < 0:
            num_used_model = len(self.models)
        device = self.device if self.device is not None \
            else resolve_device(None)
        return predict_raw_scores(self.models[:num_used_model], features,
                                  device)

    def predict(self, features: np.ndarray,
                num_used_model: int = -1) -> np.ndarray:
        """Predict with the sigmoid transform (gbdt.cpp:481-494)."""
        ret = self.predict_raw(features, num_used_model)
        if self.sigmoid > 0:
            ret = 1.0 / (1.0 + np.exp(-2.0 * self.sigmoid * ret))
        return ret

    # -------------------------------------------------------------- model IO

    def save_model_to_file(self, is_finish: bool, filename: str) -> None:
        """Incremental text save (gbdt.cpp:307-348), in the JAX package's
        format (lightgbm_tpu/models/gbdt.py:2605-2642) without its
        score-reference line."""
        if self._saved_model_size == -1:
            self._model_file = open(filename, "w")
            self._model_file.write(self.model_header())
            self._saved_model_size = 0
        if self._model_file is None or self._model_file.closed:
            return
        for i in range(self._saved_model_size, len(self.models)):
            self._model_file.write("Tree=%d\n" % i)
            self._model_file.write(self.models[i].to_string() + "\n")
        self._saved_model_size = len(self.models)
        self._model_file.flush()
        if is_finish:
            self._model_file.write("\n" + self.feature_importance() + "\n")
            self._model_file.close()

    def model_header(self) -> str:
        return ("gbdt\nnum_class=%d\nlabel_index=%d\nmax_feature_idx=%d\n"
                "sigmoid=%s\n\n" % (self.num_class, self.label_idx,
                                     self.max_feature_idx,
                                     repr(float(self.sigmoid))))

    def model_to_string(self) -> str:
        """The whole model file's text, as save_model_to_file writes it."""
        return (self.model_header()
                + "".join("Tree=%d\n%s\n" % (i, t.to_string())
                          for i, t in enumerate(self.models))
                + "\n" + self.feature_importance() + "\n")

    def models_from_string(self, model_str: str) -> None:
        """GBDT::ModelsFromString (gbdt.cpp:350-441)."""
        self.models = []
        lines = model_str.split("\n")

        def find_value(key):
            for line in lines:
                if key in line and "=" in line:
                    return line.split("=", 1)[1].strip()
            return None

        for key in ("num_class=", "label_index=", "max_feature_idx="):
            if find_value(key) is None:
                log.fatal("Model file doesn't contain %s" % key[:-1])
        self.num_class = int(find_value("num_class="))
        if self.num_class != 1:
            log.fatal("num_class=%d models are not supported by "
                      "lightgbm_tpu_torch (outside the ported slice)"
                      % self.num_class)
        self.label_idx = int(find_value("label_index="))
        self.max_feature_idx = int(find_value("max_feature_idx="))
        sigmoid = find_value("sigmoid=")
        self.sigmoid = float(sigmoid) if sigmoid is not None else -1.0
        i = 0
        while i < len(lines):
            if "Tree=" in lines[i]:
                i += 1
                start = i
                while i < len(lines) and "Tree=" not in lines[i]:
                    i += 1
                self.models.append(Tree.from_string(
                    "\n".join(lines[start:i])))
            else:
                i += 1
        log.info("%d models has been loaded" % len(self.models))

    @classmethod
    def from_model_file(cls, filename: str, device=None) -> "GBDT":
        """Boosting::CreateBoosting from file (boosting.cpp:6-57)."""
        if not os.path.exists(filename):
            log.fatal("Model file %s doesn't exist" % filename)
        with open(filename, "r") as f:
            content = f.read()
        first_line = content.split("\n", 1)[0].strip()
        if first_line != "gbdt":
            log.fatal("Unknown boosting type %s" % first_line)
        self = cls()
        self.device = resolve_device(device)
        self.models_from_string(content)
        return self

    def feature_importance(self) -> str:
        """Split-count importances (gbdt.cpp:443-468)."""
        importances = np.zeros(self.max_feature_idx + 1, dtype=np.int64)
        for tree in self.models:
            for f in tree.split_feature_real:
                importances[f] += 1
        names = (self.train_data.feature_names
                 if self.train_data is not None
                 else ["Column_%d" % i
                       for i in range(self.max_feature_idx + 1)])
        pairs = sorted(zip(importances, names), key=lambda p: -p[0])
        out = ["", "feature importances:"]
        out += ["%s=%d" % (name, cnt) for cnt, name in pairs]
        return "\n".join(out) + "\n"
