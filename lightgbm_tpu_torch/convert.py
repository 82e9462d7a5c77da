"""Carrying trained weights between the JAX package and the port.

Two carriers:

- ``trees_from_numpy(list_of_dicts)``: trees as numpy arrays keyed by the
  JAX package's ``Tree`` attribute names (``split_feature``,
  ``split_feature_real``, ``threshold``, ``threshold_bin``,
  ``left_child``, ``right_child``, ``leaf_parent``, ``leaf_value``, and
  optionally ``split_gain``, ``leaf_count``, ``num_leaves``) become the
  port's trees; ``trees_to_numpy`` goes the other way.
- the model text file, in both directions: both packages write and read
  the same format (``GBDT.save_model_to_file`` / ``from_model_file``);
  ``booster_from_trees`` wraps trees into a port booster that can save it.

``flat_from_numpy`` builds the port's ``serving.FlatEnsemble`` from the
arrays of the JAX package's (its attribute names, ``FLAT_FIELDS``), so
the port can serve the very tables the JAX package flattened.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .device import resolve_device
from .models.gbdt import GBDT
from .models.tree import Tree
from .serving import FlatEnsemble

FIELDS = ("split_feature", "split_feature_real", "threshold_bin",
          "threshold", "split_gain", "left_child", "right_child",
          "leaf_parent", "leaf_value")
FLAT_FIELDS = ("used", "thresholds", "split_feature", "threshold_rank",
               "left_child", "right_child", "leaf_value", "num_leaves",
               "root_state", "tree_class", "max_nodes", "max_depth",
               "num_class")


def trees_from_numpy(trees: List[Dict[str, np.ndarray]]) -> List[Tree]:
    out = []
    for d in trees:
        n = int(d.get("num_leaves", len(d["leaf_value"])))
        sf = np.asarray(d["split_feature"])
        out.append(Tree(
            num_leaves=n, split_feature=sf,
            split_feature_real=np.asarray(d.get("split_feature_real", sf)),
            threshold_bin=np.asarray(d.get("threshold_bin",
                                           np.zeros(len(sf), np.int32))),
            threshold=np.asarray(d["threshold"]),
            split_gain=np.asarray(d.get("split_gain",
                                        np.zeros(len(sf), np.float64))),
            left_child=np.asarray(d["left_child"]),
            right_child=np.asarray(d["right_child"]),
            leaf_parent=np.asarray(d["leaf_parent"]),
            leaf_value=np.asarray(d["leaf_value"]),
            leaf_count=d.get("leaf_count")))
    return out


def trees_to_numpy(trees: List[Tree]) -> List[Dict[str, np.ndarray]]:
    return [dict({k: np.array(getattr(t, k)) for k in FIELDS},
                 num_leaves=t.num_leaves) for t in trees]


def booster_from_trees(trees: List[Tree], max_feature_idx: int,
                       sigmoid: float = 1.0, device=None,
                       num_class: int = 1) -> GBDT:
    """A prediction-only port booster over ``trees``; with K = num_class
    > 1, tree i belongs to class i % K."""
    b = GBDT()
    b.num_class = int(num_class)
    b.models = list(trees)
    b.max_feature_idx = int(max_feature_idx)
    b.sigmoid = float(sigmoid)
    b.device = resolve_device(device)
    return b


def flat_from_numpy(d: Dict) -> FlatEnsemble:
    """A port FlatEnsemble from a JAX FlatEnsemble's arrays, keyed by
    ``FLAT_FIELDS``: numpy node and leaf tables, the sorted used columns
    and their float64 threshold tables."""
    arr = lambda k, dt: np.array(d[k], dtype=dt)  # noqa: E731
    return FlatEnsemble(
        [int(f) for f in d["used"]],
        {int(f): np.array(v, np.float64) for f, v in d["thresholds"].items()},
        arr("split_feature", np.int32), arr("threshold_rank", np.int32),
        arr("left_child", np.int32), arr("right_child", np.int32),
        arr("leaf_value", np.float32), arr("num_leaves", np.int32),
        arr("root_state", np.int32), arr("tree_class", np.int32),
        int(d["max_nodes"]), int(d["max_depth"]), int(d["num_class"]))
