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
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .device import resolve_device
from .models.gbdt import GBDT
from .models.tree import Tree

FIELDS = ("split_feature", "split_feature_real", "threshold_bin",
          "threshold", "split_gain", "left_child", "right_child",
          "leaf_parent", "leaf_value")


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
                       sigmoid: float = 1.0, device=None) -> GBDT:
    """A prediction-only port booster over ``trees``."""
    b = GBDT()
    b.models = list(trees)
    b.max_feature_idx = int(max_feature_idx)
    b.sigmoid = float(sigmoid)
    b.device = resolve_device(device)
    return b
