"""Tree model: fixed-shape arrays + reference-compatible text format.

A copy of lightgbm_tpu/models/tree.py, so the port writes and reads the
JAX package's model text byte for byte.  The node encoding is the
reference's (internal node k was created by the k-th split; leaf
references are stored bitwise-complemented, ``~leaf``; tree.cpp:50-83).

Prediction is the torch walk of models/predictor.py.

Port addition: an optional ``leaf_count`` (rows per leaf at training time,
not part of the text format) so a run can be compared tree for tree.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..utils import log


class Tree:
    """One decision tree (flat arrays, tree.h:124-149)."""

    def __init__(self, num_leaves: int,
                 split_feature: np.ndarray,       # inner feature idx [L-1]
                 split_feature_real: np.ndarray,  # original column idx [L-1]
                 threshold_bin: np.ndarray,       # [L-1]
                 threshold: np.ndarray,           # real-valued [L-1] float64
                 split_gain: np.ndarray,          # [L-1]
                 left_child: np.ndarray,          # [L-1] (~leaf encoding)
                 right_child: np.ndarray,         # [L-1]
                 leaf_parent: np.ndarray,         # [L]
                 leaf_value: np.ndarray,          # [L] float64
                 leaf_count: Optional[np.ndarray] = None):  # [L] int32
        self.num_leaves = int(num_leaves)
        self.leaf_count = (None if leaf_count is None else
                           np.asarray(leaf_count, np.int32)[:num_leaves])
        n = self.num_leaves
        self.split_feature = np.asarray(split_feature, dtype=np.int32)[:n - 1]
        self.split_feature_real = np.asarray(split_feature_real,
                                             dtype=np.int32)[:n - 1]
        self.threshold_bin = np.asarray(threshold_bin, dtype=np.int32)[:n - 1]
        self.threshold = np.asarray(threshold, dtype=np.float64)[:n - 1]
        self.split_gain = np.asarray(split_gain, dtype=np.float64)[:n - 1]
        self.left_child = np.asarray(left_child, dtype=np.int32)[:n - 1]
        self.right_child = np.asarray(right_child, dtype=np.int32)[:n - 1]
        self.leaf_parent = np.asarray(leaf_parent, dtype=np.int32)[:n]
        self.leaf_value = np.asarray(leaf_value, dtype=np.float64)[:n]

    def shrinkage(self, rate: float) -> None:
        """Scale leaf outputs by the learning rate (tree.h:94-98)."""
        self.leaf_value = self.leaf_value * rate

    # ------------------------------------------------------------ text form

    def to_string(self) -> str:
        """Tree::ToString (tree.cpp:111-130) — same keys, same order."""
        n = self.num_leaves
        lines = [
            f"num_leaves={n}",
            "split_feature=" + " ".join(str(int(x)) for x in self.split_feature_real),
            "split_gain=" + " ".join(_num_to_str(x) for x in self.split_gain),
            "threshold=" + " ".join(_num_to_str(x) for x in self.threshold),
            "left_child=" + " ".join(str(int(x)) for x in self.left_child),
            "right_child=" + " ".join(str(int(x)) for x in self.right_child),
            "leaf_parent=" + " ".join(str(int(x)) for x in self.leaf_parent),
            "leaf_value=" + " ".join(_num_to_str(x) for x in self.leaf_value),
            "",
        ]
        return "\n".join(lines) + "\n"

    @classmethod
    def from_string(cls, text: str) -> "Tree":
        """Tree::Tree(const std::string&) (tree.cpp:132-180)."""
        key_vals = {}
        for line in text.split("\n"):
            if "=" in line:
                key, val = line.split("=", 1)
                key, val = key.strip(), val.strip()
                if key and val:
                    key_vals[key] = val
        required = ("num_leaves", "split_feature", "split_gain", "threshold",
                    "left_child", "right_child", "leaf_parent", "leaf_value")
        for key in required:
            if key not in key_vals:
                log.fatal("tree model string format error")
        n = int(key_vals["num_leaves"])

        def ints(key, cnt):
            vals = [int(x) for x in key_vals[key].split()] if cnt > 0 else []
            return np.array(vals[:cnt], dtype=np.int32)

        def floats(key, cnt):
            vals = [float(x) for x in key_vals[key].split()] if cnt > 0 else []
            return np.array(vals[:cnt], dtype=np.float64)

        split_feature_real = ints("split_feature", n - 1)
        return cls(
            num_leaves=n,
            split_feature=split_feature_real,  # inner == real after load
            split_feature_real=split_feature_real,
            threshold_bin=np.zeros(max(n - 1, 0), dtype=np.int32),
            threshold=floats("threshold", n - 1),
            split_gain=floats("split_gain", n - 1),
            left_child=ints("left_child", n - 1),
            right_child=ints("right_child", n - 1),
            leaf_parent=ints("leaf_parent", n),
            leaf_value=floats("leaf_value", n),
        )


def _num_to_str(x) -> str:
    """Number formatting compatible with C++ ostream double output."""
    x = float(x)
    if x == float("inf"):
        return "inf"
    if x == float("-inf"):
        return "-inf"
    if x != x:
        return "nan"
    return repr(x)
