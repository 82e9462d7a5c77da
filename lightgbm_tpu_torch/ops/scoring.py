"""Score updates from a grown tree, in torch.

``add_tree_score`` is the counterpart of lightgbm_tpu/ops/scoring.py:341
(Tree::AddPredictionToScore on a binned matrix): replay the tree's splits
in creation order to assign every row its leaf, then add that leaf's
value.  The training score needs no replay — the grower returns each
row's leaf id — and is a plain gather (``train_score_update``).  The JAX
package's byte-split lookups (ops/lookup.py) work around slow TPU gathers
and have no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch


def split_leaf_sequence(left_child: np.ndarray,
                        right_child: np.ndarray) -> np.ndarray:
    """Leaf id split by each node, in creation order: node k split leaf
    split_leaf[k] into (that leaf, k+1); a left edge keeps its parent's
    leaf id, a right edge carries parent+1 (models/tree.py)."""
    n = len(left_child)
    parent = np.full(n, -1, np.int64)
    is_left = np.zeros(n, bool)
    for k in range(n):
        if left_child[k] >= 0:
            parent[left_child[k]], is_left[left_child[k]] = k, True
        if right_child[k] >= 0:
            parent[right_child[k]] = k
    out = np.zeros(n, np.int64)
    for k in range(1, n):
        p = parent[k]
        out[k] = out[p] if is_left[k] else p + 1
    return out


def leaf_ids_by_replay(bins, split_feature, threshold_bin, left_child,
                       right_child) -> torch.Tensor:
    """[N] int64 leaf of every row of a binned [F, N] matrix."""
    leaf = torch.zeros(bins.shape[1], dtype=torch.int64, device=bins.device)
    split_leaf = split_leaf_sequence(np.asarray(left_child),
                                     np.asarray(right_child))
    for k in range(len(split_leaf)):
        go_right = bins[int(split_feature[k])] > int(threshold_bin[k])
        leaf = torch.where((leaf == int(split_leaf[k])) & go_right, k + 1,
                           leaf)
    return leaf


def add_tree_score(bins, score, split_feature, threshold_bin, left_child,
                   right_child, leaf_value) -> torch.Tensor:
    """score + tree(bins): ``leaf_value`` [L] f32 tensor (already shrunk);
    the split arrays are host arrays of length L-1."""
    leaf = leaf_ids_by_replay(bins, split_feature, threshold_bin,
                              left_child, right_child)
    return score + leaf_value[leaf]


def train_score_update(score, leaf_value, leaf_ids) -> torch.Tensor:
    """score + leaf_value[leaf_ids] — the training rows' leaves come from
    the grower, so the update is one gather."""
    return score + leaf_value[leaf_ids.long()]
