"""The least work of each measured layer, and the chip's peaks.

Frozen here so that a later change to the program cannot move the
yardstick.  The byte formulas are those of the port's cost model
(lightgbm_tpu_torch/costmodel.py, ``hist_cost`` :79-82 and the partition
note of ops/compact.py:160-163), which PERF.md's kernel table bounds
each kernel by:

- histogram of ``n`` rows over ``f`` columns of ``b`` bins, ``c``
  leaves: ``bin_bytes·n·f + side·n + f·b·3·c·4`` bytes, ``3·n·f`` adds;
  ``side`` 12 for the root (gradient, hessian, row mask), 9 for a child
  read from the compacted pane (gradient, hessian, validity);
- partition of a parent segment of ``cnt`` rows: ``2·R·cnt`` bytes
  (every pane row read and written once), ``cnt`` compares, with
  ``R = pane_rows(f)`` (ops/compact.py:53-57: the bin rows and 9 value
  planes, padded to 8);
- the objective: score and label read, gradient and hessian written,
  16 bytes a row; LambdaRank adds ``PAIR_FLOPS`` a document pair of
  different labels;
- the score update: leaf id read, score read and written, 12 bytes a row;
- the serving walk of a batch: its rows' int32 codes over the used
  columns read and its float32 scores written once, and the ensemble's
  node tables (four int32 a node) and leaf table (float32) read once.

A layer's least time is the larger of its bytes over the HBM bandwidth
and its operations over the float32 rate of the CUDA cores, the peaks of
one NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU datasheet, dense,
at its 700 W limit).
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 66.9e12

ROOT_SIDE = 12
PANE_SIDE = 9
OBJECTIVE_BYTES_PER_ROW = 16
SCORE_UPDATE_BYTES_PER_ROW = 12
# exp, two divisions, the ΔNDCG product, the sigmoid's terms and four
# accumulations of one pair
PAIR_FLOPS = 20


def least_s(nbytes: float, flops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def hist_cost(bin_bytes: int, n: int, f: int, b: int, c: int, side: int):
    """(bytes, adds) of one histogram (costmodel.hist_cost)."""
    return (bin_bytes * n * f + side * n + f * b * 3 * c * 4, 3 * n * f)


def pane_rows(f: int, bin_bytes: int = 1) -> int:
    r = bin_bytes * f + 9
    return -(-r // 8) * 8


def partition_cost(f: int, cnt: int, bin_bytes: int = 1):
    """(bytes, compares) of partitioning a segment of ``cnt`` rows."""
    return 2 * pane_rows(f, bin_bytes) * cnt, cnt


def node_counts(left_child, right_child, leaf_count) -> np.ndarray:
    """Rows under each internal node of a tree (children in the model's
    encoding, ``~leaf`` for a leaf)."""
    n = len(left_child)
    counts = np.zeros(n, np.int64)

    def rows(c):
        return int(leaf_count[~c]) if c < 0 else int(counts[c])

    # children are created after their parents: sum from the last node
    for k in range(n - 1, -1, -1):
        counts[k] = rows(left_child[k]) + rows(right_child[k])
    return counts


def tree_work(left_child, right_child, leaf_count, f: int, b: int,
              bin_bytes: int = 1) -> dict:
    """Least seconds of one best-first tree's histograms (the root's
    rows, then the smaller child of each split) and partitions (each
    split's parent rows)."""
    counts = node_counts(left_child, right_child, leaf_count)

    def rows(c):
        return int(leaf_count[~c]) if c < 0 else int(counts[c])

    if len(left_child) == 0:
        return {"hist_s": 0.0, "partition_s": 0.0}
    hist = [hist_cost(bin_bytes, int(counts[0]), f, b, 1, ROOT_SIDE)]
    part = []
    for k in range(len(left_child)):
        small = min(rows(left_child[k]), rows(right_child[k]))
        hist.append(hist_cost(bin_bytes, small, f, b, 1, PANE_SIDE))
        part.append(partition_cost(f, int(counts[k]), bin_bytes))
    return {"hist_s": sum(least_s(*h) for h in hist),
            "partition_s": sum(least_s(*p) for p in part)}


def objective_s(rows: int, pairs: int = 0) -> float:
    return least_s(OBJECTIVE_BYTES_PER_ROW * rows, PAIR_FLOPS * pairs)


def score_update_s(rows: int) -> float:
    return least_s(SCORE_UPDATE_BYTES_PER_ROW * rows)


def walk_bytes(rows: int, calls: int, used_columns: int, nodes: int,
               leaves: int) -> int:
    """Bytes of ``calls`` serving batches holding ``rows`` rows in all,
    over an ensemble of ``nodes`` internal nodes and ``leaves`` leaves."""
    return rows * (4 * used_columns + 4) + calls * (nodes * 16 + leaves * 4)
