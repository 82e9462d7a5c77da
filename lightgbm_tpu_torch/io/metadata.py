"""Labels, weights, query boundaries and initial scores of a dataset.

The port's subset of lightgbm_tpu/io/metadata.py: labels, per-row
weights, the ``<data>.weight`` and ``<data>.query`` side files
(metadata.cpp:228-299), query weights (the per-query mean of the row
weights, recomputed by a cache reader whose file carries weights and
queries), the initial scores of an ``input_init_score`` file (one value
per line), an in-file query-id column (``set_queries_from_column``,
turned into boundaries by ``finalize``) and the ``finalize`` size
checks; and for the data-parallel learner, ``partition`` (a rank's
rows of the side data, metadata.cpp:130-212) and ``global_view`` (the
world's labels, weights and query layout in rank order, for metrics).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..utils import log


class Metadata:
    def __init__(self):
        self.num_data: int = 0
        self.label: Optional[np.ndarray] = None             # float32 [N]
        self.weights: Optional[np.ndarray] = None           # float32 [N]
        self.query_boundaries: Optional[np.ndarray] = None  # int32 [nq+1]
        self.query_weights: Optional[np.ndarray] = None     # float32 [nq]
        self.init_score: Optional[np.ndarray] = None        # float32 [N]
        self.queries: Optional[np.ndarray] = None           # raw query ids

    def init_from_files(self, data_filename: str,
                        init_score_filename: str = "") -> None:
        self._load_query_boundaries(data_filename + ".query")
        path = data_filename + ".weight"
        if os.path.exists(path):
            log.info("Start loading weights")
            self.weights = np.loadtxt(path, dtype=np.float64,
                                      ndmin=1).astype(np.float32)
        self.load_query_weights()
        if init_score_filename:
            self._load_init_score(init_score_filename)

    def _load_init_score(self, path: str) -> None:
        log.info("Start loading initial scores")
        self.init_score = np.loadtxt(path, dtype=np.float64,
                                     ndmin=1).astype(np.float32)

    def _load_query_boundaries(self, path: str) -> None:
        """One document count per line -> boundaries [nq + 1]."""
        if not os.path.exists(path):
            return
        log.info("Start loading query boundries")
        counts = np.loadtxt(path, dtype=np.int64, ndmin=1)
        boundaries = np.zeros(counts.size + 1, dtype=np.int32)
        boundaries[1:] = np.cumsum(counts)
        self.query_boundaries = boundaries

    def load_query_weights(self) -> None:
        """Per-query mean of record weights (metadata.cpp:285-299)."""
        if self.weights is None or self.query_boundaries is None:
            return
        log.info("Start loading query weights")
        nq = self.query_boundaries.size - 1
        qw = np.zeros(nq, dtype=np.float32)
        for i in range(nq):
            lo, hi = self.query_boundaries[i], self.query_boundaries[i + 1]
            qw[i] = self.weights[lo:hi].mean() if hi > lo else 0.0
        self.query_weights = qw

    def partition(self, used_indices: np.ndarray, num_all_data: int) -> None:
        """Keep this rank's rows of the side data (metadata.cpp:130-212;
        lightgbm_tpu/io/metadata.py:127-153): weights, initial scores and
        labels by row; query boundaries of the queries the rows hold,
        which a query-atomic shard holds whole."""
        used_indices = np.asarray(used_indices)
        if self.weights is not None:
            if self.weights.size != num_all_data:
                log.fatal("Initial weights size doesn't equal to data")
            self.weights = self.weights[used_indices]
        if self.query_boundaries is not None:
            if self.query_boundaries[-1] != num_all_data:
                log.fatal("Initial query size doesn't equal to data")
            row_query = np.searchsorted(self.query_boundaries, used_indices,
                                        side="right") - 1
            _, counts = np.unique(row_query, return_counts=True)
            boundaries = np.zeros(counts.size + 1, dtype=np.int32)
            boundaries[1:] = np.cumsum(counts)
            self.query_boundaries = boundaries
            self.load_query_weights()
        if self.init_score is not None:
            if self.init_score.size != num_all_data:
                log.fatal("Initial score size doesn't equal to data")
            self.init_score = self.init_score[used_indices]
        if self.label is not None:
            self.label = self.label[used_indices]
        self.num_data = used_indices.size

    def global_view(self, gather_rows) -> "Metadata":
        """The world's metadata from this rank's (lightgbm_tpu/io/
        metadata.py:70-97): ``gather_rows(local) -> global`` places every
        rank's row-aligned array in the world's row order
        (models.gbdt.SerialRows.gather_host).  Shards are query-atomic
        and a query's rows are consecutive, so a flag on each query's
        first row, gathered alike, marks the global boundaries.  Metrics
        over it and the scores gathered in the same order are the serial
        run's."""
        g = Metadata()
        if self.label is not None:
            g.set_label(gather_rows(self.label))
        if self.weights is not None:
            g.weights = gather_rows(self.weights)
        if self.query_boundaries is not None:
            qb = self.query_boundaries
            first = np.zeros(self.num_data, dtype=np.int8)
            first[qb[:-1][np.diff(qb) > 0]] = 1
            starts = np.flatnonzero(gather_rows(first))
            boundaries = np.empty(starts.size + 1, dtype=np.int32)
            boundaries[:-1] = starts
            boundaries[-1] = g.label.size if g.label is not None else 0
            g.query_boundaries = boundaries
            g.load_query_weights()
        g.num_data = 0 if g.label is None else g.label.size
        return g

    def set_label(self, label: np.ndarray) -> None:
        self.label = np.asarray(label, dtype=np.float32)
        self.num_data = self.label.size

    def set_queries_from_column(self, queries: np.ndarray) -> None:
        """An in-file query-id column (metadata.cpp:81-106): ``finalize``
        starts a new query wherever the id changes."""
        self.queries = np.asarray(queries)

    def finalize(self, num_data: int) -> None:
        self.num_data = num_data
        if self.queries is not None:
            q = self.queries
            change = np.nonzero(q[1:] != q[:-1])[0] + 1
            starts = np.concatenate(([0], change, [q.size]))
            self.query_boundaries = starts.astype(np.int32)
            self.load_query_weights()
            self.queries = None
        if self.weights is not None and self.weights.size != num_data:
            log.fatal("Initial weight size doesn't equal to data")
        if (self.query_boundaries is not None
                and self.query_boundaries[-1] != num_data):
            log.fatal("Initial query size doesn't equal to data")
        if self.init_score is not None and self.init_score.size != num_data:
            log.fatal("Initial score size doesn't equal to data")
