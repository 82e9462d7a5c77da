"""Labels and weights of a dataset.

The slice subset of lightgbm_tpu/io/metadata.py: labels, per-row weights
and the ``<data>.weight`` side file (metadata.cpp:228-299).  Query
boundaries and init scores belong to objectives and features outside
this slice.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..utils import log


class Metadata:
    def __init__(self):
        self.num_data: int = 0
        self.label: Optional[np.ndarray] = None     # float32 [N]
        self.weights: Optional[np.ndarray] = None   # float32 [N]

    def init_from_files(self, data_filename: str) -> None:
        path = data_filename + ".weight"
        if os.path.exists(path):
            log.info("Start loading weights")
            self.weights = np.loadtxt(path, dtype=np.float64,
                                      ndmin=1).astype(np.float32)

    def set_label(self, label: np.ndarray) -> None:
        self.label = np.asarray(label, dtype=np.float32)
        self.num_data = self.label.size

    def finalize(self, num_data: int) -> None:
        self.num_data = num_data
        if self.weights is not None and self.weights.size != num_data:
            log.fatal("Initial weight size doesn't equal to data")
