"""Dataset: host loading and binning, and the bin matrix as a tensor.

The slice subset of lightgbm_tpu/io/dataset.py: ``from_arrays`` (:551,
same signature) and the one-round text loader (:242-302), with the same
≤50k-row binning sample, trivial-feature removal and uint8 ``[F, N]`` bin
matrix, so the port bins a dataset exactly as the JAX package does.
``to_device`` places the bin matrix, labels and weights as tensors on the
training device.  Binary caches, streaming and distributed sharding are
outside this slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils import log
from . import parser as parser_mod
from .binning import BinMapper, find_bins_for_matrix
from .metadata import Metadata

SAMPLE_CNT = 50000  # dataset.cpp:219 — max rows sampled for bin finding


class Dataset:
    """Binned dataset.

    bins : np.ndarray uint8 [num_features, num_data]
    bin_mappers : per used feature
    num_bins : np.ndarray int32 [num_features]
    real_feature_idx : used feature -> original column (split_feature_real)
    """

    def __init__(self):
        self.bins: Optional[np.ndarray] = None
        self.bin_mappers: List[BinMapper] = []
        self.num_bins = np.zeros(0, dtype=np.int32)
        self.real_feature_idx = np.zeros(0, dtype=np.int32)
        self.used_feature_map: Dict[int, int] = {}
        self.num_total_features = 0
        self.feature_names: List[str] = []
        self.metadata = Metadata()
        self.label_idx = 0
        self.num_data = 0
        self.max_bin = 256
        self._device_cache = {}

    @classmethod
    def from_arrays(cls, features: np.ndarray, labels: np.ndarray,
                    max_bin: int = 256,
                    weights: Optional[np.ndarray] = None,
                    query_boundaries: Optional[np.ndarray] = None,
                    sample_cnt: int = SAMPLE_CNT,
                    seed: int = 1,
                    reference: Optional["Dataset"] = None) -> "Dataset":
        """Build from in-memory arrays (lightgbm_tpu/io/dataset.py:551).
        ``reference``: a training Dataset whose bin mappers are reused (for
        validation sets).  ``query_boundaries`` belong to ranking, outside
        this slice, and must stay None."""
        if query_boundaries is not None:
            log.fatal("query_boundaries are not supported by "
                      "lightgbm_tpu_torch (outside the ported slice)")
        if max_bin > 256:
            log.fatal("max_bin should be in (0, 256] (uint8 bin matrix)")
        self = cls()
        features = np.asarray(features, dtype=np.float64)
        self.max_bin = max_bin
        self.num_total_features = features.shape[1]
        self.feature_names = ["Column_%d" % i
                              for i in range(features.shape[1])]
        if reference is not None:
            if features.shape[1] != reference.num_total_features:
                log.fatal("valid data has different number of features")
            self._share_mappers(reference)
        else:
            rng = np.random.RandomState(seed)
            total_rows = features.shape[0]
            if total_rows > sample_cnt:
                sample = features[np.sort(rng.choice(total_rows, sample_cnt,
                                                     replace=False))]
            else:
                sample = features
            self._build_bin_mappers(sample, max_bin)
        self.metadata.set_label(np.asarray(labels, dtype=np.float32))
        if weights is not None:
            self.metadata.weights = np.asarray(weights, dtype=np.float32)
        self._binarize(features)
        self.metadata.finalize(self.num_data)
        return self

    @classmethod
    def load_train(cls, io_config) -> "Dataset":
        """LoadTrainData, one-round path (dataset.cpp:420-465): label in
        column 0, ``<data>.weight`` side file."""
        self = cls()
        self.max_bin = io_config.max_bin
        self.metadata.init_from_files(io_config.data_filename)
        parsed = self._parse(io_config.data_filename, io_config.has_header)
        features = parsed.features
        rng = np.random.RandomState(io_config.data_random_seed)
        if features.shape[0] > SAMPLE_CNT:
            sample = features[np.sort(rng.choice(features.shape[0],
                                                 SAMPLE_CNT, replace=False))]
        else:
            sample = features
        self.num_total_features = features.shape[1]
        self.feature_names = ["Column_%d" % i
                              for i in range(self.num_total_features)]
        self._build_bin_mappers(sample, io_config.max_bin)
        self.metadata.set_label(parsed.labels)
        self._binarize(features)
        self.metadata.finalize(self.num_data)
        return self

    @classmethod
    def load_valid(cls, train: "Dataset", filename: str,
                   has_header: bool = False) -> "Dataset":
        """LoadValidationData (dataset.cpp:467-511): binned with the
        training set's mappers."""
        self = cls()
        self.max_bin = train.max_bin
        self.num_total_features = train.num_total_features
        self.feature_names = train.feature_names
        self._share_mappers(train)
        self.metadata.init_from_files(filename)
        parsed = self._parse(filename, has_header)
        features = parsed.features
        if features.shape[1] < self.num_total_features:
            pad = np.zeros((features.shape[0],
                            self.num_total_features - features.shape[1]))
            features = np.concatenate([features, pad], axis=1)
        self.metadata.set_label(parsed.labels)
        self._binarize(features)
        self.metadata.finalize(self.num_data)
        return self

    # ------------------------------------------------------------ internals

    @staticmethod
    def _parse(filename: str, has_header: bool):
        parser = parser_mod.create_parser(filename, has_header, 0, 0)
        return parser.parse(parser_mod.read_lines(filename,
                                                  skip_header=has_header))

    def _share_mappers(self, train: "Dataset") -> None:
        self.used_feature_map = dict(train.used_feature_map)
        self.bin_mappers = train.bin_mappers
        self.real_feature_idx = train.real_feature_idx
        self.num_bins = train.num_bins

    def _build_bin_mappers(self, sample: np.ndarray, max_bin: int) -> None:
        """Bin mappers + trivial-feature removal (dataset.cpp:334-350)."""
        for j, m in enumerate(find_bins_for_matrix(sample, max_bin)):
            if m.is_trivial:
                log.warning("Feature %s only contains one value, will be "
                            "ignored" % self.feature_names[j])
                continue
            self.used_feature_map[j] = len(self.bin_mappers)
            self.bin_mappers.append(m)
        self.real_feature_idx = np.array(sorted(self.used_feature_map),
                                         dtype=np.int32)
        self.num_bins = np.array([m.num_bin for m in self.bin_mappers],
                                 dtype=np.int32)

    def _binarize(self, features: np.ndarray) -> None:
        """Quantize the dense value matrix into the uint8 [F, N] matrix."""
        self.num_data = features.shape[0]
        bins = np.empty((len(self.bin_mappers), features.shape[0]),
                        dtype=np.uint8)
        for j_raw, j_inner in self.used_feature_map.items():
            bins[j_inner] = self.bin_mappers[j_inner].value_to_bin(
                features[:, j_raw]).astype(np.uint8)
        self.bins = bins

    @property
    def num_features(self) -> int:
        return len(self.bin_mappers)

    def bin_upper_bounds_matrix(self) -> np.ndarray:
        """[F, max_bins] float64 padded with +inf: bin -> real threshold."""
        max_b = int(self.num_bins.max()) if self.num_features else 1
        out = np.full((self.num_features, max_b), np.inf, dtype=np.float64)
        for i, m in enumerate(self.bin_mappers):
            out[i, :m.num_bin] = m.bin_upper_bound
        return out

    def to_device(self, device: torch.device) -> dict:
        """The bin matrix, labels and weights as tensors on ``device``
        (cached per device: a dataset uploads once)."""
        key = str(device)
        if key not in self._device_cache:
            md = self.metadata
            self._device_cache[key] = {
                "bins": torch.from_numpy(self.bins).to(device),
                "label": torch.from_numpy(md.label).to(device),
                "weights": (None if md.weights is None else
                            torch.from_numpy(md.weights).to(device)),
            }
        return self._device_cache[key]
