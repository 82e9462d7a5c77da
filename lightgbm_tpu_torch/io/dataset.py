"""Dataset: host loading and binning, and the bin matrix as a tensor.

The slice subset of lightgbm_tpu/io/dataset.py: ``from_arrays`` (:551,
same signature) and the one-round text loader (:242-302), with the same
≤50k-row binning sample, trivial-feature removal and ``[F, N]`` bin
matrix (uint8 up to 256 bins a feature, uint16 up to 65,536; ``_bin_dtype``,
:32-38), so the port bins a dataset exactly as the JAX package does.
Continued training attaches each row's initial score: the raw prediction
of the input model (``predict_fun``, lightgbm_tpu/io/dataset.py:620-626)
over the training rows and every validation set's rows, else, for the
training set, the ``input_init_score`` file.  ``to_device`` places the
bin matrix, labels and weights as tensors on the training device;
``plan_packing`` plans the mixed-bin layout of a booster's own copy of
the bin matrix.  Query boundaries stay on the host (the lambdarank
objective builds its own device tables from them).  Binary caches,
streaming and distributed sharding are outside the port.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops.bins import to_tensor as bins_to_tensor
from ..utils import log
from . import parser as parser_mod
from .binning import BinMapper, find_bins_for_matrix, plan_feature_packing
from .metadata import Metadata

SAMPLE_CNT = 50000  # dataset.cpp:219 — max rows sampled for bin finding


def _bin_dtype(max_num_bin: int):
    """lightgbm_tpu/io/dataset.py:32-38 (Bin::CreateDenseBin): uint8 up
    to 256 bins, uint16 up to 65,536.  Its uint32 matrices (a feature of
    more than 65,536 bins: ``sample_cnt`` and ``max_bin`` both above
    65,536) are not ported, and refused by name."""
    if max_num_bin <= 256:
        return np.uint8
    if max_num_bin <= 65536:
        return np.uint16
    log.fatal("a feature has %d bins: bin matrices wider than 16 bits "
              "(uint32 bins, more than 65536 bins a feature) are not "
              "ported" % max_num_bin)


class Dataset:
    """Binned dataset.

    bins : np.ndarray uint8 or uint16 [num_features, num_data]
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
        validation sets).  ``query_boundaries``: [nq + 1] row offsets of
        the queries, for lambdarank and ndcg."""
        if max_bin <= 0:
            log.fatal("max_bin should be > 0")
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
        if query_boundaries is not None:
            self.metadata.query_boundaries = np.asarray(query_boundaries,
                                                        dtype=np.int32)
            self.metadata.load_query_weights()
        self._binarize(features)
        self.metadata.finalize(self.num_data)
        return self

    @classmethod
    def load_train(cls, io_config,
                   predict_fun: Optional[Callable] = None) -> "Dataset":
        """LoadTrainData, one-round path (dataset.cpp:420-465): label in
        column 0, ``<data>.weight`` and ``<data>.query`` side files, the
        ``input_init_score`` file; ``predict_fun(features)``, when given,
        scores every row instead (continued training)."""
        self = cls()
        self.max_bin = io_config.max_bin
        self.metadata.init_from_files(io_config.data_filename,
                                      io_config.input_init_score)
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
        self._attach_init_score_values(features, predict_fun)
        return self

    @classmethod
    def load_valid(cls, train: "Dataset", filename: str,
                   has_header: bool = False,
                   predict_fun: Optional[Callable] = None) -> "Dataset":
        """LoadValidationData (dataset.cpp:467-511): binned with the
        training set's mappers; its own weight and query side files; its
        rows scored by ``predict_fun`` when given."""
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
        self._attach_init_score_values(features, predict_fun)
        return self

    # ------------------------------------------------------------ internals

    def _attach_init_score_values(self, features: np.ndarray,
                                  predict_fun) -> None:
        """Continued training: every row's score under the input model
        (dataset.cpp:546-581), as float32."""
        if predict_fun is not None:
            self.metadata.init_score = np.asarray(
                predict_fun(features), dtype=np.float32).reshape(-1)

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
        """Quantize the dense value matrix into the [F, N] bin matrix."""
        self.num_data = features.shape[0]
        dtype = _bin_dtype(int(self.num_bins.max())
                           if len(self.bin_mappers) else 256)
        bins = np.empty((len(self.bin_mappers), features.shape[0]),
                        dtype=dtype)
        for j_raw, j_inner in self.used_feature_map.items():
            bins[j_inner] = self.bin_mappers[j_inner].value_to_bin(
                features[:, j_raw]).astype(dtype)
        self.bins = bins

    @property
    def num_features(self) -> int:
        return len(self.bin_mappers)

    def plan_packing(self, mode: str = "auto"):
        """The mixed-bin layout of this dataset's per-feature bin counts
        (io/binning.plan_feature_packing), or None.  The dataset itself
        stays in canonical order: a training booster keeps its own packed
        copy of the bin matrix."""
        if not len(self.bin_mappers):
            return None
        return plan_feature_packing(self.num_bins, int(self.num_bins.max()),
                                    mode=mode)

    def bin_upper_bounds_matrix(self) -> np.ndarray:
        """[F, max_bins] float64 padded with +inf: bin -> real threshold."""
        max_b = int(self.num_bins.max()) if self.num_features else 1
        out = np.full((self.num_features, max_b), np.inf, dtype=np.float64)
        for i, m in enumerate(self.bin_mappers):
            out[i, :m.num_bin] = m.bin_upper_bound
        return out

    def to_device(self, device: torch.device) -> dict:
        """The bin matrix (16-bit bins as an int16 view, ops/bins.py),
        labels and weights as tensors on ``device`` (cached per device: a
        dataset uploads once)."""
        key = str(device)
        if key not in self._device_cache:
            md = self.metadata
            self._device_cache[key] = {
                "bins": bins_to_tensor(self.bins, device),
                "label": torch.from_numpy(md.label).to(device),
                "weights": (None if md.weights is None else
                            torch.from_numpy(md.weights).to(device)),
            }
        return self._device_cache[key]
