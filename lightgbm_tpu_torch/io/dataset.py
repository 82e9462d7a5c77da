"""Dataset: loading and binning, and the bin matrix as a tensor.

A copy of lightgbm_tpu/io/dataset.py's single-process loads, so the port
bins a table exactly as the JAX package does: the same ≤50k-row binning
sample, trivial and ignored feature removal and ``[F, N]`` bin matrix
(uint8 up to 256 bins a feature, uint16 up to 65,536; ``_bin_dtype``).
``load_train`` dispatches as the JAX package does (:81-302):

1. ``data=`` itself a native cache (``BINARY_MAGIC``);
2. a ``<data>.bin`` sibling: ours, corrupt (a ``Fatal``), or foreign (a
   reference-LightGBM cache, read and never overwritten);
3. streaming (``streaming=auto|true``, io/streaming.py): the bin matrix
   fed to the training device in chunks, and held nowhere else;
4. two-round (``use_two_round_loading``): the streamed passes into a
   host matrix;
5. resident: the whole text parsed, then binned.

Every route gives the resident load's mappers, bin bytes and metadata.
The JAX package's two-round loader draws its binning sample with an
algorithm-R reservoir, which above 50,000 rows is not the resident
sample; the port's draws the resident sample (ROADMAP C5).  Columns are
chosen by index or ``name:`` (``_resolve_columns``): the label, an
in-file weight and query-id column, ignored columns; with ``has_header``
the header names the features (``_make_feature_names``).  Both cache
formats are written byte for byte as the JAX package writes them:
``save_binary`` (pickled header + raw matrix) and
``save_binary_reference`` (the reference's own layout).  Continued
training scores each text row with ``predict_fun``.  A load runs under
the ``ingest`` telemetry span, whatever its route.  ``to_device``
places the bin matrix, labels and weights on the training device.

Not ported: the distributed shard draw and re-shard
(``_draw_shard_mask``, ``_reshard_rows``) and the ``rank`` and
``num_machines`` arguments, which belong to the parallel learners
(ROADMAP A9); uint32 bin matrices (refused by name).
"""
from __future__ import annotations

import os
import pickle
import struct
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..device import resolve_device
from ..ops.bins import to_tensor as bins_to_tensor
from ..utils import log
from . import parser as parser_mod
from .binning import BinMapper, bin_features, plan_feature_packing
from .metadata import Metadata

SAMPLE_CNT = 50000  # dataset.cpp:219 — max rows sampled for bin finding
BINARY_MAGIC = b"LGBM_TPU_BIN_V1"   # the native cache's first bytes


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


def pinned_sample_indices(total_rows: int, seed: int,
                          sample_cnt: int = SAMPLE_CNT
                          ) -> Optional[np.ndarray]:
    """The resident loader's binning sample: sorted ``choice(total_rows,
    sample_cnt)`` of a fresh ``RandomState(seed)``, or None when every
    row is the sample (lightgbm_tpu/io/streaming.py:320-331).  One rule
    for every route, so each reproduces the resident mappers."""
    if total_rows <= sample_cnt:
        return None
    rng = np.random.RandomState(seed)
    return np.sort(rng.choice(total_rows, sample_cnt, replace=False))


class Dataset:
    """Binned dataset.

    bins : np.ndarray uint8 or uint16 [num_features, num_data], or None
        for a streamed load, whose matrix is ``device_bins`` alone
        (``read_bins`` reads either)
    device_bins : torch.Tensor [num_features, num_data] on the training
        device (uint8, or the int16 view of uint16), streamed loads only
    bin_mappers : per used feature
    num_bins : np.ndarray int32 [num_features]
    real_feature_idx : used feature -> original column (split_feature_real)
    """

    def __init__(self):
        self.data_filename = ""
        self.bins: Optional[np.ndarray] = None
        self.device_bins: Optional[torch.Tensor] = None
        # a booster packed device_bins into its own copy and released them
        self.device_bins_consumed = False
        # a streamed load's io/streaming.DeviceRowWriter, kept for its
        # counts (h2d_bytes, wait_s, hidden_s)
        self.ingest_writer = None
        self.bin_mappers: List[BinMapper] = []
        self.num_bins = np.zeros(0, dtype=np.int32)
        self.real_feature_idx = np.zeros(0, dtype=np.int32)
        self.used_feature_map: Dict[int, int] = {}
        self.num_total_features = 0
        self.feature_names: List[str] = []
        self.metadata = Metadata()
        self.label_idx = 0
        self.num_data = 0
        self.global_num_data = 0
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
            idx = pinned_sample_indices(features.shape[0], seed, sample_cnt)
            self._build_bin_mappers(
                features if idx is None else features[idx], max_bin, set())
        self.metadata.set_label(np.asarray(labels, dtype=np.float32))
        if weights is not None:
            self.metadata.weights = np.asarray(weights, dtype=np.float32)
        if query_boundaries is not None:
            self.metadata.query_boundaries = np.asarray(query_boundaries,
                                                        dtype=np.int32)
            self.metadata.load_query_weights()
        self._binarize(features)
        self.global_num_data = self.num_data
        self.metadata.finalize(self.num_data)
        return self

    # ------------------------------------------------------------------ load

    @classmethod
    def load_train(cls, io_config, predict_fun: Optional[Callable] = None,
                   device=None) -> "Dataset":
        """LoadTrainData (dataset.cpp:420-465), dispatched as the module
        docstring says.  ``predict_fun(features)`` scores every text row
        (continued training).  ``device``: where a streamed load lands
        its bin matrix, "cuda" by default (a ``Fatal`` without a card) or
        "cpu"; the other routes keep it on the host.  Every route runs
        under the ``ingest`` telemetry span (the JAX package spans only
        its streamed routes; their sub-spans and counters are
        io/streaming.py's)."""
        with telemetry.span("ingest"):
            return cls._load_train(io_config, predict_fun, device)

    @classmethod
    def _load_train(cls, io_config, predict_fun, device) -> "Dataset":
        from . import streaming
        self = cls()
        self.data_filename = io_config.data_filename
        self.max_bin = io_config.max_bin

        # data= itself a native cache: no text sibling needed
        if os.path.exists(io_config.data_filename):
            kind = self._classify_binary_cache(io_config.data_filename)
            if kind == "ours":
                self._load_cache(io_config.data_filename, io_config, device,
                                 direct=True)
                return self
            if kind == "corrupt":
                log.fatal("Binary file %s is a corrupt/truncated "
                          "lightgbm_tpu cache — delete it to regenerate"
                          % io_config.data_filename)

        bin_path = io_config.data_filename + ".bin"
        foreign_bin = False
        if os.path.exists(bin_path):
            kind = self._classify_binary_cache(bin_path)
            if kind == "ours":
                self._load_cache(bin_path, io_config, device, direct=False)
                return self
            if kind == "corrupt":
                log.fatal("Binary file %s is a corrupt/truncated "
                          "lightgbm_tpu cache — delete it to regenerate"
                          % bin_path)
            # a reference-LightGBM cache beside the data file: read it,
            # and never overwrite it
            foreign_bin = True
            try:
                log.info("Loading data set from reference-format binary "
                         "file")
                self._load_reference_binary(bin_path)
            except (ValueError, struct.error) as e:
                self.__dict__.update(cls().__dict__)
                self.data_filename = io_config.data_filename
                self.max_bin = io_config.max_bin
                if not os.path.exists(io_config.data_filename):
                    log.fatal("Binary file %s is neither a lightgbm_tpu "
                              "cache nor a readable reference-LightGBM "
                              "cache (%s), and the text data file %s does "
                              "not exist"
                              % (bin_path, e, io_config.data_filename))
                log.warning("Binary file %s could not be parsed as a "
                            "reference-LightGBM cache (%s) — re-binning "
                            "from the text file (the file is left "
                            "untouched)" % (bin_path, e))
            else:
                # the reference cache stores the label data, not its
                # column: recover a configured label_column
                self.label_idx = _label_idx_without_text_load(io_config)
                self._attach_init_score(io_config.input_init_score)
                return self
            if io_config.is_save_binary_file:
                log.warning("is_save_binary_file requested but %s is a "
                            "foreign file — NOT overwriting it; delete "
                            "or move it to let lightgbm_tpu write its own"
                            % bin_path)

        label_idx, weight_idx, group_idx, ignore_set, header_names = \
            _resolve_columns(io_config)
        self.label_idx = label_idx
        self.metadata.init_from_files(io_config.data_filename,
                                      io_config.input_init_score)
        parser = parser_mod.create_parser(io_config.data_filename,
                                          io_config.has_header, 0, label_idx)
        columns = (weight_idx, group_idx, ignore_set, header_names)
        if streaming.resolve_streaming(io_config, io_config.data_filename):
            if io_config.use_two_round_loading:
                log.info("streaming supersedes use_two_round_loading")
            streaming.load_train_streaming(
                self, io_config, parser, predict_fun, *columns,
                device=resolve_device(device), foreign_bin=foreign_bin)
            self.metadata.finalize(self.num_data)
            return self
        if io_config.use_two_round_loading:
            # the streamed passes into a host matrix: never the whole
            # float64 feature matrix on the host
            streaming.load_train_streaming(
                self, io_config, parser, predict_fun, *columns,
                device=None, foreign_bin=foreign_bin)
        else:
            self._load_resident(io_config, parser, predict_fun, *columns)
        self.metadata.finalize(self.num_data)
        if io_config.is_save_binary_file and not foreign_bin:
            self._save_binary_as(io_config, bin_path)
        return self

    def _load_resident(self, io_config, parser, predict_fun, weight_idx,
                       group_idx, ignore_set, header_names) -> None:
        """The one-round load (lightgbm_tpu/io/dataset.py:242-302)."""
        lines = parser_mod.read_lines(io_config.data_filename,
                                      skip_header=io_config.has_header)
        parsed = parser.parse(lines)
        del lines
        features = parsed.features
        self.global_num_data = features.shape[0]
        idx = pinned_sample_indices(features.shape[0],
                                    io_config.data_random_seed)
        self.num_total_features = features.shape[1]
        self.feature_names = _make_feature_names(
            header_names, self.label_idx, self.num_total_features)
        self._build_bin_mappers(features if idx is None else features[idx],
                                io_config.max_bin, ignore_set)
        # in-file weight and query columns override the side files
        # (dataset.cpp:536-545)
        if weight_idx >= 0:
            log.info("using weight in data file, and ignore additional "
                     "weight file")
            self.metadata.weights = features[:, weight_idx].astype(
                np.float32)
        if group_idx >= 0:
            log.info("using query id in data file, and ignore additional "
                     "query file")
            self.metadata.query_boundaries = None
            self.metadata.set_queries_from_column(features[:, group_idx])
        self.metadata.set_label(parsed.labels)
        self._binarize(features)
        self.metadata.finalize(self.num_data)
        self._attach_init_score_values(features, predict_fun)

    def _load_cache(self, path: str, io_config, device,
                    direct: bool) -> None:
        """A native cache (``direct``: given as ``data=``, else the
        ``<data>.bin`` sibling), streamed onto ``device`` where
        ``streaming`` resolves so for the cache file, else read whole."""
        from . import streaming
        if streaming.resolve_streaming(io_config, path):
            log.info("Loading data set from binary file (streamed%s)"
                     % (", direct" if direct else ""))
            streaming.load_binary_streaming(self, path, io_config,
                                            resolve_device(device))
        else:
            log.info("Loading data set from binary file%s"
                     % (" (direct)" if direct else ""))
            self._load_binary(path)
        self._attach_init_score(io_config.input_init_score)

    def _save_binary_as(self, io_config, bin_path: str) -> None:
        """``save_binary_format``: "native" or "reference"."""
        if io_config.save_binary_format == "reference":
            self.save_binary_reference(bin_path)
        else:
            self.save_binary(bin_path)

    @classmethod
    def load_valid(cls, train: "Dataset", filename: str,
                   predict_fun: Optional[Callable] = None,
                   io_config=None) -> "Dataset":
        """LoadValidationData (dataset.cpp:467-511): binned with the
        training set's mappers; its own weight and query side files, or
        in-file weight and query columns and a header as ``io_config``
        names them (lightgbm_tpu/io/dataset.py:502-548); its rows scored
        by ``predict_fun`` when given."""
        self = cls()
        self.data_filename = filename
        self.max_bin = train.max_bin
        self.label_idx = train.label_idx
        self.num_total_features = train.num_total_features
        self.feature_names = train.feature_names
        self._share_mappers(train)
        has_header = bool(io_config.has_header) if io_config else False
        weight_idx = group_idx = -1
        if io_config is not None and (io_config.weight_column
                                      or io_config.group_column):
            import dataclasses
            cfg = dataclasses.replace(io_config, data_filename=filename)
            _, weight_idx, group_idx, _, _ = _resolve_columns(cfg)
        self.metadata.init_from_files(filename)
        parser = parser_mod.create_parser(filename, has_header, 0,
                                          train.label_idx)
        parsed = parser.parse(parser_mod.read_lines(filename,
                                                    skip_header=has_header))
        features = parsed.features
        if 0 <= weight_idx < features.shape[1]:
            self.metadata.weights = features[:, weight_idx].astype(
                np.float32)
        if 0 <= group_idx < features.shape[1]:
            self.metadata.query_boundaries = None
            self.metadata.set_queries_from_column(features[:, group_idx])
        if features.shape[1] < self.num_total_features:
            pad = np.zeros((features.shape[0],
                            self.num_total_features - features.shape[1]))
            features = np.concatenate([features, pad], axis=1)
        self.global_num_data = features.shape[0]
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

    def _attach_init_score(self, path: str) -> None:
        """A cache load's ``input_init_score`` file (a cache has no raw
        rows for ``predict_fun`` to score)."""
        if path:
            self.metadata._load_init_score(path)

    def _share_mappers(self, train: "Dataset") -> None:
        self.used_feature_map = dict(train.used_feature_map)
        self.bin_mappers = train.bin_mappers
        self.real_feature_idx = train.real_feature_idx
        self.num_bins = train.num_bins

    def _build_bin_mappers(self, sample: np.ndarray, max_bin: int,
                           ignore_set) -> None:
        """A mapper for every column outside ``ignore_set``, then trivial
        and ignored feature removal (dataset.cpp:275-350)."""
        for j in range(sample.shape[1]):
            if j in ignore_set:
                continue
            m = BinMapper()
            m.find_bin(sample[:, j], max_bin)
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

    def bin_chunk(self, features: np.ndarray, dtype) -> np.ndarray:
        """Quantize [n, raw features] values into [F, n] bins."""
        return bin_features(self.bin_mappers, self.used_feature_map,
                            features, dtype)

    def bin_dtype(self):
        return _bin_dtype(int(self.num_bins.max())
                          if len(self.bin_mappers) else 256)

    def _binarize(self, features: np.ndarray) -> None:
        """Quantize the dense value matrix into the [F, N] bin matrix."""
        self.num_data = features.shape[0]
        self.bins = self.bin_chunk(features, self.bin_dtype())

    @property
    def num_features(self) -> int:
        return len(self.bin_mappers)

    def read_bins(self) -> np.ndarray:
        """The [F, N] bin matrix on the host: the resident one, or a
        streamed one read back from its device (uint16 for 16-bit
        bins)."""
        if self.bins is not None:
            return self.bins
        log.check(self.device_bins is not None,
                  "this streamed dataset's bin matrix was consumed by a "
                  "mixed-bin GBDT.init — reload the dataset")
        out = self.device_bins.cpu().numpy()
        return out.view(np.uint16) if out.dtype == np.int16 else out

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
        dataset uploads once; a streamed one is there already)."""
        key = str(device)
        if key not in self._device_cache:
            md = self.metadata
            if self.bins is not None:
                bins = bins_to_tensor(self.bins, device)
            else:
                log.check(self.device_bins is not None,
                          "this streamed dataset's bin matrix was consumed "
                          "by a mixed-bin GBDT.init — reload the dataset "
                          "to train another booster on it")
                bins = self.device_bins.to(device)
            self._device_cache[key] = {
                "bins": bins,
                "label": torch.from_numpy(md.label).to(device),
                "weights": (None if md.weights is None else
                            torch.from_numpy(md.weights).to(device)),
            }
        return self._device_cache[key]

    # ---------------------------------------------------------- binary cache

    def binary_header(self, bins_dtype, bins_shape) -> dict:
        """The native cache's pickled header (lightgbm_tpu/io/dataset.py:
        673-692): the same keys, order and types, so the two packages
        write the same bytes.  Shared by ``save_binary`` and the streamed
        cache writer (io/streaming.CacheWriter)."""
        return {
            "num_data": self.num_data,
            "global_num_data": self.global_num_data,
            "num_total_features": self.num_total_features,
            "label_idx": self.label_idx,
            "feature_names": self.feature_names,
            "used_feature_map": self.used_feature_map,
            "max_bin": self.max_bin,
            "mappers": [m.to_bytes() for m in self.bin_mappers],
            "bins_dtype": str(np.dtype(bins_dtype)),
            "bins_shape": tuple(bins_shape),
            "label": self.metadata.label,
            "weights": self.metadata.weights,
            "query_boundaries": self.metadata.query_boundaries,
        }

    def save_binary(self, path: str) -> None:
        """The native cache (dataset.cpp:653-713's role): magic, pickled
        header, raw bin matrix; written to a temp file and renamed."""
        log.check(self.bins is not None,
                  "save_binary needs a host-resident bin matrix (a "
                  "streamed dataset writes its cache during ingestion — "
                  "set is_save_binary_file at load time)")
        header = self.binary_header(self.bins.dtype, self.bins.shape)
        _atomic_write(path, [cache_prefix(header),
                             np.ascontiguousarray(self.bins).tobytes()])
        log.info("Saved binary data file to %s" % path)

    def save_binary_reference(self, path: str) -> None:
        """The reference's own cache layout (Dataset::SaveBinaryFile,
        dataset.cpp:653-713), dense columns only, byte for byte as
        lightgbm_tpu/io/dataset.py:721-803 writes it.  Its quirk is kept:
        the reference's reader advances by num_weights past the labels
        (metadata.cpp:313), so a file with queries and no weights is
        byte-faithful and unreadable by the reference, like its own."""
        log.check(self.bins is not None,
                  "save_binary_reference needs a host-resident bin matrix "
                  "(load with streaming=false)")
        md = self.metadata
        n = self.num_data
        weights = md.weights
        qb = md.query_boundaries
        qw = md.query_weights
        n_map = self.num_total_features
        fmap = np.full(n_map, -1, dtype=np.int32)
        for real, inner in self.used_feature_map.items():
            fmap[real] = inner
        names = list(self.feature_names)
        if len(names) < n_map:
            names += ["Column_%d" % i for i in range(len(names), n_map)]
        header = b"".join(
            [struct.pack("<Q", int(self.global_num_data or n)),
             struct.pack("<?", False),          # is_enable_sparse
             struct.pack("<iiii", int(self.max_bin), n,
                         self.num_features, n_map),
             struct.pack("<Q", n_map), fmap.tobytes()]
            + [struct.pack("<i", len(s.encode())) + s.encode()
               for s in names])
        meta = [struct.pack("<iii", n,
                            0 if weights is None else len(weights),
                            0 if qb is None else len(qb) - 1),
                np.asarray(md.label, "<f4").tobytes()]
        if weights is not None:
            meta.append(np.asarray(weights, "<f4").tobytes())
        if qb is not None:
            meta.append(np.asarray(qb, "<i4").tobytes())
            if qw is not None:
                meta.append(np.asarray(qw, "<f4").tobytes())
        meta = b"".join(meta)
        # features in real-index order, like the reference's features_
        blocks = [struct.pack("<Q", len(header)) + header,
                  struct.pack("<Q", len(meta)) + meta]
        for real in self.real_feature_idx:
            inner = self.used_feature_map[int(real)]
            m = self.bin_mappers[inner]
            vt = np.dtype(_bin_dtype(m.num_bin)).newbyteorder("<")
            blob = b"".join([
                struct.pack("<i?", int(real), False),   # dense
                struct.pack("<i?d", int(m.num_bin), bool(m.is_trivial),
                            float(m.sparse_rate)),
                np.asarray(m.bin_upper_bound, "<f8").tobytes(),
                np.ascontiguousarray(self.bins[inner]).astype(vt).tobytes(),
            ])
            blocks.append(struct.pack("<Q", len(blob)) + blob)
        _atomic_write(path, blocks)
        log.info("Saved binary data file to %s" % path)

    @staticmethod
    def _classify_binary_cache(path: str) -> str:
        """'ours' (the magic), 'corrupt' (its prefix alone: a damaged
        cache of either package) or 'foreign' (anything else, such as the
        reference's layout, which starts with a raw header size)."""
        with open(path, "rb") as f:
            head = f.read(len(BINARY_MAGIC))
        if head == BINARY_MAGIC:
            return "ours"
        if head[:8] == b"LGBM_TPU":
            return "corrupt"
        return "foreign"

    def _load_binary(self, path: str) -> None:
        try:
            header, offset = read_cache_header(path)
            with open(path, "rb") as f:
                f.seek(offset)
                bins = np.frombuffer(f.read(),
                                     dtype=np.dtype(header["bins_dtype"]))
        except log.LightGBMError:
            raise
        except Exception as e:   # any damage: name the file
            log.fatal("Binary file %s is a damaged lightgbm_tpu cache "
                      "(%s) — delete it to regenerate" % (path, e))
        self.apply_binary_header(header)
        self.bins = bins.reshape(header["bins_shape"]).copy()
        self.metadata.finalize(self.num_data)

    def apply_binary_header(self, header: dict) -> None:
        """Every field of a native cache header but the matrix (shared
        with the streamed cache reader)."""
        self.num_data = header["num_data"]
        self.global_num_data = header["global_num_data"]
        self.num_total_features = header["num_total_features"]
        self.label_idx = header["label_idx"]
        self.feature_names = header["feature_names"]
        self.used_feature_map = header["used_feature_map"]
        self.max_bin = header["max_bin"]
        self.bin_mappers = [BinMapper.from_bytes(b)
                            for b in header["mappers"]]
        self.real_feature_idx = np.array(sorted(self.used_feature_map),
                                         dtype=np.int32)
        self.num_bins = np.array([m.num_bin for m in self.bin_mappers],
                                 dtype=np.int32)
        self.metadata.set_label(header["label"])
        self.metadata.weights = header["weights"]
        self.metadata.query_boundaries = header["query_boundaries"]
        if (self.metadata.weights is not None
                and self.metadata.query_boundaries is not None):
            # finalize derives query weights only from a query column
            self.metadata.load_query_weights()

    def _load_reference_binary(self, path: str) -> None:
        """A cache written by the reference binary (SaveBinaryFile,
        dataset.cpp:653-713; lightgbm_tpu/io/dataset.py:890-1040):
        little-endian, packed; a header block (global_num_data,
        is_sparse, max_bin, num_data, num_features, num_total_features,
        the feature map, the names), a metadata block (labels, weights,
        query boundaries) and one block a feature (index, sparse flag,
        mapper, then a dense uint8/16/32 row or the sparse delta stream
        of sparse_bin.hpp:178-187, absent rows bin 0).  Raises ValueError
        on malformed input (the caller re-bins the text)."""

        def take(buf, fmt, off):
            vals = struct.unpack_from("<" + fmt, buf, off)
            return vals, off + struct.calcsize("<" + fmt)

        with open(path, "rb") as f:
            def read_block(what):
                raw = f.read(8)
                if len(raw) != 8:
                    raise ValueError("truncated at %s size" % what)
                n = struct.unpack("<Q", raw)[0]
                if n > (64 << 30):
                    raise ValueError("implausible %s size %d" % (what, n))
                blob = f.read(n)
                if len(blob) != n:
                    raise ValueError("truncated %s" % what)
                return blob

            head = read_block("header")
            (global_num_data,), off = take(head, "Q", 0)
            off += 1                                  # is_enable_sparse
            (max_bin, num_data, num_features,
             num_total_features), off = take(head, "iiii", off)
            (n_map,), off = take(head, "Q", off)
            if not (0 < num_features <= n_map
                    and num_features <= num_total_features):
                raise ValueError("inconsistent feature counts")
            off += 4 * n_map    # the map: rebuilt from each feature's index
            names = []
            for _ in range(num_total_features):
                (ln,), off = take(head, "i", off)
                if ln < 0 or off + ln > len(head):
                    raise ValueError("bad feature-name length")
                names.append(head[off:off + ln].decode("utf-8", "replace"))
                off += ln

            meta = read_block("metadata")
            (md_n, md_w, md_q), off = take(meta, "iii", 0)
            if md_n != num_data:
                raise ValueError("metadata/header row-count mismatch")
            label = np.frombuffer(meta, "<f4", md_n, off).copy()
            off += 4 * md_n
            weights = qb = None
            if md_w > 0:
                weights = np.frombuffer(meta, "<f4", md_w, off).copy()
                off += 4 * md_w
            if md_q > 0:
                qb = np.frombuffer(meta, "<i4", md_q + 1, off).copy()
                off += 4 * (md_q + 1)

            mappers: List[BinMapper] = []
            real_idx: List[int] = []
            cols: List[np.ndarray] = []
            for i in range(num_features):
                blob = read_block("feature %d" % i)
                (fidx,), off = take(blob, "i", 0)
                is_sparse = blob[off] != 0
                off += 1
                (num_bin,), off = take(blob, "i", off)
                is_trivial = blob[off] != 0
                off += 1
                (sparse_rate,), off = take(blob, "d", off)
                if not (0 < num_bin <= (1 << 24)):
                    raise ValueError("bad num_bin %d" % num_bin)
                upper = np.frombuffer(blob, "<f8", num_bin, off).copy()
                off += 8 * num_bin
                vt = ("<u1" if num_bin <= 256
                      else "<u2" if num_bin <= 65536 else "<u4")
                if not is_sparse:
                    col = np.frombuffer(blob, vt, num_data, off)
                else:
                    (nv,), off = take(blob, "i", off)
                    delta = np.frombuffer(blob, "<u1", nv + 1, off)
                    off += nv + 1
                    vals = np.frombuffer(blob, vt, nv, off)
                    pos = np.cumsum(delta[:nv].astype(np.int64))
                    if nv and pos[-1] >= num_data:
                        raise ValueError("sparse position out of range")
                    col = np.zeros(num_data, dtype=vt)
                    col[pos] = vals
                mappers.append(BinMapper(num_bin=num_bin,
                                         is_trivial=bool(is_trivial),
                                         sparse_rate=float(sparse_rate),
                                         bin_upper_bound=upper))
                real_idx.append(fidx)
                cols.append(col)

        order = np.argsort(np.asarray(real_idx, dtype=np.int64),
                           kind="stable")
        self.num_data = num_data
        self.global_num_data = int(global_num_data) or num_data
        self.num_total_features = num_total_features
        self.feature_names = names
        self.max_bin = max_bin
        self.bin_mappers = [mappers[j] for j in order]
        self.used_feature_map = {int(real_idx[j]): k
                                 for k, j in enumerate(order)}
        self.real_feature_idx = np.array(sorted(self.used_feature_map),
                                         dtype=np.int32)
        self.num_bins = np.array([m.num_bin for m in self.bin_mappers],
                                 dtype=np.int32)
        dtype = _bin_dtype(int(self.num_bins.max()))
        self.bins = np.ascontiguousarray(
            np.stack([cols[j].astype(dtype, copy=False) for j in order],
                     axis=0))
        self.metadata.set_label(label)
        self.metadata.weights = weights
        self.metadata.query_boundaries = qb
        if weights is not None and qb is not None:
            # finalize derives query weights only from a query column
            # (metadata.cpp:286-298)
            self.metadata.load_query_weights()
        self.metadata.finalize(self.num_data)


def read_cache_header(path: str) -> Tuple[dict, int]:
    """A native cache's header and the offset of its bin matrix.  The
    header is a pickle: read only caches this program or the JAX package
    wrote."""
    with open(path, "rb") as f:
        f.read(len(BINARY_MAGIC))
        size = int.from_bytes(f.read(8), "little")
        header = pickle.loads(f.read(size))
        return header, f.tell()


def cache_prefix(header: dict) -> bytes:
    """A native cache's bytes before its bin matrix: the magic, the
    header's length (8 bytes, little-endian) and the pickled header."""
    blob = pickle.dumps(header)
    return BINARY_MAGIC + len(blob).to_bytes(8, "little") + blob


def _atomic_write(path: str, parts) -> None:
    """Write the byte strings ``parts`` to a temp file and rename it over
    ``path``: a crash leaves no partial cache."""
    tmp = path + ".%d.tmp" % os.getpid()
    try:
        with open(tmp, "wb") as f:
            for part in parts:
                f.write(part)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _label_idx_without_text_load(io_config) -> int:
    """``label_column`` as an index for a cache load, where no text is
    parsed: a number directly; ``name:`` through the text header while
    the file is there (lightgbm_tpu/io/dataset.py:1043-1070)."""
    lc = io_config.label_column
    if not lc:
        return 0
    if not lc.startswith("name:"):
        try:
            return int(lc)
        except ValueError:
            log.fatal("label_column is not a number, if you want to use "
                      "column name, please add prefix \"name:\" before "
                      "column name")
    name = lc[len("name:"):]
    if io_config.has_header and os.path.exists(io_config.data_filename):
        with open(io_config.data_filename, "r") as f:
            first = f.readline().rstrip("\r\n")
        delim = "\t" if first.count("\t") > first.count(",") else ","
        names = first.split(delim)
        if name in names:
            return names.index(name)
        log.fatal("cannot find label column: %s in data file" % name)
    log.warning("label_column=%s cannot be resolved without the text "
                "file's header; keeping label_index=0 (only the saved "
                "model's label_index field is affected)" % lc)
    return 0


def _resolve_columns(io_config) -> Tuple[int, int, int, set,
                                         Optional[List[str]]]:
    """Column roles by index or ``name:`` (dataset.cpp:44-146;
    lightgbm_tpu/io/dataset.py:1073-1142).  Returns (label_idx,
    weight_idx, group_idx, ignore_set, header_names); the weight, group
    and ignored indices are in the label-removed feature space, and the
    weight and group columns are ignored as features."""
    header_names: Optional[List[str]] = None
    name2idx: Dict[str, int] = {}
    if io_config.has_header:
        with open(io_config.data_filename, "r") as f:
            first = f.readline().rstrip("\r\n")
        delim = "\t" if first.count("\t") > first.count(",") else ","
        header_names = first.split(delim)
        name2idx = {name: i for i, name in enumerate(header_names)}

    def resolve(column: str, what: str) -> int:
        if column.startswith("name:"):
            name = column[len("name:"):]
            if name in name2idx:
                log.info("use %s column as %s" % (name, what))
                return name2idx[name]
            log.fatal("cannot find %s column: %s in data file" % (what, name))
        try:
            idx = int(column)
        except ValueError:
            log.fatal("%s_column is not a number, if you want to use column "
                      "name, please add prefix \"name:\" before column name"
                      % what)
        log.info("use %d-th column as %s" % (idx, what))
        return idx

    label_idx = 0
    if io_config.label_column:
        label_idx = resolve(io_config.label_column, "label")
    if header_names is not None:
        header_names = list(header_names)
        del header_names[label_idx]

    ignore_set: set = set()
    if io_config.ignore_column:
        spec = io_config.ignore_column
        if spec.startswith("name:"):
            for name in spec[len("name:"):].split(","):
                if name not in name2idx:
                    log.fatal("cannot find column: %s in data file" % name)
                idx = name2idx[name]
                if idx > label_idx:
                    idx -= 1
                ignore_set.add(idx)
        else:
            for token in spec.split(","):
                idx = int(token)
                if idx > label_idx:
                    idx -= 1
                ignore_set.add(idx)

    weight_idx = -1
    if io_config.weight_column:
        weight_idx = resolve(io_config.weight_column, "weight")
        if weight_idx > label_idx:
            weight_idx -= 1
        ignore_set.add(weight_idx)

    group_idx = -1
    if io_config.group_column:
        group_idx = resolve(io_config.group_column, "group/query id")
        if group_idx > label_idx:
            group_idx -= 1
        ignore_set.add(group_idx)

    return label_idx, weight_idx, group_idx, ignore_set, header_names


def _make_feature_names(header_names: Optional[List[str]], label_idx: int,
                        num_total: int) -> List[str]:
    """The header's names (label removed) where it names every column,
    else ``Column_%d`` (lightgbm_tpu/io/dataset.py:1145-1149)."""
    if header_names is not None and len(header_names) >= num_total:
        return header_names[:num_total]
    return ["Column_%d" % i for i in range(num_total)]
