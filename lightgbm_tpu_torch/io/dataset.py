"""Dataset: loading and binning, and the bin matrix as a tensor.

A copy of lightgbm_tpu/io/dataset.py's single-process loads, so the port
bins a table exactly as the JAX package does: the same ≤50k-row binning
sample, trivial and ignored feature removal and ``[F, N]`` bin matrix
(uint8 up to 256 bins a feature, uint16 up to 65,536, uint32 above;
``_bin_dtype``).
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

For the data-parallel learner, ``load_train(..., rank, num_machines,
bin_finder)`` keeps one rank's rows, by every route: the shard draw
``draw_shard`` (dataset.cpp:172-216), query-atomic where query
boundaries exist, drawn from ``data_random_seed`` over the whole file,
so the ranks' shards partition its rows; the bin mappers come from the
whole file's sample (or the world's, ``bin_finder``:
parallel/learners.distributed_bin_finder).  The text routes draw before
an in-file query column is read (its queries are cut per record); the
streamed and two-round passes draw after pass 1 and keep only the
rank's rows in pass 2 (io/streaming.py), the byte-range workers parse
only them (io/parallel_ingest.py).  A cache, native or the reference's,
is read whole and re-sharded (``_reshard_rows``, lightgbm_tpu/io/
dataset.py:868-888), query-atomic wherever the cache holds query
boundaries, an in-file column's too: for such a column a cache world's
rows are not the text world's, the JAX rule on both sides.  Unlike the
JAX package the re-shard sets ``used_data_indices``, so a world from a
cache keeps serial row order (models/gbdt.SerialRows) as the world
from text does.  ``is_pre_partition=true`` keeps every row of each
rank's own file.  ``streaming=auto`` streams a world's file as it
streams a serial one.  Every rank of a world must take the same kind
of route (a text route runs the bin finder's collective and the cache
write; ``_agree_route`` makes a disagreement a ``Fatal``, not a hang).

In a world of more than one rank (``parallel.mesh.get_num_machines``),
``is_save_binary_file`` writes one cache, the serial run's byte for
byte, by rank 0 alone (``_save_world_cache``): rank 0 gathers each data
index's rows once and writes the whole table (ROADMAP C14: every JAX
rank writes its own shard to the one path, and the last rename wins).
Under ``is_pre_partition`` each rank writes its own file's cache.
"""
from __future__ import annotations

import os
import pickle
import struct
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..device import resolve_device
from ..ops.bins import to_numpy as bins_to_numpy
from ..ops.bins import to_tensor as bins_to_tensor
from ..utils import log
from . import parser as parser_mod
from .binning import (BinMapper, bin_features, plan_feature_packing,
                      plan_feature_packing_blocked)
from .metadata import Metadata

SAMPLE_CNT = 50000  # dataset.cpp:219 — max rows sampled for bin finding
BINARY_MAGIC = b"LGBM_TPU_BIN_V1"   # the native cache's first bytes


def _bin_dtype(max_num_bin: int):
    """lightgbm_tpu/io/dataset.py:32-38 (Bin::CreateDenseBin): uint8 up
    to 256 bins, uint16 up to 65,536, uint32 above (``sample_cnt`` and
    ``max_bin`` both above 65,536; ops/bins.py carries them as int32)."""
    if max_num_bin <= 256:
        return np.uint8
    if max_num_bin <= 65536:
        return np.uint16
    return np.uint32


def draw_shard(total_rows: int, query_boundaries, seed: int, rank: int,
               num_machines: int) -> np.ndarray:
    """The rows of ``rank`` (int64, ascending): each record, or each
    query of ``query_boundaries``, goes to a rank drawn from
    ``RandomState(seed)`` (dataset.cpp:172-216)."""
    rng = np.random.RandomState(seed)
    if query_boundaries is not None:
        q_owner = rng.randint(0, num_machines,
                              size=len(query_boundaries) - 1)
        row_query = np.searchsorted(query_boundaries,
                                    np.arange(total_rows), side="right") - 1
        mask = q_owner[row_query] == rank
    else:
        mask = rng.randint(0, num_machines, size=total_rows) == rank
    return np.nonzero(mask)[0].astype(np.int64)


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

    bins : np.ndarray uint8, uint16 or uint32 [num_features, num_data],
        or None for a streamed load, whose matrix is ``device_bins`` alone
        (``read_bins`` reads either)
    device_bins : torch.Tensor [num_features, num_data] on the training
        device (uint8, or the int16 or int32 view of uint16 or uint32,
        ops/bins.py), streamed loads only
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
        # the rows this rank kept of the whole file (None: all of them),
        # and whether the draw kept whole queries (an in-file query column
        # is read after the draw, so its queries may be cut)
        self.used_data_indices: Optional[np.ndarray] = None
        self.shard_query_atomic = True
        # the whole table's (query boundaries, query weights), noted when
        # the rows are sharded (_partition_rows)
        self._table_queries = (None, None)
        # a world's cache write: bytes gathered, seconds (rank 0)
        self.world_cache: Optional[dict] = None
        self.max_bin = 256
        self._device_cache = {}

    @classmethod
    def from_arrays(cls, features: np.ndarray, labels: np.ndarray,
                    max_bin: int = 256,
                    weights: Optional[np.ndarray] = None,
                    query_boundaries: Optional[np.ndarray] = None,
                    sample_cnt: int = SAMPLE_CNT,
                    seed: int = 1,
                    reference: Optional["Dataset"] = None,
                    rank: int = 0, num_machines: int = 1) -> "Dataset":
        """Build from in-memory arrays (lightgbm_tpu/io/dataset.py:551).
        ``reference``: a training Dataset whose bin mappers are reused (for
        validation sets).  ``query_boundaries``: [nq + 1] row offsets of
        the queries, for lambdarank and ndcg.  ``rank`` of
        ``num_machines``: keep that data-parallel shard of the rows, drawn
        as ``load_train`` draws it with ``seed`` as the data seed, the
        mappers from every row's sample (module docstring)."""
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
        total = features.shape[0]
        if num_machines > 1:
            self.shard_query_atomic = query_boundaries is not None
            self.used_data_indices = draw_shard(
                total, self.metadata.query_boundaries, seed, rank,
                num_machines)
            features = features[self.used_data_indices]
            self.metadata.partition(self.used_data_indices, total)
        self._binarize(features)
        self.global_num_data = total
        self.metadata.finalize(self.num_data)
        return self

    # ------------------------------------------------------------------ load

    @classmethod
    def load_train(cls, io_config, predict_fun: Optional[Callable] = None,
                   device=None, rank: int = 0, num_machines: int = 1,
                   bin_finder: Optional[Callable] = None) -> "Dataset":
        """LoadTrainData (dataset.cpp:420-465), dispatched as the module
        docstring says.  ``predict_fun(features)`` scores every text row
        (continued training).  ``device``: where a streamed load lands
        its bin matrix, "cuda" by default (a ``Fatal`` without a card) or
        "cpu" (in a world the rank's own device,
        parallel/mesh.rank_device); the other routes keep it on the host.
        ``rank`` of ``num_machines``: the data-parallel shard to keep, by
        every route (module docstring); ``bin_finder(sample, max_bin)``:
        every column's mappers, in place of local finding.  In a world
        every rank calls it at the same point.  Every route runs
        under the ``ingest`` telemetry span (the JAX package spans only
        its streamed routes; their sub-spans and counters are
        io/streaming.py's)."""
        with telemetry.span("ingest"):
            return cls._load_train(io_config, predict_fun, device, rank,
                                   num_machines, bin_finder)

    @classmethod
    def _load_train(cls, io_config, predict_fun, device, rank=0,
                    num_machines=1, bin_finder=None) -> "Dataset":
        from ..parallel import mesh
        from . import streaming
        self = cls()
        self.data_filename = io_config.data_filename
        self.max_bin = io_config.max_bin
        shard = (rank, num_machines, io_config.is_pre_partition,
                 io_config.data_random_seed)
        world = mesh.get_num_machines() > 1

        # data= itself a native cache: no text sibling needed
        if os.path.exists(io_config.data_filename):
            kind = self._classify_binary_cache(io_config.data_filename)
            if kind == "ours":
                self._load_cache(io_config.data_filename, io_config, device,
                                 True, shard)
                self._agree_route("native cache (direct)")
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
                self._load_cache(bin_path, io_config, device, False, shard)
                self._agree_route("native cache")
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
                self._reshard_rows(*shard)
                self._agree_route("reference cache")
                return self
            if io_config.is_save_binary_file:
                log.warning("is_save_binary_file requested but %s is a "
                            "foreign file — NOT overwriting it; delete "
                            "or move it to let lightgbm_tpu write its own"
                            % bin_path)

        write = io_config.is_save_binary_file and not foreign_bin
        if write and num_machines > 1 and not world:
            log.fatal("is_save_binary_file=true under num_machines=%d needs "
                      "a world (torch.distributed): its rank 0 writes the "
                      "whole table's cache, and no process group is up"
                      % num_machines)
        stream = streaming.resolve_streaming(io_config,
                                             io_config.data_filename)
        route = ("streamed text" if stream else "two-round text"
                 if io_config.use_two_round_loading else "resident text")
        self._agree_route(route, text=True, writes=write)
        label_idx, weight_idx, group_idx, ignore_set, header_names = \
            _resolve_columns(io_config)
        self.label_idx = label_idx
        self.metadata.init_from_files(io_config.data_filename,
                                      io_config.input_init_score)
        parser = parser_mod.create_parser(io_config.data_filename,
                                          io_config.has_header, 0, label_idx)
        columns = (weight_idx, group_idx, ignore_set, header_names)
        passes = dict(rank=rank, num_machines=num_machines,
                      bin_finder=bin_finder)
        if stream:
            if io_config.use_two_round_loading:
                log.info("streaming supersedes use_two_round_loading")
            on = resolve_device(device)
            # a serial load writes its cache in pass 2
            streaming.load_train_streaming(
                self, io_config, parser, predict_fun, *columns,
                device=mesh.rank_device(on) if world else on,
                write_cache=write and not world, **passes)
        elif io_config.use_two_round_loading:
            # the streamed passes into a host matrix: never the whole
            # float64 feature matrix on the host
            streaming.load_train_streaming(
                self, io_config, parser, predict_fun, *columns,
                device=None, **passes)
        else:
            self._load_resident(io_config, parser, predict_fun, *columns,
                                rank, num_machines, bin_finder)
        self.metadata.finalize(self.num_data)
        if write and world:
            self._save_world_cache(io_config, bin_path, rank)
        elif write and not stream:
            self._save_binary_as(io_config, bin_path)
        return self

    def _agree_route(self, route: str, text: bool = False,
                     writes: bool = False) -> None:
        """Every rank of a world takes one kind of route: a cache (no
        collective) or a text load (the bin finder's collective; with
        ``writes``, the cache write's).  A rank on another kind would
        hang its peers, so a disagreement is a ``Fatal`` on every rank.
        One object exchange over the world; nothing without one."""
        from ..parallel import mesh
        if mesh.get_num_machines() <= 1:
            return
        routes = mesh.all_gather_object((route, (text, writes)))
        if len({k for _, k in routes}) > 1:
            log.fatal("the ranks of this world take different load routes "
                      "(%s): every rank must load a cache, or every rank "
                      "text, each writing a cache or none"
                      % ", ".join("rank %d %s%s" % (r, name,
                                                   " + cache write"
                                                   if k[1] else "")
                                  for r, (name, k) in enumerate(routes)))

    def _load_resident(self, io_config, parser, predict_fun, weight_idx,
                       group_idx, ignore_set, header_names, rank: int = 0,
                       num_machines: int = 1, bin_finder=None) -> None:
        """The one-round load (lightgbm_tpu/io/dataset.py:242-302), of
        ``rank``'s shard of ``num_machines`` (module docstring)."""
        lines = parser_mod.read_lines(io_config.data_filename,
                                      skip_header=io_config.has_header)
        parsed = parser.parse(lines)
        del lines
        features = parsed.features
        total_rows = features.shape[0]
        self.global_num_data = total_rows
        self.used_data_indices = self._draw_shard_mask(
            io_config, rank, num_machines, total_rows)
        idx = pinned_sample_indices(total_rows, io_config.data_random_seed)
        self.num_total_features = features.shape[1]
        self.feature_names = _make_feature_names(
            header_names, self.label_idx, self.num_total_features)
        self._build_bin_mappers(features if idx is None else features[idx],
                                io_config.max_bin, ignore_set, bin_finder)
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
        used = self.used_data_indices
        if used is not None:
            features = features[used]
            self._partition_rows(used, total_rows)
        self._binarize(features)
        self.metadata.finalize(self.num_data)
        self._attach_init_score_values(features, predict_fun)

    def _load_cache(self, path: str, io_config, device, direct: bool,
                    shard: tuple) -> None:
        """A native cache (``direct``: given as ``data=``, else the
        ``<data>.bin`` sibling), streamed onto ``device`` where
        ``streaming`` resolves so for the cache file, else read whole.
        Under a shard draw (``shard``: rank, num_machines,
        is_pre_partition, seed) it is always read whole and re-sharded
        (lightgbm_tpu/io/dataset.py:118, :145), its initial scores with
        its rows."""
        from . import streaming
        if shard[1] <= 1 and streaming.resolve_streaming(io_config, path):
            log.info("Loading data set from binary file (streamed%s)"
                     % (", direct" if direct else ""))
            streaming.load_binary_streaming(self, path, io_config,
                                            resolve_device(device))
        else:
            log.info("Loading data set from binary file%s"
                     % (" (direct)" if direct else ""))
            self._load_binary(path)
        self._attach_init_score(io_config.input_init_score)
        self._reshard_rows(*shard)

    def _reshard_rows(self, rank: int, num_machines: int,
                      is_pre_partition: bool, seed: int) -> None:
        """A cache's rows re-sharded for a world (lightgbm_tpu/io/
        dataset.py:868-888, dataset.cpp:840-872): ``draw_shard`` over the
        cached rows with the text routes' seed, query-atomic wherever the
        cache holds query boundaries (module docstring).  Unlike the JAX
        package it sets ``used_data_indices``: the rows keep their place
        in serial order."""
        if num_machines <= 1 or is_pre_partition:
            return
        total = self.num_data
        qb = self.metadata.query_boundaries
        self.shard_query_atomic = qb is not None
        used = draw_shard(total, qb, seed, rank, num_machines)
        self.used_data_indices = used
        self.bins = np.ascontiguousarray(self.bins[:, used])
        self._partition_rows(used, total)
        self.num_data = used.size
        self.metadata.finalize(self.num_data)

    def _partition_rows(self, used: np.ndarray, total: int) -> None:
        """Keep the rows ``used`` of the side data (Metadata.partition, an
        in-file query column's ids with them), after noting the whole
        table's query boundaries and query weights as a serial load
        finalizes them: a world's cache writes them
        (``_save_world_cache``)."""
        md = self.metadata
        self._table_queries = (None, None)
        if md.queries is not None or md.query_boundaries is not None:
            whole = Metadata()
            whole.weights, whole.queries = md.weights, md.queries
            whole.query_boundaries = md.query_boundaries
            whole.query_weights = md.query_weights
            whole.finalize(total)
            self._table_queries = (whole.query_boundaries,
                                   whole.query_weights)
        if md.queries is not None:
            md.queries = md.queries[used]
        md.partition(used, total)

    def _draw_shard_mask(self, io_config, rank: int, num_machines: int,
                         total_rows: int) -> Optional[np.ndarray]:
        """The rows ``rank`` keeps of ``total_rows`` (lightgbm_tpu/io/
        dataset.py:313-336, dataset.cpp:172-216): each record, or each
        query where the side file gives query boundaries, goes to a rank
        drawn from ``RandomState(data_random_seed)``.  None: every row
        (one rank, or ``is_pre_partition``).  Sets
        ``shard_query_atomic``: an in-file query column is read after the
        draw, so its queries are cut per record."""
        if num_machines <= 1 or io_config.is_pre_partition:
            return None
        qb = self.metadata.query_boundaries
        self.shard_query_atomic = qb is not None
        return draw_shard(total_rows, qb, io_config.data_random_seed, rank,
                          num_machines)

    def _save_world_cache(self, io_config, bin_path: str, rank: int) -> None:
        """``is_save_binary_file`` in a world (module docstring).  An
        exchange of every rank's data index (or, under
        ``is_pre_partition``, its cache path) is the barrier before the
        write: no rank is still choosing its route when ``<data>.bin``
        appears.  Then rank 0 gathers each data index's host bins,
        labels, weights and ``used_data_indices`` from the lowest rank
        holding it, places them in serial order with the whole table's
        query boundaries, and writes the serial run's cache
        (``_save_binary_as``); under ``is_pre_partition`` each rank writes
        its own file's (two ranks naming one path is a ``Fatal``).  An
        exchange of each rank's outcome is the barrier after it: no rank
        goes on before the file is whole, and a failed write is a
        ``Fatal`` on every rank."""
        from ..parallel import mesh
        me = mesh.get_rank()
        t0 = time.perf_counter()
        error = None
        if io_config.is_pre_partition:
            paths = mesh.all_gather_object(os.path.abspath(bin_path))
            if len(set(paths)) < len(paths):
                log.fatal("is_save_binary_file with is_pre_partition=true: "
                          "ranks name one cache path (%s); each rank's file "
                          "needs its own" % ", ".join(sorted(set(paths))))
            try:
                self._save_binary_as(io_config, bin_path)
            except Exception as e:
                error = "%s: %s" % (type(e).__name__, e)
        else:
            owners = mesh.all_gather_object(rank)
            first = owners.index(rank) == me
            parts = mesh.gather_object(
                (self.used_data_indices, self.read_bins(),
                 self.metadata.label, self.metadata.weights)
                if first else None)
            if me == 0:
                try:
                    t1 = time.perf_counter()
                    table, nbytes = self._table_from(
                        [p for p in parts if p is not None])
                    table._save_binary_as(io_config, bin_path)
                    self.world_cache = {
                        "gather_bytes": nbytes, "gather_s": t1 - t0,
                        "write_s": time.perf_counter() - t1}
                    log.info("Gathered the world's %d rows (%d bytes) in "
                             "%.3f s for the cache %s"
                             % (table.num_data, nbytes, t1 - t0, bin_path))
                except Exception as e:
                    error = "%s: %s" % (type(e).__name__, e)
        errors = mesh.all_gather_object(error)
        failed = [(r, e) for r, e in enumerate(errors) if e]
        if failed:
            log.fatal("writing the world's cache %s failed: %s" % (
                bin_path, "; ".join("rank %d %s" % f for f in failed)))

    def _table_from(self, parts) -> Tuple["Dataset", int]:
        """The whole table from each data index's (used_data_indices,
        bins, labels, weights), in serial order (a part without indices
        holds every row: ``feature``, one data shard), as a Dataset
        sharing this one's mappers and names; and the bytes of
        ``parts``.  The arrays are new, of this process's dtypes: the
        cache header pickles them, and a dtype unpickled from a peer is
        another object to pickle's memo than the serial run's."""
        nbytes = sum(a.nbytes for p in parts for a in p if a is not None)
        total = self.global_num_data
        held = sum(total if p[0] is None else p[0].size for p in parts)
        log.check(held == total, "the world's shards hold %d of the "
                  "table's %d rows" % (held, total))
        table = Dataset()
        table.__dict__.update({k: v for k, v in self.__dict__.items()
                               if k not in ("bins", "device_bins",
                                            "metadata", "_device_cache",
                                            "ingest_writer")})
        table._device_cache = {}
        bins = np.empty((parts[0][1].shape[0], total),
                        dtype=np.dtype(parts[0][1].dtype.name))
        label = np.empty(total, dtype=np.float32)
        weights = (None if parts[0][3] is None
                   else np.empty(total, dtype=np.float32))
        for used, b, lab, w in parts:
            used = slice(None) if used is None else used
            bins[:, used] = b
            label[used] = lab
            if weights is not None:
                weights[used] = w
        md = table.metadata = Metadata()
        md.query_boundaries, md.query_weights = (
            (self.metadata.query_boundaries, self.metadata.query_weights)
            if self.used_data_indices is None else self._table_queries)
        md.set_label(label)
        md.weights = weights
        table.bins = bins
        table.num_data = total
        table.used_data_indices = None
        return table, nbytes

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
                           ignore_set, bin_finder=None) -> None:
        """A mapper for every column outside ``ignore_set`` (from
        ``bin_finder``, which maps every column, where given), then
        trivial and ignored feature removal (dataset.cpp:275-350)."""
        found = (bin_finder(sample, max_bin) if bin_finder is not None
                 else None)
        for j in range(sample.shape[1]):
            if j in ignore_set:
                continue
            if found is not None:
                m = found[j]
            else:
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
        streamed one read back from its device (uint16 or uint32 for
        16-bit or 32-bit bins)."""
        if self.bins is not None:
            return self.bins
        log.check(self.device_bins is not None,
                  "this streamed dataset's bin matrix was consumed by a "
                  "mixed-bin GBDT.init — reload the dataset")
        return bins_to_numpy(self.device_bins)

    def plan_packing(self, mode: str = "auto", block: int = 0,
                     shards: int = 0):
        """The mixed-bin layout of this dataset's per-feature bin counts
        (io/binning.plan_feature_packing), or None.  ``block`` > 0: the
        block-local layout of ownership blocks of that width over
        ``shards`` feature shards (plan_feature_packing_blocked; the
        hybrid and voting learners, lightgbm_tpu/io/dataset.py:636-661).
        The dataset itself stays in canonical order: a training booster
        keeps its own packed copy of the bin matrix."""
        if not len(self.bin_mappers):
            return None
        if block > 0:
            return plan_feature_packing_blocked(
                self.num_bins, int(self.num_bins.max()), block, mode=mode,
                shards=shards)
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
        """The bin matrix (16-bit or 32-bit bins as an int16 or int32
        view, ops/bins.py), labels and weights as tensors on ``device``
        (cached per device: a dataset uploads once; a streamed one is
        there already)."""
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
