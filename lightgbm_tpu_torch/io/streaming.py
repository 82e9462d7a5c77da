"""Streaming ingest: a text file or a dataset cache parsed and binned in
bounded chunks and fed to the training device, double-buffered.

The port of lightgbm_tpu/io/streaming.py.  The resident loader holds the
whole float64 feature matrix on the host (at 11M x 28, 2.5 GB); this
loader holds one chunk of ``ingest_chunk_rows`` rows and the ≤50k-row
binning sample, and gives the same dataset bit for bit:

- **pass 0** counts the data rows (``parser.count_data_rows``);
- the binning sample is the resident loader's own draw
  (``dataset.pinned_sample_indices``), gathered in file order, and
  ``find_bin`` does not depend on the sample's order;
- **pass 1** parses every chunk, keeps the labels, the in-file weight
  and query columns and the sample rows; the mappers come from the
  sample;
- **pass 2** parses and bins every chunk again, writes it to the cache
  (``CacheWriter``) when ``is_save_binary_file`` asks, and hands it to
  the ``DeviceRowWriter``.  Continued training scores each chunk with
  ``predict_fun``.

``DeviceRowWriter`` is the device step (the JAX package's ``device_put``
and donated ``dynamic_update_slice``, :138-268): a preallocated ``[F, N]``
tensor on the card (uint8, or the int16 view of uint16, ops/bins.py),
``depth`` page-locked host staging buffers, and a side CUDA stream that
copies each chunk into its column slice while the host parses and bins
the next one.  A staging buffer is reused only after the event of its
last copy has completed, and ``finish`` makes the training stream wait
on the side stream, so the first histogram cannot run before the last
chunk lands.  ``depth=0`` waits for every copy (the A/B of
chip_smoke.py phase 12).  The counts ``h2d_bytes``, ``wait_s`` (host time
blocked on a copy) and ``hidden_s`` (dispatch-to-wait gaps: copy time
that could run behind host work, an upper bound) are the JAX package's.
On the CPU (``device=cpu``) the writer copies into a CPU tensor.

With ``device=None`` the same passes land in a host matrix: the port's
two-round loader.  ``load_binary_streaming`` feeds a native cache's
memmapped matrix to the device in row chunks.  ``ingest_workers > 1``
hands the passes to byte-range worker processes
(io/parallel_ingest.py).

Telemetry, as the JAX package files it: a streamed load runs under the
``ingest`` span with ``ingest_count`` (pass 0), ``ingest_pass1``,
``ingest_bin`` (a pass-2 chunk's parse, bin and hand-off) and
``ingest_h2d`` (the writer's finish); the counters ``ingest/chunks``,
``ingest/rows``, ``ingest/parse_us``, ``ingest/bin_us``,
``ingest/h2d_us``, ``ingest/h2d_bytes``, ``ingest/h2d_wait_us``,
``ingest/overlap_hidden_us`` and the route
``ingest/double_buffer_on|off``; the flight recorder's
``record_ingest_pass`` and ``record_ingest_chunk`` events.

Under a shard draw (``rank`` of ``num_machines``, lightgbm_tpu/io/
streaming.py:333-585) every rank runs pass 0 and pass 1 over the whole
file, as the resident load parses it whole: the binning sample is the
whole file's, the mappers come from the world's ``bin_finder`` at one
point of pass 1 on every rank, and the shard is drawn after pass 1 but
before an in-file query column replaces the side file's boundaries
(:456-466); pass 2 bins only the rank's rows (:527-529) into a
``Pass2Sink`` of the shard's size, on the rank's own device
(parallel/mesh.rank_device) or, two-round, in a host matrix.  In a world
no rank writes a cache in pass 2: rank 0 writes the whole table's after
the load (io/dataset.Dataset._save_world_cache).  With ``ingest_workers
> 1`` the byte-range workers take these passes (io/parallel_ingest.py);
with one, a world's rank runs them here, where the JAX package runs the
workers' range plan in-process (io/parallel_ingest.py:115): both give
the same dataset.

Not ported: ``single_process()``, ``HostRowWriter`` and the mesh
placement (``_placement``): a JAX process may hold several devices of a
mesh, a port rank holds one (above); the ``LGBM_TPU_INGEST_SYNC``
environment switch (the port adds none: chip_smoke.py builds its writer
at depth 0 instead).
"""
from __future__ import annotations

import collections
import os
import time
from typing import List, Optional

import numpy as np
import torch

from .. import telemetry, tracing
from ..utils import log
from . import parser as parser_mod
from .dataset import (SAMPLE_CNT, _make_feature_names, cache_prefix,
                      pinned_sample_indices, read_cache_header)

# streaming=auto engages for a data or cache file of at least this size
AUTO_MIN_BYTES = 256 * 1024 * 1024


def resolve_streaming(io_config, path: str) -> bool:
    """``streaming=``: "true"/"false" force; "auto" streams ``path`` of
    at least AUTO_MIN_BYTES (lightgbm_tpu/io/streaming.py:92-103)."""
    mode = io_config.streaming
    if mode == "true":
        return True
    if mode == "false":
        return False
    try:
        return os.path.getsize(path) >= AUTO_MIN_BYTES
    except OSError:
        return False


class DeviceRowWriter:
    """The ``[F, N]`` bin matrix assembled on ``device`` from host row
    chunks, with at most ``depth`` copies in flight (module docstring).
    ``append`` returns while the chunk's copy may still be running."""

    def __init__(self, num_features: int, num_rows: int, dtype,
                 device: torch.device, depth: int = 2):
        self.device = device
        self.num_features = int(num_features)
        self.num_rows = int(num_rows)
        self.depth = int(depth)
        self.h2d_bytes = 0
        self.wait_s = 0.0
        self.hidden_s = 0.0
        self._np_dtype = np.dtype(dtype)
        self._dtype = (torch.int16 if self._np_dtype == np.uint16
                       else torch.uint8)
        self.bins = torch.empty((self.num_features, self.num_rows),
                                dtype=self._dtype, device=device)
        self._cuda = device.type == "cuda"
        telemetry.count_route("ingest", "ingest/double_buffer_on"
                              if self._cuda and self.depth > 0
                              else "ingest/double_buffer_off")
        if self._cuda:
            self._stream = torch.cuda.Stream(device)
            # the matrix was allocated on the training stream
            self._stream.wait_stream(torch.cuda.current_stream(device))
            # per slot: [pinned host buffer, device buffer], grown on need
            self._slots = [[None, None] for _ in range(max(self.depth, 1))]
            self._pending: "collections.deque" = collections.deque()
            self._next = 0

    def append(self, chunk: np.ndarray, start: int) -> None:
        """Land one ``[F, c]`` chunk at column ``start``."""
        c = chunk.shape[1]
        if c == 0:
            return
        log.check(chunk.shape[0] == self.num_features
                  and start + c <= self.num_rows
                  and chunk.dtype == self._np_dtype,
                  "DeviceRowWriter: chunk %s %s at %d does not fit [%d, %d]"
                  % (chunk.shape, chunk.dtype, start, self.num_features,
                     self.num_rows))
        if self._np_dtype == np.uint16:
            chunk = chunk.view(np.int16)
        src = torch.from_numpy(np.ascontiguousarray(chunk))
        self.h2d_bytes += chunk.nbytes
        telemetry.count("ingest/h2d_bytes", chunk.nbytes)
        if not self._cuda:
            self.bins[:, start:start + c].copy_(src)
            return
        slot_idx = self._next % len(self._slots)
        self._next += 1
        # the slot's last copy must be done before its host buffer is
        # overwritten: pending entries are in slot order, oldest first
        while any(s == slot_idx for s, _, _ in self._pending):
            self._drain_one()
        slot = self._slots[slot_idx]
        n = self.num_features * c
        if slot[0] is None or slot[0].numel() < n:
            slot[0] = torch.empty(n, dtype=self._dtype, pin_memory=True)
            with torch.cuda.stream(self._stream):
                slot[1] = torch.empty(n, dtype=self._dtype,
                                      device=self.device)
        host = slot[0][:n].view(self.num_features, c)
        host.copy_(src)
        with torch.cuda.stream(self._stream):
            dev = slot[1][:n].view(self.num_features, c)
            dev.copy_(host, non_blocking=True)
            self.bins[:, start:start + c].copy_(dev)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._pending.append((slot_idx, event, time.perf_counter()))
        while len(self._pending) > self.depth:
            self._drain_one()

    def _drain_one(self) -> None:
        _, event, t_dispatch = self._pending.popleft()
        t0 = time.perf_counter()
        event.synchronize()
        t1 = time.perf_counter()
        self.wait_s += t1 - t0
        self.hidden_s += max(0.0, t0 - t_dispatch)
        telemetry.count("ingest/h2d_wait_us", int((t1 - t0) * 1e6))
        telemetry.count("ingest/overlap_hidden_us",
                        int(max(0.0, t0 - t_dispatch) * 1e6))

    def finish(self) -> torch.Tensor:
        """The matrix, with the training stream ordered after every copy.
        The host does not wait: the staging buffers are freed through the
        caching allocators, which hold them until their copies end."""
        with telemetry.span("ingest_h2d"):
            if self._cuda:
                torch.cuda.current_stream(self.device).wait_stream(
                    self._stream)
                self._pending.clear()
                self._slots = []
            else:
                # the CPU copies ran in append: nothing waited, nothing
                # hid (filed so the derived columns have their counters)
                telemetry.count("ingest/h2d_wait_us", 0)
                telemetry.count("ingest/overlap_hidden_us", 0)
        return self.bins


class CacheWriter:
    """The native cache written during pass 2 through a memmap: the same
    bytes as ``Dataset.save_binary`` (lightgbm_tpu/io/streaming.py:
    273-317), to a temp file renamed at ``finish``."""

    def __init__(self, header: dict, bin_path: str, dtype, shape):
        self._path = bin_path
        self._tmp = bin_path + ".%d.tmp" % os.getpid()
        prefix = cache_prefix(header)
        dtype = np.dtype(dtype)
        total = int(shape[0]) * int(shape[1]) * dtype.itemsize
        with open(self._tmp, "wb") as f:
            f.write(prefix)
            if total:
                f.seek(len(prefix) + total - 1)
                f.write(b"\0")
        self._mm = (np.memmap(self._tmp, dtype=dtype, mode="r+",
                              offset=len(prefix), shape=tuple(shape))
                    if total else None)

    def write(self, chunk: np.ndarray, start: int) -> None:
        if self._mm is not None:
            self._mm[:, start:start + chunk.shape[1]] = chunk

    def finish(self) -> None:
        if self._mm is not None:
            self._mm.flush()
            self._mm = None
        os.replace(self._tmp, self._path)
        log.info("Saved binary data file to %s" % self._path)

    def abort(self) -> None:
        self._mm = None
        try:
            os.unlink(self._tmp)
        except OSError:
            pass


def finish_pass1(ds, io_config, ignore_set, header_names, sample,
                 num_cols, total_rows, labels_parts, weight_parts,
                 group_parts, used=None, bin_finder=None) -> None:
    """Everything pass 1 decides, in the resident loader's order: the
    feature names, the mappers (``bin_finder``'s, where given: every rank
    of a world calls it here, as the resident load does), the in-file
    weight and query columns, the labels; then the rank's rows ``used``
    of a shard draw (``Dataset._draw_shard_mask``, drawn before the
    query column overrides the side file's boundaries) kept of the side
    data; finalized before pass 2 (the streamed cache's header needs the
    query boundaries)."""
    ds.num_total_features = num_cols or 0
    ds.feature_names = _make_feature_names(header_names, ds.label_idx,
                                           ds.num_total_features)
    ds.used_data_indices = used
    ds._build_bin_mappers(sample, io_config.max_bin, ignore_set, bin_finder)
    if weight_parts is not None:
        log.info("using weight in data file, and ignore additional "
                 "weight file")
        ds.metadata.weights = np.concatenate(weight_parts)
    if group_parts is not None:
        log.info("using query id in data file, and ignore additional "
                 "query file")
        ds.metadata.query_boundaries = None
        ds.metadata.set_queries_from_column(np.concatenate(group_parts))
    ds.metadata.set_label(np.concatenate(labels_parts) if labels_parts
                          else np.zeros((0,), np.float32))
    ds.num_data = total_rows
    if used is not None:
        ds._partition_rows(used, total_rows)
        ds.num_data = used.size
    ds.metadata.finalize(ds.num_data)


class Pass2Sink:
    """Where pass 2's binned chunks go, in row order: the cache where
    ``write_cache`` asks (a serial load's; a world's rank 0 writes the
    whole table's after the load, io/dataset.Dataset._save_world_cache),
    the device writer (or, for two-round, a host matrix), the continued
    training scores.  It holds the rows the dataset keeps: a rank's
    shard under a draw."""

    def __init__(self, ds, io_config, predict_fun, device,
                 write_cache: bool, depth: int = 2):
        self.ds = ds
        F, N = len(ds.bin_mappers), ds.num_data
        self.dtype = ds.bin_dtype()
        if device is None:
            self.host = np.empty((F, N), dtype=self.dtype)
            self.writer = None
            self.cache = None       # two-round saves after the load
        else:
            self.host = None
            self.writer = DeviceRowWriter(F, N, self.dtype, device, depth)
            self.cache = _open_cache(ds, io_config, self.dtype, (F, N),
                                     write_cache)
        self.predict_fun = predict_fun
        self.init_scores: Optional[List[np.ndarray]] = (
            [] if predict_fun is not None else None)
        self.cursor = 0

    def commit(self, binned: np.ndarray, feats: Optional[np.ndarray]):
        n = binned.shape[1]
        if n == 0:
            return
        if self.init_scores is not None:
            self.init_scores.append(np.asarray(
                self.predict_fun(feats), np.float32).reshape(-1))
        if self.cache is not None:
            self.cache.write(binned, self.cursor)
        if self.writer is None:
            self.host[:, self.cursor:self.cursor + n] = binned
        else:
            self.writer.append(binned, self.cursor)
        self.cursor += n

    def finish(self) -> None:
        ds = self.ds
        if self.writer is None:
            ds.bins = self.host
        else:
            t0 = time.perf_counter()
            ds.device_bins = self.writer.finish()
            telemetry.count("ingest/h2d_us",
                            int((time.perf_counter() - t0) * 1e6))
            ds.bins = None
            ds.ingest_writer = self.writer
        if self.init_scores is not None:
            ds.metadata.init_score = np.concatenate(self.init_scores)
        if self.cache is not None:
            self.cache.finish()

    def abort(self) -> None:
        if self.cache is not None:
            self.cache.abort()


def load_train_streaming(ds, io_config, parser, predict_fun, weight_idx,
                         group_idx, ignore_set, header_names, device,
                         write_cache: bool = False, depth: int = 2,
                         rank: int = 0, num_machines: int = 1,
                         bin_finder=None) -> None:
    """Fill ``ds`` with the resident loader's dataset through the passes
    of the module docstring.  ``device``: the torch.device the matrix
    lands on, or None for a host matrix (two-round, always serial
    passes).  ``write_cache``: write the native cache in pass 2 (a
    serial streamed load's).  ``rank`` of ``num_machines``: the shard to
    keep, as the resident load draws it; ``bin_finder``: the world's
    mappers."""
    shard = dict(rank=rank, num_machines=num_machines,
                 bin_finder=bin_finder)
    if device is not None:
        workers = int(io_config.ingest_workers or 1)
        if workers > 1:
            from . import parallel_ingest
            if parallel_ingest.available():
                return parallel_ingest.load_train_streaming_parallel(
                    ds, io_config, parser, predict_fun, weight_idx,
                    group_idx, ignore_set, header_names, device,
                    write_cache, workers, depth, **shard)
            log.warning("ingest_workers=%d requested but no worker "
                        "interpreter can be exec'd — parsing serially"
                        % workers)
    with telemetry.span("ingest"):
        _load_serial(ds, io_config, parser, predict_fun, weight_idx,
                     group_idx, ignore_set, header_names, device,
                     write_cache, depth, **shard)


def _load_serial(ds, io_config, parser, predict_fun, weight_idx,
                 group_idx, ignore_set, header_names, device, write_cache,
                 depth, rank, num_machines, bin_finder) -> None:
    """The passes of ``load_train_streaming`` in this process; pass 2
    bins only the rows of the shard drawn after pass 1
    (lightgbm_tpu/io/streaming.py:456-466, :527-529)."""
    filename = io_config.data_filename
    chunk_rows = io_config.ingest_chunk_rows

    def chunks():
        return parser_mod.prefetch_chunks(parser_mod.read_line_chunks(
            filename, skip_header=io_config.has_header,
            chunk_lines=chunk_rows))

    t_pass = time.perf_counter()
    with telemetry.span("ingest_count"):
        total_rows = parser_mod.count_data_rows(
            filename, skip_header=io_config.has_header)
    tracing.record_ingest_pass(0, time.perf_counter() - t_pass, total_rows)
    ds.global_num_data = total_rows
    sample_idx = pinned_sample_indices(total_rows,
                                       io_config.data_random_seed,
                                       SAMPLE_CNT)
    labels_parts: List[np.ndarray] = []
    weight_parts = [] if weight_idx >= 0 else None
    group_parts = [] if group_idx >= 0 else None
    sample_parts: List[np.ndarray] = []
    sample = None
    num_cols = None
    start = 0
    t_pass = time.perf_counter()
    with telemetry.span("ingest_pass1"):
        for chunk_no, lines in enumerate(chunks()):
            t0 = time.perf_counter()
            parsed = parser.parse(lines)
            parse_us = (time.perf_counter() - t0) * 1e6
            telemetry.count("ingest/parse_us", int(parse_us))
            tracing.record_ingest_chunk(1, chunk_no, len(lines), parse_us,
                                        0.0, 0.0)
            feats = parsed.features
            num_cols = feats.shape[1]
            labels_parts.append(parsed.labels)
            if weight_parts is not None:
                weight_parts.append(feats[:, weight_idx].astype(np.float32))
            if group_parts is not None:
                group_parts.append(feats[:, group_idx].copy())
            c = feats.shape[0]
            if sample_idx is None:
                sample_parts.append(feats)
            else:
                if sample is None:
                    sample = np.empty((sample_idx.size, num_cols),
                                      np.float64)
                lo = np.searchsorted(sample_idx, start)
                hi = np.searchsorted(sample_idx, start + c)
                if hi > lo:
                    sample[lo:hi] = feats[sample_idx[lo:hi] - start]
            start += c
    tracing.record_ingest_pass(1, time.perf_counter() - t_pass, start)
    log.check(start == total_rows,
              "Input file changed between the streaming passes "
              f"(pass 0: {total_rows} rows, pass 1: {start})")
    if sample_idx is None:
        sample = (np.concatenate(sample_parts) if sample_parts
                  else np.zeros((0, 0), np.float64))
    del sample_parts
    used = ds._draw_shard_mask(io_config, rank, num_machines, total_rows)
    finish_pass1(ds, io_config, ignore_set, header_names, sample, num_cols,
                 total_rows, labels_parts, weight_parts, group_parts, used,
                 bin_finder)
    del sample
    keep = None
    if used is not None:
        keep = np.zeros(total_rows, dtype=bool)
        keep[used] = True

    sink = Pass2Sink(ds, io_config, predict_fun, device, write_cache, depth)
    start = 0
    t_pass = time.perf_counter()
    try:
        for chunk_no, lines in enumerate(chunks()):
            with telemetry.span("ingest_bin"):
                t0 = time.perf_counter()
                feats = parser.parse(lines).features
                c = feats.shape[0]
                if keep is not None:
                    feats = feats[keep[start:start + c]]
                t1 = time.perf_counter()
                binned = ds.bin_chunk(feats, sink.dtype)
                t2 = time.perf_counter()
                sink.commit(binned, feats)
                t3 = time.perf_counter()
            count_chunk(2, chunk_no, feats.shape[0], (t1 - t0) * 1e6,
                        (t2 - t1) * 1e6, (t3 - t2) * 1e6)
            start += c
        log.check(start == total_rows and sink.cursor == ds.num_data,
                  "Input file changed between the streaming passes "
                  f"(pass 1: {total_rows} rows, pass 2: {start})")
        tracing.record_ingest_pass(2, time.perf_counter() - t_pass,
                                   sink.cursor)
        sink.finish()
    except BaseException:
        sink.abort()
        raise


def count_chunk(pass_no: int, chunk_no: int, n: int, parse_us: float,
                bin_us: float, h2d_us: float, worker=None) -> None:
    """One pass-2 chunk's counters and its flight-recorder event."""
    telemetry.count("ingest/chunks")
    telemetry.count("ingest/rows", n)
    telemetry.count("ingest/parse_us", int(parse_us))
    telemetry.count("ingest/bin_us", int(bin_us))
    telemetry.count("ingest/h2d_us", int(h2d_us))
    tracing.record_ingest_chunk(pass_no, chunk_no, n, parse_us, bin_us,
                                h2d_us, worker=worker)


def _open_cache(ds, io_config, dtype, shape,
                write_cache: bool) -> Optional[CacheWriter]:
    if not write_cache:
        return None
    if io_config.save_binary_format == "reference":
        log.warning("save_binary_format=reference is not supported by "
                    "the streaming loader (the reference layout is "
                    "per-feature-major); skipping the cache write — use "
                    "streaming=false to write a reference cache")
        return None
    return CacheWriter(ds.binary_header(dtype, shape),
                       io_config.data_filename + ".bin", dtype, shape)


def load_binary_streaming(ds, path: str, io_config, device,
                          depth: int = 2) -> None:
    """A native cache fed to ``device`` in row chunks of its memmapped
    matrix, never read whole on the host
    (lightgbm_tpu/io/streaming.py:625-689)."""
    try:
        header, offset = read_cache_header(path)
    except Exception as e:   # any damage: name the file
        log.fatal("Binary file %s is a damaged lightgbm_tpu cache "
                  "(%s) — delete it to regenerate" % (path, e))
    ds.apply_binary_header(header)
    dtype = np.dtype(header["bins_dtype"])
    shape = tuple(header["bins_shape"])
    with telemetry.span("ingest"):
        writer = DeviceRowWriter(shape[0], shape[1], dtype, device, depth)
        t_pass = time.perf_counter()
        if shape[0] * shape[1]:
            mm = np.memmap(path, dtype=dtype, mode="r", offset=offset,
                           shape=shape)
            step = io_config.ingest_chunk_rows
            for chunk_no, s in enumerate(range(0, shape[1], step)):
                with telemetry.span("ingest_bin"):
                    t0 = time.perf_counter()
                    chunk = np.array(mm[:, s:s + step])
                    t1 = time.perf_counter()
                    writer.append(chunk, s)
                    t2 = time.perf_counter()
                count_chunk(2, chunk_no, chunk.shape[1], 0.0,
                            (t1 - t0) * 1e6, (t2 - t1) * 1e6)
            del mm
        tracing.record_ingest_pass(2, time.perf_counter() - t_pass,
                                   shape[1])
        t0 = time.perf_counter()
        ds.device_bins = writer.finish()
        telemetry.count("ingest/h2d_us",
                        int((time.perf_counter() - t0) * 1e6))
    ds.bins = None
    ds.ingest_writer = writer
    ds.metadata.finalize(ds.num_data)
