"""Parallel ingest: the streamed passes fanned out over byte-range worker
processes.

The port of lightgbm_tpu/io/parallel_ingest.py.  ``plan_ranges`` cuts
the data bytes into ranges snapped to row starts
(``parser.split_byte_ranges``), at about four a worker and at most
``ingest_chunk_rows`` rows each; its one raw scan also counts the rows,
so it is pass 0.  Pass 1 is selective: a worker extracts the label and
the in-file weight and query columns of every row with the exact tier's
token rule (``_atof``) and full-parses only its rows of the pinned
binning sample.  Pass 2: a worker parses and bins its range.  The parent
takes the results in range order and commits them as the serial loader
does (io/streaming.Pass2Sink), so the dataset, the streamed cache and
the model are the serial loader's, bit for bit, at any worker count.

The label extraction differs from the native tier on a token such as
``1.5abc`` (0 here, 1.5 there), as in the JAX package (ROADMAP C4).

Workers are exec'd interpreters (``python -m
lightgbm_tpu_torch.io.parallel_ingest``), never forks: forking after CUDA
is initialised is unsafe, as after XLA's threads start.  ``WORKER_ENV``
makes the package skip ``import torch`` in a worker, so one starts in
milliseconds.  They speak pickle frames over stdin and stdout, persist
across passes and loads, and are registered with ``lifecycle`` while they
live; ``shutdown_workers`` reaps them, at exit too.  A worker's parser
tiers are added to the parent's ``parser.tier_calls``.

Telemetry, as the JAX package files it: the ``ingest``,
``ingest_count``, ``ingest_pass1`` and ``ingest_bin`` spans, the
``ingest/*`` counters of io/streaming.py with each range's parse and bin
microseconds measured in its worker, ``ingest/worker_wait_us`` (the
parent's time blocked on a result), and the flight recorder's pass and
chunk events tagged with the worker's pid.

Under a shard draw (``rank`` of ``num_machines``) the parent draws the
rank's rows up front (lightgbm_tpu/io/parallel_ingest.py:445-453): the
draw reads only the seed, the row count and the side file's query
boundaries, so it is the serial passes' draw.  Pass 1 runs over every
row as above; pass 2's job carries each range's owned rows
(``sel_local``, by ``searchsorted``, :562-571), and a worker parses and
bins only those.  With ``ingest_workers=1`` a world's rank runs
io/streaming.py's serial passes, where the JAX package runs this range
plan in-process (:115): the same dataset either way.
"""
from __future__ import annotations

import collections
import os
import pickle
import subprocess
import sys
import time
import traceback
from typing import List, Optional

import numpy as np

from .. import lifecycle, telemetry, tracing
from ..utils import log
from . import parser as parser_mod
from .binning import bin_features
from .parser import ZERO_THRESHOLD, _atof, _DelimitedParser

WORKER_ENV = "LIGHTGBM_TPU_TORCH_INGEST_WORKER"
# tasks in flight beyond one a worker: keeps every worker busy while the
# parent drains results in range order, and bounds the buffered results
_WINDOW_EXTRA = 2

_JOB = None             # a worker's per-pass state


def available() -> bool:
    """Workers are exec'd from ``sys.executable``."""
    return bool(sys.executable) and os.path.exists(sys.executable)


class _Job:
    """Per-pass worker state, sent to each worker as one pickle."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class _Worker:
    """One exec'd worker: pickle frames over stdin/stdout (a pickle ends
    itself, so no length prefix); its stderr passes through."""

    def __init__(self):
        env = dict(os.environ)
        env[WORKER_ENV] = "1"
        # the worker imports this package from where the parent did
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = (pkg_root + os.pathsep
                             + env.get("PYTHONPATH", "")).rstrip(os.pathsep)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "lightgbm_tpu_torch.io.parallel_ingest"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        # a 64 KB pipe would stall a worker mid-result while the parent
        # commits an earlier range; 1 MB lets it parse ahead (Linux only)
        try:
            import fcntl
            fcntl.fcntl(self.proc.stdout.fileno(),
                        getattr(fcntl, "F_SETPIPE_SZ", 1031), 1 << 20)
        except (ImportError, OSError):
            pass

    def send(self, msg) -> None:
        pickle.dump(msg, self.proc.stdin, protocol=pickle.HIGHEST_PROTOCOL)
        self.proc.stdin.flush()

    def recv(self):
        try:
            kind, payload = pickle.load(self.proc.stdout)
        except EOFError:
            raise RuntimeError("parallel ingest worker (pid %s) exited "
                               "mid-task" % self.proc.pid)
        if kind == "err":
            raise RuntimeError("parallel ingest worker task failed:\n%s"
                               % payload)
        return payload

    def close(self) -> None:
        try:
            self.send(("exit",))
            self.proc.stdin.close()
        except (OSError, ValueError):
            pass
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.proc.stdout.close()


class WorkerPool:
    """The persistent workers of this process, tracked by ``lifecycle``
    while any lives."""

    def __init__(self):
        self.workers: List[_Worker] = []
        self._atexit = False

    def get(self, n: int) -> List[_Worker]:
        self.workers = [w for w in self.workers if w.proc.poll() is None]
        while len(self.workers) < n:
            self.workers.append(_Worker())
        lifecycle.track("ingest_workers", self, self.close,
                        name="parallel_ingest")
        if not self._atexit:
            import atexit
            atexit.register(self.close)
            self._atexit = True
        return self.workers[:n]

    def close(self) -> None:
        """Stop every worker (idempotent)."""
        workers, self.workers = self.workers, []
        for w in workers:
            w.close()
        lifecycle.untrack(self)


_POOL = WorkerPool()


def shutdown_workers() -> None:
    """Reap the persistent workers; the next parallel load execs new
    ones."""
    _POOL.close()


class _Tasks:
    """One pass over the ranges: the job broadcast to each worker, tasks
    dealt round-robin, results read in submission order (each worker
    answers its stdin queue in order)."""

    def __init__(self, workers: List[_Worker], job, fn_name: str):
        self.ws = workers
        self.fn_name = fn_name
        self.outstanding = 0
        for w in self.ws:
            w.send(("job", job))

    def submit(self, ridx: int) -> _Worker:
        w = self.ws[ridx % len(self.ws)]
        w.send(("task", self.fn_name, ridx))
        self.outstanding += 1
        return w

    def results(self, n_tasks: int, window: int):
        """Results in range order, at most ``window`` tasks in flight."""
        pending: "collections.deque" = collections.deque()
        nxt = 0
        while nxt < min(window, n_tasks):
            pending.append(self.submit(nxt))
            nxt += 1
        while pending:
            t0 = time.perf_counter()
            res = pending.popleft().recv()
            telemetry.count("ingest/worker_wait_us",
                            int((time.perf_counter() - t0) * 1e6))
            self.outstanding -= 1
            if nxt < n_tasks:
                pending.append(self.submit(nxt))
                nxt += 1
            for tier, calls in res["tiers"].items():
                parser_mod.tier_calls[tier] += calls
            yield res


def plan_ranges(filename: str, skip_header: bool, workers: int,
                chunk_rows: int):
    """The snapped byte ranges (the fused pass-0 scan): byte-balanced at
    about four a worker (targets of 1-32 MB), re-split until none holds
    more than ``chunk_rows`` rows."""
    size = os.path.getsize(filename)
    d0 = parser_mod.data_byte_start(filename, skip_header)
    data_bytes = max(size - d0, 1)
    target = min(max(data_bytes // max(workers * 4, 1), 1 << 20), 32 << 20)
    k = max(workers, -(-data_bytes // target))
    ranges, counts, total = parser_mod.split_byte_ranges(
        filename, k, skip_header=skip_header)
    for _ in range(8):
        if not any(c > chunk_rows for c in counts):
            break
        cands = []
        for (s, e), c in zip(ranges, counts):
            cands.append(s)
            if c > chunk_rows:
                parts = -(-c // chunk_rows)
                cands.extend(s + ((e - s) * i) // parts
                             for i in range(1, parts))
        ranges, counts, total = parser_mod.split_byte_ranges_at(
            filename, cands[1:], skip_header=skip_header)
    return ranges, counts, total


# ------------------------------------------------------------ worker side


def _extract_column(lines, delim: str, raw_idx: int) -> np.ndarray:
    """One raw column as float64 by the exact tier's token rule."""
    if raw_idx == 0:
        toks = [ln.split(delim, 1)[0] for ln in lines]
    else:
        toks = [ln.split(delim, raw_idx + 1)[raw_idx] for ln in lines]
    return np.array([_atof(t) for t in toks], dtype=np.float64)


def _pass1_range(ridx: int) -> dict:
    job = _JOB
    t0 = time.perf_counter()
    s, e = job.ranges[ridx]
    lines = parser_mod.read_range_lines(job.filename, s, e)
    n = len(lines)
    g0 = job.offsets[ridx]
    out = {"ridx": ridx, "n": n, "pid": os.getpid()}
    local = None
    if job.sample_idx is not None:
        lo = np.searchsorted(job.sample_idx, g0)
        hi = np.searchsorted(job.sample_idx, g0 + n)
        local = job.sample_idx[lo:hi] - g0
    delim = job.delimiter
    selective = delim is not None and local is not None and n > 0
    if selective:
        n_delim = lines[0].count(delim)
        # a ragged range: the full parse gives the exact tier's error
        selective = all(ln.count(delim) == n_delim for ln in lines)
    if selective:
        ncols_raw = n_delim + 1
        li = job.label_raw
        has_label = 0 <= li < ncols_raw
        out["num_cols"] = ncols_raw - 1 if has_label else ncols_raw
        out["labels"] = (_extract_column(lines, delim, li).astype(np.float32)
                         if has_label else np.zeros(n, dtype=np.float32))
        for key, fidx in (("weight", job.weight_idx),
                          ("group", job.group_idx)):
            if fidx >= 0:
                raw = fidx + (1 if has_label and fidx >= li else 0)
                col = _extract_column(lines, delim, raw)
                # parse() zeroes tiny feature values after removing the
                # label, and pass 1 of the serial loader slices those
                col[np.abs(col) <= ZERO_THRESHOLD] = 0.0
                out[key] = col.astype(np.float32) if key == "weight" else col
        if local.size:
            out["sample"] = job.parser.parse(
                [lines[i] for i in local]).features
    else:
        parsed = job.parser.parse(lines)
        feats = parsed.features
        out["num_cols"] = feats.shape[1]
        out["labels"] = parsed.labels
        if job.weight_idx >= 0:
            out["weight"] = feats[:, job.weight_idx].astype(np.float32)
        if job.group_idx >= 0:
            out["group"] = feats[:, job.group_idx].copy()
        if local is None:
            out["sample"] = feats
        elif local.size:
            out["sample"] = feats[local]
    out["parse_us"] = (time.perf_counter() - t0) * 1e6
    return out


def _pass2_range(ridx: int) -> dict:
    job = _JOB
    t0 = time.perf_counter()
    s, e = job.ranges[ridx]
    lines = parser_mod.read_range_lines(job.filename, s, e)
    rows = len(lines)
    if job.sel_local is not None:
        lines = [lines[i] for i in job.sel_local[ridx]]
    feats = (job.parser.parse(lines).features if lines
             else np.zeros((0, job.num_cols), dtype=np.float64))
    t1 = time.perf_counter()
    binned = bin_features(job.mappers, job.used_feature_map, feats,
                          job.dtype)
    return {"ridx": ridx, "rows": rows, "n": feats.shape[0],
            "binned": binned,
            "feats": feats if job.need_feats else None,
            "pid": os.getpid(), "parse_us": (t1 - t0) * 1e6,
            "bin_us": (time.perf_counter() - t1) * 1e6}


def _worker_main() -> int:
    """The worker loop: ``("job", job)`` sets the pass's state,
    ``("task", fn_name, ridx)`` runs one range and answers ``("ok",
    result)`` or ``("err", traceback)``; ``("exit",)`` or EOF ends it.
    The protocol owns stdout; stray prints go to stderr."""
    global _JOB
    inp = sys.stdin.buffer
    out = sys.stdout.buffer
    sys.stdout = sys.stderr
    tasks = {"_pass1_range": _pass1_range, "_pass2_range": _pass2_range}
    while True:
        try:
            msg = pickle.load(inp)
        except EOFError:
            return 0
        if msg[0] == "exit":
            return 0
        if msg[0] == "job":
            _JOB = msg[1]
            continue
        before = dict(parser_mod.tier_calls)
        try:
            res = tasks[msg[1]](msg[2])
            res["tiers"] = {k: v - before[k]
                            for k, v in parser_mod.tier_calls.items()}
            reply = ("ok", res)
        except BaseException:   # reported to the parent, which raises
            reply = ("err", traceback.format_exc())
        pickle.dump(reply, out, protocol=pickle.HIGHEST_PROTOCOL)
        out.flush()


# ------------------------------------------------------------ parent side


def load_train_streaming_parallel(ds, io_config, parser, predict_fun,
                                  weight_idx, group_idx, ignore_set,
                                  header_names, device, write_cache,
                                  workers: int, depth: int = 2,
                                  rank: int = 0, num_machines: int = 1,
                                  bin_finder=None) -> None:
    """io/streaming.load_train_streaming with its passes on ``workers``
    worker processes; the same dataset, bit for bit, the rank's shard of
    ``num_machines`` under a draw (module docstring)."""
    with telemetry.span("ingest"):
        _load_parallel(ds, io_config, parser, predict_fun, weight_idx,
                       group_idx, ignore_set, header_names, device,
                       write_cache, workers, depth, rank, num_machines,
                       bin_finder)


def _load_parallel(ds, io_config, parser, predict_fun, weight_idx,
                   group_idx, ignore_set, header_names, device, write_cache,
                   workers: int, depth: int, rank: int, num_machines: int,
                   bin_finder) -> None:
    from . import streaming
    from .dataset import SAMPLE_CNT, pinned_sample_indices

    filename = io_config.data_filename
    window = workers + _WINDOW_EXTRA
    t_pass = time.perf_counter()
    with telemetry.span("ingest_count"):
        ranges, counts, total_rows = plan_ranges(
            filename, io_config.has_header, workers,
            io_config.ingest_chunk_rows)
    tracing.record_ingest_pass(0, time.perf_counter() - t_pass, total_rows)
    ds.global_num_data = total_rows
    sample_idx = pinned_sample_indices(total_rows,
                                       io_config.data_random_seed,
                                       SAMPLE_CNT)
    offsets = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    k = len(ranges)
    used = ds._draw_shard_mask(io_config, rank, num_machines, total_rows)
    pool = _POOL.get(workers)

    delim = (parser.delimiter if isinstance(parser, _DelimitedParser)
             else None)
    job = _Job(filename=filename, ranges=ranges, offsets=offsets[:-1],
               parser=parser, delimiter=delim, label_raw=parser.label_idx,
               sample_idx=sample_idx, weight_idx=weight_idx,
               group_idx=group_idx)
    labels_parts: List[np.ndarray] = []
    weight_parts = [] if weight_idx >= 0 else None
    group_parts = [] if group_idx >= 0 else None
    sample_parts: List[np.ndarray] = []
    sample: Optional[np.ndarray] = None
    num_cols = None
    start = 0
    t_pass = time.perf_counter()
    with telemetry.span("ingest_pass1"):
        tasks = _Tasks(pool, job, "_pass1_range")
        try:
            for out in tasks.results(k, window):
                n = out["n"]
                telemetry.count("ingest/parse_us", int(out["parse_us"]))
                tracing.record_ingest_chunk(1, out["ridx"], n,
                                            out["parse_us"], 0.0, 0.0,
                                            worker=out["pid"])
                g0 = int(offsets[out["ridx"]])
                num_cols = out["num_cols"]
                labels_parts.append(out["labels"])
                if weight_parts is not None:
                    weight_parts.append(out["weight"])
                if group_parts is not None:
                    group_parts.append(out["group"])
                if sample_idx is None:
                    if "sample" in out:
                        sample_parts.append(out["sample"])
                elif "sample" in out:
                    if sample is None:
                        sample = np.empty((sample_idx.size, num_cols),
                                          np.float64)
                    lo = np.searchsorted(sample_idx, g0)
                    hi = np.searchsorted(sample_idx, g0 + n)
                    sample[lo:hi] = out["sample"]
                start += n
        finally:
            if tasks.outstanding:
                shutdown_workers()   # their queues are out of step
    tracing.record_ingest_pass(1, time.perf_counter() - t_pass, start)
    log.check(start == total_rows,
              "Input file changed between the streaming passes "
              f"(pass 0: {total_rows} rows, pass 1: {start})")
    if sample_idx is None:
        sample = (np.concatenate(sample_parts) if sample_parts
                  else np.zeros((0, 0), np.float64))
    del sample_parts
    streaming.finish_pass1(ds, io_config, ignore_set, header_names, sample,
                           num_cols, total_rows, labels_parts, weight_parts,
                           group_parts, used, bin_finder)
    del sample

    sink = streaming.Pass2Sink(ds, io_config, predict_fun, device,
                               write_cache, depth)
    sel_local = None
    if used is not None:
        lo = np.searchsorted(used, offsets[:-1])
        hi = np.searchsorted(used, offsets[1:])
        sel_local = [used[a:b] - offsets[i]
                     for i, (a, b) in enumerate(zip(lo, hi))]
    job2 = _Job(filename=filename, ranges=ranges, parser=parser,
                mappers=ds.bin_mappers, used_feature_map=ds.used_feature_map,
                dtype=sink.dtype, num_cols=num_cols or 0,
                need_feats=predict_fun is not None, sel_local=sel_local)
    start = 0
    t_pass = time.perf_counter()
    try:
        tasks = _Tasks(pool, job2, "_pass2_range")
        try:
            for out in tasks.results(k, window):
                with telemetry.span("ingest_bin"):
                    t0 = time.perf_counter()
                    sink.commit(out["binned"], out["feats"])
                    h2d_us = (time.perf_counter() - t0) * 1e6
                streaming.count_chunk(2, out["ridx"], out["n"],
                                      out["parse_us"], out["bin_us"],
                                      h2d_us, worker=out["pid"])
                start += out["rows"]
        finally:
            if tasks.outstanding:
                shutdown_workers()
        log.check(start == total_rows and sink.cursor == ds.num_data,
                  "Input file changed between the streaming passes "
                  f"(pass 1: {total_rows} rows, pass 2: {start})")
        tracing.record_ingest_pass(2, time.perf_counter() - t_pass,
                                   sink.cursor)
        sink.finish()
    except BaseException:
        sink.abort()
        raise


if __name__ == "__main__":
    sys.exit(_worker_main())
