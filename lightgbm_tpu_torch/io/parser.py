"""Text parsers: CSV / TSV / LibSVM to dense numpy.

A copy of the exact tier of lightgbm_tpu/io/parser.py (format sniffing
:217-270, the per-token loop :137-146, LibSVM :159-197): values with
``|v| <= 1e-10`` are zero, ``na``/``nan``/unparseable tokens parse as 0
(utils/common.h:177-178).  The JAX package's native and pandas tiers are
speedups of the same semantics and are not ported.  ``read_line_chunks``
and ``prefetch_chunks`` stream a file in bounded chunks, for
``task=predict``.
"""
from __future__ import annotations

import math
import queue
import threading
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .. import lifecycle
from ..utils import log

ZERO_THRESHOLD = 1e-10  # parser.hpp:32


def _atof(token: str) -> float:
    """Locale-free float parse; na/nan and garbage parse as 0."""
    token = token.strip()
    if not token:
        return 0.0
    try:
        value = float(token)
    except ValueError:
        return 0.0
    if math.isnan(value):
        return 0.0
    return value


@dataclass
class ParsedData:
    features: np.ndarray      # [rows, raw features] float64, label removed
    labels: np.ndarray        # [rows] float32 (0 without a label column)


class _DelimitedParser:
    delimiter = ","

    def __init__(self, label_idx: int):
        self.label_idx = label_idx

    def parse(self, lines: List[str]) -> ParsedData:
        if not lines:
            return ParsedData(np.zeros((0, 0)), np.zeros((0,), np.float32))
        cols = len(lines[0].rstrip("\r\n").split(self.delimiter))
        matrix = np.empty((len(lines), cols), dtype=np.float64)
        for i, line in enumerate(lines):
            tokens = line.rstrip("\r\n").split(self.delimiter)
            if len(tokens) != cols:
                log.fatal("input format error, should be %s"
                          % ("CSV" if self.delimiter == "," else "TSV"))
            matrix[i] = [_atof(t) for t in tokens]
        labels = np.zeros((len(lines),), dtype=np.float32)
        if 0 <= self.label_idx < matrix.shape[1]:
            labels = matrix[:, self.label_idx].astype(np.float32)
            matrix = np.delete(matrix, self.label_idx, axis=1)
        matrix[np.abs(matrix) <= ZERO_THRESHOLD] = 0.0
        return ParsedData(matrix, labels)


class CSVParser(_DelimitedParser):
    delimiter = ","


class TSVParser(_DelimitedParser):
    delimiter = "\t"


class LibSVMParser:
    def __init__(self, label_idx: int):
        if label_idx > 0:
            log.fatal("label should be the first column in Libsvm file")
        self.label_idx = label_idx

    def _parse_one_line(self, line: str) -> Tuple[list, float]:
        tokens = line.split()
        pairs = []
        label = 0.0
        start = 0
        if self.label_idx == 0 and tokens and ":" not in tokens[0]:
            label = _atof(tokens[0])
            start = 1
        for token in tokens[start:]:
            if ":" not in token:
                log.fatal("input format error, should be LibSVM")
            col, value = token.split(":", 1)
            pairs.append((int(col), _atof(value)))
        return pairs, label

    def parse(self, lines: List[str]) -> ParsedData:
        rows = []
        labels = np.zeros((len(lines),), dtype=np.float32)
        max_col = -1
        for i, line in enumerate(lines):
            pairs, labels[i] = self._parse_one_line(line)
            rows.append(pairs)
            for col, _ in pairs:
                max_col = max(max_col, col)
        matrix = np.zeros((len(lines), max_col + 1), dtype=np.float64)
        for i, pairs in enumerate(rows):
            for col, value in pairs:
                if abs(value) > ZERO_THRESHOLD:
                    matrix[i, col] = value
        return ParsedData(matrix, labels)


def read_lines(filename: str, skip_header: bool = False) -> List[str]:
    """All non-empty data lines (lightgbm_tpu/io/parser.py:426-473), read
    through ``read_line_chunks`` so a resident and a streamed read see
    the same rows."""
    out: List[str] = []
    for chunk in read_line_chunks(filename, skip_header=skip_header):
        out.extend(chunk)
    return out


def read_line_chunks(filename: str, skip_header: bool = False,
                     chunk_lines: int = 200_000):
    """Non-empty data lines in chunks of at most ``chunk_lines``
    (lightgbm_tpu/io/parser.py:456-479)."""
    with open(filename, "r") as f:
        if skip_header:
            f.readline()
        buf: List[str] = []
        for line in f:
            line = line.rstrip("\n")
            if line:
                buf.append(line)
                if len(buf) >= chunk_lines:
                    yield buf
                    buf = []
        if buf:
            yield buf


def prefetch_chunks(iterable, depth: int = 2):
    """Yield the items of ``iterable`` while a background thread produces
    up to ``depth`` of them ahead (lightgbm_tpu/io/parser.py:354-423):
    the next chunk is read and parsed while the caller scores this one.
    The thread registers with ``lifecycle`` while it lives; an exception
    it raises surfaces here, after the items before it."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def put_blocking(item) -> bool:
        """Stop-aware blocking put; False when the consumer went away."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put_blocking(item):
                    return
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            # the sentinel goes through the same stop-aware loop: dropped
            # on a momentarily full queue, it would strand the consumer
            # in q.get() and swallow a stored exception
            put_blocking(sentinel)
            # a thread that outlives _close's bounded join still clears
            # its entry when it exits
            lifecycle.untrack(thread)

    thread = threading.Thread(target=worker, name="lgbm-torch-prefetch",
                              daemon=True)

    def _close() -> None:
        """Stop and join: the generator's own finally and a leak guard
        both call it."""
        stop.set()
        thread.join(1.0)
        if not thread.is_alive():
            lifecycle.untrack(thread)

    lifecycle.track("prefetch", thread, _close)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        # the consumer stopped early or drained fully: unblock the worker
        # so it exits and releases the file
        _close()


def create_parser(filename: str, has_header: bool, num_features: int,
                  label_idx: int):
    """Format sniffing + label presence heuristics (parser.cpp:71-143):
    ``num_features > 0`` is the predict-time rule — a line with exactly
    ``num_features`` columns carries no label."""
    try:
        f = open(filename, "r")
    except OSError:
        log.fatal("Data file: %s doesn't exist" % filename)
    with f:
        if has_header:
            f.readline()
        line1 = f.readline().rstrip("\r\n")
        if not line1:
            log.fatal("Data file: %s at least should have one line"
                      % filename)
        line2 = f.readline().rstrip("\r\n")
    counts1 = (line1.count(","), line1.count("\t"), line1.count(":"))
    counts2 = (line2.count(","), line2.count("\t"), line2.count(":"))
    data_type = None
    if not line2:
        if counts1[2] > 0:
            data_type = "libsvm"
        elif counts1[1] > 0:
            data_type = "tsv"
        elif counts1[0] > 0:
            data_type = "csv"
    elif counts1[2] > 0 or counts2[2] > 0:
        data_type = "libsvm"
    elif counts1[1] == counts2[1] and counts1[1] > 0:
        data_type = "tsv"
    elif counts1[0] == counts2[0] and counts1[0] > 0:
        data_type = "csv"
    if data_type is None:
        log.fatal("Unknown format of training data")
    if data_type == "libsvm":
        if num_features > 0:
            head = line1.strip().split(None, 1)[0] if line1.strip() else ""
            if ":" in head:
                label_idx = -1
        return LibSVMParser(label_idx)
    delim = "\t" if data_type == "tsv" else ","
    if num_features > 0 and len(line1.strip().split(delim)) == num_features:
        label_idx = -1
    return (TSVParser if data_type == "tsv" else CSVParser)(label_idx)
