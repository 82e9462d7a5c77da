"""Text parsers: CSV / TSV / LibSVM to dense numpy.

A copy of lightgbm_tpu/io/parser.py: format sniffing (:217-270), LibSVM
(:159-197), and the delimited parse in the JAX package's three tiers and
order (``_parse_delimited_fast``, :123-146): the native C++ parser
(native/, built with g++ at first use), then the pandas C engine, then
the exact per-token loop, which alone raises the format error of a
ragged row.  Values with ``|v| <= 1e-10`` are zero; ``na``/``nan``/
unparseable tokens parse as 0 (utils/common.h:177-178) in every tier,
but the tiers disagree on a token such as ``1.5abc``: ``strtod`` in the
native tier reads its prefix (1.5), the others give 0 (ROADMAP C4, the
JAX package's own divergence).  Taking the same order, the port gives
the same values as the JAX package on the same host.  ``tier_calls``
counts the tier of every delimited parse, so tests and chip_smoke.py
can require the native one.  The
pandas tier is absent quietly where pandas is (one warning).

``read_line_chunks`` and ``prefetch_chunks`` stream a file in bounded
chunks; ``count_data_rows``, ``data_byte_start``,
``split_byte_ranges_at``/``split_byte_ranges`` and ``read_range_lines``
(:445-610) cut a file into row-aligned byte ranges for the parallel
ingest workers.  The module imports numpy and the standard library only:
those workers import it without torch.
"""
from __future__ import annotations

import itertools
import math
import os
import queue
import threading
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .. import lifecycle
from ..native import lib as native_lib
from ..utils import log

ZERO_THRESHOLD = 1e-10  # parser.hpp:32

# every casing of na/nan, the pandas tier's NA vocabulary (:40-42)
_NA_SPELLINGS = sorted(
    {"".join(cs) for w in ("na", "nan")
     for cs in itertools.product(*((c.lower(), c.upper()) for c in w))})

# the tier of every delimited parse of this process (a parallel load adds
# its workers' parses)
tier_calls: Dict[str, int] = {"native": 0, "pandas": 0, "exact": 0}
_warned_no_pandas = False


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
        matrix = _parse_delimited_fast(lines, self.delimiter)
        labels = np.zeros((len(lines),), dtype=np.float32)
        if 0 <= self.label_idx < matrix.shape[1]:
            labels = matrix[:, self.label_idx].astype(np.float32)
            matrix = np.delete(matrix, self.label_idx, axis=1)
        matrix[np.abs(matrix) <= ZERO_THRESHOLD] = 0.0
        return ParsedData(matrix, labels)


def _parse_delimited_fast(lines: List[str], delimiter: str) -> np.ndarray:
    """Uniform delimited lines to float64, na/nan -> 0, through the first
    tier that takes them: native, pandas, exact (which raises the format
    error of a ragged row)."""
    from ..native import lib as native_lib
    out = native_lib.parse_delimited(lines, delimiter)
    if out is not None:
        tier_calls["native"] += 1
        return out
    out = _parse_delimited_pandas(lines, delimiter)
    if out is not None:
        tier_calls["pandas"] += 1
        return out
    out = _parse_delimited_exact(lines, delimiter)
    tier_calls["exact"] += 1
    return out


def _parse_delimited_exact(lines: List[str], delimiter: str) -> np.ndarray:
    """The exact tier: ``_atof`` token by token; a ragged row is the
    reference's format error."""
    cols = len(lines[0].rstrip("\r\n").split(delimiter))
    out = np.empty((len(lines), cols), dtype=np.float64)
    for i, line in enumerate(lines):
        tokens = line.rstrip("\r\n").split(delimiter)
        if len(tokens) != cols:
            log.fatal("input format error, should be %s"
                      % ("CSV" if delimiter == "," else "TSV"))
        out[i] = [_atof(t) for t in tokens]
    return out


def _parse_delimited_pandas(lines: List[str], delimiter: str):
    """The pandas C engine (lightgbm_tpu/io/parser.py:299-352): None
    without pandas, on a ragged row or on any token it cannot convert,
    so the exact tier decides those.  ``round_trip`` parses as float()
    does; quoting off and the NA vocabulary cut to na/nan keep garbage
    tokens on the exact tier."""
    global _warned_no_pandas
    try:
        import csv
        import io as _io
        import pandas as pd
    except ImportError:
        if not _warned_no_pandas:
            _warned_no_pandas = True
            log.warning("pandas unavailable: text parsing falls back to "
                        "the exact per-token tier (slow)")
        return None
    n_delim = lines[0].count(delimiter)
    if any(ln.count(delimiter) != n_delim for ln in lines):
        return None
    try:
        df = pd.read_csv(_io.StringIO("\n".join(lines)), header=None,
                         sep=delimiter, engine="c", dtype=np.float64,
                         quoting=csv.QUOTE_NONE,
                         float_precision="round_trip",
                         keep_default_na=False, na_values=_NA_SPELLINGS)
    except Exception:   # any token pandas refuses: the exact tier decides
        return None
    out = df.to_numpy()
    if out.shape != (len(lines), n_delim + 1):
        return None
    out[np.isnan(out)] = 0.0
    return out


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


def count_data_rows(filename: str, skip_header: bool = False) -> int:
    """The data rows ``read_line_chunks`` yields, counted without a parse
    (streaming pass 0, lightgbm_tpu/io/parser.py:445)."""
    return sum(len(chunk) for chunk in
               read_line_chunks(filename, skip_header=skip_header))


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


# Byte ranges (lightgbm_tpu/io/parser.py:481-610).  A worker of the
# parallel ingest reads a byte range, not a line range.  Text mode reads
# \r\n and lone \r as \n, so a row is a maximal run of bytes other than
# 0x0A and 0x0D (UTF-8 never embeds either in a multibyte sequence);
# blank lines are empty runs.  A split point snapped forward to the next
# run start never lands inside a row, so the ranges cover the data bytes
# once and their rows, in order, are ``read_line_chunks``'s.

_SCAN_BLOCK = 8 * 1024 * 1024


def data_byte_start(filename: str, skip_header: bool = False) -> int:
    """Offset of the first data byte: past the first physical line (up to
    and including its \n, \r or \r\n) with a header, else 0; a file
    with no terminator is all header."""
    if not skip_header:
        return 0
    with open(filename, "rb") as f:
        pos = 0
        pending_cr = False
        while True:
            block = f.read(_SCAN_BLOCK)
            if not block:
                return pos
            if pending_cr:
                # the header ended on a \r at the last block's edge: a \n
                # here belongs to the same \r\n
                return pos + (1 if block[0:1] == b"\n" else 0)
            arr = np.frombuffer(block, dtype=np.uint8)
            hits = np.nonzero((arr == 10) | (arr == 13))[0]
            if hits.size == 0:
                pos += len(block)
                continue
            i = int(hits[0])
            if block[i:i + 1] == b"\n":
                return pos + i + 1
            if i + 1 < len(block):
                return pos + i + 1 + (1 if block[i + 1:i + 2] == b"\n"
                                      else 0)
            pos += len(block)
            pending_cr = True


def split_byte_ranges_at(filename: str, candidates,
                         skip_header: bool = False):
    """Snap candidate offsets forward to row starts in one raw scan.
    Returns ``(ranges, counts, total_rows)``: byte ranges covering the
    data once, the rows of each, and their sum (``count_data_rows``'s
    count, so the scan doubles as pass 0)."""
    size = os.path.getsize(filename)
    d0 = data_byte_start(filename, skip_header)
    pending = sorted(min(max(int(c), d0), size) for c in candidates)
    snapped: List[Tuple[int, int]] = []  # (byte offset, rows before it)
    total = 0
    in_run = False
    pos = d0
    with open(filename, "rb") as f:
        f.seek(d0)
        while True:
            block = f.read(_SCAN_BLOCK)
            if not block:
                break
            arr = np.frombuffer(block, dtype=np.uint8)
            m = (arr != 10) & (arr != 13)
            prev = np.empty_like(m)
            prev[0] = in_run
            prev[1:] = m[:-1]
            starts = np.nonzero(m & ~prev)[0]
            while pending and pending[0] < pos + len(block):
                j = int(np.searchsorted(starts, pending[0] - pos))
                if j >= starts.size:
                    break  # snaps in a later block, or to EOF
                snapped.append((pos + int(starts[j]), total + j))
                pending.pop(0)
            total += int(starts.size)
            in_run = bool(m[-1])
            pos += len(block)
    for _ in pending:
        snapped.append((size, total))
    bounds = [d0] + [b for b, _ in snapped] + [size]
    cum = [0] + [c for _, c in snapped] + [total]
    ranges = list(zip(bounds[:-1], bounds[1:]))
    counts = [cum[i + 1] - cum[i] for i in range(len(ranges))]
    return ranges, counts, total


def split_byte_ranges(filename: str, num_ranges: int,
                      skip_header: bool = False):
    """``num_ranges`` byte-balanced ranges, snapped to row starts."""
    size = os.path.getsize(filename)
    d0 = data_byte_start(filename, skip_header)
    num_ranges = max(int(num_ranges), 1)
    span = max(size - d0, 0)
    cands = [d0 + (span * i) // num_ranges for i in range(1, num_ranges)]
    return split_byte_ranges_at(filename, cands, skip_header=skip_header)


def read_range_lines(filename: str, start: int, end: int) -> List[str]:
    """The data lines of one snapped range: the slice of ``read_lines``
    it covers (newline translation, then blank lines dropped)."""
    if end <= start:
        return []
    with open(filename, "rb") as f:
        f.seek(start)
        data = f.read(end - start)
    text = data.decode()
    if "\r" in text:
        text = text.replace("\r\n", "\n").replace("\r", "\n")
    return [ln for ln in text.split("\n") if ln]


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
