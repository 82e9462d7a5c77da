"""ctypes loader of the native text parser (lgbm_native.cpp).

Modelled on lightgbm_tpu/native/lib.py:20-122.  The library is built at
first use, never at import, with ``g++ -O3 -fopenmp -shared -fPIC`` into
the package's git-ignored ``_build/``, through a temp file and a rename
(another process may race the first use, and a killed build must not
leave a library that fails to load).  Its name carries a digest of the
source, so an edited source is rebuilt and a stale library never loads.
A failed build leaves the reason in :data:`build_error` and the callers
take the next tier (io/parser.py), as the JAX package's do.  The build's
seconds (or a cached load) go to costmodel.py's ``compile`` block.  Imports
numpy and the standard library only: the exec'd parse workers
(io/parallel_ingest.py) load it too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional

import numpy as np

from .. import costmodel

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "lgbm_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()
build_error: Optional[str] = None   # why the library is unavailable


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        "liblgbm_native-%s.so" % digest.hexdigest()[:16])


def _build(out: str) -> None:
    global build_error
    gxx = shutil.which("g++")
    if gxx is None:
        build_error = "g++ not found"
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    try:
        proc = subprocess.run([gxx] + FLAGS + [SOURCE, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            build_error = "g++ failed: %s" % proc.stderr.strip()[-2000:]
            return
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError) as e:
        build_error = "g++ did not run: %s" % e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> Optional[ctypes.CDLL]:
    """The library, built on the first call; None when it cannot be
    built or loaded (``build_error`` says why)."""
    global _lib, _tried, build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = library_path()
        if os.path.exists(path):
            costmodel.note_build("g++:lgbm_native.cpp", 0.0, cached=True)
        else:
            t0 = time.perf_counter()
            _build(path)
            if os.path.exists(path):
                costmodel.note_build("g++:lgbm_native.cpp",
                                     time.perf_counter() - t0, cached=False)
        if not os.path.exists(path):
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.parse_delimited.restype = ctypes.c_int
            lib.parse_delimited.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char,
                ctypes.c_longlong, ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_double)]
            lib.set_num_threads.restype = None
            lib.set_num_threads.argtypes = [ctypes.c_int]
        except (OSError, AttributeError) as e:
            build_error = "cannot load %s: %s" % (path, e)
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def set_num_threads(n: int) -> None:
    """Cap the library's OpenMP pool (``num_threads``, application.cpp:
    30-34); no-op for n <= 0 or without the library."""
    lib = load()
    if lib is not None and n > 0:
        lib.set_num_threads(int(n))


def parse_delimited(lines: List[str], delimiter: str) -> Optional[np.ndarray]:
    """Uniform delimited lines as a float64 [rows, cols] matrix, or None
    (no library, or a ragged row) so the caller takes the next tier."""
    lib = load()
    if lib is None or not lines:
        return None
    ncols = lines[0].count(delimiter) + 1
    blob = ("\n".join(lines) + "\n").encode()
    out = np.empty((len(lines), ncols), dtype=np.float64)
    rc = lib.parse_delimited(
        blob, len(blob), delimiter.encode(), len(lines), ncols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out if rc == 0 else None
