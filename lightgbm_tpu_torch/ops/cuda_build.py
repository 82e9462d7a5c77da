"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source has a plain C interface, so it compiles with ``nvcc`` alone
(no PyTorch headers) into a shared library under ``_build/`` of this
package (git-ignored), at first use, and loads with ``ctypes``.  The
library name carries a digest of the source, so an edited kernel is
rebuilt and a stale one never loads.  Each build's seconds, and each
load of a library an earlier process built, go to costmodel.py's
``compile`` block.  Nothing here runs at import time:
the CPU tests import every module without a CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List

from .. import costmodel
from ..utils import log

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("hist", "partition", "rank")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: Dict[str, str] = {}   # source name -> ptxas resource report
_built = set()                   # sources this process compiled


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        log.fatal("nvcc not found: the CUDA kernels of lightgbm_tpu_torch "
                  "are built from csrc/ at first use and need the CUDA "
                  "toolkit")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(ARCH_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        "lib%s-%s.so" % (name, digest.hexdigest()[:16]))


def nvcc_command(name: str, out_path: str) -> List[str]:
    return ([nvcc_path()] + ARCH_FLAGS
            + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", out_path,
               os.path.join(CSRC_DIR, name + ".cu")])


def build(names=SOURCES) -> None:
    """Compile every missing library, one ``nvcc`` per source, all
    started together; raises on any compiler error."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs.append((name, out, tmp, subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        text, _ = proc.communicate()
        build_log[name] = text
        if proc.returncode != 0:
            failed.append("%s.cu:\n%s" % (name, text))
            os.unlink(tmp)
        else:
            os.replace(tmp, out)
            _built.add(name)
            # seconds from the start of the parallel build to this one's end
            costmodel.note_build("nvcc:%s.cu" % name,
                                 time.perf_counter() - t0, cached=False)
    if failed:
        log.fatal("nvcc failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build((name,))
            elif name not in _built:
                costmodel.note_build("nvcc:%s.cu" % name, 0.0, cached=True)
            lib = ctypes.CDLL(path)
            _declare(name, lib)
            _libs[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "hist":
        # ..., n, num_f, num_b, num_c, shift, [bin layout,] then the plan
        # (vec, threads, g, copies, tile, chunk, groups, chunks, smem,
        # slices, slice_cells), [the float modes' exponent, scratch,] out,
        # stream
        tail = [i, i, i, i, i, ll, i, i, i, i, i, p, p]
        fixed = [i, i, i, i, i, ll, i, i, i, i, i, p, p, p, p]
        lib.lgbm_hist_f32.argtypes = [p, ll, p, p, p, i, i, i, i, i,
                                      i] + fixed
        lib.lgbm_hist_i8.argtypes = [p, ll, p, ll, p, i, i, i, i, i, i] + tail
        lib.lgbm_hist_pane.argtypes = [p, ll, ll, i, p, i, i, i, i,
                                       i] + fixed
        for fn in (lib.lgbm_hist_f32, lib.lgbm_hist_i8, lib.lgbm_hist_pane):
            fn.restype = i
    elif name == "partition":
        # src, lds, dst, ldd, then the entry's own arguments, then the
        # plan (tiles, group), counts, left, stream
        tail = [i, i, p, p, p]
        lib.lgbm_partition_pane.argtypes = [p, ll, p, ll, i, i, i, i, i,
                                            ctypes.c_uint] + tail
        lib.lgbm_partition_mask.argtypes = [p, ll, p, ll, p, i, i] + tail
        for fn in (lib.lgbm_partition_pane, lib.lgbm_partition_mask):
            fn.restype = i
    elif name == "rank":
        # score, perm, label, gain, items, n_items, item_docs,
        # inv_max_dcg, discount, sigmoid, disc scratch, lambdas, hessians,
        # stream
        lib.lgbm_rank_gradients.argtypes = [p, p, p, p, p, i, i, p, p,
                                            ctypes.c_float, p, p, p, p]
        lib.lgbm_rank_gradients.restype = i


_num_sms: Dict[int, int] = {}


def num_sms(device) -> int:
    """Streaming multiprocessors of a CUDA device, read once per device."""
    import torch
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _num_sms:
        _num_sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _num_sms[idx]


def require(ok: bool, what: str) -> None:
    """A wrapper's check of its inputs, before any pointer reaches a
    kernel: raises on a tensor the kernel does not take."""
    if not ok:
        raise ValueError(what)


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t from a kernel entry."""
    if rc != 0:
        import torch
        name = torch.cuda.get_device_name() if torch.cuda.is_available() \
            else "no device"
        raise RuntimeError("%s: CUDA error %d on %s" % (what, rc, name))
