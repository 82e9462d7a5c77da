"""The bin matrix as a tensor: 8-bit, 16-bit or 32-bit bins.

A dataset stores uint8 bins where every feature has at most 256 bins,
uint16 up to 65,536 and uint32 above that (io/dataset.py, the JAX
package's rule).  The 16-bit ones travel as ``torch.int16`` views of the
same bytes and the 32-bit ones as ``torch.int32`` views, because torch's
``uint16`` and ``uint32`` tensors have no comparison and no ``gather`` on
the CPU; the CUDA kernels read those bytes as ``uint16_t`` or
``uint32_t``, and everything else compares or indexes through ``widen``.
A 32-bit bin is below 2^31 (``max_bin`` is an int32), so its int32 view
is the bin itself; ``carry`` refuses one that is not.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import log

# host bin dtype -> the dtype of the view that carries it, and back
_CARRY = {np.dtype(np.uint16): np.dtype(np.int16),
          np.dtype(np.uint32): np.dtype(np.int32)}
_HOST = {v: k for k, v in _CARRY.items()}


def bin_bytes(bins: torch.Tensor) -> int:
    """Bytes a bin: 1, 2 or 4 (uint8, or the int16 or int32 carry)."""
    return bins.element_size()


def widen(bins: torch.Tensor) -> torch.Tensor:
    """Bin values that compare and index as unsigned numbers: 16-bit bins
    as int32 in [0, 65536), uint8 and 32-bit bins as they are."""
    if bins.dtype == torch.int16:
        return bins.to(torch.int32) & 0xFFFF
    return bins


def carry(bins: np.ndarray) -> np.ndarray:
    """Host bins as their carry's bytes: uint16 as an int16 view, uint32
    as an int32 view (a bin of 2^31 or more is a ``Fatal``), uint8 as
    it is."""
    to = _CARRY.get(bins.dtype)
    if to is None:
        return bins
    if to == np.int32 and bins.size and int(bins.max()) >= 1 << 31:
        log.fatal("a 32-bit bin of %d does not fit the int32 carry of "
                  "uint32 bins (bins must be below 2^31)" % int(bins.max()))
    return bins.view(to)


def carry_dtype(np_dtype) -> torch.dtype:
    """The tensor dtype that carries host bins of ``np_dtype``."""
    return torch.from_numpy(carry(np.zeros(0, np_dtype))).dtype


def to_tensor(bins: np.ndarray, device) -> torch.Tensor:
    """A uint8, uint16 or uint32 numpy bin matrix on ``device``, as its
    carry (``carry``)."""
    return torch.from_numpy(carry(bins)).to(device)


def to_numpy(bins: torch.Tensor) -> np.ndarray:
    """The host bin matrix of a carried tensor, ``to_tensor``'s inverse:
    int16 back to uint16, int32 back to uint32."""
    out = bins.cpu().numpy()
    return out.view(_HOST[out.dtype]) if out.dtype in _HOST else out
