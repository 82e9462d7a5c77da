"""The bin matrix as a tensor: 8-bit or 16-bit bins.

A dataset stores uint8 bins where every feature has at most 256 bins and
16-bit bins up to 65,536 (io/dataset.py, the JAX package's rule).  The
16-bit ones travel as ``torch.int16`` views of the same bytes, because
torch's ``uint16`` tensors have no comparison and no ``gather`` on the
CPU; the CUDA kernels read those bytes as ``uint16_t``, and everything
else compares or indexes through ``widen``.
"""
from __future__ import annotations

import numpy as np
import torch


def bin_bytes(bins: torch.Tensor) -> int:
    """Bytes a bin: 2 for a 16-bit matrix (carried as int16), else 1."""
    return 2 if bins.dtype == torch.int16 else 1


def widen(bins: torch.Tensor) -> torch.Tensor:
    """Bin values that compare and index as unsigned numbers: 16-bit bins
    as int32 in [0, 65536), uint8 bins as they are."""
    if bins.dtype == torch.int16:
        return bins.to(torch.int32) & 0xFFFF
    return bins


def to_tensor(bins: np.ndarray, device) -> torch.Tensor:
    """A uint8 or uint16 numpy bin matrix on ``device``; uint16 becomes
    an int16 view of the same bytes."""
    if bins.dtype == np.uint16:
        bins = bins.view(np.int16)
    return torch.from_numpy(bins).to(device)
