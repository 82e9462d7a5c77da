"""Histogram routing: ``build_histogram`` and ``histogram_leafbatch``.

Counterpart of lightgbm_tpu/ops/histogram.py:284-382 and :531-567 for the
two modes of this slice, with the same layouts: ``[F, B, 3]`` for one
leaf and ``[C, F, B, 3]`` f32 for C leaf columns (grad, hess, count).
Both modes go through the histogram kernel (ops/hist_cuda.py), as both
reach the Pallas kernel on the TPU:

- ``float32``: f32 grad/hess accumulate as they are (the TPU's
  ``precision="f32"`` hi/lo split approximates exactly this);
- ``int8``: grad/hess quantized per pass (``quantize_values``), int32
  accumulation, dequantized by the pass scale as ``_hist_pallas_one``
  does (hist_pallas.py:431-433) — bitwise equal to the JAX package.
"""
from __future__ import annotations

import torch

from .hist_cuda import grouped, hist_float, hist_int8, quantize_values


def _float_one(bins, grad, hess, col_id, col_ok, num_cols, B):
    F = bins.shape[0]
    cid = torch.where(col_ok, col_id, -1).to(torch.int32)
    acc = hist_float(bins, grad.contiguous(), hess.contiguous(), cid,
                     num_cols, B)
    return acc.reshape(F, B, num_cols, 3).permute(2, 0, 1, 3)


def _int8_one(bins, grad, hess, col_id, col_ok, num_cols, B):
    F = bins.shape[0]
    vals, scale = quantize_values(grad, hess, col_ok)
    cid = torch.where(col_ok, col_id, -1).to(torch.int32)
    acc = hist_int8(bins, vals, cid, num_cols, B)
    hist = acc.to(torch.float32).reshape(F, B, num_cols, 3)
    return hist.permute(2, 0, 1, 3) * scale


def histogram_leafbatch(bins, grad, hess, col_id, col_ok, num_cols: int,
                        num_bins_max: int, compute_dtype: str = "float32"):
    """[C, F, B, 3] f32 histograms of C leaf columns in one pass per
    64-column group.  ``bins`` [F, N] uint8 (rows may be strided),
    ``col_id`` [N] leaf column per row, ``col_ok`` [N] bool."""
    one = _int8_one if compute_dtype == "int8" else _float_one
    return grouped(one, bins, grad, hess, col_id, col_ok, num_cols,
                   num_bins_max)


def build_histogram(bins, grad, hess, mask, num_bins_max: int,
                    compute_dtype: str = "float32"):
    """[F, B, 3] histogram of the rows where ``mask`` holds: the
    one-column leaf batch, as on the TPU (histogram.py:541-564)."""
    cid = torch.zeros(bins.shape[1], dtype=torch.int32, device=bins.device)
    return histogram_leafbatch(bins, grad, hess, cid, mask, 1,
                               num_bins_max, compute_dtype)[0]
