"""Histogram routing: ``build_histogram`` and ``histogram_leafbatch``.

Counterpart of lightgbm_tpu/ops/histogram.py:284-382 and :531-567, with
the same layouts: ``[F, B, 3]`` for one leaf and ``[C, F, B, 3]`` f32 for
C leaf columns (grad, hess, count).  Every mode goes through the
histogram kernel (ops/hist_cuda.py), as every mode reaches the Pallas
kernel on the TPU:

- ``float32``: f32 grad/hess accumulate as they are (the TPU's
  ``precision="f32"`` hi/lo split approximates exactly this); on the card
  in 64-bit fixed point at the tree's ``exponent``
  (``hist_cuda.fixed_exponent``), the same bits on every run;
- ``bfloat16``: grad/hess rounded to bf16 (to nearest even), then the
  float mode's f32 accumulation, as the TPU's single-pass bf16 operand
  (hist_pallas.py:510-522; on the CPU, histogram.py:236-239, :430);
  counts stay exact;
- ``int8`` and ``int8_sr``: grad/hess quantized per pass
  (``quantize_values``; ``int8_sr`` rounds stochastically, keyed by the
  pass's ``salt``), int32 accumulation, dequantized by the pass scale as
  ``_hist_pallas_one`` does (hist_pallas.py:431-433) — bitwise equal to
  the JAX package.

``packing`` (io/binning.PackSpec): the bin matrix stores its features in
bin-width classes; each pass launches once per class on the class's
rows at the class's width and puts the histograms back in canonical
feature order (``assemble``).  int8 quantizes once for all classes and
assembles the int accumulators before dequantizing, so packed and
uniform int8 histograms are bitwise equal (hist_pallas.py:380-404).
A packed leaf batch counts ``hist/mixedbin_leafbatch`` in telemetry, as
the JAX package's routing layer does (histogram.py:318).  Under the
block-local layout of the hybrid and voting learners (io/binning.
BlockedPackSpec) an owned block is histogrammed in its storage order and
``feat_gather`` puts it back in canonical order, a gather of the
accumulator after the kernel (int8: before the reduction and the scale).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as nnf

from .. import telemetry
from .hist_cuda import (group_width, grouped, hist_float, hist_int8,
                        quantize_values)


def is_int8(compute_dtype: str) -> bool:
    """True for both int8 modes (lightgbm_tpu/models/grower_unified.py::
    _is_int8): ``int8_sr`` takes every int8 branch."""
    return compute_dtype.startswith("int8")


def class_ranges(packing, F: int, B: int):
    """(first row, rows, width) of each bin-width class: the packing's,
    or one class of all F rows at B."""
    return ((0, F, B),) if packing is None else packing.ranges


@functools.lru_cache(maxsize=None)
def _index(values: tuple, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=device)


def canonical_index(packing, device) -> torch.Tensor:
    """[F] int64 on ``device``: canonical feature -> storage row (``c2p``),
    uploaded once per layout and device."""
    return _index(packing.c2p, device)


def assemble(parts, packing, B: int):
    """Per-class accumulators ``[Fc, width, ...]`` (packed feature order)
    -> one ``[F, B, ...]`` in canonical order: each zero-padded to B bins,
    concatenated, gathered by ``c2p`` (histogram.py:75-89)."""
    if packing is None:
        return parts[0]
    padded = [nnf.pad(p, (0, 0, 0, B - w)) if w < B else p
              for p, (_, _, w) in zip(parts, packing.ranges)]
    out = torch.cat(padded, 0)
    return out.index_select(0, canonical_index(packing, out.device))


def gather_features(acc, feat_gather, dim: int = 0):
    """``acc`` with its feature axis ``dim`` gathered by ``feat_gather``
    ([F] int64: canonical position -> storage position; block-local
    packing's owned block, JAX histogram.py:161-171), or as it is."""
    if feat_gather is None:
        return acc
    return acc.index_select(dim, feat_gather)


def _float_one(bins, grad, hess, col_id, col_ok, num_cols, B, packing,
               exponent, feat_gather=None):
    F = bins.shape[0]
    cid = torch.where(col_ok, col_id, -1).to(torch.int32)
    grad, hess = grad.contiguous(), hess.contiguous()
    acc = gather_features(assemble(
        [hist_float(bins[s:s + n], grad, hess, cid, num_cols, w, exponent)
         for s, n, w in class_ranges(packing, F, B)], packing, B),
        feat_gather)
    return acc.reshape(F, B, num_cols, 3).permute(2, 0, 1, 3)


def _int8_one(bins, grad, hess, col_id, col_ok, num_cols, B, packing, salt,
              stochastic, scale_reduce=None, int_reduce=None,
              feat_gather=None):
    F = bins.shape[0]
    # one quantization for every class launch: the scale comes from the
    # same rows whatever the layout
    vals, scale = quantize_values(grad, hess, col_ok, stochastic, salt,
                                  scale_reduce)
    cid = torch.where(col_ok, col_id, -1).to(torch.int32)
    acc = assemble([hist_int8(bins[s:s + n], vals, cid, num_cols, w)
                    for s, n, w in class_ranges(packing, F, B)], packing, B)
    # the block's canonical order in the int domain, before any reduction
    # and the scale (hist_pallas.py:409-417)
    acc = gather_features(acc, feat_gather)
    if int_reduce is not None:
        # the world's sum in the int domain, before the scale: int32 sums
        # are order-free, so the result is the serial run's bit for bit
        # (JAX histogram.py:505-510); a dequantized f32 sum would not be
        acc = int_reduce(acc)
    hist = acc.to(torch.float32).reshape(acc.shape[0], B, num_cols, 3)
    return hist.permute(2, 0, 1, 3) * scale


def round_bf16(x):
    """f32 values rounded to bf16 (to nearest even), as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def histogram_leafbatch(bins, grad, hess, col_id, col_ok, num_cols: int,
                        num_bins_max: int, compute_dtype: str = "float32",
                        packing=None, salt: int = 0, exponent=None,
                        scale_reduce=None, int_reduce=None,
                        feat_gather=None):
    """[C, F, B, 3] f32 histograms of C leaf columns in one pass per
    group of 64 columns, 42 with 16-bit bins (``group_width``; one launch
    per bin-width class under ``packing``).  ``bins`` [F, N] uint8, or
    int16 carrying 16-bit bins, in storage order (rows may be strided),
    ``col_id`` [N] leaf column per row, ``col_ok`` [N] bool; ``salt``
    keys ``int8_sr``'s rounding bits; ``exponent``: the float modes'
    fixed-point exponent (``hist_cuda.fixed_exponent``, one per tree;
    by default each launch's own).  The result is in canonical feature
    order.  The int8 modes' world seams (a data-parallel schedule's,
    models/grower_unified.SeamSchedule): ``scale_reduce`` takes each
    pass's maxima to the world's, ``int_reduce`` each pass's
    canonical [F, B, 3C] int32 accumulator to the world's sum (or this
    rank's feature block of it); the float modes take none (the caller
    reduces the f32 result).  ``feat_gather`` ([F] int64): a block-local
    packed owned block's storage rows back in canonical block order,
    gathered from each pass's accumulator (int8: before ``int_reduce``
    and the scale)."""
    int8 = is_int8(compute_dtype)
    if packing is not None:
        telemetry.count("hist/mixedbin_leafbatch")
    if compute_dtype == "bfloat16":
        grad, hess = round_bf16(grad), round_bf16(hess)

    def one(*args):
        if int8:
            return _int8_one(*args, packing, salt,
                             compute_dtype == "int8_sr", scale_reduce,
                             int_reduce, feat_gather)
        return _float_one(*args, packing, exponent, feat_gather)

    return grouped(one, bins, grad, hess, col_id, col_ok, num_cols,
                   num_bins_max, group_width(num_bins_max))


def build_histogram(bins, grad, hess, mask, num_bins_max: int,
                    compute_dtype: str = "float32", packing=None,
                    salt: int = 0, exponent=None, scale_reduce=None,
                    int_reduce=None, feat_gather=None):
    """[F, B, 3] histogram of the rows where ``mask`` holds: the
    one-column leaf batch, as on the TPU (histogram.py:541-564)."""
    cid = torch.zeros(bins.shape[1], dtype=torch.int32, device=bins.device)
    return histogram_leafbatch(bins, grad, hess, cid, mask, 1,
                               num_bins_max, compute_dtype, packing, salt,
                               exponent, scale_reduce, int_reduce,
                               feat_gather)[0]
