"""The histogram kernel's wrappers, their plain versions, and the int8
quantization — counterpart of lightgbm_tpu/ops/hist_pallas.py.

``hist_float`` and ``hist_int8`` compute the raw accumulator of the TPU
kernel ``_hist_pallas_raw_fn`` (hist_pallas.py:86):

    acc[f, b, 3*c + k] = sum over rows r with bins[f, r] == b and
                         cid[r] == c of val[k, r]

with val = (grad, hess, 1) in the float mode and the int8 levels of
``quantize_values`` in the int8 mode; rows whose cid lies outside
[0, num_cols) are excluded.  On a CUDA tensor they launch csrc/hist.cu
(its header says what bounds it and how it is laid out); on a CPU tensor
they run the plain version, an ``index_add_`` on ``(f*B + bin)*C + cid``.
There is no other route: a CUDA tensor that the kernel refuses raises.

The TPU kernel's operand tricks have no counterpart here, because the
CUDA kernel computes their target directly: the bf16 hi/lo split of the
float mode (hist_pallas.py:449-460) becomes plain f32 accumulation, the
``bf16`` int-levels mode is the int8 mode itself, and the 128/192-lane
padding of the value operand has no meaning for a scatter.
"""
from __future__ import annotations

import torch

from . import cuda_build
from .cuda_build import require

# kernel launches (both modes); chip_smoke.py zeroes it around the main path
launches = 0

_num_sms = {}


def quantize_values(grad, hess, col_ok):
    """int8 round-to-nearest quantization with a per-pass global scale —
    hist_pallas.py:216-269 with ``stochastic=False``, bit for bit.
    Returns (vals [3, N] int8 = (gq*ok, hq*ok, ok), scale [3] f32)."""
    okf = col_ok.to(torch.float32)
    ag = torch.max(grad.abs() * okf)
    ah = torch.max(hess.abs() * okf)
    gs = torch.clamp_min(ag, 1e-30) / 127.0
    hs = torch.clamp_min(ah, 1e-30) / 127.0
    gq = torch.clamp(torch.round(grad / gs), -127, 127)
    hq = torch.clamp(torch.round(hess / hs), -127, 127)
    vals = torch.stack([gq * okf, hq * okf, okf]).to(torch.int8)
    return vals, torch.stack([gs, hs, torch.ones_like(gs)])


def grouped(fn, bins, grad, hess, col_id, col_ok, num_cols, B,
            group_width=64):
    """Split levels wider than ``group_width`` columns into balanced
    groups (hist_pallas.py:307-323): ceil-split so the last group is
    never a nearly-empty pass.  Each group masks its own rows, so in the
    int8 mode each group quantizes with its own scale, as on the TPU."""
    if num_cols <= group_width:
        return fn(bins, grad, hess, col_id, col_ok, num_cols, B)
    n_groups = -(-num_cols // group_width)
    width = -(-num_cols // n_groups)
    parts = []
    for base in range(0, num_cols, width):
        k = min(width, num_cols - base)
        ok = col_ok & (col_id >= base) & (col_id < base + k)
        parts.append(fn(bins, grad, hess, col_id - base, ok, k, B))
    return torch.cat(parts, dim=0)


def _check(bins, cid, values, num_cols, B):
    F, N = bins.shape
    require(bins.dtype == torch.uint8 and bins.stride(1) == 1,
            "bins must be uint8 [F, N] with contiguous rows")
    require(cid.dtype == torch.int32 and cid.shape == (N,)
            and cid.is_contiguous(), "cid must be contiguous int32 [N]")
    for v in values:
        require(v.device == bins.device and cid.device == bins.device,
                "all inputs must be on one device")
        require(v.shape[-1] == N and v.is_contiguous(),
                "values must be contiguous [..., N]")
    require(1 <= num_cols and 1 <= B <= 256, "need num_cols >= 1, B <= 256")


def _sms(device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _num_sms:
        _num_sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _num_sms[idx]


def _launch(entry, bins, args, num_cols, B, out):
    global launches
    F, N = bins.shape
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    rc = entry(bins.data_ptr(), bins.stride(0), *args, N, F, B, num_cols,
               _sms(bins.device), out.data_ptr(), stream)
    cuda_build.check(rc, "hist kernel")
    launches += 1
    return out


def hist_float(bins, grad, hess, cid, num_cols: int, B: int):
    """[F, B, 3*num_cols] f32 accumulator of (grad, hess, 1)."""
    _check(bins, cid, (grad, hess), num_cols, B)
    if bins.device.type == "cpu":
        ones = torch.ones_like(grad)
        return hist_plain(bins, torch.stack([grad, hess, ones], 1), cid,
                          num_cols, B)
    require(grad.dtype == torch.float32 and hess.dtype == torch.float32,
            "grad and hess must be float32")
    F = bins.shape[0]
    out = torch.empty((F, B, 3 * num_cols), dtype=torch.float32,
                      device=bins.device)
    lib = cuda_build.load("hist")
    return _launch(lib.lgbm_hist_f32, bins,
                   (grad.data_ptr(), hess.data_ptr(), cid.data_ptr()),
                   num_cols, B, out)


def hist_int8(bins, levels, cid, num_cols: int, B: int):
    """[F, B, 3*num_cols] int32 accumulator of int8 ``levels`` [3, N]."""
    _check(bins, cid, (levels,), num_cols, B)
    if bins.device.type == "cpu":
        return hist_plain(bins, levels.t().to(torch.int32), cid, num_cols, B)
    require(levels.dtype == torch.int8 and levels.shape[0] == 3,
            "levels must be int8 [3, N]")
    F = bins.shape[0]
    out = torch.empty((F, B, 3 * num_cols), dtype=torch.int32,
                      device=bins.device)
    lib = cuda_build.load("hist")
    return _launch(lib.lgbm_hist_i8, bins,
                   (levels.data_ptr(), levels.stride(0), cid.data_ptr()),
                   num_cols, B, out)


def hist_plain(bins, vals, cid, num_cols: int, B: int):
    """Plain version of the kernel: ``index_add_`` of ``vals`` [N, 3]
    (f32 or int32) on ``(f*B + bin)*C + cid``; excluded rows and bins
    >= B land in a dropped bucket."""
    F, N = bins.shape
    C = num_cols
    b = bins.long()
    keep = ((cid >= 0) & (cid < C))[None, :] & (b < B)
    f_idx = torch.arange(F, device=bins.device)[:, None]
    idx = (f_idx * B + b) * C + cid.long().clamp(0, C - 1)[None, :]
    idx = torch.where(keep, idx, F * B * C)
    out = torch.zeros((F * B * C + 1, 3), dtype=vals.dtype,
                      device=bins.device)
    out.index_add_(0, idx.reshape(-1),
                   vals[None].expand(F, N, 3).reshape(-1, 3))
    return out[:-1].reshape(F, B, 3 * C)
