"""Stable row partition of the plane pane — the compacted leaf-wise
grower's core op.  Counterpart of lightgbm_tpu/ops/compact.py.

Every leaf's rows stay contiguous in one ``[R, P]`` int8 pane: F bin rows,
the f32 grad and hess as four byte planes each, a validity row, zero rows
up to a multiple of 8 (``pack_planes``).  Each split stably partitions the
parent's lane range (``partition_segment``), so the smaller child's
histogram reads only that child's rows.

``partition_segment`` launches csrc/partition.cu on a CUDA tensor (its
header says what bounds it and how it works) and runs the plain version —
the stable-sort formulation of the JAX package's oracle
(compact.py:438-444) — on a CPU tensor.  The byte planes go through
``Tensor.view(dtype)``, so a pane is bit-exact with the JAX package's.
"""
from __future__ import annotations

import torch

from . import cuda_build
from .cuda_build import require

BLOCK = 2048  # lane block of the bucket table (compact.py:54)

# kernel launches (one per partition); chip_smoke.py zeroes it
launches = 0


def pane_rows(num_features: int) -> int:
    """F bin rows + 8 grad/hess byte planes + validity, padded to 8."""
    r = num_features + 9
    return -(-r // 8) * 8


def pack_planes(bins, grad, hess, row_mask, width: int) -> torch.Tensor:
    """[pane_rows(F), width] int8 pane (compact.py:455-472).  Lanes past
    N are zero; every consumer masks by segment extent."""
    F, N = bins.shape
    pane = torch.zeros((pane_rows(F), width), dtype=torch.int8,
                       device=bins.device)
    pane[:F, :N] = bins.view(torch.int8)
    pane[F:F + 4, :N] = grad.to(torch.float32).contiguous().view(
        torch.int8).reshape(N, 4).t()
    pane[F + 4:F + 8, :N] = hess.to(torch.float32).contiguous().view(
        torch.int8).reshape(N, 4).t()
    pane[F + 8, :N] = row_mask.to(torch.int8)
    return pane


def unpack_values(pane_slice, F: int):
    """(bins uint8 [F, W] view, grad f32 [W], hess f32 [W], valid bool [W])
    from a pane slice (compact.py:475-490); byte k of a value sits in
    plane k, little-endian, as ``pack_planes`` put it."""
    bins = pane_slice[:F].view(torch.uint8)
    grad = pane_slice[F:F + 4].t().contiguous().view(torch.float32)[:, 0]
    hess = pane_slice[F + 4:F + 8].t().contiguous().view(torch.float32)[:, 0]
    valid = pane_slice[F + 8] == 1
    return bins, grad, hess, valid


def bucket_table(n: int, block: int = BLOCK, min_width: int = 0):
    """Descending slice widths W_0 > W_1 > ... >= max(block, min_width)
    (compact.py:493-504): W_0 covers the root, each next is ceil(W/2)
    rounded up to a block multiple."""
    w = -(-n // block) * block
    floor_w = max(block, -(-min_width // block) * block)
    table = [w]
    while table[-1] > floor_w:
        w = -(-(table[-1] // 2) // block) * block
        table.append(max(w, floor_w))
    return tuple(table)


def partition_segment(seg, mask3, delta: int, cnt: int, plcnt: int):
    """Stable in-segment partition of ``seg``'s lanes [delta, delta+cnt).

    seg : [R, W] int8 (rows contiguous; a strided column slice of the pane
        is fine); mask3 : [W] int8, 1 = left, 0 = right, -1 outside the
        segment; plcnt : number of mask3 == 1 lanes.

    Returns a new [R, W] tensor: lanes [delta, delta+plcnt) hold the left
    rows in original order, [delta+plcnt, delta+cnt) the right rows, every
    other lane is byte-identical to ``seg``."""
    R, W = seg.shape
    require(seg.dtype == torch.int8 and seg.stride(1) == 1,
            "seg must be int8 [R, W] with contiguous rows")
    require(mask3.dtype == torch.int8 and mask3.shape == (W,)
            and mask3.is_contiguous() and mask3.device == seg.device,
            "mask3 must be contiguous int8 [W] on seg's device")
    require(0 <= delta and 0 <= cnt and delta + cnt <= W
            and 0 <= plcnt <= cnt, "segment out of range")
    if seg.device.type == "cpu":
        return partition_plain(seg, mask3, delta, cnt)
    global launches
    out = torch.empty((R, W), dtype=torch.int8, device=seg.device)
    scratch = torch.empty(4 * (-(-W // 1024)), dtype=torch.int32,
                          device=seg.device)
    lib = cuda_build.load("partition")
    rc = lib.lgbm_partition(
        seg.data_ptr(), seg.stride(0), mask3.data_ptr(), out.data_ptr(), R,
        W, int(delta), int(cnt), int(plcnt), scratch.data_ptr(),
        torch.cuda.current_stream(seg.device).cuda_stream)
    cuda_build.check(rc, "partition kernel")
    launches += 1
    return out


def partition_plain(seg, mask3, delta: int, cnt: int):
    """Plain version: stable sort by class (left 0, right 1, outside 2),
    gather, roll by ``delta`` (compact.py:438-444)."""
    W = seg.shape[1]
    keys = torch.where(mask3 == 1, 0, torch.where(mask3 == 0, 1, 2))
    order = torch.sort(keys, stable=True).indices
    permuted = torch.roll(seg[:, order], delta, dims=1)
    lane = torch.arange(W, device=seg.device)
    inseg = (lane >= delta) & (lane < delta + cnt)
    return torch.where(inseg[None, :], permuted, seg)
