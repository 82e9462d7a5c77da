"""Stable row partition of the plane pane — the compacted leaf-wise
grower's core op.  Counterpart of lightgbm_tpu/ops/compact.py.

Every leaf's rows stay contiguous in an ``[R, P]`` int8 pane: F bin rows,
the f32 grad and hess as four byte planes each, a validity row, zero rows
up to a multiple of 8 (``pack_planes``).  With 16-bit or 32-bit bins
(``bin_bytes`` 2 or 4) the F bin rows hold the bins' low bytes and each
next F rows their next byte, little-endian, so a split keys on the whole
bin; the JAX package keeps only the low byte there (compact.py:463,
ROADMAP C3).  Each
split stably partitions the parent's lane range, so the smaller child's
histogram reads only that child's rows.  Two entries:

- ``partition_pane``, the grower's: decides each lane from the pane's own
  bin row and writes the partitioned lanes into a second pane;
- ``partition_segment``, the JAX package's contract: a ``mask3`` over a
  bucketed slice, a new slice returned.

On a CUDA tensor both launch csrc/partition.cu (its header says what
bounds it and how it works) with the launch plan of ``plan``, and each
launch counts ``partition/cuda`` in telemetry with its analytic bytes
(costmodel.py); on a CPU tensor they run the plain version (counted
``partition/plain``), the stable-sort formulation of the JAX
package's oracle (compact.py:438-444).  The byte planes go through
``Tensor.view(dtype)``, so an 8-bit pane is bit-exact with the JAX
package's.
"""
from __future__ import annotations

import collections

import torch

from .. import costmodel, telemetry
from . import cuda_build
from .bins import bin_bytes as bins_bytes
from .cuda_build import require

BLOCK = 2048  # lane block of the bucket table (compact.py:54)
# launch plan of csrc/partition.cu (its header says why)
TILE = 4096            # lanes per block
MAX_GROUP = 8          # pane rows per block, at most
ONE_LAUNCH_TILES = 6   # up to this many tiles, blocks count their own sides

# partition calls that launched the kernel (either entry), CUDA kernels
# launched (one or two per call), and the lanes of the latest pane-entry
# launches; chip_smoke.py resets them around the main path
launches = 0
kernel_launches = 0
launch_rows = collections.deque(maxlen=1 << 16)


def pane_rows(num_features: int, bin_bytes: int = 1) -> int:
    """F bin rows (2F or 4F with 16-bit or 32-bit bins) + 8 grad/hess
    byte planes + validity, padded to 8."""
    r = bin_bytes * num_features + 9
    return -(-r // 8) * 8


def pack_planes(bins, grad, hess, row_mask, width: int) -> torch.Tensor:
    """[pane_rows(F, bin_bytes), width] int8 pane (compact.py:455-472)
    of uint8, 16-bit (int16) or 32-bit (int32) bins.  Lanes past N are
    zero; every consumer masks by segment extent."""
    F, N = bins.shape
    nb = bins_bytes(bins)
    pane = torch.zeros((pane_rows(F, nb), width), dtype=torch.int8,
                       device=bins.device)
    if nb == 1:
        pane[:F, :N] = bins.view(torch.int8)
    else:
        # little-endian: byte 0 of each bin is its low byte
        planes = bins.contiguous().view(torch.int8).reshape(F, N, nb)
        for k in range(nb):
            pane[k * F:(k + 1) * F, :N] = planes[..., k]
    v = nb * F
    pane[v:v + 4, :N] = grad.to(torch.float32).contiguous().view(
        torch.int8).reshape(N, 4).t()
    pane[v + 4:v + 8, :N] = hess.to(torch.float32).contiguous().view(
        torch.int8).reshape(N, 4).t()
    pane[v + 8, :N] = row_mask.to(torch.int8)
    return pane


def unpack_values(pane_slice, F: int, bin_bytes: int = 1):
    """(bins [F, W], grad f32 [W], hess f32 [W], valid bool [W]) from a
    pane slice (compact.py:475-490); byte k of a value sits in plane k,
    little-endian, as ``pack_planes`` put it.  The bins are a uint8 view,
    or with ``bin_bytes`` 2 or 4 an int16 or int32 copy of the 16-bit or
    32-bit bins."""
    if bin_bytes == 1:
        bins = pane_slice[:F].view(torch.uint8)
    else:
        carry = torch.int16 if bin_bytes == 2 else torch.int32
        bins = torch.stack([pane_slice[k * F:(k + 1) * F]
                            for k in range(bin_bytes)],
                           -1).view(carry)[..., 0]
    v = bin_bytes * F
    grad = pane_slice[v:v + 4].t().contiguous().view(torch.float32)[:, 0]
    hess = pane_slice[v + 4:v + 8].t().contiguous().view(
        torch.float32)[:, 0]
    valid = pane_slice[v + 8] == 1
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


def plan(cnt: int, shift: int, rows: int, sms: int):
    """Launch plan of csrc/partition.cu for ``cnt`` lanes whose first lies
    ``shift`` bytes past a 16-byte boundary, ``rows`` pane rows and ``sms``
    SMs: (tiles, group, count_pass).  Tiles of TILE lanes start at that
    boundary.  A segment of up to ONE_LAUNCH_TILES tiles takes one launch,
    a longer one a count pass first.  Blocks take ``group`` pane rows: the
    most, up to MAX_GROUP, that still gives one block per SM, or one per
    two SMs in one launch, where each block also counts every tile's
    sides (scripts/partition_port_bench.py measures both choices)."""
    tiles = -(-(cnt + shift) // TILE)
    count_pass = tiles > ONE_LAUNCH_TILES
    want = sms if count_pass else -(-sms // 2)
    group = MAX_GROUP
    while group > 1 and tiles * -(-rows // group) < want:
        group //= 2
    return tiles, group, count_pass


def _launch(entry, src, dst, args, cnt: int, left):
    """Launch ``entry`` on the lanes at ``src`` and ``dst`` (column slices
    starting at the segment's first lane); ``left`` gets the left count."""
    global launches, kernel_launches
    tiles, group, count_pass = plan(cnt, src.data_ptr() % 16, src.shape[0],
                                    cuda_build.num_sms(src.device))
    counts = (torch.empty(tiles, dtype=torch.int32, device=src.device)
              if count_pass else None)
    rc = entry(src.data_ptr(), src.stride(0), dst.data_ptr(), dst.stride(0),
               *args, tiles, group,
               None if counts is None else counts.data_ptr(),
               left.data_ptr(),
               torch.cuda.current_stream(src.device).cuda_stream)
    cuda_build.check(rc, "partition kernel")
    launches += 1
    kernel_launches += 2 if count_pass else 1
    _count_launch("partition/cuda", src.shape[0], cnt)
    return left


def _count_launch(route: str, rows: int, cnt: int) -> None:
    """The launch's route counter and its analytic cost (costmodel.py):
    the segment's pane rows read and written (PERF.md's bound), a compare
    a lane; the plain version files the same work."""
    if telemetry.enabled():
        telemetry.count(route)
        costmodel.note_launch("partition", route, bytes=2 * rows * cnt,
                              flops=cnt)


def partition_pane(src, dst, F: int, feat: int, thr: int, start: int,
                   cnt: int, bin_bytes: int = 1):
    """Stable partition of the lanes [start, start + cnt) of the [R, P]
    pane ``src`` into the same lanes of ``dst``: first the lanes whose bin
    of feature ``feat`` is <= ``thr``, in order, then the others, in
    order.  The bin is row ``feat`` read as uint8, or with ``bin_bytes``
    2 or 4 (a 16-bit or 32-bit pane) the little-endian number whose byte
    k is row ``feat + k * F``.  No other lane of either pane is written.

    Returns the left count as a 0-dim int32 tensor on the panes' device;
    reading it on the host is the caller's synchronisation."""
    R, P = src.shape
    require(src.dtype == torch.int8 and dst.dtype == torch.int8
            and dst.shape == src.shape and src.stride(1) == 1
            and dst.stride(1) == 1 and dst.device == src.device,
            "src and dst must be int8 [R, P] panes with contiguous rows on "
            "one device")
    require(src.untyped_storage().data_ptr()
            != dst.untyped_storage().data_ptr(),
            "src and dst must be different buffers")
    top = {1: 255, 2: 65535, 4: (1 << 31) - 1}.get(bin_bytes, -1)
    require(bin_bytes in (1, 2, 4) and 0 <= feat < F and bin_bytes * F <= R
            and 0 <= thr <= top,
            "need bin_bytes 1, 2 or 4, 0 <= feat < F, %d*F <= R and 0 <= "
            "thr <= %d" % (bin_bytes, top))
    require(0 <= start and 0 <= cnt and start + cnt <= P,
            "segment out of range")
    if src.device.type == "cpu":
        _count_launch("partition/plain", R, cnt)
        return pane_plain(src, dst, feat, thr, start, cnt, F, bin_bytes)
    if cnt == 0:                            # no lanes: nothing to launch
        return torch.zeros((), dtype=torch.int32, device=src.device)
    left = torch.empty((), dtype=torch.int32, device=src.device)
    lib = cuda_build.load("partition")
    _launch(lib.lgbm_partition_pane, src[:, start:], dst[:, start:],
            (R, cnt, feat, F, bin_bytes, thr), cnt, left)
    launch_rows.append(cnt)
    return left


def pane_plain(src, dst, feat: int, thr: int, start: int, cnt: int,
               F: int = 0, bin_bytes: int = 1):
    """Plain version of the pane entry: ``mask3`` from the bin's byte
    rows (row ``feat + k * F`` holds byte k), then ``partition_plain``
    on the segment alone."""
    seg = src[:, start:start + cnt]
    key = torch.zeros(cnt, dtype=torch.int64, device=src.device)
    for k in range(bin_bytes):
        key |= seg[feat + k * F].view(torch.uint8).to(torch.int64) << 8 * k
    go_left = key <= thr
    if cnt:
        mask3 = go_left.to(torch.int8)
        dst[:, start:start + cnt] = partition_plain(seg, mask3, 0, cnt)
    return go_left.sum(dtype=torch.int32)


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
        _count_launch("partition/plain", R, cnt)
        return partition_plain(seg, mask3, delta, cnt)
    # the kernel writes the segment's lanes only; the rest come from here
    out = seg.clone(memory_format=torch.contiguous_format)
    if cnt == 0:                            # no lanes: nothing to launch
        return out
    lib = cuda_build.load("partition")
    left = torch.empty((), dtype=torch.int32, device=seg.device)
    _launch(lib.lgbm_partition_mask, seg[:, delta:], out[:, delta:],
            (mask3[delta:].data_ptr(), R, cnt), cnt, left)
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
