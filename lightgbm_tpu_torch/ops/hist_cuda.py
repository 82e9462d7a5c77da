"""The histogram kernel's wrappers, their plain versions, and the int8
quantization — counterpart of lightgbm_tpu/ops/hist_pallas.py.

``hist_float`` and ``hist_int8`` compute the raw accumulator of the TPU
kernel ``_hist_pallas_raw_fn`` (hist_pallas.py:86):

    acc[f, b, 3*c + k] = sum over rows r with bins[f, r] == b and
                         cid[r] == c of val[k, r]

with val = (grad, hess, 1) in the float mode and the int8 levels of
``quantize_values`` in the int8 mode; rows whose cid lies outside
[0, num_cols) are excluded.  ``hist_pane_float`` computes the float mode
with one column straight from a slice of the compacted grower's plane
pane (ops/compact.py), over all its bin rows or one bin-width class of
them, so the grower's per-split histogram needs no unpacking.  Bins are
uint8 (B <= 256), 16-bit (B <= 65,536, int16 views, ops/bins.py) or
32-bit (int32 views; in the pane, two or four byte planes a feature).  A
pass wider than GLOBAL_BINS bins adds into global memory (``copies`` 0 in
the plan; csrc/hist.cu's header says why).  On a CUDA
tensor they launch csrc/hist.cu (its header says what bounds it and how
it is laid out) with the launch plan of ``plan``;
on a CPU tensor they run the plain version, an ``index_add_`` on
``(f*B + bin)*C + cid``.  There is no other route: a CUDA tensor that the
kernel refuses raises.  Each launch counts its route in telemetry
(``hist/cuda_float``, ``hist/cuda_int8``, ``hist/cuda_pane``) with its
analytic bytes and adds (costmodel.py); a plain version counts
``hist/plain_float``, ``hist/plain_int8`` or ``hist/plain_pane``.

The TPU kernel's operand tricks have no counterpart here, because the
CUDA kernel computes their target directly: the bf16 hi/lo split of the
float mode (hist_pallas.py:449-460) becomes 64-bit fixed-point
accumulation at one exponent per tree (``fixed_exponent``), whose sums
do not depend on the order of the atomics and so are the same on every
run, as the TPU grid's fixed order makes them there; the
single-pass bf16 operand mode (:510-522) is the float mode on values
the caller rounded to bf16 (ops/histogram.py), the ``bf16`` int-levels
mode is the int8 mode itself, and the 128/192-lane padding of the value
operand has no meaning for a scatter.
"""
from __future__ import annotations

import collections
import functools

import torch

from .. import costmodel, telemetry
from . import cuda_build
from .bins import bin_bytes, widen
from .compact import unpack_values
from .cuda_build import require

# kernel launches (every entry), and the row and column counts of the
# latest ones; chip_smoke.py resets them around each path it drives
launches = 0
launch_rows = collections.deque(maxlen=1 << 16)
launch_cols = collections.deque(maxlen=1 << 16)

# launch plan (csrc/hist.cu's header says why)
MAX_SMEM = 232448        # dynamic shared memory a block may use on sm_90
SM_SMEM = 233472         # shared memory of one SM
SM_THREADS = 2048        # resident threads of one SM
GROUP_CELLS = 1024       # accumulator (bin, column) cells per feature group
SLICE_BYTES = 196608     # most accumulator bytes of one feature a block
                         # holds; a larger one is cut into cell slices
COPIES_CELLS = 4096      # two accumulator copies where they fit this
BLOCKS_PER_SM = 8        # target resident blocks per SM
MIN_RESIDENT = 3         # the side band's tile leaves room for this many
                         # blocks on an SM where the accumulator allows
MIN_CHUNK_TILES = 1      # rows per block: at least this many tiles
# per mode: accumulator bytes per cell (int8: three int32; float and pane:
# two 64-bit fixed-point sums and an int32 count) and side-band words per
# row (int8: levels and column packed in one; float and pane: the two
# 8-byte fixed-point values and the column)
CELL_BYTES = {"float": 20, "int8": 12}
SIDE_WORDS = {"float": 5, "int8": 1}
FIXED_BITS = 62          # a fixed-point sum of N rows stays below 2^62
GLOBAL_BINS = 65536      # a pass of more bins than this (32-bit bins
                         # only) accumulates in global memory, not in
                         # shared-memory cell slices (PERF.md times both)


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2^32`` for x in [0, 2^32) (int64 tensor or int) and a
    32-bit constant c, exactly: c splits into 16-bit halves so no
    product passes 2^48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """hist_pallas.py:186-193: the murmur3 finalizer on uint32 values,
    carried as int64 in [0, 2^32) (or a Python int)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _f32_bits(x):
    """The f32 bit pattern of ``x`` as int64 in [0, 2^32)."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & _M32


def stochastic_bits(x, other, salt: int):
    """hist_pallas.py:196-213, bit for bit: per-element uniform uint32
    bits (as int64) keyed on the row's value pair and a per-pass
    ``salt``, so a row rounds alike wherever it sits."""
    key = _mix32((int(salt) + 0x9E3779B9) & _M32)
    return _mix32(_f32_bits(x) ^ _mix32(_f32_bits(other)) ^ key)


def quantize_values(grad, hess, col_ok, stochastic: bool = False,
                    salt: int = 0, max_reduce=None):
    """int8 quantization with a per-pass global scale — hist_pallas.py:
    216-269, bit for bit: round to nearest even, or with ``stochastic``
    unbiased ``floor(y + u)`` with u from ``stochastic_bits`` (salt for
    grad, salt + 0x51ED for hess).  ``max_reduce`` (a data-parallel
    world's): the pass maxima [2] f32 -> their maxima over the world,
    before the division, as the JAX ``axis_name`` pmax
    (hist_pallas.py:241-247), so every rank quantizes with the serial
    run's scale.  No rows: maxima 0.
    Returns (vals [3, N] int8 = (gq*ok, hq*ok, ok), scale [3] f32)."""
    okf = col_ok.to(torch.float32)
    if grad.numel():
        ag = torch.max(grad.abs() * okf)
        ah = torch.max(hess.abs() * okf)
    else:
        ag = ah = torch.zeros((), dtype=torch.float32, device=grad.device)
    if max_reduce is not None:
        ag, ah = max_reduce(torch.stack([ag, ah]))
    # divide by a tensor, not a Python number: CUDA turns division by a
    # host scalar into a multiplication by its reciprocal, which can round
    # the scale one ulp away from the CPU's (and the JAX package's)
    top = ag.new_tensor(127.0)
    gs = torch.clamp_min(ag, 1e-30) / top
    hs = torch.clamp_min(ah, 1e-30) / top

    def quant(x, s, bits):
        y = x / s
        if bits is None:
            q = torch.round(y)
        else:
            # (bits >> 8) < 2^24 and the factor 2^-24 are exact in f32
            q = torch.floor(y + (bits >> 8).to(torch.float32)
                            * (1.0 / (1 << 24)))
        return torch.clamp(q, -127, 127)

    gbits = hbits = None
    if stochastic:
        gbits = stochastic_bits(grad, hess, salt)
        hbits = stochastic_bits(hess, grad, salt + 0x51ED)
    gq = quant(grad, gs, gbits)
    hq = quant(hess, hs, hbits)
    vals = torch.stack([gq * okf, hq * okf, okf]).to(torch.int8)
    return vals, torch.stack([gs, hs, torch.ones_like(gs)])


def quant_saturation_count(grad, hess, comm=None):
    """Health gauge (hist_pallas.py:272-303, bit for bit): how many
    grad/hess entries quantize to the ±127 ceiling under
    ``quantize_values``' scale from the finite maximum (``|x|·127 >
    max·126.5``), as a 0-dim f32 tensor on their device.  The scale pins
    the max row at 127, so a few saturated rows are normal; a large count
    means the magnitudes have collapsed onto the ceiling (iteration 0's
    uniform hessians are the usual case).  Histogram passes quantize
    with masked scales at most this maximum, so read it as a floor.
    ``comm`` (the learner's group over ranks of sharded rows): each
    channel's maximum is max-reduced before the comparison
    (``health/quant_sat_pmax``) and the counts summed after it
    (``health/quant_sat_reduce``), so every rank reports the serial
    run's gauge.  Kept beside ``quantize_values`` so the two cannot
    drift."""
    f32 = torch.float32
    axs = [torch.where(torch.isfinite(x), x.abs(),
                       torch.zeros((), dtype=x.dtype, device=x.device))
           for x in (grad, hess)]
    m = torch.stack([ax.max() for ax in axs])
    if comm is not None:
        m = comm.all_reduce(m, "health/quant_sat_pmax", op="max")
    sat = torch.stack([(ax * 127.0 > m[i] * 126.5).to(f32).sum()
                       for i, ax in enumerate(axs)])
    if comm is not None:
        sat = comm.all_reduce(sat, "health/quant_sat_reduce")
    return sat[0] + sat[1]


def group_width(num_bins_max: int) -> int:
    """Columns a histogram pass takes at most: 64 where the JAX package
    takes its Pallas kernel on the TPU (8-bit bins), 42 where it never
    does (B > 256: ``hist_quant_xla`` and ``_leafbatch_einsum`` group at
    42 on every backend, hist_pallas.py:307-323, histogram.py:403-420)."""
    return 64 if num_bins_max <= 256 else 42


def grouped(fn, bins, grad, hess, col_id, col_ok, num_cols, B,
            group_width=64):
    """Split levels wider than ``group_width`` columns into balanced
    groups (hist_pallas.py:307-323): ceil-split so the last group is
    never a nearly-empty pass.  Each group masks its own rows, so in the
    int8 mode each group quantizes with its own scale, as in the JAX
    package."""
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


def _check_width(nb: int, B: int, num_cols: int) -> None:
    """The bin count a layout takes: B <= 256 for uint8 bins, <= 65,536
    for 16-bit ones, below 2^31 cells a feature for 32-bit ones."""
    top = {1: 256, 2: 65536}.get(nb, (1 << 31) - 1)
    require(1 <= B <= top and B * max(num_cols, 1) < 1 << 31,
            "need B <= 256 for uint8 bins, B <= 65536 for 16-bit bins, "
            "B * num_cols < 2^31 for 32-bit bins")


def _check(bins, cid, values, num_cols, B):
    F, N = bins.shape
    require(bins.dtype in (torch.uint8, torch.int16, torch.int32)
            and bins.stride(1) == 1,
            "bins must be uint8, int16 (16-bit bins) or int32 (32-bit "
            "bins) [F, N] with contiguous rows")
    _check_width(bin_bytes(bins), B, num_cols)
    require(cid.dtype == torch.int32 and cid.shape == (N,)
            and cid.is_contiguous(), "cid must be contiguous int32 [N]")
    for v in values:
        require(v.device == bins.device and cid.device == bins.device,
                "all inputs must be on one device")
        require(v.shape[-1] == N and v.is_contiguous(),
                "values must be contiguous [..., N]")
    require(1 <= num_cols, "need num_cols >= 1")


def fixed_exponent(grad, hess, n: int):
    """The float mode's fixed-point exponent for sums of at most ``n``
    rows of ``grad`` and ``hess``, as an int32 [1] tensor on their device:
    ``e = FIXED_BITS - ceil(log2(n * max(|grad|, |hess|)))``, so that
    every row's ``round(v * 2^e)`` and every sum of ``n`` of them stays
    below 2^62 (csrc/hist.cu).  Computed on the device with no host read;
    a tree computes it once over its (GOSS-amplified) gradients and every
    launch of the tree shares it."""
    top = torch.maximum(grad.abs().max(), hess.abs().max())
    mant, ex = torch.frexp(top.to(torch.float64) * max(int(n), 1))
    ceil_log2 = ex - (mant == 0.5).to(ex.dtype)     # 0 when all are 0
    return (FIXED_BITS - ceil_log2).clamp(-1000, 1000).to(
        torch.int32).reshape(1)


@functools.lru_cache(maxsize=None)
def _shape_plan(F: int, B: int, C: int, mode: str, sms: int):
    """The part of ``plan`` that does not depend on the row count:
    (threads, g, copies, groups, slices, slice_cells, {vec: (tile, smem,
    blocks per SM)})."""
    cell, side_words = CELL_BYTES[mode], SIDE_WORDS[mode]
    if B > GLOBAL_BINS:
        # no accumulator in shared memory: one slice of every cell, up to
        # 8 features a block sharing the staged side band
        slices, slice_cells, g = 1, B * C, min(8, F)
    else:
        # a feature's B*C cells in slices of at most SLICE_BYTES of
        # accumulator
        slices = -(-B * C * cell // SLICE_BYTES)
        slice_cells = -(-B * C // slices)
        g = max(1, min(8, F, GROUP_CELLS // slice_cells))
    groups = -(-F // g)
    g = -(-F // groups)
    copies = (0 if B > GLOBAL_BINS
              else 2 if 2 * g * slice_cells <= COPIES_CELLS else 1)
    acc = -(-copies * g * slice_cells * cell // 16) * 16
    threads = 512 if 2 * (acc + 1024) > SM_SMEM else 256
    # side-band bytes that keep MIN_RESIDENT blocks on an SM, where the
    # accumulator leaves any (a float feature of 1022 bins would otherwise
    # stage 4,096 rows of 20-byte side band and hold one block an SM)
    room = SM_SMEM // MIN_RESIDENT - 1024 - acc
    by_vec = {}
    for vec in (16, 4):
        # one pad word per vec rows of the side band
        row_bytes = side_words * 4 * (vec + 1) / vec
        cap = int(room // row_bytes) if room >= 16 * row_bytes else 1 << 30
        tile = min(threads * vec // g, int((MAX_SMEM - acc) // row_bytes),
                   cap) // 16 * 16
        smem = acc + side_words * 4 * (tile + tile // vec)
        by_vec[vec] = (tile, smem, min(SM_THREADS // threads,
                                       SM_SMEM // (smem + 1024),
                                       BLOCKS_PER_SM))
    return threads, g, copies, groups, slices, slice_cells, by_vec


def plan(n: int, F: int, B: int, C: int, mode: str, shift: int,
         sms: int):
    """Launch plan of csrc/hist.cu for ``n`` rows starting ``shift`` rows
    past a 16-byte boundary: (vec, threads, g, copies, tile, chunk,
    groups, chunks, smem, slices, slice_cells).  Blocks take g features
    (about GROUP_CELLS cells of accumulator) and ``chunk`` rows (a
    multiple of the staged ``tile``, which leaves room for MIN_RESIDENT
    blocks an SM where the accumulator allows); a feature whose
    accumulator passes SLICE_BYTES (16-bit bins at wide B or C, or the
    float mode at C > 38) is cut into ``slices`` ranges of
    ``slice_cells`` (bin, column) cells, one block each; a pass of more
    than GLOBAL_BINS bins keeps none (``copies`` 0, one slice) and adds
    into global memory.  Chunks are
    sized for BLOCKS_PER_SM resident blocks on each of ``sms`` SMs;
    ``mode`` ("float", which the pane entry shares, or "int8") sets the
    cell and side-band sizes.  Each thread takes ``vec`` rows of one
    feature per load: 16
    where that still gives every SM its full complement of threads and
    keeps at least three quarters of a block's threads busy, else 4, so
    a small segment spreads over more threads.  Where a block's
    accumulator leaves room for one block per SM (wide C), the block has
    512 threads instead of 256.  All but the row split is cached per
    shape, so a launch pays a few integer operations."""
    threads, g, copies, groups, slices, slice_cells, by_vec = _shape_plan(
        F, B, C, mode, sms)
    rows = max(n + shift, 1)
    vec = 16 if (F * rows >= 16 * SM_THREADS * sms
                 and by_vec[16][0] * g >= 12 * threads) else 4
    tile, smem, per_sm = by_vec[vec]
    require(tile >= 16, "histogram accumulator does not fit shared memory "
            "(B=%d, num_cols=%d)" % (B, C))
    chunks = -(-per_sm * sms // (groups * slices))
    chunk = max(MIN_CHUNK_TILES * tile, -(-rows // chunks))
    chunk = -(-chunk // tile) * tile
    chunks = -(-rows // chunk)
    return (vec, threads, g, copies, tile, chunk, groups, chunks, smem,
            slices, slice_cells)


# side-band bytes a row, per route (PERF.md's bound formulas): the float
# mode reads grad, hess and the column id, int8 its three levels and the
# column id, the pane entry its grad, hess and validity planes; a plain
# version computes the same function, so it files the same work
_SIDE_BYTES = {"hist/cuda_float": 12, "hist/cuda_int8": 7,
               "hist/cuda_pane": 9, "hist/plain_float": 12,
               "hist/plain_int8": 7, "hist/plain_pane": 9}


def _count_launch(route: str, bin_bytes_: int, n: int, f: int, b: int,
                  c: int) -> None:
    """The launch's route counter and its analytic cost (costmodel.py),
    both under the ``histogram`` phase; a flag check while telemetry is
    off."""
    if telemetry.enabled():
        telemetry.count(route)
        nbytes, adds = costmodel.hist_cost(bin_bytes_, n, f, b, c,
                                           _SIDE_BYTES[route])
        costmodel.note_launch("histogram", route, bytes=nbytes, flops=adds)


def _launch(entry, bins, args, num_cols, B, mode, out, route, layout=(),
            fixed=(), nb=None):
    """``route``: the launch's counter name (``_SIDE_BYTES``);
    ``layout``: the entry's bin-layout argument, if it takes one;
    ``fixed``: the float modes' (exponent, scratch) pointers; ``nb``:
    bytes a bin (by default ``bins``' own)."""
    global launches
    F, N = bins.shape
    if N == 0 or F == 0:
        return out.zero_()                  # no rows: nothing to launch
    shift = bins.data_ptr() % 16 // bins.element_size()
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    rc = entry(bins.data_ptr(), bins.stride(0), *args, N, F, B, num_cols,
               shift, *layout, *plan(N, F, B, num_cols, mode, shift,
                                     cuda_build.num_sms(bins.device)),
               *fixed, out.data_ptr(), stream)
    cuda_build.check(rc, "hist kernel")
    launches += 1
    _count_launch(route, bin_bytes(bins) if nb is None else nb, N, F, B,
                  num_cols)
    launch_rows.append(N)
    launch_cols.append(num_cols)
    return out


def _fixed_args(exponent, device, cells: int, grad, hess, n: int):
    """(exponent, scratch) of a float-mode launch, which the caller holds
    until the launch is queued, and the pointers the entry takes:
    ``exponent`` as given (a tree's, from ``fixed_exponent``) or this
    launch's own; scratch for the fixed-point sums and counts, 20 bytes a
    cell."""
    if exponent is None:
        exponent = fixed_exponent(grad, hess, n)
    require(exponent.dtype == torch.int32 and exponent.numel() == 1
            and exponent.device == device,
            "exponent must be one int32 on the histogram's device")
    scratch = torch.empty(cells * 5, dtype=torch.int32, device=device)
    return (exponent, scratch), (exponent.data_ptr(), scratch.data_ptr())


def hist_float(bins, grad, hess, cid, num_cols: int, B: int,
               exponent=None):
    """[F, B, 3*num_cols] f32 accumulator of (grad, hess, 1).  On the
    card the sums are fixed point at ``exponent`` (``fixed_exponent``;
    by default this call's own), so they are the same on every run."""
    _check(bins, cid, (grad, hess), num_cols, B)
    if bins.device.type == "cpu":
        _count_launch("hist/plain_float", bin_bytes(bins), bins.shape[1],
                      bins.shape[0], B, num_cols)
        ones = torch.ones_like(grad)
        return hist_plain(bins, torch.stack([grad, hess, ones], 1), cid,
                          num_cols, B)
    require(grad.dtype == torch.float32 and hess.dtype == torch.float32,
            "grad and hess must be float32")
    F, N = bins.shape
    out = torch.empty((F, B, 3 * num_cols), dtype=torch.float32,
                      device=bins.device)
    lib = cuda_build.load("hist")
    _held, fixed = _fixed_args(exponent, bins.device, F * B * num_cols, grad,
                              hess, N)
    return _launch(lib.lgbm_hist_f32, bins,
                   (grad.data_ptr(), hess.data_ptr(), cid.data_ptr()),
                   num_cols, B, "float", out, "hist/cuda_float",
                   (bin_bytes(bins),), fixed)


def hist_int8(bins, levels, cid, num_cols: int, B: int):
    """[F, B, 3*num_cols] int32 accumulator of int8 ``levels`` [3, N]."""
    _check(bins, cid, (levels,), num_cols, B)
    # the kernel stages a row's column id in one byte, 0xFF for "dropped"
    require(num_cols <= 255, "the int8 mode takes num_cols <= 255")
    if bins.device.type == "cpu":
        _count_launch("hist/plain_int8", bin_bytes(bins), bins.shape[1],
                      bins.shape[0], B, num_cols)
        return hist_plain(bins, levels.t().to(torch.int32), cid, num_cols, B)
    require(levels.dtype == torch.int8 and levels.shape[0] == 3,
            "levels must be int8 [3, N]")
    F = bins.shape[0]
    out = torch.empty((F, B, 3 * num_cols), dtype=torch.int32,
                      device=bins.device)
    lib = cuda_build.load("hist")
    return _launch(lib.lgbm_hist_i8, bins,
                   (levels.data_ptr(), levels.stride(0), cid.data_ptr()),
                   num_cols, B, "int8", out, "hist/cuda_int8",
                   (bin_bytes(bins),))


def hist_pane_float(pane, F: int, sstart: int, scnt: int, B: int,
                    rows=None, bin_bytes: int = 1, exponent=None):
    """[Fr, B, 3] f32 histogram of (grad, hess, 1) over the valid rows of
    the plane-pane lanes [sstart, sstart + scnt): ``build_histogram`` of
    ``unpack_values(pane[:, sstart:sstart + scnt], F, bin_bytes)``, read
    in place.  ``rows`` = (first, count) takes the bin rows [first, first
    + count) of the F (one bin-width class of a packed pane), Fr = count;
    all F by default.  ``bin_bytes`` 2 or 4: a 16-bit or 32-bit pane
    (ops/compact.py).
    ``exponent``: as ``hist_float``'s; by default from the segment's
    values."""
    R, P = pane.shape
    first, Fr = rows if rows is not None else (0, F)
    require(pane.dtype == torch.int8 and pane.stride(1) == 1,
            "pane must be int8 [R, P] with contiguous rows")
    require(bin_bytes in (1, 2, 4) and R >= bin_bytes * F + 9,
            "need bin_bytes 1, 2 or 4 and bin_bytes * F + 9 pane rows")
    _check_width(bin_bytes, B, 1)
    require(0 <= first and 0 <= Fr and first + Fr <= F,
            "bin rows out of range")
    require(0 <= sstart and 0 <= scnt and sstart + scnt <= P,
            "segment out of range")
    if scnt == 0:                           # no rows: nothing to launch
        return torch.zeros((Fr, B, 3), dtype=torch.float32,
                           device=pane.device)
    seg = pane[:, sstart:sstart + scnt]
    if pane.device.type == "cpu":
        _count_launch("hist/plain_pane", bin_bytes, scnt, Fr, B, 1)
        return pane_plain(seg, F, B, (first, Fr), bin_bytes)
    out = torch.empty((Fr, B, 3), dtype=torch.float32, device=pane.device)
    lib = cuda_build.load("hist")
    planes = seg[bin_bytes * F:bin_bytes * F + 9]
    grad = hess = None
    if exponent is None:
        _, grad, hess, _ = unpack_values(seg, F, bin_bytes)
    _held, fixed = _fixed_args(exponent, pane.device, Fr * B, grad, hess,
                              scnt)
    return _launch(lib.lgbm_hist_pane,
                   seg[first:first + Fr].view(torch.uint8),
                   (F * seg.stride(0), bin_bytes, planes.data_ptr()), 1,
                   B, "float", out, "hist/cuda_pane", fixed=fixed,
                   nb=bin_bytes)


def pane_plain(seg, F: int, B: int, rows=None, bin_bytes: int = 1):
    """Plain version of the pane entry: unpack the slice, then the float
    mode's plain version with column 0 for valid rows."""
    first, Fr = rows if rows is not None else (0, F)
    bins, grad, hess, valid = unpack_values(seg, F, bin_bytes)
    cid = torch.where(valid, 0, -1).to(torch.int32)
    return hist_plain(bins[first:first + Fr],
                      torch.stack([grad, hess, torch.ones_like(grad)], 1),
                      cid, 1, B)


def hist_plain(bins, vals, cid, num_cols: int, B: int):
    """Plain version of the kernel: ``index_add_`` of ``vals`` [N, 3]
    (f32 or int32) on ``(f*B + bin)*C + cid``; excluded rows and bins
    >= B land in a dropped bucket."""
    F, N = bins.shape
    C = num_cols
    b = widen(bins).long()
    keep = ((cid >= 0) & (cid < C))[None, :] & (b < B)
    f_idx = torch.arange(F, device=bins.device)[:, None]
    idx = (f_idx * B + b) * C + cid.long().clamp(0, C - 1)[None, :]
    idx = torch.where(keep, idx, F * B * C)
    out = torch.zeros((F * B * C + 1, 3), dtype=vals.dtype,
                      device=bins.device)
    out.index_add_(0, idx.reshape(-1),
                   vals[None].expand(F, N, 3).reshape(-1, 3))
    return out[:-1].reshape(F, B, 3 * C)
