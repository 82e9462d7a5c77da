"""The histogram kernel's pane entry (``hist_cuda.hist_pane_float``) against
the JAX package, through its plain version on the CPU, and the kernel's
launch plan (``hist_cuda.plan``), which is plain arithmetic on shapes.
tests/test_torch_cuda.py holds the CUDA kernel against the same plain
version on the card.

Each case packs one numpy table into a plane pane with the JAX package's
``pack_planes`` and histograms a segment of it two ways: the JAX
package's ``unpack_values`` and histogram, and the port's pane entry on
the same pane.  Segments start at lanes off the 16-byte boundary, hold 0,
1, 15, 16, 17 or a few thousand rows, carry bins >= 128 and rows the
validity plane drops.  Tolerances: counts exact; grad and hess sums
rtol 1e-5, atol 1e-5 against the f32 scatter oracle (the same terms
added in another order; the atol covers sums that cancel to near zero);
against the Pallas kernel's f32 hi/lo split in interpret mode, the error
budget of tests/test_hist_float_pallas.py (as in test_torch_hist.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._pltpu_probe import requires_pltpu_interpret

from lightgbm_tpu.ops import compact as jcompact
from lightgbm_tpu.ops import hist_pallas as jhp
from lightgbm_tpu.ops.histogram import histogram_leafbatch_segsum
from lightgbm_tpu_torch.ops import compact, hist_cuda
from lightgbm_tpu_torch.ops.histogram import build_histogram

F, B, N, P = 6, 256, 8000, 8192


def _pane(seed):
    """[pane_rows(F), P] int8 numpy pane from the JAX package's packer:
    uint8 bins over the full 0..255 range, ~20% of rows dropped."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, N)).astype(np.uint8)
    grad = (rng.randn(N) * 0.4).astype(np.float32)
    hess = (rng.rand(N) * 0.25).astype(np.float32)
    keep = rng.rand(N) < 0.8
    return np.array(jcompact.pack_planes(
        *map(jnp.asarray, (bins, grad, hess, keep)), P))


def _jax_unpacked(pane, sstart, scnt):
    return jcompact.unpack_values(jnp.asarray(pane[:, sstart:sstart + scnt]),
                                  F)


@pytest.mark.parametrize("sstart,scnt", [
    (0, 0), (5, 1), (17, 15), (3, 16), (1001, 17), (2049, 3000),
    (777, 4093)])
def test_pane_entry_vs_jax_segsum(sstart, scnt):
    pane = _pane(sstart + scnt)
    got = hist_cuda.hist_pane_float(torch.as_tensor(pane), F, sstart, scnt,
                                    B).numpy()
    assert got.shape == (F, B, 3) and got.dtype == np.float32
    if scnt == 0:
        assert not got.any()
        return
    bins, grad, hess, valid = _jax_unpacked(pane, sstart, scnt)
    want = np.asarray(histogram_leafbatch_segsum(
        bins, grad, hess, jnp.zeros(scnt, jnp.int32), valid, 1, B))[0]
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert want[0, :, 2].sum() == np.asarray(valid).sum()


@requires_pltpu_interpret
def test_pane_entry_vs_pallas_f32_interpret():
    from jax.experimental.pallas import tpu as pltpu
    sstart, scnt = 1001, 3000
    pane = _pane(11)
    bins, grad, hess, valid = _jax_unpacked(pane, sstart, scnt)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jhp.hist_pallas_float_leafbatch(
            bins, grad, hess, jnp.zeros(scnt, jnp.int32), valid, 1, B,
            chunk=1024, precision="f32"))[0]
    got = hist_cuda.hist_pane_float(torch.as_tensor(pane), F, sstart, scnt,
                                    B).numpy()
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    maxv = max(np.abs(np.asarray(grad)).max(), np.abs(np.asarray(hess)).max())
    bound = got[..., 2:3] * maxv * 2.0 ** -15 + 1e-5
    assert (np.abs(got - want)[..., :2] <= bound).all()


@pytest.mark.parametrize("sstart,scnt", [(0, 1), (1001, 17), (777, 4093)])
def test_pane_entry_is_unpack_then_build_histogram(sstart, scnt):
    """The grower's float child pass went through ``unpack_values`` and
    ``build_histogram``; the pane entry's plain version is that, bit for
    bit, so the CPU trees cannot move."""
    pane = torch.as_tensor(_pane(3))
    got = hist_cuda.hist_pane_float(pane, F, sstart, scnt, B)
    want = build_histogram(
        *compact.unpack_values(pane[:, sstart:sstart + scnt], F), B)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["range", "rows", "dtype"])
def test_pane_entry_refuses_what_the_kernel_does_not_take(bad):
    pane = torch.as_tensor(_pane(4))
    args = {"range": (pane, F, 8000, 500), "rows": (pane[:F + 8], F, 0, 10),
            "dtype": (pane.view(torch.uint8), F, 0, 10)}[bad]
    with pytest.raises(ValueError):
        hist_cuda.hist_pane_float(*args, B)


# F, C, mode ("float": the float and pane entries, 20-byte cells and 5
# side-band words a row; "int8": 12-byte cells, 1 word)
PLAN_SHAPES = [(28, 1, "float"), (28, 1, "int8"), (28, 42, "float"),
               (28, 64, "float"), (28, 64, "int8"), (200, 1, "float"),
               (3, 7, "float"), (1, 1, "float")]


@pytest.mark.parametrize("n", [1, 17, 4000, 50_000, 1_000_000])
@pytest.mark.parametrize("F,C,side", PLAN_SHAPES)
def test_launch_plan_fits_and_covers(n, F, C, side):
    """Every plan fits shared memory and covers each feature and row once:
    csrc/hist.cu refuses a plan that does not, and its layout of the
    accumulator and side band is the one sized here."""
    cell, words = hist_cuda.CELL_BYTES[side], hist_cuda.SIDE_WORDS[side]
    for shift in (0, 9):
        (vec, threads, g, copies, tile, chunk, groups, chunks, smem, slices,
         slice_cells) = hist_cuda.plan(n, F, B, C, side, shift, 132)
        assert vec in (4, 16) and threads in (256, 512)
        assert smem <= hist_cuda.MAX_SMEM
        # every 8-bit int8 accumulator fits one slice; the float mode's
        # 20-byte cells pass one slice's SLICE_BYTES above 38 columns
        assert slices == (2 if side == "float" and C > 38 else 1)
        assert (slices - 1) * slice_cells < B * C <= slices * slice_cells
        acc = -(-copies * g * slice_cells * cell // 16) * 16
        assert smem == acc + words * 4 * (tile + tile // vec)
        assert tile % 16 == 0 and chunk % tile == 0
        assert (groups - 1) * g < F <= groups * g
        assert (chunks - 1) * chunk < n + shift <= chunks * chunk
        assert g * tile // vec <= threads      # one load per thread a tile


@pytest.mark.parametrize("F,C,side", PLAN_SHAPES)
def test_bench_plan_copy_is_the_wrappers_plan(F, C, side):
    """scripts/hist_port_bench.py times variants of a written-out copy of
    the plan; with no override the copy is the wrapper's plan."""
    from scripts import hist_port_bench
    for n in (1, 4000, 1_000_000):
        for shift in (0, 9):
            assert hist_port_bench.bench_plan(
                n, F, B, C, side, shift, 132, hist_cuda) == \
                hist_cuda.plan(n, F, B, C, side, shift, 132)


def test_launch_plan_fills_the_card_at_child_sizes():
    """Main-path shapes (F=28, B=256, one column, on 132 SMs): the root
    runs on a few hundred blocks of about 3K cells each, and children of
    4,000 and 50,000 rows on about a hundred blocks and more."""
    def blocks(n):
        p = hist_cuda.plan(n, 28, B, 1, "float", 9, 132)
        return p[6] * p[7], p[2] * B * 3
    root_blocks, cells = blocks(1_000_000)
    assert 300 <= root_blocks <= 1100 and cells == 3072
    assert blocks(50_000)[0] >= 300
    assert blocks(4000)[0] >= 100


@pytest.mark.parametrize("C", [255, 256])
def test_int8_takes_at_most_255_columns(C):
    """The int8 kernel stages each row's column id in one byte, 0xFF for a
    dropped row, so 256 columns or more are refused on every device rather
    than wrapped on the card."""
    rng = np.random.RandomState(C)
    n, B = 300, 16
    bins = torch.as_tensor(rng.randint(0, B, (3, n)).astype(np.uint8))
    levels = torch.as_tensor(rng.randint(-127, 128, (3, n)).astype(np.int8))
    cid = torch.as_tensor(rng.randint(0, C, n).astype(np.int32))
    if C > 255:
        with pytest.raises(ValueError):
            hist_cuda.hist_int8(bins, levels, cid, C, B)
        return
    got = hist_cuda.hist_int8(bins, levels, cid, C, B)
    assert got.shape == (3, B, 3 * C)
    assert int(got[..., 2::3].sum()) == 3 * int(levels[2].long().sum())
