"""lightgbm_tpu_torch histograms vs the JAX package, through the kernel's
plain version on the CPU (tests/test_torch_cuda.py holds the CUDA kernel
against that plain version on the card).

Same inputs, made with numpy, go through the JAX function and the port's
counterpart.  Tolerances:
- int8 mode and ``quantize_values``: bitwise (int32 sums are order-free);
- float mode vs the f32 scatter oracle: rtol 1e-5, atol 1e-5 — both are
  f32 sums of the same terms in different orders; the atol covers cells
  whose grad sum cancels to near zero;
- float mode vs the Pallas kernel's f32 hi/lo split (interpret mode): the
  error budget of tests/test_hist_float_pallas.py (|eps| <= 2^-16 per
  operand value, so n rows of max |v| drift <= n * max|v| * 2^-15).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests._pltpu_probe import requires_pltpu_interpret

from lightgbm_tpu.ops import hist_pallas as jhp
from lightgbm_tpu.ops.histogram import histogram_leafbatch_segsum
from lightgbm_tpu_torch.ops import hist_cuda
from lightgbm_tpu_torch.ops.histogram import (build_histogram,
                                              histogram_leafbatch)


def _inputs(seed, F, N, B, C):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, N)).astype(np.uint8)
    grad = (rng.randn(N) * 0.4).astype(np.float32)
    hess = (rng.rand(N) * 0.25).astype(np.float32)
    cid = rng.randint(0, C, N).astype(np.int32)
    ok = rng.rand(N) < 0.85
    return bins, grad, hess, cid, ok


def _port(bins, grad, hess, cid, ok, C, B, dtype, device="cpu"):
    t = lambda a: torch.as_tensor(a, device=device)
    out = histogram_leafbatch(t(bins), t(grad), t(hess), t(cid), t(ok), C, B,
                              compute_dtype=dtype)
    return out.cpu().numpy()


def _jax(a):
    return [jnp.asarray(x) for x in a]


# uint8 bins up to 255 (>= 128), ragged N, and level widths across the
# 64-column grouping rule (100 -> two groups of 50)
@pytest.mark.parametrize("C", [1, 42, 64, 100])
def test_int8_bitwise_vs_xla(C):
    bins, grad, hess, cid, ok = _inputs(C, 6, 3001, 256, C)
    args = _jax((bins, grad, hess, cid, ok))
    if C <= 42:
        want = np.asarray(jhp.hist_quant_xla(*args, C, 256))
    else:
        # each column group quantizes with its own scale, so wide levels
        # compare at the Pallas route's 64-column grouping (the port's);
        # hist_quant_xla's own default groups at 42 (one MXU tile)
        want = np.asarray(jhp._grouped(
            jhp._hist_quant_xla_one, *args, C, 256, group_width=64,
            chunk=65536, rng_bits=None))
    got = _port(bins, grad, hess, cid, ok, C, 256, "int8")
    assert got.shape == (C, 6, 256, 3)
    np.testing.assert_array_equal(got, want)


@requires_pltpu_interpret
@pytest.mark.parametrize("C", [5, 70])
def test_int8_bitwise_vs_pallas_interpret(C):
    from jax.experimental.pallas import tpu as pltpu
    bins, grad, hess, cid, ok = _inputs(100 + C, 4, 1500, 256, C)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jhp.hist_pallas_leafbatch(
            *_jax((bins, grad, hess, cid, ok)), C, 256, chunk=512,
            dtype="int8"))
    got = _port(bins, grad, hess, cid, ok, C, 256, "int8")
    np.testing.assert_array_equal(got, want)


def test_quantize_values_bitwise():
    rng = np.random.RandomState(3)
    N = 5000
    grad = (rng.randn(N) * 3).astype(np.float32)
    hess = rng.rand(N).astype(np.float32)
    ok = rng.rand(N) < 0.7
    jv, js = jhp.quantize_values(*_jax((grad, hess, ok)))
    tv, ts = hist_cuda.quantize_values(*map(torch.as_tensor,
                                            (grad, hess, ok)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("C", [1, 42, 64, 100])
def test_float_vs_segsum(C):
    bins, grad, hess, cid, ok = _inputs(7 + C, 5, 4001, 256, C)
    want = np.asarray(histogram_leafbatch_segsum(
        *_jax((bins, grad, hess, cid, ok)), C, 256))
    got = _port(bins, grad, hess, cid, ok, C, 256, "float32")
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@requires_pltpu_interpret
def test_float_vs_pallas_f32_interpret():
    from jax.experimental.pallas import tpu as pltpu
    F, N, B, C = 5, 4000, 32, 7
    bins, grad, hess, cid, ok = _inputs(7, F, N, B, C)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jhp.hist_pallas_float_leafbatch(
            *_jax((bins, grad, hess, cid, ok)), C, B, chunk=1024,
            precision="f32"))
    got = _port(bins, grad, hess, cid, ok, C, B, "float32")
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    maxv = max(np.abs(grad).max(), np.abs(hess).max())
    bound = got[..., 2:3] * maxv * 2.0 ** -15 + 1e-5
    assert (np.abs(got - want)[..., :2] <= bound).all()


def test_build_histogram_is_one_column_batch():
    bins, grad, hess, _, ok = _inputs(5, 4, 2000, 64, 1)
    t = torch.as_tensor
    for dtype in ("float32", "int8"):
        one = build_histogram(t(bins), t(grad), t(hess), t(ok), 64, dtype)
        batch = histogram_leafbatch(
            t(bins), t(grad), t(hess), torch.zeros(2000, dtype=torch.int32),
            t(ok), 1, 64, dtype)[0]
        assert torch.equal(one, batch)


def test_strided_bins_rows():
    """The grower hands the kernel a column slice of the pane (row stride
    larger than N): the wrapper must take it without a copy or a
    difference."""
    bins, grad, hess, cid, ok = _inputs(9, 3, 3000, 32, 1)
    wide = np.zeros((3, 5000), np.uint8)
    wide[:, 1000:4000] = bins
    t = torch.as_tensor
    view = t(wide)[:, 1000:4000]
    assert view.stride(0) == 5000
    got = histogram_leafbatch(view, t(grad), t(hess), t(cid), t(ok), 1, 32)
    want = histogram_leafbatch(t(bins), t(grad), t(hess), t(cid), t(ok), 1,
                               32)
    assert torch.equal(got, want)

