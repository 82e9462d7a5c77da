"""lightgbm_tpu_torch plane pane and row partition vs the JAX package.

Everything here is integer or byte movement, so every comparison is
bitwise: the pane packing (f32 grad/hess as byte planes), the bucket
table, and ``partition_segment`` against both of the JAX package's
versions — the stable-argsort oracle and the Pallas kernel in interpret
mode, in both DMA schedules — on the shapes of tests/test_leafcompact.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops import compact as jc
from lightgbm_tpu_torch.ops import compact as tc


def _case(rng, R, W, delta, cnt):
    seg = rng.randint(-128, 128, (R, W)).astype(np.int8)
    m = rng.randint(0, 2, W).astype(np.int8)
    lane = np.arange(W)
    mask3 = np.where((lane >= delta) & (lane < delta + cnt), m, -1)
    return seg, mask3.astype(np.int8), int((mask3 == 1).sum())


def _port(seg, mask3, delta, cnt, plcnt):
    return tc.partition_segment(torch.as_tensor(seg), torch.as_tensor(mask3),
                                delta, cnt, plcnt).numpy()


def _jax(seg, mask3, delta, cnt, plcnt, **kw):
    return np.asarray(jc.partition_segment(
        jnp.asarray(seg), jnp.asarray(mask3), jnp.int32(delta),
        jnp.int32(cnt), jnp.int32(plcnt), block=2048, **kw))


@pytest.mark.parametrize("delta,cnt", [
    (0, 4096), (0, 4000), (100, 3000), (4095, 1), (0, 1), (123, 0),
])
def test_partition_vs_oracle_and_kernel(delta, cnt):
    rng = np.random.RandomState(delta + cnt)
    seg, mask3, plcnt = _case(rng, 11, 4096, delta, cnt)
    want = _jax(seg, mask3, delta, cnt, plcnt)
    np.testing.assert_array_equal(_port(seg, mask3, delta, cnt, plcnt), want)
    np.testing.assert_array_equal(
        want, _jax(seg, mask3, delta, cnt, plcnt, use_pallas=True,
                   interpret=True))


@pytest.mark.parametrize("delta,cnt", [
    (0, 8192), (777, 6000), (2047, 4097), (100, 3000), (4095, 2049),
])
def test_partition_vs_both_kernel_schedules(delta, cnt):
    rng = np.random.RandomState(delta * 7 + cnt)
    seg, mask3, plcnt = _case(rng, 13, 8192, delta, cnt)
    got = _port(seg, mask3, delta, cnt, plcnt)
    for overlap in (False, True):
        np.testing.assert_array_equal(
            got, _jax(seg, mask3, delta, cnt, plcnt, use_pallas=True,
                      interpret=True, overlap=overlap))


def test_partition_strided_pane_slice():
    """The grower partitions a column slice of the pane (row stride P)."""
    rng = np.random.RandomState(1)
    seg, mask3, plcnt = _case(rng, 8, 4096, 50, 3000)
    pane = np.zeros((8, 10_000), np.int8)
    pane[:, 2000:6096] = seg
    view = torch.as_tensor(pane)[:, 2000:6096]
    got = tc.partition_segment(view, torch.as_tensor(mask3), 50, 3000,
                               plcnt).numpy()
    np.testing.assert_array_equal(got, _port(seg, mask3, 50, 3000, plcnt))


def test_pack_unpack_bitwise():
    rng = np.random.RandomState(1)
    N, F = 1000, 4
    bins = rng.randint(0, 256, (F, N)).astype(np.uint8)
    grad = rng.randn(N).astype(np.float32) * 1e3
    hess = np.abs(rng.randn(N)).astype(np.float32) * 1e-3
    mask = rng.rand(N) < 0.7
    want = np.asarray(jc.pack_planes(*map(jnp.asarray,
                                          (bins, grad, hess, mask)), 2048))
    got = tc.pack_planes(*map(torch.as_tensor, (bins, grad, hess, mask)),
                         2048)
    assert got.shape == (tc.pane_rows(F), 2048) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    b, g, h, v = tc.unpack_values(got[:, :N], F)
    np.testing.assert_array_equal(b.numpy(), bins)
    np.testing.assert_array_equal(g.numpy(), grad)
    np.testing.assert_array_equal(h.numpy(), hess)
    np.testing.assert_array_equal(v.numpy(), mask)


@pytest.mark.parametrize("n", [1, 2048, 100_000, 1_000_000, 11_000_000])
def test_bucket_table_and_pane_rows(n):
    assert tc.bucket_table(n) == jc.bucket_table(n)
    assert tc.bucket_table(n, min_width=n >> 9) == \
        jc.bucket_table(n, min_width=n >> 9)
    for f in (1, 5, 28, 200):
        assert tc.pane_rows(f) == jc.pane_rows(f)

