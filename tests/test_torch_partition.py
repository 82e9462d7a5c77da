"""lightgbm_tpu_torch plane pane and row partition vs the JAX package.

Everything here is integer or byte movement, so every comparison is
bitwise: the pane packing (f32 grad/hess as byte planes), the bucket
table, ``partition_segment`` against both of the JAX package's versions —
the stable-argsort oracle and the Pallas kernel in interpret mode, in both
DMA schedules — on the shapes of tests/test_leafcompact.py, and the
grower's pane entry ``partition_pane`` against the JAX grower's partition
branch.
"""
import numpy as np
import jax
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



def _jax_branch(pane, F, feat, thr, start, cnt):
    """The JAX grower's partition branch (grower_unified.py:1076-1100):
    mask3 from the bin row at the segment's bucket width, the oracle
    partition, the slice written back.  Returns (pane, plcnt)."""
    R, P = pane.shape
    table = jc.bucket_table(P, min_width=max(2048, P >> 9))
    W = table[sum(1 for w in table if w >= max(cnt, 1)) - 1]
    cs = min(start, P - W)
    delta = start - cs
    seg = jnp.asarray(pane[:, cs:cs + W])
    fbin = seg[feat].astype(jnp.int32) & 255
    lane = jnp.arange(W, dtype=jnp.int32)
    inseg = (lane >= delta) & (lane < delta + cnt)
    go_right = fbin > thr
    mask3 = jnp.where(inseg, jnp.where(go_right, 0, 1), -1).astype(jnp.int8)
    plcnt = jnp.sum(inseg & ~go_right).astype(jnp.int32)
    new_seg = jc.partition_segment(seg, mask3, jnp.int32(delta),
                                   jnp.int32(cnt), plcnt, block=2048)
    out = jax.lax.dynamic_update_slice(jnp.asarray(pane), new_seg,
                                       (jnp.int32(0), jnp.int32(cs)))
    return np.asarray(out), int(plcnt)


def _pane_case(seed, F, P):
    """A random pane whose row 0 holds bins across 0-255 and whose row 1
    holds bins of 10 or more, and a random destination pane."""
    rng = np.random.RandomState(seed)
    R = tc.pane_rows(F)
    src = rng.randint(-128, 128, (R, P)).astype(np.int8)
    src[1] = rng.randint(10, 256, P).astype(np.uint8).view(np.int8)
    dst = rng.randint(-128, 128, (R, P)).astype(np.int8)
    return src, dst


# cnt around one kernel tile and a bucket block, at aligned and unaligned
# starts; thresholds in the sign byte, all left, and under every bin
@pytest.mark.parametrize("start,cnt", [
    (0, 0), (5, 1), (1, 2047), (2048, 2048), (13, 2049), (4099, 4093),
    (0, 8192)])
@pytest.mark.parametrize("feat,thr", [(0, 127), (0, 128), (0, 200),
                                      (0, 255), (1, 9)])
def test_pane_entry_vs_jax_branch(start, cnt, feat, thr):
    F, P = 5, 8192
    src, dst0 = _pane_case(start + cnt + thr, F, P)
    want, plcnt = _jax_branch(src, F, feat, thr, start, cnt)
    # the JAX branch leaves every other lane of its pane as it was
    np.testing.assert_array_equal(want[:, :start], src[:, :start])
    np.testing.assert_array_equal(want[:, start + cnt:], src[:, start + cnt:])
    s, d = torch.as_tensor(src.copy()), torch.as_tensor(dst0.copy())
    left = tc.partition_pane(s, d, F, feat, thr, start, cnt)
    assert left.dtype == torch.int32 and left.shape == ()
    assert int(left) == plcnt
    if thr == 255:
        assert plcnt == cnt
    if feat == 1 and thr == 9:
        assert plcnt == 0
    got = d.numpy()
    np.testing.assert_array_equal(got[:, start:start + cnt],
                                  want[:, start:start + cnt])
    np.testing.assert_array_equal(got[:, :start], dst0[:, :start])
    np.testing.assert_array_equal(got[:, start + cnt:], dst0[:, start + cnt:])
    np.testing.assert_array_equal(s.numpy(), src)


def test_pane_entry_wide_pane_and_strided_dst():
    """F = 200 (216 pane rows); the panes may be column slices of wider
    buffers, as long as their rows are contiguous."""
    F, P = 200, 6144
    src, dst0 = _pane_case(3, F, P)
    want, plcnt = _jax_branch(src, F, 0, 140, 777, 5000)
    wide = torch.as_tensor(np.concatenate([dst0, dst0[:, :100]], 1))
    d = wide[:, :P]
    left = tc.partition_pane(torch.as_tensor(src), d, F, 0, 140, 777, 5000)
    assert int(left) == plcnt
    np.testing.assert_array_equal(d[:, 777:5777].numpy(), want[:, 777:5777])
    np.testing.assert_array_equal(wide[:, P:].numpy(), dst0[:, :100])


@pytest.mark.parametrize("kw,match", [
    (dict(same=True), "different buffers"),
    (dict(thr=256), "thr"), (dict(feat=5), "feat"),
    (dict(thr=65536, bin_bytes=2), "thr"),
    (dict(start=8000, cnt=200), "out of range"),
    (dict(dst_dtype=torch.uint8), "int8"),
])
def test_pane_entry_refuses(kw, match):
    """thr=256 on an 8-bit pane; a 16-bit pane (``bin_bytes`` 2) takes
    thr up to 65535."""
    src = torch.zeros((16, 8192), dtype=torch.int8)
    dst = src if kw.get("same") else torch.zeros(
        (16, 8192), dtype=kw.get("dst_dtype", torch.int8))
    with pytest.raises(ValueError, match=match):
        tc.partition_pane(src, dst, 5, kw.get("feat", 0), kw.get("thr", 3),
                          kw.get("start", 0), kw.get("cnt", 10),
                          kw.get("bin_bytes", 1))


@pytest.mark.parametrize("cnt,shift,tiles,group,count_pass", [
    (1, 0, 1, 1, False), (4096, 0, 1, 1, False), (4081, 15, 1, 1, False),
    (4082, 15, 2, 1, False), (20480, 0, 5, 2, False),
    (24576, 0, 6, 2, False), (24577, 0, 7, 2, True), (32769, 0, 9, 2, True),
    (100_000, 3, 25, 4, True), (300_000, 7, 74, 8, True),
    (1_000_000, 3, 245, 8, True)])
def test_partition_plan(cnt, shift, tiles, group, count_pass):
    """Tiles of TILE lanes from the 16-byte boundary at or below the
    segment's first lane; up to ONE_LAUNCH_TILES tiles in one launch; the
    most rows per block (up to 8) that still give a block per SM (one per
    two SMs in one launch), at the main path's 40 pane rows on 132 SMs."""
    assert tc.plan(cnt, shift, 40, 132) == (tiles, group, count_pass)
