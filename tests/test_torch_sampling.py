"""lightgbm_tpu_torch/ops/sampling.py against lightgbm_tpu/ops/sampling.py
on the CPU, bit for bit: the bagging masks of a stream's redraws, and the
GOSS row scores, masks and amplified gradients and hessians for one and
five classes, with tied |grad| rows included (they break by row index in
both stable sorts)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import sampling as jsampling
from lightgbm_tpu_torch.ops import sampling
from lightgbm_tpu_torch.utils import threefry


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("n,frac", [(1, 0.5), (997, 0.8), (50_000, 0.8),
                                    (65_536, 0.25), (20_003, 1.0)])
def test_bag_mask_matches_jax(seed, n, frac):
    bag_cnt = int(frac * n)
    jkey, tkey = jsampling.bag_key(seed), sampling.bag_key(seed)
    masks = []
    for draw in range(3):
        want = np.asarray(jsampling.bag_mask_for_draw(jkey, draw, n,
                                                      bag_cnt))
        got = sampling.bag_mask_for_draw(tkey, draw, n, bag_cnt)
        assert got.dtype == torch.bool and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.sum()) == bag_cnt
        masks.append(want)
    if 1 < bag_cnt < n:
        assert not np.array_equal(masks[0], masks[1])


def _gradients(K, n, seed):
    """[K, n] grad with a block of tied |grad| rows (exact small
    integers and their negations) and zeros; [K, n] positive hess."""
    rng = np.random.RandomState(seed)
    g = rng.randn(K, n).astype(np.float32)
    g[:, : n // 4] = rng.randint(-2, 3, (K, n // 4)).astype(np.float32)
    g[:, n // 4: n // 4 + 7] = 0.0
    h = (rng.rand(K, n) + 0.1).astype(np.float32)
    return g, h


@pytest.mark.parametrize("K", [1, 5])
def test_goss_row_scores_match_jax(K):
    g, _ = _gradients(K, 10_007, 5)
    want = jsampling.goss_row_scores(jnp.asarray(g))
    got = sampling.goss_row_scores(torch.as_tensor(g))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("top_rate,other_rate", [(0.2, 0.1), (0.0, 0.3),
                                                 (0.5, 0.5)])
@pytest.mark.parametrize("K", [1, 5])
def test_goss_select_matches_jax(K, top_rate, other_rate):
    n = 10_007
    g, h = _gradients(K, n, 7 + K)
    top_cnt, other_cnt, amp = jsampling.goss_counts(n, top_rate, other_rate)
    assert sampling.goss_counts(n, top_rate, other_rate) == \
        (top_cnt, other_cnt, amp)
    jkey, tkey = jsampling.bag_key(3), sampling.bag_key(3)
    for it in range(3):
        jg, jh, jmask = jsampling.goss_select(
            jax.random.fold_in(jkey, it), jnp.asarray(g), jnp.asarray(h),
            top_cnt, other_cnt, amp)
        tg, th, tmask = sampling.goss_select(
            threefry.fold_in(tkey, it), torch.as_tensor(g),
            torch.as_tensor(h), top_cnt, other_cnt, amp)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        assert int(tmask.sum()) == top_cnt + other_cnt
        np.testing.assert_array_equal(_bits(tg.numpy()), _bits(jg))
        np.testing.assert_array_equal(_bits(th.numpy()), _bits(jh))
