"""lightgbm_tpu_torch best-split search vs the JAX package.

Split choice (feature, threshold, counts) must be identical — it decides
tree structure — including the tie rules: within a feature the larger
threshold wins, across features the smaller index.  Values agree to
rtol 1e-6: the port sums bins in float64 where the JAX package sums in
f32 (ops/split.py module docstring).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops.split import find_best_split as jfind
from lightgbm_tpu_torch.ops.split import find_best_split as tfind

FIELDS = ("gain", "feature", "threshold", "left_output", "right_output",
          "left_count", "right_count", "left_sum_grad", "left_sum_hess",
          "right_sum_grad", "right_sum_hess")
EXACT = ("feature", "threshold", "left_count", "right_count")


def _hist(seed, F, B, n=3000):
    """[F, B, 3] f32 histograms of n random rows (every feature sees the
    same rows, as in a real leaf)."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, n))
    grad = rng.randn(n).astype(np.float32)
    hess = (rng.rand(n) * 0.25).astype(np.float32)
    hist = np.zeros((F, B, 3), np.float32)
    for f in range(F):
        np.add.at(hist[f], bins[f], np.stack([grad, hess,
                                              np.ones_like(grad)], 1))
    return hist


def _both(hist, num_bins, fmask, min_data=5.0, min_hess=1e-3):
    # every feature's bins hold all the leaf's rows: totals from feature 0
    tg, th, tc_ = (hist[0, :, k].sum(dtype=np.float32) for k in range(3))
    j = jfind(jnp.asarray(hist), jnp.float32(tg), jnp.float32(th),
              jnp.float32(tc_), jnp.asarray(num_bins), jnp.asarray(fmask),
              min_data, min_hess)
    t = tfind(torch.as_tensor(hist), torch.tensor(tg), torch.tensor(th),
              torch.tensor(tc_), torch.as_tensor(num_bins),
              torch.as_tensor(fmask), min_data, min_hess)
    return j, t


def _assert_same(j, t):
    for name in FIELDS:
        a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
        if name in EXACT:
            assert int(a) == int(b), name
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-12,
                                       err_msg=name)


@pytest.mark.parametrize("seed", range(6))
def test_random_histograms(seed):
    F, B = 7, 32
    hist = _hist(seed, F, B, n=300 if seed % 2 else 3000)
    nb = np.full(F, B, np.int32)
    nb[2] = 10
    fmask = np.ones(F, bool)
    fmask[4] = False
    _assert_same(*_both(hist, nb, fmask))


def _step_hist(F, B, lo, hi):
    """Rows with grad +1 in bins < lo, -1 in bins >= hi, none between:
    every threshold in [lo-1, hi-1] splits the leaf identically."""
    cnt = np.full(B, 10, np.float32)
    cnt[lo:hi] = 0
    g = np.where(np.arange(B) < lo, 1.0, -1.0).astype(np.float32) * cnt
    one = np.stack([g, cnt * 0.25, cnt], -1)
    return np.repeat(one[None], F, axis=0)


def test_tie_across_features_smaller_index_wins():
    hist = _step_hist(4, 16, 6, 6)           # four identical features
    fmask = np.array([False, True, True, True])
    j, t = _both(hist, np.full(4, 16, np.int32), fmask)
    assert int(t.feature) == int(j.feature) == 1
    _assert_same(j, t)


def test_tie_across_thresholds_larger_threshold_wins():
    hist = _step_hist(2, 16, 7, 11)          # thresholds 6..10 all tie
    j, t = _both(hist, np.full(2, 16, np.int32), np.ones(2, bool))
    assert int(t.threshold) == int(j.threshold) == 10
    assert int(t.feature) == 0
    _assert_same(j, t)


def test_batched_equals_single():
    hists = [_hist(s, 5, 16) for s in (1, 2)]
    nb = torch.full((5,), 16, dtype=torch.int32)
    fm = torch.ones(5, dtype=torch.bool)
    tot = [[float(h[0, :, k].sum(dtype=np.float32)) for h in hists]
           for k in range(3)]
    batch = tfind(torch.as_tensor(np.stack(hists)),
                  *(torch.tensor(v, dtype=torch.float32) for v in tot),
                  nb, fm, 5.0, 1e-3).packed()
    for i, h in enumerate(hists):
        one = tfind(torch.as_tensor(h),
                    *(torch.tensor(v[i], dtype=torch.float32) for v in tot),
                    nb, fm, 5.0, 1e-3).packed()
        assert torch.equal(one, batch[i])


def test_unsplittable_leaf():
    hist = _hist(3, 3, 8)
    j, t = _both(hist, np.full(3, 8, np.int32), np.ones(3, bool),
                 min_data=1e9)
    assert float(t.gain) == float(j.gain) == -np.inf
