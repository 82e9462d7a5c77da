"""The port's objectives (device="cpu") against the JAX package's, on the
same scores, labels, weights and queries, built from a numpy seed.

Tolerances:
- regression: exact (each step is one exactly rounded f32 operation in
  both packages);
- multiclass (K = 3): within 4 ulps of 1.0, the probabilities' scale.
  The JAX package's softmax takes XLA's f32 ``exp``; the port takes it
  in float64 and rounds p once, so p differs by a few ulps, and so do
  grad = p − 1[y = k] and hess = 2p(1 − p);
- lambdarank: rtol 1e-5.  Both packages reduce the same f32 pair terms
  in another order.  ``hess`` sums positive terms (rtol 1e-5, atol 0); a
  lambda is the difference of two such sums of terms up to about 1, so
  its rounding is absolute, and it also gets atol 1e-6.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.config import ObjectiveConfig as JObjectiveConfig
from lightgbm_tpu.io.metadata import Metadata as JMetadata
from lightgbm_tpu.objectives import create_objective as jcreate

from lightgbm_tpu_torch.config import ObjectiveConfig
from lightgbm_tpu_torch.io.metadata import Metadata
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.utils import log

CPU = torch.device("cpu")


def _pair(kind, label, weights=None, query_boundaries=None, **config):
    """(JAX objective, port objective), each initialised on the same
    metadata."""
    objs = []
    for cfg_cls, md_cls, create, extra in (
            (JObjectiveConfig, JMetadata, jcreate, ()),
            (ObjectiveConfig, Metadata, create_objective, (CPU,))):
        cfg = cfg_cls()
        for k, v in config.items():
            setattr(cfg, k, v)
        md = md_cls()
        md.set_label(label)
        if weights is not None:
            md.weights = np.asarray(weights, np.float32)
        if query_boundaries is not None:
            md.query_boundaries = np.asarray(query_boundaries, np.int32)
        md.finalize(len(label))
        obj = create(kind, cfg)
        obj.init(md, len(label), *extra)
        objs.append(obj)
    return objs


def _both(j, t, score):
    jg, jh = j.get_gradients(jnp.asarray(score))
    tg, th = t.get_gradients(torch.as_tensor(score))
    assert tg.dtype == th.dtype == torch.float32
    return (np.asarray(jg), np.asarray(jh)), (tg.numpy(), th.numpy())


@pytest.mark.parametrize("weighted", [False, True])
def test_regression_gradients_exact(weighted):
    rng = np.random.RandomState(1)
    n = 5000
    label = (rng.randn(n) * 3).astype(np.float32)
    score = (rng.randn(n) * 2).astype(np.float32)
    w = rng.uniform(0.1, 2.0, n).astype(np.float32) if weighted else None
    j, t = _pair("regression", label, w)
    (jg, jh), (tg, th) = _both(j, t, score)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(th, jh)
    assert t.sigmoid == j.sigmoid == -1.0


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("scale", [0.0, 1.0, 30.0])
def test_multiclass_gradients_within_ulps(weighted, scale):
    """Scores at 0 (p = 1/K exactly), moderate, and wide (p near 0 and
    1, where the row maximum's subtraction matters)."""
    rng = np.random.RandomState(2)
    K, n = 3, 4000
    label = rng.randint(0, K, n).astype(np.float32)
    score = (rng.randn(K, n) * scale).astype(np.float32)
    w = rng.uniform(0.1, 2.0, n).astype(np.float32) if weighted else None
    j, t = _pair("multiclass", label, w, num_class=K)
    (jg, jh), (tg, th) = _both(j, t, score)
    assert tg.shape == th.shape == (K, n)
    tol = 4 * np.spacing(np.float32(1.0)) * (2.0 if weighted else 1.0)
    assert np.abs(tg - jg).max() <= tol
    assert np.abs(th - jh).max() <= tol
    if scale == 0.0:
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(th, jh)


def test_multiclass_label_out_of_range_is_fatal():
    cfg = ObjectiveConfig()
    cfg.num_class = 3
    md = Metadata()
    md.set_label(np.array([0, 1, 3], np.float32))
    with pytest.raises(log.Fatal, match="Label must be in"):
        create_objective("multiclass", cfg).init(md, 3, CPU)


def _rank_case(rng, sizes, ties=False):
    """Labels 0-4 per query, one query of one document, one query whose
    documents all share a label, and scores with or without ties."""
    n = int(sum(sizes))
    label = rng.randint(0, 5, n).astype(np.float32)
    qb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    label[qb[2]:qb[3]] = 2.0                   # all-equal-label query
    score = (rng.randn(n) * 2).astype(np.float32)
    if ties:
        score = np.round(score, 1)
    return label, qb, score


@pytest.mark.parametrize("case", ["zero", "random", "ties", "weighted",
                                  "sigmoid"])
def test_lambdarank_gradients_match_jax(case):
    """Ragged queries of 1-40 documents: a one-document query, an
    all-equal-label query, and scores all 0 (best == worst in every
    query: no 1/(0.01 + |Δs|) regularisation), random, tied, with row
    weights, or with sigmoid 2."""
    rng = np.random.RandomState(3)
    sizes = np.concatenate([[1, 5, 7], rng.randint(2, 41, 60)])
    label, qb, score = _rank_case(rng, sizes, ties=case == "ties")
    if case == "zero":
        score = np.zeros_like(score)
    # one query with all scores equal in the random cases too
    score[qb[4]:qb[5]] = 0.5
    w = (rng.uniform(0.2, 2.0, len(label)).astype(np.float32)
         if case == "weighted" else None)
    extra = {"sigmoid": 2.0} if case == "sigmoid" else {}
    j, t = _pair("lambdarank", label, w, qb, **extra)
    (jg, jh), (tg, th) = _both(j, t, score)
    assert t.block == j.block
    # the one-document and the all-equal-label queries get no pairs
    for q in (0, 2):
        assert not tg[qb[q]:qb[q + 1]].any()
        assert not th[qb[q]:qb[q + 1]].any()
    np.testing.assert_allclose(th, jh, rtol=1e-5, atol=0)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)
    assert np.abs(jg).max() > 0.5


def test_lambdarank_blocks_do_not_change_gradients():
    """Query blocks of 1, 7 and all queries give the same lambdas."""
    rng = np.random.RandomState(4)
    sizes = rng.randint(1, 25, 40)
    label, qb, score = _rank_case(rng, sizes)
    _, t = _pair("lambdarank", label, None, qb)
    want = [x.numpy() for x in t.get_gradients(torch.as_tensor(score))]
    for block in (1, 7):
        t.block = block
        got = [x.numpy() for x in t.get_gradients(torch.as_tensor(score))]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-9)


def test_lambdarank_needs_queries():
    md = Metadata()
    md.set_label(np.zeros(4, np.float32))
    with pytest.raises(log.Fatal, match="query information"):
        create_objective("lambdarank", ObjectiveConfig()).init(md, 4, CPU)
