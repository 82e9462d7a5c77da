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


def test_lambdarank_cpu_takes_the_plain_route():
    """A CPU tensor runs the padded plain version: ``init`` builds the
    padded tables (and not the kernel's), a call counts ``rank/plain``
    with its analytic cost under ``gradient``, leaves the kernel's
    ``launches`` alone and loads no kernel library."""
    from lightgbm_tpu_torch import costmodel, telemetry
    from lightgbm_tpu_torch.objectives import rank
    from lightgbm_tpu_torch.ops import cuda_build
    rng = np.random.RandomState(5)
    sizes = np.array([1, 4, 30, 12])
    label, qb, score = _rank_case(rng, sizes)
    _, t = _pair("lambdarank", label, None, qb)
    assert t.doc_index.shape == t.valid.shape == t.labels.shape == (4, 30)
    assert t.row_pos.shape == (len(label),)
    assert not hasattr(t, "items")
    # different-label pairs: sum over queries of (n^2 - sum_l n_l^2) / 2
    want_pairs = sum(
        (len(q) ** 2 - (np.unique(q, return_counts=True)[1] ** 2).sum()) // 2
        for q in np.split(label, qb[1:-1]))
    assert t.pairs == want_pairs > 0
    before = rank.launches
    telemetry.enable()
    telemetry.reset()
    try:
        t.get_gradients(torch.as_tensor(score))
        assert telemetry.counters()["rank/plain"] == 1
        (note,) = costmodel.roofline({})["traced_passes"]
        assert (note["phase"], note["key"], note["traces"]) == \
            ("gradient", ["rank/plain"], 1)
        assert note["macs"] == rank.PAIR_FLOPS * t.pairs
        assert note["bytes_moved"] == rank.BYTES_PER_ROW * len(label)
    finally:
        telemetry.disable()
        telemetry.reset()
    assert rank.launches == before
    assert not cuda_build._libs


def test_lambdarank_kernel_tables_replay_the_plain_version():
    """The kernel's tables (csrc/rank.cu), built here on the CPU: items
    cover every document once, longest query first, in blocks of
    ``ITEM_DOCS``; each query's documents are visited in label order.
    Replayed in numpy as the kernel runs them (a document's place in
    score order by counting, its pairs from either end, float64 sums),
    they give the plain version's gradients, tied scores, best == worst
    and the all-zero first iteration included."""
    from lightgbm_tpu_torch.objectives import rank
    rng = np.random.RandomState(6)
    sizes = np.concatenate([[1, 5, 7, 300], rng.randint(2, 140, 20)])
    label, qb, score = _rank_case(rng, sizes, ties=True)
    score[qb[4]:qb[5]] = 0.5
    _, t = _pair("lambdarank", label, None, qb)
    b = qb.astype(np.int64)
    t._init_items(np.repeat(np.arange(sizes.size), sizes),
                  label.astype(np.int64), np.diff(b), b, int(sizes.max()),
                  torch.as_tensor)
    items = t.items.numpy()
    perm = t.perm.numpy()
    assert items[:3].tolist() == [[qb[3], 300, i0, 3] for i0 in (0, 128, 256)]
    assert np.all(np.diff(items[:, 1]) <= 0)
    covered = np.concatenate([perm[lo + i0:lo + min(i0 + rank.ITEM_DOCS, n)]
                              for lo, n, i0, _ in items])
    assert np.array_equal(np.sort(covered), np.arange(len(label)))
    f = np.float32
    inv, disc_t = t.inv_max_dcg.numpy(), t.discount.numpy()
    for sc in (np.zeros_like(score), score):
        want = [x.numpy() for x in t.get_gradients(torch.as_tensor(sc))]
        lam = np.zeros_like(sc)
        hes = np.zeros_like(sc)
        for q in range(sizes.size):
            rows = perm[qb[q]:qb[q + 1]]
            assert np.all(np.diff(label[rows]) >= 0)
            s, gain = sc[rows], t.pgains.numpy()[qb[q]:qb[q + 1]]
            lq = t.plabels.numpy()[qb[q]:qb[q + 1]]
            place = ((s[None, :] > s[:, None])
                     | ((s[None, :] == s[:, None])
                        & (rows[None, :] < rows[:, None]))).sum(1)
            d = disc_t[place]
            delta = s[:, None] - s[None, :]            # [hi, lo]
            dn = (gain[:, None] - gain[None, :]) * np.abs(
                d[:, None] - d[None, :]) * inv[q]
            if s.max() != s.min():
                dn = dn / (f(0.01) + np.abs(delta))
            e = np.exp((f(2) * delta * f(1)).astype(np.float64)).astype(f)
            sig = (f(1) / (f(1) + e)) * f(2)
            pair = lq[:, None] > lq[None, :]
            lt = np.where(pair, -sig * dn, f(0)).astype(np.float64)
            ht = np.where(pair, f(2) * dn * (sig * (f(2) - sig)),
                          f(0)).astype(np.float64)
            lam[rows] = lt.sum(1) - lt.sum(0)
            hes[rows] = ht.sum(1) + ht.sum(0)
        np.testing.assert_allclose(lam, want[0], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(hes, want[1], rtol=1e-5, atol=1e-7)
