"""The port's metrics against the JAX package's evaluators, on the same
labels, weights, queries and scores, built from a numpy seed.

Tolerance: rtol 1e-12 (both are float64 numpy on the host over the same
f32 score; the port's evaluators are copies).  Display names are equal.
"""
import numpy as np
import pytest

from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io.metadata import Metadata as JMetadata
from lightgbm_tpu.metrics import create_metric as jcreate

from lightgbm_tpu_torch.config import OverallConfig
from lightgbm_tpu_torch.io.metadata import Metadata
from lightgbm_tpu_torch.metrics import create_metrics
from lightgbm_tpu_torch.utils import log


def _metadata(md, label, weights, qb):
    md.set_label(label)
    md.weights = weights
    md.query_boundaries = qb
    return md


def _eval_both(params, label, score, weights=None, qb=None):
    """[(name, JAX values, port values)] of every metric in ``params``."""
    jcfg, tcfg = JConfig(), OverallConfig()
    jcfg.set(params, require_data=False)
    tcfg.set(params, require_data=False)
    jmd = _metadata(JMetadata(), label, weights, qb)
    tmd = _metadata(Metadata(), label, weights, qb)
    if qb is not None:
        jmd._load_query_weights()
        tmd.load_query_weights()
    out = []
    for jm, tm in zip([jcreate(t, jcfg.metric_config)
                       for t in jcfg.metric_types], create_metrics(tcfg)):
        jm.init("valid_1", jmd, len(label))
        tm.init("valid_1", tmd, len(label))
        assert tm.name == jm.name
        out.append((tm.name, jm.eval(score), tm.eval(score)))
    assert len(out) == len(jcfg.metric_types)
    return out


def _check(results):
    for name, want, got in results:
        assert len(got) == len(want), name
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=name)


@pytest.mark.parametrize("weighted", [False, True])
def test_regression_metrics_match_jax(weighted):
    rng = np.random.RandomState(5)
    n = 3000
    label = (rng.randn(n) * 2).astype(np.float32)
    score = (label + rng.randn(n)).astype(np.float32)
    w = rng.uniform(0.1, 2.0, n).astype(np.float32) if weighted else None
    _check(_eval_both({"objective": "regression", "metric": "l1,l2"},
                      label, score, w))


@pytest.mark.parametrize("weighted", [False, True])
def test_binary_metrics_match_jax(weighted):
    rng = np.random.RandomState(6)
    n = 3000
    label = (rng.rand(n) < 0.4).astype(np.float32)
    score = (rng.randn(n) + label).astype(np.float32)
    score[:50] = 0.0            # probability exactly 0.5: predicted negative
    w = rng.uniform(0.1, 2.0, n).astype(np.float32) if weighted else None
    _check(_eval_both({"objective": "binary",
                       "metric": "binary_error,binary_logloss,auc",
                       "sigmoid": "0.7"}, label, score, w))


@pytest.mark.parametrize("weighted", [False, True])
def test_multiclass_metrics_match_jax(weighted):
    """The score is [K, N] flattened class-major."""
    rng = np.random.RandomState(7)
    K, n = 4, 2500
    label = rng.randint(0, K, n).astype(np.float32)
    score = (rng.randn(K, n) * 2).astype(np.float32)
    score[label.astype(int)[:100], np.arange(100)] += 3.0
    w = rng.uniform(0.1, 2.0, n).astype(np.float32) if weighted else None
    results = _eval_both({"objective": "multiclass", "num_class": str(K),
                          "metric": "multi_logloss,multi_error"},
                         label, score.reshape(-1), w)
    _check(results)
    assert 0 < results[1][2][0] < 1


def _queries(rng, nq=80):
    sizes = np.concatenate([[1, 6], rng.randint(1, 30, nq - 2)])
    qb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    label = rng.randint(0, 4, qb[-1]).astype(np.float32)
    label[qb[1]:qb[2]] = 0.0                    # an all-negative query
    score = rng.randn(qb[-1]).astype(np.float32)
    score[qb[5]:qb[6]] = 0.25                   # tied scores
    return label, qb, score


@pytest.mark.parametrize("extra", [
    {},
    {"ndcg_eval_at": "10,1,3"},
    {"ndcg_at": "2,7", "label_gain": "0,1,3,7.5"},
    {"label_gain": "0.5,2,2.5,10", "ndcg_eval_at": "5"},
], ids=["default", "eval_at", "alias-gain", "gain"])
@pytest.mark.parametrize("weighted", [False, True])
def test_ndcg_matches_jax(extra, weighted):
    """NDCG@k per query, weighted by the query weights (per-query means
    of the row weights); an all-negative query scores 1.0."""
    rng = np.random.RandomState(8)
    label, qb, score = _queries(rng)
    w = (rng.uniform(0.1, 2.0, len(label)).astype(np.float32)
         if weighted else None)
    results = _eval_both(dict({"objective": "lambdarank", "metric": "ndcg"},
                              **extra), label, score, w, qb)
    _check(results)
    name, _, got = results[0]
    ks = sorted(int(k) for k in (extra.get("ndcg_eval_at")
                                 or extra.get("ndcg_at") or "1,2,3,4,5")
                .split(","))
    assert name == "valid_1's " + " ".join("NDCG@%d" % k for k in ks)
    assert all(0 < v <= 1 for v in got)


def test_ndcg_without_queries_is_fatal():
    cfg = OverallConfig()
    cfg.set({"objective": "lambdarank", "metric": "ndcg"},
            require_data=False)
    md = _metadata(Metadata(), np.zeros(5, np.float32), None, None)
    with pytest.raises(log.Fatal, match="query information"):
        create_metrics(cfg)[0].init("valid_1", md, 5)
