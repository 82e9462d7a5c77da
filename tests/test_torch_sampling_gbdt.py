"""Sampling and early stopping through the whole boosting loop:
lightgbm_tpu_torch (device="cpu", the kernels' plain versions) against
the JAX package's GBDT driven iteration by iteration
(``GBDT.train_one_iter``, the per-iteration semantics its fused chunk
and pipelined paths claim to reproduce).

Covered: host (numpy) and device (threefry) bagging, per-query bagging
for lambdarank, ``feature_fraction``, GOSS and early stopping, under the
compacted, masked and depth-wise growers, in float32 and int8, for
binary, multiclass (K = 3) and lambdarank.

Tolerances (the budget of tests/test_torch_gbdt.py and
tests/test_grower_unified.py:100-114): tree structure, the number and
order of trees, the in-bag counts (the port's leaf counts against the
mask; the JAX package's trees keep none) and the stop iteration: exact; leaf values rtol 1e-5 / atol 5e-7 and scores rtol 1e-5 / atol
2e-6, in int8 too (the gradients' last bits differ: XLA's f32 ``exp``
against the port's float64 one, which moves the int8 pass scale by an
ulp).

Where the two packages' known float gaps (ROADMAP §C) would flip a split,
and how the cases stay clear of them:
- The first multiclass iteration gives every row the gradients 1/3 and
  -2/3, so many splits tie exactly, and the JAX package's f32 gain sums
  and the port's f64 ones break the ties differently: the multiclass
  cases carry seeded real-valued row weights, which leave no exact tie.
- GOSS ranks rows by |grad|, so a last-bit gradient difference moves a
  row across the cut; lambdarank's pair sums differ in the last bits
  (f32 in the JAX package, f64 here), so its GOSS case is float32 and
  masked, where this data keeps every rank.
- The early-stopping runs train up to a dozen iterations at a high
  learning rate, where f32-against-f64 near-ties add up: each case's
  learning rate is one under which the run stays clear of them (0.3 for
  lambdarank, 0.9 for masked multiclass; other settings tried differed
  in a near-tie threshold or an int8 level, never in a draw, a mask or
  the stop).
"""
import functools

import numpy as np
import pytest

from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.metrics import create_metric as jmetric
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.objectives import create_objective as jcreate

import lightgbm_tpu_torch as lgt
from tests import test_torch_objectives_gbdt as obj

K = obj.K
STRUCTURE = obj.STRUCTURE
BASE = obj.BASE
KINDS = {
    "binary": (lambda rng, n: _binary(rng, n),
               {"objective": "binary", "metric": "binary_logloss,auc"}),
    "multiclass": obj.KINDS["multiclass"],
    "lambdarank": obj.KINDS["lambdarank"],
}
GROWERS = {"compacted": {"leafwise_compact": "true"},
           "masked": {"leafwise_compact": "false"},
           "depthwise": {"grow_policy": "depthwise"}}
BAG = {"bagging_fraction": "0.7", "bagging_freq": "2"}
GOSS = {"goss": "true", "top_rate": "0.3", "other_rate": "0.2"}
FF = {"feature_fraction": "0.75"}


def _binary(rng, n):
    x = rng.randn(n, 8)
    y = ((x[:, 0] - 0.6 * x[:, 1] + 0.25 * x[:, 2]
          + 0.3 * rng.randn(n)) > 0).astype(np.float32)
    return x, y, None


def _data(kind, seed=14, n=1200, n_valid=400):
    rng = np.random.RandomState(seed)
    make = KINDS[kind][0]
    return make(rng, n), make(rng, n_valid)


def booster_pair(kind, extra, iters, data=None, weights=None,
                 init_scores=None):
    """(JAX booster, port booster), each trained up to ``iters``
    iterations with one validation set and the same params, from the
    (train, valid) ``init_scores`` when given."""
    (x, y, qb), (xv, yv, qbv) = data or _data(kind)
    params = dict(BASE, **KINDS[kind][1])
    params.update(extra)
    cfg = JConfig()
    cfg.set(dict(params), require_data=False)
    jtrain = JDataset.from_arrays(x, y, max_bin=32, weights=weights,
                                  query_boundaries=qb)
    jvalid = JDataset.from_arrays(xv, yv, query_boundaries=qbv,
                                  reference=jtrain)
    ttrain = lgt.Dataset.from_arrays(x, y, max_bin=32, weights=weights,
                                     query_boundaries=qb)
    tvalid = lgt.Dataset.from_arrays(xv, yv, query_boundaries=qbv,
                                     reference=ttrain)
    if init_scores is not None:
        for ds, score in ((jtrain, init_scores[0]), (ttrain, init_scores[0]),
                          (jvalid, init_scores[1]), (tvalid, init_scores[1])):
            ds.metadata.init_score = score
    j = JGBDT()
    j.init(cfg.boosting_config, jtrain,
           jcreate(cfg.objective_type, cfg.objective_config))
    j.add_valid_dataset(
        jvalid, [jmetric(t, cfg.metric_config) for t in cfg.metric_types])
    for _ in range(iters):
        if j.train_one_iter(is_eval=True):
            break
    t = lgt.train(dict(params, num_iterations=iters), ttrain, [tvalid],
                  device="cpu")
    return j, t


def _init_scores(seed, n, n_valid):
    """Seeded float32 initial scores of the training and validation
    rows."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n).astype(np.float32) * 0.5,
            rng.randn(n_valid).astype(np.float32) * 0.5)


def assert_same_booster_trees(j, t):
    """The same trees: structure exact, leaf values within the budget."""
    assert len(t.models) == len(j.models) > 0
    for k, (a, b) in enumerate(zip(j.models, t.models)):
        assert a.num_leaves == b.num_leaves, "tree %d" % k
        for field in STRUCTURE:
            np.testing.assert_array_equal(getattr(b, field), getattr(a, field),
                                          err_msg="tree %d %s" % (k, field))
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=5e-7, err_msg="tree %d" % k)


def assert_same_booster(j, t):
    assert t.iter == j.iter
    assert_same_booster_trees(j, t)
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score),
                               rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(t.valid_datasets[0]["score"].numpy(),
                               np.asarray(j.valid_datasets[0]["score"]),
                               rtol=1e-5, atol=2e-6)


CASES = [
    ("binary", "compacted", "float32", dict(BAG, **FF)),
    ("binary", "compacted", "int8", dict(BAG, bagging_device="true",
                                         bagging_freq="1", **FF)),
    ("binary", "masked", "float32", dict(BAG, bagging_device="true")),
    ("binary", "masked", "int8", dict(GOSS, **FF)),
    ("binary", "depthwise", "int8", dict(BAG, bagging_device="true", **FF)),
    ("binary", "depthwise", "float32", dict(GOSS)),
    ("binary", "compacted", "float32", dict(GOSS, feature_fraction="0.5")),
    ("multiclass", "compacted", "float32", dict(BAG, bagging_freq="1", **FF)),
    ("multiclass", "depthwise", "int8", dict(BAG, bagging_device="true")),
    ("multiclass", "masked", "float32", dict(GOSS, **FF)),
    ("lambdarank", "compacted", "float32", dict(BAG, **FF)),
    ("lambdarank", "depthwise", "int8", dict(BAG, bagging_device="true")),
    ("lambdarank", "masked", "float32", dict(GOSS)),
]
CASE_IDS = ["%s-%s-%s-%s" % (kind, grower, dtype,
                             "-".join("%s=%s" % kv for kv in extra.items()))
            for kind, grower, dtype, extra in CASES]


@functools.lru_cache(maxsize=None)
def _built(case: int):
    kind, grower, dtype, extra = CASES[case]
    weights = None
    if kind == "multiclass":
        weights = _real_weights(1200)
    params = dict(GROWERS[grower], hist_dtype=dtype, **extra)
    return booster_pair(kind, params, 4, weights=weights)


def _real_weights(n):
    """Seeded row weights in [0.5, 2): they break the exact ties of the
    first multiclass iteration's gradients (1/3 and -2/3 on every row),
    which the two packages' f32 and f64 gain sums resolve differently."""
    return np.random.RandomState(1014).uniform(0.5, 2.0, n) \
        .astype(np.float32)


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_sampled_trees_match_jax(case):
    j, t = _built(case)
    per_iter = K if CASES[case][0] == "multiclass" else 1
    assert len(t.models) == 4 * per_iter
    assert_same_booster(j, t)


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_sampled_trees_see_fewer_rows(case):
    """A sampled tree's leaves hold at most the rows its mask keeps:
    exactly ``int(0.7·N)`` under record bagging, ``top_cnt +
    other_cnt`` under GOSS, whole queries under per-query bagging."""
    kind, _, _, extra = CASES[case]
    _, t = _built(case)
    n = t.num_data
    for tree in t.models:
        total = int(np.sum(tree.leaf_count))
        if "goss" in extra:
            assert total == int(0.3 * n) + int(0.2 * n)
        elif kind == "lambdarank":
            assert total < n
        else:
            assert total == int(0.7 * n)


ES_CASES = [("binary", "compacted", "float32", "0.5"),
            ("binary", "depthwise", "int8", "0.5"),
            ("multiclass", "masked", "float32", "0.9"),
            ("lambdarank", "compacted", "float32", "0.3")]


@functools.lru_cache(maxsize=None)
def _early(case: int):
    kind, grower, dtype, rate = ES_CASES[case]
    # a fast learner over few rows: the held-out metric turns
    params = dict(GROWERS[grower], hist_dtype=dtype,
                  early_stopping_round="2", learning_rate=rate,
                  min_data_in_leaf="10", min_sum_hessian_in_leaf="0.01",
                  **BAG)
    data = _data(kind, seed=21, n=400, n_valid=300)
    weights = _real_weights(400) if kind == "multiclass" else None
    return booster_pair(kind, params, 40, data=data, weights=weights)


@pytest.mark.parametrize("case", range(len(ES_CASES)),
                         ids=["-".join(c[:3]) for c in ES_CASES])
def test_early_stopping_matches_jax(case, tmp_path):
    """The same stop iteration, the same kept trees and the same best
    (set, metric) bookkeeping; the incremental save holds back the
    window until finish, and the saved files list the same trees."""
    kind = ES_CASES[case][0]
    j, t = _early(case)
    per_iter = K if kind == "multiclass" else 1
    assert t.iter == j.iter < 40
    assert len(t.models) == (t.iter - 2) * per_iter
    assert t.best_iter == j.best_iter
    np.testing.assert_allclose(t.best_score, j.best_score, rtol=1e-5)
    assert_same_booster(j, t)
    files = {}
    for name, b in (("jax", j), ("port", t)):
        path = str(tmp_path / (name + ".txt"))
        b._saved_model_size = -1
        b.save_model_to_file(True, path)
        with open(path) as f:
            files[name] = f.read()
    assert files["jax"].count("Tree=") == files["port"].count("Tree=") \
        == len(t.models)
    # the header and each tree's structure lines are the same text
    for key in ("num_class=", "max_feature_idx=", "split_feature=",
                "threshold=", "left_child=", "right_child=",
                "leaf_parent="):
        jl = [ln for ln in files["jax"].split("\n") if ln.startswith(key)]
        tl = [ln for ln in files["port"].split("\n") if ln.startswith(key)]
        assert jl == tl, key


def test_incremental_save_withholds_window(tmp_path):
    """Mid-run saves write every tree but the last early_stopping_round
    iterations'; the final save writes the rest (gbdt.cpp:307-348)."""
    x, y, _ = _binary(np.random.RandomState(3), 600)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=32)
    booster = lgt.train(dict(BASE, objective="binary", num_iterations=5,
                             early_stopping_round=2), ds, device="cpu")
    path = str(tmp_path / "m.txt")
    booster.save_model_to_file(False, path)
    with open(path) as f:
        assert f.read().count("Tree=") == 3
    booster.save_model_to_file(True, path)
    with open(path) as f:
        assert f.read() == booster.model_to_string()


def test_bagging_device_rules():
    """bagging_device on the CPU: auto draws with numpy, true with
    threefry; per-query bagging stays on numpy under true."""
    x, y, qb = obj._lambdarank(np.random.RandomState(2), 300)
    flat = lgt.Dataset.from_arrays(x, (y > 1).astype(np.float32), max_bin=32)
    ranked = lgt.Dataset.from_arrays(x, y, max_bin=32, query_boundaries=qb)
    for ds, objective, device_mode, want in (
            (flat, "binary", "auto", False), (flat, "binary", "true", True),
            (flat, "binary", "false", False),
            (ranked, "lambdarank", "true", False)):
        b = lgt.train(dict(BASE, objective=objective, num_iterations=1,
                           bagging_device=device_mode, **BAG), ds,
                      device="cpu")
        assert b._bag_device is want, (objective, device_mode)
