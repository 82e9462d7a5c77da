"""Regression, multiclass and lambdarank through the whole boosting loop:
lightgbm_tpu_torch (device="cpu", the kernels' plain versions) against
the JAX package's GBDT, in the style of tests/test_torch_gbdt.py.

Tolerances (the budget of tests/test_torch_gbdt.py):
- tree structure (split features, thresholds, children, leaf parents),
  the number of trees and their order (class k of iteration i is tree
  i·K + k), including a degenerate stop in the middle of an iteration:
  exact, in float32 and int8;
- leaf values rtol 1e-5 / atol 5e-7; training and validation scores
  rtol 1e-5 / atol 2e-6 (f32 sums in another order, and the gradients'
  last bits: XLA's f32 ``exp`` against the port's float64 one, and the
  lambdarank pair sums reduced in another order);
- predictions over the same trees (a JAX model file loaded by the port):
  rtol 1e-12 (both walk and sum in float64); the ``task=predict`` result
  file of a multiclass model: byte for byte (both sum each class in f32,
  tree by tree, then take the softmax in float64 and print ``%.6f``);
- query boundaries and query weights read from side files: exact.

What the data avoid, and why (each seen with other seeds):
- At iteration 1 every multiclass row has p = 1/3, so the gradients are
  f32 1/3 and -2/3 and the hessians 4/9, all inexact: their sums round
  differently in the JAX package's f32 bin cumsum and the port's f64 one,
  by up to 3e-6 on leaf values of 0.1 where a leaf's gradients cancel.
  The float32 multiclass case therefore carries row weights of 9 and 18,
  which make those gradients and hessians whole numbers, exact in any
  order, as binary's first-iteration ±1 are.  (In int8 the weights would
  put levels exactly half-way between two integers, so the int8 cases
  carry none: their level sums are exact anyway.)
- A leaf whose rows share one label has a constant grad/hess ratio at
  iteration 1, so every split of it gains 0 up to rounding, and the two
  packages may pick different zero-gain splits: the trees here stop
  before such leaves.
- In int8, gradients a few ulps apart (XLA's f32 ``exp`` against the
  port's float64 one; lambdarank sums in another order) can move a row
  across a rounding boundary of its quantization level, which moves a
  leaf value by about 1e-4 relative.  Seed 14 has no such row.
"""
import functools

import numpy as np
import pytest

from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.io.metadata import Metadata as JMetadata
from lightgbm_tpu.metrics import create_metric as jmetric
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.models.predictor import Predictor as JPredictor
from lightgbm_tpu.objectives import create_objective as jcreate

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.cli import main as cli_main
from lightgbm_tpu_torch.config import IOConfig
from lightgbm_tpu_torch.io.metadata import Metadata

ITERS = 4
K = 3
STRUCTURE = ("split_feature", "split_feature_real", "threshold_bin",
             "threshold", "left_child", "right_child", "leaf_parent")
BASE = {"num_leaves": "15", "min_data_in_leaf": "20",
        "min_sum_hessian_in_leaf": "1.0", "learning_rate": "0.2"}


def _features(rng, n):
    return rng.randn(n, 8)


def _regression(rng, n):
    x = _features(rng, n)
    y = x[:, 0] - 0.6 * x[:, 1] + 0.25 * x[:, 2] + 0.3 * rng.randn(n)
    return x, y.astype(np.float32), None


def _multiclass(rng, n, rare_offset=None):
    """Three classes from seeded projections plus noise; with
    ``rare_offset`` the third class is rare."""
    x = _features(rng, n)
    z = np.stack([x[:, 0] - 0.6 * x[:, 1], -x[:, 0] + 0.25 * x[:, 2],
                  0.5 * x[:, 3] - (rare_offset or 0.0)], 1)
    z += (0.3 if rare_offset else 0.8) * rng.randn(n, 3)
    return x, np.argmax(z, 1).astype(np.float32), None


def _lambdarank(rng, n):
    """Queries of 2-30 documents; labels 0-4 by quantiles of a latent."""
    sizes = []
    while sum(sizes) < n:
        sizes.append(rng.randint(2, 31))
    sizes[-1] -= sum(sizes) - n
    qb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    x = _features(rng, n)
    latent = x[:, 0] - 0.6 * x[:, 1] + 0.25 * x[:, 2] + 0.3 * rng.randn(n)
    y = np.digitize(latent, np.quantile(latent, [0.5, 0.75, 0.9, 0.97]))
    return x, y.astype(np.float32), qb


KINDS = {
    "regression": (_regression, {"objective": "regression",
                                 "metric": "l2,l1"}),
    "multiclass": (_multiclass, {"objective": "multiclass",
                                 "num_class": str(K),
                                 "metric": "multi_logloss,multi_error"}),
    "lambdarank": (_lambdarank, {"objective": "lambdarank", "metric": "ndcg",
                                 "ndcg_eval_at": "1,3,5",
                                 "min_sum_hessian_in_leaf": "0.05"}),
}


def _data(kind, seed=14):
    rng = np.random.RandomState(seed)
    make = KINDS[kind][0]
    return make(rng, 1200), make(rng, 400)


def booster_pair(kind, extra, iters=ITERS, data=None, weights=None):
    """(train and valid data, JAX booster, port booster), each trained
    ``iters`` iterations with the same params, training-row ``weights``
    and one validation set; the JAX booster through
    ``GBDT.train_one_iter``, the port's through ``lightgbm_tpu_torch.train``."""
    (x, y, qb), (xv, yv, qbv) = data or _data(kind)
    params = dict(BASE, **KINDS[kind][1])
    params.update(extra)
    cfg = JConfig()
    cfg.set(params, require_data=False)
    jtrain = JDataset.from_arrays(x, y, max_bin=32, weights=weights,
                                  query_boundaries=qb)
    j = JGBDT()
    j.init(cfg.boosting_config, jtrain,
           jcreate(cfg.objective_type, cfg.objective_config))
    j.add_valid_dataset(
        JDataset.from_arrays(xv, yv, query_boundaries=qbv, reference=jtrain),
        [jmetric(t, cfg.metric_config) for t in cfg.metric_types])
    for _ in range(iters):
        if j.train_one_iter(is_eval=False):
            break
    ttrain = lgt.Dataset.from_arrays(x, y, max_bin=32, weights=weights,
                                     query_boundaries=qb)
    t = lgt.train(dict(params, num_iterations=iters), ttrain,
                  [lgt.Dataset.from_arrays(xv, yv, query_boundaries=qbv,
                                           reference=ttrain)],
                  device="cpu")
    return ((x, y, qb), (xv, yv, qbv)), j, t


def assert_same_trees(j, t):
    assert len(j.models) == len(t.models)
    for k, (a, b) in enumerate(zip(j.models, t.models)):
        assert a.num_leaves == b.num_leaves, "tree %d" % k
        for field in STRUCTURE:
            np.testing.assert_array_equal(getattr(b, field), getattr(a, field),
                                          err_msg="tree %d %s" % (k, field))
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=5e-7, err_msg="tree %d" % k)


CASES = [(kind, {"hist_dtype": dtype}) for kind in KINDS
         for dtype in ("float32", "int8")]
CASES.append(("multiclass", {"hist_dtype": "int8",
                             "grow_policy": "depthwise"}))


def _whole_number_weights(n):
    return np.random.RandomState(1014).choice([9.0, 18.0], n) \
        .astype(np.float32)


CASE_IDS = ["%s-%s" % (k, "-".join(e.values())) for k, e in CASES]


@functools.lru_cache(maxsize=None)
def _built(case: int):
    """(kind, data, JAX booster, port booster) of CASES[case], built once
    for every test that uses it."""
    kind, extra = CASES[case]
    weights = None
    if kind == "multiclass" and extra["hist_dtype"] == "float32":
        weights = _whole_number_weights(1200)
    return (kind,) + booster_pair(kind, extra, weights=weights)


def _save_jax_model(j, path) -> str:
    """The JAX booster's model file (its incremental writer writes a file
    once; resetting its count starts a new one)."""
    j._saved_model_size = -1
    j.save_model_to_file(True, str(path))
    return str(path)


@pytest.fixture(params=range(len(CASES)), ids=CASE_IDS)
def pair(request):
    return _built(request.param)


def test_trees_match_jax(pair):
    kind, _, j, t = pair
    per_iter = K if kind == "multiclass" else 1
    assert len(t.models) == ITERS * per_iter
    assert t.num_class == j.num_class == per_iter
    assert_same_trees(j, t)


def test_scores_match_jax(pair):
    _, _, j, t = pair
    assert t.score.shape == tuple(np.asarray(j.score).shape)
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score),
                               rtol=1e-5, atol=2e-6)
    (tv,), (jv,) = t.valid_datasets, j.valid_datasets
    np.testing.assert_allclose(tv["score"].numpy(), np.asarray(jv["score"]),
                               rtol=1e-5, atol=2e-6)


def test_metrics_fall_and_match_jax(pair):
    """``eval_values`` hands each validation metric the [N] score, or the
    [K·N] class-major one: the JAX evaluators over the same score agree,
    and the trained model beats the score-0 one."""
    kind, _, j, t = pair
    _, valid = t.eval_values()
    score = t.valid_datasets[0]["score"].numpy()
    flat = score.reshape(-1) if kind == "multiclass" else score[0]
    want = [m.eval(flat) for m in j.valid_metrics[0]]
    for got, w in zip(valid[0], want):
        np.testing.assert_allclose(got, w, rtol=1e-12)
    zero = [m.eval(np.zeros_like(flat)) for m in t.valid_metrics[0]]
    if kind == "lambdarank":
        assert valid[0][0][-1] > zero[0][-1]
    else:
        assert valid[0][0][0] < zero[0][0]


def test_jax_model_file_predicts_alike(pair, tmp_path):
    """A JAX model file loaded by the port predicts what the JAX booster
    predicts, on the validation rows."""
    kind, data, j, _ = pair
    xv = data[1][0]
    path = _save_jax_model(j, tmp_path / "jax_model.txt")
    loaded = lgt.GBDT.from_model_file(path, device="cpu")
    assert loaded.num_class == j.num_class
    if kind == "multiclass":
        got = loaded.predict_multiclass(xv)
        np.testing.assert_allclose(got, j.predict_multiclass(xv), rtol=1e-12)
        np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-12)
        assert loaded.predict_raw(xv).shape == (K, len(xv))
        np.testing.assert_allclose(loaded.predict_multiclass(xv, 2),
                                   j.predict_multiclass(xv, 2), rtol=1e-12)
    else:
        np.testing.assert_allclose(loaded.predict(xv), j.predict(xv),
                                   rtol=1e-12)
    trees = convert.trees_from_numpy(
        [{k: getattr(tr, k) for k in convert.FIELDS} for tr in j.models])
    port = convert.booster_from_trees(trees, j.max_feature_idx, j.sigmoid,
                                      device="cpu", num_class=j.num_class)
    np.testing.assert_allclose(port.predict_raw(xv), loaded.predict_raw(xv),
                               rtol=0)


def test_port_model_text_loads_into_jax(pair, tmp_path):
    kind, data, _, t = pair
    xv = data[1][0]
    path = str(tmp_path / "port_model.txt")
    t.save_model_to_file(True, path)
    with open(path) as f:
        text = f.read()
    assert text == t.model_to_string()
    assert "num_class=%d\n" % t.num_class in text
    loaded = JGBDT.from_model_file(path)
    assert len(loaded.models) == len(t.models)
    if kind == "multiclass":
        np.testing.assert_allclose(loaded.predict_multiclass(xv),
                                   t.predict_multiclass(xv), rtol=1e-12)
    else:
        np.testing.assert_allclose(loaded.predict(xv), t.predict(xv),
                                   rtol=1e-12)


@pytest.mark.parametrize("dtype,seed", [("float32", 7), ("int8", 14)])
def test_degenerate_stop_mid_iteration(dtype, seed):
    """A rare third class loses its hessian mass: the first iteration
    whose class-2 tree cannot split stops training, and the class-0 and
    class-1 trees of that iteration stay (gbdt.py:1267-1286).  float32
    carries the whole-number weights (mean 13.5, so the hessian limit is
    13.5 times int8's)."""
    rng = np.random.RandomState(seed)
    data = (_multiclass(rng, 1200, rare_offset=1.2),
            _multiclass(rng, 400, rare_offset=1.2))
    weights = _whole_number_weights(1200) if dtype == "float32" else None
    _, j, t = booster_pair("multiclass", {
        "num_leaves": "4", "learning_rate": "1.0", "hist_dtype": dtype,
        "min_sum_hessian_in_leaf": "202.5" if weights is not None else "15"},
        iters=12, data=data, weights=weights)
    assert len(t.models) == 17           # 5 iterations, then 2 trees
    assert t.iter == j.iter == 5
    assert_same_trees(j, t)
    assert [tr.num_leaves > 1 for tr in t.models] == [True] * 17
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score),
                               rtol=1e-5, atol=2e-6)


def _write_tsv(path, x, y):
    np.savetxt(path, np.column_stack([y, x]), delimiter="\t", fmt="%.6g")


@pytest.mark.parametrize(
    "case", [i for i, (k, _) in enumerate(CASES) if k == "multiclass"],
    ids=[c for c in CASE_IDS if c.startswith("multiclass")])
def test_cli_multiclass_result_file_equals_jax(case, tmp_path):
    """A JAX multiclass model, predicted by the port's CLI and by the JAX
    package's Predictor: the same result file, byte for byte, K
    tab-separated probabilities a row."""
    _, data, j, _ = _built(case)
    model = _save_jax_model(j, tmp_path / "jax_model.txt")
    xv, yv, _ = data[1]
    test = tmp_path / "test.tsv"
    _write_tsv(test, xv, yv)
    want = str(tmp_path / "jax_result.txt")
    JPredictor(JGBDT.from_model_file(model), True, False, -1).predict_file(
        str(test), want, False)
    got = str(tmp_path / "port_result.txt")
    assert cli_main(["task=predict", "data=%s" % test, "input_model=%s" % model,
                     "output_result=%s" % got, "device=cpu"]) == 0
    with open(want, "rb") as a, open(got, "rb") as b:
        want_bytes, got_bytes = a.read(), b.read()
    assert got_bytes == want_bytes
    rows = np.loadtxt(got, delimiter="\t")
    assert rows.shape == (len(yv), K)
    # num_model_predict counts iterations, K trees each
    want2 = str(tmp_path / "jax_result2.txt")
    JPredictor(JGBDT.from_model_file(model), True, False, 2).predict_file(
        str(test), want2, False)
    assert cli_main(["task=predict", "data=%s" % test, "input_model=%s" % model,
                     "output_result=%s" % got, "num_model_predict=2",
                     "device=cpu"]) == 0
    with open(want2, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


def test_query_side_file_loads_like_jax(tmp_path):
    """``<data>.query`` (one document count a line) and ``<data>.weight``:
    the same boundaries and query weights as the JAX package's
    Metadata, and a lambdarank model trained from the files by the CLI."""
    (x, y, qb), _ = _data("lambdarank")
    w = np.random.RandomState(3).uniform(0.5, 2.0, len(y))
    train = tmp_path / "rank.train"
    _write_tsv(train, x, y)
    np.savetxt(str(train) + ".query", np.diff(qb), fmt="%d")
    np.savetxt(str(train) + ".weight", w, fmt="%.6f")
    jmd, tmd = JMetadata(), Metadata()
    jmd.init_from_files(str(train))
    tmd.init_from_files(str(train))
    np.testing.assert_array_equal(tmd.query_boundaries, jmd.query_boundaries)
    np.testing.assert_array_equal(tmd.query_boundaries, qb)
    np.testing.assert_array_equal(tmd.query_weights, jmd.query_weights)
    assert tmd.query_weights.dtype == np.float32
    ds = lgt.Dataset.load_train(IOConfig(data_filename=str(train),
                                         max_bin=32))
    np.testing.assert_array_equal(ds.metadata.query_boundaries, qb)
    model = tmp_path / "model.txt"
    assert cli_main(["task=train", "objective=lambdarank", "data=%s" % train,
                     "valid_data=%s" % train, "metric=ndcg", "ndcg_at=3",
                     "num_trees=2", "num_leaves=7", "min_sum_hessian=0.05",
                     "output_model=%s" % model, "device=cpu"]) == 0
    text = model.read_text()
    assert "num_class=1\n" in text and text.count("Tree=") == 2
    # a query file whose counts do not cover the rows is refused
    np.savetxt(str(train) + ".query", np.diff(qb)[:-1], fmt="%d")
    assert cli_main(["task=train", "objective=lambdarank", "data=%s" % train,
                     "num_trees=1", "device=cpu"]) == 1


def test_cli_train_predict_each_objective(tmp_path):
    """``task=train`` then ``task=predict`` through the CLI: one column of
    raw scores for regression, K probability columns for multiclass."""
    for kind, extra, cols in (("regression", [], 1),
                              ("multiclass", ["num_class=3"], K)):
        (x, y, _), _ = _data(kind)
        train = tmp_path / ("%s.tsv" % kind)
        _write_tsv(train, x, y)
        model = tmp_path / ("%s.model" % kind)
        result = tmp_path / ("%s.pred" % kind)
        metric = "l2" if kind == "regression" else "multi_logloss"
        assert cli_main(["task=train", "objective=%s" % kind,
                         "data=%s" % train, "metric=%s" % metric,
                         "is_training_metric=true", "num_trees=3",
                         "num_leaves=7", "output_model=%s" % model,
                         "device=cpu"] + extra) == 0
        assert cli_main(["task=predict", "data=%s" % train,
                         "input_model=%s" % model,
                         "output_result=%s" % result, "device=cpu"]) == 0
        pred = np.loadtxt(result, delimiter="\t", ndmin=2)
        assert pred.shape == (len(y), cols)
        booster = lgt.GBDT.from_model_file(str(model), device="cpu")
        feats = np.loadtxt(train, delimiter="\t")[:, 1:]
        if kind == "multiclass":
            np.testing.assert_allclose(pred.sum(1), 1.0, atol=1e-5)
            np.testing.assert_allclose(pred, booster.predict_multiclass(feats),
                                       atol=1e-6)
        else:
            np.testing.assert_allclose(pred[:, 0], booster.predict(feats),
                                       atol=1e-5)
