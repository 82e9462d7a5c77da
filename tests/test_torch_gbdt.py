"""The whole slice: lightgbm_tpu_torch (device="cpu", the kernels' plain
versions) vs the JAX package's compacted leaf-wise grower and GBDT.

Tolerances:
- tree structure (split features, thresholds, children) and leaf counts:
  exact, in float32 and int8;
- grower level: leaf ids exact, leaf values rtol 1e-6 (the same ops in
  the same order; the port's f64 bin cumsum may move the last bit);
- GBDT level: leaf values rtol 1e-5 / atol 5e-7 and train scores rtol
  1e-5 / atol 2e-6 — the cross-program budget of
  tests/test_grower_unified.py:111-114 (f32 sums in another order, and
  XLA's vs torch's f32 ``exp`` in the gradients);
- predictions over the same trees: rtol 1e-12 (both walk in float64).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.models.grower_leafcompact import \
    grow_tree_leafcompact as jgrow
from lightgbm_tpu.objectives import create_objective as jcreate

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.cli import main as cli_main
from lightgbm_tpu_torch.models.grower_leafcompact import \
    grow_tree_leafcompact as tgrow

PARAMS = {"objective": "binary", "num_leaves": "15",
          "min_data_in_leaf": "20", "min_sum_hessian_in_leaf": "1.0",
          "learning_rate": "0.2"}
ITERS = 4
STRUCTURE = ("split_feature", "threshold_bin", "left_child", "right_child",
             "leaf_parent")


def _data():
    """tests/test_grower_unified.py:36-42."""
    rng = np.random.RandomState(97)
    n, f = 1200, 8
    x = rng.randn(n, f)
    y = ((x[:, 0] - 0.6 * x[:, 1] + 0.25 * x[:, 2]
          + 0.3 * rng.randn(n)) > 0).astype(np.float32)
    return x, y


def booster_pair(params):
    """(x, JAX booster, port booster), each trained ITERS iterations on
    ``_data()`` with the same ``params``."""
    x, y = _data()
    cfg = JConfig()
    cfg.set(params, require_data=False)
    j = JGBDT()
    j.init(cfg.boosting_config, JDataset.from_arrays(x, y, max_bin=32),
           jcreate(cfg.objective_type, cfg.objective_config))
    for _ in range(ITERS):
        if j.train_one_iter(is_eval=False):
            break
    t = lgt.train(dict(params, num_iterations=ITERS),
                  lgt.Dataset.from_arrays(x, y, max_bin=32), device="cpu")
    return x, j, t


@pytest.fixture(scope="module", params=["float32", "int8"])
def pair(request):
    return booster_pair(dict(PARAMS, grow_policy="leafwise",
                             leafwise_compact="true",
                             hist_dtype=request.param))


def test_trees_match_jax(pair):
    _, j, t = pair
    assert len(j.models) == len(t.models) == ITERS
    for k, (a, b) in enumerate(zip(j.models, t.models)):
        assert a.num_leaves == b.num_leaves, "tree %d" % k
        for field in STRUCTURE + ("split_feature_real",):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field),
                                          err_msg="tree %d %s" % (k, field))
        np.testing.assert_array_equal(a.threshold, b.threshold)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=5e-7, err_msg="tree %d" % k)


def test_scores_match_jax(pair):
    _, j, t = pair
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score),
                               rtol=1e-5, atol=2e-6)


def test_model_text_loads_into_jax(pair, tmp_path):
    x, j, t = pair
    path = str(tmp_path / "port_model.txt")
    t.save_model_to_file(True, path)
    loaded = JGBDT.from_model_file(path)
    assert len(loaded.models) == ITERS
    np.testing.assert_allclose(loaded.predict(x), t.predict(x), rtol=1e-12)
    with open(path) as f:
        assert f.read() == t.model_to_string()


def test_jax_trees_carry_into_port(pair, tmp_path):
    x, j, _ = pair
    trees = convert.trees_from_numpy(
        [{k: getattr(tr, k) for k in convert.FIELDS} for tr in j.models])
    port = convert.booster_from_trees(trees, j.max_feature_idx, j.sigmoid,
                                      device="cpu")
    np.testing.assert_allclose(port.predict(x), j.predict(x), rtol=1e-12)
    np.testing.assert_allclose(port.predict_raw(x, 2), j.predict_raw(x, 2),
                               rtol=1e-12)
    # the text carrier: JAX model file -> port booster
    path = str(tmp_path / "jax_model.txt")
    j.save_model_to_file(True, path)
    loaded = lgt.GBDT.from_model_file(path, device="cpu")
    np.testing.assert_allclose(loaded.predict(x), j.predict(x), rtol=1e-12)
    back = convert.trees_to_numpy(trees)
    np.testing.assert_array_equal(back[0]["leaf_value"],
                                  j.models[0].leaf_value)


def _grower_case(seed, bagging, B=32):
    """tests/test_leafcompact.py::_grow_both's inputs, with B bins."""
    rng = np.random.RandomState(seed)
    N, F = 4000, 5
    x = rng.randn(N, F)
    lo, hi = x.min(0), x.max(0)
    bins = np.clip((x - lo) / (hi - lo) * (B - 1), 0, B - 1)
    bins = bins.astype(np.uint8).T.copy()
    y = (x[:, 0] - x[:, 1] + 0.5 * np.sin(3 * x[:, 2])
         + 0.3 * rng.randn(N) > 0)
    pr = np.full(N, 0.5, np.float32)
    grad = (pr - y).astype(np.float32)
    hess = (pr * (1 - pr)).astype(np.float32)
    row_mask = np.ones(N, bool)
    if bagging:
        row_mask[rng.rand(N) < 0.4] = False
    return (bins, grad, hess, row_mask, np.ones(F, bool),
            np.full(F, B, np.int32)), B


def assert_grown_alike(t, j, dtype="float32"):
    """A port TreeArrays against a JAX one: structure, leaf counts and
    original-order leaf ids exact; leaf values rtol 1e-6 in float32, and
    rtol 1e-4 / atol 1e-7 in int8, where XLA CPU may contract the
    dequantize multiply into an FMA (tests/test_leafcompact.py:186-193)."""
    assert int(j.num_leaves) == t.num_leaves
    for field in STRUCTURE + ("leaf_count",):
        np.testing.assert_array_equal(getattr(t, field),
                                      np.asarray(getattr(j, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(t.leaf_ids.numpy(), np.asarray(j.leaf_ids))
    if dtype == "int8":
        np.testing.assert_allclose(t.leaf_value, np.asarray(j.leaf_value),
                                   rtol=1e-4, atol=1e-7)
    else:
        np.testing.assert_allclose(t.leaf_value, np.asarray(j.leaf_value),
                                   rtol=1e-6, atol=1e-9)


# B = 256 puts bins of 128 and more (the int8 pane's sign byte) under the
# double-buffered pane's partition
@pytest.mark.parametrize("dtype,bagging,B", [
    pytest.param(d, g, b, id="%s-%s%s" % (d, g, "" if b == 32 else "-B256"))
    for b in (32, 256) for g in (False, True) for d in ("float32", "int8")])
def test_grower_matches_jax(dtype, bagging, B):
    """Grower level, including the row-mask seam the boosting loop keeps
    all-true in this slice: leaf counts and original-order leaf ids."""
    args, B = _grower_case(11, bagging, B)
    kw = dict(num_leaves=15, num_bins_max=B, min_data_in_leaf=20,
              min_sum_hessian_in_leaf=1e-3)
    j = jgrow(*map(jnp.asarray, args),
              compute_dtype="int8" if dtype == "int8" else jnp.float32, **kw)
    t = tgrow(*map(torch.as_tensor, args), compute_dtype=dtype, **kw)
    assert int(j.num_leaves) == t.num_leaves > 8
    for field in STRUCTURE + ("leaf_count",):
        np.testing.assert_array_equal(getattr(t, field),
                                      np.asarray(getattr(j, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(t.leaf_ids.numpy(), np.asarray(j.leaf_ids))
    np.testing.assert_allclose(t.leaf_value, np.asarray(j.leaf_value),
                               rtol=1e-6, atol=1e-9)


def test_max_depth_gates_splits():
    args, B = _grower_case(3, False)
    kw = dict(num_leaves=31, num_bins_max=B, min_data_in_leaf=10,
              min_sum_hessian_in_leaf=1e-3, max_depth=3)
    j = jgrow(*map(jnp.asarray, args), compute_dtype=jnp.float32, **kw)
    t = tgrow(*map(torch.as_tensor, args), **kw)
    assert int(j.num_leaves) == t.num_leaves <= 4
    np.testing.assert_array_equal(t.leaf_ids.numpy(), np.asarray(j.leaf_ids))


def test_cli_train_predict_round_trip(tmp_path):
    x, y = _data()
    train = tmp_path / "train.tsv"
    np.savetxt(train, np.column_stack([y, x]), delimiter="\t", fmt="%.6g")
    model = tmp_path / "model.txt"
    result = tmp_path / "pred.txt"
    conf = tmp_path / "train.conf"
    conf.write_text("task = train\nobjective = binary\nnum_trees = 3\n"
                    "num_leaves = 7\nmetric = binary_logloss,auc\n"
                    "is_training_metric = true\n")
    assert cli_main(["config=%s" % conf, "data=%s" % train,
                     "output_model=%s" % model, "device=cpu"]) == 0
    text = model.read_text()
    assert text.startswith("gbdt\n") and text.count("Tree=") == 3
    assert cli_main(["task=predict", "data=%s" % train,
                     "input_model=%s" % model, "output_result=%s" % result,
                     "device=cpu"]) == 0
    pred = np.loadtxt(result)
    assert pred.shape == (len(y),)
    assert ((pred >= 0) & (pred <= 1)).all()
    # the file round trip predicts what the in-memory model predicts
    booster = lgt.GBDT.from_model_file(str(model), device="cpu")
    feats = np.loadtxt(train, delimiter="\t")[:, 1:]
    np.testing.assert_allclose(pred, booster.predict(feats), atol=1e-6)
