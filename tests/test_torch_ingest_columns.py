"""Column selectors and header names: lightgbm_tpu_torch's text loader
(device="cpu") against lightgbm_tpu's on the same files.

- ``has_header=true`` names the features from the header in the saved
  model, as the JAX package does (the port once wrote ``Column_%d``);
- ``label_column``, ``weight_column``, ``group_column`` and
  ``ignore_column``, by index and by ``name:``, with the label mid-file:
  mapper bytes, bin bytes and metadata equal; trees within the parity
  bar (structure exact, leaf values rtol 1e-5, tests/
  test_grower_unified.py:100-114);
- ``load_valid`` with a header and in-file weight and query columns.

Sizes: 1,500-2,000 rows, 5 features, 7-15 leaves, 2-3 iterations.
"""
import numpy as np
import pytest

from lightgbm_tpu.cli import main as jcli
from lightgbm_tpu.config import IOConfig as JIOConfig
from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.objectives import create_objective as jcreate
from lightgbm_tpu.utils.log import LightGBMError as JError

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.cli import main as tcli
from lightgbm_tpu_torch.config import IOConfig
from lightgbm_tpu_torch.utils import log

STRUCTURE = ("split_feature", "split_feature_real", "threshold_bin",
             "left_child", "right_child", "leaf_parent")


def write_table(path, n=1500, seed=5, header=True):
    """Columns a, b, y (binary label), w (weight), q (query id, runs of
    25 rows), c, d: the label and the side columns mid-file."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4)
    y = (x[:, 0] - 0.7 * x[:, 1] + 0.4 * rng.randn(n) > 0).astype(int)
    w = 0.5 + rng.rand(n)
    q = np.arange(n) // 25
    with open(path, "w") as f:
        if header:
            f.write("a,b,y,w,q,c,d\n")
        for i in range(n):
            f.write("%.6f,%.6f,%d,%.4f,%d,%.6f,%.6f\n" % (
                x[i, 0], x[i, 1], y[i], w[i], q[i], x[i, 2], x[i, 3]))
    return str(path)


def assert_same_dataset(j, t):
    """Mappers, bin bytes, names, feature map and metadata bitwise."""
    assert t.feature_names == j.feature_names
    assert t.label_idx == j.label_idx
    assert t.num_total_features == j.num_total_features
    assert list(t.used_feature_map.items()) == \
        list(j.used_feature_map.items())
    assert [m.to_bytes() for m in t.bin_mappers] == \
        [m.to_bytes() for m in j.bin_mappers]
    jb = j.bins if j.bins is not None else np.asarray(j.device_bins)
    tb = t.read_bins()
    assert tb.dtype == jb.dtype and tb.tobytes() == jb.tobytes()
    for key in ("label", "weights", "query_boundaries", "query_weights"):
        a, b = getattr(j.metadata, key), getattr(t.metadata, key)
        assert (a is None) == (b is None), key
        if a is not None:
            assert b.dtype == a.dtype and b.tobytes() == a.tobytes(), key


def _train_pair(jds, tds, params, iters):
    cfg = JConfig()
    cfg.set(dict(params), require_data=False)
    j = JGBDT()
    j.init(cfg.boosting_config, jds,
           jcreate(cfg.objective_type, cfg.objective_config))
    for _ in range(iters):
        if j.train_one_iter(is_eval=False):
            break
    t = lgt.train(dict(params, num_iterations=iters), tds, device="cpu")
    return j, t


def assert_same_trees(j, t):
    assert len(j.models) == len(t.models)
    for k, (a, b) in enumerate(zip(j.models, t.models)):
        assert a.num_leaves == b.num_leaves, "tree %d" % k
        for field in STRUCTURE:
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field),
                                          err_msg="tree %d %s" % (k, field))
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=5e-7, err_msg="tree %d" % k)


def _importances(path):
    with open(path) as f:
        text = f.read()
    return text[text.index("feature importances:"):].strip()


def test_has_header_names_features_in_model_file(tmp_path):
    """The reproduction of the header fault: a 2,000 x 5 CSV with header
    ``y,a,b,c,d,e`` through both CLIs; the saved models' ``feature
    importances:`` blocks name the same header columns."""
    rng = np.random.RandomState(0)
    x = rng.randn(2000, 5)
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.randn(2000) > 0).astype(int)
    data = str(tmp_path / "train.csv")
    with open(data, "w") as f:
        f.write("y,a,b,c,d,e\n")
        for i in range(2000):
            f.write("%d,%s\n" % (y[i], ",".join("%.6f" % v for v in x[i])))
    blocks = {}
    for name, main, extra in (("jax", jcli, []),
                              ("port", tcli, ["device=cpu"])):
        model = str(tmp_path / ("%s.txt" % name))
        assert main(["task=train", "data=" + data, "has_header=true",
                     "objective=binary", "num_trees=2", "num_leaves=7",
                     "output_model=" + model] + extra) == 0
        blocks[name] = _importances(model)
    assert blocks["port"] == blocks["jax"]
    names = [ln.split("=")[0] for ln in blocks["port"].splitlines()[1:]]
    assert names and set(names) <= {"a", "b", "c", "d", "e"}


SELECTORS = {
    "label-index": {"label_column": "2"},
    "label-name": {"label_column": "name:y"},
    "weight-index": {"label_column": "2", "weight_column": "3",
                     "ignore_column": "4"},
    "weight-name": {"label_column": "name:y", "weight_column": "name:w",
                    "ignore_column": "name:q"},
    "ignore-list-index": {"label_column": "2", "ignore_column": "0,3,4,6"},
    "ignore-list-name": {"label_column": "name:y",
                         "ignore_column": "name:a,w,q,d"},
}


# name: selectors need the header; index selectors run with and without
CASES = [(case, header) for case in sorted(SELECTORS)
         for header in (True, False)
         if header or "name" not in case]


@pytest.mark.parametrize("case,header", CASES,
                         ids=["%s-%s" % (c, "header" if h else "bare")
                              for c, h in CASES])
def test_selectors_match_jax(tmp_path, case, header):
    sel = SELECTORS[case]
    data = write_table(tmp_path / "t.csv", header=header)
    kw = dict(sel, data_filename=data, has_header=header, max_bin=63)
    j = JDataset.load_train(JIOConfig(**kw))
    t = lgt.Dataset.load_train(IOConfig(**kw))
    assert_same_dataset(j, t)
    if "weight_column" in sel:
        assert t.metadata.weights is not None
    jb, tb = _train_pair(j, t, {"objective": "binary", "num_leaves": 15,
                                "min_data_in_leaf": 20,
                                "min_sum_hessian_in_leaf": 1.0,
                                "learning_rate": 0.2}, 3)
    assert_same_trees(jb, tb)
    assert tb.feature_importance() == jb.feature_importance()
    if header:
        # the saved model names the header's columns, label removed
        names = [ln.split("=")[0]
                 for ln in tb.feature_importance().splitlines()[2:]]
        assert names and set(names) <= {"a", "b", "w", "q", "c", "d"}


@pytest.mark.parametrize("group", ["4", "name:q"])
def test_group_column_lambdarank_matches_jax(tmp_path, group):
    """An in-file query column, by index and by name, under lambdarank:
    the query boundaries and query weights come from the column."""
    rng = np.random.RandomState(11)
    n = 1500
    x = rng.randn(n, 4)
    rel = np.clip((x[:, 0] + rng.randn(n) * 0.5 + 1.5).astype(int), 0, 3)
    q = np.repeat(np.arange(n // 30), 30)
    w = 0.5 + rng.rand(n)
    data = str(tmp_path / "rank.csv")
    with open(data, "w") as f:
        f.write("a,b,y,w,q,c,d\n")
        for i in range(n):
            f.write("%.6f,%.6f,%d,%.4f,%d,%.6f,%.6f\n" % (
                x[i, 0], x[i, 1], rel[i], w[i], q[i], x[i, 2], x[i, 3]))
    kw = dict(data_filename=data, has_header=True, label_column="name:y",
              group_column=group, weight_column="name:w")
    j = JDataset.load_train(JIOConfig(**kw))
    t = lgt.Dataset.load_train(IOConfig(**kw))
    assert_same_dataset(j, t)
    assert t.metadata.query_boundaries.size == n // 30 + 1
    jb, tb = _train_pair(j, t, {"objective": "lambdarank",
                                "num_leaves": 7, "min_data_in_leaf": 20,
                                "min_sum_hessian_in_leaf": 1.0}, 2)
    assert_same_trees(jb, tb)


@pytest.mark.parametrize("kw,message", [
    ({"label_column": "name:nope"}, "cannot find label column"),
    ({"weight_column": "w"}, "weight_column is not a number"),
    ({"ignore_column": "name:a,zz"}, "cannot find column: zz"),
], ids=["label-name", "weight-not-number", "ignore-name"])
def test_selector_faults_are_jax_fatals(tmp_path, kw, message):
    data = write_table(tmp_path / "t.csv", n=200)
    kw = dict(kw, data_filename=data, has_header=True)
    with pytest.raises(JError, match=message) as want:
        JDataset.load_train(JIOConfig(**kw))
    with pytest.raises(log.Fatal, match=message) as got:
        lgt.Dataset.load_train(IOConfig(**kw))
    assert str(got.value) == str(want.value)


def test_load_valid_header_and_columns_match_jax(tmp_path):
    """A validation file with a header, a weight column and a query
    column: binned with the training mappers, its own metadata."""
    train = write_table(tmp_path / "train.csv", n=1500, seed=1)
    valid = write_table(tmp_path / "valid.csv", n=600, seed=2)
    kw = dict(data_filename=train, has_header=True, label_column="name:y",
              weight_column="name:w", group_column="name:q")
    jcfg, tcfg = JIOConfig(**kw), IOConfig(**kw)
    j = JDataset.load_train(jcfg)
    t = lgt.Dataset.load_train(tcfg)
    jv = JDataset.load_valid(j, valid, io_config=jcfg)
    tv = lgt.Dataset.load_valid(t, valid, io_config=tcfg)
    assert_same_dataset(jv, tv)
    assert tv.metadata.weights is not None
    assert tv.metadata.query_boundaries.size == 600 // 25 + 1
    # without io_config: no header skip, side files only, as the JAX
    # package
    plain = write_table(tmp_path / "plain.csv", n=300, seed=3,
                        header=False)
    assert_same_dataset(JDataset.load_valid(j, plain),
                        lgt.Dataset.load_valid(t, plain))


def test_cli_selectors_and_valid_match_jax(tmp_path):
    """The column keys and their aliases through both CLIs, with a
    validation file: the same model files, up to leaf-value rounding."""
    train = write_table(tmp_path / "train.csv", n=1500, seed=7)
    valid = write_table(tmp_path / "valid.csv", n=500, seed=8)
    texts = {}
    for name, main, extra in (("jax", jcli, []),
                              ("port", tcli, ["device=cpu"])):
        model = str(tmp_path / ("%s.txt" % name))
        assert main(["task=train", "data=" + train, "valid=" + valid,
                     "header=true", "label=name:y", "weight=name:w",
                     "ignore_feature=name:q", "objective=binary",
                     "metric=binary_logloss", "num_trees=2",
                     "num_leaves=7", "output_model=" + model] + extra) == 0
        texts[name] = model
    j = JGBDT.from_model_file(texts["jax"])
    t = lgt.GBDT.from_model_file(texts["port"], device="cpu")
    assert_same_trees(j, t)
    np.testing.assert_array_equal(t.models[0].threshold,
                                  j.models[0].threshold)
    assert _importances(texts["port"]) == _importances(texts["jax"])
