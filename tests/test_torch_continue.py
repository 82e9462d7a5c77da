"""Continued training and initial scores: lightgbm_tpu_torch
(device="cpu") against the JAX package on the CPU.

The JAX package trains a model; both packages continue it, through the
CLI (``task=train input_model=...``) and through ``GBDT.init`` on a
dataset carrying the continuation scores, for binary and multiclass
(K = 3).  Checked: the start score ("PredictRaw over all models": each
row's float64 sum of every input tree whatever its class, rounded once
to float32, tiled over the K classes) bitwise; the kept trees' text
byte for byte; the new trees exact in structure with leaf values within
rtol 1e-5 / atol 5e-7 (the budget of tests/test_torch_gbdt.py).  Also
the ``input_init_score`` side file and its size ``Fatal``.  The
multiclass data carry seeded real-valued row weights, as in
tests/test_torch_sampling_gbdt.py (its header says why).
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu.cli import main as jcli
from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.objectives import create_objective as jcreate

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.cli import main as tcli
from lightgbm_tpu_torch.config import OverallConfig
from lightgbm_tpu_torch.models.predictor import continuation_score
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.utils import log
from tests import test_torch_sampling_gbdt as samp

K = 3
PARAMS = {"num_leaves": "15", "min_data_in_leaf": "20",
          "min_sum_hessian_in_leaf": "1.0", "learning_rate": "0.2",
          "leafwise_compact": "true"}
KINDS = {"binary": {"objective": "binary", "metric": "binary_logloss"},
         "multiclass": {"objective": "multiclass", "num_class": str(K),
                        "metric": "multi_logloss"}}


def _data(kind, n=1200, seed=14):
    make = samp.KINDS[kind][0]
    return make(np.random.RandomState(seed), n)[:2]


def _write_tsv(path, x, y):
    np.savetxt(path, np.column_stack([y, x]), delimiter="\t", fmt="%.17g")
    return str(path)


def _trees(text):
    """The model text's ``Tree=`` blocks."""
    body = text.split("\nTree=")[1:]
    return ["Tree=" + b.split("\n\n")[0] for b in body]


def _fields(block):
    return dict(ln.split("=", 1) for ln in block.split("\n") if "=" in ln)


def assert_trees_alike(want_blocks, got_blocks):
    assert len(got_blocks) == len(want_blocks)
    for k, (a, b) in enumerate(zip(want_blocks, got_blocks)):
        fa, fb = _fields(a), _fields(b)
        for key in ("Tree", "num_leaves", "split_feature", "threshold",
                    "left_child", "right_child", "leaf_parent"):
            assert fa[key] == fb[key], "tree %d %s" % (k, key)
        np.testing.assert_allclose(
            np.array(fb["leaf_value"].split(), float),
            np.array(fa["leaf_value"].split(), float), rtol=1e-5, atol=5e-7,
            err_msg="tree %d" % k)


@pytest.fixture(scope="module", params=sorted(KINDS))
def first_model(request, tmp_path_factory):
    """(kind, data dir, train file, JAX input model file) — the JAX
    package's model of 2 iterations on the training file."""
    kind = request.param
    d = tmp_path_factory.mktemp("continue_" + kind)
    x, y = _data(kind)
    train = _write_tsv(d / "train.tsv", x, y)
    if kind == "multiclass":
        np.savetxt(train + ".weight", samp._real_weights(len(y)),
                   fmt="%.9g")
    xv, yv = _data(kind, n=300, seed=15)
    _write_tsv(d / "valid.tsv", xv, yv)
    model = str(d / "m1.txt")
    args = ["task=train", "data=" + train, "output_model=" + model,
            "num_iterations=2"] + ["%s=%s" % kv for kv in
                                   dict(PARAMS, **KINDS[kind]).items()]
    assert jcli(args) == 0
    return kind, d, train, model


def _cli_args(kind, d, train, model, out, extra=()):
    return (["task=train", "data=" + train, "valid_data=%s" % (d / "valid.tsv"),
             "output_model=%s" % out, "num_iterations=2",
             "input_model=" + model]
            + ["%s=%s" % kv for kv in dict(PARAMS, **KINDS[kind]).items()]
            + list(extra))


def test_cli_continues_the_model(first_model):
    """Both CLIs continue the JAX package's model: its trees first, byte
    for byte, then the new ones (2 + 2 iterations)."""
    kind, d, train, model = first_model
    per_iter = K if kind == "multiclass" else 1
    outs = {}
    for name, main in (("jax", jcli), ("port", tcli)):
        out = d / ("m2_%s.txt" % name)
        extra = ["device=cpu"] if name == "port" else []
        assert main(_cli_args(kind, d, train, model, out, extra)) == 0
        outs[name] = _trees(out.read_text())
    first = _trees(open(model).read())
    assert len(first) == 2 * per_iter
    assert len(outs["port"]) == len(outs["jax"]) == 4 * per_iter
    assert outs["port"][:len(first)] == outs["jax"][:len(first)] == first
    assert_trees_alike(outs["jax"][len(first):], outs["port"][len(first):])


def test_c1_continuation_gives_four_trees(first_model, tmp_path):
    """The reproduction of ROADMAP §C1: a 2-iteration model continued for
    2 iterations holds 4 iterations' trees, not 2."""
    kind, d, train, model = first_model
    per_iter = K if kind == "multiclass" else 1
    out = tmp_path / "m2.txt"
    assert tcli(_cli_args(kind, d, train, model, out, ["device=cpu"])) == 0
    assert out.read_text().count("Tree=") == 4 * per_iter


def _continued_pair(kind, model, x, y, weights):
    """(JAX booster, port booster), each continuing ``model`` for 2
    iterations through ``GBDT.init`` on a dataset carrying the
    continuation scores, and the two datasets' init scores."""
    params = dict(PARAMS, **KINDS[kind])
    jcont = JGBDT.from_model_file(model)
    cfg = JConfig()
    cfg.set(dict(params), require_data=False)
    jds = JDataset.from_arrays(x, y, max_bin=255, weights=weights)
    jds.metadata.init_score = np.asarray(jcont.predict_raw(x), np.float32)
    j = JGBDT()
    j.models = list(jcont.models)
    j.init(cfg.boosting_config, jds,
           jcreate(cfg.objective_type, cfg.objective_config))
    tcont = lgt.GBDT.from_model_file(model, device="cpu")
    tcfg = OverallConfig()
    tcfg.set(dict(params), require_data=False)
    tds = lgt.Dataset.from_arrays(x, y, max_bin=255, weights=weights)
    tds.metadata.init_score = continuation_score(tcont.models, x,
                                                 torch.device("cpu"))
    t = lgt.GBDT()
    t.models = list(tcont.models)
    t.init(tcfg.boosting_config, tds,
           create_objective(tcfg.objective_type, tcfg.objective_config),
           device="cpu")
    return j, t, jds.metadata.init_score, tds.metadata.init_score


def test_gbdt_init_with_continuation_score(first_model):
    kind, d, train, model = first_model
    x, y = _data(kind)
    weights = samp._real_weights(len(y)) if kind == "multiclass" else None
    j, t, jinit, tinit = _continued_pair(kind, model, x, y, weights)
    per_iter = K if kind == "multiclass" else 1
    # the continuation score: bitwise the JAX package's, every tree of
    # the input model summed into one column whatever its class
    np.testing.assert_array_equal(tinit.view(np.uint32),
                                  jinit.view(np.uint32))
    start = np.tile(tinit, (per_iter, 1))
    np.testing.assert_array_equal(t.score.numpy(), start)
    np.testing.assert_array_equal(np.asarray(j.score), start)
    for _ in range(2):
        j.train_one_iter(is_eval=False)
        t.train_one_iter(is_eval=False)
    assert len(t.models) == len(j.models) == 4 * per_iter
    samp.assert_same_booster_trees(j, t)
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score),
                               rtol=1e-5, atol=2e-6)
    # model text: the kept trees byte for byte, the new ones alike
    j._saved_model_size = -1
    path = model + ".jax_continued"
    j.save_model_to_file(True, path)
    ttext = t.model_to_string()
    assert _trees(ttext)[:2 * per_iter] == _trees(open(model).read())
    assert_trees_alike(_trees(open(path).read()), _trees(ttext))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_input_init_score_file(kind, tmp_path):
    """``input_init_score`` (alias ``init_score``): one score per training
    row, the starting score of every class; the same model as the JAX
    package's; a file of the wrong size is the JAX package's Fatal."""
    x, y = _data(kind)
    train = _write_tsv(tmp_path / "train.tsv", x, y)
    if kind == "multiclass":
        np.savetxt(train + ".weight", samp._real_weights(len(y)),
                   fmt="%.9g")
    init = np.random.RandomState(5).randn(len(y)) * 0.3
    init_path = str(tmp_path / "train.init")
    np.savetxt(init_path, init, fmt="%.9g")
    texts = {}
    for name, main, extra in (("jax", jcli, []),
                              ("port", tcli, ["device=cpu"])):
        out = tmp_path / ("m_%s.txt" % name)
        args = ["task=train", "data=" + train, "output_model=%s" % out,
                "num_iterations=2", "init_score=" + init_path] \
            + ["%s=%s" % kv for kv in dict(PARAMS, **KINDS[kind]).items()]
        assert main(args + extra) == 0
        texts[name] = _trees(out.read_text())
    assert_trees_alike(texts["jax"], texts["port"])
    # the training set's score starts from the file, tiled over K
    from lightgbm_tpu_torch.config import IOConfig
    from lightgbm_tpu_torch.io.dataset import Dataset
    io = IOConfig()
    io.set({"data": train, "input_init_score": init_path})
    ds = Dataset.load_train(io)
    np.testing.assert_array_equal(
        ds.metadata.init_score, np.loadtxt(init_path).astype(np.float32))
    # the wrong size: the JAX package's message, exit code 1
    np.savetxt(init_path, init[:-1], fmt="%.9g")
    with pytest.raises(log.Fatal, match="Initial score size doesn't "
                                        "equal to data"):
        Dataset.load_train(io)
    assert tcli(["task=train", "data=" + train, "init_score=" + init_path,
                 "output_model=%s" % (tmp_path / "bad.txt"), "device=cpu"]
                + ["%s=%s" % kv for kv in KINDS[kind].items()]) == 1
