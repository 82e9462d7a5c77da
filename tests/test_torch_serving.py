"""The serving engine: lightgbm_tpu_torch.serving (device="cpu") against
lightgbm_tpu.serving, run live on the same model files and rows.

Tolerances: none.  The flattened tables, rank codes and leaf indices are
integers; the scores are float32 sums of the same float32 leaf values
added in the same order (tree by tree into their class rows), so the
engines' scores are bitwise equal in float32 and int8; ``task=predict``
result files are byte-equal.

Sizes: at most 2,000 rows, 8 features, 31 leaves and 8 iterations.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu import serving as jserving
from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io import parser as jparser
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.models.predictor import Predictor as JPredictor

from lightgbm_tpu_torch import convert, lifecycle, serving
from lightgbm_tpu_torch.config import OverallConfig
from lightgbm_tpu_torch.io import parser as tparser
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.models.predictor import Predictor
from lightgbm_tpu_torch.ops import scoring
from lightgbm_tpu_torch.utils import log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJECTIVES = ("regression", "binary", "lambdarank", "multiclass")
BASE = {"num_leaves": 15, "min_data_in_leaf": 20,
        "min_sum_hessian_in_leaf": 1.0, "num_iterations": 8,
        "learning_rate": 0.2}
K = 3


@pytest.fixture(autouse=True)
def no_leaked_threads():
    """Every front and prefetch a test starts is closed by its end."""
    yield
    leaked = lifecycle.leaks()
    for _kind, _name, closer in leaked:
        closer()
    assert not leaked, "left live: %s" % [(k, n) for k, n, _ in leaked]


def _rows(n, f=6, seed=3):
    return np.random.RandomState(seed).randn(n, f)


def _labels(objective, x, rng):
    if objective == "regression":
        return (x[:, 0] + 0.3 * x[:, 1] ** 2
                + 0.1 * rng.randn(len(x))).astype(np.float32)
    if objective == "binary":
        return (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)
    if objective == "lambdarank":
        return np.clip(np.digitize(x[:, 0], [-0.6, 0.2, 1.0]),
                       0, 3).astype(np.float32)
    return np.digitize(x[:, 0], [-0.5, 0.5]).astype(np.float32)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{objective: (model file, rows)}: a JAX booster trained on each
    objective (multiclass K = 3, 4 iterations) and saved."""
    out = {}
    d = tmp_path_factory.mktemp("serving_models")
    for objective in OBJECTIVES:
        rng = np.random.RandomState(3)
        x = _rows(500)
        params = dict(BASE, objective=objective)
        kwargs = {}
        if objective == "lambdarank":
            kwargs["query_boundaries"] = np.arange(0, 501, 50)
        if objective == "multiclass":
            params.update(num_class=K, num_iterations=4)
        booster = jlgb.train(params, JDataset.from_arrays(
            x, _labels(objective, x, rng), max_bin=64, **kwargs))
        path = str(d / ("%s.txt" % objective))
        booster.save_model_to_file(True, path)
        out[objective] = (path, x)
    return out


def _flats(path):
    """(JAX FlatEnsemble, port FlatEnsemble) of one model file."""
    jflat = JGBDT.from_model_file(path).export_flat()
    tflat = GBDT.from_model_file(path, device="cpu").export_flat()
    return jflat, tflat


def assert_flat_equal(jflat, tflat):
    for name in convert.FLAT_FIELDS:
        want, got = getattr(jflat, name), getattr(tflat, name)
        if name == "thresholds":
            assert sorted(got) == sorted(want)
            for f in want:
                np.testing.assert_array_equal(got[f], want[f])
                assert got[f].dtype == np.float64
        elif isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got == want, name


def _with_ties_and_nan(flat, x):
    """``x`` with exact threshold values and NaN planted in the used
    columns."""
    x = x.copy()
    for i, f in enumerate(flat.used):
        thr = flat.thresholds[f]
        x[i::7, f] = thr[(np.arange(len(x[i::7])) * 5) % len(thr)]
        x[3 + i::11, f] = np.nan
    return x


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_flat_tables_and_codes_equal_jax(models, objective):
    path, x = models[objective]
    jflat, tflat = _flats(path)
    assert_flat_equal(jflat, tflat)
    xt = _with_ties_and_nan(tflat, x)
    np.testing.assert_array_equal(tflat.encode(xt), jflat.encode(xt))
    for name in ("int8_tables",):
        for a, b in zip(getattr(jflat, name)(), getattr(tflat, name)()):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tflat.dequantized_leaf_value(),
                                  jflat.dequantized_leaf_value())


STUMPS_MODEL = """gbdt
num_class=1
label_index=0
max_feature_idx=4

Tree=0
num_leaves=4
split_feature=2 0 2
split_gain=3 2 1
threshold=0.5 -1.25 1.5
left_child=1 -1 -2
right_child=2 -3 -4
leaf_parent=1 2 1 2
leaf_value=0.1 -0.2 0.30000000000000004 -0.4

Tree=1
num_leaves=1
split_feature=0
split_gain=0
threshold=0
left_child=0
right_child=0
leaf_parent=-1
leaf_value=0.0625

Tree=2
num_leaves=3
split_feature=2 4
split_gain=2 1
threshold=0.5 0
left_child=-1 -2
right_child=1 -3
leaf_parent=0 1 1
leaf_value=-1e-3 2e-3 -3e-3

Tree=3
num_leaves=1
split_feature=0
split_gain=0
threshold=0
left_child=0
right_child=0
leaf_parent=-1
leaf_value=-0.5

"""


@pytest.mark.parametrize("quantize", ["float32", "int8"])
def test_stumps_ties_and_nan(tmp_path, quantize):
    """A hand-written model with stumps (trees 1 and 3), a threshold
    shared by two trees, unused columns, and rows at every threshold
    exactly, above and below it, and NaN: the same tables, codes, scores
    and leaf indices as the JAX package's."""
    path = str(tmp_path / "stumps.txt")
    with open(path, "w") as f:
        f.write(STUMPS_MODEL)
    jflat, tflat = _flats(path)
    assert_flat_equal(jflat, tflat)
    np.testing.assert_array_equal(tflat.root_state, [0, -1, 0, -1])
    assert tflat.used == [0, 2, 4] and tflat.max_depth == 2
    col = np.array([-1.25, 0.5, 1.5, 0.0, np.nan, -2.0, 0.4999999, 0.5000001,
                    3.0, -1.2500001])
    x = np.zeros((len(col) ** 2, 5))
    x[:, 0] = np.repeat(col, len(col))
    x[:, 2] = np.tile(col, len(col))
    x[:, 4] = np.tile(col[::-1], len(col))
    x[:, 1] = np.nan                      # an unused column
    np.testing.assert_array_equal(tflat.encode(x), jflat.encode(x))
    want = jserving.ServingEngine(jflat, quantize=quantize).scores(x)
    eng = serving.ServingEngine(tflat, quantize=quantize, device="cpu")
    np.testing.assert_array_equal(eng.scores(x), want)
    leaves = eng.leaf_indices(x)
    np.testing.assert_array_equal(
        leaves, jserving.ServingEngine(jflat).leaf_indices(x))
    # the host float64 walk: the same leaves
    booster = GBDT.from_model_file(path, device="cpu")
    jb = JGBDT.from_model_file(path)
    np.testing.assert_array_equal(leaves, jb.predict_leaf_index(x))
    np.testing.assert_array_equal(booster.predict_leaf_index(x), leaves)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_flat_from_numpy_round_trips_jax_tables(models, objective):
    """The JAX package's flattened arrays, carried into the port, serve
    the JAX engine's scores."""
    path, x = models[objective]
    jflat, tflat = _flats(path)
    carried = convert.flat_from_numpy(
        {k: getattr(jflat, k) for k in convert.FLAT_FIELDS})
    assert_flat_equal(jflat, carried)
    assert_flat_equal(tflat, carried)
    np.testing.assert_array_equal(
        serving.ServingEngine(carried, device="cpu").scores(x),
        jserving.ServingEngine(jflat).scores(x))


@pytest.mark.parametrize("quantize", ["float32", "int8"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_engine_scores_bitwise_equal_jax(models, objective, quantize):
    path, x = models[objective]
    jflat, tflat = _flats(path)
    want = jserving.ServingEngine(jflat, quantize=quantize).scores(x)
    eng = serving.ServingEngine(tflat, quantize=quantize, device="cpu")
    got = eng.scores(x)
    assert got.dtype == np.float64
    assert got.shape == (tflat.num_class, len(x))
    np.testing.assert_array_equal(got, want)
    if quantize == "float32":
        # the float64 host walk: the same leaves, f32 sums
        booster = GBDT.from_model_file(path, device="cpu")
        host = booster.predict_raw(x).reshape(tflat.num_class, -1)
        np.testing.assert_allclose(got, host, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_leaf_indices_equal_jax(models, objective):
    path, x = models[objective]
    jflat, tflat = _flats(path)
    want = jserving.ServingEngine(jflat).leaf_indices(x)
    got = serving.ServingEngine(tflat, device="cpu").leaf_indices(x)
    assert got.dtype == np.int32 and got.shape == (len(x), tflat.num_trees)
    np.testing.assert_array_equal(got, want)
    # GBDT.predict_leaf_index: the JAX package's host replay below its
    # device threshold, the port's engine; both count trees
    jb = JGBDT.from_model_file(path)
    tb = GBDT.from_model_file(path, device="cpu")
    np.testing.assert_array_equal(tb.predict_leaf_index(x),
                                  jb.predict_leaf_index(x))
    np.testing.assert_array_equal(tb.predict_leaf_index(x, 3),
                                  jb.predict_leaf_index(x, 3))


def test_bucket_padding_never_leaks(models):
    """Every batch size scores what the walk gives the unpadded rows,
    chunks past the largest bucket included, under either ``donate``."""
    path, x = models["multiclass"]
    x = np.concatenate([x, _rows(1500, seed=9)])
    jflat, tflat = _flats(path)
    t = {k: torch.as_tensor(getattr(tflat, k)) for k in (
        "split_feature", "threshold_rank", "left_child", "right_child",
        "leaf_value", "root_state")}
    for buckets in ((1, 32, 1024), (1, 16)):
        for donate in ("true", "false"):
            eng = serving.ServingEngine(tflat, buckets=buckets,
                                        donate=donate, device="cpu")
            jeng = jserving.ServingEngine(jflat, buckets=buckets)
            for n in (1, 15, 17, 31, 33, 1000, 2000):
                exact = scoring.bfs_scores(
                    torch.as_tensor(tflat.encode(x[:n])),
                    t["split_feature"], t["threshold_rank"],
                    t["left_child"], t["right_child"], t["leaf_value"],
                    t["root_state"], tflat.tree_class,
                    max_depth=tflat.max_depth, num_class=K).numpy()
                got = eng.scores(x[:n])
                np.testing.assert_array_equal(got, exact)
                np.testing.assert_array_equal(got, jeng.scores(x[:n]))
                np.testing.assert_array_equal(eng.leaf_indices(x[:n]),
                                              jeng.leaf_indices(x[:n]))
    assert eng.bucket_for(0) == 1 and eng.bucket_for(16) == 16


def test_empty_ensemble_and_warmup(models):
    x = _rows(40)
    for flat, jflat in ((serving.FlatEnsemble.from_models([], 1),
                         jserving.FlatEnsemble.from_models([], 1)),):
        eng = serving.ServingEngine(flat, device="cpu")
        np.testing.assert_array_equal(eng.scores(x),
                                      jserving.ServingEngine(jflat).scores(x))
        assert eng.scores(x).shape == (1, 40)
        assert eng.leaf_indices(x).shape == (40, 0)
        assert eng.warmup() is eng
    path, x = models["binary"]
    _, tflat = _flats(path)
    eng = serving.ServingEngine(tflat, buckets=(4, 64), donate="true",
                                device="cpu")
    assert eng.warmup() is eng and eng.warmup([4]) is eng
    np.testing.assert_array_equal(
        eng.scores(x), serving.ServingEngine(tflat, device="cpu").scores(x))
    assert eng.scores(x[:0]).shape == (1, 0)


def test_engine_option_checks(models):
    """The JAX engine's value checks and messages; tree-axis sharding and
    the per-tree replay ``algo=scan`` are served, and score as the JAX
    engine does."""
    path, x = models["binary"]
    jflat, tflat = _flats(path)
    for kwargs in ({"quantize": "int4"}, {"algo": "dfs"}, {"buckets": ()},
                   {"buckets": (0, 8)}, {"shards": -1}, {"linger_us": -1},
                   {"queue": 0}, {"donate": "maybe"},
                   {"shards": 2, "algo": "scan"}):
        with pytest.raises(ValueError) as want:
            jserving.ServingEngine(jflat, **kwargs)
        with pytest.raises(ValueError) as got:
            serving.ServingEngine(tflat, device="cpu", **kwargs)
        assert str(got.value) == str(want.value)
    for kwargs in ({"shards": 2}, {"algo": "scan"}):
        np.testing.assert_array_equal(
            serving.ServingEngine(tflat, device="cpu", **kwargs).scores(x),
            jserving.ServingEngine(jflat, **kwargs).scores(x))
    eng = serving.ServingEngine(tflat, shards=1, buckets=[32, 1, 32],
                                device="cpu")
    assert eng.buckets == (1, 32)
    if not torch.cuda.is_available():
        with pytest.raises(log.Fatal, match="no CUDA device"):
            serving.ServingEngine(tflat)


def _config(cls, params):
    cfg = cls()
    cfg.set(dict({"task": "predict", "data": "x.tsv"}, **params))
    return cfg


def _configs(params):
    """(JAX OverallConfig, port OverallConfig) of the same predict
    parameters."""
    return _config(JConfig, params), _config(OverallConfig, params)


def test_config_predict_keys_match_jax():
    j, t = _configs({})
    assert serving.engine_options_from_config(t.io_config) == \
        jserving.engine_options_from_config(j.io_config)
    assert t.predict_leaf_index is False
    params = {"predict_buckets": "64,8,8,1", "predict_quantize": "INT8",
              "predict_donate": "true", "predict_algo": "bfs",
              "predict_linger_us": "0", "predict_queue": "2",
              "predict_leaf_index": "+", "serve_shards": "1"}
    j, t = _configs(params)
    got = serving.engine_options_from_config(t.io_config)
    assert got == jserving.engine_options_from_config(j.io_config)
    assert got["buckets"] == (1, 8, 64) and got["quantize"] == "int8"
    assert t.predict_leaf_index is j.predict_leaf_index is True


@pytest.mark.parametrize("key,value", [
    ("predict_buckets", "1,x"), ("predict_buckets", "0,8"),
    ("predict_buckets", ","), ("predict_quantize", "int4"),
    ("predict_donate", "maybe"), ("predict_algo", "dfs"),
    ("predict_linger_us", "-1"), ("predict_linger_us", "1.5"),
    ("predict_queue", "0"), ("predict_leaf_index", "yes")])
def test_config_predict_key_fatals_match_jax(key, value):
    with pytest.raises(Exception) as want:
        _config(JConfig, {key: value})
    with pytest.raises(log.Fatal) as got:
        _config(OverallConfig, {key: value})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("value", ["scan", "SCAN"])
def test_predict_algo_scan_refused_by_name(value, models):
    """Once refused by name: the port takes the per-tree replay as the
    JAX package takes it, and its engine scores bitwise the JAX scan
    engine's and the port's breadth-first walk's."""
    j, t = _configs({"predict_algo": value})
    assert t.io_config.predict_algo == j.io_config.predict_algo == "scan"
    got = serving.engine_options_from_config(t.io_config)
    assert got == jserving.engine_options_from_config(j.io_config)
    path, x = models["binary"]
    jflat, tflat = _flats(path)
    scan = serving.ServingEngine(tflat, device="cpu", **got).scores(x)
    np.testing.assert_array_equal(
        scan, jserving.ServingEngine(
            jflat, **jserving.engine_options_from_config(j.io_config))
        .scores(x))
    np.testing.assert_array_equal(
        scan, serving.ServingEngine(tflat, device="cpu").scores(x))


@pytest.mark.parametrize("value", ["2", "8", "-1"])
def test_serve_shards_refused_by_name(value, models):
    """Once refused by name: the port takes what the JAX package takes.
    2 and 8 shards parse, and the engine serves them on the CPU bitwise
    the JAX engine's; -1 is the JAX config's Fatal, and the JAX engine's
    ValueError at the engine."""
    params = {"serve_shards": value}
    if int(value) < 0:
        with pytest.raises(Exception) as want:
            _config(JConfig, params)
        with pytest.raises(log.Fatal) as got:
            _config(OverallConfig, params)
        assert str(got.value) == str(want.value)
        path, _ = models["binary"]
        jflat, tflat = _flats(path)
        with pytest.raises(ValueError) as want:
            jserving.ServingEngine(jflat, shards=int(value))
        with pytest.raises(ValueError) as got:
            serving.ServingEngine(tflat, shards=int(value), device="cpu")
        assert str(got.value) == str(want.value)
        return
    j, t = _configs(params)
    opts = serving.engine_options_from_config(t.io_config)
    assert opts == jserving.engine_options_from_config(j.io_config)
    assert opts["shards"] == int(value)
    path, x = models["multiclass"]
    jflat, tflat = _flats(path)
    eng = serving.ServingEngine(tflat, device="cpu", **opts)
    assert len(eng.devices) == int(value)
    np.testing.assert_array_equal(
        eng.scores(x), jserving.ServingEngine(jflat, **opts).scores(x))


def _write_tsv(path, x, y):
    np.savetxt(path, np.column_stack([y, x]), delimiter="\t", fmt="%.17g")
    return str(path)


# (objective, is_sigmoid, leaf index, num_model_predict, options)
FILE_MODES = {
    "default": ("binary", True, False, -1, {}),
    "int8": ("binary", True, False, -1, {"predict_quantize": "int8"}),
    "leaf_index": ("binary", True, True, -1, {}),
    "raw": ("binary", False, False, -1, {}),
    "multiclass": ("multiclass", True, False, -1, {}),
    "multiclass_leaf_index": ("multiclass", True, True, 2, {}),
    "num_model_predict": ("multiclass", True, False, 2,
                          {"predict_quantize": "int8"}),
    "regression_small_ladder": ("regression", True, False, 5,
                                {"predict_buckets": "1,16"}),
}


@pytest.mark.parametrize("mode", sorted(FILE_MODES))
def test_predict_file_byte_equal_jax(models, mode, tmp_path):
    """Predictor.predict_file against the JAX package's Predictor on the
    same model and file: byte-equal resident, and a streamed run (7-row
    chunks) byte-equal to the resident one; one flatten per
    Predictor."""
    objective, sigmoid, leaf, used, params = FILE_MODES[mode]
    path, x = models[objective]
    x = np.concatenate([x[:300], _with_ties_and_nan(
        GBDT.from_model_file(path, device="cpu").export_flat(), x[300:])])
    data = _write_tsv(tmp_path / "data.tsv", x, np.zeros(len(x)))
    jcfg, tcfg = _configs(params)
    want = str(tmp_path / "jax.txt")
    JPredictor(JGBDT.from_model_file(path), sigmoid, leaf, used,
               serving_options=jserving.engine_options_from_config(
                   jcfg.io_config)).predict_file(data, want, False)
    results = {}
    for chunk_lines in (500_000, 7):
        before = serving.FLATTEN_COUNT
        pred = Predictor(GBDT.from_model_file(path, device="cpu"), sigmoid,
                         leaf, used, serving_options=serving
                         .engine_options_from_config(tcfg.io_config))
        out = str(tmp_path / ("port_%d.txt" % chunk_lines))
        pred.predict_file(data, out, False, chunk_lines=chunk_lines)
        assert serving.FLATTEN_COUNT == before + 1
        with open(out, "rb") as f:
            results[chunk_lines] = f.read()
    with open(want, "rb") as f:
        assert results[500_000] == f.read()
    assert results[7] == results[500_000]
    rows = results[7].decode().splitlines()
    assert len(rows) == len(x)
    if leaf:
        n_trees = len(GBDT.from_model_file(path, device="cpu").models)
        if used > 0:
            n_trees = used * K if objective == "multiclass" else used
        assert all(len(r.split("\t")) == n_trees for r in rows)
        assert all(c.lstrip("-").isdigit() for c in rows[0].split("\t"))


def test_predict_matrix_pads_and_truncates(models):
    path, x = models["binary"]
    booster = GBDT.from_model_file(path, device="cpu")
    pred = Predictor(booster, True, False, -1)
    full = pred.predict_matrix(x)
    wide = pred.predict_matrix(np.concatenate([x, x], axis=1))
    np.testing.assert_array_equal(wide, full)
    narrow = pred.predict_matrix(x[:, :2].astype(np.float32))
    np.testing.assert_array_equal(
        narrow, pred.predict_matrix(np.concatenate(
            [x[:, :2].astype(np.float32),
             np.zeros((len(x), 4), np.float32)], axis=1)))
    np.testing.assert_allclose(full, booster.predict(x), rtol=1e-6)


def test_binary_cache_is_a_named_fatal(models, tmp_path):
    """A dataset cache is scored since the ingest slice
    (tests/test_torch_ingest_cache.py); a damaged one is the JAX
    Predictor's named Fatal."""
    path, _ = models["binary"]
    cache = tmp_path / "data.bin"
    cache.write_bytes(b"LGBM_TPU_BIN_V1" + bytes(16))
    pred = Predictor(GBDT.from_model_file(path, device="cpu"), True, False,
                     -1)
    with pytest.raises(log.Fatal, match="damaged lightgbm_tpu cache") as got:
        pred.predict_file(str(cache), str(tmp_path / "out.txt"), False)
    jpred = JPredictor(JGBDT.from_model_file(path), True, False, -1)
    with pytest.raises(jlgb.utils.log.LightGBMError) as want:
        jpred.predict_file(str(cache), str(tmp_path / "jout.txt"), False)
    assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]


def test_read_line_chunks_and_prefetch(tmp_path):
    """The chunk reader yields the JAX package's chunks; the prefetcher
    yields them in order, raises the producer's exception after the
    items before it, and leaves no thread behind when the consumer stops
    early."""
    path = tmp_path / "lines.txt"
    path.write_text("head\n" + "".join(
        "%d\n" % i if i % 5 else "\n" for i in range(1, 40)))
    for skip in (False, True):
        want = list(jparser.read_line_chunks(str(path), skip, 4))
        got = list(tparser.read_line_chunks(str(path), skip, 4))
        assert got == want
        assert tparser.read_lines(str(path), skip) == \
            jparser.read_lines(str(path), skip)
        assert list(tparser.prefetch_chunks(iter(got), depth=1)) == want

    def failing():
        yield 1
        yield 2
        raise KeyError("parse failed")

    seen = []
    with pytest.raises(KeyError, match="parse failed"):
        for item in tparser.prefetch_chunks(failing(), depth=1):
            seen.append(item)
    assert seen == [1, 2]
    gen = tparser.prefetch_chunks(iter(range(1000)), depth=2)
    assert next(gen) == 0
    assert any(k == "prefetch" for k, _, _ in lifecycle.leaks())
    gen.close()
    assert not lifecycle.leaks()


def test_cli_predict_equals_jax_cli(models, tmp_path):
    """``python -m lightgbm_tpu_torch task=predict ... device=cpu``
    writes the file ``python -m lightgbm_tpu`` writes, by default and
    with ``predict_leaf_index=true`` and ``predict_quantize=int8``."""
    path, x = models["multiclass"]
    data = _write_tsv(tmp_path / "data.tsv", x, np.zeros(len(x)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    for extra in ([], ["predict_leaf_index=true"],
                  ["predict_quantize=int8", "predict_buckets=1,64"]):
        outs = []
        for module, dev in (("lightgbm_tpu", []),
                            ("lightgbm_tpu_torch", ["device=cpu"])):
            out = str(tmp_path / ("%s.txt" % module))
            subprocess.run([sys.executable, "-m", module, "task=predict",
                            "data=%s" % data, "input_model=%s" % path,
                            "output_result=%s" % out] + extra + dev,
                           check=True, env=env, cwd=str(tmp_path),
                           capture_output=True, timeout=300)
            with open(out, "rb") as f:
                outs.append(f.read())
        assert outs[1] == outs[0], extra
        assert len(outs[1].splitlines()) == len(x)
