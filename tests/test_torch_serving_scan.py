"""The per-tree replay walk (``predict_algo=scan``):
lightgbm_tpu_torch.serving with ``algo="scan"`` (device="cpu") against
the JAX engine's ``algo="scan"`` and the port's breadth-first engine, run
live on the same model files and rows.

Tolerances: none.  Both walks route every row by the same integer rank
codes and add each tree's leaf values into its class row in tree order,
so the scores are bitwise equal, float32 and int8 (the scan engine reads
the dequantized table under int8, as the JAX engine does); leaf indices
and result files are equal.

Sizes: 500 rows, 6 features, 15 leaves, at most 8 iterations.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu import serving as jserving
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.ops import scoring as jscoring

from lightgbm_tpu_torch import serving
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.models.predictor import Predictor
from lightgbm_tpu_torch.ops import scoring

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJECTIVES = ("regression", "binary", "lambdarank", "multiclass")
BASE = {"num_leaves": 15, "min_data_in_leaf": 20,
        "min_sum_hessian_in_leaf": 1.0, "num_iterations": 8,
        "learning_rate": 0.2}


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
    """{objective: (model file, rows)}: a JAX booster per objective
    (multiclass K = 3, 4 iterations), saved."""
    out = {}
    d = tmp_path_factory.mktemp("scan_models")
    for objective in OBJECTIVES:
        rng = np.random.RandomState(5)
        x = rng.randn(500, 6)
        params = dict(BASE, objective=objective)
        kwargs = {}
        if objective == "lambdarank":
            kwargs["query_boundaries"] = np.arange(0, 501, 50)
        if objective == "multiclass":
            params.update(num_class=3, num_iterations=4)
        booster = jlgb.train(params, JDataset.from_arrays(
            x, _labels(objective, x, rng), max_bin=64, **kwargs))
        path = str(d / ("%s.txt" % objective))
        booster.save_model_to_file(True, path)
        out[objective] = (path, x)
    return out


def _flats(path):
    return (JGBDT.from_model_file(path).export_flat(),
            GBDT.from_model_file(path, device="cpu").export_flat())


def _with_ties_and_nan(flat, x):
    """``x`` with exact threshold values and NaN in the used columns."""
    x = x.copy()
    for i, f in enumerate(flat.used):
        thr = flat.thresholds[f]
        x[i::7, f] = thr[(np.arange(len(x[i::7])) * 5) % len(thr)]
        x[3 + i::11, f] = np.nan
    return x


@pytest.mark.parametrize("quantize", ["float32", "int8"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_scan_engine_bitwise(models, objective, quantize):
    """``algo="scan"``: scores bitwise the JAX scan engine's and the
    port's breadth-first engine's, over ties and NaN too; leaf indices
    equal to both."""
    path, x = models[objective]
    jflat, tflat = _flats(path)
    x = _with_ties_and_nan(tflat, x)
    scan = serving.ServingEngine(tflat, quantize=quantize, algo="scan",
                                 device="cpu")
    jscan = jserving.ServingEngine(jflat, quantize=quantize, algo="scan")
    bfs = serving.ServingEngine(tflat, quantize=quantize, device="cpu")
    got = scan.scores(x)
    np.testing.assert_array_equal(got, jscan.scores(x))
    np.testing.assert_array_equal(got, bfs.scores(x))
    leaves = scan.leaf_indices(x)
    assert leaves.dtype == np.int32
    np.testing.assert_array_equal(leaves, jscan.leaf_indices(x))
    np.testing.assert_array_equal(leaves, bfs.leaf_indices(x))


def test_scan_int8_reads_the_dequantized_table(models):
    """Under int8 the scan engine's one leaf table is the dequantized
    float32 one, never full precision: its scores are the int8 bfs
    engine's, not the float32 engine's."""
    path, x = models["regression"]
    _, tflat = _flats(path)
    eng = serving.ServingEngine(tflat, quantize="int8", algo="scan",
                                device="cpu")
    (tables,) = eng._device_tables()
    assert set(tables) == {"sf", "tr", "lc", "rc", "root", "lv"}
    np.testing.assert_array_equal(tables["lv"].numpy(),
                                  tflat.dequantized_leaf_value())
    got = eng.scores(x)
    assert not np.array_equal(got, serving.ServingEngine(
        tflat, algo="scan", device="cpu").scores(x))


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_ensemble_scores_equal_jax_function(models, objective):
    """``ops.scoring.ensemble_scores`` / ``ensemble_leaf_indices`` against
    the JAX package's jitted functions on the same rank codes and
    tables."""
    path, x = models[objective]
    _, f = _flats(path)
    codes = f.encode(x)
    want = np.asarray(jscoring.ensemble_scores(
        codes, f.split_feature, f.threshold_rank, f.left_child,
        f.right_child, f.leaf_value, f.num_leaves, f.tree_class,
        max_nodes=f.max_nodes, num_class=f.num_class))
    got = scoring.ensemble_scores(
        torch.from_numpy(codes), f.split_feature, f.threshold_rank,
        f.left_child, f.right_child, torch.from_numpy(f.leaf_value),
        f.num_leaves, f.tree_class, num_class=f.num_class)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jscoring.ensemble_leaf_indices(
        codes, f.split_feature, f.threshold_rank, f.left_child,
        f.right_child, f.num_leaves, max_nodes=f.max_nodes))
    got = scoring.ensemble_leaf_indices(
        torch.from_numpy(codes), f.split_feature, f.threshold_rank,
        f.left_child, f.right_child, f.num_leaves)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scan_cannot_shard(models):
    """``algo="scan"`` with ``shards > 1`` is the JAX engine's
    ValueError, by its text."""
    path, _ = models["binary"]
    jflat, tflat = _flats(path)
    with pytest.raises(ValueError) as want:
        jserving.ServingEngine(jflat, algo="scan", shards=2)
    with pytest.raises(ValueError) as got:
        serving.ServingEngine(tflat, algo="scan", shards=2, device="cpu")
    assert str(got.value) == str(want.value)


def test_scan_bucket_ladder_and_warmup(models):
    """The replay goes through the bucket ladder as the walk does: a
    small ladder (chunks and padding) gives the default ladder's scores,
    and warmup runs every bucket."""
    path, x = models["multiclass"]
    _, tflat = _flats(path)
    eng = serving.ServingEngine(tflat, algo="scan", buckets=(4, 64),
                                device="cpu")
    assert eng.warmup() is eng
    np.testing.assert_array_equal(
        eng.scores(x[:203]),
        serving.ServingEngine(tflat, device="cpu").scores(x[:203]))
    assert eng.scores(x[:0]).shape == (3, 0)


def _write_tsv(path, x):
    np.savetxt(path, np.column_stack([np.zeros(len(x)), x]),
               delimiter="\t", fmt="%.17g")
    return str(path)


def test_predict_file_scan_streamed(models, tmp_path):
    """``Predictor(serving_options={"algo": "scan"})``: the streamed file
    (7-row chunks) byte-equal to the resident bfs file, one flatten."""
    path, x = models["lambdarank"]
    data = _write_tsv(tmp_path / "data.tsv", x)
    texts = []
    for algo, chunk_lines in (("bfs", 500_000), ("scan", 7)):
        before = serving.FLATTEN_COUNT
        pred = Predictor(GBDT.from_model_file(path, device="cpu"), True,
                         False, -1, serving_options={"algo": algo})
        out = str(tmp_path / ("%s.txt" % algo))
        pred.predict_file(data, out, False, chunk_lines=chunk_lines)
        assert serving.FLATTEN_COUNT == before + 1
        with open(out, "rb") as f:
            texts.append(f.read())
    assert texts[0] == texts[1] and len(texts[0].splitlines()) == len(x)


def test_cli_task_predict_scan(models, tmp_path):
    """``task=predict predict_algo=scan`` (``device_type=cpu``) writes the
    file of the default run, scores and int8 scores."""
    path, x = models["binary"]
    data = _write_tsv(tmp_path / "data.tsv", x)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    for extra in ([], ["predict_quantize=int8"]):
        outs = []
        for algo in ([], ["predict_algo=scan"]):
            out = str(tmp_path / ("out%d.txt" % len(algo)))
            subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                            "task=predict", "data=%s" % data,
                            "input_model=%s" % path, "output_result=%s" % out,
                            "device_type=cpu"] + extra + algo,
                           check=True, env=env, cwd=str(tmp_path),
                           capture_output=True, timeout=300)
            with open(out, "rb") as f:
                outs.append(f.read())
        assert outs[1] == outs[0], extra
        assert len(outs[1].splitlines()) == len(x)
