"""Tree-axis sharded serving: lightgbm_tpu_torch.serving with ``shards >
1`` (device="cpu") against lightgbm_tpu.serving's tree-sharded engine,
run live on the 8 virtual CPU devices tests/conftest.py forces.

A shard of the port is a contiguous tree block whose tables live on one
torch device; on the CPU every shard sits on the one CPU device torch
has.  Shard s holds trees [s·Tb, min((s+1)·Tb, T)), Tb = ceil(T /
shards): the JAX engine's blocks without their pad rows.

Tolerances: none.  The partial sums are carried from shard to shard in
tree order, the one-device add sequence, so the scores are bitwise the
one-device engine's and the JAX engine's at every shard count, float32
and int8; leaf indices and result files are equal.

Sizes: 500 rows, 6 features, 15 leaves, at most 8 iterations (a 5-tree
model gives an empty shard at 4 shards).
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu import serving as jserving
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.parallel import mesh as jmesh
from lightgbm_tpu.utils.log import LightGBMError as JFatal

from lightgbm_tpu_torch import lifecycle, serving, telemetry
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.models.predictor import Predictor
from lightgbm_tpu_torch.parallel import mesh
from lightgbm_tpu_torch.utils import log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJECTIVES = ("regression", "binary", "lambdarank", "multiclass")
BASE = {"num_leaves": 15, "min_data_in_leaf": 20,
        "min_sum_hessian_in_leaf": 1.0, "num_iterations": 8,
        "learning_rate": 0.2}
SHARDS = (2, 3, 4)


@pytest.fixture(autouse=True)
def no_leaked_threads():
    """Every front a test starts is closed by its end."""
    yield
    leaked = lifecycle.leaks()
    for _kind, _name, closer in leaked:
        closer()
    assert not leaked, "left live: %s" % [(k, n) for k, n, _ in leaked]


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
    """{name: (model file, rows)}: a JAX booster per objective
    (multiclass K = 3, 4 iterations) and a 5-tree binary one, saved."""
    out = {}
    d = tmp_path_factory.mktemp("sharded_models")
    for name in OBJECTIVES + ("five",):
        objective = "binary" if name == "five" else name
        rng = np.random.RandomState(3)
        x = rng.randn(500, 6)
        params = dict(BASE, objective=objective)
        kwargs = {}
        if objective == "lambdarank":
            kwargs["query_boundaries"] = np.arange(0, 501, 50)
        if objective == "multiclass":
            params.update(num_class=3, num_iterations=4)
        if name == "five":
            params["num_iterations"] = 5
        booster = jlgb.train(params, JDataset.from_arrays(
            x, _labels(objective, x, rng), max_bin=64, **kwargs))
        path = str(d / ("%s.txt" % name))
        booster.save_model_to_file(True, path)
        out[name] = (path, x)
    return out


def _flats(path):
    """(JAX FlatEnsemble, port FlatEnsemble) of one model file."""
    return (JGBDT.from_model_file(path).export_flat(),
            GBDT.from_model_file(path, device="cpu").export_flat())


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("quantize", ["float32", "int8"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_sharded_scores_bitwise(models, objective, quantize, shards):
    """Scores at every shard count are bitwise the port's one-device
    engine's and the JAX engine's ``shards=k``; leaf indices equal."""
    path, x = models[objective]
    jflat, tflat = _flats(path)
    eng = serving.ServingEngine(tflat, quantize=quantize, shards=shards,
                                device="cpu")
    jeng = jserving.ServingEngine(jflat, quantize=quantize, shards=shards)
    got = eng.scores(x)
    np.testing.assert_array_equal(got, jeng.scores(x))
    np.testing.assert_array_equal(got, serving.ServingEngine(
        tflat, quantize=quantize, device="cpu").scores(x))
    if quantize == "float32":
        leaves = eng.leaf_indices(x)
        assert leaves.shape == (len(x), tflat.num_trees)
        np.testing.assert_array_equal(leaves, jeng.leaf_indices(x))


@pytest.mark.parametrize("quantize", ["float32", "int8"])
def test_empty_shard(models, quantize):
    """5 trees at 4 shards: blocks of 2, 2, 1 and 0 trees.  The empty
    shard passes the total on; scores bitwise the JAX engine's (whose
    last shard holds only pad rows) and the one-device engine's, over
    ties and NaN too; leaf indices equal."""
    path, x = models["five"]
    jflat, tflat = _flats(path)
    x = x.copy()
    f = tflat.used[0]
    x[::5, f] = tflat.thresholds[f][0]
    x[1::7, f] = np.nan
    eng = serving.ServingEngine(tflat, quantize=quantize, shards=4,
                                device="cpu")
    assert eng.tree_blocks == [(0, 2), (2, 4), (4, 5), (5, 5)]
    jeng = jserving.ServingEngine(jflat, quantize=quantize, shards=4)
    got = eng.scores(x)
    np.testing.assert_array_equal(got, jeng.scores(x))
    np.testing.assert_array_equal(got, serving.ServingEngine(
        tflat, quantize=quantize, device="cpu").scores(x))
    np.testing.assert_array_equal(eng.leaf_indices(x), jeng.leaf_indices(x))
    assert eng.warmup() is eng


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("quantize", ["float32", "int8"])
def test_shard_tables_match_jax_shards(models, quantize, shards):
    """Shard s's node tables lie on ``serving_devices(...)[s]`` and equal
    the JAX engine's ``addressable_shards[s]`` with its pad rows
    stripped."""
    path, x = models["multiclass"]
    jflat, tflat = _flats(path)
    eng = serving.ServingEngine(tflat, quantize=quantize, shards=shards,
                                device="cpu")
    jeng = jserving.ServingEngine(jflat, quantize=quantize, shards=shards)
    eng.scores(x[:8])
    jeng.scores(x[:8])
    tables, jtables = eng._device_tables(), jeng._device_tables()
    devices = mesh.serving_devices(shards, "cpu")
    assert eng.devices == devices and len(tables) == shards
    keys = ("sf", "tr", "lc", "rc", "root") + (
        ("lv_q", "lv_scale") if quantize == "int8" else ("lv",))
    for key in keys:
        blocks = sorted(jtables[key].addressable_shards,
                        key=lambda sh: sh.index[0].start or 0)
        assert len(blocks) == shards
        for s, ((a, b), t) in enumerate(zip(eng.tree_blocks, tables)):
            assert t[key].device == devices[s]
            want = np.asarray(blocks[s].data)[:b - a]
            assert t[key].numpy().dtype == want.dtype, key
            np.testing.assert_array_equal(t[key].numpy(), want,
                                          err_msg="%s shard %d" % (key, s))
    assert sum(t["sf"].shape[0] for t in tables) == tflat.num_trees


def test_serving_devices_rule(monkeypatch):
    """One device per shard: CPU copies; a device list as given (its
    length checked); consecutive cards from the named index, and the JAX
    package's message when they pass the device count (checked with the
    count patched, against the JAX mesh's own text at its 8 virtual
    devices)."""
    cpu = torch.device("cpu")
    assert mesh.serving_devices(3, "cpu") == [cpu] * 3
    assert mesh.serving_devices(2, ["cpu", cpu]) == [cpu, cpu]
    assert mesh.TREE_AXIS == jmesh.TREE_AXIS
    with pytest.raises(ValueError, match="3 devices given for 2"):
        mesh.serving_devices(2, ["cpu"] * 3)
    with pytest.raises(log.Fatal, match="serve_shards must be >= 1"):
        mesh.serving_devices(0, "cpu")
    with pytest.raises(JFatal) as want:
        jmesh.get_serving_mesh(9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert mesh.serving_devices(3, "cuda") == [
        torch.device("cuda", i) for i in range(3)]
    assert mesh.serving_devices(2, "cuda:5") == [
        torch.device("cuda", 5), torch.device("cuda", 6)]
    with pytest.raises(log.Fatal) as got:
        mesh.serving_devices(9, "cuda")
    assert str(got.value) == str(want.value)
    with pytest.raises(log.Fatal, match="serve_shards=4 exceeds available "
                                        "devices \\(3\\)"):
        mesh.serving_devices(4, "cuda:5")


def test_engine_oversubscribed_fails_at_construction(models, monkeypatch):
    """The engine resolves its shards' devices when it is built: an
    over-subscribed count fails there, with the JAX message, before any
    table moves."""
    path, _ = models["binary"]
    jflat, tflat = _flats(path)
    with pytest.raises(JFatal) as want:
        jserving.ServingEngine(jflat, shards=9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(log.Fatal) as got:
        serving.ServingEngine(tflat, shards=9, device="cuda")
    assert str(got.value) == str(want.value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(log.Fatal, match="serve_shards=2 exceeds available "
                                        "devices \\(1\\)"):
        serving.ServingEngine(tflat, shards=2)


def test_device_list_places_shards(models):
    """A device list places the shards (several may share a device) and
    changes no score; with one shard it is the one-device engine."""
    path, x = models["regression"]
    _, tflat = _flats(path)
    base = serving.ServingEngine(tflat, device="cpu").scores(x)
    eng = serving.ServingEngine(tflat, shards=3, device=["cpu"] * 3)
    np.testing.assert_array_equal(eng.scores(x), base)
    one = serving.ServingEngine(tflat, device=["cpu"])
    assert one.shards == 1 and one.tree_blocks == [(0, tflat.num_trees)]
    np.testing.assert_array_equal(one.scores(x), base)
    with pytest.raises(ValueError, match="2 devices given for 3"):
        serving.ServingEngine(tflat, shards=3, device=["cpu"] * 2)


@pytest.mark.parametrize("shards", SHARDS)
def test_tree_carry_telemetry(models, shards):
    """``serve/tree_carry`` is filed ``shards - 1`` times a chunk, with
    C·N_bucket·4 bytes a call, in the predict phase; the one-device
    engine files none."""
    path, x = models["multiclass"]
    _, tflat = _flats(path)
    telemetry.enable()
    telemetry.reset()
    try:
        serving.ServingEngine(tflat, device="cpu").scores(x)
        assert telemetry.interconnect_snapshot() is None
        eng = serving.ServingEngine(tflat, buckets=(8, 64), shards=shards,
                                    device="cpu")
        eng.scores(x[:150])          # chunks of 64, 64 and 22 -> 64 rows
        site = telemetry.interconnect_snapshot()["sites"]["serve/tree_carry"]
        assert site["calls"] == 3 * (shards - 1)
        assert site["bytes_per_call"] == 3 * 64 * 4
        assert site["bytes"] == site["calls"] * 3 * 64 * 4
        assert (site["kind"], site["axis"], site["phase"]) == (
            "ppermute", "tree", "predict")
    finally:
        telemetry.disable()
        telemetry.reset()


def _write_tsv(path, x):
    np.savetxt(path, np.column_stack([np.zeros(len(x)), x]),
               delimiter="\t", fmt="%.17g")
    return str(path)


@pytest.mark.parametrize("quantize", ["float32", "int8"])
def test_predict_file_streamed_two_shards(models, quantize, tmp_path):
    """``Predictor(serving_options={"shards": 2})``: the streamed result
    file (7-row chunks) is byte-equal to the resident one and to the
    one-device engine's, with exactly one flatten each."""
    path, x = models["multiclass"]
    data = _write_tsv(tmp_path / "data.tsv", x)
    texts = {}
    for shards, chunk_lines in ((0, 500_000), (2, 500_000), (2, 7)):
        before = serving.FLATTEN_COUNT
        pred = Predictor(GBDT.from_model_file(path, device="cpu"), True,
                         False, -1, serving_options={
                             "shards": shards, "quantize": quantize})
        assert pred.engine.shards == max(shards, 1)
        out = str(tmp_path / ("out_%d_%d.txt" % (shards, chunk_lines)))
        pred.predict_file(data, out, False, chunk_lines=chunk_lines)
        assert serving.FLATTEN_COUNT == before + 1
        with open(out, "rb") as f:
            texts[(shards, chunk_lines)] = f.read()
    assert texts[(2, 7)] == texts[(2, 500_000)] == texts[(0, 500_000)]
    assert len(texts[(2, 7)].splitlines()) == len(x)


def test_cli_task_predict_serve_shards(models, tmp_path):
    """``task=predict serve_shards=2`` (``device_type=cpu``) writes the
    file the default run writes, scores and leaf indices."""
    path, x = models["multiclass"]
    data = _write_tsv(tmp_path / "data.tsv", x)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    for extra in ([], ["predict_leaf_index=true"]):
        outs = []
        for shards in ([], ["serve_shards=2"]):
            out = str(tmp_path / ("out%d.txt" % len(shards)))
            subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                            "task=predict", "data=%s" % data,
                            "input_model=%s" % path, "output_result=%s" % out,
                            "device_type=cpu"] + extra + shards,
                           check=True, env=env, cwd=str(tmp_path),
                           capture_output=True, timeout=300)
            with open(out, "rb") as f:
                outs.append(f.read())
        assert outs[1] == outs[0], extra
        assert len(outs[1].splitlines()) == len(x)


def test_front_hot_swap_between_sharded_engines(models):
    """A ServingFront over a 2-shard float32 engine, hot-swapped to a
    4-shard int8 one under 4 clients: no request lost, each equal to its
    rows scored on one of the two engines, and none back on float32
    after the swap returned."""
    path, x = models["binary"]
    _, tflat = _flats(path)
    f32 = serving.ServingEngine(tflat, shards=2, buckets=(1, 32, 1024),
                                device="cpu")
    i8 = serving.ServingEngine(tflat, shards=4, quantize="int8",
                               buckets=(1, 32, 1024), device="cpu")
    whole = {"float32": f32.scores(x), "int8": i8.scores(x)}
    front = serving.ServingFront(f32.warmup(), linger_us=500)
    logs = [[] for _ in range(4)]
    errors = []
    swapped = threading.Event()

    def client(i):
        r = np.random.RandomState(10 + i)
        try:
            for _ in range(30):
                n = r.randint(1, 17)
                s0 = r.randint(0, len(x) - n)
                after = swapped.is_set()
                logs[i].append((s0, n, after,
                                front.submit(x[s0:s0 + n]).result(60)))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(4)]
    try:
        for th in threads:
            th.start()
        while sum(len(lg) for lg in logs) < 40 and not errors:
            threading.Event().wait(0.005)
        front.swap_engine(i8, timeout=60)
        swapped.set()
        for th in threads:
            th.join(120)
    finally:
        front.close()
    assert not errors and not any(th.is_alive() for th in threads)
    reqs = [q for lg in logs for q in lg]
    assert len(reqs) == 120 == front.stats["requests"]
    assert front.stats["swaps"] == 1
    for s0, n, after, got in reqs:
        on = [k for k, v in whole.items()
              if np.array_equal(got, v[:, s0:s0 + n])]
        assert on, "a request matches neither engine"
        if after:
            assert "int8" in on
