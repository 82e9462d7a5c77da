"""The ``pipeline`` key, ``flush_pipeline`` and ``train_chunk``:
lightgbm_tpu_torch (device="cpu") against the JAX package run live.

The JAX package's ``pipeline=readback`` defers each iteration's model
readback by one iteration and moves only host waits: its trees, scores
and metric values are the synchronous loop's (lightgbm_tpu/config.py:
726-738), and an early stop found one call late is rolled back.  The
port keeps the key's check, message and resolution rule
(``GBDT.pipeline_on``, lightgbm_tpu/models/gbdt.py:684-699) and runs the
loop synchronously at every value.  ``train_chunk`` runs ``k`` (or
``min(k, limit)``) iterations as the JAX chunk program does, through
``train_one_iter``.

Tolerances: within one package, model text and metric lines exact
(each value against ``off``); port against JAX, structure exact, leaf
values rtol 1e-5 / atol F32_ATOL (tests/test_torch_parallel.py's float32
budget: leaves whose gradient sums cancel part by a few 1e-6 between the
packages' f32 sums), metric values rtol 1e-5 on the same iterations.
"""
import re
import types

import numpy as np
import pytest

import lightgbm_tpu as jl
from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.objectives import create_objective as jcreate
from lightgbm_tpu.utils.log import LightGBMError as JError

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.utils import log

from test_torch_parallel import F32_ATOL, assert_alike

METRIC_LINE = re.compile(r"Iteration:(\d+), (.+?) : (.*)$")
BASE = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.3,
        "min_data_in_leaf": 20, "max_bin": 63, "num_iterations": 6,
        "metric": "auc,binary_logloss", "leafwise_compact": "false"}
RUNS = {"plain": {},
        # stops at iteration 9 of 30 and pops the last 2 iterations' trees
        "early_stop": {"num_iterations": 30, "early_stopping_round": 2}}
VALUES = ("auto", "off", "readback")


def _table(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6)
    y = ((x[:, 0] - 0.6 * x[:, 1] + 0.4 * rng.randn(n)) > 0).astype(
        np.float32)
    return x, y


@pytest.fixture(scope="module")
def data():
    (x, y), (xv, yv) = _table(3000, 5), _table(800, 6)
    j = JDataset.from_arrays(x, y, max_bin=63)
    t = lgt.Dataset.from_arrays(x, y, max_bin=63)
    return {"j": (j, JDataset.from_arrays(xv, yv, reference=j)),
            "t": (t, lgt.Dataset.from_arrays(xv, yv, reference=t))}


def _metric_lines(text):
    return [m.groups() for m in map(METRIC_LINE.search, text.splitlines())
            if m]


def _train(capsys, package, params, data):
    """(model text, metric lines, booster) of one ``train`` call."""
    capsys.readouterr()
    if package == "t":
        b = lgt.train(params, data["t"][0], [data["t"][1]], device="cpu")
    else:
        b = jl.train(params, data["j"][0], [data["j"][1]])
    lines = _metric_lines(capsys.readouterr().out)
    text = (b.model_to_string() if package == "t" else
            "\n".join(tree.to_string() for tree in b.models))
    return text, lines, b


@pytest.fixture(scope="module")
def runs(data):
    """Every (package, run, value): its model text, metric lines and
    booster."""
    capsys = _Capture()
    out = {}
    for package in ("t", "j"):
        for run, extra in RUNS.items():
            for value in VALUES:
                out[package, run, value] = _train(
                    capsys, package, dict(BASE, **extra, pipeline=value),
                    data)
    capsys.close()
    return out


class _Capture:
    """capsys for a module fixture: stdout into a buffer."""

    def __init__(self):
        import io
        import sys
        self._sys, self._buf = sys, io.StringIO()
        self._old, sys.stdout = sys.stdout, self._buf

    def readouterr(self):
        out = self._buf.getvalue()
        self._buf.seek(0)
        self._buf.truncate()
        return types.SimpleNamespace(out=out)

    def close(self):
        self._sys.stdout = self._old


def _assert_lines_close(got, want):
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g[2]), float(w[2]), rtol=1e-5,
                                   err_msg="%s %s" % g[:2])


@pytest.mark.parametrize("value", VALUES)
@pytest.mark.parametrize("run", sorted(RUNS))
def test_each_value_trains_off_and_jax(runs, run, value):
    text, lines, _ = runs["t", run, value]
    off_text, off_lines, _ = runs["t", run, "off"]
    assert text == off_text and lines == off_lines
    jtext, jlines, jb = runs["j", run, value]
    assert jtext == runs["j", run, "off"][0]
    assert_alike(text, jb, atol=F32_ATOL)
    _assert_lines_close(lines, jlines)
    if run == "early_stop":
        # the early-stopping window is popped from the model in both
        assert len(jb.models) == len(runs["t", run, value][2].models) < 30
        assert lines and int(lines[-1][0]) > len(jb.models)


@pytest.mark.parametrize("value", VALUES)
def test_invalid_and_valid_values_as_jax(value):
    for bad in ("sometimes", "on", ""):
        with pytest.raises(log.Fatal) as tf:
            lgt.OverallConfig().set({"objective": "binary",
                                     "pipeline": bad}, require_data=False)
        with pytest.raises(JError) as jf:
            JConfig().set({"objective": "binary", "pipeline": bad},
                          require_data=False)
        assert str(tf.value) == str(jf.value) == \
            "pipeline must be auto, off or readback"
    cfg = lgt.OverallConfig()
    cfg.set({"objective": "binary", "pipeline": value.upper()},
            require_data=False)
    assert cfg.boosting_config.pipeline == value


def _boosters(data, params):
    """A port booster and a JAX booster, initialized, no tree grown."""
    cfg = JConfig()
    cfg.set({k: str(v) for k, v in params.items()}, require_data=False)
    j = JGBDT()
    j.init(cfg.boosting_config, data["j"][0],
           jcreate(cfg.objective_type, cfg.objective_config))
    t = lgt.train(dict(params, num_iterations=0), data["t"][0],
                  device="cpu")
    assert not t.models
    return t, j


@pytest.mark.parametrize("value", VALUES)
@pytest.mark.parametrize("auto", [False, True])
def test_resolution_rule_is_jax(data, monkeypatch, value, auto):
    """``pipeline_on`` against the JAX ``_pipeline_on`` for each value,
    inside run_training without a save_fn (``auto``) or not; a world of
    more than one rank is off whatever the value."""
    monkeypatch.delenv("LGBM_TPU_PIPELINE", raising=False)
    t, j = _boosters(data, dict(BASE, pipeline=value))
    t._pipeline_auto = j._pipeline_auto = auto
    assert t.pipeline_on() == j._pipeline_on() == (
        value == "readback" or (value == "auto" and auto))
    t._learner = types.SimpleNamespace(world=2)
    assert not t.pipeline_on()


def test_run_training_logs_the_resolution_once(data, capsys):
    """``train`` (no save_fn) resolves auto on, the CLI's incremental
    save keeps it off; one info line a run; nothing left to flush."""
    b = lgt.train(dict(BASE, num_iterations=2), data["t"][0], device="cpu")
    out = capsys.readouterr().out
    assert out.count("pipeline=auto resolves on") == 1
    assert b.flush_pipeline() is False
    b.run_training(1, False, save_fn=lambda: None)
    assert "pipeline=auto resolves off" in capsys.readouterr().out
    assert len(b.models) == 3


@pytest.mark.parametrize("args", [(3,), (3, 2), (2, 5), (3, 0)])
def test_train_chunk_as_jax(data, args):
    t, j = _boosters(data, BASE)
    assert t.chunk_supported(False) and j.chunk_supported(False)
    assert t.train_chunk(*args) is j.train_chunk(*args) is False
    n = args[0] if len(args) == 1 else min(args)
    assert len(t.models) == len(j.models) == n == t.iter == j.iter
    if n:
        assert_alike(t.model_to_string(), j, atol=F32_ATOL)
    # k train_one_iter calls: the same text
    one = lgt.train(dict(BASE, num_iterations=0), data["t"][0],
                    device="cpu")
    for _ in range(n):
        one.train_one_iter(is_eval=False)
    assert one.model_to_string() == t.model_to_string()


def test_train_chunk_early_stop_as_jax(data, capsys):
    """A chunk with evaluation stops where the JAX chunk stops, returns
    True, and pops the early-stopping window."""
    params = dict(BASE, early_stopping_round=2)
    t, j = _boosters(data, params)
    for b, v in ((t, data["t"][1]), (j, data["j"][1])):
        cfg = (lgt.OverallConfig() if b is t else JConfig())
        cfg.set({k: str(x) for k, x in params.items()}, require_data=False)
        if b is t:
            from lightgbm_tpu_torch.metrics import create_metrics
            metrics = create_metrics(cfg)
        else:
            from lightgbm_tpu.metrics import create_metric
            metrics = [m for m in (create_metric(k, cfg.metric_config)
                                   for k in cfg.metric_types) if m]
        b.add_valid_dataset(v, metrics, name="valid_1")
    capsys.readouterr()
    assert t.train_chunk(30, is_eval=True) is True
    tlines = _metric_lines(capsys.readouterr().out)
    assert j.train_chunk(30, is_eval=True) is True
    jlines = _metric_lines(capsys.readouterr().out)
    assert t.iter == j.iter and len(t.models) == len(j.models) < 30
    assert_alike(t.model_to_string(), j, atol=F32_ATOL)
    _assert_lines_close(tlines, jlines)


def test_train_chunk_refusal_is_jax(data):
    """The one refusal left: a booster without an objective, the JAX
    RuntimeError word for word."""
    cfg = JConfig()
    cfg.set({"objective": "binary"}, require_data=False)
    j = JGBDT()
    j.init(cfg.boosting_config, data["j"][0], None)
    t = lgt.train(dict(BASE, num_iterations=0), data["t"][0], device="cpu")
    objective, t.objective = t.objective, None
    assert t.chunk_supported(True) is j.chunk_supported(True) is False
    with pytest.raises(RuntimeError) as je:
        j.train_chunk(2)
    with pytest.raises(RuntimeError) as te:
        t.train_chunk(2)
    assert str(te.value) == str(je.value)
    assert t.chunk_supported(False) is False
    t.objective = objective
    assert t.chunk_supported(False)
