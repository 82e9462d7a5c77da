"""lightgbm_tpu_torch.health against lightgbm_tpu.health, live.

- ``health_vector`` and ``quant_saturation_count`` give the JAX
  package's values bit for bit on the same numpy inputs, NaN and Inf
  injected into gradients, hessians and scores, quantized or not, [N]
  and [K, N].
- ``tree_health_counts`` and ``HealthMonitor`` (blocks, totals,
  divergence streaks, the warn / record / halt policies and the counters
  they mirror) are the JAX package's on the same sequence of inputs.
- ``on_anomaly=halt`` stops training with ``TrainingHealthError`` at the
  JAX package's iteration: NaN labels (NaN gradients at once), and eval
  divergence over ``health_divergence_rounds`` on a validation set.
- Health on changes no tree; the one host read a iteration is the
  stacked vector.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu import health as jhealth
from lightgbm_tpu import telemetry as jtelemetry
from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.metrics import create_metric as jmetric
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.objectives import create_objective as jobjective
from lightgbm_tpu.ops.hist_pallas import \
    quant_saturation_count as jquant_saturation_count

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import health, lifecycle, telemetry
from lightgbm_tpu_torch.ops.hist_cuda import quant_saturation_count
from lightgbm_tpu_torch.utils import log


@pytest.fixture(autouse=True)
def no_leaks():
    yield
    left = lifecycle.leaks()
    for _, _, closer in left:
        closer()
    assert not left, [(k, n) for k, n, _ in left]


def _arrays(seed, shape, bad):
    rng = np.random.RandomState(seed)
    grad = (rng.randn(*shape) * 0.3).astype(np.float32)
    hess = (rng.rand(*shape) * 0.25).astype(np.float32)
    score = (rng.randn(*shape) * 2).astype(np.float32)
    if bad:
        flat = [a.reshape(-1) for a in (grad, hess, score)]
        for a, k in zip(flat, (3, 5, 7)):
            a[rng.choice(a.size, k, replace=False)] = np.nan
            a[rng.choice(a.size, k + 1, replace=False)] = np.inf
            a[rng.choice(a.size, 2, replace=False)] = -np.inf
        # a tied maximum, so the saturation threshold has several rows
        grad.reshape(-1)[:4] = 9.0
    return grad, hess, score


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("bad", [False, True])
@pytest.mark.parametrize("shape", [(1000,), (3, 700)])
def test_health_vector_matches_jax_bitwise(shape, bad, quantized):
    grad, hess, score = _arrays(len(shape) * 10 + bad, shape, bad)
    got = health.health_vector(torch.from_numpy(grad), torch.from_numpy(hess),
                               torch.from_numpy(score),
                               quantized=quantized).numpy()
    want = np.asarray(jhealth.health_vector(grad, hess, score,
                                            quantized=quantized))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if bad:
        assert got[0] == np.isnan(grad).sum() and got[5] == \
            np.isinf(score).sum()


@pytest.mark.parametrize("seed", range(4))
def test_quant_saturation_count_matches_jax_bitwise(seed):
    grad, hess, _ = _arrays(seed, (5000,), seed % 2 == 1)
    if seed == 2:
        hess[:] = 0.25                 # iteration 0's uniform hessians
    got = quant_saturation_count(torch.from_numpy(grad),
                                 torch.from_numpy(hess)).numpy()
    want = np.asarray(jquant_saturation_count(grad, hess))
    np.testing.assert_array_equal(got, want)
    if seed == 2:
        assert got >= 5000


def test_tree_health_counts_match_jax():
    rng = np.random.RandomState(0)
    for n in (1, 2, 7, 31):
        gain = rng.randn(max(n - 1, 1)).astype(np.float32)
        count = rng.randint(0, 3, n).astype(np.int32)
        assert health.tree_health_counts(n, gain, count) == \
            jhealth.tree_health_counts(n, gain, count)


@pytest.mark.parametrize("policy", ["warn", "record", "halt"])
def test_monitor_matches_jax(policy):
    """The same vectors, trees and metric values through both monitors:
    the same blocks, totals, summaries, counters and halt iteration."""
    telemetry.enable()
    telemetry.reset()
    jtelemetry.enable()
    jtelemetry.reset()
    try:
        mons = [health.HealthMonitor(policy, 2, True),
                jhealth.HealthMonitor(policy, 2, True)]
        rng = np.random.RandomState(1)
        halted = [None, None]
        for it in range(1, 7):
            vec = rng.rand(8).astype(np.float32) * 3
            vec[:6] = np.floor(vec[:6]) * (it >= 4)
            gain = rng.randn(6).astype(np.float32)
            count = rng.randint(0, 4, 7)
            value = [0.5, 0.4, 0.45, 0.5, 0.6, 0.3][it - 1]
            blocks = []
            for k, mon in enumerate(mons):
                if halted[k] is not None:
                    continue
                mon.add_tree(7, gain, count)
                mon.observe_eval("valid_1/l2", value, False)
                block = mon.assemble(vec)
                blocks.append(block)
                try:
                    mon.apply_policy(block, it)
                except (log.LightGBMError,
                        jhealth.TrainingHealthError) as e:
                    halted[k] = (it, type(e).__name__, str(e))
            if len(blocks) == 2:
                assert blocks[0] == blocks[1]
        assert halted[0] == (halted[1][0], "TrainingHealthError",
                             halted[1][2]) if policy == "halt" else \
            halted == [None, None]
        assert mons[0].summary() == mons[1].summary()
        assert telemetry.counters() == jtelemetry.counters()
    finally:
        telemetry.disable()
        telemetry.reset()
        jtelemetry.disable()
        jtelemetry.reset()


def test_resolve_enabled_follows_telemetry():
    assert health.resolve_enabled("true") and \
        not health.resolve_enabled("false")
    assert not health.resolve_enabled("auto")
    telemetry.enable()
    try:
        assert health.resolve_enabled("auto")
    finally:
        telemetry.disable()


def _jax_train(params, x, y, xv=None, yv=None, iters=10):
    cfg = JConfig()
    cfg.set({k: str(v) for k, v in params.items()}, require_data=False)
    ds = JDataset.from_arrays(x, y, max_bin=63)
    booster = JGBDT()
    metrics = [jmetric(t, cfg.metric_config) for t in cfg.metric_types]
    booster.init(cfg.boosting_config, ds,
                 jobjective(cfg.objective_type, cfg.objective_config), [])
    if xv is not None:
        booster.add_valid_dataset(JDataset.from_arrays(xv, yv, reference=ds),
                                  metrics, name="valid_1")
    it = 0
    try:
        for it in range(1, iters + 1):
            if booster.train_one_iter(is_eval=xv is not None):
                break
    except jhealth.TrainingHealthError as e:
        return it, str(e)
    return None, None


def _port_train(params, x, y, xv=None, yv=None, iters=10):
    ds = lgt.Dataset.from_arrays(x, y, max_bin=63)
    valid = [] if xv is None else [lgt.Dataset.from_arrays(xv, yv,
                                                           reference=ds)]
    seen = []
    try:
        lgt.train(dict(params, num_iterations=iters), ds, valid_sets=valid,
                  device="cpu", progress_fn=seen.append)
    except health.TrainingHealthError as e:
        return len(seen) + 1, str(e)
    return None, None


def test_halt_on_nan_labels_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(1500, 5)
    y = (x[:, 0] + 0.1 * rng.randn(1500)).astype(np.float32)
    y[17] = np.nan
    params = {"objective": "regression", "num_leaves": 7,
              "health": "true", "on_anomaly": "halt", "verbose": -1}
    got = _port_train(params, x, y)
    want = _jax_train(params, x, y)
    assert got[0] == want[0] == 1
    assert "grad_nan=" in got[1] and got[1] == want[1]


def test_halt_on_eval_divergence_matches_jax():
    """A learning rate that overshoots: the validation l2 worsens for
    ``health_divergence_rounds`` iterations in a row at the same
    iteration in both packages."""
    rng = np.random.RandomState(4)
    x = rng.randn(2000, 5)
    y = (x[:, 0] * 2 + rng.randn(2000)).astype(np.float32)
    params = {"objective": "regression", "num_leaves": 15,
              "learning_rate": 2.5, "metric": "l2", "health": "true",
              "on_anomaly": "halt", "health_divergence_rounds": 2,
              "verbose": -1}
    got = _port_train(params, x[:1500], y[:1500], x[1500:], y[1500:])
    want = _jax_train(params, x[:1500], y[:1500], x[1500:], y[1500:])
    assert got[0] is not None and got[0] == want[0]
    assert "eval divergence" in got[1]


def test_health_changes_no_tree():
    rng = np.random.RandomState(8)
    x = rng.randn(2000, 6)
    y = (x[:, 0] - x[:, 2] > 0).astype(np.float32)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=63)
    for extra in ({}, {"hist_dtype": "int8"},
                  {"grow_policy": "depthwise", "hist_dtype": "int8"}):
        p = dict({"objective": "binary", "num_leaves": 15,
                  "num_iterations": 4, "verbose": -1}, **extra)
        off = lgt.train(dict(p, health="false"), ds, device="cpu")
        on = lgt.train(dict(p, health="true"), ds, device="cpu")
        assert on.model_to_string() == off.model_to_string()
        assert off.health_summary() is None
        summary = on.health_summary()
        assert summary["anomalous_iterations"] == 0
        assert (summary["quant_sat"] > 0) == ("hist_dtype" in extra)
