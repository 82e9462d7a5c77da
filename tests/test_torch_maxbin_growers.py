"""Every grower and histogram mode at ``max_bin=1023`` (16-bit bins),
through ``lightgbm_tpu_torch.train`` (device="cpu", the kernels' plain
versions) against the JAX package's GBDT driven iteration by iteration.

The grid: compacted, masked and depth-wise growers x float32, bfloat16,
int8 and int8 with stochastic rounding x the packed layout (a 5-value
column and a flag at 64 bins, four continuous columns at 1022) and the
uniform one; then bagging and GOSS once each.  The JAX package's
compacted grower keys on the low byte of a 16-bit bin (ROADMAP C3), so
the port's compacted grower is held against the JAX masked grower.

Tolerances (tests/test_torch_maxbin.py's header):
- binary, 2 iterations, float32, bfloat16 and int8: split features,
  children and leaf parents exact; thresholds exact or the same
  partition of the node's rows (runs of empty bins tie in the port's
  f64 bin sums, not in the JAX package's f32 ones); leaf values rtol
  1e-5 / atol 5e-7, in float32 rtol 1e-4 / atol 1e-5: from the second
  iteration on the JAX package sums a 1022-bin feature's bins in f32,
  and a leaf whose gradients cancel carries that to 2.7e-6 absolute,
  6.7e-5 relative (tests/test_torch_packing.py's budget at 254 bins, for
  the same reason);
- int8_sr: one regression iteration from per-row initial scores, so the
  rounding bits, keyed on each row's exact gradient bits, are the same
  in both packages (tests/test_torch_quant_modes.py); then as above;
- the port's packed and uniform boosters: model text byte-equal.
The bagged case is float32: from the second iteration on, int8 levels
depend on the gradients' last bits (XLA's f32 ``exp`` against the
port's float64 one), which can move a row across a rounding boundary
and flip a near-tie (ROADMAP C, known gaps; seen at 1022 bins under a
redrawn bag).
"""
import functools

import numpy as np
import pytest

from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.objectives import create_objective as jcreate

import lightgbm_tpu_torch as lgt
from tests.test_torch_maxbin import PARAMS, assert_models_alike, wide_table

POLICIES = {"leafcompact": {"leafwise_compact": "true"},
            "leafwise": {"leafwise_compact": "false"},
            "depthwise": {"grow_policy": "depthwise"}}
# the JAX grower each port policy is held against
ORACLE = {"leafcompact": "leafwise", "leafwise": "leafwise",
          "depthwise": "depthwise"}
MODES = {"float32": {"hist_dtype": "float32"},
         "bfloat16": {"hist_dtype": "bfloat16"},
         "int8": {"hist_dtype": "int8"},
         "int8_sr": {"hist_dtype": "int8", "quant_rounding": "stochastic",
                     "objective": "regression"}}


# leaf values: (rtol, atol)
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-5, 5e-7),
       "int8": (1e-5, 5e-7), "int8_sr": (1e-5, 5e-7)}


@functools.lru_cache(maxsize=None)
def _data(mode):
    """(features, labels, initial scores or None) of a mode's cases."""
    x, y = wide_table(3000, seed=31)
    if mode != "int8_sr":
        return x, y, None
    latent = x[:, 0] - 0.6 * x[:, 2] + 0.3 * x[:, 1] + 0.8 * x[:, 5]
    init = np.random.RandomState(9).randn(len(y)).astype(np.float32)
    return x, latent.astype(np.float32), init


def _params(policy, mode, mixed_bin, **extra):
    return dict(PARAMS, mixed_bin=mixed_bin, **POLICIES[policy],
                **MODES[mode], **extra)


@functools.lru_cache(maxsize=None)
def _jax(oracle, mode, mixed_bin, extra=()):
    x, y, init = _data(mode)
    cfg = JConfig()
    cfg.set(_params(oracle, mode, mixed_bin, **dict(extra)),
            require_data=False)
    ds = JDataset.from_arrays(x, y, max_bin=1023)
    ds.metadata.init_score = init
    j = JGBDT()
    j.init(cfg.boosting_config, ds,
           jcreate(cfg.objective_type, cfg.objective_config))
    for _ in range(1 if mode == "int8_sr" else 2):
        if j.train_one_iter(is_eval=False):
            break
    return j


def _port(policy, mode, mixed_bin, extra=()):
    x, y, init = _data(mode)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=1023)
    ds.metadata.init_score = init
    return lgt.train(dict(_params(policy, mode, mixed_bin, **dict(extra)),
                          num_iterations=1 if mode == "int8_sr" else 2),
                     ds, device="cpu")


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("policy", list(POLICIES))
def test_growers_match_jax_at_1023_bins(policy, mode):
    """Packed (two launches a pass, widths 64 and 1022) and uniform,
    each against the JAX package's booster in the same layout, and the
    port's two layouts against each other."""
    texts = {}
    for mixed_bin in ("true", "false"):
        t = _port(policy, mode, mixed_bin)
        assert (t._pack_spec is not None) == (mixed_bin == "true")
        if t._pack_spec is not None:
            assert t._pack_spec.widths == (64, 1022)
        assert t.bins_device.dtype.itemsize == 2
        j = _jax(ORACLE[policy], mode, mixed_bin)
        assert (j._pack_spec is not None) == (mixed_bin == "true")
        assert_models_alike(j.models, t.models, t.train_data.bins,
                            *TOL[mode])
        assert max(int(tr.threshold_bin.max()) for tr in t.models) > 255
        texts[mixed_bin] = t.model_to_string()
    assert texts["true"] == texts["false"]


@pytest.mark.parametrize("policy,mode,extra", [
    ("depthwise", "float32", (("bagging_fraction", "0.7"),
                              ("bagging_freq", "1"),
                              ("feature_fraction", "0.8"))),
    ("leafwise", "float32", (("goss", "true"), ("top_rate", "0.3"),
                             ("other_rate", "0.2")))],
    ids=["bagged-depthwise-float32", "goss-masked-float32"])
def test_sampled_growers_match_jax_at_1023_bins(policy, mode, extra):
    """Bagging (the numpy draw in both) with feature_fraction, and GOSS,
    packed: each tree over the same rows and features as the JAX
    package's."""
    t = _port(policy, mode, "true", extra)
    j = _jax(ORACLE[policy], mode, "true", extra)
    assert_models_alike(j.models, t.models, t.train_data.bins, *TOL[mode])
