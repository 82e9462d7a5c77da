"""The depth-wise grower: lightgbm_tpu_torch (device="cpu", the kernels'
plain versions) vs the JAX package's ``grow_policy=depthwise``.

Tolerances: tests/test_torch_gbdt.py's (``assert_grown_alike`` at the
grower level: structure, leaf counts and leaf ids exact, leaf values
rtol 1e-6 in float32 and rtol 1e-4 / atol 1e-7 in int8; the GBDT level
as that file's module docstring says).

Each int8 column group quantizes with its own scale.  The port groups a
level pass at 64 columns, as the JAX package's Pallas route does on the
TPU; its CPU route groups at 42.  Levels wider than 42 columns are
therefore compared against the JAX grower with its own histogram seam
(``grower_depthwise.histogram_leafbatch``) set to the 64-column grouping,
and the GBDT-level int8 comparison keeps ``num_leaves`` <= 128, whose
widest level pass has 32 columns.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.models import grower_depthwise as jdw
from lightgbm_tpu.ops import hist_pallas as jhp

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.cli import main as cli_main
from lightgbm_tpu_torch.models import grower_depthwise as tdw
from lightgbm_tpu_torch.models.grower_unified import grow_tree_unified
from lightgbm_tpu_torch.ops import histogram as thist
from lightgbm_tpu_torch.ops.scoring import (leaf_ids_by_replay,
                                            split_leaf_sequence)
from tests import test_torch_gbdt as base

_assert_trees = base.assert_grown_alike


def _jdtype(dtype):
    return "int8" if dtype == "int8" else jnp.float32


@pytest.mark.parametrize("dtype,bagging,B", [
    pytest.param(d, g, b, id="%s-%s%s" % (d, g, "" if b == 32 else "-B256"))
    for b in (32, 256) for g in (False, True) for d in ("float32", "int8")])
def test_depthwise_grower_matches_jax(dtype, bagging, B):
    args, B = base._grower_case(11, bagging, B)
    kw = dict(num_leaves=31, num_bins_max=B, min_data_in_leaf=20,
              min_sum_hessian_in_leaf=1e-3)
    j = jdw.grow_tree_depthwise_jit(*map(jnp.asarray, args),
                                    compute_dtype=_jdtype(dtype), **kw)
    t = tdw.grow_tree_depthwise(*map(torch.as_tensor, args),
                                compute_dtype=dtype, **kw)
    assert t.num_leaves > 16          # four full level passes
    _assert_trees(t, j, dtype)


def _wide_case(seed, B):
    """8,000 rows that keep splitting down to 3-row leaves, so 255 leaves
    reach a 64-column level pass and 300 leaves a 128-column one."""
    rng = np.random.RandomState(seed)
    N, F = 8000, 6
    x = rng.randn(N, F)
    bins = np.clip((x - x.min(0)) / (x.max(0) - x.min(0)) * (B - 1), 0,
                   B - 1).astype(np.uint8).T.copy()
    y = (x[:, 0] - x[:, 1] + 0.5 * np.sin(3 * x[:, 2])
         + 0.8 * rng.randn(N) > 0)
    pr = np.full(N, 0.5, np.float32)
    row_mask = rng.rand(N) > 0.1
    return (bins, (pr - y).astype(np.float32),
            (pr * (1 - pr)).astype(np.float32), row_mask, np.ones(F, bool),
            np.full(F, B, np.int32))


def _jax_hist_at_64(bins, grad, hess, col_id, col_ok, num_cols, B, **_):
    """The JAX CPU route's int8 histogram, grouped at 64 columns as the
    Pallas route groups (hist_pallas.py:369-371)."""
    return jhp._grouped(jhp._hist_quant_xla_one, bins, grad, hess, col_id,
                        col_ok, num_cols, B, group_width=64, chunk=65536,
                        rng_bits=None)


@pytest.mark.parametrize("dtype,num_leaves,widest", [
    ("int8", 255, 64), ("int8", 300, 128), ("float32", 300, 128)])
def test_depthwise_wide_levels_match_jax(monkeypatch, dtype, num_leaves,
                                         widest):
    """A 64-column level pass, and a 128-column one that runs as two
    64-column groups, bitwise in structure against the JAX grower."""
    args = _wide_case(3, 256)
    kw = dict(num_leaves=num_leaves, num_bins_max=256, min_data_in_leaf=3,
              min_sum_hessian_in_leaf=1e-3)
    if dtype == "int8":
        monkeypatch.setattr(jdw, "histogram_leafbatch", _jax_hist_at_64)
    # a fresh trace of the un-jitted grower, so the seam above is used
    j = jax.jit(functools.partial(jdw.grow_tree_depthwise,
                                  compute_dtype=_jdtype(dtype), **kw))(
        *map(jnp.asarray, args))
    levels, passes = [], []
    one = "_int8_one" if dtype == "int8" else "_float_one"
    real_one, real_level = getattr(thist, one), tdw.histogram_leafbatch

    def record_pass(*a):
        passes.append(a[5])
        return real_one(*a)

    def record_level(*a, **k):
        levels.append(a[5])
        return real_level(*a, **k)

    monkeypatch.setattr(thist, one, record_pass)
    monkeypatch.setattr(tdw, "histogram_leafbatch", record_level)
    t = tdw.grow_tree_depthwise(*map(torch.as_tensor, args),
                                compute_dtype=dtype, **kw)
    assert max(levels) == widest
    assert max(passes) == 64 and len(passes) == len(levels) + widest // 128
    assert levels == [1] + [1 << d for d in range(len(levels) - 1)]
    _assert_trees(t, j, dtype)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_depthwise_max_depth(dtype):
    """max_depth = 4 allows three split levels (num_levels), as the JAX
    grower reads it."""
    args, B = base._grower_case(3, False)
    kw = dict(num_leaves=31, num_bins_max=B, min_data_in_leaf=10,
              min_sum_hessian_in_leaf=1e-3, max_depth=4)
    assert tdw.num_levels(31, 4) == jdw.num_levels(31, 4) == 3
    assert [tdw.num_levels(n, d) for n, d in ((2, -1), (255, -1), (256, 3),
                                               (300, -1), (300, 2))] == \
        [jdw.num_levels(n, d) for n, d in ((2, -1), (255, -1), (256, 3),
                                            (300, -1), (300, 2))]
    j = jdw.grow_tree_depthwise_jit(*map(jnp.asarray, args),
                                    compute_dtype=_jdtype(dtype), **kw)
    t = grow_tree_unified(*map(torch.as_tensor, args), policy="depthwise",
                          compute_dtype=dtype, **kw)
    assert t.num_leaves == 8
    _assert_trees(t, j, dtype)


def test_depthwise_node_numbering():
    """Node k keeps its parent's leaf on the left and puts leaf k + 1 on
    the right; replaying the splits in node order lands every row in the
    leaf the grower gave it."""
    args, B = base._grower_case(5, True)
    t = tdw.grow_tree_depthwise(*map(torch.as_tensor, args), num_leaves=31,
                                num_bins_max=B, min_data_in_leaf=20,
                                min_sum_hessian_in_leaf=1e-3)
    n = t.num_leaves - 1
    lc, rc = t.left_child[:n], t.right_child[:n]
    split_leaf = split_leaf_sequence(lc, rc)
    for k in range(n):
        # the right child is leaf k + 1, or the node that split it later
        assert (~rc[k] == k + 1) if rc[k] < 0 else split_leaf[rc[k]] == k + 1
        # the left child is the parent's leaf, or the node that split it
        assert (~lc[k] == split_leaf[k]) if lc[k] < 0 \
            else split_leaf[lc[k]] == split_leaf[k]
    replay = leaf_ids_by_replay(torch.as_tensor(args[0]),
                                t.split_feature[:n], t.threshold_bin[:n],
                                lc, rc)
    np.testing.assert_array_equal(replay.numpy(), t.leaf_ids.numpy())


def test_unknown_policy_is_refused():
    args, B = base._grower_case(3, False)
    with pytest.raises(ValueError, match="levelwise"):
        grow_tree_unified(*map(torch.as_tensor, args), policy="levelwise",
                          num_leaves=4, num_bins_max=B, min_data_in_leaf=10,
                          min_sum_hessian_in_leaf=1e-3)


# ---------------------------------------------------------------- GBDT

# 15 leaves, as tests/test_torch_gbdt.py: deeper trees put leaves of a few
# rows beside the gradients' last-bit differences (XLA's f32 exp against
# the port's f64), which move such a leaf's value by more than atol and
# can move an int8 level by one step
DEPTHWISE = dict(base.PARAMS, grow_policy="depthwise")


@pytest.fixture(scope="module", params=["float32", "int8"])
def pair(request):
    return base.booster_pair(dict(DEPTHWISE, hist_dtype=request.param))


def test_depthwise_gbdt_trees_match_jax(pair):
    assert pair[2].models[0].num_leaves > 8
    base.test_trees_match_jax(pair)


def test_depthwise_gbdt_scores_match_jax(pair):
    base.test_scores_match_jax(pair)


def test_depthwise_gbdt_model_text_loads_into_jax(pair, tmp_path):
    base.test_model_text_loads_into_jax(pair, tmp_path)


def test_depthwise_gbdt_jax_trees_carry_into_port(pair, tmp_path):
    base.test_jax_trees_carry_into_port(pair, tmp_path)


def test_depthwise_cli_trains_from_conf(tmp_path):
    x, y = base._data()
    train = tmp_path / "train.tsv"
    np.savetxt(train, np.column_stack([y, x]), delimiter="\t", fmt="%.6g")
    model = tmp_path / "model.txt"
    conf = tmp_path / "train.conf"
    conf.write_text("task = train\nobjective = binary\nnum_trees = 3\n"
                    "num_leaves = 15\ngrow_policy = depthwise\n"
                    "hist_dtype = int8\nhist_chunk = 65536\n")
    assert cli_main(["config=%s" % conf, "data=%s" % train,
                     "output_model=%s" % model, "device=cpu"]) == 0
    booster = lgt.GBDT.from_model_file(str(model), device="cpu")
    assert len(booster.models) == 3
    # the same run through the Python entry point writes the same model
    same = lgt.train({"objective": "binary", "num_trees": 3,
                      "num_leaves": 15, "grow_policy": "depthwise",
                      "hist_dtype": "int8"},
                     lgt.Dataset.load_train(_io(train)), device="cpu")
    assert same.model_to_string() == model.read_text()


def _io(path):
    cfg = lgt.OverallConfig()
    cfg.set({"objective": "binary", "data": str(path)})
    return cfg.io_config
