"""The masked leaf-wise grower (``leafwise_compact=false``):
lightgbm_tpu_torch (device="cpu", the kernels' plain versions) vs the JAX
package's masked grower, and vs the port's own compacted grower.

Tolerances: against JAX, tests/test_torch_gbdt.py's
(``assert_grown_alike`` at the grower level; the GBDT level as that
file's module docstring says).  Masked against compacted in the port
(tests/test_leafcompact.py:171-193 pins the same in the JAX package):
bitwise in int8, leaf values included (both quantize the same rows and
subtract the same cells); in float32 structure exact and values rtol
1e-6 (the two histogram routes sum in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.models import grower as jmw

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.cli import main as cli_main
from lightgbm_tpu_torch.models.grower import grow_tree
from lightgbm_tpu_torch.models.grower_leafcompact import \
    grow_tree_leafcompact
from lightgbm_tpu_torch.models.grower_unified import grow_tree_unified
from tests import test_torch_gbdt as base

STRUCTURE = base.STRUCTURE + ("leaf_count",)


def _kw(B, **extra):
    return dict(dict(num_leaves=15, num_bins_max=B, min_data_in_leaf=20,
                     min_sum_hessian_in_leaf=1e-3), **extra)


@pytest.mark.parametrize("dtype,bagging,B", [
    pytest.param(d, g, b, id="%s-%s%s" % (d, g, "" if b == 32 else "-B256"))
    for b in (32, 256) for g in (False, True) for d in ("float32", "int8")])
def test_masked_grower_matches_jax(dtype, bagging, B):
    args, B = base._grower_case(11, bagging, B)
    j = jmw.grow_tree(*map(jnp.asarray, args),
                      compute_dtype="int8" if dtype == "int8" else jnp.float32,
                      **_kw(B))
    t = grow_tree(*map(torch.as_tensor, args), compute_dtype=dtype, **_kw(B))
    assert t.num_leaves > 8
    base.assert_grown_alike(t, j, dtype)


@pytest.mark.parametrize("dtype,bagging,B", [
    ("int8", False, 256), ("int8", True, 32), ("float32", True, 256)])
def test_masked_equals_compacted(dtype, bagging, B):
    """The two leaf-wise policies grow the same trees; in int8 bit for
    bit (tests/test_leafcompact.py:171-193 pins this in the JAX
    package)."""
    args, B = base._grower_case(7, bagging, B)
    a = grow_tree(*map(torch.as_tensor, args), compute_dtype=dtype,
                  **_kw(B, num_leaves=31))
    b = grow_tree_leafcompact(*map(torch.as_tensor, args),
                              compute_dtype=dtype, **_kw(B, num_leaves=31))
    assert a.num_leaves == b.num_leaves > 16
    for field in STRUCTURE + ("split_gain",) * (dtype == "int8"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)
    assert torch.equal(a.leaf_ids, b.leaf_ids)
    if dtype == "int8":
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
    else:
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_masked_max_depth(dtype):
    args, B = base._grower_case(3, False)
    kw = _kw(B, num_leaves=31, min_data_in_leaf=10, max_depth=3)
    j = jmw.grow_tree(*map(jnp.asarray, args),
                      compute_dtype="int8" if dtype == "int8" else jnp.float32,
                      **kw)
    t = grow_tree_unified(*map(torch.as_tensor, args), policy="leafwise",
                          compute_dtype=dtype, **kw)
    assert t.num_leaves == 4
    base.assert_grown_alike(t, j, dtype)


# ---------------------------------------------------------------- GBDT

MASKED = dict(base.PARAMS, grow_policy="leafwise", leafwise_compact="false")


@pytest.fixture(scope="module", params=["float32", "int8"])
def pair(request):
    return base.booster_pair(dict(MASKED, hist_dtype=request.param))


def test_masked_gbdt_trees_match_jax(pair):
    base.test_trees_match_jax(pair)


def test_masked_gbdt_scores_match_jax(pair):
    base.test_scores_match_jax(pair)


def test_masked_gbdt_model_text_loads_into_jax(pair, tmp_path):
    base.test_model_text_loads_into_jax(pair, tmp_path)


def test_masked_gbdt_jax_trees_carry_into_port(pair, tmp_path):
    base.test_jax_trees_carry_into_port(pair, tmp_path)


def test_masked_gbdt_trees_equal_compacted():
    """Through the boosting loop: leafwise_compact=false and =true train
    the same model in int8, text for text."""
    x, y = base._data()
    ds = lgt.Dataset.from_arrays(x, y, max_bin=32)
    params = dict(base.PARAMS, num_iterations=base.ITERS, hist_dtype="int8")
    masked = lgt.train(dict(params, leafwise_compact="false"), ds,
                       device="cpu")
    compact = lgt.train(dict(params, leafwise_compact="true"), ds,
                        device="cpu")
    assert masked.model_to_string() == compact.model_to_string()


def test_masked_cli_trains_from_conf(tmp_path):
    x, y = base._data()
    train = tmp_path / "train.tsv"
    np.savetxt(train, np.column_stack([y, x]), delimiter="\t", fmt="%.6g")
    model = tmp_path / "model.txt"
    conf = tmp_path / "train.conf"
    conf.write_text("task = train\nobjective = binary\nnum_trees = 3\n"
                    "num_leaves = 7\nleafwise_compact = false\n"
                    "leafwise_segments = 4\nmetric = auc\n"
                    "is_training_metric = true\n")
    assert cli_main(["config=%s" % conf, "data=%s" % train,
                     "output_model=%s" % model, "device=cpu"]) == 0
    masked = model.read_text()
    assert masked.startswith("gbdt\n") and masked.count("Tree=") == 3
    # key=value on the command line wins over the file: the compacted
    # grower, whose float32 trees have the same structure
    assert cli_main(["config=%s" % conf, "data=%s" % train,
                     "output_model=%s" % model, "leafwise_compact=true",
                     "device=cpu"]) == 0
    a = lgt.GBDT.from_model_file(str(model), device="cpu").models
    b = lgt.GBDT()
    b.models_from_string(masked)
    for ta, tb in zip(a, b.models):
        np.testing.assert_array_equal(ta.split_feature, tb.split_feature)
        np.testing.assert_array_equal(ta.threshold, tb.threshold)
        np.testing.assert_array_equal(ta.leaf_count, tb.leaf_count)
