"""The histogram's other numerics modes: ``quant_rounding=stochastic``
(``int8_sr``) and ``hist_dtype=bfloat16``, lightgbm_tpu_torch
(device="cpu", the kernels' plain versions) vs the JAX package.

Tolerances:
- ``stochastic_bits``, ``quantize_values`` (both roundings) and int8_sr
  histograms: bitwise;
- int8_sr trees at the grower level, from the same gradients: structure,
  leaf counts and leaf ids exact, leaf values as int8's in
  ``assert_grown_alike`` (tests/test_torch_gbdt.py; rtol 2e-4 for the
  255-leaf depth-wise tree's 3-row leaves).  The rounding bits
  are keyed on each row's exact (grad, hess) bit patterns, so a booster
  is compared over its first iteration only, where both packages'
  regression gradients ``score - label`` are bit-equal (the scores start
  from per-row initial scores, so the value pairs differ row by row);
  later iterations' scores differ in the last bit between the packages
  (tests/test_torch_gbdt.py) and re-key the bits;
- bfloat16: histograms rtol 1e-6 / atol 1e-5, counts exact; trees
  structure exact, leaf values rtol 1e-5 (grower level atol 1e-9, GBDT
  level atol 5e-7 and scores rtol 1e-5 / atol 2e-6, as
  tests/test_torch_gbdt.py): bf16 values carry 8 significant bits, so
  their f32 sums hardly depend on order.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.models import grower_depthwise as jdw
from lightgbm_tpu.ops import hist_pallas as jhp
from lightgbm_tpu.ops import histogram as jhist

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.models import grower_depthwise as tdw
from lightgbm_tpu_torch.models.grower_unified import grow_tree_unified
from lightgbm_tpu_torch.ops import hist_cuda
from lightgbm_tpu_torch.ops import histogram as thist
from lightgbm_tpu_torch.utils import log
from tests import test_torch_gbdt as base
from tests import test_torch_packing as pk

SALTS = (0, 1, 2, 7, 254, 0x51ED, 2 ** 31 - 1)


def _edge_values(seed, n=4000):
    """Gradients with +-0, subnormals, the pass maximum +-127 (scale 1
    exactly) and exact half-way ties of the nearest rounding."""
    rng = np.random.RandomState(seed)
    g = (rng.randn(n) * 20).astype(np.float32)
    h = (rng.rand(n) * 50).astype(np.float32)
    g[:12] = [0.0, -0.0, 1e-40, -1e-42, 127.0, -127.0, 2.5, -3.5, 0.5,
              -0.5, 126.5, -126.5]
    h[:6] = [0.0, 127.0, 1e-41, 63.5, 0.5, 126.5]
    g[12:] = np.clip(g[12:], -126.0, 126.0)
    h[6:] = np.clip(h[6:], 0.0, 126.0)
    ok = rng.rand(n) > 0.2
    ok[:12] = True
    return g, h, ok


@pytest.mark.parametrize("salt", SALTS)
def test_stochastic_bits_match_jax(salt):
    g, h, _ = _edge_values(1)
    for x, other in ((g, h), (h, g)):
        want = np.asarray(jhp.stochastic_bits(jnp.asarray(x),
                                              jnp.asarray(other), salt))
        got = hist_cuda.stochastic_bits(torch.as_tensor(x),
                                        torch.as_tensor(other), salt)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_mix32_matches_jax_over_uint32():
    """The 16-bit-half products give murmur3's finalizer exactly, at the
    ends of the uint32 range too."""
    x = np.concatenate([np.arange(0, 70000, 7, dtype=np.uint64),
                        np.array([2 ** 32 - 1, 2 ** 31, 0x85EBCA6B,
                                  0xC2B2AE35, 2 ** 32 - 0x9E3779B9],
                                 np.uint64),
                        np.random.RandomState(0).randint(
                            0, 2 ** 32, 5000, dtype=np.uint64)])
    want = np.asarray(jhp._mix32(jnp.asarray(x.astype(np.uint32))))
    got = hist_cuda._mix32(torch.as_tensor(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert [hist_cuda._mix32(int(v)) for v in x[-8:]] == \
        [int(v) for v in want[-8:]]


@pytest.mark.parametrize("stochastic,salt", [
    (False, 0), (True, 0), (True, 3), (True, 2 ** 31 - 1)])
def test_quantize_values_match_jax(stochastic, salt):
    g, h, ok = _edge_values(2)
    jv, js = jhp.quantize_values(jnp.asarray(g), jnp.asarray(h),
                                 jnp.asarray(ok), stochastic=stochastic,
                                 salt=salt)
    tv, ts = hist_cuda.quantize_values(torch.as_tensor(g), torch.as_tensor(h),
                                       torch.as_tensor(ok), stochastic, salt)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[0]) == 1.0                 # max |g| = 127: scale 1
    if stochastic:
        # the ties round both ways over rows; nearest takes the even one
        nearest, _ = hist_cuda.quantize_values(
            torch.as_tensor(g), torch.as_tensor(h), torch.as_tensor(ok))
        assert not torch.equal(nearest, tv)


def test_stochastic_rounding_is_unbiased():
    """floor(y + u) with u uniform in [0, 1): the mean level of many rows
    of one value is that value over the scale, not its rounding."""
    n = 200_000
    rng = np.random.RandomState(3)
    g = np.full(n, 0.3, np.float32) + rng.rand(n).astype(np.float32) * 1e-3
    g[0] = 127.0
    h = rng.rand(n).astype(np.float32)
    v, s = hist_cuda.quantize_values(torch.as_tensor(g), torch.as_tensor(h),
                                     torch.ones(n, dtype=torch.bool), True, 5)
    mean = float((v[0, 1:].double() * float(s[0])).mean())
    assert abs(mean - float(g[1:].mean())) < 3e-3
    assert set(v[0, 1:].tolist()) == {0, 1}


@pytest.mark.parametrize("dtype,packing", [
    ("int8_sr", False), ("int8_sr", True), ("bfloat16", False),
    ("bfloat16", True)])
@pytest.mark.parametrize("C", [1, 6, 33])
def test_leafbatch_matches_jax(dtype, packing, C):
    """int8_sr bitwise, salted, and bfloat16 against the JAX package's
    CPU route, uniform and packed."""
    spec, jspec = pk.plans() if packing else (None, None)
    bins, grad, hess, cid, ok = pk._hist_inputs(6, C)
    if packing:
        bins = np.ascontiguousarray(bins[np.asarray(spec.perm)])
    want = np.asarray(jhist.histogram_leafbatch(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(cid), jnp.asarray(ok), C, pk.B_WIDE,
        compute_dtype=pk.JAX_DTYPE[dtype], salt=11, packing=jspec))
    got = thist.histogram_leafbatch(
        torch.as_tensor(bins), torch.as_tensor(grad), torch.as_tensor(hess),
        torch.as_tensor(cid), torch.as_tensor(ok), C, pk.B_WIDE, dtype,
        packing=spec, salt=11).numpy()
    if dtype == "int8_sr":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(got[..., 2], want[..., 2])


def test_modes_differ_where_they_should():
    """bfloat16 is the float mode over bf16-rounded values; int8_sr
    differs from int8 and from itself under another salt."""
    bins, grad, hess, cid, ok = map(torch.as_tensor, pk._hist_inputs(8, 4))
    hist = lambda dtype, salt=0, g=grad, h=hess: thist.histogram_leafbatch(
        bins, g, h, cid, ok, 4, pk.B_WIDE, dtype, salt=salt)
    assert torch.equal(hist("bfloat16"),
                       hist("float32", g=thist.round_bf16(grad),
                            h=thist.round_bf16(hess)))
    assert not torch.equal(hist("bfloat16"), hist("float32"))
    assert not torch.equal(hist("int8_sr", 1), hist("int8"))
    assert not torch.equal(hist("int8_sr", 1), hist("int8_sr", 2))
    assert torch.equal(hist("int8_sr", 1)[..., 2], hist("int8")[..., 2])


# --------------------------------------------------------------- growers


@pytest.mark.parametrize("policy", ["leafcompact", "leafwise", "depthwise"])
@pytest.mark.parametrize("dtype", ["int8_sr", "bfloat16"])
@pytest.mark.parametrize("packing,seed", [(False, 11), (True, 12)])
def test_growers_match_jax(policy, dtype, packing, seed):
    """Every split's pass takes its salt (the new leaf best-first, level
    + 1 depth-wise, 0 at the root): trees bitwise in structure against
    the JAX growers, on gradients whose value pairs differ row by row,
    with a bag, uniform and packed."""
    args = pk.grower_case(seed, True, varied=True)
    plans = pk.plans() if packing else None
    if packing:
        args = pk.packed(args, plans[0])
    t, j = pk.grow_pair(policy, dtype, args, plans)
    assert t.num_leaves > 16
    if dtype == "int8_sr":
        base.assert_grown_alike(t, j, "int8")
    else:
        base.assert_grown_alike(t, j, "float32")


@pytest.mark.parametrize("policy", ["leafcompact", "leafwise", "depthwise"])
def test_int8_sr_salts_reach_the_trees(policy):
    """The salt schedule moves the trees: int8_sr and int8 grow different
    trees from the same gradients, and int8_sr is packing-invariant."""
    args = pk.grower_case(13, False, varied=True)
    spec, _ = pk.plans()
    trees = {}
    for dtype in ("int8", "int8_sr"):
        for packing in (None, spec):
            a = pk.packed(args, spec) if packing is not None else args
            trees[dtype, packing is not None] = grow_tree_unified(
                *map(torch.as_tensor, a), policy=policy, compute_dtype=dtype,
                packing=packing, num_leaves=31, num_bins_max=pk.B_WIDE,
                min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3)
    same = lambda a, b: all(np.array_equal(getattr(a, f), getattr(b, f))
                            for f in base.STRUCTURE + ("leaf_value",))
    assert same(trees["int8_sr", False], trees["int8_sr", True])
    assert not same(trees["int8_sr", False], trees["int8", False])


def _wide_mixed_case(seed):
    """8,000 rows of three narrow and three wide features that keep
    splitting down to 3-row leaves: 255 leaves reach a 64-column level."""
    rng = np.random.RandomState(seed)
    n, nb = 8000, np.array([254, 4, 254, 50, 254, 9], np.int32)
    x = rng.randn(n, len(nb))
    ranks = x.argsort(0).argsort(0)
    bins = (ranks * nb[None, :] // n).astype(np.uint8).T.copy()
    y = (x[:, 0] - x[:, 1] + 0.5 * np.sin(3 * x[:, 2]) + 0.6 * x[:, 3]
         + 0.8 * rng.randn(n) > 0)
    pr = 1.0 / (1.0 + np.exp(-0.5 * rng.randn(n)))
    return (bins, (pr - y).astype(np.float32),
            (pr * (1 - pr)).astype(np.float32), rng.rand(n) > 0.1,
            np.ones(len(nb), bool), nb)


def _jax_hist_at_64(bins, grad, hess, col_id, col_ok, num_cols, B,
                    compute_dtype="int8", salt=0, packing=None, **_):
    """The JAX CPU route's int8 histogram grouped at 64 columns, as the
    Pallas route groups (hist_pallas.py:369-371), with its rounding, salt
    and packing (tests/test_torch_depthwise.py's seam, extended)."""
    return jhp._grouped(jhp._hist_quant_xla_one, bins, grad, hess, col_id,
                        col_ok, num_cols, B, group_width=64, chunk=65536,
                        rng_bits=None, stochastic=compute_dtype == "int8_sr",
                        salt=salt, packing=packing)


@pytest.mark.parametrize("dtype", ["int8", "int8_sr"])
def test_depthwise_64_column_level_packed_matches_jax(monkeypatch, dtype):
    """A packed, salted 64-column level pass (two launches a pass) against
    the JAX grower with its histogram seam at 64 columns."""
    args = _wide_mixed_case(4)
    spec, jspec = pk.plans(args[5])
    args = pk.packed(args, spec)
    kw = dict(num_leaves=255, num_bins_max=254, min_data_in_leaf=3,
              min_sum_hessian_in_leaf=1e-3)
    monkeypatch.setattr(jdw, "histogram_leafbatch", _jax_hist_at_64)
    j = jax.jit(functools.partial(jdw.grow_tree_depthwise,
                                  compute_dtype=dtype, packing=jspec, **kw))(
        *map(jnp.asarray, args))
    levels = []
    real = tdw.histogram_leafbatch

    def record(*a, **k):
        levels.append(a[5])
        return real(*a, **k)

    monkeypatch.setattr(tdw, "histogram_leafbatch", record)
    t = tdw.grow_tree_depthwise(*map(torch.as_tensor, args),
                                compute_dtype=dtype, packing=spec, **kw)
    assert max(levels) == 64
    # structure, leaf counts and leaf ids exact; leaf values of 3-row
    # leaves, cached and subtracted over 8 levels, differ from the JAX
    # package's f32 bin sums by up to 1.03e-4 relative in int8_sr
    assert int(j.num_leaves) == t.num_leaves
    for field in base.STRUCTURE + ("leaf_count",):
        np.testing.assert_array_equal(getattr(t, field),
                                      np.asarray(getattr(j, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(t.leaf_ids.numpy(), np.asarray(j.leaf_ids))
    np.testing.assert_allclose(t.leaf_value, np.asarray(j.leaf_value),
                               rtol=2e-4, atol=1e-7)


# ------------------------------------------------------------------ GBDT


def _regression_pair(policy, x, y, init, dtype):
    """(JAX booster, port booster) after one regression iteration from
    per-row initial scores, under mixed_bin=true."""
    params = dict(pk.gbdt_params(policy, dtype), objective="regression")
    cfg = JConfig()
    cfg.set(params, require_data=False)
    from lightgbm_tpu.io.dataset import Dataset as JDataset
    from lightgbm_tpu.models.gbdt import GBDT as JGBDT
    from lightgbm_tpu.objectives import create_objective as jcreate
    jds = JDataset.from_arrays(x, y, max_bin=255)
    jds.metadata.init_score = init
    j = JGBDT()
    j.init(cfg.boosting_config, jds,
           jcreate(cfg.objective_type, cfg.objective_config))
    j.train_one_iter(is_eval=False)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=255)
    ds.metadata.init_score = init
    t = lgt.train(dict(params, num_iterations=1), ds, device="cpu")
    return j, t


@pytest.mark.parametrize("policy", list(pk.POLICIES))
def test_int8_sr_booster_first_tree_matches_jax(policy):
    """Through the user entry point, packed: the first int8_sr tree equals
    the JAX package's, leaf values included."""
    x, _ = pk.mixed_table()
    latent = x[:, 0] - 0.6 * x[:, 2] + 0.3 * x[:, 1] + 0.8 * x[:, 4]
    y = latent.astype(np.float32)
    init = np.random.RandomState(9).randn(len(y)).astype(np.float32)
    j, t = _regression_pair(policy, x, y, init, "int8_sr")
    a, b = j.models[0], t.models[0]
    assert a.num_leaves == b.num_leaves == 15
    for field in base.STRUCTURE:
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)
    np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                               atol=5e-7)


@pytest.fixture(scope="module", params=list(pk.POLICIES))
def bf16_pair(request):
    x, y = pk.mixed_table()
    params = pk.gbdt_params(request.param, "bfloat16")
    j = pk.jax_booster(params, x, y, base.ITERS)
    t = lgt.train(dict(params, num_iterations=base.ITERS),
                  lgt.Dataset.from_arrays(x, y, max_bin=255), device="cpu")
    return x, j, t


def test_bfloat16_booster_matches_jax(bf16_pair):
    x, j, t = bf16_pair
    assert t._pack_spec is not None
    base.test_trees_match_jax((x, j, t))
    base.test_scores_match_jax((x, j, t))


def test_bfloat16_model_text_loads_into_jax(bf16_pair, tmp_path):
    base.test_model_text_loads_into_jax(bf16_pair, tmp_path)


# ---------------------------------------------------------------- config


def test_compute_dtype_of_the_keys():
    """hist_dtype and quant_rounding resolve as the JAX package's
    ``_tuning_kwargs`` does; stochastic rounding of a float mode warns
    and is ignored."""
    for params, want in (({}, "float32"), ({"hist_dtype": "bfloat16"},
                                           "bfloat16"),
                         ({"hist_dtype": "INT8"}, "int8"),
                         ({"hist_dtype": "int8",
                           "quant_rounding": "stochastic"}, "int8_sr"),
                         ({"hist_dtype": "bfloat16",
                           "quant_rounding": "stochastic"}, "bfloat16")):
        cfg = lgt.OverallConfig()
        cfg.set(dict({"objective": "binary"}, **params), require_data=False)
        tc = cfg.boosting_config.tree_config
        assert tc.compute_dtype == want, params
        jc = JConfig()
        jc.set(dict({"objective": "binary"}, **params), require_data=False)
        jt = jc.boosting_config.tree_config
        assert (tc.hist_dtype, tc.quant_rounding, tc.mixed_bin) == \
            (jt.hist_dtype, jt.quant_rounding, jt.mixed_bin)
    assert thist.is_int8("int8_sr") and thist.is_int8("int8")
    assert not thist.is_int8("bfloat16")


def test_stochastic_on_float_warns(capsys):
    cfg = lgt.OverallConfig()
    cfg.set({"objective": "binary", "hist_dtype": "float32",
             "quant_rounding": "stochastic"}, require_data=False)
    assert "only applies to hist_dtype=int8" in capsys.readouterr().out


def test_int8_sr_cli_trains(tmp_path):
    """The CLI takes the keys; packed and uniform give the same model."""
    from lightgbm_tpu_torch.cli import main as cli_main
    x, y = pk.mixed_table()
    train = tmp_path / "train.tsv"
    np.savetxt(train, np.column_stack([y, x]), delimiter="\t", fmt="%.6g")
    texts = []
    for extra in (["mixed_bin=auto"], ["mixed_bin=false"]):
        model = tmp_path / "model.txt"
        assert cli_main(["task=train", "data=%s" % train, "objective=binary",
                         "num_trees=3", "num_leaves=15", "hist_dtype=int8",
                         "quant_rounding=stochastic",
                         "output_model=%s" % model, "device=cpu"]
                        + extra) == 0
        texts.append(model.read_text())
    assert texts[0] == texts[1] and texts[0].count("Tree=") == 3
    with pytest.raises(log.Fatal, match="quant_rounding must be"):
        lgt.OverallConfig().set({"objective": "binary",
                                 "quant_rounding": "up"}, require_data=False)
