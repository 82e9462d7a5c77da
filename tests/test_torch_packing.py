"""Mixed-bin packing: lightgbm_tpu_torch (device="cpu", the kernels' plain
versions) vs the JAX package under ``mixed_bin=true``, and vs the port's
own uniform layout.

The tables mix narrow features (num_bin <= 64) with wide ones at 254
bins, so the plan has two classes and every pass launches twice.

Tolerances:
- the plan, int8 histograms (packed against the JAX package's packed
  histogram and against the port's uniform one), int8 trees and leaf ids:
  exact; the port's packed trees equal its uniform trees byte for byte
  in model text, in every mode (on the CPU the per-class passes add each
  cell's rows in the uniform pass's order);
- float32 histograms against the JAX package's: rtol 1e-6 / atol 1e-5
  (sums in another order);
- grower level: ``assert_grown_alike`` (tests/test_torch_gbdt.py);
- GBDT level: structure exact.  Leaf values and scores as
  tests/test_torch_gbdt.py in int8 (rtol 1e-5 / atol 5e-7, scores rtol
  1e-5 / atol 2e-6); in float32 rtol 1e-4 / atol 1e-5 and scores rtol
  1e-4 / atol 2e-5.  From the second iteration on, the JAX package sums
  a 254-bin feature's bins in f32 (the port in f64), and a leaf whose
  gradient sum cancels carries that difference to a few 1e-6 absolute,
  2.5e-4 relative on a leaf of 0.013 (the effect ROADMAP C records for
  multiclass).  The JAX package's own packed and uniform boosters are
  equal here, as are the port's, so the layout adds nothing to the
  difference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io import binning as jbin
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models import grower as jmw
from lightgbm_tpu.models import grower_depthwise as jdw
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.models.grower_leafcompact import \
    grow_tree_leafcompact as jlc
from lightgbm_tpu.objectives import create_objective as jcreate
from lightgbm_tpu.ops import histogram as jhist

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.io import binning as tbin
from lightgbm_tpu_torch.models.grower_unified import grow_tree_unified
from lightgbm_tpu_torch.ops import compact, hist_cuda
from lightgbm_tpu_torch.ops import histogram as thist
from tests import test_torch_gbdt as base

B_WIDE = 254
# canonical features: wide, narrow (5 bins), wide, narrow (40), narrow
# (2), wide, narrow (3)
NUM_BINS = np.array([B_WIDE, 5, B_WIDE, 40, 2, B_WIDE, 3], np.int32)
NARROW = (1, 3, 4, 6)
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
             "int8": "int8", "int8_sr": "int8_sr"}


def plans(num_bins=NUM_BINS):
    """(port PackSpec, JAX PackSpec) of ``num_bins``."""
    nb_max = int(np.max(num_bins))
    return (tbin.plan_feature_packing(num_bins, nb_max),
            jbin.plan_feature_packing(num_bins, nb_max))


def grower_case(seed, bagging, varied=False, n=4000):
    """Canonical [F, N] bins with NUM_BINS bins per feature, gradients,
    row mask, feature mask and num_bins.  ``varied``: gradients of
    random scores (distinct (grad, hess) pairs row by row); else those
    of a flat score, whose sums are exact in f32."""
    rng = np.random.RandomState(seed)
    F = len(NUM_BINS)
    x = rng.randn(n, F)
    ranks = x.argsort(0).argsort(0)
    bins = (ranks * NUM_BINS[None, :] // n).astype(np.uint8).T.copy()
    y = (x[:, 0] - x[:, 1] + 0.6 * x[:, 3] + 0.5 * np.sin(3 * x[:, 2])
         + 0.4 * (x[:, 4] > 0) + 0.3 * rng.randn(n) > 0)
    score = 0.7 * rng.randn(n) if varied else np.zeros(n)
    pr = 1.0 / (1.0 + np.exp(-score))
    grad = (pr - y).astype(np.float32)
    hess = (pr * (1 - pr)).astype(np.float32)
    row_mask = np.ones(n, bool)
    if bagging:
        row_mask[rng.rand(n) < 0.4] = False
    return bins, grad, hess, row_mask, np.ones(F, bool), NUM_BINS.copy()


def packed(args, spec):
    """The grower arguments with the bin matrix in ``spec``'s storage
    order."""
    bins = np.ascontiguousarray(args[0][np.asarray(spec.perm)])
    return (bins,) + tuple(args[1:])


def grow_pair(policy, dtype, args, packing, num_leaves=31, min_data=20):
    """(port TreeArrays, JAX TreeArrays) of one tree under ``policy``
    from the same storage-order arguments."""
    spec, jspec = packing if packing is not None else (None, None)
    kw = dict(num_leaves=num_leaves, num_bins_max=B_WIDE,
              min_data_in_leaf=min_data, min_sum_hessian_in_leaf=1e-3)
    jargs = tuple(map(jnp.asarray, args))
    jkw = dict(kw, compute_dtype=JAX_DTYPE[dtype], packing=jspec)
    if policy == "depthwise":
        j = jdw.grow_tree_depthwise_jit(*jargs, **jkw)
    elif policy == "leafcompact":
        j = jlc(*jargs, **jkw)
    else:
        j = jmw.grow_tree(*jargs, **jkw)
    t = grow_tree_unified(*map(torch.as_tensor, args), policy=policy,
                          compute_dtype=dtype, packing=spec, **kw)
    return t, j


# ------------------------------------------------------------------ plan


@pytest.mark.parametrize("num_bins,mode", [
    (NUM_BINS, "auto"), (NUM_BINS, "true"), (NUM_BINS, "false"),
    (np.array([254, 254, 200]), "auto"),        # every feature wide
    (np.array([5, 64, 2]), "true"),             # every feature narrow
    (np.array([65, 64, 2, 254]), "auto"),       # 64 is narrow, 65 wide
    (np.array([3, 90, 2, 7, 120]), "auto"),     # num_bins_max under 255
    (np.zeros(0, np.int32), "auto")])
def test_plan_matches_jax(num_bins, mode):
    nb_max = int(num_bins.max()) if num_bins.size else 0
    got = tbin.plan_feature_packing(num_bins, nb_max, mode=mode)
    want = jbin.plan_feature_packing(num_bins, nb_max, mode=mode)
    assert (got is None) == (want is None)
    if got is not None:
        assert tuple(got) == tuple(want)
        assert got.ranges == want.ranges and got.c2p == want.c2p
        assert tbin.NARROW_BINS == jbin.NARROW_BINS == 64


def test_dataset_plan_matches_jax():
    x, y = mixed_table()
    t = lgt.Dataset.from_arrays(x, y, max_bin=255)
    j = JDataset.from_arrays(x, y, max_bin=255)
    np.testing.assert_array_equal(t.num_bins, j.num_bins)
    for mode in ("auto", "true", "false"):
        got, want = t.plan_packing(mode), j.plan_packing(mode=mode)
        assert (got is None) == (want is None) == (mode == "false")
        if got is not None:
            assert tuple(got) == tuple(want)
            assert got.counts == (3, 4) and got.widths[0] == 64


# ------------------------------------------------------------ histograms


def _hist_inputs(seed, C, n=3000):
    args = grower_case(seed, True, varied=True, n=n)
    rng = np.random.RandomState(seed + 1)
    col_id = rng.randint(0, C, n).astype(np.int32)
    return args[0], args[1], args[2], col_id, args[3]


@pytest.mark.parametrize("dtype,C", [("int8", 1), ("int8", 7), ("int8", 40),
                                     ("float32", 1), ("float32", 9)])
def test_packed_leafbatch_matches_jax(dtype, C):
    """The port's packed histogram against the JAX package's packed one
    (its CPU route), from the same storage-order bins; int8 bitwise."""
    spec, jspec = plans()
    bins, grad, hess, cid, ok = _hist_inputs(3, C)
    pbins = np.ascontiguousarray(bins[np.asarray(spec.perm)])
    want = np.asarray(jhist.histogram_leafbatch(
        jnp.asarray(pbins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(cid), jnp.asarray(ok), C, B_WIDE,
        compute_dtype=JAX_DTYPE[dtype], packing=jspec))
    got = thist.histogram_leafbatch(
        torch.as_tensor(pbins), torch.as_tensor(grad), torch.as_tensor(hess),
        torch.as_tensor(cid), torch.as_tensor(ok), C, B_WIDE, dtype,
        packing=spec).numpy()
    assert got.shape == want.shape == (C, len(NUM_BINS), B_WIDE, 3)
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(got[..., 2], want[..., 2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int8_sr"])
@pytest.mark.parametrize("C", [1, 5, 100])
def test_packed_equals_uniform(dtype, C):
    """Packed storage, per-class launches, canonical assembly: the same
    histogram as the uniform single pass over canonical bins, bit for
    bit on the CPU (100 columns run as two 50-column groups)."""
    spec, _ = plans()
    bins, grad, hess, cid, ok = map(torch.as_tensor, _hist_inputs(5, C))
    pbins = bins[torch.as_tensor(spec.perm)].contiguous()
    kw = dict(compute_dtype=dtype, salt=9)
    got = thist.histogram_leafbatch(pbins, grad, hess, cid, ok, C, B_WIDE,
                                    packing=spec, **kw)
    want = thist.histogram_leafbatch(bins, grad, hess, cid, ok, C, B_WIDE,
                                     **kw)
    assert torch.equal(got, want)
    # narrow features carry nothing past their own bins
    assert not got[:, list(NARROW), 64:].any()


def test_packed_pass_launches_once_per_class(monkeypatch):
    """Each class launches at its own width on its own rows: bins >= 64
    of a narrow feature never reach the narrow launch."""
    spec, _ = plans()
    calls = []
    real = hist_cuda.hist_int8

    def record(bins, levels, cid, C, B):
        calls.append((bins.shape[0], B))
        return real(bins, levels, cid, C, B)

    monkeypatch.setattr(thist, "hist_int8", record)
    bins, grad, hess, cid, ok = map(torch.as_tensor, _hist_inputs(2, 3))
    pbins = bins[torch.as_tensor(spec.perm)].contiguous()
    thist.histogram_leafbatch(pbins, grad, hess, cid, ok, 3, B_WIDE, "int8",
                              packing=spec)
    assert calls == [(4, 64), (3, B_WIDE)]


@pytest.mark.parametrize("sstart,scnt", [(0, 4000), (13, 1500), (2047, 1)])
def test_pane_class_rows_equal_unpacked(sstart, scnt):
    """The pane entry over one class's bin rows: the float histogram of
    those rows of the unpacked slice at the class width."""
    spec, _ = plans()
    bins, grad, hess, ok, _, _ = map(torch.as_tensor,
                                     packed(grower_case(4, True), spec))
    F = bins.shape[0]
    pane = compact.pack_planes(bins, grad, hess, ok,
                               compact.bucket_table(bins.shape[1])[0])
    for first, cnt, width in spec.ranges:
        got = hist_cuda.hist_pane_float(pane, F, sstart, scnt, width,
                                        (first, cnt))
        pb, pg, ph, pvalid = compact.unpack_values(
            pane[:, sstart:sstart + scnt], F)
        want = thist.build_histogram(pb[first:first + cnt], pg, ph, pvalid,
                                     width)
        assert got.shape == (cnt, width, 3)
        assert torch.equal(got, want)


# --------------------------------------------------------------- growers


@pytest.mark.parametrize("policy", ["leafcompact", "leafwise", "depthwise"])
@pytest.mark.parametrize("dtype,bagging", [
    ("float32", False), ("float32", True), ("int8", False), ("int8", True)])
def test_packed_growers_match_jax(policy, dtype, bagging):
    """All three growers under packing, from the same storage-order bins:
    structure, leaf counts and original-order leaf ids exact against the
    JAX package's packed growers, and the port's packed tree equal to its
    own uniform tree over canonical bins."""
    args = grower_case(11, bagging)
    spec, jspec = plans()
    t, j = grow_pair(policy, dtype, packed(args, spec), (spec, jspec))
    assert t.num_leaves > 16
    # some split lands on a narrow feature: its storage row differs
    assert np.isin(t.split_feature[:t.num_leaves - 1], NARROW).any()
    base.assert_grown_alike(t, j, dtype)
    u = grow_tree_unified(*map(torch.as_tensor, args), policy=policy,
                          compute_dtype=dtype, num_leaves=31,
                          num_bins_max=B_WIDE, min_data_in_leaf=20,
                          min_sum_hessian_in_leaf=1e-3)
    for field in base.STRUCTURE + ("leaf_count", "leaf_value",
                                   "split_gain"):
        np.testing.assert_array_equal(getattr(t, field), getattr(u, field),
                                      err_msg=field)
    assert torch.equal(t.leaf_ids, u.leaf_ids)


# ------------------------------------------------------------------ GBDT


def mixed_table(n=2500, seed=97):
    """A 2,500 x 7 table of four continuous columns and three narrow
    ones (5 values, a flag, 40 values), each of which moves the label."""
    rng = np.random.RandomState(seed)
    cont = rng.randn(n, 4)
    flag = (rng.rand(n) < 0.4).astype(float)
    small = rng.randint(0, 5, n).astype(float)
    mid = rng.randint(0, 40, n).astype(float)
    x = np.column_stack([cont[:, 0], small, cont[:, 1], mid, flag,
                         cont[:, 2], cont[:, 3]])
    y = ((cont[:, 0] - 0.6 * cont[:, 1] + 0.3 * (small - 2) + 0.8 * flag
          + 0.03 * (mid - 20) + 0.25 * cont[:, 2]
          + 0.3 * rng.randn(n)) > 0).astype(np.float32)
    return x, y


MIXED_NARROW = (1, 3, 4)
POLICIES = {"leafcompact": {"leafwise_compact": "true"},
            "leafwise": {"leafwise_compact": "false"},
            "depthwise": {"grow_policy": "depthwise"}}


def jax_booster(params, x, y, iters):
    cfg = JConfig()
    cfg.set(params, require_data=False)
    j = JGBDT()
    j.init(cfg.boosting_config, JDataset.from_arrays(x, y, max_bin=255),
           jcreate(cfg.objective_type, cfg.objective_config))
    for _ in range(iters):
        if j.train_one_iter(is_eval=False):
            break
    return j


def gbdt_params(policy, dtype, mixed_bin="true"):
    extra = {"hist_dtype": dtype}
    if dtype == "int8_sr":
        extra = {"hist_dtype": "int8", "quant_rounding": "stochastic"}
    return dict(base.PARAMS, mixed_bin=mixed_bin, **POLICIES[policy],
                **extra)


@pytest.fixture(scope="module", params=[
    (p, d) for p in POLICIES for d in ("float32", "int8")],
    ids=lambda pd: "%s-%s" % pd)
def mixed_pair(request):
    """(x, JAX booster, port booster, port uniform booster), 4 iterations
    under ``mixed_bin=true`` (the uniform one under ``false``)."""
    policy, dtype = request.param
    x, y = mixed_table()
    params = gbdt_params(policy, dtype)
    j = jax_booster(params, x, y, base.ITERS)
    assert j._pack_spec is not None
    ds = lgt.Dataset.from_arrays(x, y, max_bin=255)
    t = lgt.train(dict(params, num_iterations=base.ITERS), ds, device="cpu")
    u = lgt.train(dict(params, num_iterations=base.ITERS, mixed_bin="false"),
                  ds, device="cpu")
    return x, j, t, u, dtype


def test_packed_gbdt_trees_match_jax(mixed_pair):
    x, j, t, u, dtype = mixed_pair
    assert t._pack_spec is not None and u._pack_spec is None
    assert tuple(t._pack_spec) == tuple(j._pack_spec)
    assert len(j.models) == len(t.models) == base.ITERS
    rtol, atol = (1e-5, 5e-7) if dtype == "int8" else (1e-4, 1e-5)
    for k, (a, b) in enumerate(zip(j.models, t.models)):
        assert a.num_leaves == b.num_leaves, "tree %d" % k
        for field in base.STRUCTURE + ("split_feature_real",):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field),
                                          err_msg="tree %d %s" % (k, field))
        np.testing.assert_array_equal(a.threshold, b.threshold)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=rtol,
                                   atol=atol, err_msg="tree %d" % k)
    assert any(np.isin(b.split_feature_real, MIXED_NARROW).any()
               for b in t.models)
    rtol, atol = (1e-5, 2e-6) if dtype == "int8" else (1e-4, 2e-5)
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score),
                               rtol=rtol, atol=atol)


def test_packed_gbdt_equals_uniform(mixed_pair):
    """The layout changes no bit of the model or the training score."""
    _, _, t, u, _ = mixed_pair
    assert t.model_to_string() == u.model_to_string()
    assert torch.equal(t.score, u.score)


def test_packed_model_text_loads_into_jax(mixed_pair, tmp_path):
    """The saved model speaks canonical feature indices: the JAX package
    reloads it and predicts what the port predicts."""
    x, j, t, _, _ = mixed_pair
    path = str(tmp_path / "model.txt")
    t.save_model_to_file(True, path)
    loaded = JGBDT.from_model_file(path)
    np.testing.assert_allclose(loaded.predict(x), t.predict(x), rtol=1e-12)


def test_validation_scores_stay_canonical():
    """A validation set and the training set's cached device tensor stay
    in canonical order: the validation score is the saved model's raw
    prediction of the validation rows, and a second booster on the same
    dataset trains the same trees."""
    x, y = mixed_table()
    xv, yv = mixed_table(800, seed=5)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=255)
    valid = lgt.Dataset.from_arrays(xv, yv, max_bin=255, reference=ds)
    params = dict(gbdt_params("leafcompact", "int8"), num_iterations=3,
                  metric="binary_logloss")
    first = lgt.train(params, ds, valid_sets=[valid], device="cpu")
    assert first._pack_spec is not None
    np.testing.assert_array_equal(ds.to_device(torch.device("cpu"))["bins"]
                                  .numpy(), ds.bins)
    vscore = first.valid_datasets[0]["score"][0].numpy()
    np.testing.assert_allclose(vscore, first.predict_raw(xv), rtol=1e-6,
                               atol=1e-6)
    second = lgt.train(params, ds, valid_sets=[valid], device="cpu")
    assert second.model_to_string() == first.model_to_string()
    assert any(np.isin(tr.split_feature_real, MIXED_NARROW).any()
               for tr in first.models)


def test_cli_mixed_bin_round_trip(tmp_path):
    from lightgbm_tpu_torch.cli import main as cli_main
    x, y = mixed_table()
    train = tmp_path / "train.tsv"
    np.savetxt(train, np.column_stack([y, x]), delimiter="\t", fmt="%.6g")
    models = []
    for mode in ("true", "false"):
        model = tmp_path / ("model_%s.txt" % mode)
        assert cli_main(["task=train", "data=%s" % train, "objective=binary",
                         "num_trees=3", "num_leaves=15", "mixed_bin=%s" % mode,
                         "grow_policy=depthwise", "hist_dtype=int8",
                         "output_model=%s" % model, "device=cpu"]) == 0
        models.append(model.read_text())
    assert models[0] == models[1] and models[0].count("Tree=") == 3


@pytest.mark.parametrize("extra", [
    {"objective": "regression", "hist_dtype": "bfloat16"},
    {"objective": "multiclass", "num_class": 3, "hist_dtype": "int8",
     "quant_rounding": "stochastic"},
    {"objective": "lambdarank", "hist_dtype": "int8"},
    {"hist_dtype": "int8", "bagging_fraction": 0.7, "bagging_freq": 1,
     "feature_fraction": 0.8, "grow_policy": "depthwise"},
    {"hist_dtype": "float32", "goss": "true", "leafwise_compact": "false"}],
    ids=["regression-bf16", "multiclass-int8_sr", "lambdarank-int8",
         "bagged-depthwise-int8", "goss-masked-float32"])
def test_packed_objectives_and_sampling_equal_uniform(extra):
    """Every objective, sampled or not: the packed booster's model equals
    the uniform one's byte for byte."""
    x, y = mixed_table()
    latent = x[:, 0] - 0.6 * x[:, 2] + 0.3 * x[:, 1] + 0.8 * x[:, 4]
    qb = None
    if extra.get("objective") == "multiclass":
        y = np.digitize(latent, np.quantile(latent, [0.33, 0.66]))
    elif extra.get("objective") == "lambdarank":
        y = np.digitize(latent, np.quantile(latent, [0.5, 0.8, 0.95]))
        qb = np.arange(0, 2501, 50)
    elif extra.get("objective") == "regression":
        y = latent
    ds = lgt.Dataset.from_arrays(x, y.astype(np.float32), max_bin=255,
                                 query_boundaries=qb)
    params = dict({"objective": "binary", "num_leaves": 15,
                   "num_iterations": 2, "min_data_in_leaf": 20}, **extra)
    packed_b = lgt.train(dict(params, mixed_bin="true"), ds, device="cpu")
    uniform_b = lgt.train(dict(params, mixed_bin="false"), ds, device="cpu")
    assert packed_b._pack_spec is not None and uniform_b._pack_spec is None
    assert packed_b.model_to_string() == uniform_b.model_to_string()
