"""``max_bin > 256`` (16-bit bins): lightgbm_tpu_torch (device="cpu", the
kernels' plain versions) against the JAX package run live.

At ``B > 256`` the JAX package never takes its Pallas kernels: float
histograms go through ``_leafbatch_einsum`` and int8 ones through
``hist_quant_xla``, both grouped at 42 columns on every backend
(ops/histogram.py:34-56, :385-420; hist_pallas.py:307-323, :543).  Its
compacted grower keys on the low byte of a 16-bit bin
(lightgbm_tpu/ops/compact.py:463, grower_unified.py:1087, ROADMAP C3), so
the port's compacted grower is held against the JAX masked grower, which
grows the same trees wherever both are right (tests/test_torch_grower_
masked.py).  tests/test_torch_maxbin_growers.py holds every grower and
histogram mode at the booster level.

Tolerances:
- dataset bins, their dtype, ``num_bins`` and bin upper bounds; int8 and
  int8_sr histograms; panes and partitions: exact;
- float32 and bfloat16 histograms: rtol 1e-5 / atol 1e-5, counts exact
  (f32 sums in another order; the atol covers sums that cancel);
- boosters (2 iterations): split features, children and leaf parents
  exact, leaf values rtol 1e-5 / atol 5e-7 (tests/test_torch_gbdt.py's
  budget: the gradients' last bits), float32 at 2,999 bins rtol 1e-4 /
  atol 1e-5 (tests/test_torch_maxbin_growers.py's header says why);
  thresholds exact, or the same partition (``assert_models_alike``).

Ties between thresholds.  At B = 1023 a leaf of a few hundred rows has
runs of empty bins, and every threshold in such a run splits its rows
alike.  The port sums the bins in float64, so those thresholds tie
exactly and the largest wins, the reference's rule (split.py's header);
the JAX package's float32 ``cumsum`` rounds each prefix in its own order
and picks one of them by its last bit (seen: 463 against the port's 465,
bins 462-465 empty).  Wherever the two thresholds differ, every bin
between them must be empty among the node's rows: the same partition,
the same leaves, another threshold value in the model text (ROADMAP C,
known gaps).  For the same reason a split whose gain is the JAX package's
rounding (seen: 1.5e-5, on gains of 1-400) can be taken there and
refused by the port; the trees here stop before such leaves
(``min_sum_hessian_in_leaf`` 1.0; 7 leaves through the CLI, whose 15-leaf
second tree takes one at its 14th split), as
tests/test_torch_objectives_gbdt.py's do.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.cli import main as jcli
from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io import dataset as jdataset
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.objectives import create_objective as jcreate
from lightgbm_tpu.ops import compact as jcompact
from lightgbm_tpu.ops import histogram as jhist

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.cli import main as tcli
from lightgbm_tpu_torch.ops import compact, hist_cuda
from lightgbm_tpu_torch.ops import histogram as thist
from lightgbm_tpu_torch.ops.bins import to_tensor, widen
from lightgbm_tpu_torch.ops.scoring import split_leaf_sequence
from lightgbm_tpu_torch.utils import log

JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
             "int8": "int8", "int8_sr": "int8_sr"}


def wide_table(n=3000, seed=5, narrow=True):
    """Continuous columns (num_bin max_bin - 1 at max_bin 1023), and with
    ``narrow`` a 5-value column and a flag, each moving the label."""
    rng = np.random.RandomState(seed)
    cont = rng.randn(n, 4)
    cols = [cont[:, 0], cont[:, 1], cont[:, 2], cont[:, 3]]
    latent = cont[:, 0] - 0.6 * cont[:, 1] + 0.3 * np.sin(2 * cont[:, 2])
    if narrow:
        small = rng.randint(0, 5, n).astype(float)
        flag = (rng.rand(n) < 0.4).astype(float)
        cols[1:1] = [small]
        cols.append(flag)
        latent = latent + 0.3 * (small - 2) + 0.8 * flag
    y = (latent + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return np.column_stack(cols), y


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("max_bin,n", [(1023, 3000), (4096, 6000)])
def test_dataset_bins_match_jax(max_bin, n):
    """uint16 bins, num_bins and bin upper bounds, bit for bit; the
    validation set binned with the training mappers; the device copy an
    int16 view of the same bins."""
    x, y = wide_table(n, seed=max_bin)
    xv, yv = wide_table(700, seed=max_bin + 1)
    j = JDataset.from_arrays(x, y, max_bin=max_bin)
    t = lgt.Dataset.from_arrays(x, y, max_bin=max_bin)
    assert j.bins.dtype == t.bins.dtype == np.uint16
    assert int(t.num_bins.max()) > 256
    np.testing.assert_array_equal(t.bins, j.bins)
    np.testing.assert_array_equal(t.num_bins, j.num_bins)
    for a, b in zip(j.bin_mappers, t.bin_mappers):
        np.testing.assert_array_equal(b.bin_upper_bound, a.bin_upper_bound)
    np.testing.assert_array_equal(t.bin_upper_bounds_matrix(),
                                  j.bin_upper_bounds_matrix())
    jv = JDataset.from_arrays(xv, yv, reference=j)
    tv = lgt.Dataset.from_arrays(xv, yv, reference=t)
    assert tv.bins.dtype == np.uint16
    np.testing.assert_array_equal(tv.bins, jv.bins)
    dev = t.to_device(torch.device("cpu"))["bins"]
    assert dev.dtype == torch.int16
    np.testing.assert_array_equal(widen(dev).numpy(), t.bins)


def test_narrow_columns_stay_uint8_at_high_max_bin():
    """max_bin only caps the bins: a table whose features have at most
    256 values keeps a uint8 matrix, as in the JAX package."""
    rng = np.random.RandomState(3)
    x = rng.randint(0, 200, (2000, 4)).astype(float)
    y = (x[:, 0] > 100).astype(np.float32)
    j = JDataset.from_arrays(x, y, max_bin=1023)
    t = lgt.Dataset.from_arrays(x, y, max_bin=1023)
    assert j.bins.dtype == t.bins.dtype == np.uint8
    np.testing.assert_array_equal(t.bins, j.bins)
    assert t.to_device(torch.device("cpu"))["bins"].dtype == torch.uint8


def test_uint32_bins_are_refused_by_name():
    """More than 65,536 bins in a feature needs uint32 bins in the JAX
    package; the port refuses them by name rather than truncate."""
    n = 70_000
    x = np.arange(n, dtype=float)[:, None]
    y = (x[:, 0] > n / 2).astype(np.float32)
    assert jdataset._bin_dtype(n) == np.uint32
    with pytest.raises(log.Fatal, match="wider than 16 bits"):
        lgt.Dataset.from_arrays(x, y, max_bin=n, sample_cnt=n)


@pytest.mark.parametrize("value", ["1023", "4096", "65535"])
def test_config_accepts_max_bin_above_256(value):
    cfg = lgt.OverallConfig()
    cfg.set({"objective": "binary", "max_bin": value}, require_data=False)
    assert cfg.io_config.max_bin == int(value)


# ------------------------------------------------------------ histograms


def _hist_inputs(seed, C, n=2000, F=4, B=1023):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, n)).astype(np.uint16)
    bins[:, :5] = B - 1                          # the top bin is reached
    grad = (rng.randn(n) * 0.5).astype(np.float32)
    hess = (rng.rand(n) * 0.25 + 0.01).astype(np.float32)
    cid = rng.randint(0, C, n).astype(np.int32)
    ok = rng.rand(n) < 0.85
    return bins, grad, hess, cid, ok


def _leafbatch_pair(bins, grad, hess, cid, ok, C, B, dtype, spec=None,
                    jspec=None):
    want = np.asarray(jhist.histogram_leafbatch(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(cid), jnp.asarray(ok), C, B,
        compute_dtype=JAX_DTYPE[dtype], salt=7, packing=jspec))
    got = thist.histogram_leafbatch(
        to_tensor(bins, "cpu"), torch.as_tensor(grad),
        torch.as_tensor(hess), torch.as_tensor(cid), torch.as_tensor(ok),
        C, B, dtype, packing=spec, salt=7).numpy()
    return got, want


def _assert_hist(got, want, dtype):
    if dtype.startswith("int8"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[..., 2], want[..., 2])


@pytest.mark.parametrize("dtype,C", [
    ("float32", 1), ("float32", 6), ("bfloat16", 6), ("int8", 1),
    ("int8", 6), ("int8", 64), ("int8_sr", 6), ("int8_sr", 64)])
def test_leafbatch_matches_jax_at_1023_bins(dtype, C):
    """float32/bfloat16 against ``_leafbatch_einsum``, int8/int8_sr bit
    for bit against ``hist_quant_xla`` at B = 1023; a 64-column level
    splits into two 32-column groups, each with its own scale."""
    args = _hist_inputs(C, C)
    got, want = _leafbatch_pair(*args, C, 1023, dtype)
    assert got.shape == (C, 4, 1023, 3)
    _assert_hist(got, want, dtype)


def test_int8_levels_group_at_42_columns_above_256_bins():
    """The 42-column grouping is what makes the 64-column level bitwise:
    grouped at 64 (one scale for the level) the histogram differs."""
    bins, grad, hess, cid, ok = _hist_inputs(64, 64)
    assert hist_cuda.group_width(1023) == 42
    assert hist_cuda.group_width(256) == 64
    tb = to_tensor(bins, "cpu")
    args = (torch.as_tensor(grad), torch.as_tensor(hess),
            torch.as_tensor(cid), torch.as_tensor(ok))

    def one(b, g, h, c, o, k, B):
        return thist._int8_one(b, g, h, c, o, k, B, None, 0, False)

    at42 = thist.histogram_leafbatch(tb, *args, 64, 1023, "int8")
    at64 = hist_cuda.grouped(one, tb, *args, 64, 1023, group_width=64)
    assert not torch.equal(at42, at64)
    # counts do not depend on the scale
    assert torch.equal(at42[..., 2], at64[..., 2])


@pytest.mark.parametrize("dtype,C", [("float32", 6), ("int8", 64),
                                     ("int8_sr", 6)])
def test_packed_leafbatch_matches_jax_at_1023_bins(dtype, C):
    """Two bin-width classes (64 and 1023): one launch per class,
    assembled canonically, against the JAX package's packed route."""
    from lightgbm_tpu.io import binning as jbin
    from lightgbm_tpu_torch.io import binning as tbin
    bins, grad, hess, cid, ok = _hist_inputs(C + 100, C, F=5)
    bins[1] %= 5
    bins[3] %= 40
    nb = np.array([1023, 5, 1023, 40, 1023], np.int32)
    spec = tbin.plan_feature_packing(nb, 1023)
    jspec = jbin.plan_feature_packing(nb, 1023)
    assert spec.widths == (64, 1023) == tuple(jspec.widths)
    packed = np.ascontiguousarray(bins[np.asarray(spec.perm)])
    got, want = _leafbatch_pair(packed, grad, hess, cid, ok, C, 1023, dtype,
                                spec, jspec)
    _assert_hist(got, want, dtype)
    uniform, _ = _leafbatch_pair(bins, grad, hess, cid, ok, C, 1023, dtype)
    if dtype.startswith("int8"):
        np.testing.assert_array_equal(got, uniform)


def test_plain_version_reads_bins_past_32767():
    """16-bit bins ride int16 views: bins of 32,768 and more are negative
    there and must land in their own cells, not be dropped."""
    B, n = 50_000, 3000
    rng = np.random.RandomState(1)
    bins = rng.randint(32_000, B, (2, n)).astype(np.uint16)
    grad = rng.randn(n).astype(np.float32)
    hess = np.ones(n, np.float32)
    cid = np.zeros(n, np.int32)
    got = hist_cuda.hist_float(to_tensor(bins, "cpu"), torch.as_tensor(grad),
                               torch.as_tensor(hess), torch.as_tensor(cid),
                               1, B)
    for f in range(2):
        counts = np.bincount(bins[f], minlength=B)
        np.testing.assert_array_equal(got[f, :, 2].numpy(), counts)
        np.testing.assert_allclose(
            got[f, :, 0].numpy(),
            np.bincount(bins[f], weights=grad, minlength=B), rtol=1e-5,
            atol=1e-5)


@pytest.mark.parametrize("B", [1023, 2999])
def test_split_search_matches_jax_at_wide_b(B):
    """``find_best_split`` over 1023 and 2999 bins, most of them empty or
    nearly so, on whole-number gradients: their bin sums are exact in any
    order, so the JAX package's f32 cumsum and the port's f64 one agree,
    and with them every choice, ties in runs of empty bins included."""
    from tests.test_torch_split import _assert_same, _both
    rng = np.random.RandomState(B)
    F, n = 4, 1500
    bins = rng.randint(0, B, (F, n))
    vals = np.stack([rng.randint(-3, 4, n), np.ones(n), np.ones(n)],
                    1).astype(np.float32)
    hist = np.zeros((F, B, 3), np.float32)
    for f in range(F):
        np.add.at(hist[f], bins[f], vals)
    num_bins = np.array([B, B - 7, B // 2, B], np.int32)
    j, t = _both(hist, num_bins, np.ones(F, bool))
    _assert_same(j, t)


# ------------------------------------------------------------- launch plan


# B, C, mode (hist_cuda.CELL_BYTES): the 16-bit shapes of chip_smoke.py
# phase 10 and the widest the int8 mode takes
WIDE_PLAN_SHAPES = [(1023, 1, "float"), (1023, 8, "float"),
                    (1023, 42, "float"), (1023, 42, "int8"),
                    (1023, 64, "int8"), (50_000, 1, "float"),
                    (50_000, 1, "int8"), (65_536, 1, "float"),
                    (4096, 255, "int8"), (256, 255, "int8")]


@pytest.mark.parametrize("n", [1, 4000, 1_000_000])
@pytest.mark.parametrize("B,C,side", WIDE_PLAN_SHAPES)
def test_launch_plan_slices_wide_accumulators(n, B, C, side):
    """Every plan fits shared memory; a feature's B*C cells are covered
    by its slices exactly once, each slice within SLICE_BYTES; slices and
    row chunks together cover every (feature, row)."""
    F = 28
    cell, words = hist_cuda.CELL_BYTES[side], hist_cuda.SIDE_WORDS[side]
    for shift in (0, 9):
        (vec, threads, g, copies, tile, chunk, groups, chunks, smem, slices,
         slice_cells) = hist_cuda.plan(n, F, B, C, side, shift, 132)
        assert smem <= hist_cuda.MAX_SMEM and tile >= 16
        assert (slices - 1) * slice_cells < B * C <= slices * slice_cells
        assert slice_cells * cell <= hist_cuda.SLICE_BYTES
        assert slices == -(-B * C * cell // hist_cuda.SLICE_BYTES)
        acc = -(-copies * g * slice_cells * cell // 16) * 16
        assert smem == acc + words * 4 * (tile + tile // vec)
        assert (groups - 1) * g < F <= groups * g
        assert (chunks - 1) * chunk < n + shift <= chunks * chunk
        if slices > 1:
            assert g == 1


def test_wrappers_refuse_what_the_kernel_does_not_take():
    tb = torch.zeros((2, 10), dtype=torch.uint8)
    t16 = torch.zeros((2, 10), dtype=torch.int16)
    g = torch.zeros(10)
    cid = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="B <= 256"):
        hist_cuda.hist_float(tb, g, g, cid, 1, 257)
    with pytest.raises(ValueError, match="B <= 65536"):
        hist_cuda.hist_float(t16, g, g, cid, 1, 65537)
    with pytest.raises(ValueError, match="uint8 or int16"):
        hist_cuda.hist_float(t16.to(torch.int32), g, g, cid, 1, 300)
    assert hist_cuda.hist_float(t16, g, g, cid, 1, 65536).shape == \
        (2, 65536, 3)


# ------------------------------------------------------------------ panes


def _pane16(seed, F=5, n=6000, P=8192):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, 65536, (F, n)).astype(np.uint16)
    bins[0] = rng.randint(0, 1023, n)            # a 1023-bin feature
    grad = rng.randn(n).astype(np.float32)
    hess = rng.rand(n).astype(np.float32)
    ok = rng.rand(n) < 0.8
    pane = compact.pack_planes(to_tensor(bins, "cpu"), torch.as_tensor(grad),
                               torch.as_tensor(hess), torch.as_tensor(ok), P)
    return pane, bins, grad, hess, ok


def test_pane_16bit_round_trip():
    """The 16-bit pane is the JAX package's pane of the bins' low bytes
    with F high-byte rows inserted after the bin rows: low bytes, high
    bytes, then the value planes at row 2F."""
    F, n = 5, 6000
    pane, bins, grad, hess, ok = _pane16(0, F, n)
    assert pane.shape == (compact.pane_rows(F, 2), 8192)
    assert compact.pane_rows(F, 2) == 24 and compact.pane_rows(F) == 16
    jpane = np.asarray(jcompact.pack_planes(
        *map(jnp.asarray, ((bins & 0xFF).astype(np.uint8), grad, hess, ok)),
        8192))
    np.testing.assert_array_equal(pane[:F].numpy(), jpane[:F])
    np.testing.assert_array_equal(pane[F:2 * F, :n].numpy().view(np.uint8),
                                  (bins >> 8).astype(np.uint8))
    np.testing.assert_array_equal(pane[2 * F:2 * F + 9].numpy(),
                                  jpane[F:F + 9])
    tb, tg, th, tv = compact.unpack_values(pane[:, 1001:5001], F, 2)
    assert tb.dtype == torch.int16
    np.testing.assert_array_equal(widen(tb).numpy(), bins[:, 1001:5001])
    np.testing.assert_array_equal(tg.numpy(), grad[1001:5001])
    np.testing.assert_array_equal(th.numpy(), hess[1001:5001])
    np.testing.assert_array_equal(tv.numpy(), ok[1001:5001])


@pytest.mark.parametrize("feat,thr,start,cnt", [
    (0, 511, 0, 6000), (0, 255, 1001, 3000), (0, 256, 13, 4097),
    (2, 40_000, 777, 5000), (3, 32_767, 5, 1), (4, 65_535, 100, 2000),
    (1, 0, 2049, 0)])
def test_pane_16bit_partition_matches_numpy(feat, thr, start, cnt):
    """Stable partition on the whole 16-bit key (low byte and high byte
    rows), every other lane untouched; thresholds across 256 and 32,768."""
    F = 5
    src, bins, *_ = _pane16(feat + thr, F)
    dst0 = torch.as_tensor(np.random.RandomState(2).randint(
        -128, 128, tuple(src.shape)).astype(np.int8))
    dst = dst0.clone()
    left = compact.partition_pane(src, dst, F, feat, thr, start, cnt, 2)
    key = bins[feat, start:start + cnt]
    order = np.concatenate([np.nonzero(key <= thr)[0],
                            np.nonzero(key > thr)[0]]) + start
    want = dst0.numpy().copy()
    want[:, start:start + cnt] = src.numpy()[:, order]
    np.testing.assert_array_equal(dst.numpy(), want)
    assert int(left) == int((key <= thr).sum())


@pytest.mark.parametrize("sstart,scnt,rows", [
    (0, 6000, None), (1001, 17, None), (777, 4093, (1, 3))])
def test_pane_16bit_hist_is_unpack_then_build(sstart, scnt, rows):
    """The pane entry over a 16-bit pane, all rows or a class of them,
    is ``unpack_values`` then the float histogram, bit for bit."""
    F, B = 5, 65_536
    pane, *_ = _pane16(sstart, F)
    got = hist_cuda.hist_pane_float(pane, F, sstart, scnt, B, rows, 2)
    first, cnt = rows or (0, F)
    tb, tg, th, tv = compact.unpack_values(pane[:, sstart:sstart + scnt],
                                           F, 2)
    want = thist.build_histogram(tb[first:first + cnt], tg, th, tv, B)
    assert torch.equal(got, want)


# ---------------------------------------------------------------- boosters


def _jax_booster(params, x, y, iters=2):
    cfg = JConfig()
    cfg.set(params, require_data=False)
    j = JGBDT()
    j.init(cfg.boosting_config, JDataset.from_arrays(x, y, max_bin=1023),
           jcreate(cfg.objective_type, cfg.objective_config))
    for _ in range(iters):
        if j.train_one_iter(is_eval=False):
            break
    return j


def assert_same_partitions(a_thr, b_thr, tree, bins, what):
    """Thresholds ``a_thr`` and ``b_thr`` of ``tree``'s nodes split every
    node's rows alike: equal, or no row of the node's leaf has a bin
    between them.  ``bins`` [F, N] canonical; ``tree`` gives the split
    features and children, replayed over the rows."""
    n = tree.num_leaves - 1
    split_leaf = split_leaf_sequence(tree.left_child[:n],
                                     tree.right_child[:n])
    leaf = np.zeros(bins.shape[1], np.int64)
    for k in range(n):
        row = bins[tree.split_feature[k]].astype(np.int64)
        mine = leaf == split_leaf[k]
        lo, hi = sorted((int(a_thr[k]), int(b_thr[k])))
        if lo != hi:
            assert not np.any(mine & (row > lo) & (row <= hi)), \
                "%s node %d: thresholds %d and %d split its rows apart" % (
                    what, k, a_thr[k], b_thr[k])
        leaf = np.where(mine & (row > int(b_thr[k])), k + 1, leaf)


def assert_models_alike(jm, tm, bins, rtol=1e-5, atol=5e-7):
    """A JAX booster's trees against a port booster's, tree by tree:
    split features, children and leaf parents exact; thresholds exact,
    or the same partition of every node's rows of ``bins`` (the training
    bins); leaf values within rtol / atol."""
    assert len(jm) == len(tm) > 0
    for k, (a, b) in enumerate(zip(jm, tm)):
        assert a.num_leaves == b.num_leaves, "tree %d" % k
        for field in ("split_feature", "split_feature_real", "left_child",
                      "right_child", "leaf_parent"):
            np.testing.assert_array_equal(getattr(b, field),
                                          getattr(a, field),
                                          err_msg="tree %d %s" % (k, field))
        assert_same_partitions(a.threshold_bin, b.threshold_bin, b, bins,
                               "tree %d" % k)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=rtol,
                                   atol=atol, err_msg="tree %d" % k)


PARAMS = {"objective": "binary", "num_leaves": "15",
          "min_data_in_leaf": "20", "min_sum_hessian_in_leaf": "1.0",
          "learning_rate": "0.2", "max_bin": "1023"}


def test_compacted_matches_jax_masked_above_256():
    """ROADMAP C3: at max_bin=1023 the port's compacted grower grows the
    JAX masked grower's trees; the JAX compacted grower, keying on the
    low byte, grows others (its thresholds fall in steps)."""
    x, y = wide_table(narrow=False)
    masked = _jax_booster(dict(PARAMS, leafwise_compact="false"), x, y)
    t = lgt.train(dict(PARAMS, leafwise_compact="true", num_iterations=2),
                  lgt.Dataset.from_arrays(x, y, max_bin=1023), device="cpu")
    assert int(t.train_data.num_bins.max()) == 1022
    assert max(int(tr.threshold_bin.max()) for tr in t.models) > 255
    assert_models_alike(masked.models, t.models, t.train_data.bins)
    jcompact_booster = _jax_booster(dict(PARAMS, leafwise_compact="true"),
                                    x, y)
    assert not np.array_equal(jcompact_booster.models[0].threshold_bin,
                              t.models[0].threshold_bin)


@pytest.mark.parametrize("kind", ["regression", "multiclass", "lambdarank"])
def test_objectives_match_jax_above_256(kind):
    """One each of the other objectives at max_bin=1023, compacted (the
    port's default; the JAX masked grower as its oracle), int8 for
    multiclass and lambdarank."""
    x, y = wide_table(2400, seed=11, narrow=False)
    latent = x[:, 0] - 0.6 * x[:, 1] + 0.3 * x[:, 2]
    extra = {"regression": {"objective": "regression"},
             "multiclass": {"objective": "multiclass", "num_class": "3",
                            "hist_dtype": "int8"},
             "lambdarank": {"objective": "lambdarank", "hist_dtype": "int8",
                            "min_sum_hessian_in_leaf": "0.05"}}[kind]
    qb = None
    if kind == "regression":
        y = latent.astype(np.float32)
    elif kind == "multiclass":
        y = np.digitize(latent, [-0.5, 0.5]).astype(np.float32)
    else:
        qb = np.arange(0, 2401, 30, dtype=np.int32)
        y = np.digitize(latent, [0.0, 0.8, 1.5]).astype(np.float32)
    params = dict(PARAMS, **extra)
    cfg = JConfig()
    cfg.set(dict(params, leafwise_compact="false"), require_data=False)
    j = JGBDT()
    j.init(cfg.boosting_config,
           JDataset.from_arrays(x, y, max_bin=1023, query_boundaries=qb),
           jcreate(cfg.objective_type, cfg.objective_config))
    for _ in range(2):
        j.train_one_iter(is_eval=False)
    t = lgt.train(dict(params, num_iterations=2),
                  lgt.Dataset.from_arrays(x, y, max_bin=1023,
                                          query_boundaries=qb),
                  device="cpu")
    assert t.bins_device.dtype == torch.int16
    assert_models_alike(j.models, t.models, t.train_data.bins)


@pytest.mark.parametrize("policy", ["leafcompact", "depthwise"])
def test_boosters_match_jax_at_3000_bins(policy):
    """A wider corner, max_bin=3000 on 6,000 rows (2,999 bins a feature):
    compacted float32 against the JAX masked grower, depth-wise int8
    against the JAX depth-wise grower."""
    x, y = wide_table(6000, seed=41, narrow=False)
    extra = ({"leafwise_compact": "true"} if policy == "leafcompact" else
             {"grow_policy": "depthwise", "hist_dtype": "int8"})
    params = dict(PARAMS, max_bin="3000", **extra)
    cfg = JConfig()
    jparams = dict(params, leafwise_compact="false") \
        if policy == "leafcompact" else params
    cfg.set(jparams, require_data=False)
    j = JGBDT()
    j.init(cfg.boosting_config, JDataset.from_arrays(x, y, max_bin=3000),
           jcreate(cfg.objective_type, cfg.objective_config))
    for _ in range(2):
        j.train_one_iter(is_eval=False)
    t = lgt.train(dict(params, num_iterations=2),
                  lgt.Dataset.from_arrays(x, y, max_bin=3000), device="cpu")
    assert int(t.train_data.num_bins.max()) == 2999
    assert_models_alike(j.models, t.models, t.train_data.bins,
                          *((1e-4, 1e-5) if policy == "leafcompact"
                            else (1e-5, 5e-7)))


def test_cli_train_predict_matches_jax_cli(tmp_path):
    """task=train max_bin=1023 -> task=predict through both CLIs: the
    same trees (thresholds as text where no bin run ties, see the
    header), predictions on the training rows within 1e-6."""
    x, y = wide_table(2000, seed=21)
    train = tmp_path / "train.tsv"
    np.savetxt(train, np.column_stack([y, x]), delimiter="\t", fmt="%.6g")
    outs = {}
    for name, main, extra in (("jax", jcli, []),
                              ("port", tcli, ["device=cpu"])):
        model = tmp_path / ("model_%s.txt" % name)
        result = tmp_path / ("pred_%s.txt" % name)
        assert main(["task=train", "data=%s" % train, "objective=binary",
                     "num_trees=3", "num_leaves=7", "max_bin=1023",
                     "min_sum_hessian_in_leaf=1.0",
                     "output_model=%s" % model] + extra) == 0
        assert main(["task=predict", "data=%s" % train,
                     "input_model=%s" % model, "output_result=%s" % result]
                    + extra) == 0
        outs[name] = (model.read_text(), np.loadtxt(result))
    ds = lgt.Dataset.from_arrays(x, y, max_bin=1023)
    jm, tm = (lgt.GBDT.from_model_file(str(tmp_path / ("model_%s.txt" % n)),
                                       device="cpu").models
              for n in ("jax", "port"))
    assert len(tm) == 3
    for tr in jm + tm:
        # the model text's thresholds back to bins through the mappers
        tr.threshold_bin = np.array(
            [np.searchsorted(ds.bin_mappers[f].bin_upper_bound, v)
             for f, v in zip(tr.split_feature, tr.threshold)], np.int32)
    assert_models_alike(jm, tm, ds.bins)
    np.testing.assert_allclose(outs["port"][1], outs["jax"][1], atol=1e-6)
