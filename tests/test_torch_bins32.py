"""uint32 bin matrices (a feature of more than 65,536 bins):
lightgbm_tpu_torch (device="cpu", the kernels' plain versions) against
the JAX package run live.

The JAX package stores such a matrix as uint32 (``_bin_dtype``,
lightgbm_tpu/io/dataset.py:32-38); its file loaders bin from at most
50,000 sample rows, so these tables come from ``from_arrays`` with
``max_bin`` and ``sample_cnt`` above 65,536, from validation sets with
``reference=`` to them, and from their caches.  The port carries the
bins as int32 views (ops/bins.py); a pane holds four byte rows a bin
(ops/compact.py).  At these widths the JAX package histograms outside
Pallas (ops/histogram.py:34-56) and its compacted grower keys on the low
byte (ROADMAP C3), so the port's compacted grower is held against the
JAX masked grower.

Tolerances:
- dataset bins, dtype, mappers, caches (byte for byte), int8 and int8_sr
  histograms, panes and partitions: exact; every grower and mode on a
  table stored as uint16 and as its 32-bit carry: model text byte-equal;
- float32 and bfloat16 histograms: rtol 1e-5 / atol 1e-5, counts exact
  (tests/test_torch_maxbin.py's budget);
- boosters: split features, children and leaf parents exact, thresholds
  exact or the same partition (``assert_models_alike``), leaf values
  rtol 1e-5 / atol 5e-7.

Sizes: the whole path runs on a 66,000 x 2 table at ``max_bin=65600``
(65,599 bins a feature), one tree of 4 leaves, against two JAX runs
(int8 depth-wise and float32 masked) shared by module fixtures: each
takes about 30 s in the JAX package on the CPU.
"""
import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import IOConfig as JIOConfig
from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io import dataset as jdataset
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.objectives import create_objective as jcreate
from lightgbm_tpu.ops import histogram as jhist

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import IOConfig
from lightgbm_tpu_torch.ops import bins as tbins
from lightgbm_tpu_torch.ops import compact, hist_cuda
from lightgbm_tpu_torch.ops import histogram as thist
from lightgbm_tpu_torch.utils import log

from test_torch_ingest_columns import assert_same_dataset
from test_torch_maxbin import JAX_DTYPE, assert_models_alike, wide_table
from test_torch_parallel import TrainWorld, port_serial

MAX_BIN = 65600
ONE_TREE = {"objective": "binary", "num_leaves": "4",
            "min_data_in_leaf": "20", "min_sum_hessian_in_leaf": "1.0",
            "learning_rate": "0.2", "max_bin": str(MAX_BIN),
            "mixed_bin": "false"}
GROWERS = {"compacted": {"leafwise_compact": "true"},
           "masked": {"leafwise_compact": "false"},
           "depthwise": {"grow_policy": "depthwise"}}


def table66(n=66_000, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 2)
    y = ((x[:, 0] - 0.5 * x[:, 1] + 0.3 * rng.randn(n)) > 0).astype(
        np.float32)
    return x, y


@pytest.fixture(scope="module")
def data():
    x, y = table66()
    xv, yv = table66(5000, seed=4)
    j = JDataset.from_arrays(x, y, max_bin=MAX_BIN, sample_cnt=66_000)
    t = lgt.Dataset.from_arrays(x, y, max_bin=MAX_BIN, sample_cnt=66_000)
    return {"x": x, "y": y, "xv": xv, "yv": yv, "j": j, "t": t}


def _jax_one_tree(params, ds):
    cfg = JConfig()
    cfg.set(params, require_data=False)
    j = JGBDT()
    j.init(cfg.boosting_config, ds,
           jcreate(cfg.objective_type, cfg.objective_config))
    j.train_one_iter(is_eval=False)
    return j


@pytest.fixture(scope="module")
def jax_runs(data):
    """The JAX package's int8 depth-wise and float32 masked trees."""
    return {"int8-depthwise": _jax_one_tree(
                dict(ONE_TREE, hist_dtype="int8", grow_policy="depthwise"),
                data["j"]),
            "float32-masked": _jax_one_tree(
                dict(ONE_TREE, hist_dtype="float32",
                     leafwise_compact="false"), data["j"])}


def _port_one_tree(params, ds):
    return lgt.train(dict(params, num_iterations=1), ds, device="cpu")


# ---------------------------------------------------------------- dataset


def test_both_packages_pick_uint32(data):
    j, t = data["j"], data["t"]
    assert jdataset._bin_dtype(65_537) == np.uint32
    assert j.bins.dtype == t.bins.dtype == np.uint32
    assert int(t.num_bins.max()) == MAX_BIN - 1 > 65_536
    np.testing.assert_array_equal(t.num_bins, j.num_bins)
    np.testing.assert_array_equal(t.bins, j.bins)
    np.testing.assert_array_equal(t.bin_upper_bounds_matrix(),
                                  j.bin_upper_bounds_matrix())
    dev = t.to_device(torch.device("cpu"))["bins"]
    assert dev.dtype == torch.int32 and tbins.bin_bytes(dev) == 4
    np.testing.assert_array_equal(tbins.to_numpy(dev), t.bins)
    assert tbins.widen(dev) is dev


def test_validation_set_is_uint32(data):
    jv = JDataset.from_arrays(data["xv"], data["yv"], reference=data["j"])
    tv = lgt.Dataset.from_arrays(data["xv"], data["yv"],
                                 reference=data["t"])
    assert jv.bins.dtype == tv.bins.dtype == np.uint32
    np.testing.assert_array_equal(tv.bins, jv.bins)


def test_bins_past_2_31_are_refused_by_name():
    """A 32-bit bin is below 2^31 wherever max_bin is an int32; the int32
    carry refuses one that is not rather than wrap it."""
    bins = np.array([[0, 5, 1 << 31]], np.uint32)
    with pytest.raises(log.Fatal, match="2\\^31"):
        tbins.to_tensor(bins, "cpu")
    ok = tbins.to_tensor(bins[:, :2], "cpu")
    assert ok.dtype == torch.int32 and ok.tolist() == [[0, 5]]


# ------------------------------------------------------------- histograms


def _hist_inputs(seed, C, n=3000, F=3, B=70_000):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, n)).astype(np.uint32)
    bins[:, :5] = B - 1                          # the top bin is reached
    grad = (rng.randn(n) * 0.5).astype(np.float32)
    hess = (rng.rand(n) * 0.25 + 0.01).astype(np.float32)
    cid = rng.randint(0, C, n).astype(np.int32)
    ok = rng.rand(n) < 0.85
    return bins, grad, hess, cid, ok


@pytest.mark.parametrize("dtype,C", [
    ("float32", 1), ("float32", 3), ("int8", 1), ("int8", 3),
    ("int8_sr", 3), ("bfloat16", 3)])
def test_leafbatch_matches_jax_at_70000_bins(dtype, C):
    B = 70_000
    bins, grad, hess, cid, ok = _hist_inputs(C, C, B=B)
    want = np.asarray(jhist.histogram_leafbatch(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(cid), jnp.asarray(ok), C, B,
        compute_dtype=JAX_DTYPE[dtype], salt=7))
    got = thist.histogram_leafbatch(
        tbins.to_tensor(bins, "cpu"), torch.as_tensor(grad),
        torch.as_tensor(hess), torch.as_tensor(cid), torch.as_tensor(ok),
        C, B, dtype, salt=7).numpy()
    assert got.shape == (C, 3, B, 3)
    if dtype.startswith("int8"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[..., 2], want[..., 2])


@pytest.mark.parametrize("n", [1, 4000, 1_000_000])
@pytest.mark.parametrize("B,C,side", [(131_072, 1, "float"),
                                      (131_072, 42, "int8"),
                                      (65_537, 8, "float")])
def test_launch_plan_accumulates_globally_past_65536_bins(n, B, C, side):
    """Above GLOBAL_BINS a pass keeps no accumulator in shared memory: no
    copies, one slice of every cell, the block's shared memory the staged
    side band alone; rows and features still covered once."""
    F = 8
    words = hist_cuda.SIDE_WORDS[side]
    for shift in (0, 3):
        (vec, threads, g, copies, tile, chunk, groups, chunks, smem, slices,
         slice_cells) = hist_cuda.plan(n, F, B, C, side, shift, 132)
        assert copies == 0 and slices == 1 and slice_cells == B * C
        assert smem == words * 4 * (tile + tile // vec) <= hist_cuda.MAX_SMEM
        assert tile >= 16 and g == min(8, F)
        assert (groups - 1) * g < F <= groups * g
        assert (chunks - 1) * chunk < n + shift <= chunks * chunk
    # a 64-bin class of the same 32-bit matrix keeps its shared slices
    assert hist_cuda.plan(4000, F, 64, 1, side, 0, 132)[3] > 0


def test_wrappers_take_32bit_bins():
    t32 = torch.zeros((2, 10), dtype=torch.int32)
    g = torch.zeros(10)
    cid = torch.zeros(10, dtype=torch.int32)
    assert hist_cuda.hist_float(t32, g, g, cid, 1, 131_072).shape == \
        (2, 131_072, 3)
    with pytest.raises(ValueError, match="uint8, int16"):
        hist_cuda.hist_float(t32.to(torch.int64), g, g, cid, 1, 300)
    with pytest.raises(ValueError, match="2\\^31"):
        hist_cuda.hist_float(t32, g, g, cid, 64, 1 << 25)


def test_packing_plan_matches_jax_past_65536_bins(capsys):
    """A 70,000-row table of one narrow and two 70,000-bin columns packs
    as the JAX package packs it: the same classes, widths and
    permutation, one launch a class at widths 64 and the widest
    column's bins."""
    rng = np.random.RandomState(7)
    x = rng.randn(70_000, 3)
    x[:, 1] = rng.randint(0, 5, 70_000)
    y = ((x[:, 0] + 0.2 * x[:, 1] + 0.3 * rng.randn(70_000)) > 0).astype(
        np.float32)
    j = JDataset.from_arrays(x, y, max_bin=70_000, sample_cnt=70_000)
    t = lgt.Dataset.from_arrays(x, y, max_bin=70_000, sample_cnt=70_000)
    jspec, tspec = j.plan_packing("auto"), t.plan_packing("auto")
    wide = int(t.num_bins.max())
    assert wide > 65_536
    assert tspec.widths == tuple(jspec.widths) == (64, wide)
    assert tspec.counts == tuple(jspec.counts) == (1, 2)
    assert tspec.perm == tuple(jspec.perm) == (1, 0, 2)
    params = {"objective": "binary", "num_leaves": 4, "num_iterations": 1,
              "hist_dtype": "int8", "grow_policy": "depthwise",
              "max_bin": 70_000}
    capsys.readouterr()
    packed = lgt.train(params, t, device="cpu")
    assert "mixed-bin packing: 1 narrow (<=64 bins) + 2 wide features " \
        "(histogram passes per class: 64x%d)" % wide \
        in capsys.readouterr().out
    assert packed._pack_spec == tspec
    assert packed.bins_device.dtype == torch.int32
    uniform = lgt.train(dict(params, mixed_bin="false"), t, device="cpu")
    assert packed.model_to_string() == uniform.model_to_string()


# ------------------------------------------------------------------ panes


def _pane32(seed, F=4, n=6000, P=8192):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, 1 << 31, (F, n)).astype(np.uint32)
    bins[0] = rng.randint(0, 70_000, n)          # a 70,000-bin feature
    bins[1] = rng.randint(0, 1 << 17, n)
    grad = rng.randn(n).astype(np.float32)
    hess = rng.rand(n).astype(np.float32)
    ok = rng.rand(n) < 0.8
    pane = compact.pack_planes(tbins.to_tensor(bins, "cpu"),
                               torch.as_tensor(grad), torch.as_tensor(hess),
                               torch.as_tensor(ok), P)
    return pane, bins, grad, hess, ok


def test_pane_32bit_round_trip():
    """Byte k of every bin in rows [k F, (k + 1) F), then the value
    planes at row 4F; ``unpack_values`` gives the int32 carry back."""
    F, n = 4, 6000
    pane, bins, grad, hess, ok = _pane32(0, F, n)
    assert pane.shape == (compact.pane_rows(F, 4), 8192)
    assert compact.pane_rows(F, 4) == 32 and compact.pane_rows(8, 4) == 48
    for k in range(4):
        np.testing.assert_array_equal(
            pane[k * F:(k + 1) * F, :n].numpy().view(np.uint8),
            ((bins >> (8 * k)) & 0xFF).astype(np.uint8))
    assert not pane[:, n:].any()
    tb, tg, th, tv = compact.unpack_values(pane[:, 1001:5001], F, 4)
    assert tb.dtype == torch.int32
    np.testing.assert_array_equal(tbins.to_numpy(tb), bins[:, 1001:5001])
    np.testing.assert_array_equal(tg.numpy(), grad[1001:5001])
    np.testing.assert_array_equal(th.numpy(), hess[1001:5001])
    np.testing.assert_array_equal(tv.numpy(), ok[1001:5001])


@pytest.mark.parametrize("feat,thr,start,cnt", [
    (0, 35_000, 0, 6000), (0, 65_535, 1001, 3000), (0, 65_536, 13, 4097),
    (1, 70_000, 777, 5000), (2, (1 << 24) + 5, 5, 1),
    (3, (1 << 31) - 1, 100, 2000), (2, 1 << 30, 64, 5900), (1, 0, 2049, 0)])
def test_pane_32bit_partition_matches_numpy(feat, thr, start, cnt):
    """Stable partition on the whole 32-bit key (four byte rows),
    thresholds across 2^16, 2^24 and 2^30, every other lane of the
    destination untouched."""
    F = 4
    src, bins, *_ = _pane32(feat + start, F)
    dst0 = torch.as_tensor(np.random.RandomState(2).randint(
        -128, 128, tuple(src.shape)).astype(np.int8))
    dst = dst0.clone()
    left = compact.partition_pane(src, dst, F, feat, thr, start, cnt, 4)
    key = bins[feat, start:start + cnt]
    order = np.concatenate([np.nonzero(key <= thr)[0],
                            np.nonzero(key > thr)[0]]) + start
    want = dst0.numpy().copy()
    want[:, start:start + cnt] = src.numpy()[:, order]
    np.testing.assert_array_equal(dst.numpy(), want)
    assert int(left) == int((key <= thr).sum())
    with pytest.raises(ValueError, match="thr"):
        compact.partition_pane(src, dst, F, feat, 1 << 31, start, cnt, 4)


@pytest.mark.parametrize("sstart,scnt,rows", [
    (0, 6000, None), (1001, 17, None), (777, 4093, (0, 2))])
def test_pane_32bit_hist_is_unpack_then_build(sstart, scnt, rows):
    F, B = 4, 70_000
    pane, *_ = _pane32(sstart, F)
    got = hist_cuda.hist_pane_float(pane, F, sstart, scnt, B, rows, 4)
    first, cnt = rows or (0, F)
    tb, tg, th, tv = compact.unpack_values(pane[:, sstart:sstart + scnt],
                                           F, 4)
    want = thist.build_histogram(tb[first:first + cnt], tg, th, tv, B)
    assert got.shape == (cnt, B, 3) and torch.equal(got, want)


# -------------------------------------------------------- layout invariance


MODES = {"float32": {"hist_dtype": "float32"},
         "bfloat16": {"hist_dtype": "bfloat16"},
         "int8": {"hist_dtype": "int8"},
         "int8_sr": {"hist_dtype": "int8", "quant_rounding": "stochastic"}}


@pytest.fixture(scope="module")
def wide16():
    """A 1,022-bin table with narrow columns (packed at 64 and 1022)."""
    x, y = wide_table(n=2500, seed=9)
    return lgt.Dataset.from_arrays(x, y, max_bin=1023)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("grower", sorted(GROWERS))
def test_uint16_and_32bit_carry_train_the_same_text(wide16, grower, mode):
    """The same bins stored as uint16 and as uint32 (the int32 carry,
    four-byte panes) grow byte-equal model text under every grower and
    histogram mode, packed layout included."""
    as32 = lgt.Dataset.from_arrays(*wide_table(n=2500, seed=9),
                                   max_bin=1023)
    as32.bins = wide16.bins.astype(np.uint32)
    assert as32.to_device(torch.device("cpu"))["bins"].dtype == torch.int32
    params = dict(GROWERS[grower], **MODES[mode], objective="binary",
                  num_leaves=15, num_iterations=2, min_data_in_leaf=20,
                  max_bin=1023)
    a = lgt.train(params, wide16, device="cpu")
    b = lgt.train(params, as32, device="cpu")
    assert b.bins_device.dtype == torch.int32
    assert a.model_to_string() == b.model_to_string()


# ----------------------------------------------------------- whole path


def test_int8_depthwise_matches_jax(data, jax_runs):
    t = _port_one_tree(dict(ONE_TREE, hist_dtype="int8",
                            grow_policy="depthwise"), data["t"])
    assert t.bins_device.dtype == torch.int32
    assert_models_alike(jax_runs["int8-depthwise"].models, t.models,
                        data["t"].bins)


def test_float32_masked_matches_jax(data, jax_runs):
    t = _port_one_tree(dict(ONE_TREE, hist_dtype="float32",
                            leafwise_compact="false"), data["t"])
    assert_models_alike(jax_runs["float32-masked"].models, t.models,
                        data["t"].bins)


def test_compacted_matches_jax_masked_c3(data, jax_runs):
    """ROADMAP C3 at 32 bits: the port's compacted grower keys on the
    whole bin and grows the JAX masked grower's tree, thresholds past
    65,535 included."""
    t = _port_one_tree(dict(ONE_TREE, hist_dtype="float32",
                            leafwise_compact="true"), data["t"])
    assert_models_alike(jax_runs["float32-masked"].models, t.models,
                        data["t"].bins)
    assert max(int(tr.threshold_bin.max()) for tr in t.models) > 255


# ----------------------------------------------------------------- caches


@pytest.fixture(scope="module")
def caches(data, tmp_path_factory):
    """Each package's native cache (read as ``data=``) and reference-
    format cache (read as the ``<data>.bin`` sibling of a text path that
    does not exist) of the 66,000-row table: {(who, fmt): (cache, the
    path to load)}."""
    d = tmp_path_factory.mktemp("caches")
    paths = {}
    for who, ds in (("j", data["j"]), ("t", data["t"])):
        native = str(d / ("%s.bin" % who))
        ds.save_binary(native)
        paths[who, "native"] = (native, native)
        text = str(d / ("%s.tsv" % who))
        ds.save_binary_reference(text + ".bin")
        paths[who, "reference"] = (text + ".bin", text)
    return paths


@pytest.mark.parametrize("fmt", ["native", "reference"])
def test_caches_byte_equal_and_read_across(data, caches, fmt):
    assert filecmp.cmp(caches["j", fmt][0], caches["t", fmt][0],
                       shallow=False)
    t_from_j = lgt.Dataset.load_train(IOConfig(
        data_filename=caches["j", fmt][1]))
    j_from_t = JDataset.load_train(JIOConfig(
        data_filename=caches["t", fmt][1]))
    assert t_from_j.bins.dtype == j_from_t.bins.dtype == np.uint32
    assert_same_dataset(j_from_t, t_from_j)
    np.testing.assert_array_equal(t_from_j.bins, data["t"].bins)


def test_streamed_cache_read_carries_32bit_bins(data, caches):
    s = lgt.Dataset.load_train(IOConfig(
        data_filename=caches["t", "native"][1], streaming="true",
        ingest_chunk_rows=7000), device="cpu")
    assert s.bins is None and s.device_bins.dtype == torch.int32
    np.testing.assert_array_equal(s.read_bins(), data["t"].bins)


def test_data_world_from_cache_writes_the_serial_int8_text(caches,
                                                            tmp_path):
    """A 2-rank ``tree_learner=data`` world re-shards the uint32 cache and
    grows the serial run's int8 text on it."""
    params = dict(ONE_TREE, hist_dtype="int8", num_iterations="1")
    world = TrainWorld(tmp_path, 2, [{
        "name": "int8", "params": {"tree_learner": "data",
                                   "num_machines": "2"}}],
        caches["t", "native"][1], base=params).result()
    texts = [rank["int8"]["model"] for rank in world]
    assert texts[0] == texts[1]
    assert sum(rank["int8"]["rows"] for rank in world) == 66_000
    assert texts[0] == port_serial(params, caches["t", "native"][1])
