"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither JAX nor the JAX
package, so it runs where only PyTorch for CUDA is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the float histogram sums in 64-bit fixed point, the same
bits on every run, and agrees with the plain ``index_add_`` (f32 sums in
another order) to f32 rounding (rtol 1e-5, atol 1e-4 for cells that
cancel to near zero; on a root-sized segment, 1e-5 of each cell's
absolute sum); counts, the int8
histogram, both partition entries (with every lane outside the segment
untouched) and the int8 trees are exact, and so are the serving engine's
scores and leaf indices against the CPU engine's.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import compact, hist_cuda
from lightgbm_tpu_torch.ops.histogram import histogram_leafbatch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _hist(bins, grad, hess, cid, ok, C, B, dtype, device):
    t = lambda a: torch.as_tensor(a, device=device)
    return histogram_leafbatch(t(bins), t(grad), t(hess), t(cid), t(ok), C, B,
                               compute_dtype=dtype).cpu().numpy()


@pytest.mark.parametrize("C", [1, 42, 100])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_hist_kernel_matches_plain(cuda, dtype, C):
    rng = np.random.RandomState(C)
    F, N, B = 28, 100_001, 256
    args = (rng.randint(0, B, (F, N)).astype(np.uint8),
            (rng.randn(N) * 0.4).astype(np.float32),
            (rng.rand(N) * 0.25).astype(np.float32),
            rng.randint(0, C, N).astype(np.int32), rng.rand(N) < 0.85)
    got = _hist(*args, C, B, dtype, cuda)
    want = _hist(*args, C, B, dtype, "cpu")
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _assert_hist(got, want, dtype):
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _bins_view(rng, F, N, B, offset, ld, device):
    """[F, N] uint8 bins as a column slice starting ``offset`` lanes into
    rows of stride ``ld``, as the grower slices the pane."""
    wide = torch.as_tensor(rng.randint(0, B, (F, ld)).astype(np.uint8),
                           device=device)
    view = wide[:, offset:offset + N]
    assert view.stride(0) == ld
    return view


@pytest.mark.parametrize("N", [1, 100, 2047, 8191])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_hist_kernel_small_n(cuda, dtype, N):
    rng = np.random.RandomState(N)
    F, B = 28, 256
    args = (rng.randint(0, B, (F, N)).astype(np.uint8),
            (rng.randn(N) * 0.4).astype(np.float32),
            (rng.rand(N) * 0.25).astype(np.float32),
            np.zeros(N, np.int32), rng.rand(N) < 0.85)
    _assert_hist(_hist(*args, 1, B, dtype, cuda),
                 _hist(*args, 1, B, dtype, "cpu"), dtype)


@pytest.mark.parametrize("F,N,C", [(28, 60_001, 64), (200, 30_000, 1)])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_hist_kernel_wide_shapes(cuda, dtype, F, N, C):
    rng = np.random.RandomState(F + C)
    B = 256
    args = (rng.randint(0, B, (F, N)).astype(np.uint8),
            (rng.randn(N) * 0.4).astype(np.float32),
            (rng.rand(N) * 0.25).astype(np.float32),
            rng.randint(0, C, N).astype(np.int32), rng.rand(N) < 0.85)
    _assert_hist(_hist(*args, C, B, dtype, cuda),
                 _hist(*args, C, B, dtype, "cpu"), dtype)


# offsets off the 16-byte boundary; row strides aligned (the pane's) and not
@pytest.mark.parametrize("offset,ld", [(1, 40960), (13, 40960), (7, 40001),
                                       (2048, 40960)])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_hist_kernel_unaligned_slices(cuda, dtype, offset, ld):
    rng = np.random.RandomState(offset)
    F, N, B, C = 12, 33_333, 256, 3
    view = _bins_view(rng, F, N, B, offset, ld, cuda)
    g = torch.as_tensor(rng.randn(N).astype(np.float32), device=cuda)
    h = torch.as_tensor(rng.rand(N).astype(np.float32), device=cuda)
    cid = torch.as_tensor(rng.randint(-1, C + 1, N).astype(np.int32),
                          device=cuda)
    ok = torch.ones(N, dtype=torch.bool, device=cuda)
    got = histogram_leafbatch(view, g, h, cid.clamp(0, C - 1), ok & (
        cid >= 0) & (cid < C), C, B, dtype)
    want = histogram_leafbatch(view.cpu(), g.cpu(), h.cpu(),
                               cid.clamp(0, C - 1).cpu(),
                               ((cid >= 0) & (cid < C)).cpu(), C, B, dtype)
    _assert_hist(got.cpu().numpy(), want.numpy(), dtype)


@pytest.mark.parametrize("sstart,scnt", [(0, 0), (5, 1), (17, 15), (16, 16),
                                         (4095, 17), (1001, 4000),
                                         (12345, 100_001)])
def test_hist_pane_matches_plain(cuda, sstart, scnt):
    rng = np.random.RandomState(sstart + scnt)
    F, N, B, P = 28, 120_000, 256, 122_880
    bins = torch.as_tensor(rng.randint(0, B, (F, N)).astype(np.uint8))
    grad = torch.as_tensor(rng.randn(N).astype(np.float32))
    hess = torch.as_tensor(rng.rand(N).astype(np.float32))
    mask = torch.as_tensor(rng.rand(N) < 0.8)
    pane = compact.pack_planes(bins, grad, hess, mask, P)
    before = hist_cuda.launches
    got = hist_cuda.hist_pane_float(pane.to(cuda), F, sstart, scnt, B)
    assert hist_cuda.launches == before + (scnt > 0)
    want = hist_cuda.hist_pane_float(pane, F, sstart, scnt, B)
    _assert_hist(got.cpu().numpy(), want.numpy(), "float32")


# every row valid, as on the main path (each warp takes its all-kept
# branch): a root-sized segment (16 rows per thread), a median and a p90
# child of a 255-leaf tree on 1M rows, and a small child (4 rows per thread)
@pytest.mark.parametrize("scnt", [1, 3907, 22_236, 1_000_000])
def test_hist_pane_all_rows_valid(cuda, scnt):
    rng = np.random.RandomState(scnt)
    F, B, N = 28, 256, scnt + 2000
    P = compact.bucket_table(N)[0]
    bins = torch.as_tensor(rng.randint(0, B, (F, N)).astype(np.uint8))
    grad = torch.as_tensor(rng.randn(N).astype(np.float32))
    hess = torch.as_tensor(rng.rand(N).astype(np.float32))
    ones = torch.ones(N, dtype=torch.bool)
    pane = compact.pack_planes(bins, grad, hess, ones, P)
    got = hist_cuda.hist_pane_float(pane.to(cuda), F, 1001, scnt, B).cpu()
    want = hist_cuda.hist_pane_float(pane, F, 1001, scnt, B)
    # cells of thousands of terms cancel: each is held within 1e-5 of its
    # absolute sum, as chip_smoke.py holds the kernel
    mag = hist_cuda.hist_pane_float(
        compact.pack_planes(bins, grad.abs(), hess, ones, P), F, 1001, scnt,
        B)
    assert float(want[0, :, 2].sum()) == scnt
    assert torch.equal(got[..., 2], want[..., 2])
    assert bool(((got - want).abs() <= 1e-5 * mag + 1e-6).all())


def test_hist_int8_widest_column_byte(cuda):
    """Column 254, the widest id the int8 mode's staged byte holds."""
    rng = np.random.RandomState(255)
    F, N, B, C = 3, 20_000, 16, 255
    bins = torch.as_tensor(rng.randint(0, B, (F, N)).astype(np.uint8))
    levels = torch.as_tensor(rng.randint(-127, 128, (3, N)).astype(np.int8))
    cid = torch.as_tensor(rng.randint(-1, C, N).astype(np.int32))
    got = hist_cuda.hist_int8(bins.to(cuda), levels.to(cuda), cid.to(cuda),
                              C, B)
    assert torch.equal(got.cpu(), hist_cuda.hist_int8(bins, levels, cid, C, B))


def test_hist_kernel_strided_rows(cuda):
    """The grower hands the kernel a column slice of the pane."""
    rng = np.random.RandomState(9)
    wide = torch.as_tensor(rng.randint(0, 64, (5, 9000)).astype(np.uint8),
                           device=cuda)
    view = wide[:, 1000:7000]
    g = torch.as_tensor(rng.randn(6000).astype(np.float32), device=cuda)
    h = torch.ones(6000, device=cuda)
    cid = torch.zeros(6000, dtype=torch.int32, device=cuda)
    ok = torch.ones(6000, dtype=torch.bool, device=cuda)
    got = histogram_leafbatch(view, g, h, cid, ok, 1, 64, "int8")
    want = histogram_leafbatch(view.contiguous().cpu(), g.cpu(), h.cpu(),
                               cid.cpu(), ok.cpu(), 1, 64, "int8")
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("delta,cnt", [
    (0, 10240), (0, 8192), (1023, 4097), (77, 0), (2048, 5000), (5, 1),
    (3, 4093), (3, 4094)])
def test_partition_kernel_matches_plain(cuda, delta, cnt):
    rng = np.random.RandomState(delta + cnt)
    R, P, W = 40, 12288, 10240
    pane = torch.as_tensor(rng.randint(-128, 128, (R, P)).astype(np.int8))
    seg = pane[:, 1000:1000 + W]          # strided, as the grower slices
    lane = np.arange(W)
    mask3 = np.where((lane >= delta) & (lane < delta + cnt),
                     rng.randint(0, 2, W), -1).astype(np.int8)
    plcnt = int((mask3 == 1).sum())
    mask3 = torch.as_tensor(mask3)
    got = compact.partition_segment(seg.to(cuda), mask3.to(cuda), delta,
                                    cnt, plcnt)
    want = compact.partition_segment(seg, mask3, delta, cnt, plcnt)
    assert torch.equal(got.cpu(), want)


def _panes(seed, F, P):
    """A random [pane_rows(F), P] pane whose row 1 holds bins of 10 or
    more, and a random destination pane."""
    rng = np.random.RandomState(seed)
    R = compact.pane_rows(F)
    src = torch.as_tensor(rng.randint(-128, 128, (R, P)).astype(np.int8))
    src[1] = torch.as_tensor(rng.randint(10, 256, P).astype(np.uint8)
                             ).view(torch.int8)
    dst = torch.as_tensor(rng.randint(-128, 128, (R, P)).astype(np.int8))
    return src, dst


# one lane; around one kernel tile (4096 lanes from the 16-byte boundary),
# a bucket block and the largest one-launch segment (ONE_LAUNCH_TILES = 6
# tiles); the main path's root; at aligned and unaligned starts.  kind: (feature row, threshold) — random sides with a threshold
# in the sign byte, all left, all right
@pytest.mark.parametrize("start,cnt", [
    (0, 1), (5, 2047), (16, 2048), (1001, 2049), (13, 4083), (13, 4084),
    (3, 24_573), (3, 24_574), (0, 1_000_000), (7, 1_000_000)])
@pytest.mark.parametrize("kind", ["random", "all-left", "all-right"])
@pytest.mark.parametrize("F", [28, 200])
def test_partition_pane_matches_plain(cuda, F, kind, start, cnt):
    feat, thr = {"random": (0, 130), "all-left": (0, 255),
                 "all-right": (1, 9)}[kind]
    P = -(-(start + cnt) // 2048) * 2048
    src, dst0 = _panes(start + cnt, F, P)
    want = dst0.clone()
    want_left = compact.partition_pane(src, want, F, feat, thr, start, cnt)
    s, d = src.to(cuda), dst0.to(cuda)
    before = (compact.launches, compact.kernel_launches)
    left = compact.partition_pane(s, d, F, feat, thr, start, cnt)
    count_pass = compact.plan(cnt, (s.data_ptr() + start) % 16, s.shape[0],
                              torch.cuda.get_device_properties(
                                  cuda).multi_processor_count)[2]
    assert (compact.launches, compact.kernel_launches) == (
        before[0] + 1, before[1] + (2 if count_pass else 1))
    assert compact.launch_rows[-1] == cnt
    assert left.dtype == torch.int32 and left.device == s.device
    assert int(left) == int(want_left)
    if kind == "all-left":
        assert int(left) == cnt
    if kind == "all-right":
        assert int(left) == 0
    # the segment byte for byte; every other lane of both panes untouched
    assert torch.equal(d.cpu(), want)
    assert torch.equal(d[:, :start].cpu(), dst0[:, :start])
    assert torch.equal(d[:, start + cnt:].cpu(), dst0[:, start + cnt:])
    assert torch.equal(s.cpu(), src)


def test_partition_pane_empty_and_strided(cuda):
    """No lanes: nothing launched, nothing written.  Panes that are column
    slices of wider buffers (row stride off 16 bytes) still partition
    byte for byte."""
    src, dst0 = _panes(5, 28, 12288)
    s, d = src.to(cuda), dst0.to(cuda)
    before = compact.kernel_launches
    assert int(compact.partition_pane(s, d, 28, 0, 100, 777, 0)) == 0
    assert compact.kernel_launches == before
    assert torch.equal(d.cpu(), dst0)
    wide_src = torch.cat([src, src[:, :13]], 1)         # stride 12301
    want = dst0.clone()
    want_left = compact.partition_pane(wide_src[:, 3:12291], want, 28, 0,
                                       130, 1001, 9000)
    got_buf = torch.cat([dst0, dst0[:, :7]], 1).to(cuda)  # stride 12295
    got = got_buf[:, :12288]
    left = compact.partition_pane(wide_src.to(cuda)[:, 3:12291], got, 28, 0,
                                  130, 1001, 9000)
    assert int(left) == int(want_left)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got_buf[:, 12288:].cpu(), dst0[:, :7])


def test_int8_trees_equal_on_card_and_cpu(cuda):
    rng = np.random.RandomState(4)
    x = rng.randn(20_000, 10)
    y = (x[:, 0] - x[:, 1] + 0.3 * rng.randn(20_000) > 0).astype(np.float32)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=255)
    params = {"objective": "binary", "num_leaves": 31, "num_iterations": 3,
              "hist_dtype": "int8", "min_data_in_leaf": 20}
    on_card = lgt.train(params, ds, device=cuda)
    on_cpu = lgt.train(params, ds, device="cpu")
    assert on_card.model_to_string() == on_cpu.model_to_string()


@pytest.mark.parametrize("policy", [
    {"grow_policy": "depthwise", "num_leaves": 255},
    {"leafwise_compact": "false", "num_leaves": 31}],
    ids=["depthwise", "masked"])
def test_int8_policies_equal_on_card_and_cpu(cuda, policy):
    """Both other growth policies, every histogram through the kernel on
    the card: the same model as the plain versions on the CPU, and no
    partition launch.  255 depth-wise leaves reach a 64-column level."""
    rng = np.random.RandomState(5)
    x = rng.randn(30_000, 10)
    y = (x[:, 0] - x[:, 1] + 0.3 * rng.randn(30_000) > 0).astype(np.float32)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=255)
    params = dict({"objective": "binary", "num_iterations": 2,
                   "hist_dtype": "int8", "min_data_in_leaf": 20}, **policy)
    before = (hist_cuda.launches, compact.launches)
    on_card = lgt.train(params, ds, device=cuda)
    assert hist_cuda.launches > before[0]
    assert compact.launches == before[1]
    if "grow_policy" in policy:
        assert max(list(hist_cuda.launch_cols)[-8:]) == 64
    on_cpu = lgt.train(params, ds, device="cpu")
    assert on_card.model_to_string() == on_cpu.model_to_string()


@pytest.mark.parametrize("objective", ["regression", "multiclass"])
def test_int8_objective_trees_equal_on_card_and_cpu(cuda, objective):
    """Regression (constant hessian: one int8 level) and multiclass (five
    trees an iteration, float64 softmax): the same int8 model on the card
    as on the CPU."""
    rng = np.random.RandomState(6)
    x = rng.randn(20_000, 10)
    if objective == "regression":
        y = x[:, 0] - x[:, 1] + 0.3 * rng.randn(20_000)
        extra = {}
    else:
        y = np.argmax(x[:, :5] + 0.5 * rng.randn(20_000, 5), 1)
        extra = {"num_class": 5}
    ds = lgt.Dataset.from_arrays(x, y.astype(np.float32), max_bin=255)
    params = dict({"objective": objective, "num_leaves": 31,
                   "num_iterations": 3, "hist_dtype": "int8",
                   "min_data_in_leaf": 20}, **extra)
    before = (hist_cuda.launches, compact.launches)
    on_card = lgt.train(params, ds, device=cuda)
    assert hist_cuda.launches > before[0] and compact.launches > before[1]
    on_cpu = lgt.train(params, ds, device="cpu")
    assert len(on_card.models) == 3 * extra.get("num_class", 1)
    assert on_card.model_to_string() == on_cpu.model_to_string()


def test_lambdarank_gradients_on_card_and_cpu(cuda):
    """The lambdarank gradients of ragged queries on both devices, at
    score 0 and at random scores: within rtol 1e-5 / atol 1e-7 (float64
    ``exp`` and pair sums leave only float64 sums in another order)."""
    from lightgbm_tpu_torch.config import ObjectiveConfig
    from lightgbm_tpu_torch.io.metadata import Metadata
    from lightgbm_tpu_torch.objectives import create_objective
    rng = np.random.RandomState(7)
    qb = np.concatenate([[0], np.cumsum(rng.randint(1, 191, 300))])
    md = Metadata()
    md.set_label(rng.randint(0, 5, qb[-1]).astype(np.float32))
    md.query_boundaries = qb.astype(np.int32)
    md.finalize(int(qb[-1]))
    objs = []
    for dev in (cuda, torch.device("cpu")):
        objs.append(create_objective("lambdarank", ObjectiveConfig()))
        objs[-1].init(md, int(qb[-1]), dev)
    for score in (np.zeros(qb[-1], np.float32),
                  rng.randn(qb[-1]).astype(np.float32)):
        s = torch.as_tensor(score)
        on_card = [t.cpu() for t in objs[0].get_gradients(s.to(cuda))]
        on_cpu = objs[1].get_gradients(s)
        for a, b in zip(on_card, on_cpu):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_sampling_draws_equal_on_card_and_cpu(cuda):
    """The threefry bagging draw and the GOSS draw are integer arithmetic
    and stable sorts: bitwise the same on the card as on the CPU, at a
    million rows (where float32 uniforms tie) and for five classes."""
    from lightgbm_tpu_torch.ops import sampling
    from lightgbm_tpu_torch.utils import threefry
    key = sampling.bag_key(3)
    n = 1 << 20
    for draw in range(3):
        a = sampling.bag_mask_for_draw(key, draw, n, int(0.8 * n), cuda)
        b = sampling.bag_mask_for_draw(key, draw, n, int(0.8 * n))
        assert torch.equal(a.cpu(), b) and int(b.sum()) == int(0.8 * n)
    u = threefry.uniform(threefry.fold_in(key, 1), n, cuda)
    assert torch.equal(u.cpu(), threefry.uniform(threefry.fold_in(key, 1), n))
    rng = np.random.RandomState(8)
    for K in (1, 5):
        g = torch.as_tensor(rng.randn(K, 200_000).astype(np.float32))
        g[:, :50_000] = torch.round(g[:, :50_000])      # tied |grad|
        h = torch.as_tensor(rng.rand(K, 200_000).astype(np.float32))
        top, other, amp = sampling.goss_counts(200_000, 0.2, 0.1)
        k = threefry.fold_in(key, 2)
        on_card = sampling.goss_select(k, g.to(cuda), h.to(cuda), top, other,
                                       amp)
        on_cpu = sampling.goss_select(k, g, h, top, other, amp)
        for x, y in zip(on_card, on_cpu):
            assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("extra", [
    {"bagging_fraction": 0.8, "bagging_freq": 1, "bagging_device": "true",
     "feature_fraction": 0.8},
    {"goss": "true", "top_rate": 0.2, "other_rate": 0.1,
     "feature_fraction": 0.8},
    {"grow_policy": "depthwise", "num_leaves": 63, "bagging_fraction": 0.7,
     "bagging_freq": 2, "bagging_device": "true", "feature_fraction": 0.6},
    {"grow_policy": "depthwise", "num_leaves": 63, "goss": "true"},
    {"leafwise_compact": "false", "goss": "true", "feature_fraction": 0.8},
    {"objective": "multiclass", "num_class": 3, "bagging_fraction": 0.8,
     "bagging_freq": 1, "bagging_device": "true"}],
    ids=["compacted-bagging", "compacted-goss", "depthwise-bagging",
         "depthwise-goss", "masked-goss", "multiclass-bagging"])
def test_int8_sampled_trees_equal_on_card_and_cpu(cuda, extra):
    """Sampled int8 training: the threefry draws, feature samples and GOSS
    masks feed both kernels on the card, and the model equals the CPU's
    byte for byte."""
    rng = np.random.RandomState(9)
    x = rng.randn(30_000, 10)
    if extra.get("objective") == "multiclass":
        y = np.argmax(x[:, :3] + 0.5 * rng.randn(30_000, 3), 1)
    else:
        y = x[:, 0] - x[:, 1] + 0.3 * rng.randn(30_000) > 0
    ds = lgt.Dataset.from_arrays(x, y.astype(np.float32), max_bin=255)
    params = dict({"objective": "binary", "num_leaves": 31,
                   "num_iterations": 3, "hist_dtype": "int8",
                   "min_data_in_leaf": 20}, **extra)
    before = hist_cuda.launches
    on_card = lgt.train(params, ds, device=cuda)
    assert hist_cuda.launches > before
    on_cpu = lgt.train(params, ds, device="cpu")
    assert on_card.model_to_string() == on_cpu.model_to_string()


def test_continued_training_on_card(cuda, tmp_path):
    """``task=train input_model=...`` on the card: the input trees first,
    the continuation score bitwise the CPU's (a float64 sum in model
    order), and the same int8 model as the CPU's."""
    from lightgbm_tpu_torch.cli import main
    from lightgbm_tpu_torch.models.predictor import continuation_score
    rng = np.random.RandomState(10)
    x = rng.randn(20_000, 10)
    y = (x[:, 0] - x[:, 1] + 0.3 * rng.randn(20_000) > 0).astype(np.float32)
    train = str(tmp_path / "train.tsv")
    np.savetxt(train, np.column_stack([y, x]), delimiter="\t", fmt="%.17g")
    base = ["task=train", "data=" + train, "objective=binary",
            "num_leaves=31", "num_iterations=2", "hist_dtype=int8"]
    m1 = str(tmp_path / "m1.txt")
    assert main(base + ["output_model=" + m1]) == 0
    outs = {}
    for name, extra in (("card", []), ("cpu", ["device=cpu"])):
        outs[name] = str(tmp_path / ("m2_%s.txt" % name))
        assert main(base + ["input_model=" + m1,
                            "output_model=" + outs[name]] + extra) == 0
    text = open(outs["card"]).read()
    assert text == open(outs["cpu"]).read()
    assert text.count("Tree=") == 4
    first = lgt.GBDT.from_model_file(m1, device="cpu").models
    assert np.array_equal(continuation_score(first, x, cuda),
                          continuation_score(first, x, torch.device("cpu")))


@pytest.mark.parametrize("extra", [
    {"hist_dtype": "float32"},
    {"hist_dtype": "float32", "grow_policy": "depthwise"},
    {"hist_dtype": "int8", "bagging_fraction": 0.8, "bagging_freq": 2,
     "feature_fraction": 0.8},
], ids=["float32", "float32_depthwise", "int8_sampled"])
def test_raise_and_resume_on_card(cuda, tmp_path, extra):
    """On the card, float32 and int8 training stopped by a raise at
    iteration 3 and resumed from its checkpoints writes the unbroken
    run's model text byte for byte; the float histogram's sums are the
    same on every run, so two unbroken float32 runs agree first."""
    from lightgbm_tpu_torch import faults
    rng = np.random.RandomState(13)
    x = rng.randn(50_000, 12)
    y = (x[:, 0] - x[:, 1] + 0.4 * rng.randn(50_000) > 0).astype(np.float32)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=255)
    params = dict({"objective": "binary", "num_leaves": 63,
                   "num_iterations": 6, "verbose": -1}, **extra)
    whole = lgt.train(params, ds, device=cuda).model_to_string()
    assert lgt.train(params, ds, device=cuda).model_to_string() == whole
    ck = dict(params, checkpoint_interval=1,
              checkpoint_dir=str(tmp_path / "ck"))
    faults.arm(3, "raise")
    try:
        with pytest.raises(RuntimeError, match="injected fault"):
            lgt.train(ck, ds, device=cuda)
    finally:
        faults.disarm()
    resumed = lgt.train(ck, ds, device=cuda)
    assert resumed.model_to_string() == whole


# ---- mixed-bin packing, bfloat16 and stochastic rounding on the card


def _mixed_table(rng, n):
    """Continuous columns beside narrow ones (5 values, a flag, 40
    values): a two-class plan (narrow at 64 bins, wide at 254)."""
    cont = rng.randn(n, 4)
    x = np.column_stack([cont[:, 0], rng.randint(0, 5, n), cont[:, 1],
                         rng.randint(0, 40, n), rng.rand(n) < 0.4,
                         cont[:, 2], cont[:, 3]]).astype(np.float64)
    y = (cont[:, 0] - 0.6 * cont[:, 1] + 0.3 * (x[:, 1] - 2) + 0.8 * x[:, 4]
         + 0.03 * (x[:, 3] - 20) + 0.3 * rng.randn(n) > 0)
    return x, y.astype(np.float32)


@pytest.mark.parametrize("C", [1, 8, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int8_sr"])
def test_hist_b64_class_launches_match_plain(cuda, dtype, C):
    """The narrow class's launch at B = 64 on its rows of a packed bin
    matrix, beside the wide class at B = 254, in every mode: the packed
    pass against its plain version on the CPU."""
    from lightgbm_tpu_torch.io.binning import plan_feature_packing
    rng = np.random.RandomState(64 + C)
    F, N = 28, 100_001
    num_bins = np.array([5 + (f * 7) % 60 if f % 7 else 254
                         for f in range(F)], np.int32)
    spec = plan_feature_packing(num_bins, 254)
    assert spec.counts == (24, 4)
    bins = (rng.rand(N, F) * num_bins).astype(np.uint8).T
    bins = np.ascontiguousarray(bins[np.asarray(spec.perm)])
    args = [bins, (rng.randn(N) * 0.4).astype(np.float32),
            (rng.rand(N) * 0.25).astype(np.float32),
            rng.randint(0, C, N).astype(np.int32), rng.rand(N) < 0.85]
    t = lambda a, d: torch.as_tensor(a, device=d)
    before = hist_cuda.launches
    got = histogram_leafbatch(*[t(a, cuda) for a in args], C, 254, dtype,
                              packing=spec, salt=3).cpu().numpy()
    assert hist_cuda.launches == before + 2
    assert list(hist_cuda.launch_cols)[-2:] == [C, C]
    want = histogram_leafbatch(*[t(a, "cpu") for a in args], C, 254, dtype,
                               packing=spec, salt=3).numpy()
    _assert_hist(got, want, "int8" if dtype.startswith("int8") else dtype)


@pytest.mark.parametrize("sstart,scnt", [(0, 60_000), (13, 4097), (1001, 1)])
def test_hist_pane_class_rows_match_plain(cuda, sstart, scnt):
    """The pane entry over one class's bin rows, at that class's width."""
    rng = np.random.RandomState(scnt)
    F, N, P = 28, 60_000, 61_440
    bins = torch.as_tensor(rng.randint(0, 64, (F, N)).astype(np.uint8))
    grad = torch.as_tensor(rng.randn(N).astype(np.float32))
    hess = torch.as_tensor(rng.rand(N).astype(np.float32))
    pane = compact.pack_planes(bins, grad, hess,
                               torch.as_tensor(rng.rand(N) < 0.8), P)
    for first, cnt, width in ((0, 24, 64), (24, 4, 254)):
        got = hist_cuda.hist_pane_float(pane.to(cuda), F, sstart, scnt,
                                        width, (first, cnt)).cpu()
        want = hist_cuda.hist_pane_float(pane, F, sstart, scnt, width,
                                         (first, cnt))
        assert got.shape == (cnt, width, 3)
        _assert_hist(got.numpy(), want.numpy(), "float32")


@pytest.mark.parametrize("policy", [
    {}, {"leafwise_compact": "false"},
    {"grow_policy": "depthwise", "num_leaves": 255}],
    ids=["compacted", "masked", "depthwise"])
def test_packed_int8_trees_equal_uniform_on_card(cuda, policy):
    """mixed_bin=auto packs the table and launches twice a pass; the
    model equals mixed_bin=false's byte for byte."""
    x, y = _mixed_table(np.random.RandomState(11), 30_000)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=255)
    params = dict({"objective": "binary", "num_leaves": 31,
                   "num_iterations": 2, "hist_dtype": "int8",
                   "min_data_in_leaf": 20}, **policy)
    before = hist_cuda.launches
    packed = lgt.train(params, ds, device=cuda)
    n_packed = hist_cuda.launches - before
    assert packed._pack_spec is not None
    uniform = lgt.train(dict(params, mixed_bin="false"), ds, device=cuda)
    n_uniform = hist_cuda.launches - before - n_packed
    assert n_packed == 2 * n_uniform
    assert packed.model_to_string() == uniform.model_to_string()


@pytest.mark.parametrize("policy", [
    {}, {"leafwise_compact": "false"},
    {"grow_policy": "depthwise", "num_leaves": 255}],
    ids=["compacted", "masked", "depthwise"])
def test_int8_sr_trees_equal_on_card_and_cpu(cuda, policy):
    """Stochastic rounding's bits are integer arithmetic on the gradient
    bits: the card's model equals the CPU's byte for byte, packed."""
    x, y = _mixed_table(np.random.RandomState(12), 30_000)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=255)
    params = dict({"objective": "binary", "num_leaves": 31,
                   "num_iterations": 3, "hist_dtype": "int8",
                   "quant_rounding": "stochastic",
                   "min_data_in_leaf": 20}, **policy)
    on_card = lgt.train(params, ds, device=cuda)
    on_cpu = lgt.train(params, ds, device="cpu")
    assert on_card.model_to_string() == on_cpu.model_to_string()


# ------------------------------------------------- 16-bit bins (max_bin > 256)


def _bins16(rng, F, N, B, offset=0):
    """[F, N] 16-bit bins (an int16 view) over 0..B-1, sliced ``offset``
    lanes into wider rows, so rows start off the 16-byte boundary."""
    from lightgbm_tpu_torch.ops.bins import to_tensor
    rows = rng.randint(0, B, (F, N + 2 * offset)).astype(np.uint16)
    rows[:, offset:offset + 5] = B - 1
    return to_tensor(rows, "cpu")[:, offset:offset + N]


@pytest.mark.parametrize("B,C,offset", [
    (1023, 1, 0), (1023, 8, 3), (1023, 42, 0), (1023, 64, 7),
    (50_000, 1, 0), (50_000, 1, 5), (300, 3, 1)])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_hist16_kernel_matches_plain(cuda, dtype, B, C, offset):
    """16-bit bins through the float and int8 modes, accumulators cut
    into cell slices where they pass SLICE_BYTES (B = 1023 at C = 42 and
    64, B = 50,000), rows at unaligned lanes."""
    rng = np.random.RandomState(B + C + offset)
    F, N = 28, 60_001
    bins = _bins16(rng, F, N, B, offset)
    grad = torch.as_tensor((rng.randn(N) * 0.4).astype(np.float32))
    hess = torch.as_tensor((rng.rand(N) * 0.25).astype(np.float32))
    cid = torch.as_tensor(np.where(rng.rand(N) < 0.85,
                                   rng.randint(0, C, N), -1).astype(np.int32))
    if dtype == "int8":
        levels, _ = hist_cuda.quantize_values(grad, hess, cid >= 0)
        got = hist_cuda.hist_int8(bins.to(cuda), levels.to(cuda),
                                  cid.to(cuda), C, B).cpu()
        want = hist_cuda.hist_int8(bins, levels, cid, C, B)
        assert torch.equal(got, want)
    else:
        got = hist_cuda.hist_float(bins.to(cuda), grad.to(cuda),
                                   hess.to(cuda), cid.to(cuda), C, B).cpu()
        want = hist_cuda.hist_float(bins, grad, hess, cid, C, B)
        _assert_hist(got.numpy(), want.numpy(), "float32")


@pytest.mark.parametrize("sstart,scnt,rows", [
    (0, 60_000, None), (13, 4097, None), (1001, 1, None),
    (777, 30_000, (2, 5))])
def test_hist16_pane_matches_plain(cuda, sstart, scnt, rows):
    """The pane entry on a 16-bit pane (low-byte rows, then high-byte
    rows), all bin rows or a class of them."""
    rng = np.random.RandomState(scnt + 16)
    F, N, P, B = 8, 60_000, 61_440, 1023
    bins = _bins16(rng, F, N, B)
    grad = torch.as_tensor(rng.randn(N).astype(np.float32))
    hess = torch.as_tensor(rng.rand(N).astype(np.float32))
    pane = compact.pack_planes(bins, grad, hess,
                               torch.as_tensor(rng.rand(N) < 0.8), P)
    got = hist_cuda.hist_pane_float(pane.to(cuda), F, sstart, scnt, B, rows,
                                    2).cpu()
    want = hist_cuda.hist_pane_float(pane, F, sstart, scnt, B, rows, 2)
    _assert_hist(got.numpy(), want.numpy(), "float32")


@pytest.mark.parametrize("entry", ["hist_float", "hist_pane_float"])
@pytest.mark.parametrize("bits", [8, 16])
def test_float_hist_bitwise_equal_run_to_run(cuda, entry, bits):
    """The float mode's fixed-point sums do not depend on the order of
    the atomics: the same inputs give the same bits on every launch, at
    8- and 16-bit bins, through both float entries, under the tree's
    shared exponent and under each launch's own."""
    rng = np.random.RandomState(bits)
    F, N, C = 28, 200_001, 8
    B = 256 if bits == 8 else 1023
    bins = torch.as_tensor(rng.randint(0, B, (F, N)).astype(np.uint8)) \
        if bits == 8 else _bins16(rng, F, N, B)
    grad = torch.as_tensor((rng.randn(N) * 0.4).astype(np.float32))
    hess = torch.as_tensor((rng.rand(N) * 0.25).astype(np.float32))
    cid = torch.as_tensor(np.where(rng.rand(N) < 0.85, rng.randint(0, C, N),
                                   -1).astype(np.int32))
    g, h = grad.to(cuda), hess.to(cuda)
    tree_e = hist_cuda.fixed_exponent(g, h, N)
    if entry == "hist_float":
        b, c = bins.to(cuda), cid.to(cuda)
        run = lambda e: hist_cuda.hist_float(b, g, h, c, C, B, e)
        want = hist_cuda.hist_float(bins, grad, hess, cid, C, B)
    else:
        P = compact.bucket_table(N)[0]
        pane = compact.pack_planes(bins, grad, hess, cid >= 0, P)
        pc = pane.to(cuda)
        run = lambda e: hist_cuda.hist_pane_float(pc, F, 1001, N - 2000, B,
                                                  None, bits // 8, e)
        want = hist_cuda.hist_pane_float(pane, F, 1001, N - 2000, B, None,
                                         bits // 8)
    for e in (tree_e, None):
        first = run(e).cpu()
        for _ in range(3):
            assert torch.equal(run(e).cpu(), first)
        _assert_hist(first.numpy(), want.numpy(), "float32")


@pytest.mark.parametrize("start,cnt,feat,thr", [
    (0, 60_000, 0, 511), (1001, 30_000, 3, 255), (13, 4083, 5, 256),
    (3, 6 * 4096 - 2, 7, 700), (7, 1, 2, 100), (2048, 20_000, 1, 1022),
    (777, 0, 0, 0)])
def test_partition16_pane_matches_plain(cuda, start, cnt, feat, thr):
    """The partition on a 16-bit key (its low byte in row feat, its high
    byte in row F + feat): byte-exact, every other lane untouched."""
    rng = np.random.RandomState(start + cnt)
    F, N, P = 8, 60_000, 61_440
    bins = _bins16(rng, F, N, 1023)
    pane = compact.pack_planes(bins, torch.as_tensor(
        rng.randn(N).astype(np.float32)), torch.ones(N), torch.ones(
            N, dtype=torch.bool), P)
    dst0 = torch.as_tensor(rng.randint(-128, 128, tuple(pane.shape))
                           .astype(np.int8))
    got, want = dst0.to(cuda), dst0.clone()
    left = compact.partition_pane(pane.to(cuda), got, F, feat, thr, start,
                                  cnt, 2)
    want_left = compact.partition_pane(pane, want, F, feat, thr, start, cnt,
                                       2)
    assert int(left) == int(want_left)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("policy", [
    {}, {"leafwise_compact": "false"},
    {"grow_policy": "depthwise", "num_leaves": 255}],
    ids=["compacted", "masked", "depthwise"])
def test_maxbin_int8_trees_equal_on_card_and_cpu(cuda, policy):
    """max_bin=1023, packed (widths 64 and 1022): the card's int8 model
    equals the CPU's byte for byte, through 16-bit histogram and
    partition launches."""
    x, y = _mixed_table(np.random.RandomState(13), 30_000)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=1023)
    params = dict({"objective": "binary", "num_leaves": 31,
                   "num_iterations": 2, "hist_dtype": "int8",
                   "min_data_in_leaf": 20, "max_bin": 1023}, **policy)
    before = hist_cuda.launches
    on_card = lgt.train(params, ds, device=cuda)
    assert hist_cuda.launches > before
    assert on_card._pack_spec.widths == (64, 1022)
    assert on_card.bins_device.dtype == torch.int16
    on_cpu = lgt.train(params, ds, device="cpu")
    assert on_card.model_to_string() == on_cpu.model_to_string()


def test_maxbin_compacted_equals_masked_on_card(cuda):
    """The compacted grower's 16-bit partition keys on the whole bin: at
    max_bin=1023 it grows the masked grower's int8 trees on the card."""
    x, y = _mixed_table(np.random.RandomState(14), 30_000)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=1023)
    params = {"objective": "binary", "num_leaves": 31, "num_iterations": 2,
              "hist_dtype": "int8", "max_bin": 1023}
    before = compact.launches
    compacted = lgt.train(params, ds, device=cuda)
    assert compact.launches - before == sum(t.num_leaves - 1
                                            for t in compacted.models)
    masked = lgt.train(dict(params, leafwise_compact="false"), ds,
                       device=cuda)
    assert compacted.model_to_string() == masked.model_to_string()


@pytest.fixture(scope="module")
def serving_model():
    """A multiclass (K = 3) port booster trained on the CPU: 2,000 rows,
    8 features, 31 leaves, 6 iterations; and held-out rows with NaN."""
    rng = np.random.RandomState(21)
    x = rng.randn(3_000, 8)
    y = np.digitize(x[:, 0] + 0.5 * x[:, 1], [-0.5, 0.5]).astype(np.float32)
    booster = lgt.train({"objective": "multiclass", "num_class": 3,
                         "num_leaves": 31, "num_iterations": 6},
                        lgt.Dataset.from_arrays(x[:2000], y[:2000]),
                        device="cpu")
    held = x[2000:].copy()
    held[::17, 0] = np.nan
    return booster, held


@pytest.mark.parametrize("quantize", ["float32", "int8"])
def test_serving_engine_on_card_equals_cpu(cuda, serving_model, quantize):
    """Scores and leaf indices on the card are bitwise the CPU engine's:
    the gathers are exact and the f32 adds run in the same order.  A
    small ladder sends the 1,000 rows through several buckets."""
    from lightgbm_tpu_torch import serving
    booster, x = serving_model
    flat = booster.export_flat()
    for buckets in ((1, 32, 1024, 65536), (1, 16, 64)):
        kw = dict(buckets=buckets, quantize=quantize)
        card = serving.ServingEngine(flat, device=cuda, **kw)
        cpu = serving.ServingEngine(flat, device="cpu", **kw)
        for n in (1, 31, 1000):
            np.testing.assert_array_equal(card.scores(x[:n]),
                                          cpu.scores(x[:n]))
            np.testing.assert_array_equal(card.leaf_indices(x[:n]),
                                          cpu.leaf_indices(x[:n]))


def test_serving_front_round_trip_on_card(cuda, serving_model):
    """Requests through a front on the card, a swap to the int8 engine
    in the middle: every request resolves, each bitwise its rows scored
    alone on the engine it met."""
    from lightgbm_tpu_torch import lifecycle, serving
    booster, x = serving_model
    flat = booster.export_flat()
    f32 = serving.ServingEngine(flat, device=cuda, linger_us=500)
    i8 = serving.ServingEngine(flat, device=cuda, quantize="int8")
    with serving.ServingFront(f32) as front:
        before = [front.submit(x[i:i + 7]) for i in range(0, 350, 7)]
        front.swap_engine(i8, timeout=60)
        after = [front.submit(x[i:i + 7]) for i in range(350, 700, 7)]
        got_before = [f.result(60) for f in before]
        got_after = [f.result(60) for f in after]
    assert not lifecycle.tracked(front)
    for i, got in zip(range(0, 350, 7), got_before):
        np.testing.assert_array_equal(got, f32.scores(x[i:i + 7]))
    for i, got in zip(range(350, 700, 7), got_after):
        np.testing.assert_array_equal(got, i8.scores(x[i:i + 7]))


@pytest.mark.parametrize("shards", [2, 3, 4])
@pytest.mark.parametrize("quantize", ["float32", "int8"])
def test_sharded_serving_on_card(cuda, serving_model, quantize, shards):
    """Tree shards on the one card (a device list): every block's tables
    there, scores and leaf indices bitwise the card's one-device engine's
    and the CPU sharded engine's, and no kernel launch."""
    from lightgbm_tpu_torch import serving
    booster, x = serving_model
    flat = booster.export_flat()
    card = serving.ServingEngine(flat, quantize=quantize, shards=shards,
                                 device=[cuda] * shards)
    one = serving.ServingEngine(flat, quantize=quantize, device=cuda)
    cpu = serving.ServingEngine(flat, quantize=quantize, shards=shards,
                                device="cpu")
    before = (hist_cuda.launches, compact.launches)
    for n in (1, 31, 1000):
        got = card.scores(x[:n])
        np.testing.assert_array_equal(got, one.scores(x[:n]))
        np.testing.assert_array_equal(got, cpu.scores(x[:n]))
        np.testing.assert_array_equal(card.leaf_indices(x[:n]),
                                      cpu.leaf_indices(x[:n]))
    assert (hist_cuda.launches, compact.launches) == before
    assert all(t["sf"].is_cuda for t in card._device_tables())


@pytest.mark.parametrize("quantize", ["float32", "int8"])
def test_scan_serving_on_card(cuda, serving_model, quantize):
    """``algo="scan"`` on the card: scores and leaf indices bitwise the
    breadth-first engine's and the CPU scan engine's."""
    from lightgbm_tpu_torch import serving
    booster, x = serving_model
    flat = booster.export_flat()
    scan = serving.ServingEngine(flat, quantize=quantize, algo="scan",
                                 device=cuda)
    bfs = serving.ServingEngine(flat, quantize=quantize, device=cuda)
    cpu = serving.ServingEngine(flat, quantize=quantize, algo="scan",
                                device="cpu")
    for n in (1, 1000):
        got = scan.scores(x[:n])
        np.testing.assert_array_equal(got, bfs.scores(x[:n]))
        np.testing.assert_array_equal(got, cpu.scores(x[:n]))
        np.testing.assert_array_equal(scan.leaf_indices(x[:n]),
                                      bfs.leaf_indices(x[:n]))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("depth", [0, 2])
def test_device_row_writer_on_card(cuda, depth, dtype):
    """The streamed feed on the card: chunks of 4,099 columns and an odd
    tail through ``depth`` pinned staging buffers, 8- and 16-bit bins;
    the matrix equals the host one once ``finish`` orders the training
    stream after the copies (no host synchronize before the read)."""
    from lightgbm_tpu_torch.io.streaming import DeviceRowWriter
    rng = np.random.RandomState(depth + 7)
    F, N = 28, 50_001
    hi = 256 if dtype == np.uint8 else 65536
    want = rng.randint(0, hi, (F, N)).astype(dtype)
    w = DeviceRowWriter(F, N, dtype, cuda, depth=depth)
    for s in range(0, N, 4_099):
        w.append(np.ascontiguousarray(want[:, s:s + 4_099]), s)
    got = w.finish()
    # a kernel on the training stream sees every chunk
    total = int(got.to(torch.int64).sum().item()) if dtype == np.uint8 \
        else int((got.to(torch.int64) & 0xFFFF).sum().item())
    assert total == int(want.astype(np.int64).sum())
    host = got.cpu().numpy()
    if dtype == np.uint16:
        host = host.view(np.uint16)
    np.testing.assert_array_equal(host, want)
    assert w.h2d_bytes == want.nbytes
    assert w.wait_s >= 0.0 and w.hidden_s >= 0.0


def test_streamed_load_on_card_equals_resident(cuda, tmp_path):
    """A text file streamed onto the card (serial and with 2 workers):
    the resident dataset; the packed device gather equals the host
    gather of the resident booster; and under mixed_bin=auto a streamed
    load trains the resident model text in int8 (order-free int32 sums:
    the float mode's f32 atomics make its text differ from run to run
    on the card)."""
    from lightgbm_tpu_torch.config import IOConfig
    from lightgbm_tpu_torch.io import parallel_ingest
    rng = np.random.RandomState(3)
    n = 60_000
    x = rng.randn(n, 6)
    x[:, 4] = rng.randint(0, 5, n)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(int)
    path = str(tmp_path / "s.csv")
    with open(path, "w") as f:
        for i in range(n):
            f.write("%d,%s\n" % (y[i], ",".join("%.6f" % v for v in x[i])))
    resident = lgt.Dataset.load_train(IOConfig(data_filename=path,
                                               streaming="false"))
    try:
        for workers in (1, 2):
            ds = lgt.Dataset.load_train(
                IOConfig(data_filename=path, streaming="true",
                         ingest_chunk_rows=7_001, ingest_workers=workers),
                device=cuda)
            assert ds.device_bins.is_cuda and ds.bins is None
            np.testing.assert_array_equal(ds.read_bins(), resident.bins)
    finally:
        parallel_ingest.shutdown_workers()
    from lightgbm_tpu_torch.config import OverallConfig
    from lightgbm_tpu_torch.objectives import create_objective
    params = {"objective": "binary", "num_leaves": 31, "num_iterations": 2,
              "mixed_bin": "auto", "hist_dtype": "int8"}
    packed_host = lgt.GBDT()
    cfg = OverallConfig()
    cfg.set({k: str(v) for k, v in params.items()}, require_data=False)
    packed_host.init(cfg.boosting_config, resident,
                     create_objective(cfg.objective_type,
                                      cfg.objective_config), device=cuda)
    assert packed_host._pack_spec is not None
    packed_dev = lgt.GBDT()
    packed_dev.init(cfg.boosting_config, ds,
                    create_objective(cfg.objective_type,
                                     cfg.objective_config), device=cuda)
    assert torch.equal(packed_dev.bins_device, packed_host.bins_device)
    assert ds.device_bins_consumed
    want = lgt.train(params, resident, device=cuda).model_to_string()
    again = lgt.Dataset.load_train(IOConfig(data_filename=path,
                                            streaming="true"), device=cuda)
    assert lgt.train(params, again, device=cuda).model_to_string() == want


# ---- observability on the card


@pytest.mark.parametrize("extra", [
    {},
    {"leafwise_compact": "false"},
    {"grow_policy": "depthwise", "hist_dtype": "int8"},
], ids=["compacted_float32", "masked_float32", "depthwise_int8"])
def test_armed_training_on_card(cuda, tmp_path, extra):
    """chip_smoke.py phase 14 (a), (b) and (d) at a small size: armed
    (sink, fence, memory gauges, health) the model text is byte-equal to
    the unarmed run's; the summary's ``hist/cuda_*`` counters sum to the
    histogram launches and ``partition/cuda`` equals the partition
    launches, with no plain route; the memory block reads the card's
    allocator, its peak between the bin matrix and the allocator's own
    peak."""
    import json
    from lightgbm_tpu_torch import lifecycle
    rng = np.random.RandomState(17)
    x = rng.randn(50_000, 12)
    y = (x[:, 0] - x[:, 1] + 0.4 * rng.randn(50_000) > 0).astype(np.float32)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=255)
    params = dict({"objective": "binary", "num_leaves": 63,
                   "num_iterations": 3, "verbose": -1}, **extra)
    plain = lgt.train(params, ds, device=cuda).model_to_string()
    sink = tmp_path / "m.jsonl"
    h0, p0 = hist_cuda.launches, compact.launches
    armed = lgt.train(dict(params, metrics_out=str(sink),
                           metrics_fence="true", memory_stats="true",
                           health="true"), ds, device=cuda)
    assert armed.model_to_string() == plain
    recs = [json.loads(line) for line in open(sink)]
    summary = recs[-1]
    assert summary["summary"] and len([r for r in recs if "iter" in r]) == 3
    ctr = summary["counters"]
    assert sum(v for k, v in ctr.items() if k.startswith("hist/cuda_")) \
        == hist_cuda.launches - h0 > 0
    assert ctr.get("partition/cuda", 0) == compact.launches - p0
    assert not any("plain" in k for k in ctr)
    mem = summary["memory"]
    assert mem["source"] == "device"
    assert ds.num_data * ds.num_features <= mem["peak_bytes_in_use"] \
        <= torch.cuda.max_memory_allocated()
    assert lifecycle.leaks() == []


def test_fence_times_device_work_on_card(cuda):
    """A fenced span waits on the stream, so it times the device work
    queued inside it (CUDA events bound it from below); unfenced, the
    same span closes after the host's enqueue, long before the work
    ends."""
    from lightgbm_tpu_torch import telemetry
    cycles = 200_000_000                    # about 0.1 s of sleep
    telemetry.set_device(cuda)
    try:
        for fence in (True, False):
            telemetry.enable(fence=fence)
            telemetry.reset()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            with telemetry.span("histogram") as sp:
                start.record()
                torch.cuda._sleep(cycles)
                end.record()
                sp.fence(torch.zeros(1, device=cuda))
            span_s = telemetry.snapshot()["phase_times"]["histogram"]
            torch.cuda.synchronize()
            device_s = start.elapsed_time(end) / 1e3
            if fence:
                assert span_s >= device_s > 0.01
            else:
                assert span_s < 0.5 * device_s
    finally:
        telemetry.disable()
        telemetry.reset()
        telemetry.set_device(None)


# one rank of a card world: train the spec's jobs on this rank's row draw
# of the arrays (learners.row_shard: its own shard under tree_learner=data,
# its data index's under hybrid and voting) and write each model text and
# the backend
PARALLEL_WORKER = r'''
import json, sys
import numpy as np
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import parallel
from lightgbm_tpu_torch.config import OverallConfig
from lightgbm_tpu_torch.parallel import learners

spec = json.load(open(sys.argv[1]))
parallel.init_distributed()
x, y = np.load(spec["x"]), np.load(spec["y"])
sets, out = {}, {}
for name, params in spec["jobs"].items():
    cfg = OverallConfig()
    cfg.set({k: str(v) for k, v in params.items()}, require_data=False)
    shard = learners.row_shard(cfg)
    if shard not in sets:
        sets[shard] = lgt.Dataset.from_arrays(
            x, y, max_bin=63, rank=shard[0], num_machines=shard[1])
    ds = sets[shard]
    booster = lgt.train(params, ds, device="cuda")
    out[name] = {"model": booster.model_to_string(),
                 "backend": booster._learner.comm.backend,
                 "world": booster._learner.world, "rows": ds.num_data}
json.dump(out, open(spec["out"] % parallel.get_rank(), "w"))
parallel.shutdown()
'''


def _card_world(tmp_path, nprocs, jobs, x, y):
    """The jobs in a world of ``nprocs`` ranks on the card (parallel/
    launch.LocalWorld, killed past 120 s): [rank] -> {job: record}."""
    import json
    import os
    import sys
    from lightgbm_tpu_torch.parallel.launch import LocalWorld
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", y)
    spec = {"x": str(tmp_path / "x.npy"), "y": str(tmp_path / "y.npy"),
            "jobs": jobs, "out": str(tmp_path / "out.%d.json")}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    (tmp_path / "worker.py").write_text(PARALLEL_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    ranks = LocalWorld([sys.executable, "worker.py", "spec.json"], nprocs,
                       str(tmp_path), 120, env).wait()
    for r, (rc, out) in enumerate(ranks):
        assert rc == 0, "rank %d failed:\n%s" % (r, out[-4000:])
    return [json.load(open(spec["out"] % r)) for r in range(nprocs)]


_DP_PARAMS = {"objective": "binary", "num_leaves": 31, "num_iterations": 3,
              "min_data_in_leaf": 20, "max_bin": 63,
              "tree_learner": "data", "num_machines": 2}


def _dp_table():
    rng = np.random.RandomState(13)
    x = rng.randn(20_000, 10).astype(np.float32)
    y = ((x[:, 0] - 0.5 * x[:, 1] + 0.3 * rng.randn(20_000)) > 0)
    return x.astype(np.float64), y.astype(np.float32)


def test_one_rank_nccl_world_is_serial(cuda, tmp_path):
    """(a) A one-rank world on the card takes NCCL, and tree_learner=data
    there trains the serial run's model text (float32, compacted)."""
    x, y = _dp_table()
    ranks = _card_world(tmp_path, 1, {"f32": _DP_PARAMS}, x, y)
    rec = ranks[0]["f32"]
    assert (rec["backend"], rec["world"]) == ("nccl", 1)
    serial = lgt.train({k: v for k, v in _DP_PARAMS.items()
                        if k not in ("tree_learner", "num_machines")},
                       lgt.Dataset.from_arrays(x, y, max_bin=63),
                       device="cuda")
    assert rec["model"] == serial.model_to_string()


def test_two_ranks_share_the_card_over_gloo(cuda, tmp_path):
    """(b) Two ranks on the one card take gloo; int8 under both schedules
    is the serial run's model text, float32's structure is serial's and
    its leaf values within rtol 1e-5 / atol 5e-6; both ranks agree."""
    x, y = _dp_table()
    jobs = {"%s_%s" % (d, s): dict(_DP_PARAMS, hist_dtype=d, dp_schedule=s)
            for d in ("int8", "float32") for s in ("psum", "reduce_scatter")}
    ranks = _card_world(tmp_path, 2, jobs, x, y)
    full = lgt.Dataset.from_arrays(x, y, max_bin=63)
    for d in ("int8", "float32"):
        serial = lgt.train({k: v for k, v in dict(_DP_PARAMS,
                                                  hist_dtype=d).items()
                            if k not in ("tree_learner", "num_machines")},
                           full, device="cuda")
        for s in ("psum", "reduce_scatter"):
            recs = [r["%s_%s" % (d, s)] for r in ranks]
            assert recs[0]["model"] == recs[1]["model"]
            assert all((r["backend"], r["world"]) == ("gloo", 2)
                       for r in recs)
            if d == "int8":
                assert recs[0]["model"] == serial.model_to_string()
                continue
            got = lgt.GBDT()
            got.models_from_string(recs[0]["model"])
            for ta, tb in zip(got.models, serial.models):
                np.testing.assert_array_equal(ta.split_feature_real,
                                              tb.split_feature_real)
                np.testing.assert_array_equal(ta.threshold, tb.threshold)
                np.testing.assert_allclose(ta.leaf_value, tb.leaf_value,
                                           rtol=1e-5, atol=5e-6)


def _serial_text(params, x, y):
    """The serial run's model text on the card of a parallel job's
    parameters."""
    serial = {k: v for k, v in params.items()
              if k not in ("tree_learner", "num_machines", "feature_shards",
                           "top_k")}
    return lgt.train(serial, lgt.Dataset.from_arrays(x, y, max_bin=63),
                     device="cuda").model_to_string()


def test_hybrid_four_ranks_share_the_card(cuda, tmp_path):
    """Four ranks on a 2 x 2 grid (tree_learner=hybrid) share the card
    over gloo: compacted int8 is the serial run's model text on every
    rank, and the ranks of one feature group hold the same rows."""
    x, y = _dp_table()
    params = dict(_DP_PARAMS, hist_dtype="int8", tree_learner="hybrid",
                  num_machines=4, feature_shards=2)
    ranks = _card_world(tmp_path, 4, {"hybrid": params}, x, y)
    recs = [r["hybrid"] for r in ranks]
    assert all((r["backend"], r["world"]) == ("gloo", 4) for r in recs)
    assert len({r["model"] for r in recs}) == 1
    assert recs[0]["model"] == _serial_text(params, x, y)
    rows = [r["rows"] for r in recs]
    assert rows[0] == rows[1] and rows[2] == rows[3]
    assert rows[0] + rows[2] == len(y)


def test_voting_exact_regime_on_card(cuda, tmp_path):
    """Four ranks, tree_learner=voting on a 4 x 1 grid with top_k=20 (2 x
    top_k covers the 10 features: the exact regime): int8 compacted and
    depth-wise are the serial run's model text; float32 compacted keeps
    the serial run's structure, leaf values within rtol 1e-5 / atol
    5e-6; every rank agrees."""
    x, y = _dp_table()
    base = dict(_DP_PARAMS, tree_learner="voting", num_machines=4)
    jobs = {"int8": dict(base, hist_dtype="int8"),
            "int8_depthwise": dict(base, hist_dtype="int8",
                                   grow_policy="depthwise"),
            "float32": dict(base, hist_dtype="float32")}
    ranks = _card_world(tmp_path, 4, jobs, x, y)
    for name, params in jobs.items():
        recs = [r[name] for r in ranks]
        assert len({r["model"] for r in recs}) == 1, name
        assert all((r["backend"], r["world"]) == ("gloo", 4) for r in recs)
        want = _serial_text(params, x, y)
        if name.startswith("int8"):
            assert recs[0]["model"] == want, name
            continue
        got, serial = lgt.GBDT(), lgt.GBDT()
        got.models_from_string(recs[0]["model"])
        serial.models_from_string(want)
        for ta, tb in zip(got.models, serial.models):
            np.testing.assert_array_equal(ta.split_feature_real,
                                          tb.split_feature_real)
            np.testing.assert_array_equal(ta.threshold, tb.threshold)
            np.testing.assert_allclose(ta.leaf_value, tb.leaf_value,
                                       rtol=1e-5, atol=5e-6)
