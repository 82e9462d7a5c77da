"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither JAX nor the JAX
package, so it runs where only PyTorch for CUDA is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the float histogram adds f32 values with atomics in a
run-dependent order, so it agrees with the plain ``index_add_`` to f32
reordering (rtol 1e-5, atol 1e-4 for cells that cancel to near zero);
counts, the int8 histogram, the partition and the int8 trees are exact.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import compact
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
    (0, 10240), (0, 8192), (1023, 4097), (77, 0), (2048, 5000)])
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
