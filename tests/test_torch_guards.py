"""Guards of the port's boundaries: it never imports the JAX package, it
never runs on the CPU unasked, it refuses what it does not run, and its
kernels build for sm_90a into a git-ignored directory."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import cuda_build
from lightgbm_tpu_torch.utils import log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "lightgbm_tpu_torch")


def _port_sources():
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "lightgbm_tpu")


def test_no_jax_or_reference_imports():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += ["%s: %s" % (os.path.relpath(path, REPO), n)
                          for n in names if _forbidden(n)]
    assert not offenders, offenders


def _port_modules():
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        if rel.startswith("lightgbm_tpu_torch") and \
                not rel.endswith("__main__"):
            yield rel[:-len(".__init__")] if rel.endswith("__init__") \
                else rel


def test_imports_with_jax_blocked():
    mods = sorted(_port_modules())
    assert "lightgbm_tpu_torch.ops.hist_cuda" in mods
    code = ("import sys\n"
            "for m in [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'lightgbm_tpu')]:\n"
            "    del sys.modules[m]\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['lightgbm_tpu'] = None\n"
            "import importlib\n"
            "for m in %r:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n" % (mods,))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    x = np.random.RandomState(0).randn(200, 3)
    ds = lgt.Dataset.from_arrays(x, (x[:, 0] > 0).astype(np.float32))
    with pytest.raises(log.Fatal, match="no CUDA device"):
        lgt.train({"objective": "binary", "num_iterations": 1}, ds)
    with pytest.raises(log.Fatal, match="no CUDA device"):
        lgt.train({"objective": "binary", "num_iterations": 1}, ds,
                  device="cuda")


@pytest.mark.parametrize("key,value", [
    ("objective", "regression"), ("grow_policy", "depthwise"),
    ("leafwise_compact", "false"), ("tree_learner", "data"),
    ("num_machines", "4"), ("bagging_fraction", "0.5"),
    ("feature_fraction", "0.8"), ("goss", "true"),
    ("hist_dtype", "bfloat16"), ("quant_rounding", "stochastic"),
    ("mixed_bin", "true"), ("streaming", "true"),
    ("checkpoint_interval", "5"), ("metrics_out", "m.jsonl"),
    ("metric", "auc,l2"), ("early_stopping_round", "3"),
])
def test_out_of_slice_config_is_fatal(key, value):
    cfg = lgt.OverallConfig()
    with pytest.raises(log.Fatal, match=key):
        cfg.set({"objective": "binary", key: value}, require_data=False)


def test_slice_defaults_accepted():
    cfg = lgt.OverallConfig()
    cfg.set({"objective": "binary", "grow_policy": "leafwise",
             "tree_learner": "serial", "bagging_fraction": "1.0",
             "leafwise_compact": "auto", "num_trees": "7",
             "min_data": "3", "hist_dtype": "int8"}, require_data=False)
    assert cfg.boosting_config.num_iterations == 7
    assert cfg.boosting_config.tree_config.min_data_in_leaf == 3
    assert cfg.boosting_config.tree_config.hist_dtype == "int8"


def test_cpu_tensor_takes_plain_version_only():
    """A CPU tensor never reaches the kernel library (none is built or
    loaded here) and never counts as a kernel launch."""
    from lightgbm_tpu_torch.ops import compact, hist_cuda
    before = (hist_cuda.launches, compact.launches)
    bins = torch.zeros((2, 10), dtype=torch.uint8)
    hist_cuda.hist_float(bins, torch.ones(10), torch.ones(10),
                         torch.zeros(10, dtype=torch.int32), 1, 4)
    seg = torch.zeros((8, 2048), dtype=torch.int8)
    mask = torch.full((2048,), -1, dtype=torch.int8)
    compact.partition_segment(seg, mask, 0, 0, 0)
    assert (hist_cuda.launches, compact.launches) == before
    assert not cuda_build._libs


def test_nvcc_command_targets_sm90a_in_ignored_dir(monkeypatch):
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "nvcc")
    for name in cuda_build.SOURCES:
        out = cuda_build.library_path(name)
        cmd = cuda_build.nvcc_command(name, out)
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert cmd[cmd.index("-o") + 1] == out
        assert os.path.dirname(out) == cuda_build.BUILD_DIR
        assert os.path.exists(os.path.join(cuda_build.CSRC_DIR,
                                           name + ".cu"))
    rel = os.path.relpath(cuda_build.BUILD_DIR, REPO).replace(os.sep, "/")
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = {ln.strip().rstrip("/") for ln in f}
    assert rel in ignored


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card_or_package(tmp_path, alone):
    """chip_smoke.py prints no result and exits nonzero without a CUDA
    device, or when it stands in a directory without the package."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA device is present")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        cwd = str(tmp_path)
        with open(script) as src, open(tmp_path / "chip_smoke.py", "w") as f:
            f.write(src.read())
        script = str(tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, script], cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
