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


def test_parallel_modules_are_guarded():
    """The parallel learners' modules are among the sources scanned above
    and imported with JAX blocked below."""
    mods = set(_port_modules())
    assert {"lightgbm_tpu_torch.parallel", "lightgbm_tpu_torch.parallel.mesh",
            "lightgbm_tpu_torch.parallel.learners"} <= mods


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
    assert {"lightgbm_tpu_torch.objectives.rank",
            "lightgbm_tpu_torch.objectives.multiclass",
            "lightgbm_tpu_torch.objectives.regression",
            "lightgbm_tpu_torch.metrics.dcg"} <= set(mods)
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
    # every objective, and a multiclass model file, asks for the card
    qds = lgt.Dataset.from_arrays(x, (x[:, 0] > 0).astype(np.float32),
                                  query_boundaries=[0, 50, 120, 200])
    for params in ({"objective": "regression"},
                   {"objective": "multiclass", "num_class": 2},
                   {"objective": "lambdarank"}):
        with pytest.raises(log.Fatal, match="no CUDA device"):
            lgt.train(dict(params, num_iterations=1), qds)


# the other keys a case needs (a grid of ranks of the hybrid learner;
# GOSS over it, whose rates are still checked)
CASE_CONTEXT = {("feature_shards", "3"): {"tree_learner": "hybrid",
                                          "num_machines": "4"},
                ("other_rate", "0"): {"tree_learner": "hybrid",
                                      "num_machines": "4", "goss": "true"}}


@pytest.mark.parametrize("key,value", [
    ("objective", "huber"), ("grow_policy", "levelwise"),
    ("leafwise_compact", "maybe"), ("feature_shards", "-1"),
    ("num_machines", "0"), ("boosting_type", "dart"),
    ("predict_leaf_index", "maybe"), ("is_save_binary_file", "maybe"),
    ("max_bin", "0"), ("quant_rounding", "dither"),
    ("mixed_bin", "sometimes"), ("streaming", "sometimes"),
    ("checkpoint_interval", "-1"), ("timeline", "sometimes"),
    ("metric", "auc,map"), ("pipeline", "readback"),
    ("is_pre_partition", "maybe"), ("save_binary_format", "parquet"),
    ("ingest_workers", "0"), ("ingest_chunk_rows", "0"),
    ("use_two_round_loading", "often"), ("checkpoint_keep", "0"),
    ("elastic_shrink", "true"), ("top_k", "0"),
    ("feature_shards", "3"), ("other_rate", "0"), ("straggler_k", "0"),
    ("dp_schedule", "ring"), ("time_out", "0"),
])
def test_out_of_slice_config_is_fatal(key, value):
    cfg = lgt.OverallConfig()
    with pytest.raises(log.Fatal, match=key):
        cfg.set(dict({"objective": "binary"},
                     **CASE_CONTEXT.get((key, value), {}), **{key: value}),
                require_data=False)


INGEST_KEYS = [
    {},
    {"label_column": "name:y", "weight_column": "3",
     "group_column": "name:q", "ignore_column": "name:a,b",
     "use_two_round_loading": "true", "is_save_binary_file": "true",
     "save_binary_format": "Reference", "streaming": "TRUE",
     "ingest_chunk_rows": "5000", "ingest_workers": "3",
     "num_threads": "4", "is_enable_sparse": "false",
     "is_pre_partition": "false"},
    {"label": "0", "weight": "1", "query": "2", "blacklist": "4,5",
     "two_round": "true", "save_binary": "true", "nthread": "2",
     "is_sparse": "true", "streaming": "auto", "ingest_workers": "auto"},
    {"group": "name:g", "ignore_feature": "1", "query_column": "7",
     "two_round_loading": "false", "is_save_binary": "false",
     "num_thread": "0", "streaming": "false"},
]


@pytest.mark.parametrize("params", INGEST_KEYS,
                         ids=["defaults", "canonical", "aliases",
                              "more-aliases"])
def test_ingest_keys_take_jax_values(params):
    """The ingest keys and their aliases take the JAX package's defaults
    and values (lightgbm_tpu/config.py:67-82, 256-285, 439-477)."""
    from lightgbm_tpu.config import OverallConfig as JConfig
    params = dict({"objective": "binary"}, **params)
    j, t = JConfig(), lgt.OverallConfig()
    j.set(dict(params), require_data=False)
    t.set(dict(params), require_data=False)
    assert t.num_threads == j.num_threads
    for key in ("label_column", "weight_column", "group_column",
                "ignore_column", "use_two_round_loading",
                "is_save_binary_file", "save_binary_format", "streaming",
                "ingest_chunk_rows", "ingest_workers", "is_enable_sparse"):
        assert getattr(t.io_config, key) == getattr(j.io_config, key), key


@pytest.mark.parametrize("params,message", [
    ({"ingest_workers": "-2"}, "ingest_workers should be > 0"),
    ({"ingest_chunk_rows": "-1"}, "ingest_chunk_rows should be > 0"),
    ({"streaming": "yes"}, "streaming must be auto, true or false"),
    ({"save_binary_format": "csv"}, "save_binary_format must be"),
    ({"two_round": "x"}, "use_two_round_loading should be"),
    ({"num_threads": "many"}, "num_threads should be int"),
], ids=["workers", "chunk", "streaming", "format", "two-round", "threads"])
def test_ingest_key_fault_is_jax_fatal(params, message):
    from lightgbm_tpu.config import OverallConfig as JConfig
    from lightgbm_tpu.utils import log as jlog
    params = dict({"objective": "binary"}, **params)
    with pytest.raises(jlog.LightGBMError, match=message) as want:
        JConfig().set(dict(params), require_data=False)
    with pytest.raises(log.Fatal, match=message) as got:
        lgt.OverallConfig().set(dict(params), require_data=False)
    assert str(got.value) == str(want.value)


def test_ingest_modules_scanned_and_worker_imports_no_torch():
    """The ingest layer's modules are among the scanned sources (no JAX,
    no JAX package), and an exec'd parse worker's imports leave torch
    out."""
    rel = {os.path.relpath(p, REPO) for p in _port_sources()}
    for name in ("native/lib.py", "native/__init__.py", "io/streaming.py",
                 "io/parallel_ingest.py", "io/parser.py", "io/dataset.py"):
        assert os.path.join("lightgbm_tpu_torch", name) in rel, name
    with open(os.path.join(PKG, "native", "lgbm_native.cpp")) as f:
        assert "lightgbm_tpu/native/lib.py" not in f.read()
    from lightgbm_tpu_torch.io import parallel_ingest
    code = ("import sys\n"
            "import lightgbm_tpu_torch.io.parallel_ingest as pi\n"
            "import lightgbm_tpu_torch.native.lib\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'lightgbm_tpu')]\n"
            "print('clean' if not bad else bad)\n")
    env = dict(os.environ, **{parallel_ingest.WORKER_ENV: "1"})
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "clean", (
        out.stdout, out.stderr)


def test_native_build_goes_to_ignored_dir():
    from lightgbm_tpu_torch.native import lib as native_lib
    assert os.path.dirname(native_lib.library_path()) == \
        cuda_build.BUILD_DIR
    assert native_lib.FLAGS[:4] == ["-O3", "-fopenmp", "-shared", "-fPIC"]


def test_slice_defaults_accepted():
    cfg = lgt.OverallConfig()
    cfg.set({"objective": "binary", "grow_policy": "leafwise",
             "tree_learner": "serial", "bagging_fraction": "1.0",
             "leafwise_compact": "auto", "num_trees": "7",
             "min_data": "3", "hist_dtype": "int8"}, require_data=False)
    assert cfg.boosting_config.num_iterations == 7
    assert cfg.boosting_config.tree_config.min_data_in_leaf == 3
    assert cfg.boosting_config.tree_config.hist_dtype == "int8"
    assert cfg.boosting_config.tree_config.policy == "leafcompact"
    # every growth policy of the JAX package; depthwise wins whatever
    # leafwise_compact says; hist_chunk and leafwise_segments (bench.py
    # passes both) are accepted and change nothing
    for extra, policy in (
            ({"leafwise_compact": "true"}, "leafcompact"),
            ({"leafwise_compact": "false"}, "leafwise"),
            ({"grow_policy": "depthwise"}, "depthwise"),
            ({"grow_policy": "depthwise", "leafwise_compact": "false"},
             "depthwise"),
            ({"grow_policy": "Depthwise", "hist_chunk": "65536",
              "leafwise_segments": "4"}, "depthwise")):
        cfg = lgt.OverallConfig()
        cfg.set(dict({"objective": "binary"}, **extra), require_data=False)
        assert cfg.boosting_config.tree_config.policy == policy, extra


@pytest.mark.parametrize("key,value,field,want", [
    ("hist_dtype", "bfloat16", "compute_dtype", "bfloat16"),
    ("quant_rounding", "stochastic", "compute_dtype", "int8_sr"),
    ("mixed_bin", "true", "mixed_bin", "true")])
def test_histogram_mode_keys_accepted(key, value, field, want):
    """The histogram's modes and layout run since the mixed-bin slice
    (stochastic rounding with hist_dtype=int8)."""
    cfg = lgt.OverallConfig()
    cfg.set({"objective": "binary", "hist_dtype": "int8", key: value},
            require_data=False)
    assert getattr(cfg.boosting_config.tree_config, field) == want


@pytest.mark.parametrize("key,value", [
    ("hist_chunk", "-1"), ("leafwise_segments", "0"),
    ("hist_chunk", "big"), ("num_class", "0"), ("max_position", "0"),
    ("label_gain", "0,1,x"), ("ndcg_eval_at", "0,3")])
def test_invalid_tuning_knob_is_fatal(key, value):
    cfg = lgt.OverallConfig()
    with pytest.raises(log.Fatal, match=key):
        cfg.set({"objective": "binary", key: value}, require_data=False)


SAMPLING_FAULTS = [
    ({"bagging_fraction": "0"}, "bagging_fraction should be in"),
    ({"bagging_fraction": "1.5"}, "bagging_fraction should be in"),
    ({"sub_row": "-0.1"}, "bagging_fraction should be in"),
    ({"bagging_freq": "-1"}, "bagging_freq should be >= 0"),
    ({"bagging_freq": "often"}, "bagging_freq should be int"),
    ({"bagging_seed": "x"}, "bagging_seed should be int"),
    ({"bagging_device": "gpu"}, "bagging_device must be"),
    ({"feature_fraction": "0"}, "feature_fraction should be in"),
    ({"sub_feature": "1.01"}, "feature_fraction should be in"),
    ({"feature_fraction_seed": "1.5"}, "feature_fraction_seed should be"),
    ({"goss": "yes"}, "goss should be"),
    ({"goss": "true", "top_rate": "1.0"}, "top_rate should be in"),
    ({"goss": "true", "top_rate": "-0.1"}, "top_rate should be in"),
    ({"goss": "true", "other_rate": "0"}, "other_rate should be in"),
    ({"goss": "true", "top_rate": "0.6", "other_rate": "0.5"},
     "top_rate \\+ other_rate"),
    ({"goss": "true", "bagging_fraction": "0.8", "bagging_freq": "1"},
     "Cannot use bagging in GOSS mode"),
    ({"early_stopping_round": "-1"}, "early_stopping_round should be"),
    ({"early_stopping_rounds": "x"}, "early_stopping_round should be"),
]


@pytest.mark.parametrize("params,message", SAMPLING_FAULTS,
                         ids=[" ".join("%s=%s" % kv for kv in p.items())
                              for p, _ in SAMPLING_FAULTS])
def test_sampling_key_fault_is_jax_fatal(params, message):
    """Each invalid sampling or early-stopping value is a Fatal, with the
    JAX package's message (lightgbm_tpu/config.py:640-644, 794-804,
    830-845)."""
    from lightgbm_tpu.config import OverallConfig as JConfig
    from lightgbm_tpu.utils import log as jlog
    params = dict({"objective": "binary"}, **params)
    with pytest.raises(jlog.LightGBMError, match=message) as want:
        JConfig().set(dict(params), require_data=False)
    with pytest.raises(log.Fatal, match=message) as got:
        lgt.OverallConfig().set(dict(params), require_data=False)
    assert str(got.value) == str(want.value)


def test_sampling_keys_accepted():
    """The sampling, early-stopping and init-score keys and their aliases
    take the JAX package's defaults and values."""
    from lightgbm_tpu.config import OverallConfig as JConfig
    for params in ({}, {"sub_feature": "0.8", "sub_row": "0.7",
                        "bagging_freq": "5", "bagging_seed": "11",
                        "feature_fraction_seed": "7",
                        "bagging_device": "TRUE",
                        "early_stopping_rounds": "4",
                        "init_score": "train.init"},
                   {"goss": "true", "top_rate": "0.3", "other_rate": "0.2",
                    "early_stopping": "2"}):
        params = dict({"objective": "binary"}, **params)
        j, t = JConfig(), lgt.OverallConfig()
        j.set(dict(params), require_data=False)
        t.set(dict(params), require_data=False)
        jb, tb = j.boosting_config, t.boosting_config
        for key in ("bagging_fraction", "bagging_freq", "bagging_seed",
                    "bagging_device", "early_stopping_round", "goss",
                    "top_rate", "other_rate"):
            assert getattr(tb, key) == getattr(jb, key), (params, key)
        for key in ("feature_fraction", "feature_fraction_seed"):
            assert getattr(tb.tree_config, key) \
                == getattr(jb.tree_config, key), (params, key)
        assert t.io_config.input_init_score == j.io_config.input_init_score


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


@pytest.mark.parametrize("params,message", [
    ({"objective": "multiclass"}, "number of class"),
    ({"objective": "multiclass", "num_class": "1"}, "number of class"),
    ({"objective": "regression", "num_class": "3"}, "Number of class"),
    ({"objective": "binary", "num_class": "2"}, "Number of class"),
    ({"objective": "binary", "metric": "multi_logloss"}, "don't match"),
    ({"objective": "multiclass", "num_class": "3", "metric": "auc"},
     "don't match"),
    ({"objective": "multiclass", "num_class": "3",
      "metric": "multi_error,l2"}, "don't match"),
], ids=["multiclass-default", "multiclass-1", "regression-3", "binary-2",
        "binary-multi_logloss", "multiclass-auc", "multiclass-l2"])
def test_objective_conflicts_are_fatal(params, message):
    """lightgbm_tpu/config.py:972-985, for task=train."""
    cfg = lgt.OverallConfig()
    with pytest.raises(log.Fatal, match=message):
        cfg.set(params, require_data=False)


def test_objective_keys_accepted():
    cfg = lgt.OverallConfig()
    cfg.set({"objective": "lambdarank", "metric": "ndcg,l1",
             "ndcg_at": "5,1", "label_gain": "0,1,3", "max_position": "10"},
            require_data=False)
    assert cfg.metric_config.eval_at == [1, 5]
    assert cfg.metric_config.label_gain == cfg.objective_config.label_gain \
        == [0.0, 1.0, 3.0]
    assert cfg.objective_config.max_position == 10
    cfg = lgt.OverallConfig()
    cfg.set({"objective": "multiclass", "num_class": "4",
             "metric": "multi_logloss,multi_error"}, require_data=False)
    assert cfg.boosting_config.num_class == cfg.objective_config.num_class \
        == cfg.metric_config.num_class == 4
    # the default objective is regression, as in the JAX package; a
    # prediction run reads num_class from the model file
    cfg = lgt.OverallConfig()
    cfg.set({"metric": "l2"}, require_data=False)
    assert cfg.objective_type == "regression"
    cfg = lgt.OverallConfig()
    cfg.set({"task": "predict", "num_class": "3"}, require_data=False)


def test_training_data_faults_are_fatal():
    """lambdarank without queries, and a multiclass label outside
    [0, num_class), through the user entry point."""
    x = np.random.RandomState(1).randn(100, 3)
    y = np.arange(100, dtype=np.float32) % 4
    with pytest.raises(log.Fatal, match="query information"):
        lgt.train({"objective": "lambdarank", "num_iterations": 1},
                  lgt.Dataset.from_arrays(x, y), device="cpu")
    with pytest.raises(log.Fatal, match="Label must be in"):
        lgt.train({"objective": "multiclass", "num_class": 3,
                   "num_iterations": 1},
                  lgt.Dataset.from_arrays(x, y), device="cpu")
    with pytest.raises(log.Fatal, match="query size"):
        lgt.Dataset.from_arrays(x, y, query_boundaries=[0, 40, 90])
