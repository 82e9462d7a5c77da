"""The parallel learners through the command line, and what they refuse.

- ``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
  lightgbm_tpu_torch ... tree_learner=data num_machines=2`` (gloo on the
  CPU, killed past WORLD_TIMEOUT): rank 0's ``output_model`` and rank
  1's ``output_model.rank1`` are byte-equal, and equal to the serial
  CLI's model file in int8;
- its metric lines (training metrics over the world's rows, validation
  metrics on every rank) equal the serial CLI's, rtol 1e-6;
- GOSS through a CLI world: the rank files are byte-equal to the serial
  CLI's GOSS model file in int8;
- every key still refused is a named ``Fatal``: ``serve_shards > 1``
  under ``predict_algo=scan``, as in the JAX package; so are the hybrid
  and voting keys' own faults (a
  ``feature_shards`` that does not divide the world, ``top_k`` below
  1), a ``timeline`` other than auto, true or false, GOSS with bagging
  under hybrid, ``elastic_shrink`` under the
  serial learner and ``straggler_k`` below 1, and what a rank's booster
  cannot restore across a topology change: host-stream bagging and a
  pre-partitioned world;
- the load routes once refused under a shard draw (the caches, streamed,
  worker and two-round loads) each load the resident shard, and
  ``is_save_binary_file`` under one without a world is the ``Fatal``
  that names it (tests/test_torch_world_ingest.py holds them in worlds).
"""
import glob
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import checkpoint as ckpt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.io import parallel_ingest
from lightgbm_tpu_torch.utils import log
from test_torch_parallel import BASE, REPO, WORLD_TIMEOUT, write_table

ARGS = ["task=train", "objective=binary", "num_leaves=15",
        "min_data_in_leaf=20", "min_sum_hessian_in_leaf=1.0",
        "learning_rate=0.2", "num_trees=3", "max_bin=32", "hist_dtype=int8",
        "metric=auc,binary_logloss", "is_training_metric=true",
        "device=cpu"]
METRIC_LINE = re.compile(r"Iteration:(\d+), (.+?) : (.*)$")


def torchrun(tmp_path, args, nproc=2):
    """The CLI under ``torch.distributed.run`` in ``tmp_path``: (exit
    code, launcher output, [rank stdout]); the launcher's process group is
    killed past WORLD_TIMEOUT."""
    logs = tmp_path / "logs"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), "--log-dir", str(logs),
           "--redirects", "3", "-m", "lightgbm_tpu_torch"] + args
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(cmd, cwd=str(tmp_path), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=WORLD_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail("torch.distributed.run ran past %d s and was killed"
                    % WORLD_TIMEOUT)
    ranks = sorted(glob.glob(str(logs / "**" / "stdout.log"),
                             recursive=True),
                   key=lambda p: int(os.path.basename(os.path.dirname(p))))
    return proc.returncode, out, [open(p).read() for p in ranks]


def metric_lines(text):
    """{(iteration, metric): values} of a run's log."""
    out = {}
    for line in text.splitlines():
        m = METRIC_LINE.search(line)
        if m:
            out[int(m.group(1)), m.group(2)] = [float(v) for v in
                                                m.group(3).split()]
    return out


def _serial_cli(d, args):
    """The serial CLI in ``d``, its output to serial.log."""
    old, cwd = sys.stdout, os.getcwd()
    with open(d / "serial.log", "w") as f:
        sys.stdout = f
        os.chdir(d)
        try:
            return cli.main(args)
        finally:
            sys.stdout = old
            os.chdir(cwd)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    write_table(d / "train.tsv")
    write_table(d / "valid.tsv", n=1000, seed=8)
    args = ARGS + ["data=train.tsv", "valid_data=valid.tsv"]
    rc, out, ranks = torchrun(d, args + ["tree_learner=data",
                                         "num_machines=2",
                                         "output_model=dp.txt"])
    assert rc == 0, out[-4000:]
    assert _serial_cli(d, args + ["output_model=serial.txt"]) == 0
    return d, ranks, (d / "serial.log").read_text()


def test_cli_rank_model_files_byte_equal(runs):
    d, ranks, _ = runs
    assert len(ranks) == 2
    rank0 = (d / "dp.txt").read_text()
    assert rank0 == (d / "dp.txt.rank1").read_text()
    assert rank0 == (d / "serial.txt").read_text()


def test_cli_metric_lines_equal_serial(runs):
    _, ranks, serial = runs
    want = metric_lines(serial)
    assert len(want) == 3 * 2 * 2      # iterations x sets x metrics
    for text in ranks:
        got = metric_lines(text)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       err_msg=str(key))


def test_cli_goss_world_byte_equal_serial(tmp_path):
    """GOSS on every rank of a CLI world: both rank files are the serial
    CLI's GOSS model file, byte for byte (int8)."""
    write_table(tmp_path / "train.tsv", n=500)
    goss = ARGS + ["data=train.tsv", "goss=true", "top_rate=0.3",
                   "other_rate=0.2"]
    rc, out, ranks = torchrun(tmp_path, goss + [
        "tree_learner=data", "num_machines=2", "output_model=dp.txt"])
    assert rc == 0, out[-4000:]
    assert len(ranks) == 2
    assert _serial_cli(tmp_path, goss + ["output_model=serial.txt"]) == 0
    text = (tmp_path / "dp.txt").read_text()
    assert text == (tmp_path / "dp.txt.rank1").read_text()
    assert text == (tmp_path / "serial.txt").read_text()
    for log_text in ranks:
        assert "GOSS: keeping top 150 rows" in log_text


# the other keys a case needs (the learner of a grid of ranks)
REFUSED_CONTEXT = {("feature_shards", "3"): {"tree_learner": "hybrid"},
                   ("feature_shards", "4"): {"tree_learner": "voting"},
                   ("goss", "true"): {"tree_learner": "hybrid",
                                      "bagging_fraction": "0.5",
                                      "bagging_freq": "1"},
                   ("topk", "2"): {"tree_learner": "voting_parallel",
                                   "feature_shards": "5"},
                   ("serve_shards", "2"): {"predict_algo": "scan"}}


@pytest.mark.parametrize("key,value,match", [
    ("feature_shards", "-1", "feature_shards should be >= 0"),
    ("feature_shards", "3", "feature_shards=3 does not divide "
                            "num_machines=2"),
    ("feature_shards", "4", "feature_shards=4 does not divide "
                            "num_machines=2"),
    ("top_k", "0", "top_k should be >= 1"),
    ("topk", "2", "feature_shards=5 does not divide num_machines=2"),
    ("goss", "true", "Cannot use bagging in GOSS mode"),
    ("elastic_shrink", "true", "elastic_shrink=true requires a parallel "
                               "tree_learner"),
    ("straggler_k", "0", "straggler_k should be >= 1"),
    ("timeline", "sometimes", "timeline must be auto, true or false"),
    pytest.param("serve_shards", "2", "serve_shards > 1 requires "
                 "predict_algo=bfs", id="serve_shards-2-serve_shards=2"),
    ("tree_learner", "ring", "Tree learner type error"),
    ("dp_schedule", "ring", "dp_schedule must be"),
    ("local_listen_port", "0", "local_listen_port should be > 0"),
    ("time_out", "0", "time_out should be > 0"),
])
def test_refused_keys(key, value, match):
    cfg = lgt.OverallConfig()
    with pytest.raises(log.Fatal, match=match):
        cfg.set(dict({"objective": "binary", "num_machines": "2"},
                     **REFUSED_CONTEXT.get((key, value), {}),
                     **{key: value}), require_data=False)


def test_parity_keys_accepted_without_effect():
    cfg = lgt.OverallConfig()
    cfg.set({"objective": "binary", "tree_learner": "data_parallel",
             "num_machines": "2", "mlist": "machines.txt",
             "local_port": "12401", "time_out": "30",
             "dp_schedule": "psum", "is_pre_partition": "true"},
            require_data=False)
    nc = cfg.network_config
    assert (nc.num_machines, nc.machine_list_filename, nc.local_listen_port,
            nc.time_out) == (2, "machines.txt", 12401, 30)
    assert cfg.boosting_config.tree_learner == "data"
    assert cfg.is_parallel and cfg.is_parallel_find_bin
    assert cfg.io_config.is_pre_partition
    assert cfg.boosting_config.tree_config.dp_schedule == "psum"


def _cache(path):
    lgt.Dataset.load_train(_io(path, is_save_binary_file="true"))


def _io(path, **extra):
    cfg = lgt.OverallConfig()
    cfg.set(dict(BASE, data=str(path), **extra))
    return cfg.io_config


@pytest.mark.parametrize("route", ["streaming", "two_round", "save_binary",
                                   "sibling_cache", "cache_as_data",
                                   "pre_partition_streaming"])
def test_sharded_load_routes_refused(tmp_path, route):
    """Each route that was refused under ``num_machines > 1`` before the
    port took the other load routes into a world (ROADMAP A.2): it now
    loads rank 0's resident shard (a pre-partitioned rank every row of
    its file), and writing a cache under a shard draw needs a world."""
    path = tmp_path / "train.tsv"
    write_table(path, n=300)
    want = lgt.Dataset.load_train(_io(path), rank=0, num_machines=2)
    extra = {}
    if route == "streaming":
        extra = {"streaming": "true", "ingest_workers": "2"}
    elif route == "pre_partition_streaming":
        # each rank's own file: every row, the resident load's
        extra = {"streaming": "true", "is_pre_partition": "true"}
        want = lgt.Dataset.load_train(_io(path))
    elif route == "two_round":
        extra = {"use_two_round_loading": "true"}
    elif route == "save_binary":
        with pytest.raises(log.Fatal, match="num_machines=2 needs a world"):
            lgt.Dataset.load_train(_io(path, is_save_binary_file="true"),
                                   rank=0, num_machines=2)
        assert not os.path.exists(str(path) + ".bin")
        return
    else:
        _cache(path)
        if route == "cache_as_data":
            path = tmp_path / "train.tsv.bin"
    try:
        got = lgt.Dataset.load_train(_io(path, **extra), rank=0,
                                     num_machines=2, device="cpu")
    finally:
        parallel_ingest.shutdown_workers()
    if want.used_data_indices is None:
        assert got.used_data_indices is None
    else:
        np.testing.assert_array_equal(got.used_data_indices,
                                      want.used_data_indices)
    assert got.read_bins().tobytes() == want.bins.tobytes()
    np.testing.assert_array_equal(got.metadata.label, want.metadata.label)
    assert got.num_data == want.num_data
    assert want.num_data == (300 if route == "pre_partition_streaming"
                             else want.used_data_indices.size)


class _World2:
    """A learner in a world of two ranks, refused before any collective."""
    world = 2
    shards_rows = True
    comm = None

    def bind(self, device):
        return device


@pytest.mark.parametrize("extra,match", [
    ({"bagging_fraction": "0.8", "bagging_freq": "1"},
     "host-path bagging state is per-shard"),
    ({"is_pre_partition": "true"},
     "is_pre_partition=true cannot resume across a topology change"),
])
def test_world_refusals_at_init(tmp_path, extra, match):
    """A rank's booster refuses a serial run's checkpoint, before any
    collective, where the topology change breaks it: host-stream bagging
    (one state a shard) and a pre-partitioned world (its scores in rank
    order)."""
    path = tmp_path / "train.tsv"
    write_table(path, n=300)
    cfg = lgt.OverallConfig()
    cfg.set(dict(BASE, data=str(path), **extra))
    from lightgbm_tpu_torch.objectives import create_objective

    def booster(learner, shards):
        b = lgt.GBDT()
        b.init(cfg.boosting_config,
               lgt.Dataset.load_train(cfg.io_config, rank=0,
                                      num_machines=shards),
               create_objective("binary", cfg.objective_config),
               device="cpu", learner=learner)
        return b

    serial = booster(None, 1)
    serial.run_training(1, is_eval=False)
    payload = ckpt.serialize_state(serial.checkpoint_state())
    rank = booster(_World2(), 2)
    payload["dataset"] = rank._dataset_fingerprint()
    with pytest.raises(log.Fatal, match=match):
        rank.restore_checkpoint(payload)
