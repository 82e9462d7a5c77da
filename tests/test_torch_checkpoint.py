"""Checkpoints and resume in lightgbm_tpu_torch (device="cpu", the
kernels' plain versions), case for case after tests/test_checkpoint.py
where a case applies to one process, with the JAX package run live as
the oracle across packages.

- Resume in the port: a run stopped at iteration k by the fault hatch
  (``faults.arm(k, "raise")``) and restarted from its checkpoint
  directory writes the unbroken run's model text byte for byte, and its
  scores bit for bit: float32 and int8; the compacted, masked and
  depth-wise growers; host (numpy) and threefry (``bagging_device=true``)
  bagging, ``feature_fraction`` and GOSS; early stopping on a validation
  set; multiclass K = 3.
- Across packages: a checkpoint the JAX package writes at iteration k is
  resumed by the port: its first k trees are the file's, byte for byte
  in the model text, and the trees it grows then equal the JAX package's
  unbroken run in structure exactly and in leaf values within the
  repo's cross-package budget (rtol 1e-5 / atol 5e-7,
  tests/test_torch_gbdt.py), in float32 and in int8 alike: in int8 too
  the port's f64 bin cumsum can move a leaf value's last bit against
  the JAX package's f32 one, though both grow from the same int8 sums
  (tests/test_torch_gbdt.py header), so the two packages' int8 trees are
  not bitwise equal even without a checkpoint between them.  A
  checkpoint the port writes loads in the JAX package, passes its
  fingerprint check and restores there.  ``bagging_device`` resolves
  alike in both packages on the CPU (numpy for ``auto``).
- File discipline, each refusal with the JAX loader's own message.
- The CLI: a run SIGKILLed at iteration 6 (rc -9) and rerun writes the
  unbroken run's model file; ``input_model`` with a checkpoint to resume
  is a Fatal.
- A snapshot is not torn by the in-place score updates that follow it.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from lightgbm_tpu import checkpoint as jckpt
from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.objectives import create_objective as jcreate

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import checkpoint as ckpt
from lightgbm_tpu_torch import cli, faults, lifecycle
from lightgbm_tpu_torch.metrics import create_metrics
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.utils import log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = {"objective": "binary", "num_leaves": "8", "min_data_in_leaf": "5",
        "min_sum_hessian_in_leaf": "0.1", "learning_rate": "0.1",
        "verbose": "-1"}
ITERS = 8
STOP = 3          # the fault fires at this iteration boundary
STRUCTURE = ("split_feature", "split_feature_real", "threshold_bin",
             "left_child", "right_child", "leaf_parent")


@pytest.fixture(autouse=True)
def no_leaks():
    """No writer thread and no armed fault outlives a test."""
    yield
    left = lifecycle.leaks()
    for _, _, closer in left:
        closer()
    assert not left, [(k, n) for k, n, _ in left]


def _data(n=1200, f=10, seed=7, classes=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f)
    z = x[:, 0] - x[:, 1] + 0.4 * rng.randn(n)
    if classes:
        y = np.digitize(z, np.quantile(z, np.linspace(0, 1, classes + 1)
                                       [1:-1])).astype(np.float32)
    else:
        y = (z > 0).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def data():
    return _data()


def _datasets(x, y, valid):
    """The training set, and a held-out set of 400 rows ``valid`` = K
    (0: binary) or none for ``valid`` None."""
    train = lgt.Dataset.from_arrays(x, y, max_bin=63)
    if valid is None:
        return train, []
    xv, yv = _data(n=400, f=x.shape[1], seed=99, classes=valid)
    return train, [lgt.Dataset.from_arrays(xv, yv, reference=train)]


def _train(params, x, y, valid=None, **extra):
    train, valids = _datasets(x, y, valid)
    return lgt.train(dict(params, **extra), train, valids, device="cpu")


# name -> (params over BASE, held-out set (K, or None), multiclass K)
RESUME = {
    "f32_compacted": ({}, None, 0),
    "int8_compacted": ({"hist_dtype": "int8"}, None, 0),
    "f32_masked": ({"leafwise_compact": "false"}, None, 0),
    "int8_masked": ({"leafwise_compact": "false", "hist_dtype": "int8"},
                    None, 0),
    "f32_depthwise": ({"grow_policy": "depthwise"}, None, 0),
    "int8_depthwise": ({"grow_policy": "depthwise", "hist_dtype": "int8"},
                       None, 0),
    "host_bagging_ff": ({"bagging_fraction": "0.8", "bagging_freq": "2",
                         "feature_fraction": "0.8"}, None, 0),
    "threefry_bagging_int8": ({"bagging_fraction": "0.7",
                               "bagging_freq": "1", "bagging_device": "true",
                               "hist_dtype": "int8"}, None, 0),
    "goss_ff": ({"goss": "true", "top_rate": "0.3", "other_rate": "0.2",
                 "feature_fraction": "0.75"}, None, 0),
    "early_stopping_valid": ({"metric": "binary_logloss",
                              "learning_rate": "0.9",
                              "early_stopping_round": "2",
                              "num_leaves": "31", "min_data_in_leaf": "2"},
                             0, 0),
    "multiclass_bagging_ff": ({"objective": "multiclass", "num_class": "3",
                               "metric": "multi_logloss",
                               "bagging_fraction": "0.8", "bagging_freq": "1",
                               "feature_fraction": "0.8"}, 3, 3),
}


@pytest.mark.parametrize("name", list(RESUME))
def test_raise_and_resume_writes_the_unbroken_model(name, tmp_path):
    """Unbroken run of ITERS iterations == a run stopped by a raise at
    iteration STOP (checkpoints every iteration) and resumed from its
    directory by a fresh ``lgt.train``: model text byte-equal, scores and
    early-stopping state equal."""
    extra, valid, classes = RESUME[name]
    x, y = _data(classes=classes)
    params = dict(BASE, num_iterations=ITERS, **extra)
    whole = _train(params, x, y, valid)
    ck = dict(checkpoint_interval=1, checkpoint_dir=str(tmp_path / "ck"))
    faults.arm(STOP, "raise")
    with pytest.raises(RuntimeError, match="injected fault at iteration %d"
                       % STOP):
        _train(params, x, y, valid, **ck)
    assert not faults.armed()
    payload = ckpt.load_checkpoint(ckpt.latest_checkpoint(ck[
        "checkpoint_dir"]))
    assert payload["iteration"] == STOP
    resumed = _train(params, x, y, valid, **ck)
    assert resumed.model_to_string() == whole.model_to_string()
    assert resumed.iter == whole.iter
    assert np.array_equal(resumed.score.numpy(), whole.score.numpy())
    for a, b in zip(resumed.valid_datasets, whole.valid_datasets):
        assert np.array_equal(a["score"].numpy(), b["score"].numpy())
    assert resumed.best_score == whole.best_score
    assert resumed.best_iter == whole.best_iter
    if name == "early_stopping_valid":
        assert STOP < whole.iter < ITERS      # the stop came after resume
    if name.startswith("threefry"):
        assert whole._bag_device and resumed._bag_draw_idx == ITERS


def _port_booster(x, y, params, valid=None):
    cfg = lgt.OverallConfig()
    cfg.set(dict(params), require_data=False)
    train, valids = _datasets(x, y, valid)
    b = lgt.GBDT()
    b.init(cfg.boosting_config, train,
           create_objective(cfg.objective_type, cfg.objective_config),
           device="cpu")
    for v in valids:
        b.add_valid_dataset(v, create_metrics(cfg))
    return b


def _jax_booster(x, y, params):
    cfg = JConfig()
    cfg.set(dict(params), require_data=False)
    b = JGBDT()
    b.init(cfg.boosting_config, JDataset.from_arrays(x, y, max_bin=63),
           jcreate(cfg.objective_type, cfg.objective_config))
    return b


def _jax_iters(b, n):
    for _ in range(n):
        if b.train_one_iter(is_eval=False):
            break
    return b


# name -> params over BASE; the JAX package's masked grower (its CPU
# default) against the port's compacted one, which grows the same trees
CROSS = {
    "float32": {},
    "float32_host_bagging_ff": {"bagging_fraction": "0.8",
                                "bagging_freq": "2",
                                "feature_fraction": "0.8"},
    "int8": {"hist_dtype": "int8"},
    "int8_regression_threefry": {"objective": "regression",
                                 "hist_dtype": "int8",
                                 "bagging_fraction": "0.7",
                                 "bagging_freq": "1",
                                 "bagging_device": "true"},
}


@pytest.mark.parametrize("name", list(CROSS))
def test_jax_checkpoint_resumed_by_the_port(name, data, tmp_path):
    """A checkpoint the JAX package writes at iteration STOP, resumed by
    the port to ITERS iterations: the port's trees are the JAX unbroken
    run's (the first STOP byte-equal in text; then structure exact, leaf
    values within the cross-package budget)."""
    x, y = data
    params = dict(BASE, **CROSS[name])
    whole = _jax_iters(_jax_booster(x, y, params), ITERS)
    part = _jax_iters(_jax_booster(x, y, params), STOP)
    path = jckpt.write_checkpoint(str(tmp_path),
                                  jckpt.serialize_state(
                                      part.checkpoint_state()))
    b = _port_booster(x, y, params)
    b.restore_checkpoint(path)
    assert b.iter == STOP and len(b.models) == STOP
    b.run_training(ITERS - STOP, is_eval=False)
    assert len(b.models) == len(whole.models) == ITERS
    assert [t.to_string() for t in b.models[:STOP]] == \
        [t.to_string() for t in whole.models[:STOP]]
    for k, (jt, tt) in enumerate(zip(whole.models, b.models)):
        for field in STRUCTURE:
            np.testing.assert_array_equal(getattr(tt, field),
                                          getattr(jt, field),
                                          err_msg="tree %d %s" % (k, field))
        np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=1e-5,
                                   atol=5e-7, err_msg="tree %d" % k)


@pytest.mark.parametrize("extra", [{}, {"bagging_fraction": "0.8",
                                        "bagging_freq": "2",
                                        "feature_fraction": "0.8"}],
                         ids=["plain", "host_bagging_ff"])
def test_port_checkpoint_loads_in_jax(extra, data, tmp_path):
    """A checkpoint the port writes passes the JAX package's loader and
    its field-by-field fingerprint check, and carries the JAX payload's
    fields; the JAX package restores it and trains on."""
    x, y = data
    params = dict(BASE, **extra)
    b = _port_booster(x, y, params)
    b.run_training(STOP, is_eval=False)
    path = ckpt.write_checkpoint(str(tmp_path),
                                 ckpt.serialize_state(b.checkpoint_state()))
    payload = jckpt.load_checkpoint(path)
    j = _jax_booster(x, y, params)
    jckpt.check_fingerprint(payload, j.checkpoint_fingerprint(),
                            j._dataset_fingerprint())
    jpart = _jax_iters(_jax_booster(x, y, params), STOP)
    want = jckpt.serialize_state(jpart.checkpoint_state())
    assert set(payload) == set(want)
    assert payload["topology"] == want["topology"]
    assert set(payload["trees"][0]) == set(want["trees"][0]) | {"leaf_count"}
    j.restore_checkpoint(payload)
    assert j.iter == STOP
    assert [t.to_string() for t in j.models] == \
        [t.to_string() for t in b.models]
    np.testing.assert_array_equal(np.asarray(j.score), b.score.numpy())


def test_checkpoint_payload_round_trips_trees(data, tmp_path):
    """Every training-side tree array, leaf counts included, survives a
    file round trip; the model text is the booster's."""
    x, y = data
    b = _port_booster(x, y, BASE)
    b.run_training(3, is_eval=False)
    path = ckpt.write_checkpoint(str(tmp_path),
                                 ckpt.serialize_state(b.checkpoint_state()))
    c = _port_booster(x, y, BASE)
    c.restore_checkpoint(path)
    for s, t in zip(b.models, c.models):
        for field in STRUCTURE + ("threshold", "split_gain", "leaf_value",
                                  "leaf_count"):
            assert np.array_equal(getattr(s, field), getattr(t, field))
    assert c.model_to_string() == b.model_to_string()


# ------------------------------------------------------------ file discipline

def _valid_checkpoint(data, tmp_path):
    x, y = data
    b = _port_booster(x, y, BASE)
    b.run_training(3, is_eval=False)
    path = ckpt.write_checkpoint(str(tmp_path),
                                 ckpt.serialize_state(b.checkpoint_state()))
    return b, path


def _both_refuse(path, match):
    """The port's loader and the JAX package's refuse the file with the
    same message."""
    with pytest.raises(ckpt.CheckpointError, match=match) as port:
        ckpt.load_checkpoint(path)
    with pytest.raises(jckpt.CheckpointError) as jax_:
        jckpt.load_checkpoint(path)
    assert str(port.value) == str(jax_.value)


def test_truncated_checkpoint_rejected(data, tmp_path):
    _, path = _valid_checkpoint(data, tmp_path)
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])
    _both_refuse(path, "truncated")


def test_corrupt_checkpoint_rejected(data, tmp_path):
    _, path = _valid_checkpoint(data, tmp_path)
    blob = bytearray(open(path, "rb").read())
    blob[-20] ^= 0x41
    with open(path, "wb") as f:
        f.write(bytes(blob))
    _both_refuse(path, "sha256")


def test_bad_header_rejected(tmp_path):
    path = str(tmp_path / "ckpt-00000001.json")
    with open(path, "w") as f:
        f.write("not a checkpoint at all\n{}")
    _both_refuse(path, "header")


@pytest.mark.parametrize("field", ["rng", "trees", "score", "config"])
def test_missing_field_named(field, data, tmp_path):
    """A structurally valid file missing a payload field names it."""
    _, path = _valid_checkpoint(data, tmp_path)
    payload = ckpt.load_checkpoint(path)
    broken = {k: v for k, v in payload.items() if k != field}
    p2 = ckpt.write_checkpoint(str(tmp_path / ("f_" + field)), broken)
    _both_refuse(p2, "'%s'" % field)


@pytest.mark.parametrize("key,value", [("num_leaves", "16"),
                                       ("learning_rate", "0.2")])
def test_config_mismatch_names_field(key, value, data, tmp_path):
    x, y = data
    _, path = _valid_checkpoint(data, tmp_path)
    c = _port_booster(x, y, dict(BASE, **{key: value}))
    with pytest.raises(log.LightGBMError, match=key):
        c.restore_checkpoint(path)


def test_dataset_mismatch_names_field(data, tmp_path):
    x, y = data
    _, path = _valid_checkpoint(data, tmp_path)
    e = _port_booster(x[:800], y[:800], BASE)
    with pytest.raises(log.LightGBMError, match="num_rows"):
        e.restore_checkpoint(path)


def test_restore_requires_fresh_booster(data, tmp_path):
    x, y = data
    _, path = _valid_checkpoint(data, tmp_path)
    c = _port_booster(x, y, BASE)
    c.restore_checkpoint(path)
    with pytest.raises(log.LightGBMError, match="freshly initialized"):
        c.restore_checkpoint(path)


def test_atomic_rename_discipline(data, tmp_path):
    """A writer killed mid-write leaves the previous checkpoint loadable
    and only a stray .tmp-* file, which the lister ignores; a finished
    write leaves no temp file."""
    _, path = _valid_checkpoint(data, tmp_path)
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(path)]
    stray = str(tmp_path / ".tmp-9999-1")
    with open(stray, "w") as f:
        f.write("lightgbm_tpu_checkpoint v1 sha256=" + "0" * 64
                + " bytes=99999\n{\"partial")
    assert ckpt.list_checkpoints(str(tmp_path)) == [path]
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    assert ckpt.load_checkpoint(path)["iteration"] == 3


def test_latest_checkpoint_orders_by_iteration(tmp_path):
    for it in (3, 12, 7):
        with open(str(tmp_path / ("ckpt-%08d.json" % it)), "w") as f:
            f.write("x")
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith(
        "ckpt-00000012.json")
    assert ckpt.latest_checkpoint(str(tmp_path / "absent")) is None


def test_writer_latest_wins_and_close(tmp_path, data):
    """submit never blocks; a pending snapshot is replaced by a newer one
    (counted in ``dropped``), and close drains and joins."""
    x, y = data
    b = _port_booster(x, y, BASE)
    b.run_training(2, is_eval=False)
    w = ckpt.CheckpointWriter(str(tmp_path), keep=5)
    assert ckpt.live_writers() == 1
    try:
        for _ in range(5):
            w.submit(b.checkpoint_state())
    finally:
        w.close()
    assert not w.alive and ckpt.live_writers() == 0
    assert w.written >= 1 and w.written + w.dropped == 5
    assert ckpt.latest_checkpoint(str(tmp_path)) is not None


def test_run_training_writer_lifecycle(data, tmp_path):
    """checkpoint_interval writes on the background writer, prunes to
    checkpoint_keep, writes a final checkpoint, and closes the writer."""
    x, y = data
    cdir = str(tmp_path / "ck")
    b = _port_booster(x, y, dict(BASE, checkpoint_interval="2",
                                 checkpoint_dir=cdir, checkpoint_keep="2"))
    b.run_training(6, is_eval=False)
    assert ckpt.live_writers() == 0 and not b.checkpoint_writer.alive
    assert b.checkpoint_writer.written >= 1
    files = ckpt.list_checkpoints(cdir)
    assert 1 <= len(files) <= 2
    payload = ckpt.load_checkpoint(ckpt.latest_checkpoint(cdir))
    assert payload["iteration"] == 6 and len(payload["trees"]) == 6
    assert not [n for n in os.listdir(cdir) if n.startswith(".tmp-")]
    c = _port_booster(x, y, BASE)
    c.restore_checkpoint(payload)
    assert c.model_to_string() == b.model_to_string()
    assert np.array_equal(c.score.numpy(), b.score.numpy())


def test_no_interval_no_writer(data, tmp_path):
    x, y = data
    b = _port_booster(x, y, BASE)
    b.run_training(2, is_eval=False)
    assert b.checkpoint_writer is None and ckpt.live_writers() == 0
    assert ckpt.list_checkpoints(str(tmp_path)) == []


def test_snapshot_not_torn_by_later_updates(data, tmp_path):
    """checkpoint_state copies the scores: the booster updates them in
    place, so a snapshot that kept a reference would be written with a
    later iteration's values."""
    x, y = data
    b = _port_booster(x, y, BASE, valid=0)
    b.run_training(2, is_eval=False)
    want = b.score.numpy().copy()
    want_valid = b.valid_datasets[0]["score"].numpy().copy()
    w = ckpt.CheckpointWriter(str(tmp_path))
    try:
        w.submit(b.checkpoint_state())
        b.score.add_(1.0)
        b.valid_datasets[0]["score"].add_(1.0)
        b.train_one_iter(is_eval=False)
    finally:
        w.close()
    payload = ckpt.load_checkpoint(ckpt.latest_checkpoint(str(tmp_path)))
    assert payload["iteration"] == 2
    assert np.array_equal(ckpt.array_from_json(payload["score"]), want)
    assert np.array_equal(ckpt.array_from_json(payload["valid_scores"][0]),
                          want_valid)


def test_fault_hatch_is_tracked_and_one_shot():
    faults.arm(4, "stall", stall_s=0.0)
    assert faults.armed()
    assert any(k == faults.HATCH_KIND for k, _, _ in lifecycle.leaks())
    faults.maybe_fire(3)
    assert faults.armed()
    faults.maybe_fire(4)
    assert not faults.armed() and not lifecycle.leaks()
    with pytest.raises(log.LightGBMError, match="fault kind"):
        faults.arm(1, "explode")


# --------------------------------------------------------------------- CLI

def _cli_files(tmp_path):
    x, y = _data(n=1500, f=6, seed=11)
    data = str(tmp_path / "train.tsv")
    np.savetxt(data, np.column_stack([y, x]), delimiter="\t", fmt="%.6f")
    return data


def _cli_args(data, out, ckdir):
    return ["task=train", "data=" + data, "objective=binary",
            "num_trees=10", "num_leaves=8", "min_data_in_leaf=5",
            "device=cpu", "verbose=-1", "output_model=" + out,
            "checkpoint_interval=1", "checkpoint_dir=" + ckdir]


def test_cli_kill_and_resume_writes_the_unbroken_model(tmp_path):
    """A CLI run SIGKILLed at iteration 6 exits -9; the same command
    again resumes from the latest checkpoint and writes the unbroken
    run's model file byte for byte."""
    data = _cli_files(tmp_path)
    whole = str(tmp_path / "whole.txt")
    assert cli.main(_cli_args(data, whole, str(tmp_path / "ck0"))) == 0
    out, ckdir = str(tmp_path / "model.txt"), str(tmp_path / "ck")
    args = _cli_args(data, out, ckdir)
    code = ("import sys\n"
            "from lightgbm_tpu_torch import cli, faults\n"
            "faults.arm(6, 'kill')\n"
            "sys.exit(cli.main(%r))\n" % (args,))
    killed = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, timeout=300)
    assert killed.returncode == -9, killed.stderr[-2000:]
    # the background writer may not have written iteration 6's snapshot
    # before the kill: the latest checkpoint is at most that one
    assert 1 <= ckpt.load_checkpoint(ckpt.latest_checkpoint(ckdir))[
        "iteration"] <= 6
    again = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch"]
                           + args, cwd=REPO, capture_output=True, text=True,
                           timeout=300)
    assert again.returncode == 0, again.stderr[-2000:]
    with open(out, "rb") as f1, open(whole, "rb") as f2:
        assert f1.read() == f2.read()


def test_cli_input_model_with_checkpoint_is_fatal(tmp_path):
    data = _cli_files(tmp_path)
    model, ckdir = str(tmp_path / "m.txt"), str(tmp_path / "ck")
    assert cli.main(_cli_args(data, model, ckdir)) == 0
    assert ckpt.latest_checkpoint(ckdir) is not None
    app = cli.Application(_cli_args(data, str(tmp_path / "m2.txt"), ckdir)
                          + ["input_model=" + model])
    with pytest.raises(log.LightGBMError, match="input_model"):
        app.run()
