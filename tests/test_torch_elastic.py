"""The straggler drain: lightgbm_tpu_torch/elastic.py against the JAX
package's lightgbm_tpu/elastic.py live, and the drain in gloo worlds of
3 and 2 ranks (one process a rank, on the CPU, each killed past
WORLD_TIMEOUT s).

- The pure logic (``median``, ``slowest_unique``, ``StragglerTracker``,
  ``StragglerMonitor``, ``skew_from_rows``, ``host_times_from_gather``)
  gives the JAX module's answer on enumerated inputs and on
  hypothesis-drawn rows, sequences and vectors.
- ``clear_lead``, the port's own reading of a boundary (ROADMAP C11), on
  enumerated inputs; and C11 itself: the JAX trainer's observation, each
  host's interval between boundaries, is the world's period on every
  host, and the strictly-slowest rule flags a host on its jitter alone,
  where ``clear_lead`` sees no straggler.
- A world of 3 ranks under ``elastic_shrink=true straggler_k=2`` whose
  rank 2 (``p2``) sleeps SLOW s before every iteration, its own work as
  the ranks measure it (nothing injected): at the second boundary every
  rank writes nothing but rank 0's checkpoint, agrees on 2 survivors and
  stops with the named ``Fatal``; the exchange files
  ``elastic/times_allgather`` (4 bytes a call) and the vote
  ``elastic/survivor_pmin`` (4 bytes a rank) under the ``elastic`` span,
  and ``elastic/shrinks`` counts 1.  The restart on 2 ranks from that
  checkpoint writes the serial int8 run's model text byte for byte.
- Without checkpoints the drain warns, disarms, and the model is the
  serial run's, on every rank.
- A world of 2 ranks that nothing slows, armed at ``straggler_k=3`` with
  checkpoints, exchanges at each of its UNSLOWED boundaries and never
  drains.
- A restart on 3 ranks of a ``hybrid`` world of 4 with
  ``feature_shards=2`` is the config's ``Fatal``, naming the restart.
"""
import shutil

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from lightgbm_tpu import elastic as jelastic

from lightgbm_tpu_torch import elastic
from lightgbm_tpu_torch.parallel import mesh
from test_torch_parallel import port_serial, write_table
from test_torch_parallel_checkpoint import CkptWorld

ITERS = 5
K = 2
SLOW = 0.5           # rank 2's own seconds before each iteration
UNSLOWED = 20
INT8 = {"hist_dtype": "int8", "tree_learner": "data", "num_machines": "8",
        "num_iterations": str(ITERS)}
DRAIN = {"elastic_shrink": "true", "straggler_k": str(K)}
HOSTS = st.sampled_from(["p0", "p1", "p2", "p3"])


# ------------------------------------------------------------ pure logic

@pytest.mark.parametrize("totals", [
    {}, {"a": 1.0, "b": 2.0}, {"a": 2.0, "b": 2.0}, {"a": 0.0, "b": 0.0},
    {"p0": 3.0, "p1": 1.0, "p2": 3.0}, {"p0": -1.0}, {"p1": 5.0}])
def test_slowest_unique_equals_jax(totals):
    assert elastic.slowest_unique(totals) == jelastic.slowest_unique(totals)


@pytest.mark.parametrize("vals", [[1.0], [3.0, 1.0], [2.0, 5.0, 1.0],
                                  [4.0, 1.0, 3.0, 2.0]])
def test_median_equals_jax(vals):
    assert elastic.median(vals) == jelastic.median(vals)


def _track(mod, k, seq):
    t = mod.StragglerTracker(k)
    out = [t.update(it, h) for it, h in seq]
    return out, (t.run_host, t.run_len, t.prev_it, t.flagged)


@pytest.mark.parametrize("k,seq", [
    (3, [(1, "p1"), (2, "p1"), (3, "p1")]),
    (3, [(1, "p1"), (2, None), (3, "p1"), (4, "p1")]),
    (2, [(1, "p0"), (3, "p0"), (4, "p0")]),
    (1, [(5, "p2"), (6, None)]),
    (0, [(1, "p3")])])
def test_tracker_equals_jax(k, seq):
    assert _track(elastic, k, seq) == _track(jelastic, k, seq)


@settings(max_examples=150, deadline=None, database=None)
@given(k=st.integers(0, 4),
       seq=st.lists(st.tuples(st.integers(0, 12), st.none() | HOSTS),
                    max_size=30))
def test_tracker_equals_jax_drawn(k, seq):
    assert _track(elastic, k, seq) == _track(jelastic, k, seq)


def _monitor(mod, k, steps):
    mon = mod.StragglerMonitor(k)
    out = []
    for it, totals, take in steps:
        out.append(mon.observe(it, totals))
        if take:
            out.append(mon.take_flagged())
    return out


TOTALS = st.dictionaries(HOSTS, st.sampled_from([0.0, 1.0, 2.0, 3.5]),
                         max_size=4)


@settings(max_examples=150, deadline=None, database=None)
@given(k=st.integers(1, 4),
       steps=st.lists(st.tuples(st.integers(0, 50), TOTALS, st.booleans()),
                      max_size=25))
def test_monitor_equals_jax_drawn(k, steps):
    assert _monitor(elastic, k, steps) == _monitor(jelastic, k, steps)


def test_monitor_flags_consecutive_observations():
    steps = [(8, {"p0": 1.0, "p1": 9.0}, False),
             (16, {"p0": 1.0, "p1": 9.0}, False),
             (24, {"p0": 1.0, "p1": 9.0}, True),
             (32, {"p0": 1.0, "p1": 9.0}, True)]
    got = _monitor(elastic, 3, steps)
    assert got == _monitor(jelastic, 3, steps)
    assert got[2:] == ["p1", "p1", None, None]


ROWS = st.dictionaries(
    st.integers(0, 8),
    st.dictionaries(HOSTS, st.dictionaries(
        st.sampled_from(["histogram", "split_find", "eval", "partition"]),
        st.sampled_from([0.0, 0.1, 0.25, 0.5, 2.0]), max_size=4),
        max_size=4), max_size=8)


@settings(max_examples=150, deadline=None, database=None)
@given(rows=ROWS, k=st.integers(1, 4))
def test_skew_from_rows_equals_jax_drawn(rows, k):
    assert elastic.skew_from_rows(rows, k) == jelastic.skew_from_rows(rows, k)


def test_skew_from_rows_flags_the_slow_host():
    rows = {it: {"p0": {"histogram": 0.1, "eval": 0.02},
                 "p1": {"histogram": 0.5, "eval": 0.02}}
            for it in range(1, 5)}
    got = elastic.skew_from_rows(rows, straggler_k=3)
    assert got == jelastic.skew_from_rows(rows, straggler_k=3)
    assert got["persistent_straggler"] == "p1"
    assert got["iterations_compared"] == 4


@settings(max_examples=100, deadline=None, database=None)
@given(vals=st.lists(st.floats(0, 100, width=32), max_size=12),
       sph=st.integers(0, 4))
def test_host_times_from_gather_equals_jax_drawn(vals, sph):
    v = np.asarray(vals, np.float32)
    assert elastic.host_times_from_gather(v, sph) == \
        jelastic.host_times_from_gather(v, sph)


@pytest.mark.parametrize("totals,lead", [
    ({}, False), ({"p0": 5.0}, False),
    ({"p0": 1.0, "p1": 2.0}, False),        # 2 hosts: more than 2x
    ({"p0": 1.0, "p1": 2.01}, True),
    ({"p0": 0.0, "p1": 0.0}, False),
    ({"p0": 1.0, "p1": 1.0, "p2": 1.5}, False),   # 3 hosts: 1.5x
    ({"p0": 0.2, "p1": 1.0, "p2": 1.6}, True),
    ({"p0": 3.0, "p1": 1.0, "p2": 3.0}, False),
    ({"p0": 1.0, "p1": 1.0, "p2": 1.0, "p3": 1.34}, True)])
def test_clear_lead(totals, lead):
    assert elastic.clear_lead(totals) == (totals if lead else {})


def test_c11_jax_interval_rule_drains_on_noise():
    """ROADMAP C11: under the JAX trainer each host feeds the monitor its
    interval from one boundary to the next (lightgbm_tpu/models/gbdt.py:
    1021-1044).  Hosts that meet at every collective all see the world's
    period, here 1 s with 0.1 ms of seeded jitter over UNSLOWED
    boundaries: the JAX monitor flags a host, the port's reading through
    ``clear_lead`` never does."""
    rng = np.random.RandomState(0)
    jmon = jelastic.StragglerMonitor(k=3)
    mon = elastic.StragglerMonitor(3)
    jflags, flags = [], []
    for it in range(1, UNSLOWED + 1):
        totals = {"p%d" % h: 1.0 + 1e-4 * rng.randn() for h in range(2)}
        jflags.append(jmon.observe(it, totals))
        flags.append(mon.observe(it, elastic.clear_lead(totals)))
    assert any(jflags)
    assert not any(flags)


def test_collectives_in_a_world_of_one():
    """No process group: both exchanges are this rank's own values."""
    comm = mesh.host_comm()
    np.testing.assert_array_equal(elastic.exchange_times(comm, 0.25),
                                  np.float32([0.25]))
    np.testing.assert_array_equal(
        elastic.agree_survivors(comm, [1, 0, 1]), [1, 0, 1])


# ------------------------------------------------------------- the drain

@pytest.fixture(scope="module")
def drained(tmp_path_factory):
    """(the 3-rank world's result, the 2-rank restart's, the serial int8
    text)."""
    root = tmp_path_factory.mktemp("drain")
    data = root / "train.tsv"
    write_table(data)
    ck = str(root / "ck")
    world = CkptWorld(root, "three", 3, [
        {"name": "drain", "expect_error": True, "telemetry": True,
         "slow": [2, SLOW],
         "params": dict(INT8, checkpoint_interval="1", checkpoint_dir=ck,
                        **DRAIN)},
        {"name": "no-writer", "slow": [2, SLOW],
         "params": dict(INT8, **DRAIN)},
        {"name": "hybrid-restart", "expect_error": True,
         "params": dict(INT8, tree_learner="hybrid", num_machines="4",
                        feature_shards="2")}], data)
    serial = port_serial({"hist_dtype": "int8",
                          "num_iterations": str(ITERS)}, data)
    three = world.result()
    shutil.copytree(ck, str(root / "ck2"))
    two = CkptWorld(root, "two", 2, [
        {"name": "restart",
         "params": dict(INT8, checkpoint_interval="1",
                        checkpoint_dir=str(root / "ck2"))},
        {"name": "unslowed", "telemetry": True,
         "params": dict(INT8, num_iterations=str(UNSLOWED),
                        checkpoint_interval="1",
                        checkpoint_dir=str(root / "ck3"),
                        elastic_shrink="true", straggler_k="3")}],
        data).result()
    return three, two, serial, ck


def test_drain_stops_every_rank_after_a_checkpoint(drained):
    from lightgbm_tpu_torch import checkpoint as ckpt
    (_, recs, _), _, _, ck = drained
    for rec in recs:
        err = rec["drain"]["error"]
        assert "persistent straggler p2: checkpoint written at iteration " \
            "%d" % K in err
        assert "restarting the 2 surviving processes from the checkpoint " \
               "(task=train, same checkpoint_dir)" in err
    assert ckpt.load_checkpoint(ckpt.latest_checkpoint(ck))["iteration"] \
        == K


def test_drain_files_its_sites_and_counter(drained):
    (_, recs, _), _, _, _ = drained
    for rec in recs:
        d = rec["drain"]
        times = d["sites"]["elastic/times_allgather"]
        votes = d["sites"]["elastic/survivor_pmin"]
        assert (times["calls"], times["bytes_per_call"]) == (K, 4)
        assert (votes["calls"], votes["bytes_per_call"]) == (1, 4 * 3)
        assert votes["kind"] == "pmin" and times["kind"] == "all_gather"
        assert d["counters"]["elastic/shrinks"] == 1
        assert "elastic" in d["phases"]


def test_restart_of_the_survivors_is_serial(drained):
    _, (_, recs, logs), serial, _ = drained
    assert [r["restart"]["model"] for r in recs] == [serial, serial]
    assert "elastic restart: checkpoint topology num_machines=3 -> 2" \
        in logs[0]


def test_drain_without_checkpoints_warns_and_disarms(drained):
    (_, recs, logs), _, serial, _ = drained
    for rec, text in zip(recs, logs):
        assert rec["no-writer"]["model"] == serial
        assert "persistent straggler p2 flagged, but no checkpoint is " \
            "configured" in text


def test_restart_on_fewer_ranks_refactors_the_grid(drained):
    (_, recs, _), _, _, _ = drained
    for rec in recs:
        assert "feature_shards=2 does not divide the world's 3 ranks: a " \
            "restart on fewer ranks" in rec["hybrid-restart"]["error"]


def test_unslowed_world_never_drains(drained):
    """Two ranks of equal work, UNSLOWED boundaries at straggler_k=3:
    every boundary exchanged, no rank flagged, no drain."""
    _, (_, recs, logs), _, _ = drained
    for rec, text in zip(recs, logs):
        u = rec["unslowed"]
        assert u["iter"] == UNSLOWED and "error" not in u
        assert u["sites"]["elastic/times_allgather"]["calls"] == UNSLOWED
        assert "elastic/shrinks" not in u["counters"]
        assert "persistent straggler" not in text
