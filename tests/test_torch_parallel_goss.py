"""GOSS over a world of ranks: lightgbm_tpu_torch worlds of 2, 3 and 4
gloo ranks (one process a rank, on the CPU, each killed past
WORLD_TIMEOUT s) against the port's serial GOSS run and the JAX
package's serial and single-process ``tree_learner=data`` GOSS runs
(the 8-device virtual CPU mesh of tests/conftest.py), live.

Each rank scores its own rows (``goss_row_scores``), the scores are
gathered in serial row order (site ``dp/goss_score_allgather``; a
grid's data index once), every rank draws the serial run's mask under
``fold_in(PRNGKey(bagging_seed), iter)`` and keeps its own rows' part.
Under ``is_pre_partition`` the layout is rank order (the ranks' files in
turn), here cut so that rank order is the file's order.

The GOSS rates are those of the repo's cross-package GOSS tests (top
0.3, other 0.2; tests/test_torch_sampling_gbdt.py).  At top 0.2, other
0.1 (amplification 8) on this table the port's serial run already parts
from the JAX serial run by 1.7e-5 relative at one leaf of the third
tree, the known int8 last-bit gap of the two packages (ROADMAP C), which
the world neither adds to nor removes (chip_smoke.py phase 17 holds a
world at those rates to the serial run byte for byte).

Tolerances:
- int8: model text byte-equal to the port's serial GOSS run under
  ``tree_learner=data`` at 2 and 3 ranks and all three growers,
  ``feature`` at 2 (masked and depth-wise), hybrid 2 x 2 and voting
  4 x 1 (``top_k=20``, exact), pre-partitioned at 2; against the JAX
  serial and single-process data-parallel GOSS runs, structure exact
  and leaf values rtol 1e-5 / atol 5e-7 (tests/test_torch_parallel.py);
- float32 under ``data``: the first tree's structure exact (each rank's
  f32 histogram rounds before the cross-rank add; tests/
  test_torch_parallel.py).

ROADMAP C9 is recorded here too: the JAX package's multi-process row
layout (process order of ``_draw_shard_mask`` shards) is not serial
order, and where row scores tie (every row at the first binary
iteration) ``goss_mask_weights`` keeps other rows there.
"""
import jax
import numpy as np
import pytest

from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.ops import sampling as jsampling

from lightgbm_tpu_torch.ops import sampling
from lightgbm_tpu_torch.utils import threefry
from test_torch_parallel import (BASE, GROWERS, assert_alike, jax_booster,
                                 port_serial, trees_of, write_table)
from test_torch_parallel_checkpoint import CkptWorld

# the GOSS rates of the repo's cross-package GOSS tests (tests/
# test_torch_sampling_gbdt.py); module docstring
GOSS = {"goss": "true", "top_rate": "0.3", "other_rate": "0.2"}
STRUCTURE = ("split_feature_real", "threshold", "left_child",
             "right_child", "leaf_parent")


def _jobs(P):
    """(name, params) of the world of P ranks."""
    jobs = {}
    if P in (2, 3):
        for g in GROWERS:
            jobs["data-%s-int8" % g] = dict(
                GROWERS[g], hist_dtype="int8", tree_learner="data",
                num_machines=str(P))
    if P == 2:
        for g in GROWERS:
            jobs["data-%s-float32" % g] = dict(
                GROWERS[g], hist_dtype="float32", tree_learner="data",
                num_machines="2")
        for g in ("masked", "depthwise"):
            jobs["feature-%s-int8" % g] = dict(
                GROWERS[g], hist_dtype="int8", tree_learner="feature",
                num_machines="2")
        jobs["prepart-masked-int8"] = dict(
            GROWERS["masked"], hist_dtype="int8", tree_learner="data",
            num_machines="2", is_pre_partition="true")
    if P == 4:
        for g in ("compacted", "masked"):
            jobs["hybrid-%s-int8" % g] = dict(
                GROWERS[g], hist_dtype="int8", tree_learner="hybrid",
                num_machines="4", feature_shards="2")
        for g in ("depthwise", "masked"):
            jobs["voting-%s-int8" % g] = dict(
                GROWERS[g], hist_dtype="int8", tree_learner="voting",
                num_machines="4", top_k="20")
    return [dict({"name": n, "params": dict(p, **GOSS)},
                 **({"telemetry": True} if n == "data-compacted-int8"
                    else {}))
            for n, p in jobs.items()]


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    root = tmp_path_factory.mktemp("gosstable")
    x, y = write_table(root / "train.tsv")
    half = len(y) // 2
    for r, sl in enumerate((slice(0, half), slice(half, None))):
        np.savetxt(root / ("part%d.tsv" % r), np.column_stack([y[sl],
                                                              x[sl]]),
                   delimiter="\t", fmt="%.17g")
    return root, root / "train.tsv", x, y


@pytest.fixture(scope="module")
def started(table, tmp_path_factory):
    """The three worlds, started before the serial and JAX runs so that
    they overlap."""
    root, path, _, _ = table
    out = {}
    for P in (2, 3, 4):
        jobs = _jobs(P)
        for job in jobs:
            if job["name"].startswith("prepart"):
                job["data_by_shard"] = [str(root / "part0.tsv"),
                                        str(root / "part1.tsv")]
        out[P] = CkptWorld(tmp_path_factory.mktemp("goss%d" % P), "w", P,
                           jobs, path)
    return out


@pytest.fixture(scope="module")
def serial(table):
    """The port's serial GOSS model text per (grower, dtype)."""
    path = table[1]
    return {(g, d): port_serial(dict(GROWERS[g], hist_dtype=d, **GOSS), path)
            for g in GROWERS for d in ("int8", "float32")}


@pytest.fixture(scope="module")
def jax_runs(table, started):
    """JAX serial and single-process tree_learner=data (2 devices) GOSS
    runs in int8, per grower."""
    _, _, x, y = table
    out = {}
    for g in GROWERS:
        params = dict(GROWERS[g], hist_dtype="int8", **GOSS)
        out[g, 1] = jax_booster(params, x, y)
        out[g, 2] = jax_booster(dict(params, tree_learner="data"), x, y, 2)
    return out


@pytest.fixture(scope="module")
def worlds(started, serial, jax_runs):
    return {P: w.result()[1] for P, w in started.items()}


def _text(worlds, P, name):
    texts = [rank[name]["model"] for rank in worlds[P]]
    assert all(t == texts[0] for t in texts), "ranks disagree"
    return texts[0]


def _grower(name):
    return name.split("-")[1]


@pytest.mark.parametrize("P,name", [
    (P, job["name"]) for P in (2, 3, 4) for job in _jobs(P)
    if job["name"].endswith("int8") and not job["name"].startswith("pre")])
def test_int8_goss_world_byte_equal_serial(worlds, serial, P, name):
    assert _text(worlds, P, name) == serial[_grower(name), "int8"]


def test_pre_partitioned_goss_draws_one_world_mask(worlds):
    """``is_pre_partition``: each rank bins its own file (the world's
    mappers come from every file's sample, so the text is not the serial
    run's), the draw runs over the ranks' rows in rank order, and every
    rank grows the same trees, each over top + other rows of the
    world."""
    _text(worlds, 2, "prepart-masked-int8")
    top, other, _ = sampling.goss_counts(4000, 0.3, 0.2)
    for name in ("prepart-masked-int8", "data-masked-int8"):
        counts = worlds[2][0][name]["leaf_count"]
        assert len(counts) == int(BASE["num_iterations"])
        assert [sum(c) for c in counts] == [top + other] * len(counts)


@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("grower", list(GROWERS))
def test_int8_goss_world_matches_jax(worlds, jax_runs, P, grower):
    text = _text(worlds, P, "data-%s-int8" % grower)
    assert_alike(text, jax_runs[grower, 1], atol=5e-7)
    assert_alike(text, jax_runs[grower, 2], atol=5e-7)


@pytest.mark.parametrize("grower", list(GROWERS))
def test_float32_goss_world_first_tree_structure(worlds, serial, grower):
    got = trees_of(_text(worlds, 2, "data-%s-float32" % grower))
    want = trees_of(serial[grower, "float32"])
    assert len(got) == len(want)
    assert got[0].num_leaves == want[0].num_leaves
    for field in STRUCTURE:
        np.testing.assert_array_equal(getattr(got[0], field),
                                      getattr(want[0], field), err_msg=field)
    np.testing.assert_allclose(got[0].leaf_value, want[0].leaf_value,
                               rtol=1e-5, atol=5e-6)


def test_goss_score_gather_site(worlds, table):
    """One serial-order gather an iteration: 4 bytes a row of the largest
    shard, over the data axis, under the ``goss`` span."""
    for rank in worlds[2]:
        rec = rank["data-compacted-int8"]
        site = rec["sites"]["dp/goss_score_allgather"]
        widest = max(r["data-compacted-int8"]["rows"] for r in worlds[2])
        assert site["calls"] == int(BASE["num_iterations"])
        assert site["bytes_per_call"] == 4 * widest
        assert site["kind"] == "all_gather" and site["axis"] == "data"
        assert site["phase"] == "goss"
        assert rec["counters"]["goss/iterations"] == site["calls"]


def test_c9_jax_process_order_draws_other_rows(table):
    """ROADMAP C9: the JAX package's multi-process GOSS selection runs on
    the row layout of its score gather, the processes' shards
    (``Dataset._draw_shard_mask``) concatenated in process order
    (lightgbm_tpu/parallel/learners.py:760-835).  ``goss_mask_weights``
    ranks the rows by a stable sort, so where scores tie the layout's
    order picks the rows: at the first iteration every binary row's
    |grad| is 0.5, and over the process-order layout the draw keeps other
    top rows and other remainder rows than over serial order.  The
    port's rule draws over serial order: its ``goss_mask_weights`` there
    is the JAX serial draw, bit for bit."""
    _, path, _, y = table
    n = len(y)
    import torch
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.config import ObjectiveConfig
    from lightgbm_tpu_torch.io.metadata import Metadata
    md = Metadata()
    md.set_label(y)
    md.finalize(n)
    obj = create_objective("binary", ObjectiveConfig())
    obj.init(md, n, torch.device("cpu"))
    grad, _ = obj.get_gradients(torch.zeros(n))
    absg = sampling.goss_row_scores(grad[None]).numpy()
    assert np.unique(absg).size == 1
    cfg = JConfig()
    cfg.set(dict(BASE, data=str(path)))
    shards = [JDataset()._draw_shard_mask(cfg.io_config, r, 2, n)
              for r in range(2)]
    order = np.concatenate(shards)                # process-order layout
    top, other, amp = jsampling.goss_counts(n, 0.2, 0.1)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 0)
    serial_mask, serial_w = (np.asarray(a) for a in
                             jsampling.goss_mask_weights(
                                 key, absg, top, other, amp))
    mp_mask, mp_w = (np.asarray(a) for a in jsampling.goss_mask_weights(
        key, absg[order], top, other, amp))
    mp_rows = np.zeros(n, bool)
    mp_rows[order[mp_mask]] = True
    mp_amped = np.zeros(n, bool)
    mp_amped[order[mp_w != 1]] = True
    assert mp_rows.sum() == serial_mask.sum() == top + other
    assert not np.array_equal(mp_rows & ~mp_amped,
                              serial_mask & (serial_w == 1))   # top rows
    assert not np.array_equal(mp_amped, serial_w != 1)         # remainder
    # the port: the serial layout's draw, the JAX serial draw
    mask, w = sampling.goss_mask_weights(
        threefry.fold_in(threefry.prng_key(3), 0), torch.from_numpy(absg),
        top, other, amp)
    np.testing.assert_array_equal(mask.numpy(), serial_mask)
    np.testing.assert_array_equal(w.numpy(), serial_w)
