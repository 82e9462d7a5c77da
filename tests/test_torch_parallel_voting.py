"""The voting learner (PV-tree): lightgbm_tpu_torch worlds of 4 ranks
(gloo on the CPU, tests/test_torch_parallel.World) on a 4 x 1 grid
(``top_k`` 20: 2·top_k covers every feature, the exact regime) and a
2 x 2 grid (``top_k`` 2 or 1 against owned blocks of 5 features, the
PV-tree regime), against the port's serial run and the JAX package's
live ``tree_learner=voting`` run on the same mesh of the 8-device
virtual CPU platform (tests/conftest.py).

Tolerances (tests/test_torch_parallel.py says why):
- int8, both grids, all three growers: model text byte-equal to the
  port's serial run (int8 histograms are summed whole over the data
  shards, so every shard votes on global evidence and the best feature
  is always voted), and under ``mixed_bin=true`` too; against the JAX
  run structure exact, leaf values rtol 1e-5 / atol 5e-7;
- float32 in the exact regime: structure exact, leaf values rtol 1e-5 /
  atol F32_ATOL against the serial run and the JAX run;
- float32 in the PV-tree regime: each data shard reads the JAX package's
  contiguous row block (``is_pre_partition=true``, a file a data shard,
  as ``shard_map`` splits rows in lightgbm_tpu/parallel/learners.py:
  1126-1131), so the votes read the same local evidence as the JAX
  learner's: structure exact against it, leaf values rtol 1e-5 / atol
  F32_ATOL.  The table is integer-valued, so every shard's sample bins
  it as the whole table does;
- every rank's model text is byte-equal to every other rank's.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.split import \
    per_feature_best_scores as jper_feature_best_scores

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops.split import per_feature_best_scores
from lightgbm_tpu_torch.parallel import learners, mesh
from test_torch_parallel import (BASE, F32_ATOL, GROWERS, TrainWorld,
                                 assert_alike, jax_booster, port_serial,
                                 split_health_sites, trees_of, write_table)
from test_torch_parallel_hybrid import write_mixed

F = 9
WIDE = {"tree_learner": "voting", "num_machines": "4"}
GRID = {"tree_learner": "voting", "num_machines": "4",
        "feature_shards": "2", "top_k": "2"}
PV = dict(GRID, top_k="1", is_pre_partition="true")
GRIDS = {"4x1": WIDE, "2x2": GRID}


def write_int_table(path, n=4000, seed=5):
    """A seeded 4000 x 9 binary table of integer features (12 values each)
    as TSV, and each data shard's contiguous half as its own file;
    returns (x, y, [half paths])."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 12, size=(n, F)).astype(np.float64)
    y = ((x[:, 0] - 0.7 * x[:, 3] + 0.4 * x[:, 7] + 0.5 * x[:, 5]
          + 3.0 * rng.randn(n)) > 1.2).astype(np.float64)
    rows = np.column_stack([y, x])
    halves = []
    for d in range(2):
        half = str(path) + ".part%d" % d
        np.savetxt(half, rows[d * n // 2:(d + 1) * n // 2], delimiter="\t",
                   fmt="%.17g")
        halves.append(half)
    return x, y.astype(np.float32), halves


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("tables")
    x, y = write_table(d / "train.tsv", f=F)
    xm, ym = write_mixed(d / "mixed.tsv")
    xi, yi, halves = write_int_table(d / "ints.tsv")
    return {"plain": (d / "train.tsv", x, y), "mixed": (d / "mixed.tsv",),
            "ints": (halves, xi, yi)}


def _jobs(tables):
    jobs = [{"name": "%s-%s-int8" % (grid, g),
             "params": dict(GROWERS[g], hist_dtype="int8", **GRIDS[grid])}
            for grid in GRIDS for g in GROWERS]
    jobs += [{"name": "4x1-%s-float32" % g,
              "params": dict(GROWERS[g], hist_dtype="float32", **WIDE)}
             for g in GROWERS]
    jobs += [{"name": "pv-%s-float32" % g,
              "data_by_shard": tables["ints"][0],
              "params": dict(GROWERS[g], hist_dtype="float32", **PV)}
             for g in ("compacted", "masked")]
    jobs += [{"name": "mixed-%s-%s" % (g, m), "data": str(tables["mixed"][0]),
              "params": dict(GROWERS[g], hist_dtype="int8", mixed_bin=m,
                             max_bin="128", **GRID)}
             for g in GROWERS for m in ("true", "false")]
    jobs.append({"name": "telemetry-compacted-float32", "telemetry": True,
                 "params": dict(GROWERS["compacted"], hist_dtype="float32",
                                **GRID)})
    return jobs


@pytest.fixture(scope="module")
def started(tables, tmp_path_factory):
    """The world, started before the JAX runs so that they overlap."""
    return TrainWorld(tmp_path_factory.mktemp("voting"), 4, _jobs(tables),
                      tables["plain"][0])


@pytest.fixture(scope="module")
def jax_runs(tables, started):
    """The JAX package's voting learner: int8 on both grids under every
    grower, float32 on 4 x 1 compacted and masked, and float32 in the
    PV-tree regime on the integer table."""
    _, x, y = tables["plain"]
    jgrid = {"4x1": {"tree_learner": "voting"},
             "2x2": {"tree_learner": "voting", "feature_shards": "2",
                     "top_k": "2"}}
    runs = {(grid, g, "int8"): jax_booster(
        dict(GROWERS[g], hist_dtype="int8", **jgrid[grid]), x, y, 4)
        for grid in GRIDS for g in GROWERS}
    # the JAX package's serial masked int8 run (ROADMAP C8)
    runs["serial", "masked", "int8"] = jax_booster(
        dict(GROWERS["masked"], hist_dtype="int8"), x, y)
    _, xi, yi = tables["ints"]
    for g in ("compacted", "masked"):
        runs["4x1", g, "float32"] = jax_booster(
            dict(GROWERS[g], hist_dtype="float32", **jgrid["4x1"]), x, y, 4)
        runs["pv", g, "float32"] = jax_booster(
            dict(GROWERS[g], hist_dtype="float32", tree_learner="voting",
                 feature_shards="2", top_k="1"), xi, yi, 4)
    return runs


@pytest.fixture(scope="module")
def world(started, jax_runs):
    """[rank] -> {job: record}."""
    return started.result()


def _texts(world, name):
    texts = [rank[name]["model"] for rank in world]
    assert all(t == texts[0] for t in texts), "ranks disagree"
    return texts


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("grower", list(GROWERS))
def test_voting_int8_byte_equal_serial(world, tables, grid, grower):
    name = "%s-%s-int8" % (grid, grower)
    assert _texts(world, name)[0] == port_serial(
        dict(GROWERS[grower], hist_dtype="int8"), tables["plain"][0])
    rows = [rank[name]["rows"] for rank in world]
    assert sum(rows) == (4000 if grid == "4x1" else 8000)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("grower", list(GROWERS))
def test_voting_int8_matches_jax(world, jax_runs, grid, grower):
    assert_alike(world[0]["%s-%s-int8" % (grid, grower)]["model"],
                 jax_runs[grid, grower, "int8"], atol=5e-7)


def test_c8_jax_voting_int8_parts_from_jax_serial(world, jax_runs):
    """ROADMAP C8: the JAX package's masked voting learner in int8 is not
    its serial run's bit for bit (its leaf values part by a few 1e-8 from
    the second tree on: the voted search is another XLA program, whose
    dequantized f32 arithmetic contracts otherwise), though both
    packages document int8 parallel trees as the serial run's; the
    port's are (test_voting_int8_byte_equal_serial)."""
    got = trees_of(jax_runs["4x1", "masked", "int8"])
    want = trees_of(jax_runs["serial", "masked", "int8"])
    diffs = [float(np.max(np.abs(a.leaf_value - b.leaf_value)))
             for a, b in zip(got, want)]
    assert 0.0 < max(diffs) < 5e-7, diffs
    assert_alike(jax_runs["4x1", "masked", "int8"],
                 jax_runs["serial", "masked", "int8"], atol=5e-7)
    assert world[0]["4x1-masked-int8"]["model"] == \
        world[0]["2x2-masked-int8"]["model"]


@pytest.mark.parametrize("grower", list(GROWERS))
def test_voting_float32_exact_regime(world, tables, jax_runs, grower):
    text = _texts(world, "4x1-%s-float32" % grower)[0]
    assert_alike(text, port_serial(dict(GROWERS[grower],
                                        hist_dtype="float32"),
                                   tables["plain"][0]), atol=F32_ATOL)
    if ("4x1", grower, "float32") in jax_runs:
        assert_alike(text, jax_runs["4x1", grower, "float32"],
                     atol=F32_ATOL)


@pytest.mark.parametrize("grower", ["compacted", "masked"])
def test_voting_pv_regime_matches_jax(world, jax_runs, grower):
    """top_k=1 against blocks of 5 (V = 2): each shard's votes on its own
    rows decide which features are searched, as in the JAX learner."""
    name = "pv-%s-float32" % grower
    assert [rank[name]["rows"] for rank in world] == [2000] * 4
    assert_alike(_texts(world, name)[0], jax_runs["pv", grower, "float32"],
                 atol=F32_ATOL)


@pytest.mark.parametrize("grower", list(GROWERS))
def test_voting_packed_equals_uniform(world, tables, grower):
    packed = _texts(world, "mixed-%s-true" % grower)[0]
    assert packed == _texts(world, "mixed-%s-false" % grower)[0]
    assert packed == port_serial(dict(GROWERS[grower], hist_dtype="int8",
                                      max_bin="128"), tables["mixed"][0])


def test_voting_collective_sites(world, tables):
    """The JAX site names with their calls and payloads: the root's vote
    (k = 2 ids) and voted histograms (V = 4 features) at ``root_`` sites,
    a split's pair of children in one call of each (2 lanes), the split
    records over the feature group, the root stats over the data
    group; the health vector's sites over the data group
    (``split_health_sites``)."""
    cfg = lgt.OverallConfig()
    cfg.set(dict(BASE, data=str(tables["plain"][0])))
    B = int(lgt.Dataset.load_train(cfg.io_config).num_bins.max())
    k, V = 2, 4
    for r, rank in enumerate(world):
        rec = rank["telemetry-compacted-float32"]
        leaves = rec["num_leaves"]
        splits, trees = sum(leaves) - len(leaves), len(leaves)
        pre = "voting/leafcompact/"
        want = {pre + "root_votes_allgather": (trees, k * 4, "data"),
                pre + "votes_allgather": (splits, 2 * k * 4, "data"),
                pre + "root_voted_hist_allreduce": (trees, V * B * 12,
                                                    "data"),
                pre + "voted_hist_allreduce": (splits, 2 * V * B * 12,
                                               "data"),
                pre + "root_splitinfo_allreduce": (trees, 44, "feature"),
                pre + "splitinfo_allreduce": (splits, 88, "feature"),
                pre + "root_stats": (trees, 24, "data")}
        assert rec["counters"]["learner/voting_leafcompact"] == 1
        sites = split_health_sites(rec["sites"], trees, False)
        assert set(sites) == set(want), r
        for site, (calls, per_call, axis) in want.items():
            assert sites[site]["calls"] == calls, (r, site)
            assert sites[site]["bytes_per_call"] == per_call, (r, site)
            assert sites[site]["axis"] == axis, (r, site)


def test_per_feature_best_scores_equals_jax():
    """Each feature's best score, -inf for a masked feature, one whose
    bins leave no side min_data_in_leaf rows, and a one-bin feature."""
    import jax.numpy as jnp
    rng = np.random.RandomState(3)
    Fh, B = 7, 16
    hist = np.zeros((Fh, B, 3), np.float32)
    for f in range(Fh):
        cnt = rng.randint(0, 30, size=B).astype(np.float32)
        hist[f, :, 2] = cnt
        hist[f, :, 0] = cnt * rng.randn(B).astype(np.float32)
        hist[f, :, 1] = cnt * 0.25
    hist[4, :, :] = 0.0
    hist[4, 0] = hist[0].sum(0)           # every row in one bin: no split
    tot = hist[0].sum(0)
    nb = np.array([16, 16, 12, 16, 16, 1, 16], np.int64)
    fm = np.array([True, True, True, False, True, True, True])
    for mind in (1.0, 20.0, 1e6):
        got = per_feature_best_scores(
            torch.from_numpy(hist), torch.tensor(tot[0]),
            torch.tensor(tot[1]), torch.tensor(tot[2]), torch.from_numpy(nb),
            torch.from_numpy(fm), mind, 1e-3).numpy()
        want = np.asarray(jper_feature_best_scores(
            jnp.asarray(hist), jnp.float32(tot[0]), jnp.float32(tot[1]),
            jnp.float32(tot[2]), jnp.asarray(nb), jnp.asarray(fm), mind,
            1e-3))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        assert np.isneginf(got[[3, 4, 5]]).all()
        ok = np.isfinite(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5)
        if mind == 1e6:
            assert not ok.any()


class _Comm:
    """One rank's view of a group: ``all_gather`` stacks this rank's
    tensor with the others' given ones; ``all_reduce`` is the identity."""

    def __init__(self, others=(), rank=0):
        self.others, self.rank, self.sent = list(others), rank, []
        self.size = len(self.others) + 1

    def all_gather(self, t, site, axis="data"):
        self.sent.append((site, t.clone()))
        rows = self.others[:self.rank] + [t] + self.others[self.rank:]
        return torch.stack([torch.as_tensor(x, dtype=t.dtype).reshape(
            t.shape) for x in rows])

    def all_reduce(self, t, site, op="sum", axis="data"):
        return t.clone()


def _tied_hist(Fh=6, B=8):
    """A leaf whose features 1, 3 and 4 split alike (the best), 0 and 5
    worse, 2 not at all."""
    hist = np.zeros((Fh, B, 3), np.float32)
    good = np.zeros((B, 3), np.float32)
    good[:4] = (-4.0, 2.0, 20.0)
    good[4:] = (4.0, 2.0, 20.0)
    weak = good.copy()
    weak[:4, 0], weak[4:, 0] = -1.0, 1.0
    for f in range(Fh):
        hist[f] = good if f in (1, 3, 4) else weak
    hist[2] = 0.0
    hist[2, 0] = good.sum(0)
    return torch.from_numpy(hist)


@pytest.mark.parametrize("top_k,others,want_votes,want_feature", [
    # equal gains vote the smaller feature: 1, then 3
    (1, [], [1], 1),
    (2, [], [1, 3], 1),
    # counts tie at one vote each for 1, 0 and 5 (V = 2): the smaller ids
    # 0 and 1 are searched, and 1 wins
    (1, [[0], [5]], [1], 1),
    # 5 has two votes, 0 and 1 one each (V = 2): 5, then the smaller of
    # the tie, 0; 1 is not searched
    (1, [[5], [5], [0]], [1], 0),
])
def test_vote_tie_breaks_are_stable(top_k, others, want_votes, want_feature):
    hist = _tied_hist()
    Fh, B = hist.shape[0], hist.shape[1]
    data = _Comm(others)
    grid = mesh.Grid(data.size, 1, 0, 0, data, _Comm())
    _, fmask, nbins, schedule = learners.voting_seams(
        grid, Fh, top_k, True, "leafwise", torch.ones(Fh, dtype=torch.bool),
        torch.full((Fh,), B), True)
    tot = hist[0].sum(0)
    res = schedule.split_finder(hist[None], tot[0:1], tot[1:2], tot[2:3],
                                nbins, fmask, 1.0, 1e-3)
    site, votes = data.sent[0]
    assert site == "voting/leafwise/votes_allgather"
    assert votes[0].tolist() == want_votes
    assert int(res.feature[0]) == want_feature
