"""The hybrid learner: lightgbm_tpu_torch worlds of 4 ranks on a 2 x 2
grid (gloo on the CPU, tests/test_torch_parallel.World; rows sharded
over the data index, feature blocks owned over the feature index)
against the port's serial run and the JAX package's live
``tree_learner=hybrid`` run on a 2 x 2 mesh of the 8-device virtual CPU
platform (tests/conftest.py).

The table has 9 features, so the feature index's blocks are 5 and 4
features wide and the last owned block carries a padding lane.

Tolerances (tests/test_torch_parallel.py says why):
- int8 and stochastic int8, all three growers: model text byte-equal to
  the port's serial run (the owned block's int32 sums are the serial
  histogram's cells; the int8 root stats come from feature 0's owner);
  against the JAX run structure exact, leaf values rtol 1e-5 / atol
  5e-7;
- float32 and bfloat16: structure exact, leaf values rtol 1e-5 / atol
  F32_ATOL against the serial run, float32 against the JAX run too;
- block-local mixed-bin packing (``mixed_bin=true`` on a table with
  narrow and wide columns in each block): the int8 model text of the
  uniform layout, byte for byte;
- every rank's model text is byte-equal to every other rank's.
"""
import numpy as np
import pytest

from lightgbm_tpu.io.binning import \
    plan_feature_packing_blocked as jplan_blocked
from lightgbm_tpu.parallel import learners as jlearners
from lightgbm_tpu.parallel.mesh import factor_machines as jfactor
from lightgbm_tpu.utils import log as jlog

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.io.binning import plan_feature_packing_blocked
from lightgbm_tpu_torch.parallel import learners, mesh
from lightgbm_tpu_torch.utils import log
from test_torch_parallel import (BASE, F32_ATOL, GROWERS, TrainWorld,
                                 assert_alike, jax_booster, port_serial,
                                 split_health_sites, write_table)

F = 9
GRID = {"tree_learner": "hybrid", "num_machines": "4",
        "feature_shards": "2"}
MIXED = {"max_bin": "128"}


def write_mixed(path, n=4000, seed=11):
    """A seeded 4000 x 9 binary table whose two ownership blocks (5 and 4
    features) each hold narrow (3-33 values) and wide (continuous)
    columns, as TSV; returns (x, y)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, F)
    for j, card in zip((0, 1, 4, 6, 8), (3, 5, 9, 17, 33)):
        x[:, j] = np.clip(((x[:, j] + 3.0) * card / 6.0).astype(int), 0,
                          card - 1)
    y = ((0.8 * x[:, 2] - 0.5 * x[:, 5] + 0.3 * x[:, 1] - 0.2 * x[:, 6]
          + 0.4 * rng.randn(n)) > 0).astype(np.float64)
    np.savetxt(path, np.column_stack([y, x]), delimiter="\t", fmt="%.17g")
    return x, y.astype(np.float32)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("tables")
    x, y = write_table(d / "train.tsv", f=F)
    xm, ym = write_mixed(d / "mixed.tsv")
    return {"plain": (d / "train.tsv", x, y), "mixed": (d / "mixed.tsv", xm, ym)}


def _jobs(tables):
    jobs = [{"name": "%s-%s" % (g, d),
             "params": dict(GROWERS[g], hist_dtype=d, **GRID)}
            for g in GROWERS for d in ("int8", "float32")]
    jobs += [{"name": "compacted-int8_sr",
              "params": dict(GROWERS["compacted"], hist_dtype="int8",
                             quant_rounding="stochastic", **GRID)},
             {"name": "masked-bfloat16",
              "params": dict(GROWERS["masked"], hist_dtype="bfloat16",
                             **GRID)},
             # feature_shards=0 factors 4 ranks as 2 x 2
             {"name": "auto-grid-int8",
              "params": dict(GROWERS["depthwise"], hist_dtype="int8",
                             tree_learner="hybrid", num_machines="4")}]
    jobs += [{"name": "mixed-%s-%s" % (g, m), "data": str(tables["mixed"][0]),
              "telemetry": m == "true",
              "params": dict(GROWERS[g], hist_dtype="int8", mixed_bin=m,
                             **MIXED, **GRID)}
             for g in GROWERS for m in ("true", "false")]
    jobs += [{"name": "telemetry-%s-%s" % (g, d), "telemetry": True,
              "params": dict(GROWERS[g], hist_dtype=d, **GRID)}
             for g, d in (("compacted", "int8"), ("masked", "float32"))]
    return jobs


@pytest.fixture(scope="module")
def started(tables, tmp_path_factory):
    """The world, started before the JAX runs so that they overlap."""
    return TrainWorld(tmp_path_factory.mktemp("hybrid"), 4, _jobs(tables),
                      tables["plain"][0])


@pytest.fixture(scope="module")
def jax_runs(tables, started):
    """The JAX package's hybrid learner on a 2 x 2 mesh, int8 under every
    grower and float32 compacted and masked."""
    _, x, y = tables["plain"]
    runs = {(g, "int8"): jax_booster(dict(GROWERS[g], hist_dtype="int8",
                                          tree_learner="hybrid",
                                          feature_shards="2"), x, y, 4)
            for g in GROWERS}
    for g in ("compacted", "masked"):
        runs[g, "float32"] = jax_booster(
            dict(GROWERS[g], hist_dtype="float32", tree_learner="hybrid",
                 feature_shards="2"), x, y, 4)
    return runs


@pytest.fixture(scope="module")
def world(started, jax_runs):
    """[rank] -> {job: record}."""
    return started.result()


def _texts(world, name):
    texts = [rank[name]["model"] for rank in world]
    assert all(t == texts[0] for t in texts), "ranks disagree"
    return texts


@pytest.mark.parametrize("grower", list(GROWERS))
def test_hybrid_int8_byte_equal_serial(world, tables, grower):
    name = "%s-int8" % grower
    texts = _texts(world, name)
    assert texts[0] == port_serial(dict(GROWERS[grower], hist_dtype="int8"),
                                   tables["plain"][0])
    # the ranks of one feature group hold the same rows, the two data
    # shards every row between them
    rows = [rank[name]["rows"] for rank in world]
    assert rows[0] == rows[1] and rows[2] == rows[3]
    assert rows[0] + rows[2] == 4000


@pytest.mark.parametrize("grower", list(GROWERS))
def test_hybrid_int8_matches_jax(world, jax_runs, grower):
    assert_alike(world[0]["%s-int8" % grower]["model"],
                 jax_runs[grower, "int8"], atol=5e-7)


@pytest.mark.parametrize("grower", list(GROWERS))
def test_hybrid_float32_matches_serial_and_jax(world, tables, jax_runs,
                                               grower):
    text = _texts(world, "%s-float32" % grower)[0]
    assert_alike(text, port_serial(dict(GROWERS[grower],
                                        hist_dtype="float32"),
                                   tables["plain"][0]), atol=F32_ATOL)
    if (grower, "float32") in jax_runs:
        assert_alike(text, jax_runs[grower, "float32"], atol=F32_ATOL)


def test_hybrid_other_modes(world, tables):
    """Stochastic int8 is the serial run's byte for byte; bfloat16 alike;
    feature_shards=0 factors 4 ranks as 2 x 2 (the explicit grid's
    text)."""
    path = tables["plain"][0]
    assert _texts(world, "compacted-int8_sr")[0] == port_serial(
        dict(GROWERS["compacted"], hist_dtype="int8",
             quant_rounding="stochastic"), path)
    assert_alike(_texts(world, "masked-bfloat16")[0],
                 port_serial(dict(GROWERS["masked"],
                                  hist_dtype="bfloat16"), path),
                 atol=F32_ATOL)
    assert _texts(world, "auto-grid-int8")[0] == \
        world[0]["depthwise-int8"]["model"]


@pytest.mark.parametrize("grower", list(GROWERS))
def test_hybrid_packed_equals_uniform(world, tables, started, grower):
    """mixed_bin=true plans the block-local layout (both blocks hold 2
    narrow features in their narrow segment) and grows the uniform
    layout's trees, which are the serial run's."""
    packed = _texts(world, "mixed-%s-true" % grower)[0]
    assert packed == _texts(world, "mixed-%s-false" % grower)[0]
    assert packed == port_serial(dict(GROWERS[grower], hist_dtype="int8",
                                      **MIXED), tables["mixed"][0])
    for rank in world:
        counters = rank["mixed-%s-true" % grower]["counters"]
        assert counters["hist/mixedbin_blocked"] == 1
        assert counters["hist/mixedbin_on"] == 1
    with open(started.world.world.logs[0].name) as f:    # rank0.log
        assert "mixed-bin packing (block-local, block=5): 2 narrow" \
            in f.read()


def test_hybrid_collective_sites(world, tables):
    """Each site a rank ran, with its calls and the payload it sent (JAX
    site names): the owned block (5 features, padded) a split, the whole
    histogram at the root, the split records over the feature group;
    the health vector's sites over the data group
    (``split_health_sites``)."""
    cfg = lgt.OverallConfig()
    cfg.set(dict(BASE, data=str(tables["plain"][0])))
    B = int(lgt.Dataset.load_train(cfg.io_config).num_bins.max())
    Fb = 5
    for r, rank in enumerate(world):
        rec = rank["telemetry-compacted-int8"]
        leaves = rec["num_leaves"]
        splits, trees = sum(leaves) - len(leaves), len(leaves)
        pre = "hybrid/leafcompact/"
        want = {pre + "own_block_int_allreduce": (splits, Fb * B * 12),
                pre + "root_hist": (trees, F * B * 12),
                pre + "splitinfo_allreduce": (trees + splits, 88),
                "hist/quant_scale_pmax": (trees + splits, 8)}
        _check_sites(split_health_sites(rec["sites"], trees, True), want, r)
        assert rec["counters"]["allhosts/partition/plain"] == \
            4 * rec["counters"]["partition/plain"]
        assert rec["counters"]["learner/hybrid_leafcompact"] == 1
        rec = rank["telemetry-masked-float32"]
        leaves = rec["num_leaves"]
        splits, trees = sum(leaves) - len(leaves), len(leaves)
        assert rec["counters"]["learner/hybrid_leafwise"] == 1
        pre = "hybrid/leafwise/"
        want = {pre + "hist_allreduce": (splits, Fb * B * 12),
                pre + "root_hist": (trees, Fb * B * 12),
                pre + "root_stats": (trees, 24),
                pre + "splitinfo_allreduce": (trees + splits, 88)}
        _check_sites(split_health_sites(rec["sites"], trees, False), want,
                     r)


def _check_sites(sites, want, r):
    assert set(sites) == set(want), r
    for site, (calls, per_call) in want.items():
        assert sites[site]["calls"] == calls, (r, site)
        assert sites[site]["bytes_per_call"] == per_call, (r, site)
        assert sites[site]["phase"] == "grow"
    axis = {"splitinfo_allreduce": "feature"}
    for site, v in sites.items():
        assert v["axis"] == axis.get(site.rsplit("/", 1)[-1], "data"), site


@pytest.mark.parametrize("voting", [False, True])
def test_factor_machines_equals_jax(voting):
    for n in range(1, 13):
        for fs in range(0, n + 1):
            if fs and n % fs:
                with pytest.raises(jlog.LightGBMError) as want:
                    jfactor(n, fs, voting)
                with pytest.raises(log.Fatal) as got:
                    mesh.factor_machines(n, fs, voting)
                assert str(got.value) == str(want.value)
            else:
                assert mesh.factor_machines(n, fs, voting) == \
                    jfactor(n, fs, voting)


@pytest.mark.parametrize("num_bins,block,shards", [
    ([5, 64, 254, 254, 3, 254, 40, 254, 2], 5, 2),     # both blocks mixed
    ([5, 64, 254, 254, 3, 254, 40, 254, 2], 3, 3),
    ([2, 254, 3, 254, 4, 254, 5, 254], 2, 4),
    ([5, 6, 7, 254, 254, 254, 254, 254], 4, 2),      # a block of no narrow
    ([5, 254, 254, 254, 254], 2, 4),                  # a shard of padding
    ([5, 6, 7], 2, 2),                                # one class
    ([5, 254, 6, 254, 7], 5, 1),
])
def test_blocked_pack_spec_equals_jax(num_bins, block, shards):
    got = plan_feature_packing_blocked(num_bins, 254, block, shards=shards)
    want = jplan_blocked(num_bins, 254, block, shards=shards)
    if want is None:
        assert got is None
        return
    assert (got.widths, got.counts, got.block, got.perm) == \
        (want.widths, want.counts, want.block, want.perm)
    assert got.c2p == want.c2p and got.ranges == want.ranges
    bv, jbv = got.block_view, want.block_view
    assert (bv.widths, bv.counts, bv.perm, bv.ranges, bv.c2p) == \
        (jbv.widths, jbv.counts, jbv.perm, jbv.ranges, jbv.c2p)
    # every block's storage rows are its own canonical features
    for s in range(0, len(num_bins), block):
        assert sorted(got.perm[s:s + block]) == list(
            range(s, min(s + block, len(num_bins))))
    # each owned block's gather puts the block back in canonical order
    import jax.numpy as jnp
    F = len(num_bins)
    for f in range(shards):
        Fb, _, own, _ = learners._owned_block(F, shards, f)
        jown = jnp.minimum(f * Fb + jnp.arange(Fb), F - 1)
        np.testing.assert_array_equal(
            learners._block_feat_gather(got, own, f, Fb, "cpu").numpy(),
            np.asarray(jlearners._block_feat_gather(want, jown, f, Fb)))
    assert plan_feature_packing_blocked(num_bins, 254, block, mode="false",
                                        shards=shards) is None


def test_feature_groups_must_agree_on_rows(monkeypatch):
    """Under is_pre_partition each rank reads its own file: a feature
    group whose ranks hold different row counts is a Fatal naming it."""
    learner = object.__new__(learners.HybridLearner)
    learner.ds, learner.fs = 2, 2
    monkeypatch.setattr(mesh, "all_gather_object",
                        lambda obj: [100, 100, 90, 91])
    with pytest.raises(log.Fatal, match="data shard 1 .ranks 2-3. hold "
                                        r"\[90, 91\] rows"):
        learner.agree_rows(100)
    monkeypatch.setattr(mesh, "all_gather_object",
                        lambda obj: [100, 100, 90, 90])
    learner.agree_rows(100)


@pytest.mark.parametrize("params,message", [
    ({"feature_shards": "3", "num_machines": "4"},
     "feature_shards=3 does not divide num_machines=4"),
    ({"goss": "true", "num_machines": "4", "bagging_fraction": "0.5",
      "bagging_freq": "1"}, "Cannot use bagging in GOSS mode"),
])
def test_hybrid_config_refusals(params, message):
    cfg = lgt.OverallConfig()
    with pytest.raises(log.Fatal, match=message):
        cfg.set(dict({"objective": "binary", "tree_learner": "hybrid"},
                     **params), require_data=False)
