"""The feature-parallel learner: lightgbm_tpu_torch worlds of 2 and 3
ranks (gloo on the CPU, tests/test_torch_parallel.World) against the
port's serial run and the JAX package's live ``tree_learner=feature``
run, masked leaf-wise and depth-wise, float32 and int8.

Every rank histograms its owned features over every row, so each
histogram cell is the serial run's, and ``allreduce_best_split`` picks
the serial run's split: model text byte-equal to the port's serial run
in both modes (the int8 root stats come from feature 0's owner, as the
serial run reads feature 0).  Against the JAX run: structure exact, leaf
values rtol 1e-5 / atol 5e-7 in int8, atol F32_ATOL in float32
(tests/test_torch_parallel.py says why).
"""
import pytest

from test_torch_parallel import (F32_ATOL, GROWERS, TrainWorld,
                                 assert_alike, jax_booster, port_serial,
                                 write_table)

FP_GROWERS = ("masked", "depthwise")
DTYPES = ("float32", "int8")


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    path = tmp_path_factory.mktemp("table") / "train.tsv"
    x, y = write_table(path)
    return path, x, y


@pytest.fixture(scope="module")
def started(table, tmp_path_factory):
    jobs = [{"name": "%s-%s" % (g, d),
             "params": dict(GROWERS[g], hist_dtype=d, tree_learner="feature",
                            num_machines="3")}
            for g in FP_GROWERS for d in DTYPES]
    # leafwise_compact=auto resolves to the masked grower under feature
    jobs.append({"name": "auto-int8",
                 "params": dict(hist_dtype="int8", tree_learner="feature",
                                num_machines="2")})
    return {P: TrainWorld(tmp_path_factory.mktemp("fp%d" % P), P, jobs,
                          table[0])
            for P in (2, 3)}


@pytest.fixture(scope="module")
def jax_runs(table, started):
    _, x, y = table
    return {(g, d, P): jax_booster(dict(GROWERS[g], hist_dtype=d,
                                        tree_learner="feature"), x, y, P)
            for g in FP_GROWERS for d in DTYPES for P in (2, 3)}


@pytest.fixture(scope="module")
def worlds(started, jax_runs):
    return {P: w.result() for P, w in started.items()}


@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grower", FP_GROWERS)
def test_feature_parallel_byte_equal_serial(worlds, table, P, dtype, grower):
    name = "%s-%s" % (grower, dtype)
    texts = [rank[name]["model"] for rank in worlds[P]]
    assert all(t == texts[0] for t in texts), "ranks disagree"
    # every rank holds every row
    assert all(rank[name]["rows"] == 4000 for rank in worlds[P])
    assert texts[0] == port_serial(dict(GROWERS[grower], hist_dtype=dtype),
                                   table[0])


@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grower", FP_GROWERS)
def test_feature_parallel_matches_jax(worlds, jax_runs, P, dtype, grower):
    assert_alike(worlds[P][0]["%s-%s" % (grower, dtype)]["model"],
                 jax_runs[grower, dtype, P],
                 atol=F32_ATOL if dtype == "float32" else 5e-7)


@pytest.mark.parametrize("P", [2, 3])
def test_feature_parallel_auto_is_masked(worlds, P):
    texts = [rank["auto-int8"]["model"] for rank in worlds[P]]
    assert all(t == texts[0] for t in texts)
    assert texts[0] == worlds[P][0]["masked-int8"]["model"]
