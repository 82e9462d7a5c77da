"""The data-parallel learner's rows: the shard draw, the distributed bin
finder, the objectives on shards and per-shard bagging, for
lightgbm_tpu_torch worlds (gloo on the CPU,
tests/test_torch_parallel.World) against the JAX package and the port's
serial run.

- Shard draw: each rank's rows of ``Dataset.load_train(io, rank=r,
  num_machines=P)`` (indices, bins, labels, query boundaries) equal the
  JAX package's, with and without a query side file; the shards
  partition the file; ``is_pre_partition=true`` keeps every row.
- Bin finder: ``distributed_bin_finder``'s mappers are byte-equal to
  local bin finding.
- Objectives under ``tree_learner=data`` int8: regression, multiclass
  (K = 3) and lambdarank on query-atomic shards, model text byte-equal
  to the port's serial run.
- Bagging: each rank's bag mask is the JAX rule's draw over its own rows
  (``RandomState(bagging_seed)``); the ranks' models are byte-equal.
"""
import numpy as np
import pytest

from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.objectives import create_objective as jcreate

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.io.binning import BinMapper
from lightgbm_tpu_torch.utils import log
from test_torch_parallel import BASE, TrainWorld, port_serial, write_table

DP = {"hist_dtype": "int8", "tree_learner": "data", "num_machines": "2"}
BAG = {"bagging_fraction": "0.7", "bagging_freq": "1", "bagging_seed": "5"}


def _write(path, y, x, queries=None):
    np.savetxt(path, np.column_stack([y, x]), delimiter="\t", fmt="%.17g")
    if queries is not None:
        np.savetxt(str(path) + ".query", queries, fmt="%d")


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("tables")
    rng = np.random.RandomState(11)
    x = rng.randn(3000, 8)
    tables = {"binary": d / "binary.tsv"}
    write_table(tables["binary"])
    tables["regression"] = d / "regression.tsv"
    _write(tables["regression"],
           x[:, 0] - 0.5 * x[:, 1] + 0.3 * rng.randn(3000), x)
    tables["multiclass"] = d / "multiclass.tsv"
    _write(tables["multiclass"],
           np.argmax(x[:, :3] + 0.5 * rng.randn(3000, 3), 1), x)
    counts = rng.randint(10, 50, size=100)
    n = int(counts.sum())
    xr = rng.randn(n, 8)
    rel = np.clip(np.round(xr[:, 0] + 0.5 * rng.randn(n) + 1.5), 0, 3)
    tables["lambdarank"] = d / "rank.tsv"
    _write(tables["lambdarank"], rel, xr, counts)
    return tables


OBJECTIVES = {"regression": {"objective": "regression"},
              "multiclass": {"objective": "multiclass", "num_class": "3"},
              "lambdarank": {"objective": "lambdarank"}}


@pytest.fixture(scope="module")
def world(tables, tmp_path_factory):
    jobs = [{"name": name, "data": str(tables[name]),
             "params": dict(DP, **params)}
            for name, params in OBJECTIVES.items()]
    jobs.append({"name": "bagging", "params": dict(DP, **BAG)})
    jobs.append({"name": "bin_finder", "bin_finder": True,
                 "params": dict(DP, num_iterations="1")})
    return TrainWorld(tmp_path_factory.mktemp("w"), 2, jobs,
                      tables["binary"]).result()


def _io(path, *, package, **extra):
    cfg = (JConfig if package == "jax" else lgt.OverallConfig)()
    cfg.set(dict(BASE, data=str(path), **extra))
    return cfg.io_config


@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("name", ["binary", "lambdarank"])
def test_shard_draw_equals_jax(tables, name, P):
    path = tables[name]
    rows = []
    for r in range(P):
        got = lgt.Dataset.load_train(_io(path, package="port"), rank=r,
                                     num_machines=P)
        want = JDataset.load_train(_io(path, package="jax"), rank=r,
                                   num_machines=P)
        np.testing.assert_array_equal(got.used_data_indices,
                                      want.used_data_indices)
        np.testing.assert_array_equal(got.bins, np.asarray(want.bins))
        np.testing.assert_array_equal(got.metadata.label,
                                      want.metadata.label)
        assert got.num_data == want.num_data
        assert got.global_num_data == want.global_num_data
        assert got.shard_query_atomic == want.shard_query_atomic
        if name == "lambdarank":
            assert got.shard_query_atomic
            np.testing.assert_array_equal(got.metadata.query_boundaries,
                                          want.metadata.query_boundaries)
        rows.append(got.used_data_indices)
    # the shards partition the file
    every = np.sort(np.concatenate(rows))
    np.testing.assert_array_equal(every, np.arange(every.size))
    assert every.size == lgt.Dataset.load_train(
        _io(path, package="port")).num_data


@pytest.mark.parametrize("name", ["binary", "lambdarank"])
def test_from_arrays_shard_equals_load_train(tables, name):
    """In-memory arrays take the file's shard draw (the data seed)."""
    path = tables[name]
    data = np.loadtxt(path)
    qb = None
    if name == "lambdarank":
        counts = np.loadtxt(str(path) + ".query", dtype=np.int64)
        qb = np.concatenate([[0], np.cumsum(counts)])
    for r in range(2):
        got = lgt.Dataset.from_arrays(data[:, 1:], data[:, 0], max_bin=32,
                                      query_boundaries=qb, rank=r,
                                      num_machines=2)
        want = lgt.Dataset.load_train(_io(path, package="port"), rank=r,
                                      num_machines=2)
        np.testing.assert_array_equal(got.used_data_indices,
                                      want.used_data_indices)
        np.testing.assert_array_equal(got.bins, want.bins)
        np.testing.assert_array_equal(got.metadata.label,
                                      want.metadata.label)
        if qb is not None:
            np.testing.assert_array_equal(got.metadata.query_boundaries,
                                          want.metadata.query_boundaries)
        assert got.global_num_data == want.global_num_data


def test_pre_partition_keeps_every_row(tables):
    ds = lgt.Dataset.load_train(
        _io(tables["binary"], package="port", is_pre_partition="true"),
        rank=1, num_machines=2)
    assert ds.used_data_indices is None
    assert ds.num_data == 4000


def test_in_file_query_column_is_not_query_atomic(tables, tmp_path):
    """A query column read after the draw: the draw was per record, so
    lambdarank refuses the shard (the JAX gbdt.init guard)."""
    data = np.loadtxt(tables["lambdarank"])
    counts = np.loadtxt(str(tables["lambdarank"]) + ".query", dtype=int)
    qid = np.repeat(np.arange(counts.size), counts)
    path = tmp_path / "qcol.tsv"
    np.savetxt(path, np.column_stack([data, qid]), delimiter="\t",
               fmt="%.17g")
    ds = lgt.Dataset.load_train(
        _io(path, package="port", group_column="9"), rank=0, num_machines=2)
    assert not ds.shard_query_atomic
    booster = lgt.GBDT()
    learner = type("L", (), {"world": 2, "shards_rows": True,
                             "bind": lambda self, device: device})()
    cfg = lgt.OverallConfig()
    cfg.set(dict(BASE, objective="lambdarank"), require_data=False)
    from lightgbm_tpu_torch.objectives import create_objective
    with pytest.raises(log.Fatal, match="query-atomic"):
        booster.init(cfg.boosting_config, ds,
                     create_objective("lambdarank", cfg.objective_config),
                     device="cpu", learner=learner)


def test_distributed_bin_finder_equals_local(world, tables):
    sample = np.loadtxt(tables["binary"])[:, 1:]
    want = []
    for j in range(sample.shape[1]):
        m = BinMapper()
        m.find_bin(sample[:, j], int(BASE["max_bin"]))
        want.append(m.to_bytes().hex())
    for rank in world:
        assert rank["bin_finder"]["mappers"] == want


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_objectives_byte_equal_serial(world, tables, name):
    texts = [rank[name]["model"] for rank in world]
    assert texts[0] == texts[1], "ranks disagree"
    assert texts[0] == port_serial(dict(OBJECTIVES[name],
                                        hist_dtype="int8"), tables[name])


def test_bagging_each_rank_draws_its_own_rows(world, tables):
    recs = [rank["bagging"] for rank in world]
    assert recs[0]["model"] == recs[1]["model"]
    data = np.loadtxt(tables["binary"])
    for rec in recs:
        idx = np.asarray(rec["indices"])
        cfg = JConfig()
        cfg.set(dict(BASE, **BAG), require_data=False)
        j = JGBDT()
        j.init(cfg.boosting_config,
               JDataset.from_arrays(data[idx, 1:],
                                    data[idx, 0].astype(np.float32),
                                    max_bin=32),
               jcreate(cfg.objective_type, cfg.objective_config))
        for it in range(int(BASE["num_iterations"])):
            j._draw_bag_mask(it)
        np.testing.assert_array_equal(np.asarray(rec["bag_mask"]),
                                      np.asarray(j._bag_mask))
        assert 0 < sum(rec["bag_mask"]) < idx.size
