"""The generators: declared shapes, the same inputs for the same seed,
the same amount of work for every seed, and binning through the port
that keeps one bin a level."""
import os

import numpy as np
import pytest

from portbench import data, run


@pytest.fixture(scope="module")
def configs():
    return {c["name"]: run._json(os.path.join(run.ROOT, c["file"]))
            for c in run.load_benchmark()["configs"]}


def small(cfg, rows):
    out = dict(cfg, rows=rows)
    if "queries" in cfg:
        out["queries"] = dict(cfg["queries"],
                              count=max(2, rows // 120))
    return out


@pytest.mark.parametrize("name", ["higgs", "mslr"])
def test_table_shapes_and_seed(configs, name):
    cfg = small(configs[name], 6000)
    a = data.make_table(cfg, 2**40 + 17)
    b = data.make_table(cfg, 2**40 + 17)
    c = data.make_table(cfg, 5)
    F = cfg["features"]
    assert a.x.shape == (6000, F) and a.x.dtype == np.float32
    assert a.codes.shape == (F, 6000) and a.y.shape == (6000,)
    assert len(a.grids) == F
    for j in range(F):
        assert np.array_equal(a.x[:, j], a.grids[j][a.codes[j]])
    assert np.array_equal(a.x, b.x) and np.array_equal(a.y, b.y)
    assert not np.array_equal(a.x, c.x)
    if name == "mslr":
        sizes = np.diff(a.query_boundaries)
        assert a.query_boundaries[-1] == 6000
        assert np.array_equal(np.sort(sizes),
                              np.sort(np.diff(c.query_boundaries)))
        assert set(np.unique(a.y)) <= {0, 1, 2, 3, 4}
    else:
        assert a.y.mean() == pytest.approx(cfg["label"]["positive_share"],
                                           abs=1e-3)


def test_published_sizes(configs):
    h, m = configs["higgs"], configs["mslr"]
    assert (h["rows"], h["features"]) == (10_500_000, 28)
    assert (m["rows"], m["features"]) == (2_270_296, 136)
    sizes = data.query_sizes(m)
    assert sizes.sum() == m["rows"] and sizes.size == 18_919
    assert sizes.max() == m["queries"]["max"] and sizes.min() >= 1
    assert 110 < sizes.mean() < 130


@pytest.mark.parametrize("name", ["higgs", "mslr"])
def test_binning_keeps_one_bin_a_level(configs, name):
    import lightgbm_tpu_torch as lgt
    cfg = small(configs[name], 60000)
    t = data.make_table(cfg, 3)
    ds = lgt.Dataset.from_arrays(t.x, t.y, max_bin=255)
    assert np.array_equal(ds.num_bins, [g.size for g in t.grids])
    assert np.array_equal(ds.bins, t.codes)


def test_requests_and_ensemble(configs):
    traffic = run._json(run.BENCH_DIR + "/traffic/batch_closed.json")
    sizes = data.request_sizes(traffic)
    assert sizes.min() >= traffic["rows_min"]
    assert sizes.max() <= traffic["rows_max"]
    s1 = data.client_streams(traffic, 1, 100000)
    s2 = data.client_streams(traffic, 2, 100000)
    assert len(s1) == traffic["clients"]
    assert sorted(z for s in s1 for z, _ in s) == sorted(
        z for s in s2 for z, _ in s)
    assert all(o + z <= 100000 for s in s1 for z, o in s)
    grids = data.make_pool(configs["higgs"], 4, 100)[2]
    ens = data.random_ensemble(grids, 3, 31, 9)
    import lightgbm_tpu_torch as lgt
    b = lgt.GBDT()
    b.models_from_string(data.model_text(ens, 28))
    assert len(b.models) == 3
    for t, m in enumerate(b.models):
        assert m.num_leaves == 31
        assert np.array_equal(m.left_child, ens.left_child[t])
        assert np.array_equal(m.threshold, ens.threshold[t])
        assert np.array_equal(m.leaf_value, ens.leaf_value[t])
