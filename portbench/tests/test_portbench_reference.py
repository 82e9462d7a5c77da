"""The plain reference against the port at a tiny size on the CPU: its
replay of the port's trees, its gradients and its walk agree with what
the port computed (the test imports both; the reference imports none of
the port)."""
import numpy as np
import pytest
import torch

from portbench import data, run, train
from portbench.reference import trees as rtrees
from portbench.reference.objectives import binary as rbinary, \
    lambdarank as rrank

# higgs.train, the binary objective on the higgs table, is out of
# BENCHMARK.json (its rate follows the host's phases: PERF.md, Open
# questions); its check is tested here all the same
HIGGS_TRAIN = {"name": "higgs.train", "config": "higgs", "traffic": "train",
               "chips": 1, "why": "the binary objective's check"}


def bench():
    b = run.load_benchmark()
    return dict(b, workloads=b["workloads"] + [HIGGS_TRAIN])


TINY = {
    "higgs.train": {"config": {"rows": 8000}},
    "mslr.train": {"config": {"rows": 6000, "queries": {
        "count": 50, "median": 90, "sigma": 0.75, "max": 400}}},
    "higgs.serve": {"config": {"num_trees": 20}, "traffic": {
        "pool_rows": 50000, "rows_min": 16, "rows_max": 2048,
        "check_requests": 8}},
}


def tiny_params(workload, **extra):
    cfg = run.resolve(bench(), workload)[1]
    params = dict(cfg["params"], num_leaves=31, min_sum_hessian_in_leaf=20,
                  **extra)
    ov = {k: dict(v) for k, v in TINY[workload].items()}
    ov["config"]["params"] = params
    return ov


@pytest.mark.parametrize("workload", ["higgs.train", "mslr.train"])
def test_training_cell_agrees_on_cpu(workload):
    r = run.run_cell(workload, 2**33 + 5, 0.5, False, device="cpu",
                     bench=bench(), overrides=tiny_params(workload))
    c = {k: v["value"] for k, v in r["checks"].items()}
    assert c["trees_short"] == 0
    # the port's CPU histograms add float32 values in float32
    # (index_add_), so sums over thousands of rows carry ~1e-4 of their
    # size; the card's are fixed point, exact
    assert c["split_gap"] < 1e-5
    assert c["root_gain_gap"] < 1e-5
    assert c["leaf_gap"] < 3e-3
    assert c["score_gap"] < 3e-3
    assert r["attempted"] >= 1 and r["failed"] == 0


def test_serving_cell_agrees_on_cpu():
    r = run.run_cell("higgs.serve", 2**35 + 1, 1.0, False, device="cpu",
                     overrides=TINY["higgs.serve"])
    assert r["correct"], r["checks"]
    assert r["checks"]["score_gap"]["value"] < 1e-5


def test_walks_match_the_engine():
    cfg = run.resolve(run.load_benchmark(), "higgs.serve")[1]
    x, codes, grids = data.make_pool(cfg, 8, 3000)
    ens = data.random_ensemble(grids, 12, 63, 8)
    import lightgbm_tpu_torch as lgt
    b = lgt.GBDT()
    b.device = torch.device("cpu")
    b.models_from_string(data.model_text(ens, 28))
    got = b.serving_engine().scores(x)[0]
    want = rtrees.walk_values(torch.as_tensor(x, dtype=torch.float64),
                              ens.split_feature, ens.threshold,
                              ens.left_child, ens.right_child,
                              ens.leaf_value).numpy()
    assert np.allclose(got, want, rtol=1e-6, atol=1e-6)
    # the level-code walk of one tree is the raw walk of it
    cut = rtrees.level_cuts(grids, ens.split_feature[0], ens.threshold[0])
    one = rtrees.walk_codes(torch.as_tensor(codes), ens.split_feature[0],
                            cut, ens.left_child[0], ens.right_child[0],
                            ens.leaf_value[0]).numpy()
    raw = rtrees.walk_values(torch.as_tensor(x, dtype=torch.float64),
                             ens.split_feature[:1], ens.threshold[:1],
                             ens.left_child[:1], ens.right_child[:1],
                             ens.leaf_value[:1]).numpy()
    assert np.array_equal(one, raw)


def test_gradients_match_the_port():
    from types import SimpleNamespace
    from lightgbm_tpu_torch.objectives.binary import BinaryLogloss
    from lightgbm_tpu_torch.objectives.rank import LambdarankNDCG
    cfg = dict(run.resolve(run.load_benchmark(), "mslr.train")[1],
               **TINY["mslr.train"]["config"])
    t = data.make_table(cfg, 4)
    N = t.y.size
    score = torch.as_tensor(np.random.default_rng(1).normal(0, 0.3, N)
                            .astype(np.float32))
    score[1::7] = score[::7][:score[1::7].numel()]      # ties
    md = SimpleNamespace(label=t.y, weights=None,
                         query_boundaries=t.query_boundaries)
    rank = LambdarankNDCG(SimpleNamespace(sigmoid=1.0, max_position=20,
                                          label_gain=2.0 ** np.arange(31) - 1))
    rank.init(md, N, torch.device("cpu"))
    pg, ph = rank.get_gradients(score)
    rg, rh = rrank.LambdaRank(t.y, t.query_boundaries, "cpu")(score)
    assert torch.allclose(pg.double(), rg, rtol=1e-5, atol=1e-7)
    assert torch.allclose(ph.double(), rh, rtol=1e-5, atol=1e-7)
    yb = (t.y > 1).astype(np.float32)
    binary = BinaryLogloss(SimpleNamespace(is_unbalance=False, sigmoid=1.0))
    binary.init(SimpleNamespace(label=yb, weights=None), N,
                torch.device("cpu"))
    pg, ph = binary.get_gradients(score)
    rg, rh = rbinary.binary(score, torch.as_tensor(yb))
    assert torch.allclose(pg.double(), rg, rtol=1e-6)
    assert torch.allclose(ph.double(), rh, rtol=1e-6)


def test_replay_finds_a_wrong_split():
    """A tree whose root cut is moved loses gain the replay sees."""
    cfg = dict(run.resolve(bench(), "higgs.train")[1],
               **tiny_params("higgs.train")["config"])
    traffic = run.resolve(bench(), "higgs.train")[2]
    st = train.setup(cfg, traffic, 12, "cpu")
    t = st["booster"].models[0]
    codes = torch.as_tensor(st["table"].codes)
    h = rtrees.Histogrammer(codes, np.array([g.size for g in
                                             st["table"].grids]))
    g, hs = rbinary.binary(torch.zeros(codes.shape[1]),
                              torch.as_tensor(st["table"].y))
    cut = rtrees.level_cuts(st["table"].grids, t.split_feature_real,
                            t.threshold)
    args = (t.left_child, t.right_child, t.leaf_value, 31, 0.1, 0.0, 20.0)
    good = rtrees.replay(h, g, hs, t.split_feature_real, cut, *args)
    assert good.split_gap < 1e-9
    bad_cut = cut.copy()
    bad_cut[0] = max(cut[0] - 20, 0)
    bad = rtrees.replay(h, g, hs, t.split_feature_real, bad_cut, *args)
    assert bad.split_gap > 1e-4
