"""The cells on the card.

- Each cell at a small size, traced: the run ends with its per-layer
  metrics and the device block a result needs, and nothing lost.  Its
  numbers are not held to the cells' limits, which were read at the
  cells' own sizes (PERF.md §2).
- Each cell at its own size under its own limits: the sound program's
  run is correct and the control's is not (control.py, one seed; the
  window's trees are replayed too).
"""
import pytest

from portbench import control, run

SMALL = {
    "mslr.train": {"config": {"rows": 120000, "queries": {
        "count": 1000, "median": 90, "sigma": 0.75, "max": 1251}}},
    "higgs.serve": {"config": {"num_trees": 100},
                    "traffic": {"trace_seconds": 3}},
}
SEED = 2**31 + 11


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_small_cell_on_the_card(card, workload):
    r = run.run_cell(workload, SEED, 3.0, True, device=card,
                     overrides=SMALL[workload])
    for name in ("trees_short", "requests_lost"):
        if name in r["checks"]:
            assert r["checks"][name]["value"] == 0, r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    names = {m["name"] for m in run.resolve(run.load_benchmark(),
                                            workload)[5]}
    assert set(r["metrics"]) == names
    for name, m in r["metrics"].items():
        if name.endswith("_roofline") or "mfu" in name:
            assert 0 < m["value"] <= 105, (name, m)
    assert run.forbidden_loaded() == []


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_cell_and_control_at_their_own_size(card, workload):
    _, cfg, traffic, limits, _, _ = run.resolve(run.load_benchmark(),
                                                workload)
    if traffic["kind"] == "train":
        rows = control.train_readings(cfg, traffic, SEED, card, True,
                                      faults=())
    else:
        rows = control.serve_readings(cfg, traffic, SEED, card, True, 10.0,
                                      faults=())
    got = dict(rows)

    def correct(numbers):
        return all(v <= limits[k] for k, v in numbers.items())
    sound = [v for k, v in got.items() if k == "program"]
    ctl = [v for k, v in got.items() if k.startswith("control")]
    assert len(sound) == 1 and len(ctl) == 1
    assert correct(sound[0]), sound[0]
    assert not correct(ctl[0]), ctl[0]
