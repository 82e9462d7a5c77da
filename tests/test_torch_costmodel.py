"""lightgbm_tpu_torch.costmodel: the kernel roofline and the build record.

The JAX module gets its costs from XLA's cost analysis, which the port
has no counterpart of; the port files analytic costs at every launch.
Checked here on the CPU, against the JAX module live where the two share
a contract:

- the roofline block and the compile block carry the JAX blocks' keys
  and JSON types;
- the peak table resolves the H100 (3.35 TB/s HBM, the datasheet's dense
  tensor rates) and leaves an unknown kind, the CPU included,
  ``unavailable`` with the fractions absent, as the JAX module does;
- every launch (a plain version here) files the bytes of PERF.md's bound
  formulas: ``bin_bytes·N·F + side·N + F·B·3·C·4`` for the histogram
  (side 12 float, 7 int8, 9 the pane entry) and ``2·R·cnt`` for the
  partition, one note a call;
- a training run's roofline joins those notes to its measured spans, and
  the attained rates are the notes over the seconds;
- the compile block records the native parser's build or cached load.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lightgbm_tpu import costmodel as jcostmodel

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import costmodel, lifecycle, telemetry
from lightgbm_tpu_torch.ops import compact, hist_cuda
from lightgbm_tpu_torch.ops.histogram import histogram_leafbatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def no_leaks():
    yield
    left = lifecycle.leaks()
    for _, _, closer in left:
        closer()
    assert not left, [(k, n) for k, n, _ in left]


@pytest.fixture
def armed():
    telemetry.enable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


def test_peak_table():
    peaks = costmodel.resolve_peaks(H100)
    assert peaks["hbm_bytes_per_sec"] == 3.35e12
    assert peaks["flops_per_sec"] == 989.4e12
    assert peaks["int8_ops_per_sec"] == 1978.9e12
    assert set(jcostmodel.resolve_peaks("TPU v5 lite")) <= set(peaks)
    for kind in ("cpu", "NVIDIA A100-SXM4-80GB", "", None):
        assert costmodel.resolve_peaks(kind) is None
        assert jcostmodel.resolve_peaks(kind) is None


def _kinds(d):
    return {k: type(v).__name__ for k, v in d.items()}


def test_roofline_block_keys_match_jax(armed):
    """One note in each module, the same phase seconds: the blocks share
    their keys and types, and on an unknown kind both report
    ``unavailable`` without fractions."""
    jcostmodel.enable()
    try:
        jcostmodel.reset()
        jcostmodel.note_traced_pass("histogram", ("pass", 10), macs=1e6,
                                    bytes_moved=1e5)
        costmodel.note_launch("histogram", "hist/plain_float", bytes=1e5,
                              flops=1e6)
        for kind, fenced in (("cpu", False), (H100, True)):
            want = jcostmodel.roofline({"histogram": 0.5}, kind=kind,
                                       fenced=fenced)
            # the port's spans are fenced by their device time
            got = costmodel.roofline(
                {"histogram": 2.0}, kind=kind,
                device_times={"histogram": 0.5} if fenced else None)
            assert sorted(got) == sorted(want)
            assert _kinds(got) == _kinds(want) or kind == H100
            assert _kinds(got["traced_passes"][0]) == \
                _kinds(want["traced_passes"][0])
            if kind == "cpu":
                assert got["peaks"] == want["peaks"] == "unavailable"
                assert "frac_of_peak_bw" not in got["phases"]["histogram"]
        blk = got["phases"]["histogram"]
        assert blk["attained_hbm_gbps"] == round(1e5 / 0.5 / 1e9, 4)
        assert blk["frac_of_peak_bw"] == round(1e5 / 0.5 / 3.35e12, 6)
        assert blk["calls"] == 1 and blk["programs"] == 1
        assert got["fenced_spans"] is True
    finally:
        jcostmodel.disable()
        jcostmodel.reset()


def test_roofline_method_names_its_divisor(armed):
    """A phase's seconds are its device time where ``device_times`` has
    it, else its host wall time; ``method`` and ``fenced_spans`` name
    which divided."""
    costmodel.note_launch("histogram", "hist/plain_float", bytes=1e9,
                          flops=1e6)
    host = costmodel.roofline({"histogram": 4.0}, kind=H100)
    assert host["fenced_spans"] is False
    assert "host wall time" in host["method"]
    assert host["phases"]["histogram"]["seconds"] == 4.0
    for device in (None, {}):
        assert costmodel.roofline({"histogram": 4.0}, kind=H100,
                                  device_times=device) == host
    dev = costmodel.roofline({"histogram": 4.0}, kind=H100,
                             device_times={"histogram": 0.5})
    assert dev["fenced_spans"] is True
    assert "device time" in dev["method"] and "CUDA events" in dev["method"]
    blk = dev["phases"]["histogram"]
    assert blk["seconds"] == 0.5
    assert blk["attained_hbm_gbps"] == round(1e9 / 0.5 / 1e9, 4)
    assert blk["frac_of_peak_bw"] == round(1e9 / 0.5 / 3.35e12, 6)


def test_compile_block_keys_match_jax(armed):
    want = jcostmodel.compile_block()
    got = costmodel.compile_block()
    assert sorted(got) == sorted(want)
    for k in got:
        if k != "programs":
            assert type(got[k]) is type(want[k]) or \
                {type(got[k]), type(want[k])} <= {int, float}, k
    assert isinstance(got["total_compile_seconds"], float)


def test_compile_block_records_the_native_build(tmp_path):
    """A fresh process that loads the native parser files one g++ entry:
    a build with its seconds, or a cached load of a library on disk."""
    code = ("import json\n"
            "from lightgbm_tpu_torch.native import lib\n"
            "from lightgbm_tpu_torch import costmodel\n"
            "lib.load()\n"
            "print(json.dumps(costmodel.compile_block()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    blk = json.loads(out.stdout.strip().splitlines()[-1])
    (prog,) = blk["programs"]
    assert prog["name"] == "g++:lgbm_native.cpp" and prog["phase"] == "build"
    assert blk["program_count"] == 1
    assert blk["warm_programs"] + blk["backend_compiles"] == 1
    assert blk["persistent_cache_hits"] == blk["warm_programs"]


@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("mode", ["float32", "int8"])
def test_launch_notes_are_the_bound_formulas(armed, mode, C):
    rng = np.random.RandomState(C)
    F, N, B = 6, 3000, 32
    bins = torch.as_tensor(rng.randint(0, B, (F, N)).astype(np.uint8))
    g = torch.as_tensor(rng.randn(N).astype(np.float32))
    cid = torch.as_tensor(rng.randint(0, C, N).astype(np.int64))
    ok = torch.ones(N, dtype=torch.bool)
    histogram_leafbatch(bins, g, g.abs(), cid, ok, C, B, mode)
    route = "hist/plain_" + ("int8" if mode == "int8" else "float")
    side = 7 if mode == "int8" else 12
    (note,) = costmodel.roofline({}, kind="cpu")["traced_passes"]
    assert note == {"phase": "histogram", "key": [route], "traces": 1,
                    "macs": float(3 * N * F),
                    "bytes_moved": float(N * F + side * N + F * B * 3 * C * 4)}


def test_pane_and_partition_notes(armed):
    rng = np.random.RandomState(0)
    F, N, B = 5, 2500, 20
    bins = torch.as_tensor(rng.randint(0, B, (F, N)).astype(np.uint8))
    g = torch.as_tensor(rng.randn(N).astype(np.float32))
    pane = compact.pack_planes(bins, g, g.abs(), torch.ones(N, dtype=bool),
                               4096)
    dst = torch.empty_like(pane)
    compact.partition_pane(pane, dst, F, 2, 9, 100, 2000)
    hist_cuda.hist_pane_float(dst, F, 100, 700, B, (1, 3))
    notes = {n["key"][0]: n for n in
             costmodel.roofline({}, kind="cpu")["traced_passes"]}
    assert notes["partition/plain"]["bytes_moved"] == \
        2 * compact.pane_rows(F) * 2000
    assert notes["partition/plain"]["phase"] == "partition"
    assert notes["hist/plain_pane"]["bytes_moved"] == \
        700 * 3 + 9 * 700 + 3 * B * 3 * 4


def test_training_roofline_joins_the_spans(tmp_path):
    """A compacted run's summary: histogram and partition phases whose
    calls are the launch counts of the route counters and whose attained
    rates are the noted bytes over the phase seconds."""
    rng = np.random.RandomState(9)
    x = rng.randn(3000, 6)
    y = (x[:, 0] > 0).astype(np.float32)
    ds = lgt.Dataset.from_arrays(x, y, max_bin=63)
    sink = tmp_path / "m.jsonl"
    lgt.train({"objective": "binary", "num_leaves": 15, "num_iterations": 3,
               "verbose": -1, "metrics_out": str(sink),
               "metrics_fence": "true"}, ds, device="cpu")
    summary = [json.loads(line) for line in open(sink)][-1]
    roof, ctr = summary["roofline"], summary["counters"]
    # metrics_fence on the CPU: no CUDA events, so the host wall time
    # divides, and the block says so
    assert roof["fenced_spans"] is False and roof["peaks"] == "unavailable"
    assert "host wall time" in roof["method"]
    assert "device_times" not in summary
    hist = roof["phases"]["histogram"]
    assert hist["calls"] == ctr["hist/plain_float"] + ctr["hist/plain_pane"]
    assert roof["phases"]["partition"]["calls"] == ctr["partition/plain"]
    for phase, blk in roof["phases"].items():
        assert blk["seconds"] == summary["phase_times"][phase]
        # the block rounds GB/s to 4 places and seconds to 6, as the JAX
        # module does
        assert blk["attained_hbm_gbps"] == pytest.approx(
            blk["bytes_accessed"] / blk["seconds"] / 1e9, rel=1e-3,
            abs=1e-4)
    assert summary["compile"]["midrun_recompiles"] == 0
