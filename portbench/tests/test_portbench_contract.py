"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its file; adding a per-layer metric takes only a new file
and a new entry."""
import hashlib
import json
import os
import re
import shutil
from types import SimpleNamespace

import pytest

from portbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return run.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= len(bench["command"]) <= 32
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_unique_and_well_formed(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_configs_resolve(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        cfg = json.load(open(os.path.join(run.ROOT, c["file"])))
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))


def test_cells_resolve(bench):
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
        cell, cfg, traffic, limits, e2e, layer = run.resolve(bench,
                                                             w["name"])
        used.add(w["config"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer
        for m in layer:
            assert m["moves"] in names
            assert os.path.exists(os.path.join(run.BENCH_DIR, "metrics",
                                               m["name"] + ".py"))
            assert callable(run.reader(m["name"]))
        assert traffic["kind"] in ("train", "serve")
        assert limits
    assert used == {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_well_formed(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        layers.setdefault(m["layer"], []).append(m["name"])
    assert any("mfu" in m["name"] for m in bench["per_layer"])


def _tree_digest(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".json", ".md")):
                p = os.path.join(dirpath, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


def test_new_metric_is_a_new_file_and_entry(tmp_path, bench):
    """A throwaway per-layer metric: a copy of the benchmark gains one
    reader file and one BENCHMARK.json entry, and its runs report it,
    with every file the benchmark had left as it was."""
    dst = tmp_path / "portbench"
    shutil.copytree(run.BENCH_DIR, dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree_digest(dst)
    (dst / "metrics" / "throwaway_count.py").write_text(
        "def read(ctx):\n"
        "    return ctx.telemetry['counters'].get('serve/rows')\n")
    extra = dict(bench)
    extra["per_layer"] = bench["per_layer"] + [{
        "name": "throwaway_count", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "serving front and engine",
        "moves": "serve_rows_per_s", "workloads": ["higgs.serve"]}]
    after = _tree_digest(dst)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"metrics/throwaway_count.py"}
    *_, layer = run.resolve(extra, "higgs.serve", str(dst))
    assert "throwaway_count" in [m["name"] for m in layer]
    ctx = SimpleNamespace(trace=None, telemetry={"counters": {
        "serve/rows": 1234, "serve/pad_rows": 766}, "phase_times": {}},
        requests=2, walk_s=0.0, window_s=1.0)
    got = run.per_layer(layer, ctx, str(dst))
    assert got["throwaway_count"] == {"value": 1234.0, "unit": "rows"}
    assert got["pad_share"]["value"] == pytest.approx(100 * 766 / 2000)
    # a reader that finds nothing leaves its metric out
    assert "walk_roofline" not in got
