"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix,
limits and per-layer metrics are found by name from BENCHMARK.json
(README.md).  The run needs CUDA devices for the cell's chips; it makes
its inputs from ``--seed``, sets up, measures for ``--seconds`` (with
``--trace 1`` a traced window instead, and the cell's per-layer metrics),
checks what the window produced against the plain reference, and prints
the numbers compared beside their limits as the last lines of standard
error and one JSON line as the last line of standard output.  It fails
without a result when a module of JAX or of the JAX package is loaded
once the window has closed.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "lightgbm_tpu")


def forbidden_loaded(modules=None) -> list:
    """Top-level names of loaded modules that the port's runs must not
    load, compared whole (``lightgbm_tpu_torch`` is not ``lightgbm_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(bench: dict, workload: str, bench_dir: str = BENCH_DIR):
    """(cell, config, traffic, limits, end-to-end and per-layer metric
    entries) of ``workload``, each found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError("no workload %r in BENCHMARK.json" % workload)
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _json(os.path.join(os.path.dirname(bench_dir),
                             configs[cell["config"]]["file"]))
    traffic = _json(os.path.join(bench_dir, "traffic",
                                 cell["traffic"] + ".json"))
    limits = _json(os.path.join(bench_dir, "limits", workload + ".json"))

    def mine(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    layer = [m for m in bench["per_layer"] if mine(m)]
    return cell, cfg, traffic, limits, e2e, layer


def reader(name: str, bench_dir: str = BENCH_DIR):
    """The ``read(ctx)`` of metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(entries, ctx, bench_dir: str = BENCH_DIR) -> dict:
    """Each per-layer metric its reader finds something for."""
    out = {}
    for m in entries:
        v = reader(m["name"], bench_dir)(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device_block(device, count: int, peak: int) -> dict:
    import torch
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": int(peak)}


def _result(gaps, limits, attempted, failed, metrics, device,
            breakdown, profiler=None) -> dict:
    missing = sorted(set(gaps) - set(limits))
    if missing:
        raise KeyError("no limit for %s" % missing)
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in gaps.items()}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if profiler is not None:
        out["profiler"] = profiler
    out["checks"] = checks
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench: dict = None,
             bench_dir: str = BENCH_DIR, t_start: float = None,
             program=None, overrides=None) -> dict:
    """One run, as a dict (no printing).  For checks and tests:
    ``program`` (the Program hooks of the traffic's kind), ``overrides``
    ({"config": {...}, "traffic": {...}} entries replaced, to run a cell
    small) and a ``device`` of "cpu"."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_benchmark() if bench is None else bench
    cell, cfg, traffic, limits, e2e, layer = resolve(bench, workload,
                                                     bench_dir)
    overrides = overrides or {}
    cfg = dict(cfg, **overrides.get("config", {}))
    traffic = dict(traffic, **overrides.get("traffic", {}))
    # the traffic's kind names the module that runs it (train.py, serve.py)
    kind = importlib.import_module((__package__ or "portbench") + "."
                                   + traffic["kind"])
    out = kind.run(cfg, traffic, seed, seconds, trace, device, t_start, e2e,
                   lambda ctx: per_layer(layer, ctx, bench_dir), program)
    return _result(out["gaps"], limits, out["attempted"], out["failed"],
                   out["metrics"],
                   dict(device_block(out["device"], cell["chips"],
                                     out["peak"]), **out["extra"]),
                   out["breakdown"], out["profiler"])


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    bench = load_benchmark()
    cell = resolve(bench, args.workload)[0]
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print("portbench: the cell needs %d CUDA device(s); %s"
              % (cell["chips"], "found %d" % torch.cuda.device_count()
                 if torch.cuda.is_available() else "CUDA is not available"),
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", bench, t_start=t_start)
    bad = forbidden_loaded()
    if bad:
        print("portbench: forbidden modules loaded: %s" % ", ".join(bad),
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print("check %s %r limit %r" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
