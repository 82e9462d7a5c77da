"""A serving cell: set-up, a closed loop of clients through one
``ServingFront``, and the check of the scores it returned.

Set-up makes a pool of rows and a random ensemble from the seed, writes
the ensemble as model text, loads it with ``GBDT.models_from_string``,
takes ``GBDT.serving_engine(**options)`` (the default options unless a
check asks otherwise), warms the buckets that the traffic's request
sizes land on and starts the front.

The window: ``clients`` threads, each submitting its next request only
after its last returned, sizes and pool offsets dealt from the seed
(data.client_streams).  A request's latency runs from submit to its
scores in hand; a request that raises counts as failed.  Clients stop
submitting when the window closes; requests still in flight are waited
for and count in the latency tail but not in the rows of the window.

The check, after the window and with the program freed: a sample of
finished requests, drawn from the seed and holding the longest, scored
by the reference walk (reference/trees.py) in float64 from the raw rows
and the ensemble's own arrays; ``score_gap`` is the largest gap as a
share of the larger of the row's and the median row's magnitude, and
``requests_lost`` the requests that never returned.
"""
from __future__ import annotations

import gc
import threading
import time
from types import SimpleNamespace

import numpy as np

from . import cost, data
from .reference import trees as rtrees
from .train import peak, rel_gap

SPAN_NAMES = ("predict", "predict_encode", "predict_warmup")
# rows the reference walks at once ([trees, rows] int64 state)
CHECK_BLOCK_ROWS = 16384


class Program:
    """Hooks a check or a test can wrap around the program."""

    def options(self, options: dict) -> dict:
        return options


def setup(cfg: dict, traffic: dict, seed: int, device: str,
          program: Program = Program()):
    import torch
    import lightgbm_tpu_torch as lgt
    pool, _, grids = data.make_pool(cfg, seed, int(traffic["pool_rows"]))
    ens = data.random_ensemble(grids, int(cfg["num_trees"]),
                               int(cfg["params"]["num_leaves"]), seed)
    booster = lgt.GBDT()
    booster.device = torch.device(device)
    booster.models_from_string(data.model_text(ens, int(cfg["features"])))
    engine = booster.serving_engine(**program.options({}))
    sizes = data.request_sizes(traffic)
    top = engine.buckets[-1]
    warm = sorted({engine.bucket_for(min(int(s), top)) for s in sizes}
                  | {top})
    engine.warmup(warm)
    front = lgt.ServingFront(engine)
    return {"pool": pool, "ens": ens, "booster": booster, "engine": engine,
            "front": front,
            "streams": data.client_streams(traffic, seed, pool.shape[0])}


def window(st: dict, seconds: float, wait_s: float = 60.0):
    """The closed loop; returns its records (submit, done, size, offset,
    scores or None) and the window's start and end."""
    front, pool = st["front"], st["pool"]
    records = []
    lock = threading.Lock()
    t0 = time.perf_counter()
    t_end = t0 + seconds

    def client(stream):
        i = 0
        while time.perf_counter() < t_end:
            size, off = stream[i % len(stream)]
            i += 1
            t = time.perf_counter()
            try:
                out = front.submit(pool[off:off + size]).result(
                    timeout=seconds + wait_s)
            except Exception:           # a failed request, kept as such
                out = None
            done = time.perf_counter()
            with lock:
                records.append((t, done, size, off, out))

    threads = [threading.Thread(target=client, args=(s,), daemon=True)
               for s in st["streams"]]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=seconds + 2 * wait_s)
    return records, t0, t_end


def traced(st: dict, seconds: float):
    """A window of ``seconds`` by the host clock, then one under the
    profiler with telemetry armed: (Trace, telemetry snapshot, records
    of both, the traced window's start and end, requests of each)."""
    from lightgbm_tpu_torch import telemetry
    from .trace import Window
    plain, _, _ = window(st, seconds)
    telemetry.enable()
    telemetry.reset()
    try:
        with Window(SPAN_NAMES) as w:
            records, t0, t_end = window(st, seconds)
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
    return (w.trace, snap, plain + records, t0, t_end,
            (len(plain), len(records)))


def end_to_end(records, t_end, seconds):
    rows = sum(r[2] for r in records if r[4] is not None and r[1] <= t_end)
    lat = np.array([(r[1] - r[0]) * 1e3 if r[4] is not None else np.inf
                    for r in records])
    p95 = float(np.percentile(lat, 95)) if lat.size else np.inf
    return {"serve_rows_per_s": rows / seconds,
            "serve_p95_ms": p95 if np.isfinite(p95) else 1e12}


def release(st: dict) -> None:
    import torch
    st["front"].close()
    dev = st["engine"].device
    for k in ("front", "engine", "booster"):
        st[k] = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def check(st: dict, records, seed: int, traffic: dict, device) -> dict:
    import torch
    done = [r for r in records if r[4] is not None]
    lost = len(records) - len(done)
    gaps = {"score_gap": 0.0, "requests_lost": float(lost)}
    if not done:
        gaps["score_gap"] = 1.0
        return gaps
    rng = data.rng_for(seed, 5)
    k = min(int(traffic["check_requests"]), len(done))
    pick = set(rng.choice(len(done), k, replace=False).tolist())
    pick.add(int(np.argmax([r[2] for r in done])))
    ens = st["ens"]
    got, want = [], []
    block = CHECK_BLOCK_ROWS
    for i in sorted(pick):
        _, _, size, off, out = done[i]
        x = torch.as_tensor(st["pool"][off:off + size], device=device,
                            dtype=torch.float64)
        ref = torch.cat([rtrees.walk_values(
            x[a:a + block], ens.split_feature, ens.threshold,
            ens.left_child, ens.right_child, ens.leaf_value)
            for a in range(0, size, block)])
        got.append(torch.as_tensor(np.asarray(out)[0], device=device,
                                   dtype=torch.float64))
        want.append(ref)
    gaps["score_gap"] = rel_gap(torch.cat(got), torch.cat(want))
    return gaps


def walk_least_s(ens, counters: dict) -> float:
    """Least seconds of the walks the counters record (cost.py)."""
    return cost.least_s(cost.walk_bytes(
        counters.get("serve/rows", 0), counters.get("serve/predict_calls", 0),
        np.unique(ens.split_feature).size, ens.split_feature.size,
        ens.leaf_value.size))


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: str, t_start: float, e2e, read_layer,
        program: Program = None) -> dict:
    """One run of a serving cell (run.run_cell)."""
    st = setup(cfg, traffic, seed, device, program or Program())
    setup_s = time.perf_counter() - t_start
    dev = st["engine"].device
    out = {"device": dev, "extra": {}, "breakdown": None, "profiler": None}
    if trace:
        tseconds = min(seconds, float(traffic["trace_seconds"]))
        tr, snap, records, t0, t_end, counts = traced(st, tseconds)
        out["metrics"] = read_layer(SimpleNamespace(
            trace=tr, telemetry=snap, window_s=tr.window_s,
            requests=counts[1],
            walk_s=walk_least_s(st["ens"], snap["counters"])))
        out["extra"] = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        out["breakdown"] = tr.breakdown()
        out["profiler"] = {"untraced_requests": counts[0],
                           "traced_requests": counts[1],
                           "seconds": tseconds}
    else:
        records, t0, t_end = window(st, seconds)
        values = dict(end_to_end(records, t_end, seconds), setup_s=setup_s)
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]} for m in e2e}
    out["peak"] = peak(dev)
    release(st)
    out["gaps"] = check(st, records, seed, traffic, dev)
    out["attempted"] = len(records)
    out["failed"] = sum(1 for r in records if r[4] is None)
    return out

