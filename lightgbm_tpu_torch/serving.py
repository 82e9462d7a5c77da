"""The serving engine: flattened ensembles, a bucket ladder, int8 leaf
tables, and a coalescing front.

Counterpart of lightgbm_tpu/serving.py, on an explicit torch device (the
card unless the caller asks for the CPU).

1. **FlatEnsemble** — built once per model: the per-node tables stacked
   ``[T, max_nodes]`` (split feature, threshold rank, left and right
   child), the ``[T, max_leaves]`` leaf-value table, and the host-built
   float64 threshold tables of the features the trees use.
   ``encode(features)`` rank-codes a batch against those tables on the
   host, so the integer walk on the device routes every row exactly as a
   float64 comparison with the real threshold would.
2. **ServingEngine** — pushes the tables to its device once, pads each
   batch to the smallest bucket of a fixed ladder (1 / 32 / 1024 / 65536
   rows by default; larger batches go in chunks of the largest bucket)
   and walks it breadth-first in lockstep (``ops/scoring.py``), with the
   trees' values summed in tree order in float32, so the scores are
   bitwise the JAX engine's.  ``quantize="int8"`` serves an int8 leaf
   table with a per-tree scale; routing stays exact.  ``donate`` is
   checked as the JAX engine checks it and changes nothing: XLA's buffer
   donation has no torch counterpart, since the caching allocator
   already reuses a freed codes block.
3. **ServingFront** — a bounded queue in front of one engine: requests
   coalesce onto the ladder within ``linger_us``, ``submit`` blocks when
   the queue is full (backpressure, never shedding), and
   ``swap_engine`` flips to a new engine between requests.

Observability, as the JAX engine has it: the ``serve/*`` counters
(flattens, calls, rows, pad rows, the bucket of each chunk, the front's
intake, coalescing, linger, queue depth and swaps), the spans
``predict_encode`` (the host rank-encode), ``predict`` (the device walk,
event-timed under ``metrics_fence``) and ``predict_warmup``; with the flight
recorder armed, per-request traces through the front — enqueue → queue
→ linger → coalesce → encode → dispatch → walk → scatter → complete,
whose seven components sum exactly to each request's wall time
(``tracing.record_serve_request``); with the monitor armed, every
delivered score feeds the engine's live drift histogram against the
model's ``score_reference=`` histogram (carried on the FlatEnsemble).
The JAX engine's cost-model capture of its compiled walks has no
counterpart: the walk is eager torch code.

Tree-axis sharding (``shards > 1``, lightgbm_tpu/serving.py:219-345):
shard s holds trees ``[s·Tb, min((s+1)·Tb, T))``, ``Tb = ceil(T /
shards)``, the JAX layout without its pad rows, with its node tables on
its own device (``parallel.mesh.serving_devices``: consecutive cards,
copies of the CPU, or a device list, so several shards may share one
card).  The codes go to every shard's device, each shard walks its
block, and the [C, N] partial sums are carried from shard to shard in
tree order (``ops/scoring.bfs_scores_sharded``): the scores are bitwise
the one-device engine's.  A shard may hold no trees.  ``algo="scan"``
serves the per-tree replay (``ops/scoring.ensemble_scores``) on one
device, from the dequantized table under ``quantize="int8"``; it cannot
shard.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import lifecycle, monitor, telemetry, tracing
from .device import resolve_device
from .ops import scoring
from .parallel.mesh import serving_devices

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 32, 1024, 65536)

# ensembles flattened in this process: a Predictor flattens once, not
# once per chunk of its file (the tests read the difference)
FLATTEN_COUNT = 0


def _tree_max_depth(lc: np.ndarray, rc: np.ndarray, n: int) -> int:
    """Depth (in edges from the root) a breadth-first walk needs to
    resolve every row of this tree.  Children are always created after
    their parent (node k's children have indices > k, tree.cpp:70-71),
    so one forward pass suffices."""
    if n <= 0:
        return 0
    depth = np.ones(n, np.int32)
    for k in range(n):
        for c in (int(lc[k]), int(rc[k])):
            if c >= 0:
                depth[c] = depth[k] + 1
    return int(depth.max())


class FlatEnsemble:
    """A trained ensemble flattened into dense per-node arrays plus the
    host-built float64 rank-code tables (see the module docstring).  The
    arrays are numpy; the engine copies them to its device."""

    def __init__(self, used, thresholds, sf, tr, lc, rc, lv, nl, root,
                 tree_class, max_nodes: int, max_depth: int,
                 num_class: int):
        self.used = used                 # original column ids, sorted
        self.thresholds = thresholds     # {col: sorted unique f64 thresholds}
        self.split_feature = sf          # [T, max_nodes] int32 (inner ids)
        self.threshold_rank = tr         # [T, max_nodes] int32
        self.left_child = lc             # [T, max_nodes] int32 (~leaf enc)
        self.right_child = rc            # [T, max_nodes] int32
        self.leaf_value = lv             # [T, max_nodes + 1] f32
        self.num_leaves = nl             # [T] int32
        self.root_state = root           # [T] int32: 0, or ~0 for stumps
        self.tree_class = tree_class     # [T] int32
        self.max_nodes = max_nodes
        self.max_depth = max_depth
        self.num_class = num_class
        self.num_trees = sf.shape[0]
        self._int8: Optional[Tuple[np.ndarray, np.ndarray]] = None
        # the model's training-time score histogram (GBDT.export_flat
        # sets it): a ServingFront's drift baseline
        self.score_reference: Optional[dict] = None

    @classmethod
    def from_models(cls, models, num_class: int) -> "FlatEnsemble":
        """Flatten ``models`` (a list of models.tree.Tree); tree k
        belongs to class k % num_class."""
        global FLATTEN_COUNT
        FLATTEN_COUNT += 1
        telemetry.count("serve/ensemble_flatten")
        T = len(models)
        max_nodes = max(max((t.num_leaves - 1 for t in models), default=1),
                        1)
        used = sorted({int(f) for t in models
                       for f in t.split_feature_real[:t.num_leaves - 1]})
        fmap = {f: i for i, f in enumerate(used)}
        thr = {f: [] for f in used}
        for t in models:
            for f, v in zip(t.split_feature_real, t.threshold):
                thr[int(f)].append(float(v))
        thr = {f: np.unique(np.asarray(v, np.float64))
               for f, v in thr.items()}

        sf = np.zeros((T, max_nodes), np.int32)
        tr = np.zeros((T, max_nodes), np.int32)
        lc = np.zeros((T, max_nodes), np.int32)
        rc = np.zeros((T, max_nodes), np.int32)
        lv = np.zeros((T, max_nodes + 1), np.float32)
        nl = np.zeros((T,), np.int32)
        root = np.zeros((T,), np.int32)
        max_depth = 0
        for k, t in enumerate(models):
            n = t.num_leaves - 1
            nl[k] = t.num_leaves
            lv[k, :t.num_leaves] = t.leaf_value
            if n <= 0:
                root[k] = -1      # ~0: the stump's single leaf
                continue
            sf[k, :n] = [fmap[int(f)] for f in t.split_feature_real[:n]]
            tr[k, :n] = [int(np.searchsorted(thr[int(f)], float(v), "left"))
                         for f, v in zip(t.split_feature_real[:n],
                                         t.threshold[:n])]
            lc[k, :n] = t.left_child[:n]
            rc[k, :n] = t.right_child[:n]
            max_depth = max(max_depth, _tree_max_depth(lc[k], rc[k], n))
        tc = (np.arange(T) % max(num_class, 1)).astype(np.int32)
        return cls(used, thr, sf, tr, lc, rc, lv, nl, root, tc,
                   max_nodes, max_depth, max(num_class, 1))

    def encode(self, features: np.ndarray) -> np.ndarray:
        """[F_used, N] int32 rank codes of raw ``features`` [N, cols]
        against the ensemble's own threshold tables, in float64 on the
        host: code = #{thresholds < x}, so ``x > t_j`` exactly when
        ``code > j`` and a tie ``x == t_j`` goes left, as the reference's
        double comparison does (tree.h:163-175)."""
        N = features.shape[0]
        codes = np.zeros((max(len(self.used), 1), N), np.int32)
        for i, f in enumerate(self.used):
            vals = features[:, f]
            c = np.searchsorted(self.thresholds[f], vals, side="left")
            # NaN sorts past every threshold, but ``value > t`` is False
            # for NaN: always left
            c[np.isnan(vals)] = 0
            codes[i] = c
        return codes

    def int8_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """(leaf_q [T, max_leaves] int8, scale [T] f32), built once.
        Symmetric per-tree quantization: scale = max|leaf| / 127,
        q = round(leaf / scale); a leaf reads back as ``q * scale``."""
        if self._int8 is None:
            amax = np.abs(self.leaf_value).max(axis=1)
            scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
            q = np.clip(np.round(self.leaf_value / scale[:, None]),
                        -127, 127).astype(np.int8)
            self._int8 = (q, scale)
        return self._int8

    def dequantized_leaf_value(self) -> np.ndarray:
        """[T, max_leaves] f32 leaf table of the int8 ensemble."""
        q, scale = self.int8_tables()
        return q.astype(np.float32) * scale[:, None]


class ServingEngine:
    """Bucketed batch prediction over one FlatEnsemble on ``device``, or
    on one device per tree shard (see the module docstring).  One engine
    per model; calls are serialized by the caller (a ServingFront's
    worker, or one thread)."""

    def __init__(self, flat: FlatEnsemble,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 quantize: str = "float32", donate: str = "auto",
                 algo: str = "bfs", shards: int = 0, linger_us: int = 200,
                 queue: int = 4, device=None):
        if quantize not in ("float32", "int8"):
            raise ValueError("quantize must be float32 or int8")
        if algo not in ("bfs", "scan"):
            raise ValueError("algo must be bfs or scan")
        buckets = tuple(sorted({int(b) for b in buckets}))
        if not buckets or buckets[0] < 1:
            raise ValueError("buckets must be positive ints")
        shards = int(shards)
        if shards < 0:
            raise ValueError("shards must be >= 0 (0 = single-device)")
        if int(linger_us) < 0:
            raise ValueError("linger_us must be >= 0")
        if int(queue) < 1:
            raise ValueError("queue must be >= 1 (in-flight batches)")
        if donate not in ("auto", "true", "false"):
            raise ValueError("donate must be auto, true or false")
        self.flat = flat
        self.buckets = buckets
        self.quantize = quantize
        self.algo = algo
        # 0/1 = the one-device engine; the shards' devices are resolved
        # here, so an over-subscribed count fails at construction
        self.shards = shards if shards > 1 else 1
        if self.shards > 1 and algo == "scan":
            raise ValueError(
                "predict_algo=scan cannot tree-shard (the per-tree "
                "replay is a single-device A/B path); use bfs")
        if self.shards > 1 or isinstance(device, (list, tuple)):
            self.devices = serving_devices(self.shards, device)
        else:
            self.devices = [resolve_device(device)]
        self.device = self.devices[0]
        T = flat.num_trees
        per = -(-T // self.shards)
        self.tree_blocks = [(min(s * per, T), min((s + 1) * per, T))
                            for s in range(self.shards)]
        # the ServingFront's defaults, carried on the engine so
        # engine_options_from_config stays the one config mapping
        self.linger_us = int(linger_us)
        self.queue = int(queue)
        self._tables = None
        telemetry.set_device(self.device)

    def _device_tables(self) -> List[dict]:
        """Each shard's node tables on its device, pushed once (one dict
        for the one-device engine); every call after that moves only its
        codes.  ``algo="scan"`` reads a float32 leaf table, the
        dequantized one under ``quantize="int8"``."""
        if self._tables is None:
            f = self.flat
            tables = []
            for (a, b), device in zip(self.tree_blocks, self.devices):
                def put(arr):
                    return torch.as_tensor(arr[a:b], device=device)
                t = {"sf": put(f.split_feature), "tr": put(f.threshold_rank),
                     "lc": put(f.left_child), "rc": put(f.right_child),
                     "root": put(f.root_state)}
                if self.algo == "scan" and self.quantize == "int8":
                    t["lv"] = put(f.dequantized_leaf_value())
                elif self.quantize == "int8":
                    q, scale = f.int8_tables()
                    t["lv_q"] = put(q)
                    t["lv_scale"] = put(scale)
                else:
                    t["lv"] = put(f.leaf_value)
                tables.append(t)
            self._tables = tables
        return self._tables

    def _run_scores(self, chunk: np.ndarray) -> torch.Tensor:
        tables, f = self._device_tables(), self.flat
        codes = torch.from_numpy(chunk)
        if self.algo == "scan":
            return scoring.ensemble_scores(
                codes.to(self.device), f.split_feature, f.threshold_rank,
                f.left_child, f.right_child, tables[0]["lv"], f.num_leaves,
                f.tree_class, num_class=f.num_class)
        return scoring.bfs_scores_sharded(
            codes, tables, [f.tree_class[a:b] for a, b in self.tree_blocks],
            max_depth=f.max_depth, num_class=f.num_class)

    def _run_leaves(self, chunk: np.ndarray) -> torch.Tensor:
        tables, f = self._device_tables(), self.flat
        codes = torch.from_numpy(chunk)
        if self.algo == "scan":
            return scoring.ensemble_leaf_indices(
                codes.to(self.device), f.split_feature, f.threshold_rank,
                f.left_child, f.right_child, f.num_leaves)
        return scoring.bfs_leaf_indices_sharded(codes, tables,
                                                max_depth=f.max_depth)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that holds ``n`` rows (callers chunk at the
        largest bucket first, so n <= buckets[-1] here)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _bucketed(self, features: np.ndarray, run) -> List[np.ndarray]:
        """encode → chunk at the largest bucket → pad to its bucket → run
        → strip the padding; one host array per chunk.  A ServingFront
        batch being scored on this thread gets its encode, dispatch and
        walk marks (``tracing.current_batch``); a direct call sees
        None."""
        bt = tracing.current_batch()
        if bt is not None:
            bt.mark_encode_begin()
        with telemetry.span("predict_encode"):
            codes = self.flat.encode(features)
        if bt is not None:
            bt.mark_encode_end()
        N = codes.shape[1]
        maxb = self.buckets[-1]
        outs = []
        telemetry.count("serve/predict_calls")
        telemetry.count("serve/rows", N)
        with telemetry.span("predict") as sp:
            for s in range(0, max(N, 1), maxb):
                chunk = codes[:, s:s + maxb]
                n = chunk.shape[1]
                b = self.bucket_for(n)
                if b > n:
                    telemetry.count("serve/pad_rows", b - n)
                    if bt is not None:
                        bt.add_pad(b - n)
                    chunk = np.concatenate(
                        [chunk, np.zeros((chunk.shape[0], b - n),
                                         chunk.dtype)], axis=1)
                telemetry.count("serve/bucket_%d" % b)
                if bt is not None:
                    bt.set_bucket(b)
                out = run(chunk)
                if bt is not None:
                    bt.mark_dispatched()
                outs.append(sp.fence(out)[:, :n].cpu().numpy())
        return outs

    def scores(self, features: np.ndarray) -> np.ndarray:
        """[num_class, N] float64 of the f32 ensemble sums of raw
        ``features`` [N, cols]."""
        if self.flat.num_trees == 0:
            return np.zeros((self.flat.num_class, features.shape[0]))
        return np.concatenate(
            [o.astype(np.float64) for o in
             self._bucketed(features, self._run_scores)], axis=1)

    def leaf_indices(self, features: np.ndarray) -> np.ndarray:
        """[N, T] int32 leaf index per tree (PredictLeafIndex layout)."""
        if self.flat.num_trees == 0:
            return np.zeros((features.shape[0], 0), np.int32)
        return np.concatenate(
            [o.astype(np.int32).T for o in
             self._bucketed(features, self._run_leaves)], axis=0)

    def warmup(self, buckets: Optional[Sequence[int]] = None):
        """Score zeros at every bucket (or ``buckets``) once, so the
        tables reach the device and every bucket shape has run before the
        engine serves.  Returns self, so
        ``front.swap_engine(engine.warmup())`` chains."""
        if self.flat.num_trees == 0:
            return self
        F = max(len(self.flat.used), 1)
        # every bucket through every shard: the carry ends on the last
        with telemetry.span("predict_warmup"):
            for b in (buckets if buckets is not None else self.buckets):
                self._run_scores(np.zeros((F, int(b)), np.int32)).cpu()
        telemetry.count("serve/warmups")
        return self


class _FrontRequest:
    __slots__ = ("features", "future", "rows", "t_submit", "trace_id",
                 "t_enq_ns", "block_ns")

    def __init__(self, features, future, rows, t_submit, trace_id=0,
                 t_enq_ns=0, block_ns=0):
        self.features = features
        self.future = future
        self.rows = rows
        self.t_submit = t_submit
        # the flight recorder's identity and integer enqueue stamp: the
        # attribution identity needs perf_counter_ns boundaries
        self.trace_id = trace_id
        self.t_enq_ns = t_enq_ns
        self.block_ns = block_ns


class _SwapMarker:
    __slots__ = ("engine", "event", "t0")

    def __init__(self, engine, event, t0):
        self.engine = engine
        self.event = event
        self.t0 = t0


def _drift_identity(engine) -> tuple:
    """(drift key, training-time reference histogram) of one installed
    engine: a fresh monitor key, and the model's ``score_reference=``
    histogram carried on its FlatEnsemble (None for a model without one;
    the A/A lane still runs)."""
    return monitor.engine_key(), getattr(engine.flat, "score_reference",
                                         None)


class ServingFront:
    """A coalescing front over a ServingEngine
    (lightgbm_tpu/serving.py:618-952, its telemetry, tracing and drift
    hooks included: see the module docstring).

    One worker thread drains a bounded request queue: it waits up to
    ``linger_us`` past the first queued request's arrival (or until a
    top-bucket batch is queued), concatenates whole requests into one
    batch, runs ``engine.scores`` once, and hands each request its score
    columns through its Future.  Rows are independent through the walk
    and the per-class sums, so a coalesced request's scores are bitwise
    those of scoring it alone.

    The queue holds at most ``queue`` top-bucket batches of rows:
    ``submit`` blocks while it is full (backpressure; nothing is shed).

    ``swap_engine(new_engine)`` flips engines between requests: its
    marker rides the queue, requests ahead of it score on the old engine,
    requests behind it on the new one; none is dropped or split across
    engines.  ``close`` stops accepting, drains the queue and joins the
    worker."""

    def __init__(self, engine: ServingEngine,
                 linger_us: Optional[int] = None,
                 queue: Optional[int] = None):
        self._engine = engine
        self.linger_s = (engine.linger_us if linger_us is None
                         else int(linger_us)) / 1e6
        batches = engine.queue if queue is None else int(queue)
        if batches < 1:
            raise ValueError("queue must be >= 1 (in-flight batches)")
        self.queue_rows = batches * engine.buckets[-1]
        self._cond = threading.Condition()
        self._queue: "collections.deque" = collections.deque()
        self._queued_rows = 0
        self._closed = False
        self.stats = {"requests": 0, "rows": 0, "batches": 0,
                      "queue_peak_rows": 0, "swaps": 0}
        # a fresh drift key for each installed engine: a swapped-in model
        # starts a clean live histogram
        self._monitor_key, self._monitor_ref = _drift_identity(engine)
        self._thread = threading.Thread(target=self._serve_loop,
                                        name="lgbm-torch-serving-front",
                                        daemon=True)
        lifecycle.track("serving-front", self, self.close)
        self._thread.start()

    @property
    def engine(self) -> ServingEngine:
        return self._engine

    def submit(self, features: np.ndarray) -> Future:
        """Enqueue one request ([n, F] raw features); returns a Future
        resolving to the engine's [num_class, n] raw score sums.  Blocks
        while the bounded queue is full (backpressure, never drops)."""
        features = np.asarray(features)
        if features.ndim != 2:
            raise ValueError("submit expects a [rows, features] matrix")
        n = features.shape[0]
        fut: Future = Future()
        t_arrive_ns = time.perf_counter_ns()
        with self._cond:
            if self._closed:
                raise RuntimeError("ServingFront is closed")
            blocked = False
            while self._queued_rows > 0 \
                    and self._queued_rows + n > self.queue_rows:
                blocked = True
                self._cond.wait(0.05)
                if self._closed:
                    raise RuntimeError("ServingFront is closed")
            # the enqueue stamp comes after any backpressure block: the
            # traced wall is enqueue → complete, the block its own event
            t_enq_ns = time.perf_counter_ns()
            req = _FrontRequest(features, fut, n, time.perf_counter(),
                                trace_id=tracing.next_trace_id(),
                                t_enq_ns=t_enq_ns,
                                block_ns=(t_enq_ns - t_arrive_ns
                                          if blocked else 0))
            self._queue.append(req)
            self._queued_rows += n
            self.stats["requests"] += 1
            self.stats["rows"] += n
            if self._queued_rows > self.stats["queue_peak_rows"]:
                self.stats["queue_peak_rows"] = self._queued_rows
            # filed before the lock releases, so the ring shows every
            # enqueue before its completion (tracing's lock is a leaf)
            if tracing.active():
                tracing.event("serve_enqueue", trace=req.trace_id, rows=n,
                              t_ns=t_enq_ns,
                              depth_rows=self._queued_rows - n)
                if blocked:
                    tracing.event("serve_backpressure", trace=req.trace_id,
                                  block_ns=req.block_ns)
            self._cond.notify_all()
        telemetry.count("serve/front_requests")
        telemetry.count("serve/front_rows", n)
        return fut

    def predict(self, features: np.ndarray,
                timeout: Optional[float] = None) -> np.ndarray:
        """``submit(features).result(timeout)``."""
        return self.submit(features).result(timeout)

    def swap_engine(self, new_engine: ServingEngine, warmup: bool = True,
                    timeout: Optional[float] = None) -> float:
        """Warm the new engine first (the old one keeps serving), then
        queue a swap marker and block until the worker reaches it and
        flips.  Returns the drain time in seconds (marker queued → flip).
        On ``timeout`` the marker is withdrawn if the worker has not
        reached it (TimeoutError; the old engine still serves)."""
        if warmup:
            new_engine.warmup()
        marker = _SwapMarker(new_engine, threading.Event(),
                             time.perf_counter())
        with self._cond:
            if self._closed:
                raise RuntimeError("ServingFront is closed")
            self._queue.append(marker)
            self._cond.notify_all()
        tracing.event("serve_swap_enqueue")
        if not marker.event.wait(timeout):
            # a timed-out swap must not flip later behind the caller's
            # back: withdraw the marker if the worker has not popped it;
            # if it has, the flip is committed — wait it out
            with self._cond:
                try:
                    self._queue.remove(marker)
                    withdrawn = True
                except ValueError:
                    withdrawn = False
            if withdrawn:
                raise TimeoutError("hot-swap drain timed out (swap "
                                   "withdrawn; the old engine still "
                                   "serves)")
            marker.event.wait(60.0)
        drain = time.perf_counter() - marker.t0
        self.stats["swaps"] += 1
        telemetry.count("serve/swaps")
        telemetry.count("serve/swap_drain_us", int(drain * 1e6))
        return drain

    def close(self, timeout: float = 60.0) -> None:
        """Stop accepting, score every queued request, join the worker."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout)
        # a worker wedged on a hung device call stays registered, for a
        # leak guard to surface
        if not self._thread.is_alive():
            lifecycle.untrack(self)
        telemetry.count("serve/queue_peak_rows",
                        self.stats["queue_peak_rows"])

    def __enter__(self) -> "ServingFront":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def _rows_before_marker(self, cap: int) -> int:
        """Rows queued ahead of the first swap marker, counted until
        ``cap`` (a full queue may hold many 1-row requests; the lock is
        held)."""
        rows = 0
        for item in self._queue:
            if isinstance(item, _SwapMarker) or rows >= cap:
                break
            rows += item.rows
        return rows

    def _serve_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait(0.1)
                if not self._queue:
                    break                      # closed and drained
                head = self._queue[0]
                if isinstance(head, _SwapMarker):
                    # everything ahead scored on the old engine; everything
                    # behind scores on the new one
                    self._queue.popleft()
                    self._engine = head.engine
                    self._monitor_key, self._monitor_ref = \
                        _drift_identity(head.engine)
                    head.event.set()
                    tracing.event("serve_swap_flip",
                                  drain_us=int((time.perf_counter()
                                                - head.t0) * 1e6))
                    continue
                # the worker has seen the head: queue-wait ends here,
                # linger-wait begins
                t_linger_ns = time.perf_counter_ns()
                maxb = self._engine.buckets[-1]
                deadline = head.t_submit + self.linger_s
                while not self._closed:
                    if self._rows_before_marker(maxb) >= maxb:
                        break
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(min(remaining, 0.05))
                batch: List[_FrontRequest] = []
                total = 0
                while self._queue and not isinstance(self._queue[0],
                                                     _SwapMarker):
                    r = self._queue[0]
                    if batch and total + r.rows > maxb:
                        break                  # the next batch takes it
                    self._queue.popleft()
                    batch.append(r)
                    total += r.rows
                t_form_ns = time.perf_counter_ns()
                self._queued_rows -= total
                depth_after = self._queued_rows
                engine = self._engine
                mon_key, mon_ref = self._monitor_key, self._monitor_ref
                self._cond.notify_all()        # wake blocked submitters
            # device work runs outside the lock: submit stays wait-free
            # while a batch is on the device
            wait_s = time.perf_counter() - batch[0].t_submit
            self.stats["batches"] += 1
            telemetry.count("serve/coalesced_batches")
            telemetry.count("serve/coalesced_rows", total)
            telemetry.count("serve/coalesced_requests", len(batch))
            telemetry.count("serve/linger_wait_us", int(wait_s * 1e6))
            telemetry.count("serve/queue_depth_rows", total + depth_after)
            telemetry.count("serve/queue_depth_samples")
            feats = (batch[0].features if len(batch) == 1 else
                     np.concatenate([r.features for r in batch], axis=0))
            # the batch trace, thread-local: engine._bucketed fills in its
            # dispatch and walk marks on this thread
            bt = tracing.begin_batch() if tracing.active() else None
            try:
                scores = engine.scores(feats)
            except BaseException as e:  # delivered per request, never lost
                tracing.end_batch()
                if bt is not None:
                    tracing.event("serve_error", batch=bt.batch_id,
                                  rows=total, error=type(e).__name__)
                for r in batch:
                    # a client may cancel between the check and the set:
                    # the InvalidStateError must not kill this worker
                    try:
                        if not (r.future.cancelled() or r.future.done()):
                            r.future.set_exception(e)
                    except Exception:
                        pass
                if not isinstance(e, Exception):
                    raise
                continue
            tracing.end_batch()
            if monitor.active():
                # the live drift feed, outside the lock, after the walk
                monitor.record_scores(mon_key, scores, reference=mon_ref)
            t_scores_ns = time.perf_counter_ns()
            if bt is not None:
                tracing.event("serve_batch", batch=bt.batch_id,
                              requests=len(batch), rows=total,
                              bucket=bt.bucket, pad_rows=bt.pad_rows,
                              wait_us=int(wait_s * 1e6))
                tracing.bump("serve/dispatch_bucket_%d" % bt.bucket)
                tracing.bump("serve/dispatch_rows_bucket_%d" % bt.bucket,
                             total)
                bounds = (t_linger_ns, t_form_ns, bt.encode_begin_ns,
                          bt.encode_end_ns, bt.dispatched_ns, t_scores_ns)
            ofs = 0
            for r in batch:
                # per request: one client cancelling in the check→set
                # window must not cost the others of its batch
                try:
                    if not r.future.cancelled():
                        r.future.set_result(scores[:, ofs:ofs + r.rows])
                except Exception:
                    pass
                ofs += r.rows
                if bt is not None:
                    # the complete stamp after the delivery: the seven
                    # components telescope exactly to t_done - t_enq
                    tracing.record_serve_request(
                        r.trace_id, bt, r.t_enq_ns,
                        time.perf_counter_ns(), bounds, r.rows,
                        block_ns=r.block_ns)


def engine_options_from_config(io_config) -> dict:
    """The IOConfig → ServingEngine options (cli.py and Predictor)."""
    return {
        "buckets": io_config.predict_bucket_list(),
        "quantize": io_config.predict_quantize,
        "donate": io_config.predict_donate,
        "algo": io_config.predict_algo,
        "shards": io_config.serve_shards,
        "linger_us": io_config.predict_linger_us,
        "queue": io_config.predict_queue,
    }
