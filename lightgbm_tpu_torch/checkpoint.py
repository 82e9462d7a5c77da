"""Training checkpoints: the port's copy of lightgbm_tpu/checkpoint.py.

A checkpoint is ONE self-verifying file holding everything a
``task=train`` restart needs to continue bit for bit: the training-side
tree arrays (the text format drops ``split_feature``/``threshold_bin``,
which the binned score replay needs, so trees are serialized in full;
JSON floats round-trip f64 exactly), the sampler state (the threefry
draw counter, or the host MT19937 state and current mask; one MT19937
state per class for ``feature_fraction``), the iteration count, the
early-stopping state (``best_score``/``best_iter``), the raw f32 train
and validation scores, and config and dataset fingerprints compared
field by field on load (a mismatch names the field).  Scores are stored,
not replayed: a replay of the shrunk leaf values through the f64
learning-rate product lands an ulp away from the in-grow f32 update.

The payload is the JAX package's, field for field, so a checkpoint
written by either package is read by the other.  The port's trees add
one optional field, ``leaf_count`` (rows per leaf, which the text format
does not carry); the JAX reader ignores it, and a tree read without it
has none, as a tree read from model text has none.

File format (atomicity + truncation/corruption detection)::

    lightgbm_tpu_checkpoint v1 sha256=<hex> bytes=<payload-len>\\n
    <payload JSON, exactly bytes long>

Writes go to a temp file in the same directory, fsync, then one
``os.replace``: a crash mid-write leaves the previous checkpoint loadable
and at worst a stray ``.tmp-*`` file the loader ignores.  ``load``
verifies the payload length (a short read names the truncation), the
sha256 (corruption), and then every required field (a missing or
mistyped field is named in the error).

``CheckpointWriter`` is the background path ``GBDT.run_training`` uses:
the loop hands it a raw snapshot (host copies of the scores, the tree
list, RNG states) and a thread serializes and writes it.  It holds ONE
pending snapshot (latest wins; a slow disk never stalls training;
replaced snapshots count in ``dropped``).  A live writer is tracked by
``lifecycle`` until it is closed, so a test that leaves one running
shows it as a leak.

Telemetry and trace events, as the JAX package files them:
``ckpt/written``, ``ckpt/pruned``, ``ckpt/snapshots``, ``ckpt/dropped``
and ``ckpt/async_write_us`` counters, ``ckpt/restored`` (counted by
``GBDT.restore_checkpoint``), and the flight recorder's ``ckpt_write``
and ``ckpt_drop`` events; ``written`` and ``dropped`` stay attributes of
the writer too.
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import re
import threading
import time
from typing import List, Optional

import numpy as np

from . import lifecycle, telemetry, tracing
from .utils import log

MAGIC = "lightgbm_tpu_checkpoint"
VERSION = 1
_HEADER_RE = re.compile(
    r"^lightgbm_tpu_checkpoint v(\d+) sha256=([0-9a-f]{64}) bytes=(\d+)\n")
_CKPT_NAME_RE = re.compile(r"^ckpt-(\d{8})\.json$")

# the lifecycle kind of a live writer thread
WRITER_KIND = "ckpt-writer"


class CheckpointError(Exception):
    """A checkpoint file that must not be restored: truncated, corrupt,
    malformed, or config-mismatched.  The message names the failing
    field or section."""


def live_writers() -> int:
    """CheckpointWriter threads still tracked live."""
    return sum(1 for kind, _, _ in lifecycle.leaks() if kind == WRITER_KIND)


# ---------------------------------------------------------- serialization

def rng_state_to_json(state) -> dict:
    """numpy RandomState.get_state() tuple -> JSON-safe dict."""
    alg, keys, pos, has_gauss, cached = state
    return {"alg": str(alg), "keys": np.asarray(keys, np.uint32).tolist(),
            "pos": int(pos), "has_gauss": int(has_gauss),
            "cached_gaussian": float(cached)}


def rng_state_from_json(obj):
    return (obj["alg"], np.asarray(obj["keys"], np.uint32), int(obj["pos"]),
            int(obj["has_gauss"]), float(obj["cached_gaussian"]))


def mask_to_json(mask: np.ndarray) -> dict:
    packed = np.packbits(np.asarray(mask, bool))
    return {"n": int(np.asarray(mask).size),
            "bits": base64.b64encode(packed.tobytes()).decode("ascii")}


def mask_from_json(obj) -> np.ndarray:
    packed = np.frombuffer(base64.b64decode(obj["bits"]), np.uint8)
    return np.unpackbits(packed)[:int(obj["n"])].astype(bool)


def array_to_json(arr) -> dict:
    """Raw little-endian f32 bytes, base64: bit-exact, no text-float
    round trip on the score arrays."""
    arr = np.ascontiguousarray(np.asarray(arr, np.float32))
    return {"shape": list(arr.shape), "dtype": "float32",
            "data": base64.b64encode(arr.tobytes()).decode("ascii")}


def array_from_json(obj) -> np.ndarray:
    arr = np.frombuffer(base64.b64decode(obj["data"]), np.float32)
    return arr.reshape(obj["shape"]).copy()


def bag_snapshot_to_json(snap) -> Optional[dict]:
    """``GBDT._bag_snapshot`` -> JSON.  The threefry stream's whole state
    is the draw counter (the current mask is a function of it); the host
    stream is the MT19937 state and the current mask."""
    if snap is None:
        return None
    if snap[0] == "device":
        return {"mode": "device", "draw_idx": int(snap[1])}
    _, state, mask = snap
    return {"mode": "host", "state": rng_state_to_json(state),
            "mask": mask_to_json(mask)}


def tree_to_json(tree) -> dict:
    """Every training-side tree array; JSON floats are written at
    ``repr`` precision and round-trip f64 bitwise.  ``leaf_count`` is the
    port's optional field."""
    out = {
        "num_leaves": int(tree.num_leaves),
        "split_feature": tree.split_feature.tolist(),
        "split_feature_real": tree.split_feature_real.tolist(),
        "threshold_bin": tree.threshold_bin.tolist(),
        "threshold": tree.threshold.tolist(),
        "split_gain": tree.split_gain.tolist(),
        "left_child": tree.left_child.tolist(),
        "right_child": tree.right_child.tolist(),
        "leaf_parent": tree.leaf_parent.tolist(),
        "leaf_value": tree.leaf_value.tolist(),
    }
    if tree.leaf_count is not None:
        out["leaf_count"] = tree.leaf_count.tolist()
    return out


def tree_from_json(obj):
    from .models.tree import Tree
    count = obj.get("leaf_count")
    return Tree(
        num_leaves=int(obj["num_leaves"]),
        split_feature=np.asarray(obj["split_feature"], np.int32),
        split_feature_real=np.asarray(obj["split_feature_real"], np.int32),
        threshold_bin=np.asarray(obj["threshold_bin"], np.int32),
        threshold=np.asarray(obj["threshold"], np.float64),
        split_gain=np.asarray(obj["split_gain"], np.float64),
        left_child=np.asarray(obj["left_child"], np.int32),
        right_child=np.asarray(obj["right_child"], np.int32),
        leaf_parent=np.asarray(obj["leaf_parent"], np.int32),
        leaf_value=np.asarray(obj["leaf_value"], np.float64),
        leaf_count=None if count is None else np.asarray(count, np.int32),
    )


def serialize_state(raw: dict) -> dict:
    """Raw booster snapshot (``GBDT.checkpoint_state``: Tree references,
    host score copies, RNG state tuples) -> the JSON-safe payload.  Runs
    on the writer thread in the background path."""
    bag, ff = raw["rng"]
    return {
        "magic": MAGIC,
        "version": VERSION,
        "iteration": int(raw["iteration"]),
        "num_class": int(raw["num_class"]),
        "trees": [tree_to_json(t) for t in raw["models"]],
        "best_score": [list(map(float, row)) for row in raw["best_score"]],
        "best_iter": [list(map(int, row)) for row in raw["best_iter"]],
        "rng": {
            "bagging": bag_snapshot_to_json(bag),
            "feature_fraction": ([rng_state_to_json(s) for s in ff]
                                 if ff is not None else None),
        },
        "score": array_to_json(raw["score"]),
        "valid_scores": [array_to_json(s) for s in raw["valid_scores"]],
        "config": dict(raw["config"]),
        "dataset": dict(raw["dataset"]),
        "topology": dict(raw["topology"]),
        "wall_time": time.time(),
    }


# --------------------------------------------------------------- file I/O

def checkpoint_path(directory: str, iteration: int) -> str:
    return os.path.join(directory, "ckpt-%08d.json" % iteration)


def list_checkpoints(directory: str) -> List[str]:
    """Finished checkpoint files in the directory, oldest first.  Stray
    ``.tmp-*`` files (a killed writer) are ignored by construction."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    found = []
    for name in names:
        m = _CKPT_NAME_RE.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(directory, name)))
    return [p for _, p in sorted(found)]


def latest_checkpoint(directory: str) -> Optional[str]:
    paths = list_checkpoints(directory)
    return paths[-1] if paths else None


def write_checkpoint(directory: str, payload: dict, keep: int = 2) -> str:
    """Atomic write: temp file in the SAME directory, fsync,
    ``os.replace``.  A crash at any point leaves the previous checkpoint
    loadable.  Prunes to the newest ``keep`` finished files after the
    rename (the new file counts)."""
    os.makedirs(directory, exist_ok=True)
    body = json.dumps(payload).encode("utf-8")
    header = ("%s v%d sha256=%s bytes=%d\n"
              % (MAGIC, VERSION, hashlib.sha256(body).hexdigest(),
                 len(body))).encode("ascii")
    final = checkpoint_path(directory, int(payload["iteration"]))
    tmp = os.path.join(directory,
                       ".tmp-%d-%d" % (os.getpid(), threading.get_ident()))
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(body)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    telemetry.count("ckpt/written")
    if tracing.active():
        tracing.event("ckpt_write", iter=int(payload["iteration"]),
                      bytes=len(body))
    if keep >= 1:
        for old in list_checkpoints(directory)[:-keep]:
            try:
                os.unlink(old)
                telemetry.count("ckpt/pruned")
            except OSError:
                pass
    return final


def _require(payload: dict, field: str, typ, what: str = "checkpoint"):
    if field not in payload:
        raise CheckpointError("%s field '%s' is missing" % (what, field))
    v = payload[field]
    if not isinstance(v, typ):
        raise CheckpointError(
            "%s field '%s' has the wrong type (%s, expected %s)"
            % (what, field, type(v).__name__,
               getattr(typ, "__name__", str(typ))))
    return v


def load_checkpoint(path: str) -> dict:
    """Read and verify one checkpoint file.  Raises CheckpointError naming
    what is wrong: header, truncation (with byte counts), sha256
    corruption, or the first missing or mistyped payload field."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise CheckpointError("%s: unreadable (%s)" % (path, e))
    nl = data.find(b"\n")
    if nl < 0:
        raise CheckpointError(
            "%s: truncated before the end of the header line" % path)
    m = _HEADER_RE.match(data[:nl + 1].decode("ascii", "replace"))
    if m is None:
        raise CheckpointError(
            "%s: not a %s file (bad header line)" % (path, MAGIC))
    version, digest, nbytes = int(m.group(1)), m.group(2), int(m.group(3))
    if version != VERSION:
        raise CheckpointError(
            "%s: checkpoint version %d unsupported (this build reads v%d)"
            % (path, version, VERSION))
    body = data[nl + 1:]
    if len(body) != nbytes:
        raise CheckpointError(
            "%s: truncated payload — %d of %d declared bytes present"
            % (path, len(body), nbytes))
    if hashlib.sha256(body).hexdigest() != digest:
        raise CheckpointError(
            "%s: payload sha256 mismatch (corrupt checkpoint)" % path)
    try:
        payload = json.loads(body.decode("utf-8"))
    except ValueError as e:
        raise CheckpointError("%s: payload is not valid JSON (%s)"
                              % (path, e))
    if not isinstance(payload, dict):
        raise CheckpointError("%s: payload is not a JSON object" % path)
    if payload.get("magic") != MAGIC:
        raise CheckpointError(
            "checkpoint field 'magic' is missing or wrong")
    _require(payload, "iteration", int)
    _require(payload, "num_class", int)
    _require(payload, "trees", list)
    _require(payload, "best_score", list)
    _require(payload, "best_iter", list)
    rng = _require(payload, "rng", dict)
    if "bagging" not in rng or "feature_fraction" not in rng:
        raise CheckpointError(
            "checkpoint field 'rng' is missing its "
            "'bagging'/'feature_fraction' entries")
    _require(payload, "config", dict)
    _require(payload, "dataset", dict)
    _require(payload, "topology", dict)
    score = _require(payload, "score", dict)
    if "shape" not in score or "data" not in score:
        raise CheckpointError(
            "checkpoint field 'score' is missing its 'shape'/'data' "
            "entries")
    _require(payload, "valid_scores", list)
    for i, t in enumerate(payload["trees"]):
        if not isinstance(t, dict) or "num_leaves" not in t:
            raise CheckpointError(
                "checkpoint field 'trees[%d]' is not a serialized tree" % i)
    return payload


def check_fingerprint(payload: dict, config: dict, dataset: dict) -> None:
    """Field-by-field comparison of the checkpoint's config and dataset
    fingerprints against the restoring run's.  Topology fields are not
    compared (the JAX package restarts elastically across them)."""
    for section, want in (("config", config), ("dataset", dataset)):
        have = payload[section]
        for field in sorted(set(want) | set(have)):
            if field not in have:
                raise CheckpointError(
                    "checkpoint %s field '%s' is missing (written by an "
                    "older build?)" % (section, field))
            if field not in want:
                # a newer writer recorded a field this build does not
                # know: refusing would break forward compatibility
                continue
            if have[field] != want[field]:
                raise CheckpointError(
                    "checkpoint %s field '%s' mismatch: checkpoint has "
                    "%r, this run has %r — refusing to continue a "
                    "different training run" % (section, field,
                                                have[field], want[field]))


# ---------------------------------------------------------- async writer

class CheckpointWriter:
    """Background checkpoint writer: ``submit(raw_state)`` replaces the
    single pending slot and returns at once; the thread serializes and
    writes atomically.  ``write_sync`` serializes and writes on the
    calling thread (the final checkpoint).  ``close`` drains the pending
    slot and joins the thread; always call it."""

    def __init__(self, directory: str, keep: int = 2):
        self.directory = directory
        self.keep = max(int(keep), 1)
        self._cv = threading.Condition()
        self._pending: Optional[dict] = None
        self._closing = False
        self._error: Optional[BaseException] = None
        self.written = 0
        self.dropped = 0
        self._thread = threading.Thread(
            target=self._run, name="lgbm-torch-ckpt-writer", daemon=True)
        lifecycle.track(WRITER_KIND, self, self.close)
        self._thread.start()

    def submit(self, raw_state: dict) -> None:
        """Enqueue a raw snapshot (latest wins; never blocks)."""
        with self._cv:
            if self._closing:
                raise RuntimeError("CheckpointWriter is closed")
            if self._pending is not None:
                self.dropped += 1
                telemetry.count("ckpt/dropped")
                if tracing.active():
                    tracing.event("ckpt_drop")
            self._pending = raw_state
            telemetry.count("ckpt/snapshots")
            self._cv.notify()

    def write_sync(self, raw_state: dict) -> str:
        """Serialize and write on the calling thread."""
        path = write_checkpoint(self.directory, serialize_state(raw_state),
                                keep=self.keep)
        with self._cv:
            self.written += 1
        return path

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._closing:
                    self._cv.wait()
                raw, self._pending = self._pending, None
                if raw is None and self._closing:
                    return
            try:
                t0 = time.perf_counter()
                write_checkpoint(self.directory, serialize_state(raw),
                                 keep=self.keep)
                with self._cv:
                    self.written += 1
                telemetry.count("ckpt/async_write_us",
                                int(1e6 * (time.perf_counter() - t0)))
            except Exception as e:  # disk trouble: keep the last good file
                self._error = e
                log.warning("background checkpoint write failed: %s" % e)

    def close(self, join_s: float = 10.0) -> None:
        with self._cv:
            self._closing = True
            self._cv.notify()
        self._thread.join(join_s)
        if self._thread.is_alive():
            # a writer wedged on a hung disk stays tracked, so the leak
            # check surfaces a thread that outlives its training run
            log.warning("checkpoint writer thread did not exit within "
                        "%.1fs (hung write?); leaving it tracked" % join_s)
        else:
            lifecycle.untrack(self)
        if self._error is not None:
            log.warning("checkpoint writer had failed earlier: %s"
                        % self._error)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()
