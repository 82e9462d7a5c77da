"""The world of ranks and its collectives, over ``torch.distributed``.

Counterpart of lightgbm_tpu/parallel/mesh.py.  One process is one rank,
and one rank is one of the reference's "machines"; the reference's
Linkers bootstrap (linkers_socket.cpp:20-110) becomes
``torch.distributed.init_process_group`` from torch's own environment:
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and
``LOCAL_RANK``, as ``torch.distributed.run`` sets them
(``init_distributed``).  Without them there is no process group, and the
world is one rank.  The ``machine_list_file``, ``local_listen_port``
and ``time_out`` keys are checked and have no effect: the environment
does their work.

**Backend rule** (``comm_for``, logged once per device type):

- CPU tensors use gloo;
- CUDA ranks on distinct devices use NCCL;
- CUDA ranks that share a device use gloo on CUDA tensors, because NCCL
  refuses two ranks on one device.  Which ranks share a device is found
  by all-gathering each rank's device UUID.  A collective that gloo
  does not run on CUDA tensors is staged through a pinned host copy,
  with a warning, and its telemetry site gains ``/host_staged``.

The bootstrap group is always gloo: host-side exchanges (seeds, bin
mappers, metric rows, the clock handshake, the load route, the table of
a world's cache, ``gather_object`` to rank 0) ride it as pickled objects,
and ``host_comm`` runs small host tensors over it (the elastic
exchanges).

**The wait clock** (``collective_seconds``): the host seconds this rank
has spent inside collectives, every ``Comm`` call and every object
exchange.  A rank waits there for its slowest peer, so the seconds
between two points less the clock's advance are the rank's own work,
which the straggler drain compares (``GBDT._elastic_step``).  The host
sees a collective on a CUDA tensor only as far as the backend blocks:
with ``exact_waits`` on, such a call synchronizes the device before (the
rank's own queued kernels are its work) and after (NCCL returns before
the transfer ends), so the clock holds the wait alone.

**World size** (``world_size``): a ``num_machines`` larger than the world
warns and shrinks to the world, as ``get_mesh`` does in the JAX package
(linkers_socket.cpp:106-109).

**The 2-D grid** of the hybrid and voting learners (``grid_for``): the
JAX package's ``get_mesh2d`` lays ``devices[:ds * fs]`` out as a
``(data, feature)`` mesh; here the devices are ranks, so rank ``r`` sits
at data index ``d = r // fs`` and feature index ``f = r % fs``
(``factor_machines`` picks ``ds`` and ``fs``).  A ``Grid`` holds a
``Comm`` over its data group (the ranks of the same ``f``: histogram
sums, votes) and one over its feature group (the ranks of the same
``d``: the split record's reduction).  Every rank creates every group,
data groups first, in the same order, as ``new_group`` requires.

**The serving shards** (``serving_devices``): the JAX package's
``get_serving_mesh`` is a 1-D ``("tree",)`` mesh of the devices of one
process.  Here a shard is a contiguous tree block whose tables live on
one torch device, in one process: no rank of a world serves.

Not ported: ``global_row_layout``, ``make_global_rows`` and
``gather_ragged_rows`` (each rank holds its own rows; no padded global
array exists, and ``models.gbdt.SerialRows`` places a world's rows).
The collectives are library calls: no kernel of the port runs here.
"""
from __future__ import annotations

import datetime
import os
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import telemetry
from ..device import resolve_device
from ..utils import log

DATA_AXIS = "data"
FEATURE_AXIS = "feature"
TREE_AXIS = "tree"

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

# Comm.all_reduce's ops: (torch op, the JAX collective's kind)
_REDUCE_OPS = {"sum": (dist.ReduceOp.SUM, "psum"),
               "max": (dist.ReduceOp.MAX, "pmax"),
               "min": (dist.ReduceOp.MIN, "pmin")}

# the process group this module created (and so destroys), and the
# collective groups per device type
_owned = False
_comms: dict = {}

# the wait clock (module docstring): seconds inside collectives, and
# whether a collective on a CUDA tensor synchronizes the device around it
_wait_s = 0.0
_exact_waits = False


def factor_machines(num_machines: int, feature_shards: int = 0,
                    voting: bool = False) -> "tuple[int, int]":
    """``(data_shards, feature_shards)`` of a world of ``num_machines``
    ranks (JAX mesh.py:125-158): a ``feature_shards > 0`` is taken as it
    is and must divide the world (a ``Fatal`` otherwise); 0 resolves to
    ``(n, 1)`` under voting, else to the largest divisor of n that is at
    most sqrt(n) as the feature shards (4 -> (2, 2), 8 -> (4, 2), a prime
    -> (n, 1))."""
    n = max(int(num_machines), 1)
    if feature_shards > 0:
        if n % feature_shards:
            log.fatal("feature_shards=%d does not divide num_machines=%d"
                      % (feature_shards, n))
        return n // feature_shards, feature_shards
    if voting:
        return n, 1
    fs = 1
    for d in range(2, int(n ** 0.5) + 1):
        if n % d == 0:
            fs = d
    return n // fs, fs


def serving_devices(shards: int, device=None) -> "list[torch.device]":
    """One torch device per serving shard, shard ``s`` at ``[s]``
    (lightgbm_tpu/parallel/mesh.py:192-213, ``get_serving_mesh``).

    ``device`` names one device (``device.resolve_device``'s rule): on
    CUDA the ``shards`` consecutive devices from its index (``cuda:0``
    by default), and a ``Fatal`` when they pass
    ``torch.cuda.device_count()``, since the engine never shrinks its
    shards silently; on the CPU ``shards`` copies of the one CPU device
    torch has (the JAX package's CPU mesh is the 8 virtual devices its
    tests force, ``tests/conftest.py``).  A sequence of devices is taken
    as the placement, one per shard, so several shards may share one
    card; its length must be ``shards``.  Placement never changes the
    tree blocks or a score."""
    shards = int(shards)
    if shards < 1:
        log.fatal("serve_shards must be >= 1 to build a serving mesh "
                  "(got %d)" % shards)
    if isinstance(device, (list, tuple)):
        if len(device) != shards:
            raise ValueError("%d devices given for %d serving shards"
                             % (len(device), shards))
        return [resolve_device(d) for d in device]
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * shards
    start = dev.index or 0
    available = torch.cuda.device_count() - start
    if shards > available:
        log.fatal("serve_shards=%d exceeds available devices (%d) — the "
                  "tree-sharded engine never silently shrinks its mesh"
                  % (shards, available))
    return [torch.device("cuda", start + s) for s in range(shards)]


def _reduce_scatter():
    """``reduce_scatter_single``, or its older name on a torch without it
    (the newer torch's old name warns)."""
    return getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor


def _all_gather():
    return getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed() -> bool:
    """Join the world that torch's environment describes (module
    docstring), once; True when a process group is up.  The group is
    gloo; ``comm_for`` adds the collective group of a device."""
    global _owned
    if initialized():
        return True
    if not dist.is_available() or not all(k in os.environ for k in _ENV):
        return False
    dist.init_process_group("gloo", init_method="env://")
    _owned = True
    log.info("joined the world as rank %d of %d (gloo bootstrap, %s:%s)"
             % (dist.get_rank(), dist.get_world_size(),
                os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]))
    clock_handshake()
    return True


def shutdown() -> None:
    """Destroy the process group this module created (and every
    collective group on it), once every rank has come here (a bounded
    barrier: a rank that never comes is reported, not waited for); a
    group the caller created stays."""
    global _owned
    _comms.clear()
    if _owned and initialized():
        try:
            dist.monitored_barrier(timeout=datetime.timedelta(seconds=60))
        except RuntimeError as e:
            log.warning("leaving the world without every rank: %s"
                        % str(e).splitlines()[0])
        dist.destroy_process_group()
    _owned = False


def get_rank() -> int:
    """This process's rank (Network::rank); 0 without a world."""
    return dist.get_rank() if initialized() else 0


def get_num_machines() -> int:
    """The world's size; 1 without a world."""
    return dist.get_world_size() if initialized() else 1


def world_size(num_machines: int) -> int:
    """The learner's world: every rank of the process group.  A larger
    ``num_machines`` warns and shrinks to it."""
    world = get_num_machines()
    if num_machines > world:
        log.warning("num_machines=%d exceeds the world (%d ranks); "
                    "shrinking world size to match "
                    "(linkers_socket.cpp:106-109 behavior)"
                    % (num_machines, world))
    return world


def collective_seconds() -> float:
    """The wait clock: host seconds this rank has spent in collectives
    since it started (module docstring)."""
    return _wait_s


def exact_waits(on: bool) -> None:
    """Synchronize the device around each collective on a CUDA tensor,
    so that the wait clock holds the wait alone (the straggler drain
    arms it; off, a collective costs no synchronization)."""
    global _exact_waits
    _exact_waits = bool(on)


def _waited(t0: float) -> None:
    global _wait_s
    _wait_s += time.perf_counter() - t0


def all_gather_object(obj) -> list:
    """Every rank's ``obj``, in rank order (pickled, over the bootstrap
    group)."""
    if not initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    t0 = time.perf_counter()
    dist.all_gather_object(out, obj)
    _waited(t0)
    return out


def gather_object(obj) -> list:
    """Every rank's ``obj`` in rank order on rank 0, None on the others
    (pickled, over the bootstrap group); ``[obj]`` without a world."""
    if not initialized():
        return [obj]
    out = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    t0 = time.perf_counter()
    dist.gather_object(obj, out, dst=0)
    _waited(t0)
    return out


def clock_handshake() -> float:
    """Each rank's ``time.time()`` all-gathered at bootstrap; the
    leader-relative offset goes to ``telemetry.set_clock_offset`` with
    the exchange's round trip as its error bar (JAX mesh.py:63-95).
    Collective.  Returns the offset (0 without a world)."""
    if get_num_machines() <= 1:
        telemetry.set_clock_offset(0.0)
        return 0.0
    t0 = time.perf_counter()
    stamps = all_gather_object(time.time())
    rtt = time.perf_counter() - t0
    offset = float(stamps[0] - stamps[get_rank()])
    telemetry.set_clock_offset(offset, rtt_s=rtt)
    return offset


def sync_up_by_min(value):
    """GlobalSyncUpByMin (application.cpp:275-302): the smallest value
    over the world, in the value's own type."""
    if get_num_machines() <= 1:
        return value
    return type(value)(min(all_gather_object(value)))


def rank_device(device: torch.device) -> torch.device:
    """The rank's device: a CUDA device without an index becomes
    ``cuda:(LOCAL_RANK % device count)``, so ranks share the cards in
    turn (the one H100: every rank on it)."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


class Comm:
    """The collectives of one learner's world, on one device type.

    Every rank must call the same methods in the same order.  Each call
    files its telemetry ``site`` (``telemetry.collective_span``).  A
    world of one rank without a process group runs each op as the
    identity."""

    def __init__(self, group, backend: str, rank: int, size: int):
        self.group = group
        self.backend = backend
        self.rank = rank
        self.size = size
        self._staged = set()        # op kinds gloo refused on CUDA

    def _run(self, site: str, kind: str, axis: str, op, t: torch.Tensor,
             *out):
        """``op(*out, t)`` on the group, filed at ``site`` (over ``axis``,
        the JAX package's mesh axis of the same collective) with ``t``'s
        bytes, the payload this rank sends, as the JAX package files the
        collective's input, and on the wait clock; gloo on a CUDA tensor
        stages the op kinds it refuses through pinned host copies."""
        def direct(x):
            op(*out, x)

        def staged(x):
            hx = torch.empty(x.shape, dtype=x.dtype,
                             pin_memory=True).copy_(x)
            ho = [torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
                  for y in out]
            op(*ho, hx)
            for y, hy in zip(out, ho):
                y.copy_(hy)
            if not out:
                x.copy_(hx)

        sync = _exact_waits and t.is_cuda
        if sync:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        try:
            if self.backend == "gloo" and t.is_cuda:
                if kind not in self._staged:
                    try:
                        return telemetry.collective_span(
                            site, direct, kind=kind, axis=axis)(t)
                    except RuntimeError as e:
                        log.warning("gloo runs no %s on CUDA tensors (%s); "
                                    "staging it through host memory"
                                    % (kind, str(e).splitlines()[0]))
                        self._staged.add(kind)
                return telemetry.collective_span(
                    site + "/host_staged", staged, kind=kind, axis=axis)(t)
            return telemetry.collective_span(site, direct, kind=kind,
                                             axis=axis)(t)
        finally:
            if sync:
                torch.cuda.synchronize(t.device)
            _waited(t0)

    def all_reduce(self, t: torch.Tensor, site: str, op: str = "sum",
                   axis: str = DATA_AXIS) -> torch.Tensor:
        """The sum (or ``op="max"``, ``"min"``) of ``t`` over the world,
        in a new tensor."""
        t = t.contiguous().clone()
        if self.group is None:
            return t
        rop, kind = _REDUCE_OPS[op]
        self._run(site, kind, axis,
                  lambda x: dist.all_reduce(x, op=rop, group=self.group), t)
        return t

    def reduce_scatter(self, t: torch.Tensor, site: str) -> torch.Tensor:
        """``t`` [size * k, ...] summed over the world; this rank's block
        ``[rank * k, (rank + 1) * k)``."""
        t = t.contiguous()
        k = t.shape[0] // self.size
        if self.group is None:
            return t.clone()
        out = torch.empty((k,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        fn = _reduce_scatter()
        self._run(site, "psum_scatter", DATA_AXIS,
                  lambda o, x: fn(o, x, group=self.group), t, out)
        return out

    def all_gather(self, t: torch.Tensor, site: str,
                   axis: str = DATA_AXIS) -> torch.Tensor:
        """[size, *t.shape]: every rank's ``t`` in rank order."""
        if self.group is None:
            return t[None].clone()
        flat = t.reshape(-1).contiguous()
        out = torch.empty(self.size * flat.numel(), dtype=t.dtype,
                          device=t.device)
        fn = _all_gather()
        self._run(site, "all_gather", axis,
                  lambda o, x: fn(o, x, group=self.group), flat, out)
        return out.view((self.size,) + tuple(t.shape))


def host_comm() -> Comm:
    """The world's collectives on host (CPU) tensors, over the gloo
    bootstrap group: the small exchanges every rank makes whatever its
    learner (the elastic seconds and votes).  A world of one rank
    without a process group runs each op as the identity."""
    if not initialized():
        return Comm(None, "none", 0, 1)
    return Comm(dist.group.WORLD, "gloo", dist.get_rank(),
                dist.get_world_size())


def _backend(device: torch.device) -> "tuple[str, str]":
    """(backend, why) of this rank's ``device`` under the backend rule
    (module docstring).  Collective on a CUDA device (the UUID
    gather)."""
    if device.type != "cuda":
        return "gloo", "CPU tensors"
    torch.cuda.set_device(device)
    uuids = all_gather_object(
        str(torch.cuda.get_device_properties(device).uuid))
    if len(set(uuids)) == len(uuids):
        return "nccl", "each rank on its own device"
    return "gloo", ("%d ranks share %d device(s); NCCL refuses two ranks "
                    "on one device" % (len(uuids), len(set(uuids))))


def comm_for(device: torch.device) -> Comm:
    """The collective group of this rank's ``device`` under the backend
    rule (module docstring).  Collective the first time per device
    type: every rank calls it at the same point."""
    key = device.type
    comm = _comms.get(key)
    if comm is not None:
        return comm
    if not initialized():
        comm = Comm(None, "none", 0, 1)
        _comms[key] = comm
        return comm
    rank, size = dist.get_rank(), dist.get_world_size()
    backend, why = _backend(device)
    group = (dist.new_group(backend="nccl") if backend == "nccl"
             else dist.group.WORLD)
    log.info("collectives: %s backend over %d rank(s) (%s)"
             % (backend, size, why))
    comm = Comm(group, backend, rank, size)
    _comms[key] = comm
    return comm


class Grid(NamedTuple):
    """This rank's place in the 2-D grid of a hybrid or voting world
    (module docstring): ``ds`` x ``fs`` ranks, this one at data index
    ``d`` and feature index ``f``; ``data`` reduces over the ranks of
    the same ``f``, ``feature`` over the ranks of the same ``d``."""
    ds: int
    fs: int
    d: int
    f: int
    data: Comm
    feature: Comm


def grid_for(device: torch.device, ds: int, fs: int) -> Grid:
    """The 2-D grid of ``ds`` x ``fs`` ranks for this rank's ``device``,
    its groups under the backend rule.  Collective: every rank calls it
    once per learner bind, and creates every group (``new_group``),
    data groups first.  Without a process group the grid is one rank and
    both groups run each op as the identity."""
    if not initialized():
        one = Comm(None, "none", 0, 1)
        return Grid(1, 1, 0, 0, one, one)
    rank, size = dist.get_rank(), dist.get_world_size()
    log.check(ds * fs == size, "a %d x %d grid of ranks needs a world of "
              "%d ranks, not %d" % (ds, fs, ds * fs, size))
    backend, why = _backend(device)
    d, f = divmod(rank, fs)
    data = feature = None
    for g in range(fs):
        group = dist.new_group(ranks=[g + fs * i for i in range(ds)],
                               backend=backend)
        if g == f:
            data = Comm(group, backend, d, ds)
    for g in range(ds):
        group = dist.new_group(ranks=[g * fs + j for j in range(fs)],
                               backend=backend)
        if g == d:
            feature = Comm(group, backend, f, fs)
    log.info("collectives: a %d x %d grid of ranks (data x feature), %s "
             "backend (%s); rank %d at data %d, feature %d"
             % (ds, fs, backend, why, rank, d, f))
    return Grid(ds, fs, d, f, data, feature)


__all__ = ["Comm", "DATA_AXIS", "FEATURE_AXIS", "Grid", "all_gather_object",
           "clock_handshake", "comm_for", "factor_machines",
           "collective_seconds", "exact_waits", "gather_object", "get_rank",
           "get_num_machines", "grid_for",
           "host_comm",
           "init_distributed", "initialized", "rank_device", "shutdown",
           "sync_up_by_min", "world_size"]
