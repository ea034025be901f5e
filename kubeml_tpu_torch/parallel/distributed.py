"""Multi-process setup over ``torch.distributed``, the port of
``kubeml_tpu/parallel/distributed.py``.

The JAX package runs one process per TPU-VM host under JAX's
multi-controller runtime. The port runs one process per device (a rank),
wired by ``torch.distributed``:

* :func:`init_distributed` - one process group from the same variables
  as JAX's (``KUBEML_COORDINATOR``, ``KUBEML_NUM_PROCESSES``,
  ``KUBEML_PROCESS_ID``); a no-op for one process. The module makes the
  rendezvous store itself (a ``TCPStore`` on ``host:port``, or a
  ``FileStore`` for a ``file://`` coordinator on one host) and hands it to
  ``init_process_group(store=...)``; :class:`DistContext` reads the same
  store. The backend is an explicit argument: ``"nccl"`` for CUDA ranks
  and ``"gloo"`` for CPU ranks by default. A CUDA rank takes
  ``cuda:{local rank}``; two NCCL ranks on one device raise (NCCL refuses
  them), and only ``backend="gloo"`` lets ranks share a card.
* :func:`global_mesh` - a mesh over every rank, ``dp`` laid across hosts
  (the counterpart of the TPU's slices: :func:`num_slices` counts the
  distinct hosts in the group) and the model axes within one host.
* :func:`local_batch_slice` - the rows of a global batch this process
  feeds.
* :class:`DistContext` - leader/follower decisions (stop, elastic level,
  acknowledgements) broadcast over the store, a host channel that never
  races device collectives, as in JAX. A follower waits for the leader's
  next broadcast without a deadline, but a ``TCPStore`` whose server (the
  leader's process) died makes the wait raise, so a follower ends instead
  of hanging (JAX gets this from its coordination service); a ``file://``
  store gives no such signal.
* :func:`subgroup` - the process group of a subset of the ranks, cached
  by its rank set (the elastic remesh builds meshes over the first ``k``
  ranks); :func:`rank_hosts` - each rank's host, by rank.
* :func:`hybrid_mesh_shapes`, :func:`worker_device_count`,
  :func:`pick_worker_devices`, :func:`local_worker_rows` - the JAX
  package's pure layout math, unchanged.
* :func:`spawn` - start ``n`` ranks of a function on this host with the
  three variables set (the tests and ``chip_smoke.py`` launch ranks so).

The process group is per process, so its state lives in this module, as
JAX's runtime state does in ``jax.distributed``.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import socket
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import AXIS_ORDER, make_mesh, mesh_shape_for

log = logging.getLogger("kubeml.distributed")

BACKENDS = ("nccl", "gloo")
# how long a rank waits for the others at the rendezvous and in a
# collective before the process group gives up
TIMEOUT_S = 600.0


@dataclass
class _State:
    store: Any
    rank: int
    size: int
    hosts: List[str]  # each rank's host name, by rank
    device: torch.device


_state: Optional[_State] = None


def rank_device(backend: str, device_type: str, local_rank: int,
                device_count: int) -> torch.device:
    """The device of the rank that is ``local_rank``-th on its host.

    CPU ranks take the CPU (gloo only). A CUDA rank takes ``cuda:{local
    rank}``; with more ranks than cards, gloo ranks share the cards round
    robin, while NCCL ranks raise: NCCL refuses two ranks on one device,
    and the port never switches backend on its own."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (valid: {BACKENDS})")
    if device_type == "cpu":
        if backend == "nccl":
            raise ValueError("backend 'nccl' needs CUDA ranks; CPU ranks "
                             "take backend='gloo'")
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"a rank runs on 'cuda' or 'cpu', not "
                         f"{device_type!r}")
    if device_count < 1:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run CPU ranks over gloo")
    if backend == "nccl" and local_rank >= device_count:
        raise ValueError(
            f"local rank {local_rank} has no CUDA device of its own (this "
            f"host has {device_count}): NCCL refuses two ranks on one "
            f"device; pass backend='gloo' to let ranks share a device")
    return torch.device("cuda", local_rank % device_count)


def _make_store(address: str, size: int, rank: int):
    if address.startswith("file://"):
        return dist.FileStore(address[len("file://"):], size)
    host, sep, port = address.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"coordinator address must be host:port or "
                         f"file://path, got {address!r}")
    return dist.TCPStore(host, int(port), size, is_master=rank == 0,
                         timeout=datetime.timedelta(seconds=TIMEOUT_S))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: Optional[str] = None) -> bool:
    """Join this process to the process group; True when distributed.

    The three JAX variables default to ``KUBEML_COORDINATOR`` (``host:port``
    of rank 0's store, or ``file://path`` on one host),
    ``KUBEML_NUM_PROCESSES`` and ``KUBEML_PROCESS_ID``. Without a
    coordinator and with at most one process this is a no-op, so one
    binary serves one card and many. ``device`` is the ranks' device type,
    ``"cuda"`` (the default; it raises without a card) or ``"cpu"``;
    ``backend`` defaults to ``"nccl"`` for CUDA ranks and ``"gloo"`` for
    CPU ranks. Idempotent."""
    global _state
    if _state is not None:
        return _state.size > 1
    coordinator_address = (coordinator_address
                           or os.environ.get("KUBEML_COORDINATOR"))
    if num_processes is None:
        env = os.environ.get("KUBEML_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("KUBEML_PROCESS_ID")
        process_id = int(env) if env else None
    if coordinator_address is None and num_processes in (None, 1):
        log.info("single-process mode (no KUBEML_COORDINATOR)")
        return False
    if coordinator_address is None or num_processes is None or \
            process_id is None:
        raise ValueError("a process group needs the coordinator address, "
                         "the number of processes and this process's id "
                         "(KUBEML_COORDINATOR, KUBEML_NUM_PROCESSES, "
                         "KUBEML_PROCESS_ID)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in "
                         f"[0, {num_processes})")
    device_type = torch.device(device or "cuda").type
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    rank_device(backend, device_type, 0, count)  # fail before rendezvous
    store = _make_store(coordinator_address, num_processes, process_id)
    # each rank's host: the local rank, and the hosts the slices stand for
    store.set(f"kubeml/host/{process_id}", socket.gethostname())
    hosts = [store.get(f"kubeml/host/{r}").decode()
             for r in range(num_processes)]
    local_rank = sum(h == hosts[process_id] for h in hosts[:process_id])
    dev = rank_device(backend, device_type, local_rank, count)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _state = _State(store, process_id, num_processes, hosts, dev)
    log.info("distributed: rank %d/%d on %s (%s), %d host(s)", process_id,
             num_processes, dev, backend, len(set(hosts)))
    return True


def shutdown() -> None:
    """Leave the process group (no-op when not distributed)."""
    global _state, _dist_context
    if _state is not None:
        dist.destroy_process_group()
    _state = None
    _dist_context = None
    _subgroups.clear()


def process_index() -> int:
    return 0 if _state is None else _state.rank


def process_count() -> int:
    return 1 if _state is None else _state.size


def local_device() -> Optional[torch.device]:
    """This rank's device (None when not distributed)."""
    return None if _state is None else _state.device


def num_slices() -> int:
    """Distinct hosts in the process group (1 when not distributed): the
    port's counterpart of the TPU's ICI-connected slices."""
    return 1 if _state is None else len(set(_state.hosts))


def rank_hosts() -> List[str]:
    """Each rank's host name, by rank (one entry when not distributed)."""
    return [socket.gethostname()] if _state is None else list(_state.hosts)


_subgroups: Dict[Tuple[int, ...], Any] = {}


def subgroup(ranks: Sequence[int]):
    """The process group of ``ranks`` (ascending), created at its first
    request and cached by its rank set. ``dist.new_group`` is collective
    over the whole world: every rank, the ranks outside ``ranks`` too,
    must request every group in the same order, so the caches of all
    ranks hold the same groups."""
    key = tuple(int(r) for r in ranks)
    if list(key) != sorted(set(key)):
        raise ValueError(f"a group's ranks must ascend, got {list(key)}")
    group = _subgroups.get(key)
    if group is None:
        group = _subgroups[key] = dist.new_group(list(key))
    return group


def hybrid_mesh_shapes(
    shape: Dict[str, int], n_slices: int, n_devices: int, dcn_axis: str = "dp"
) -> Tuple[Tuple[str, ...], list, list]:
    """Pure layout math for the hybrid mesh: (axis names, per-slice shape,
    across-slice shape), as JAX computes them."""
    if dcn_axis not in shape:
        raise ValueError(
            f"dcn_axis {dcn_axis!r} missing from mesh shape {shape}; on a "
            f"{n_slices}-slice topology one axis must span the slices"
        )
    per_slice = n_devices // n_slices
    model = int(np.prod([s for ax, s in shape.items() if ax != dcn_axis]))
    if per_slice % model != 0:
        raise ValueError(
            f"model axes use {model} devices which does not divide the "
            f"{per_slice}-device slice; keep tp/sp/ep/pp within one slice"
        )
    if shape[dcn_axis] % n_slices != 0:
        raise ValueError(
            f"{dcn_axis}={shape[dcn_axis]} must be divisible by the "
            f"{n_slices} slices it spans"
        )
    names = tuple(ax for ax in AXIS_ORDER if ax in shape)
    ici_shape = [shape[ax] // n_slices if ax == dcn_axis else shape[ax]
                 for ax in names]
    dcn_shape = [n_slices if ax == dcn_axis else 1 for ax in names]
    return names, ici_shape, dcn_shape


def hybrid_grid(hosts: Sequence[str], ici_shape, dcn_shape) -> np.ndarray:
    """The rank grid of a hybrid mesh: each host's ranks (ascending) fill
    one ``ici_shape`` block, and the blocks tile the grid in ``dcn_shape``
    order, hosts ordered by their lowest rank (the block layout of JAX's
    ``create_hybrid_device_mesh``)."""
    order = list(dict.fromkeys(hosts))
    dims = [i * d for i, d in zip(ici_shape, dcn_shape)]
    grid = np.empty(dims, dtype=np.int64)
    per = int(np.prod(ici_shape))
    for s, host in enumerate(order):
        ranks = [r for r, h in enumerate(hosts) if h == host]
        if len(ranks) != per:
            raise ValueError(f"host {host} runs {len(ranks)} ranks; every "
                             f"host needs {per} for this mesh")
        at = np.unravel_index(s, dcn_shape)
        grid[tuple(slice(a * i, (a + 1) * i)
                   for a, i in zip(at, ici_shape))] = (
            np.array(ranks).reshape(ici_shape))
    return grid


def global_mesh(shape: Optional[Dict[str, int]] = None, dcn_axis: str = "dp",
                **axes: int):
    """A mesh over every rank: the model axes (tp/sp/ep/pp) within one
    host, ``dcn_axis`` (default ``dp``) across hosts. One host (or no
    process group) gives the plain :func:`~.mesh.make_mesh` layout."""
    n = process_count()
    if shape is None:
        shape = mesh_shape_for(n, **axes)
    n_slices = num_slices()
    if n_slices == 1:
        return make_mesh(shape=shape)
    names, ici_shape, dcn_shape = hybrid_mesh_shapes(shape, n_slices, n,
                                                     dcn_axis)
    grid = hybrid_grid(_state.hosts, ici_shape, dcn_shape)
    return make_mesh(shape={ax: shape[ax] for ax in names}, grid=grid)


def worker_device_count(n_workers: int, n_devices: int, n_procs: int = 1) -> int:
    """Devices the 1-D ``worker`` mesh should span.

    Single-process: the largest ``d <= n_devices`` dividing ``n_workers``
    (workers pack onto devices when N > devices). Multi-process:
    additionally ``d`` must be a multiple of ``n_procs`` so every process
    contributes an equal block of the worker axis. Requires ``n_workers %
    n_procs == 0``."""
    if n_procs > 1:
        if n_workers % n_procs != 0:
            raise ValueError(
                f"n_workers={n_workers} must be a multiple of the "
                f"{n_procs} host processes"
            )
        d = min(n_workers, (n_devices // n_procs) * n_procs)
        while d > n_procs and (n_workers % d != 0 or d % n_procs != 0):
            d -= n_procs
        return max(d, n_procs)
    d = min(n_workers, n_devices)
    while d > 1 and n_workers % d != 0:
        d -= 1
    return d


def pick_worker_devices(n_workers: int, devices: Sequence,
                        n_procs: int = 1) -> list:
    """The device block for the worker mesh, process-major so contiguous
    worker rows land on one process. Each device carries the
    ``process_index`` of the process that owns it."""
    devices = list(devices)
    d = worker_device_count(n_workers, len(devices), n_procs)
    if n_procs <= 1:
        return devices[:d]
    per = d // n_procs
    chosen: list = []
    for p in range(n_procs):
        local = [dv for dv in devices if dv.process_index == p]
        if len(local) < per:
            raise ValueError(
                f"process {p} has {len(local)} devices, need {per} for the "
                f"worker mesh"
            )
        chosen.extend(local[:per])
    return chosen


def local_worker_rows(n_workers: int, rank: int, size: int) -> Tuple[int, int]:
    """[start, end) rows of the ``[N, ...]`` worker axis this process feeds."""
    if size <= 1:
        return 0, n_workers
    if n_workers % size != 0:
        raise ValueError(
            f"n_workers={n_workers} must be a multiple of {size} processes"
        )
    per = n_workers // size
    return rank * per, (rank + 1) * per


def local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """[start, end) rows of the global batch this process feeds; the
    global batch must divide evenly over the processes."""
    n = process_count()
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} must be divisible by the "
            f"{n} host processes"
        )
    per = global_batch // n
    start = process_index() * per
    return start, start + per


class DistContext:
    """Host-channel coordination between the leader (rank 0) and the
    followers, over the process group's store.

    Decisions travel as sequence-numbered keys of the store, never as
    device collectives, so a broadcast cannot interleave with a step's
    collectives. Every process must call each method at the same point of
    its program. One process gets an in-memory store, so the same code
    runs alone. Use :func:`get_dist_context`: the sequence counter must be
    shared process-wide."""

    # key N - LAG is deleted when key N is written (JAX's window)
    BCAST_GC_LAG = 8192

    def __init__(self):
        self.rank = process_index()
        self.size = process_count()
        self._store = dist.HashStore() if _state is None else _state.store
        self._seq = 0
        self._barrier_seq = -1
        self._lock = threading.Lock()

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def _next_key(self) -> Tuple[str, int]:
        with self._lock:
            seq = self._seq
            self._seq += 1
        return f"kubeml/bcast/{seq}", seq

    def _wait(self, key: str, timeout_s: Optional[float]) -> bool:
        """Poll the store for ``key``; False once ``timeout_s`` passed.
        Raises ``ConnectionError`` when the store is gone (a ``TCPStore``
        whose server, the leader's process, died)."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        pause = 0.001
        while True:
            try:
                if self._store.check([key]):
                    return True
            except (dist.DistNetworkError, RuntimeError) as e:
                raise ConnectionError(
                    f"rank {self.rank}: the process group's store is gone "
                    f"while waiting for {key!r} (the leader died?): "
                    f"{str(e).splitlines()[0]}") from e
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(pause)
            pause = min(pause * 2, 0.05)

    def broadcast_obj(self, obj=None):
        """Broadcast a JSON-serializable object from the leader; followers
        wait for the leader's next key without a deadline (the leader may
        be idle between jobs)."""
        if self.size == 1:
            return obj
        key, seq = self._next_key()
        if self.is_leader:
            self._store.set(key, json.dumps(obj))
            if seq >= self.BCAST_GC_LAG:
                self._store.delete_key(
                    f"kubeml/bcast/{seq - self.BCAST_GC_LAG}")
            return obj
        self._wait(key, None)
        return json.loads(self._store.get(key))

    def broadcast_flags(self, stop: bool = False,
                        parallelism: int = 0) -> Tuple[bool, int]:
        """Per-round/per-epoch control decisions; rank 0's values win."""
        out = self.broadcast_obj({"s": int(stop), "p": int(parallelism)})
        return bool(out["s"]), int(out["p"])

    def put(self, key: str, value: str) -> None:
        self._store.set(key, value)

    def get(self, key: str, timeout_s: float = 120.0) -> Optional[str]:
        """Blocking read with a real deadline; None on timeout."""
        if not self._wait(key, timeout_s):
            return None
        return self._store.get(key).decode()

    def barrier(self, tag: str, timeout_s: float = 600.0) -> None:
        """Returns once every process has announced ``tag``. Keys carry a
        per-call sequence number, so a reused tag cannot satisfy a later
        barrier with a stale announcement. Raises on timeout."""
        if self.size == 1:
            return
        with self._lock:
            self._barrier_seq += 1
            seq = self._barrier_seq
        self.put(f"kubeml/barrier/{seq}/{tag}/{self.rank}", "1")
        for r in range(self.size):
            if self.get(f"kubeml/barrier/{seq}/{tag}/{r}", timeout_s) is None:
                raise TimeoutError(
                    f"barrier {tag!r}: rank {r} missing after {timeout_s}s")


_dist_context: Optional[DistContext] = None


def get_dist_context() -> DistContext:
    """The process-wide :class:`DistContext`."""
    global _dist_context
    if _dist_context is None:
        _dist_context = DistContext()
    return _dist_context


def _rank_main(rank: int, fn: Callable, world: int, coordinator: str,
               args: tuple) -> None:
    os.environ.update(KUBEML_COORDINATOR=coordinator,
                      KUBEML_NUM_PROCESSES=str(world),
                      KUBEML_PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    try:
        fn(rank, *args)
    finally:
        shutdown()
    # the rank's work is done (its results written by fn): end the process
    # here. The interpreter's exit ends the daemon threads still alive (a
    # job's stall watchdog, a server's, a cluster's loops) by pthread_exit
    # when they next take the GIL, and one doing so inside a torch binding
    # unwinds through C++ frames that cannot be unwound: "terminate called
    # without an active exception", and the rank dies of SIGABRT after its
    # work (CPython 3.12; the stack ends in PyEval_RestoreThread from
    # libtorch_python under pthread_exit).
    logging.shutdown()
    for stream in (sys.stdout, sys.stderr):
        stream.flush()
    os._exit(0)


def spawn(fn: Callable, world: int, args: tuple = (),
          timeout_s: float = 120.0) -> None:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes on this host,
    each with ``KUBEML_COORDINATOR`` (a ``FileStore`` in a new temporary
    directory, so no port is fixed), ``KUBEML_NUM_PROCESSES`` and
    ``KUBEML_PROCESS_ID`` set and one torch thread; ``fn`` calls
    :func:`init_distributed`.
    ``fn`` must be importable (a module-level function); a rank whose
    ``fn`` returns leaves the process group and exits at once, without the
    interpreter's finalization (see ``_rank_main``). Raises if a rank
    fails, and stops every rank and raises ``TimeoutError`` when they have
    not all finished after ``timeout_s``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="kubeml_spawn_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, f"file://{tmp}/store", args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks did not finish within "
                                       f"{timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(5)
