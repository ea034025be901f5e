"""Sharded checkpoints, the port of
``kubeml_tpu/storage/sharded_checkpoint.py``, in its on-disk format.

Layout::

    <root>/<job_id>/<tag>.shards/manifest.json
    <root>/<job_id>/<tag>.shards/shard-<p>.npz

Each ``shard-<p>.npz`` holds the leaf slices process ``p`` owned, keyed
``<leaf path>@<start,...>`` (:func:`_slice_key`); ``manifest.json`` holds
``job_id``, ``tag``, ``epoch``, ``saved_at``, ``processes``, the caller's
``meta`` and, per leaf path, its global ``shape``, ``dtype`` and slice
table (``start``, ``shape``, ``shard``). The manifest is published last:
its presence marks the checkpoint complete, so an interrupted save is
invisible. bfloat16 leaves are stored as their 16-bit patterns (uint16)
under the dtype string ``"bfloat16"``, as in the flat store.

:meth:`ShardedCheckpointStore.save` over the ranks of a ``mesh`` (JAX
:90-183) is collective: each rank passes its own shards (the Flax tree of
a module built with the mesh) and writes ``shard-<rank>.npz`` with the
slices it owns, possibly none. A leaf's slices are the distinct
``interop.from_flax.leaf_block`` of the mesh's ranks (a ``tp`` part, a
pipelined model's stage along ``pp``, a MoE expert stack's ``ep`` part); a slice several ranks hold
(``dp`` and ``sp`` replicas, every leaf under ``sp``, the embeddings and
head on every ``pp`` rank) is owned by the lowest of them, JAX's
``replica_id == 0``, so each is written once. Three ``barrier`` calls order the save (``ckpt-staged/``,
``ckpt-clear/``, ``ckpt/``), and rank 0 publishes the manifest with
``"processes"`` the world. Without a mesh one process writes
``shard-0.npz`` with every leaf whole (one slice at the origin).

:meth:`~ShardedCheckpointStore.restore` onto a ``mesh`` reads, on each
rank, only the stored slices that overlap that rank's block of each leaf
(npz members are read lazily, one member a slice), whatever mesh wrote
them, and returns the rank's blocks (on a serving mesh a leaf's block
follows the fit rule, and a ``final-int8``'s storage markers are cut as
their kernel: ``interop.from_flax.leaf_spec``); without a mesh it assembles every
leaf whole on the host, as the serving path needs. So a checkpoint the
JAX package wrote from any mesh (many slices a leaf, one or many shard
files) restores here onto any mesh, and one written here restores in JAX
onto any mesh. Leaves come back as numpy arrays, bfloat16 ones as CPU
``torch.bfloat16`` tensors; the caller moves them to its device.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api.config import Config, get_config
from ..api.errors import CheckpointNotFoundError, StorageError
from .checkpoint import _BF16, _flatten, _host_leaf, _unflatten

MANIFEST = "manifest.json"
SHARD_DIR_SUFFIX = ".shards"


def _slice_key(path: str, start: Tuple[int, ...]) -> str:
    return f"{path}@{','.join(map(str, start))}"


def _dotted(path: str) -> str:
    """A stored leaf path's parameter name in the partition table
    (``params/block_0/attn/query/kernel`` -> ``block_0.attn.query.kernel``)."""
    parts = path.split("/")
    return ".".join(parts[1:] if parts[0] == "params" else parts)


def _mesh_coords(mesh) -> Dict[int, Dict[str, int]]:
    """{rank: its coordinates} over the ranks of ``mesh``, ascending."""
    coords = {int(r): dict(zip(mesh.axis_names, map(int, at)))
              for at, r in np.ndenumerate(mesh.grid)}
    return dict(sorted(coords.items()))


@dataclass
class ShardedCheckpoint:
    """A restored sharded checkpoint (host leaves); ``bytes_read`` counts
    the stored slice bytes the restore read."""

    job_id: str
    tag: str
    variables: Dict[str, Any]
    epoch: int = 0
    meta: Dict[str, Any] = field(default_factory=dict)
    bytes_read: int = 0


class ShardedCheckpointStore:
    """Filesystem store of sharded checkpoints (see the module docstring
    for the layout)."""

    def __init__(self, root: Optional[Path] = None,
                 config: Optional[Config] = None):
        cfg = config or get_config()
        self.root = Path(root) if root is not None else cfg.checkpoints_dir
        self.root.mkdir(parents=True, exist_ok=True)
        # this rank's last save: {"bytes": its slices' bytes, "seconds":
        # the save's wall, barriers included}
        self.last_save: Optional[Dict[str, float]] = None

    def _dir(self, job_id: str, tag: str) -> Path:
        if not job_id or "/" in job_id or job_id.startswith("."):
            raise StorageError(f"invalid job id {job_id!r}")
        if not tag or "/" in tag or tag.startswith("."):
            raise StorageError(f"invalid checkpoint tag {tag!r}")
        return self.root / job_id / f"{tag}{SHARD_DIR_SUFFIX}"

    # --- write ---

    def save(self, job_id: str, variables: Dict[str, Any], *,
             epoch: int = 0, tag: str,
             meta: Optional[Dict[str, Any]] = None, mesh=None,
             barrier: Optional[Callable[[str], None]] = None) -> Path:
        """Write a nested-dict tree (numpy or torch leaves): without a
        ``mesh``, every leaf whole as process 0's shard; over a mesh of
        ranks, this rank's shards, of which it writes the slices it owns
        (collective: every rank of the world calls it, ``barrier`` a
        world barrier such as ``DistContext.barrier``). Rank 0 publishes
        the manifest after the last barrier.

        A resave over an existing tag never tears the previous checkpoint
        (JAX :146-183): each rank stages its shard under a temporary name
        (a failure there leaves the old checkpoint restorable), rank 0
        unpublishes the old manifest, every rank renames its staged shard
        into place, and rank 0 publishes the new manifest. A crash in
        between reads as "no checkpoint", never as a mix of old and new
        slices."""
        from ..interop.from_flax import global_shape, leaf_block
        from ..parallel import distributed

        t0 = time.perf_counter()
        rank = distributed.process_index() if mesh is not None else 0
        coords = _mesh_coords(mesh) if mesh is not None else {0: {}}
        d = self._dir(job_id, tag)
        d.mkdir(parents=True, exist_ok=True)
        blobs: Dict[str, np.ndarray] = {}
        leaves: Dict[str, Dict[str, Any]] = {}
        for path, leaf in _flatten(variables):
            arr, dt = _host_leaf(leaf)
            name = _dotted(path)
            shape = global_shape(name, arr.shape, mesh)
            slices: Dict[Tuple[int, ...], Dict[str, Any]] = {}
            for r, coord in coords.items():  # ascending: the lowest owns
                start, size = leaf_block(name, shape, mesh, coord=coord)
                slices.setdefault(start, {"start": list(start),
                                          "shape": list(size), "shard": r})
            leaves[path] = {"shape": list(shape), "dtype": dt,
                            "slices": list(slices.values())}
            if mesh is None or mesh.member:
                mine, _ = leaf_block(name, shape, mesh)
                if slices[mine]["shard"] == rank:
                    blobs[_slice_key(path, mine)] = arr
        tmp = d / f".shard-{rank}.{uuid.uuid4().hex}.npz"
        try:
            np.savez(tmp, **blobs)
            if barrier is not None:  # every rank has staged its bytes
                barrier(f"ckpt-staged/{job_id}/{tag}")
            if rank == 0:
                (d / MANIFEST).unlink(missing_ok=True)
            if barrier is not None:  # no shard lands under a live manifest
                barrier(f"ckpt-clear/{job_id}/{tag}")
            os.replace(tmp, d / f"shard-{rank}.npz")
        except Exception:
            tmp.unlink(missing_ok=True)
            raise
        # this rank's checkpoint bytes and write bandwidth (the barrier
        # waits are part of a save's cost), as a span when tracing is on
        from ..utils import profiler

        profiler.record_io("ckpt.save", sum(b.nbytes for b in blobs.values()),
                           time.perf_counter() - t0, job=job_id, tag=tag)
        if barrier is not None:
            barrier(f"ckpt/{job_id}/{tag}")
        if rank == 0:
            manifest = {"job_id": job_id, "tag": tag, "epoch": int(epoch),
                        "saved_at": time.time(),
                        "processes": (1 if mesh is None
                                      else distributed.process_count()),
                        "meta": meta or {}, "leaves": leaves}
            tmpm = d / f".manifest.{uuid.uuid4().hex}"
            tmpm.write_text(json.dumps(manifest))
            os.replace(tmpm, d / MANIFEST)
        self.last_save = {"bytes": sum(b.nbytes for b in blobs.values()),
                          "seconds": time.perf_counter() - t0}
        return d

    # --- read ---

    def exists(self, job_id: str, tag: str) -> bool:
        return (self._dir(job_id, tag) / MANIFEST).exists()

    def manifest_path(self, job_id: str, tag: str) -> Path:
        """The manifest file: the checkpoint's completion marker, whose
        mtime is the serving cache's freshness key."""
        return self._dir(job_id, tag) / MANIFEST

    def tags(self, job_id: str) -> List[str]:
        jd = self.root / job_id
        if not jd.exists():
            return []
        return sorted(p.name[: -len(SHARD_DIR_SUFFIX)]
                      for p in jd.glob(f"*{SHARD_DIR_SUFFIX}")
                      if (p / MANIFEST).exists())

    def list_jobs(self) -> List[str]:
        if not self.root.exists():
            return []
        return sorted(
            d.name for d in self.root.iterdir()
            if d.is_dir() and any(d.glob(f"*{SHARD_DIR_SUFFIX}/{MANIFEST}")))

    def read_manifest(self, job_id: str, tag: str) -> Dict[str, Any]:
        p = self._dir(job_id, tag) / MANIFEST
        if not p.exists():
            raise CheckpointNotFoundError(f"{job_id}/{tag} (sharded)")
        return json.loads(p.read_text())

    def restore(self, job_id: str, tag: str,
                remap: Optional[Callable] = None,
                mesh=None) -> ShardedCheckpoint:
        """Assemble the tree on the host: every leaf whole, or with a
        ``mesh`` this rank's block of each leaf (its
        ``interop.from_flax.leaf_block``), read from the stored slices that
        overlap it only (JAX's restore with ``shardings``); the tree then
        loads into a module built with the mesh.

        ``remap`` re-lays the tree out as it is read (JAX :235): a callable
        ``stored_path -> None | [(target_path, index_prefix)]``; None keeps
        the leaf, a list fans it out into target leaves, each the stored
        leaf indexed by ``index_prefix`` on its leading axes.

        Every shard file is opened before the leaves are read and the
        manifest is checked unchanged afterwards: open handles keep the
        files' original contents, and a resave unpublishes the manifest
        before it renames anything, so an unchanged manifest proves the
        handles belong to it. A resave that got in between raises
        ``StorageError``."""
        if mesh is not None and (remap is not None or not mesh.member):
            raise ValueError("a restore onto a mesh takes no remap and "
                             "needs a rank of the mesh")
        t_restore = time.perf_counter()
        d = self._dir(job_id, tag)
        mpath = d / MANIFEST
        try:
            before = mpath.stat()
            manifest = json.loads(mpath.read_text())
        except FileNotFoundError:
            raise CheckpointNotFoundError(f"{job_id}/{tag} (sharded)")
        readers = _ShardReaders(d)
        specs = manifest["leaves"]
        try:
            for sid in sorted({sl["shard"] for spec in specs.values()
                               for sl in spec["slices"]}):
                readers.get(sid)
            try:
                after = mpath.stat()
            except OSError:
                after = None
            if (after is None or after.st_ino != before.st_ino
                    or after.st_mtime_ns != before.st_mtime_ns):
                raise StorageError(
                    f"checkpoint {job_id}/{tag} was replaced while a restore "
                    f"was starting; retry the restore")
            plan: Dict[str, Tuple[str, Tuple[int, ...]]] = {}
            for p in specs:
                fan = remap(p) if remap is not None else None
                if fan is None:
                    plan[p] = (p, ())
                else:
                    for tgt, pre in fan:
                        plan[tgt] = (p, tuple(int(i) for i in pre))
            pairs = {}
            for tgt, (src, pre) in plan.items():
                spec = specs[src]
                index = None
                if mesh is not None:
                    from ..interop.from_flax import leaf_block

                    start, size = leaf_block(_dotted(src), spec["shape"],
                                             mesh)
                    index = tuple(slice(a, a + n)
                                  for a, n in zip(start, size))
                if pre:
                    index = (tuple(slice(i, i + 1) for i in pre)
                             + tuple(slice(0, s)
                                     for s in spec["shape"][len(pre):]))
                arr = _assemble(readers, src, spec, index)
                if pre:
                    arr = arr.reshape(tuple(spec["shape"][len(pre):]))
                pairs[tgt] = _from_stored(arr, spec["dtype"])
        finally:
            readers.close()
        from ..utils import profiler

        profiler.record_io(
            "ckpt.restore", sum(getattr(a, "nbytes", 0)
                                for a in pairs.values()),
            time.perf_counter() - t_restore, job=job_id, tag=tag)
        return ShardedCheckpoint(
            job_id=manifest.get("job_id", job_id),
            tag=manifest.get("tag", tag),
            variables=_unflatten(pairs),
            epoch=int(manifest.get("epoch", 0)),
            meta=manifest.get("meta", {}), bytes_read=readers.bytes_read)

    def delete(self, job_id: str, tag: str) -> None:
        d = self._dir(job_id, tag)
        if not d.exists():
            raise CheckpointNotFoundError(f"{job_id}/{tag} (sharded)")
        shutil.rmtree(d)


def apply_remap_host(variables: Dict[str, Any], remap) -> Dict[str, Any]:
    """Apply a restore-time remap plan (:meth:`ShardedCheckpointStore.
    restore`'s ``remap``) to an in-memory host tree: the flat-checkpoint
    counterpart (JAX :347)."""
    out: Dict[str, Any] = {}
    for path, leaf in _flatten_any(variables):
        fan = remap(path)
        if fan is None:
            out[path] = leaf
            continue
        for tgt, pre in fan:
            sub = leaf
            for i in pre:
                sub = sub[int(i)]
            out[tgt] = sub
    return _unflatten(out)


# --- internals ---


def _flatten_any(tree: Any) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []

    def rec(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], f"{prefix}{k}/")
            return
        out.append((prefix[:-1], node))

    rec(tree, "")
    return out


def _container_dtype(dt: str) -> np.dtype:
    """The numpy dtype a stored slice of dtype string ``dt`` reads as."""
    return np.dtype(np.uint16) if dt == _BF16 else np.dtype(dt)


def _from_stored(arr: np.ndarray, dt: str):
    """A host leaf from its stored array: bfloat16 bit patterns become a
    CPU ``torch.bfloat16`` tensor."""
    if dt == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return arr


class _ShardReaders:
    """Lazy npz handles over the shard files of one checkpoint."""

    def __init__(self, d: Path):
        self.dir = d
        self._handles: Dict[int, Any] = {}
        self.bytes_read = 0

    def read(self, shard: int, key: str) -> np.ndarray:
        """One stored slice (the npz member is read whole, on request)."""
        arr = self.get(shard)[key]
        self.bytes_read += arr.nbytes
        return arr

    def get(self, shard: int):
        h = self._handles.get(shard)
        if h is None:
            p = self.dir / f"shard-{shard}.npz"
            if not p.exists():
                raise StorageError(f"missing shard file {p}")
            h = np.load(p)
            self._handles[shard] = h
        return h

    def close(self):
        for h in self._handles.values():
            h.close()


def _assemble(readers: _ShardReaders, path: str, spec: Dict[str, Any],
              index) -> np.ndarray:
    """``leaf[index]`` (the whole leaf when ``index`` is None), in its
    stored container dtype, from whichever stored slices overlap it
    (JAX :495)."""
    shape = tuple(spec["shape"])
    if index is None:
        index = tuple(slice(0, s) for s in shape)
    req_start = tuple(0 if s.start is None else int(s.start) for s in index)
    req_stop = tuple(dim if s.stop is None else int(s.stop)
                     for s, dim in zip(index, shape))
    out_shape = tuple(b - a for a, b in zip(req_start, req_stop))
    out = np.empty(out_shape, dtype=_container_dtype(spec["dtype"]))
    filled = 0
    for sl in spec["slices"]:
        s_start = tuple(sl["start"])
        s_stop = tuple(a + n for a, n in zip(s_start, sl["shape"]))
        lo = tuple(max(a, b) for a, b in zip(req_start, s_start))
        hi = tuple(min(a, b) for a, b in zip(req_stop, s_stop))
        if any(l >= h for l, h in zip(lo, hi)):
            continue  # no overlap
        data = readers.read(sl["shard"], _slice_key(path, s_start))
        src = tuple(slice(l - a, h - a) for l, h, a in zip(lo, hi, s_start))
        dst = tuple(slice(l - a, h - a) for l, h, a in zip(lo, hi, req_start))
        out[dst] = data[src]
        filled += int(np.prod([h - l for l, h in zip(lo, hi)]))
    if filled < int(np.prod(out_shape)):
        raise StorageError(f"stored slices do not cover leaf {path!r} range "
                           f"{req_start}..{req_stop}")
    return out
