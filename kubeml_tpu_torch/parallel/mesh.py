"""Device meshes with named parallelism axes, the port of
``kubeml_tpu/parallel/mesh.py``.

``AXIS_ORDER``, :func:`parse_mesh_spec` and :func:`mesh_shape_for` are the
JAX functions unchanged. :func:`make_mesh` builds a :class:`Mesh`:

* over one device (``make_mesh(devices=[dev])``, what ``bench_moe``,
  ``SPMDTrainer`` and ``engine.spmd_job.SPMDJob`` build), or
* over the ranks of the process group (``parallel.distributed.
  init_distributed``): one process per device, the world equal to the
  product of the axes. Rank ``r`` takes the coordinate
  ``np.unravel_index(r, dims)`` in ``AXIS_ORDER``, exactly where JAX's
  ``np.array(devices).reshape(dims)`` puts device ``r``.
  ``Mesh.coord[axis]`` is this rank's coordinate and ``Mesh.group(axis)``
  the process group of the ranks that differ from it only along
  ``axis``;

* or over the first ``k`` ranks of a larger world (``make_mesh(shape,
  ranks=range(k))``, the SPMD job's elastic remesh): every rank of the
  world calls it, and a rank outside the mesh gets a :class:`Mesh` whose
  ``member`` is False. It holds no coordinate, takes part in no step and
  in no group of the mesh.

``dist.new_group`` is collective over the whole world: every rank creates
every group, in the same order, or the ranks deadlock. :func:`make_mesh`
creates the group of each axis of size above 1 and the ``dp`` x ``sp``
group over which the trainer sums (all ranks of the world call it
together, members or not); any other group over several axes is made at
its first use, which every rank of the world must reach at the same point
of its program. Groups come from ``distributed.subgroup``, cached by their
rank sets, so a mesh built again over the same ranks reuses its groups.

A ``pp`` axis (the pipeline) and an ``ep`` axis (MoE expert sharding)
above 1 are later items of the port (ROADMAP Queue 1 item 1) and raise.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

# Canonical axis order: outermost first. dp outermost, then pp stages, ep,
# sp, tp innermost (tp wants the fastest links: its collectives are in
# every matmul).
AXIS_ORDER = ("dp", "pp", "ep", "sp", "tp")

# the ROADMAP items of the axes the port does not shard yet
_LATER_AXES = {
    "pp": "the pipeline (parallel/pipeline.py, models/gpt_pipeline.py)",
    "ep": "MoE expert sharding over ep",
}


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """Parse an ``ax=n[,ax=n...]`` mesh spec (the CLI ``--mesh`` and
    ``KUBEML_SERVING_MESH`` dialect) into an axis-shape dict. Empty/blank
    input is {} (no mesh). Raises ValueError with the expected syntax on
    malformed input."""
    spec = (spec or "").strip()
    if not spec:
        return {}
    try:
        return {ax.strip(): int(size)
                for ax, size in (kv.split("=") for kv in spec.split(","))}
    except ValueError:
        raise ValueError(f"mesh spec expects e.g. tp=2,sp=2 — got {spec!r}")


def mesh_shape_for(n_devices: int, **requested: int) -> Dict[str, int]:
    """Fill in a full axis-shape dict for ``n_devices``: requested axes keep
    their sizes, remaining devices go to ``dp``."""
    shape = {ax: 1 for ax in AXIS_ORDER}
    used = 1
    for ax, size in requested.items():
        if ax not in shape:
            raise ValueError(f"unknown mesh axis {ax!r} (valid: {AXIS_ORDER})")
        if size < 1:
            raise ValueError(f"mesh axis {ax!r} must be >= 1")
        shape[ax] = size
        used *= size
    if n_devices % used != 0:
        raise ValueError(
            f"requested axes use {used} devices which does not divide {n_devices}"
        )
    shape["dp"] *= n_devices // used
    return shape


class Mesh:
    """A named grid of ranks: ``shape`` maps axis names (in
    ``axis_names`` order) to sizes, ``grid`` holds the rank at each
    coordinate (default: rank ``r`` at ``np.unravel_index(r, dims)``),
    ``rank`` is this process's rank and ``devices`` its device (one
    entry; a rank sees no other rank's device). A mesh of several ranks
    is usable once :func:`make_mesh` has given it its process groups.
    ``member`` is False on a rank the grid does not hold (``coord`` is
    then empty)."""

    def __init__(self, shape: Dict[str, int], devices: Sequence,
                 grid: Optional[np.ndarray] = None, rank: int = 0):
        self.shape = {ax: int(n) for ax, n in shape.items()}
        self.axis_names = tuple(self.shape)
        self.devices = list(devices)
        dims = tuple(self.shape.values())
        self.grid = (np.arange(math.prod(dims)).reshape(dims) if grid is None
                     else np.asarray(grid).reshape(dims))
        self.rank = int(rank)
        at = np.argwhere(self.grid == self.rank)
        if len(at) > 1:
            raise ValueError(f"rank {rank} appears {len(at)} times in the "
                             f"mesh grid")
        self.member = len(at) == 1
        self.coord = ({ax: int(c) for ax, c in zip(self.axis_names, at[0])}
                      if self.member else {})
        self._groups: Optional[Dict[Tuple[str, ...], object]] = None

    @property
    def ranks(self) -> list:
        """The ranks the mesh spans, ascending."""
        return sorted(int(r) for r in self.grid.reshape(-1))

    @property
    def size(self) -> int:
        """The number of ranks (devices) the mesh spans."""
        return int(self.grid.size)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def distributed(self) -> bool:
        return self.size > 1

    def group(self, *axes: str):
        """The process group of the ranks that differ from this one only
        along ``axes``, ordered by their coordinates along them; None when
        the axes span one rank. A group not made by :func:`make_mesh` is
        created here, collectively (see the module docstring)."""
        axes = tuple(ax for ax in AXIS_ORDER if ax in axes
                     and self.shape.get(ax, 1) > 1)
        if not axes:
            return None
        self._check_groups()
        if axes not in self._groups:
            self._groups[axes] = self._new_groups(axes)
        return self._groups[axes]

    def _check_groups(self) -> None:
        if self._groups is None:
            raise RuntimeError(f"mesh {self.shape} has no process groups: "
                               f"build a mesh of several ranks with "
                               f"make_mesh after init_distributed")

    def _new_groups(self, axes: Tuple[str, ...]):
        """Create every group along ``axes`` (each rank the same calls, in
        the same order) and return this rank's (None off the mesh)."""
        from .distributed import subgroup

        inner = [self.axis_names.index(ax) for ax in axes]
        outer = [i for i in range(len(self.axis_names)) if i not in inner]
        lines = np.transpose(self.grid, outer + inner).reshape(
            -1, math.prod(self.grid.shape[i] for i in inner))
        mine = None
        for line in lines:
            ranks = [int(r) for r in line]
            # new_group orders a group by rank: a line must ascend so that
            # its group rank is the coordinate along the axes
            if ranks != sorted(ranks):
                raise ValueError(f"mesh grid line {ranks} along {axes} does "
                                 f"not ascend")
            g = subgroup(ranks)
            if self.rank in ranks:
                mine = g
        return mine


def _later_axes(shape) -> None:
    for ax, item in _LATER_AXES.items():
        if int(shape.get(ax, 1)) > 1:
            raise NotImplementedError(
                f"mesh {shape}: a {ax} axis above 1 is {item}, a later item "
                f"of the port (ROADMAP Queue 1 item 1)")


def make_mesh(shape: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None,
              grid: Optional[np.ndarray] = None,
              ranks: Optional[Sequence[int]] = None, **axes: int) -> Mesh:
    """Build a :class:`Mesh` from an axis-shape dict (or kwargs).

    Over one device: ``devices`` (default: this rank's device, or the
    current CUDA device). Over several ranks: the process group's world
    must equal the product of the axes; ``devices``, if given, lists every
    rank's device by rank. ``grid`` places ranks elsewhere than the
    default row-major order (``distributed.global_mesh``). ``ranks``
    builds the mesh over those ranks of the world only (ascending, as many
    as the axes' product; rank ``ranks[i]`` at ``np.unravel_index(i,
    dims)``): every rank of the world calls it, and the others get a mesh
    whose ``member`` is False. Axes of size 1 stay in the mesh so code can
    always name them."""
    from . import distributed

    world = distributed.process_count()
    if shape is None:
        n = (len(ranks) if ranks is not None
             else world if devices is None else len(devices))
        shape = mesh_shape_for(n, **axes)
    names = tuple(ax for ax in AXIS_ORDER if ax in shape)
    names += tuple(ax for ax in shape if ax not in AXIS_ORDER)
    shape = {ax: int(shape[ax]) for ax in names}
    total = math.prod(shape.values())
    rank = distributed.process_index()
    if ranks is not None:
        ranks = [int(r) for r in ranks]
        if len(ranks) != total or ranks != sorted(set(ranks)) or not all(
                0 <= r < world for r in ranks):
            raise ValueError(f"mesh shape {shape} needs {total} ascending "
                             f"ranks of the {world}, got {ranks}")
        grid = np.array(ranks).reshape(tuple(shape.values()))
    if total == 1:
        if ranks is None:
            dev = distributed.local_device() if devices is None else devices[0]
            return Mesh(shape, [resolve_device(dev)])
        dev = distributed.local_device() if devices is None else devices[rank]
        return Mesh(shape, [resolve_device(dev)], grid=grid, rank=rank)
    _later_axes(shape)
    if world == 1:
        raise RuntimeError(
            f"mesh {shape} spans {total} ranks but this process is alone: "
            f"start one process per device and call "
            f"parallel.distributed.init_distributed() first")
    if total != world and ranks is None:
        raise ValueError(f"mesh shape {shape} uses {total} ranks but the "
                         f"process group holds {world}")
    if devices is not None and len(devices) != world:
        raise ValueError(f"{len(devices)} devices given for {world} ranks")
    dev = distributed.local_device() if devices is None else devices[rank]
    mesh = Mesh(shape, [resolve_device(dev)], grid=grid, rank=rank)
    mesh._groups = {}
    for ax in names:
        mesh.group(ax)
    mesh.group("dp", "sp")  # the trainer's replica group, on every rank
    return mesh


def check_mesh(mesh) -> Optional[torch.device]:
    """This rank's device on ``mesh`` (None for no mesh); raises for an
    object that is no :class:`Mesh`, a mesh of several ranks without its
    process groups, or an axis the port does not shard yet."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(f"{type(mesh).__name__} is no kubeml_tpu_torch "
                        f"mesh: build one with parallel.mesh.make_mesh")
    if mesh.distributed:
        _later_axes(mesh.shape)
        mesh._check_groups()
    return mesh.device


def local_block(mesh: Optional[Mesh], x: torch.Tensor,
                axes: Tuple[str, ...] = ("dp", "sp")) -> torch.Tensor:
    """This rank's block of a global array sharded as ``P(*axes)``: dim
    ``i`` cut into ``mesh.shape[axes[i]]`` equal parts, part
    ``mesh.coord[axes[i]]`` kept (the whole array without a mesh)."""
    if mesh is None:
        return x
    for dim, ax in enumerate(axes):
        n = mesh.shape.get(ax, 1)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                             f"over {ax}={n}")
        part = x.shape[dim] // n
        x = x.narrow(dim, mesh.coord[ax] * part, part)
    return x
