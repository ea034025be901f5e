"""Device meshes with named parallelism axes, the port of
``kubeml_tpu/parallel/mesh.py``.

``AXIS_ORDER``, :func:`parse_mesh_spec` and :func:`mesh_shape_for` are the
JAX functions unchanged. :func:`make_mesh` builds a :class:`Mesh` over
``torch.device``\\ s: its ``shape`` is the JAX axis dict and ``devices``
the device grid, flattened in axis order. The port trains and serves on
one card, so a mesh whose axes multiply past 1 raises: sharding over
``torch.distributed`` (the mesh over several cards, ring and Ulysses
attention, the pipeline) is the next slice of the port (ROADMAP Queue
1). A one-device mesh is what ``bench_moe``, ``SPMDTrainer`` and
``engine.spmd_job.SPMDJob`` build (``make_mesh(devices=[dev])``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from ..utils.device import resolve_device

# Canonical axis order: outermost first. dp outermost, then pp stages, ep,
# sp, tp innermost (tp wants the fastest links: its collectives are in
# every matmul).
AXIS_ORDER = ("dp", "pp", "ep", "sp", "tp")


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
    """A named device grid: ``shape`` maps axis names (in ``axis_names``
    order) to sizes, ``devices`` lists the grid's devices row-major."""

    def __init__(self, shape: Dict[str, int], devices: List[torch.device]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.devices = list(devices)


def _multi_card(shape) -> NotImplementedError:
    return NotImplementedError(
        f"mesh {shape} spans several devices: sharding over "
        f"torch.distributed is the next slice of the port (ROADMAP Queue 1, "
        f"multi-card SPMD); pass one device")


def make_mesh(shape: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None, **axes: int) -> Mesh:
    """Build a :class:`Mesh` from an axis-shape dict (or kwargs) over
    ``devices`` (default: the current CUDA device). Axes of size 1 stay in
    the mesh so code can always name them. An explicit shape must account
    for every device given; a shape of more than one device raises (see
    the module docstring)."""
    devices = ([resolve_device(None)] if devices is None
               else [resolve_device(d) for d in devices])
    if shape is None:
        shape = mesh_shape_for(len(devices), **axes)
    total = math.prod(int(v) for v in shape.values())
    if total != len(devices):
        raise ValueError(
            f"mesh shape {shape} uses {total} devices but {len(devices)} were "
            f"given; slice the device list explicitly to use a subset")
    if total > 1:
        raise _multi_card(shape)
    names = tuple(ax for ax in AXIS_ORDER if ax in shape)
    names += tuple(ax for ax in shape if ax not in AXIS_ORDER)
    return Mesh({ax: int(shape[ax]) for ax in names}, devices)


def check_mesh(mesh) -> Optional[torch.device]:
    """The device of a one-device ``mesh`` (None for no mesh); raises for a
    mesh of several devices or an object that is no mesh."""
    if mesh is None:
        return None
    shape = getattr(mesh, "shape", None)
    if not (isinstance(shape, dict)
            and all(int(n) == 1 for n in shape.values())):
        raise _multi_card(shape if shape is not None else mesh)
    return mesh.devices[0]
