"""Parallel training of the port: ``SPMDTrainer`` with its LM losses, on
one card or over the ranks of a mesh; ``distributed`` (the process group,
one process per device), ``mesh`` (named axes over one device or over the
ranks), ``collectives`` (differentiable collectives over a mesh axis),
``ring`` and ``ulysses`` (sequence-parallel attention), ``pipeline`` (the
GPipe schedule over ``pp`` ranks, ``PipelinedLM`` and
``PipelineTrainer``) and ``moe`` (the MoE blocks, on one card)."""

from .distributed import (DistContext, get_dist_context, global_mesh,
                          init_distributed, local_batch_slice,
                          local_worker_rows, num_slices, pick_worker_devices,
                          worker_device_count)
from .mesh import Mesh, make_mesh, mesh_shape_for
from .pipeline import PipelinedLM, PipelineTrainer, gpipe
from .ring import ring_attention
from .trainer import SPMDTrainer, adamw, chunked_lm_loss, lm_loss
from .ulysses import ulysses_attention

__all__ = [
    "DistContext", "Mesh", "PipelineTrainer", "PipelinedLM", "SPMDTrainer",
    "adamw", "chunked_lm_loss", "get_dist_context", "global_mesh", "gpipe",
    "init_distributed",
    "local_batch_slice", "local_worker_rows", "lm_loss", "make_mesh",
    "mesh_shape_for", "num_slices", "pick_worker_devices", "ring_attention",
    "ulysses_attention", "worker_device_count",
]
