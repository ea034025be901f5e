"""Flax variables <-> the port's weights.

:func:`from_flax` carries a Flax ``CausalTransformer``'s parameters;
:func:`from_flax_variables` a K-AVG model's whole variables tree (ResNet,
LeNet, VGG, ViT, BERT: ``params`` and ``batch_stats``). :func:`to_flax` and
:func:`to_flax_variables` are their inverses: the port writes checkpoints
in the Flax layout through them, so a checkpoint file never says which
package wrote it. :func:`shard_tree` (and :func:`shard_module`, on a
module built whole) cuts a full flat tree into one rank's shards by the
port's partition table (``models.gpt.partition_spec``, JAX's ``_part``
specs: tensor-parallel columns or rows over ``tp``, a pipelined model's
stage stack over ``pp``, a MoE layer's expert stacks over ``ep`` and
``tp``); :func:`gather_tree` gathers a rank's shards
back into whole leaves (collectively, on every rank), for the tests and
for a save; :func:`leaf_block` is the global slice (start, shape) of a
leaf that a rank's shard covers, from the same table, which the sharded
checkpoints write and read by. On a serving mesh (``parallel.mesh.
serving_mesh``) the table's axes go through the fit rule
(``parallel.mesh.fit_spec``): a dim that does not divide over its axis
stays whole. An int8 leaf (a :class:`QuantizedTensor`, or the
``__q8_q__``/``__q8_s__`` storage markers of a ``final-int8``
checkpoint) is cut as its dense kernel: ``q`` by the kernel's spec, the
per-channel scales ``s`` along their channel (last) axis only.

The port's modules carry Flax's parameter names and layouts (dense kernels
``[in, out]``, LayerNorm ``scale``/``bias``, ``token_embed.embedding``,
``pos_embed [1, max_len, E]``), so converting a tree is a flatten: nested
names join with ``.``. The Flax tree names are

    token_embed/embedding, pos_embed,
    block_{i}/{ln1,ln2}/{scale,bias},
    block_{i}/attn/{query,key,value,proj}/{kernel,bias?},
    block_{i}/{mlp_in,mlp_out}/{kernel,bias},
    block_{i}/moe/{router [D, E], w_in [E, D, H], w_out [E, H, D]},
    ln_f/{scale,bias}, lm_head/kernel

and become ``block_0.attn.query.kernel`` and so on (an MoE block has
``moe`` in place of ``mlp_in``/``mlp_out``; its leaves are raw params in
Flax's layout, carried unpermuted by every converter here, their 3-D
shape never taken for a conv kernel's). Leaves must be numpy
arrays (callers unbox ``nn.Partitioned`` leaves and ``np.asarray`` them on
the JAX side). An int8 pair - any node with fields ``q`` and ``s``, such as
``kubeml_tpu.serving.quant.QuantizedTensor`` - becomes the port's
:class:`~kubeml_tpu_torch.serving.quant.QuantizedTensor`.

The inverses split dotted names back into nested dicts, turn conv kernels
from OIHW back to HWIO, and return numpy leaves (bfloat16 tensors stay
CPU tensors: numpy cannot hold them).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Set, Tuple

import numpy as np
import torch
from torch import nn

from ..serving.quant import QuantizedTensor


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):  # a restored bfloat16 leaf
        return x.detach().clone()
    return torch.from_numpy(np.array(x, copy=True))


def from_flax(variables: Mapping[str, Any]) -> Dict[str, object]:
    """Flatten a Flax variables tree (with or without the top-level
    ``params`` collection) into ``{dotted name: tensor | QuantizedTensor}``,
    ready for :func:`kubeml_tpu_torch.models.layers.load_tree`."""
    tree = variables.get("params", variables)
    out: Dict[str, object] = {}

    def walk(node, prefix: str) -> None:
        if hasattr(node, "q") and hasattr(node, "s"):
            out[prefix] = QuantizedTensor(q=_tensor(node.q), s=_tensor(node.s))
        elif isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, f"{prefix}.{key}" if prefix else str(key))
        else:
            out[prefix] = _tensor(node)

    walk(tree, "")
    return out


def conv_kernels(module: Optional[nn.Module]) -> Optional[Set[str]]:
    """The dotted names of ``module``'s conv kernels (the ``kernel`` of
    each ``models.layers.Conv``), or None without a module."""
    if module is None:
        return None
    from ..models.layers import Conv

    return {f"{name}.kernel" if name else "kernel"
            for name, m in module.named_modules() if isinstance(m, Conv)}


def _is_conv(name: str, t, convs: Optional[Set[str]]) -> bool:
    """Whether the leaf ``name`` is a conv kernel: a module's named conv
    kernel, or without a module a 4-D leaf that is no pipelined stage
    stack (``stages.*`` stacks dense leaves on a leading stage axis)."""
    if convs is not None:
        return name in convs
    return t.ndim == 4 and not name.startswith("stages.")


def from_flax_variables(variables: Mapping[str, Any],
                        module: Optional[nn.Module] = None
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A Flax model's variables (``{"params": ..., "batch_stats": ...}``,
    numpy leaves) -> the port's ``{"params": {dotted name: tensor},
    "batch_stats": {dotted name: tensor}}``, the variables format of
    ``runtime.model.KubeModel``. Conv kernels go from Flax's HWIO to
    PyTorch's OIHW; dense kernels (``[in, out]``, and ``DenseGeneral``'s
    ``[*in, *out]``), BatchNorm ``scale``/``bias`` and the ``mean``/``var``
    statistics keep their layout. Without ``module`` every 4-D leaf is
    taken for a conv kernel, which holds for the conv models; a model with
    4-D dense kernels (ViT's ``qkv [E, 3, H, D]``) passes its module, whose
    :func:`conv_kernels` then name the conv kernels."""
    convs = conv_kernels(module)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for collection, tree in variables.items():
        flat: Dict[str, torch.Tensor] = {}

        def walk(node, prefix: str) -> None:
            if isinstance(node, Mapping):
                for key, child in node.items():
                    walk(child, f"{prefix}.{key}" if prefix else str(key))
            else:
                t = _tensor(node)
                if _is_conv(prefix, t, convs):  # [kh, kw, in, out]
                    t = t.permute(3, 2, 0, 1).contiguous()
                flat[prefix] = t

        walk(tree, "")
        out[collection] = flat
    return out


def _host(t):
    """A tensor's host copy: numpy, or a CPU tensor for bfloat16."""
    if not isinstance(t, torch.Tensor):
        return np.array(t, copy=True)
    t = t.detach().cpu()
    return t.clone() if t.dtype == torch.bfloat16 else t.numpy().copy()


def _nest(flat: Mapping[str, Any], leaf) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, value in flat.items():
        *parents, last = name.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf(value)
    return out


def to_flax(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{dotted name: tensor}`` (a dense ``state_dict``) -> ``{"params":
    nested tree}``, the inverse of :func:`from_flax`."""
    return {"params": _nest(flat, _host)}


def to_flax_variables(variables: Mapping[str, Mapping[str, Any]],
                      module: Optional[nn.Module] = None) -> Dict[str, Any]:
    """The port's ``{"params": {dotted: tensor}, "batch_stats": {...}}``
    (tensors or numpy arrays) -> Flax's nested variables, conv kernels
    back from OIHW to HWIO: the inverse of :func:`from_flax_variables`
    (``module`` as there)."""
    convs = conv_kernels(module)

    def convert(tree):
        out = {}
        for name, v in tree.items():
            v = _host(v)
            if _is_conv(name, v, convs):  # [out, in, kh, kw]
                v = (v.permute(2, 3, 1, 0).contiguous()
                     if isinstance(v, torch.Tensor)
                     else np.ascontiguousarray(v.transpose(2, 3, 1, 0)))
            out[name] = v
        return _nest(out, lambda v: v)

    return {c: convert(tree) for c, tree in variables.items()}


def _split(spec, mesh):
    """(dim, axis, axis size) of each dim of a leaf that ``spec`` splits
    over a mesh axis of size above 1."""
    if mesh is None:
        return []
    return [(d, ax, mesh.shape.get(ax, 1)) for d, ax in enumerate(spec)
            if ax is not None and mesh.shape.get(ax, 1) > 1]


def leaf_spec(name: str, shape: Sequence[int], mesh, spec_of=None) -> tuple:
    """The mesh axis of each dim of the leaf ``name`` of global
    ``shape`` on ``mesh``: the partition table's (``spec_of``, default
    ``models.gpt.partition_spec``), through the fit rule on a serving
    mesh. A storage marker takes its kernel's spec: ``.__q8_q__`` as it
    is, ``.__q8_s__`` (the scales) on its last axis only."""
    if spec_of is None:
        from ..models.gpt import partition_spec as spec_of
    from ..serving.quant import Q8_Q, Q8_S

    base, _, last = name.rpartition(".")
    n = len(shape)
    if last == Q8_Q:
        spec = tuple(spec_of(base, n))
    elif last == Q8_S:
        spec = (None,) * (n - 1) + tuple(spec_of(base, n))[-1:]
    else:
        spec = tuple(spec_of(name, n))
    if getattr(mesh, "serving", False):
        from ..parallel.mesh import fit_spec

        spec = fit_spec(spec, shape, mesh)
    return spec


def leaf_block(name: str, shape: Sequence[int], mesh,
               coord: Optional[Mapping[str, int]] = None,
               spec_of=None) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(start, shape) of the part of the leaf ``name`` of global ``shape``
    that the rank at ``coord`` on ``mesh`` (default: this rank's) holds,
    by the port's partition table: a dim split over ``tp`` (a stage axis
    over ``pp``, a MoE expert axis over ``ep``) covers part
    ``coord[axis]`` of it, every other dim all of it."""
    if spec_of is None:
        from ..models.gpt import partition_spec as spec_of
    start, size = [0] * len(shape), [int(n) for n in shape]
    for d, ax, n in _split(leaf_spec(name, shape, mesh, spec_of), mesh):
        size[d] //= n
        start[d] = (mesh.coord if coord is None else coord)[ax] * size[d]
    return tuple(start), tuple(size)


def global_shape(name: str, shape: Sequence[int], mesh,
                 spec_of=None) -> Tuple[int, ...]:
    """The global shape of the leaf ``name`` whose rank shard on ``mesh``
    has ``shape``: the inverse of :func:`leaf_block`'s shape."""
    if spec_of is None:
        from ..models.gpt import partition_spec as spec_of
    out = [int(n) for n in shape]
    for d, _, n in _split(spec_of(name, len(shape)), mesh):
        out[d] *= n
    return tuple(out)


def _block(name: str, t: torch.Tensor, mesh, spec_of) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` (a copy where it is cut,
    ``t`` itself where it is whole)."""
    start, size = leaf_block(name, t.shape, mesh, spec_of=spec_of)
    for d, (a, n) in enumerate(zip(start, size)):
        if n != t.shape[d]:
            t = t.narrow(d, a, n).clone()
    return t


def shard_tree(flat: Mapping[str, Any], mesh,
               spec_of=None) -> Dict[str, object]:
    """Cut a full flat tree (``from_flax`` output, or numpy leaves) into this
    rank's shards on ``mesh`` (each leaf's :func:`leaf_block`; an int8
    pair's ``q`` as its kernel, its scales along their channel axis).
    The result loads into a model built with, or placed on, the same
    mesh (``models.layers.load_tree``)."""
    from ..serving.quant import Q8_Q, Q8_S

    out: Dict[str, object] = {}
    for name, value in flat.items():
        if isinstance(value, QuantizedTensor):
            out[name] = QuantizedTensor(
                q=_block(f"{name}.{Q8_Q}", _tensor(value.q), mesh, spec_of),
                s=_block(f"{name}.{Q8_S}", _tensor(value.s), mesh, spec_of))
        else:
            out[name] = _block(name, _tensor(value), mesh, spec_of)
    return out


def shard_module(module: nn.Module, mesh, spec_of=None) -> nn.Module:
    """Keep, in place, this rank's block of every parameter of a module
    built whole (how the models built over a mesh cut themselves)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.data = _block(name, p.data, mesh, spec_of)
    return module


def gather_tree(flat: Mapping[str, torch.Tensor], mesh,
                spec_of=None) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_tree`: every leaf whole again, its
    ``tp`` (``pp``, ``ep``) shards gathered from the ranks (collective: every
    rank of the mesh calls it, leaf by leaf in the same order). Leaves
    come back on their device."""
    if spec_of is None:
        from ..models.gpt import partition_spec as spec_of
    from ..parallel.collectives import all_gather

    out: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for name, t in flat.items():
            t = t.detach()
            for d, ax, _ in _split(spec_of(name, t.dim()), mesh):
                t = all_gather(t, mesh, ax, d)
            out[name] = t
    return out
