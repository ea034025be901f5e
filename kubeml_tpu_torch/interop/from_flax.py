"""Flax variables <-> the port's weights.

:func:`from_flax` carries a Flax ``CausalTransformer``'s parameters;
:func:`from_flax_variables` a K-AVG model's whole variables tree (ResNet,
LeNet, VGG, ViT, BERT: ``params`` and ``batch_stats``). :func:`to_flax` and
:func:`to_flax_variables` are their inverses: the port writes checkpoints
in the Flax layout through them, so a checkpoint file never says which
package wrote it. :func:`shard_tree` cuts a full flat tree into one
rank's tensor-parallel shards by the port's partition table
(``models.gpt.partition_spec``, JAX's ``_part`` specs); :func:`gather_tree`
gathers a rank's shards back into whole leaves (collectively, on every
rank), for the tests and for a save; :func:`leaf_block` is the global
slice (start, shape) of a leaf that a rank's shard covers, from the same
table, which the sharded checkpoints write and read by.

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
    return t.ndim == 4 if convs is None else name in convs


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


def leaf_block(name: str, shape: Sequence[int], mesh,
               coord: Optional[Mapping[str, int]] = None,
               spec_of=None) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(start, shape) of the part of the leaf ``name`` of global ``shape``
    that the rank at ``coord`` on ``mesh`` (default: this rank's) holds,
    by the port's partition table: a leaf split over ``tp`` covers part
    ``coord["tp"]`` of its split dim, every other leaf all of it."""
    if spec_of is None:
        from ..models.gpt import partition_spec as spec_of
    start, size = [0] * len(shape), [int(n) for n in shape]
    tp = 1 if mesh is None else mesh.shape.get("tp", 1)
    spec = spec_of(name, len(shape))
    if tp > 1 and "tp" in spec:
        d = spec.index("tp")
        size[d] //= tp
        start[d] = (mesh.coord if coord is None else coord)["tp"] * size[d]
    return tuple(start), tuple(size)


def global_shape(name: str, shape: Sequence[int], mesh,
                 spec_of=None) -> Tuple[int, ...]:
    """The global shape of the leaf ``name`` whose rank shard on ``mesh``
    has ``shape``: the inverse of :func:`leaf_block`'s shape."""
    if spec_of is None:
        from ..models.gpt import partition_spec as spec_of
    out = [int(n) for n in shape]
    tp = 1 if mesh is None else mesh.shape.get("tp", 1)
    spec = spec_of(name, len(shape))
    if tp > 1 and "tp" in spec:
        out[spec.index("tp")] *= tp
    return tuple(out)


def shard_tree(flat: Mapping[str, Any], mesh,
               spec_of=None) -> Dict[str, torch.Tensor]:
    """Cut a full flat tree (``from_flax`` output, or numpy leaves) into this
    rank's shards on ``mesh`` (each leaf's :func:`leaf_block`). The result
    loads into a model built with the same mesh
    (``models.layers.load_tree``)."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in flat.items():
        t = _tensor(value)
        start, size = leaf_block(name, t.shape, mesh, spec_of=spec_of)
        for d, (a, n) in enumerate(zip(start, size)):
            if n != t.shape[d]:
                t = t.narrow(d, a, n).clone()
        out[name] = t
    return out


def gather_tree(flat: Mapping[str, torch.Tensor], mesh,
                spec_of=None) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_tree`: every leaf whole again, its
    ``tp`` shards gathered from the ranks (collective: every rank of the
    mesh calls it). Leaves come back on their device."""
    if spec_of is None:
        from ..models.gpt import partition_spec as spec_of
    from ..parallel.collectives import all_gather

    out: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for name, t in flat.items():
            spec = spec_of(name, t.dim())
            out[name] = (all_gather(t.detach(), mesh, "tp", spec.index("tp"))
                         if "tp" in spec else t.detach())
    return out
