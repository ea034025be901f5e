"""Weight-only int8 quantization for the decode path.

Port of ``kubeml_tpu/serving/quant.py`` (:54-158). Every decoded token
re-reads the whole model, so int8 weights with per-output-channel scales
cut the per-step weight bytes 4x against f32. Scheme, symmetric per output
channel (the LAST axis)::

    scale[c] = max(|W[..., c]|) / 127
    Q = round(W / scale),  W~ = Q * scale

Trees here are flat ``{name: tensor}`` mappings (a module's
``state_dict``). Only floating-point matrices with at least
``MIN_QUANT_SIZE`` elements quantize; embedding tables stay exact (decode
gathers one row per token, so quantizing them saves no per-step bytes).
:func:`quantized_dot` contracts activations against the int8 values and
applies the scale after the contraction, so no dense ``W~`` is built.

Checkpoint storage (JAX ``:161-291``): :func:`quantize_final_checkpoint`
reads a job's ``final`` export (flat or sharded, whichever is newer),
re-lays it out by its function's ``serving_remap``, quantizes its weights
by the same rule (so ``q`` and ``s`` are bit for bit the JAX package's)
and writes them under the ``final-int8`` tag in the same form, each
quantized leaf as a ``{Q8_Q: q, Q8_S: s}`` dict (:func:`to_storage_tree`),
which either package's checkpoint stores persist as it is.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..api.errors import CheckpointNotFoundError, KubeMLError
from ..ops.int8_matmul import int8_dot, int8_matmul, resolve_int8_matmul

# don't quantize small leaves: no bandwidth to win, outsized quality cost
MIN_QUANT_SIZE = 4096


class QuantizedTensor(NamedTuple):
    """int8 values + per-output-channel f32 scales."""

    q: torch.Tensor  # int8, same shape as the original weight
    s: torch.Tensor  # f32, shape [1 x (ndim-1), channels], broadcast over q

    @property
    def shape(self):
        return self.q.shape


def _quantize_leaf(w: torch.Tensor, mesh=None,
                   axes=()) -> QuantizedTensor:
    """``w``'s int8 values and per-channel scales; ``axes`` (of
    ``mesh``) are those that cut ``w`` on a dim other than the channel
    axis, over which each channel's absmax is reduced (an all-reduce MAX)
    so that a rank's block takes the scales of the whole leaf."""
    absmax = w.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True)
    if axes:
        import torch.distributed as dist

        from ..parallel.collectives import all_reduce_

        all_reduce_(absmax, mesh, tuple(axes), op=dist.ReduceOp.MAX)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, an ulp off the JAX rule's quotient on
    # ~5 % of the channels
    scale = absmax.clamp_min(1e-8) / torch.full_like(absmax, 127.0)
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return QuantizedTensor(q=q, s=scale.float())


def _wants_quant(leaf, numel=None) -> bool:
    """Whether a leaf quantizes (``numel``: the whole leaf's, where
    ``leaf`` is a rank's block of it)."""
    return (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and leaf.dim() >= 2
            and (leaf.numel() if numel is None else numel) >= MIN_QUANT_SIZE)


def _gather_accessed(name: str) -> bool:
    """Embedding-family leaves (token_embed, pos_embed, ...) are gathered,
    not streamed, by decode: they stay exact."""
    return any("embed" in part.lower() for part in name.split("."))


def quantize_tree(tree: Mapping[str, torch.Tensor], mesh=None,
                  specs: Optional[Mapping[str, tuple]] = None) -> dict:
    """Quantize every eligible weight of a flat tree; the same keys, with
    :class:`QuantizedTensor` values where quantized.

    A rank's blocks on a ``mesh`` (``specs``: each leaf's mesh axis a dim,
    ``models.gpt.place_on_mesh``'s ``mesh_specs``) quantize as the whole
    leaves would and then be cut: eligibility reads the whole leaf's size,
    and a leaf cut on a dim other than its channel axis (a row-parallel
    ``proj`` or ``mlp_out``, a MoE ``w_out``, an expert stack over
    ``ep``) reduces its absmax over those axes, so its scales are the
    whole leaf's. Every rank of the mesh calls this on its blocks, in
    the same order (the reductions are collective)."""
    out = {}
    for name, leaf in tree.items():
        spec = tuple((specs or {}).get(name, ()))
        cuts = [ax for ax in spec if ax is not None]
        numel = None
        if cuts and isinstance(leaf, torch.Tensor):
            numel = leaf.numel() * math.prod(mesh.shape[ax] for ax in cuts)
        if _gather_accessed(name) or not _wants_quant(leaf, numel):
            out[name] = leaf
            continue
        axes = [ax for ax in spec[:-1] if ax is not None]
        out[name] = _quantize_leaf(leaf, mesh, axes)
    return out


def dequantize_tree(tree: Mapping[str, object],
                    dtype: torch.dtype = torch.bfloat16) -> dict:
    """Densify a quantized tree: ``q * s`` in ``dtype`` per quantized leaf."""
    return {name: (leaf.q.to(dtype) * leaf.s.to(dtype)
                   if isinstance(leaf, QuantizedTensor) else leaf)
            for name, leaf in tree.items()}


def quantized_bytes(module: torch.nn.Module) -> int:
    """Weight bytes a decode step streams with ``module`` as loaded: every
    parameter and buffer (int8 values and their scales where quantized)
    but the gathered embedding tables."""
    sizes = {t.data_ptr(): t.numel() * t.element_size()
             for name, t in [*module.named_parameters(),
                             *module.named_buffers()]
             if not _gather_accessed(name)}
    return sum(sizes.values())


def quantized_dot(x: torch.Tensor, qt: QuantizedTensor, *, dtype=None,
                  impl: str = "auto") -> torch.Tensor:
    """``x @ dequant(qt)`` without materializing the dense weight: the
    contraction runs on the int8 values and the per-output-channel scale
    multiplies the f32 sum afterward.

    ``impl`` (``ops.int8_matmul.resolve_int8_matmul``): ``auto`` = the CUDA
    kernel on CUDA tensors and ``int8_dot`` on the CPU, ``cuda``/``pallas``
    = the kernel wrapper, ``dot`` = the plain version. Only 2-d quantized
    kernels (dense projections) are supported; a >2-d leaf raises."""
    if qt.q.dim() != 2:
        raise ValueError(
            f"quantized_dot wants a 2-d quantized kernel, got shape "
            f"{tuple(qt.q.shape)} - route >2-d leaves (expert stacks) "
            f"through the dequantize path instead")
    out = dtype or x.dtype
    if resolve_int8_matmul(impl, x.device) == "cuda":
        return int8_matmul(x, qt.q, qt.s, out_dtype=out)
    return int8_dot(x, qt.q, qt.s, out_dtype=out)


# --- checkpoint storage (the final-int8 export) ---

INT8_TAG = "final-int8"
Q8_Q = "__q8_q__"
Q8_S = "__q8_s__"


def _is_storage_q(node) -> bool:
    return isinstance(node, dict) and set(node) == {Q8_Q, Q8_S}


def _map_nodes(fn: Callable[[Any], Any], tree, is_node) -> Any:
    """``fn`` on every node ``is_node`` accepts and every leaf of a
    nested-dict tree; dicts are rebuilt around them."""
    if is_node(tree):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _map_nodes(fn, v, is_node) for k, v in tree.items()}
    return fn(tree)


def _nodes(tree, is_node):
    if is_node(tree):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _nodes(v, is_node)
    else:
        yield tree


def _is_q(node) -> bool:
    return isinstance(node, QuantizedTensor)


def to_storage_tree(tree) -> dict:
    """QuantizedTensor nodes -> ``{Q8_Q: q, Q8_S: s}`` dicts."""
    return _map_nodes(lambda n: {Q8_Q: n.q, Q8_S: n.s} if _is_q(n) else n,
                      tree, _is_q)


def from_storage_tree(tree) -> dict:
    """Inverse of :func:`to_storage_tree`."""
    return _map_nodes(lambda n: (QuantizedTensor(q=n[Q8_Q], s=n[Q8_S])
                                 if _is_storage_q(n) else n),
                      tree, _is_storage_q)


def is_quantized_tree(tree) -> bool:
    """True when the tree carries QuantizedTensor leaves."""
    return any(_is_q(n) for n in _nodes(tree, _is_q))


def is_quantized_storage(tree) -> bool:
    """True when a restored tree carries int8 storage markers."""
    return any(_is_storage_q(n) for n in _nodes(tree, _is_storage_q))


def _quantize_nested(tree, path=()) -> Any:
    """:func:`quantize_tree`'s rule over a nested host tree (numpy leaves,
    or CPU bfloat16 tensors): eligible leaves become QuantizedTensor pairs
    of numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: _quantize_nested(v, path + (str(k),))
                for k, v in tree.items()}
    leaf = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(
        np.asarray(tree))
    if _gather_accessed(".".join(path)) or not _wants_quant(leaf):
        return tree
    qt = _quantize_leaf(leaf)
    return QuantizedTensor(q=qt.q.numpy(), s=qt.s.numpy())


def quantize_final_checkpoint(job_id: str, store, registry=None,
                              sharded_store=None) -> str:
    """Quantize a job's ``final`` export offline and write it under
    ``INT8_TAG`` in the same form; returns the form written (``"flat"``
    or ``"sharded"``). The newer of the flat and the sharded final is
    read (``sharded_store`` defaults to the sharded store under
    ``store``'s root): a retrain never quantizes a stale form. Serving
    with ``serving_quantize="int8"`` then prefers the result while it is
    at least as fresh as ``final``. ``registry`` loads the job's function
    first, whose ``serving_remap`` re-lays the tree out before it is
    quantized; a function that cannot load is a 400."""
    from ..storage.checkpoint import FINAL_TAG
    from ..storage.sharded_checkpoint import (ShardedCheckpointStore,
                                              apply_remap_host)

    if sharded_store is None:
        sharded_store = ShardedCheckpointStore(root=store.root)
    form, _ = store.final_form(job_id, FINAL_TAG)
    if form is None:
        raise CheckpointNotFoundError(job_id)
    ck = (store.restore(job_id, tag=FINAL_TAG) if form == "flat"
          else sharded_store.restore(job_id, FINAL_TAG))
    variables = ck.variables
    if registry is not None:
        fn_name = ck.meta.get("request", {}).get("function_name", "")
        try:
            model = registry.load(fn_name)
        except Exception as e:
            raise KubeMLError(
                f"quantize needs job {job_id}'s function {fn_name!r} to "
                f"determine the serving layout, but loading it failed: {e}",
                400)
        remap = model.serving_remap()
        if remap is not None:
            variables = apply_remap_host(variables, remap)
    storage = to_storage_tree(_quantize_nested(variables))
    meta = {**ck.meta, "quantized": "int8", "layout": "serving"}
    target = store if form == "flat" else sharded_store
    target.save(job_id, storage, epoch=ck.epoch, tag=INT8_TAG, meta=meta)
    return form
