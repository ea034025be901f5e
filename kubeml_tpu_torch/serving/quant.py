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
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

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


def _quantize_leaf(w: torch.Tensor) -> QuantizedTensor:
    absmax = w.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True)
    scale = absmax.clamp_min(1e-8) / 127.0
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return QuantizedTensor(q=q, s=scale.float())


def _wants_quant(leaf) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and leaf.dim() >= 2 and leaf.numel() >= MIN_QUANT_SIZE)


def _gather_accessed(name: str) -> bool:
    """Embedding-family leaves (token_embed, pos_embed, ...) are gathered,
    not streamed, by decode: they stay exact."""
    return any("embed" in part.lower() for part in name.split("."))


def quantize_tree(tree: Mapping[str, torch.Tensor]) -> dict:
    """Quantize every eligible weight of a flat tree; the same keys, with
    :class:`QuantizedTensor` values where quantized."""
    return {name: (_quantize_leaf(leaf)
                   if not _gather_accessed(name) and _wants_quant(leaf)
                   else leaf)
            for name, leaf in tree.items()}


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
