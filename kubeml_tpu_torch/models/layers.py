"""Building blocks shared by the port's models.

:class:`QuantizableDense` is the port of ``kubeml_tpu/models/layers.py``:
a dense layer in Flax's layout (``kernel [in, out]``, ``bias [out]``, the
same parameter names, so a Flax tree maps onto it name for name) whose
kernel may instead be an int8 :class:`~kubeml_tpu_torch.serving.quant.
QuantizedTensor`. Dense kernels take ``nn.Dense``'s math in the layer's
compute dtype; quantized kernels go through ``serving.quant.quantized_dot``
(the int8-matmul kernel or its plain version).

:func:`load_tree` copies a flat tree (``from_flax`` output, or a
``state_dict`` passed through ``quantize_tree``) into a module, installing
quantized kernels where the tree holds them.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn


class QuantizableDense(nn.Module):
    """``y = x @ kernel + bias`` with ``kernel [in, out]``; the kernel may
    be int8 (:meth:`set_quantized`)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        self.register_buffer("kernel_q", None)  # int8 [in, out] when set
        self.register_buffer("kernel_s", None)  # f32 [1, out] when set
        # quantized_dot implementation (ops.int8_matmul.resolve_int8_matmul)
        self.int8_impl = "auto"

    @property
    def quantized(self) -> bool:
        return self.kernel_q is not None

    def set_quantized(self, qt, impl: str = "auto") -> None:
        """Replace the dense kernel with int8 values + per-channel scales."""
        shape = tuple(self.kernel_q.shape if self.quantized
                      else self.kernel.shape)
        if tuple(qt.q.shape) != shape or qt.q.dtype != torch.int8:
            raise ValueError(f"quantized kernel must be int8 {shape}, got "
                             f"{qt.q.dtype} {tuple(qt.q.shape)}")
        dev = (self.kernel_q if self.quantized else self.kernel).device
        self.kernel = None
        self.register_buffer("kernel_q", qt.q.to(dev).contiguous())
        self.register_buffer("kernel_s", qt.s.to(dev, torch.float32)
                             .contiguous())
        self.int8_impl = impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantized:
            # imported here: serving imports the models package
            from ..serving.quant import QuantizedTensor, quantized_dot

            d = self.dtype or x.dtype
            y = quantized_dot(x.to(d), QuantizedTensor(self.kernel_q,
                                                       self.kernel_s),
                              dtype=d, impl=self.int8_impl)
        else:
            d = self.dtype
            y = x.to(d) @ self.kernel.to(d)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def load_tree(module: nn.Module, tree: Mapping[str, object],
              int8_impl: str = "auto") -> nn.Module:
    """Copy a flat ``{name: tensor | QuantizedTensor}`` tree into ``module``
    in place. Every parameter must be covered and every name must exist;
    a :class:`QuantizedTensor` under ``<layer>.kernel`` turns that
    :class:`QuantizableDense` int8 (quantized_dot through ``int8_impl``).
    Returns the module."""
    from ..serving.quant import QuantizedTensor

    params = dict(module.named_parameters())
    covered = set()
    with torch.no_grad():
        for name, value in tree.items():
            if isinstance(value, QuantizedTensor):
                owner_name, _, leaf = name.rpartition(".")
                owner = module.get_submodule(owner_name)
                if leaf != "kernel" or not isinstance(owner, QuantizableDense):
                    raise ValueError(f"{name}: only QuantizableDense kernels "
                                     f"take a quantized tensor")
                owner.set_quantized(value, impl=int8_impl)
            elif name in params:
                p = params[name]
                if tuple(p.shape) != tuple(value.shape):
                    raise ValueError(f"{name}: shape {tuple(value.shape)} != "
                                     f"{tuple(p.shape)}")
                p.copy_(torch.as_tensor(value))
            else:
                raise KeyError(f"{name}: no such parameter in the module")
            covered.add(name)
    missing = sorted(set(params) - covered)
    if missing:
        raise KeyError(f"tree lacks parameters: {', '.join(missing)}")
    return module
