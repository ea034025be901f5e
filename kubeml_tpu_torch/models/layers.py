"""Building blocks shared by the port's models.

:class:`Conv` and :class:`BatchNorm` are Flax's ``nn.Conv`` and
``nn.BatchNorm`` in PyTorch, for the conv models (``models/resnet.py``,
``models/lenet.py``): the same parameter names (``kernel``, ``bias``;
``scale``, ``bias``, and the ``mean``/``var`` statistics as buffers, with
no ``num_batches_tracked``), so a Flax variables tree maps onto them name
for name (``interop.from_flax.from_flax_variables``), and Flax's numerics:
``padding="SAME"`` pads as XLA does (a stride-2 3x3 conv on an even input
pads (0, 1), not PyTorch's (1, 1)), BatchNorm keeps the *biased* batch
variance in its running statistics with Flax's momentum (0.9 keeps 0.9 of
the old value; PyTorch's 0.1 means the same). :func:`flax_init_` gives a
module Flax's initialisers (``lecun_normal`` kernels, zero biases, unit
BatchNorm scales) from a ``torch.Generator``.

:class:`QuantizableDense` is the port of ``kubeml_tpu/models/layers.py``:
a dense layer in Flax's layout (``kernel [in, out]``, ``bias [out]``, the
same parameter names, so a Flax tree maps onto it name for name) whose
kernel may instead be an int8 :class:`~kubeml_tpu_torch.serving.quant.
QuantizedTensor`. Dense kernels take ``nn.Dense``'s math in the layer's
compute dtype; quantized kernels go through ``serving.quant.quantized_dot``
(the int8-matmul kernel or its plain version).

:class:`DenseGeneral`, :class:`Embed` and :class:`LayerNorm` are the
encoders' blocks in Flax's layout and numerics (``DenseGeneral`` keeps
Flax's multi-axis kernels, e.g. ``[E, H, D]`` or ``[H, D, E]``;
``LayerNorm`` Flax's epsilon 1e-6 with f32 statistics).

Dropout draws its masks from an explicit ``torch.Generator``, never from
the global RNG: :class:`Dropout` takes the generator in its forward.
Seeds are plain integers mixed by :func:`fold_in` (a SplitMix64 hash of
the seed and a datum), the counterpart of ``jax.random.fold_in``: JAX's
threefry bits cannot be reproduced, so the masks differ from JAX's, but
the same seed always draws the same masks and different data different
ones. :func:`seed_of` turns a caller's ``rng`` (an int seed or a
generator) into such an integer.

:func:`load_tree` copies a flat tree (``from_flax`` output, or a
``state_dict`` passed through ``quantize_tree``) into a module, installing
quantized kernels where the tree holds them.
"""

from __future__ import annotations

import inspect
import math
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
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
        # quantized_dot implementation (ops.int8_matmul.resolve_int8_matmul),
        # or "dequant": densify the int8 kernel in each forward (the dense
        # engine's int8 path for MoE models)
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

    @property
    def features(self) -> int:
        """The output features this layer holds (a rank's columns of a
        column-parallel layer)."""
        return (self.kernel_q if self.quantized else self.kernel).shape[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.matmul(x)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ kernel`` without the bias, through the int8 route of a
        quantized kernel (a tensor-parallel layer's partial product)."""
        if self.quantized and self.int8_impl == "dequant":
            # in-step dequantize: the same f32 weight values as
            # serving.quant.dequantize_tree(tree, torch.float32)
            d = self.dtype
            return x.to(d) @ (self.kernel_q.to(torch.float32)
                              * self.kernel_s).to(d)
        if self.quantized:
            # imported here: serving imports the models package
            from ..serving.quant import QuantizedTensor, quantized_dot

            d = self.dtype or x.dtype
            return quantized_dot(x.to(d), QuantizedTensor(self.kernel_q,
                                                          self.kernel_s),
                                 dtype=d, impl=self.int8_impl)
        d = self.dtype
        return x.to(d) @ self.kernel.to(d)


def load_tree(module: nn.Module, tree: Mapping[str, object],
              int8_impl: str = "auto") -> nn.Module:
    """Copy a flat ``{name: tensor | QuantizedTensor}`` tree into ``module``
    in place. Every parameter must be covered and every name must exist;
    a :class:`QuantizedTensor` under ``<layer>.kernel`` turns that
    :class:`QuantizableDense` int8 (quantized_dot through ``int8_impl``),
    one under a MoE weight (``<block>.moe.w_in``, ...) makes that weight
    int8, dequantized in each forward (``parallel.moe.MoEMlp``).
    Returns the module."""
    from ..serving.quant import QuantizedTensor

    params = dict(module.named_parameters())
    covered = set()
    with torch.no_grad():
        for name, value in tree.items():
            if isinstance(value, QuantizedTensor):
                owner_name, _, leaf = name.rpartition(".")
                owner = module.get_submodule(owner_name)
                if leaf in getattr(owner, "QUANT_LEAVES", ()):
                    # a MoE expert stack or router (parallel.moe.MoEMlp)
                    owner.set_quantized(leaf, value)
                elif leaf == "kernel" and isinstance(owner, QuantizableDense):
                    owner.set_quantized(value, impl=int8_impl)
                else:
                    raise ValueError(f"{name}: only QuantizableDense kernels "
                                     f"and MoE weights take a quantized "
                                     f"tensor")
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


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``padding="SAME"``: (low, high) padding of one spatial dim so
    the output has ``ceil(size / stride)`` positions; the odd pixel goes
    high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Flax ``nn.Conv`` on NCHW activations: kernel ``[out, in, kh, kw]``
    (Flax's ``[kh, kw, in, out]`` transposed), optional bias, computed in
    ``dtype`` with channels-last weights."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides: int = 1,
                 padding: str = "SAME", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
        self.kernel_size = tuple(kernel_size)
        self.strides = int(strides)
        self.padding = padding
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features, in_features,
                                               *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        pad: Union[int, Tuple[int, int]] = 0
        if self.padding == "SAME":
            (ht, hb), (wl, wr) = (
                same_pads(x.shape[2], self.kernel_size[0], self.strides),
                same_pads(x.shape[3], self.kernel_size[1], self.strides))
            if ht == hb and wl == wr:
                pad = (ht, wl)
            else:
                x = F.pad(x, (wl, wr, ht, hb))
        w = self.kernel.to(self.dtype, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, w, b, self.strides, pad)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over the channels of NCHW activations, in f32
    (the output is f32 whatever the input). ``train=True`` normalises with
    the batch statistics and moves the running ``mean``/``var`` buffers
    toward them in place, ``momentum`` keeping that much of the old value,
    with the biased batch variance; ``train=False`` uses the buffers."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                                False, 0.0, self.epsilon)
        # the batch mean and 1/sqrt(biased var + eps) come with the output
        y, mean, invstd = torch.native_batch_norm(
            x, self.scale, self.bias, None, None, True, 0.0, self.epsilon)
        with torch.no_grad():
            var = invstd.pow(-2) - self.epsilon
            self.mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        return y


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Flax ``nn.max_pool(padding="SAME")``: pads with -inf as XLA does."""
    (ht, hb), (wl, wr) = (same_pads(x.shape[2], window, stride),
                          same_pads(x.shape[3], window, stride))
    x = F.pad(x, (wl, wr, ht, hb), value=-math.inf)
    return F.max_pool2d(x, window, stride)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
    """Flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled so the variance is ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


# --- the encoders' blocks ------------------------------------------------


class DenseGeneral(nn.Module):
    """Flax ``nn.DenseGeneral`` contracting the input's last ``len(in_shape)``
    axes: kernel ``[*in_shape, *features]``, bias ``[*features]``, the
    product in the layer's compute ``dtype``."""

    def __init__(self, in_shape: Sequence[int], features: Sequence[int],
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_shape = tuple(int(d) for d in in_shape)
        self.features = tuple(int(d) for d in features)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(*self.in_shape,
                                               *self.features))
        self.bias = (nn.Parameter(torch.zeros(*self.features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        y = torch.tensordot(x.to(d), self.kernel.to(d),
                            dims=len(self.in_shape))
        if self.bias is not None:
            y = y + self.bias.to(d)
        return y


class Embed(nn.Module):
    """Flax ``nn.Embed``: param ``embedding [vocab, features]``; rows come
    out in f32."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(dtype=float32)``: params ``scale``/``bias``,
    statistics and output in f32, epsilon 1e-6 (Flax's default; PyTorch's
    is 1e-5)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias,
                            self.eps)


# --- dropout on explicit generators ---------------------------------------

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """SplitMix64's finaliser."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (the counterpart of
    ``jax.random.fold_in``): ``mix(mix(seed) ^ data)`` with SplitMix64's
    finaliser, so nearby seeds and data give unrelated results."""
    return _mix64(_mix64(int(seed) & _MASK64) ^ (int(data) & _MASK64)) >> 1


def seed_of(rng: Union[int, torch.Generator]) -> int:
    """An integer seed from a caller's ``rng``: an int is its own seed; a
    generator gives one 62-bit draw (on its device: a CUDA generator waits
    for the draw)."""
    if isinstance(rng, torch.Generator):
        return int(torch.randint(0, 1 << 62, (1,), generator=rng,
                                 device=rng.device).item())
    return int(rng)


def make_generator(seed: int,
                   device: Union[str, torch.device]) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


class Dropout(nn.Module):
    """Flax ``nn.Dropout``: at ``train=True`` each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, its mask
    drawn from ``rng`` (a ``torch.Generator`` on the input's device); the
    identity at ``train=False`` or rate 0, zeros at rate 1."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if rng is None:
            raise ValueError(f"dropout at rate {self.rate} in training needs "
                             f"a generator (pass rng)")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def takes_rng(module: nn.Module) -> bool:
    """Whether ``module``'s forward takes a dropout generator (``rng``)."""
    return "rng" in inspect.signature(module.forward).parameters


@torch.no_grad()
def flax_init_(module: nn.Module,
               generator: Optional[torch.Generator] = None) -> nn.Module:
    """Initialise ``module``'s layers in place as Flax would, in
    registration order from ``generator``: :class:`Conv`,
    :class:`QuantizableDense` and :class:`DenseGeneral` kernels
    ``lecun_normal`` (the fan-in is the product of the contracted axes),
    :class:`Embed` tables Flax's default embedding initialiser (a normal,
    not truncated, of variance ``1 / width``), zero biases, unit
    BatchNorm and LayerNorm scales and variances, zero means; a module's
    own ``pos_embed`` normal(0.02) and ``cls`` zeros. Returns the
    module."""
    for m in module.modules():
        own = m._parameters
        if isinstance(own.get("pos_embed"), nn.Parameter):
            m.pos_embed.normal_(0.0, 0.02, generator=generator)
        if isinstance(own.get("cls"), nn.Parameter):
            m.cls.zero_()
        if isinstance(m, Conv):
            lecun_normal_(m.kernel, m.kernel[0].numel(), generator)
        elif isinstance(m, QuantizableDense) and not m.quantized:
            lecun_normal_(m.kernel, m.kernel.shape[0], generator)
        elif isinstance(m, DenseGeneral):
            lecun_normal_(m.kernel, math.prod(m.in_shape), generator)
        elif isinstance(m, Embed):
            m.embedding.normal_(0.0, m.embedding.shape[1] ** -0.5,
                                generator=generator)
            continue
        elif isinstance(m, BatchNorm):
            m.scale.fill_(1.0)
            m.mean.zero_()
            m.var.fill_(1.0)
        elif isinstance(m, LayerNorm):
            m.scale.fill_(1.0)
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
    return module
