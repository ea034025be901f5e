"""ViT, the Vision Transformer: the port of ``kubeml_tpu/models/vit.py``
(ViT-Tiny on CIFAR-100: embed 192, depth 12, 3 heads, patch 4).

The patch embedding is a VALID conv of stride p on the NHWC input,
flattened in NHWC order to ``[B, (H/p)(W/p), E]``; the ``cls`` token is
prepended before ``pos_embed`` is added, so 32x32 inputs at patch 4 give
L = 65. Each ``EncoderBlock`` is pre-LayerNorm: ``MHSA`` (one
``DenseGeneral`` to ``[3, H, D]``, non-causal attention through
``ops.attention.dot_product_attention``, which takes the flash kernels on
a CUDA tensor, and a ``DenseGeneral`` from ``[H, D]``), then an MLP with
Flax's ``nn.gelu`` (the tanh approximation), each output through dropout
drawn from the ``rng`` generator.

``dtype`` is the compute dtype: matmuls run in it, LayerNorm and the
attention softmax in f32, parameters (``cls`` and ``pos_embed`` included)
stay f32 and logits are f32. Names are Flax's (``patch_embed``, ``cls``,
``pos_embed``, ``EncoderBlock_i.{LayerNorm_0, MHSA_0.{qkv, proj},
LayerNorm_1, Dense_0, Dense_1}``, ``LayerNorm_0``, ``Dense_0``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import (Conv, DenseGeneral, Dropout, LayerNorm, QuantizableDense,
                     flax_init_)


class MHSA(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        H = num_heads
        D = embed_dim // H
        self.qkv = DenseGeneral((embed_dim,), (3, H, D), dtype=dtype)
        self.proj = DenseGeneral((H, D), (embed_dim,), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv(x)  # [B, L, 3, H, D]
        out = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.proj(out)


class EncoderBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.LayerNorm_0 = LayerNorm(embed_dim)
        self.MHSA_0 = MHSA(embed_dim, num_heads, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(embed_dim)
        self.Dense_0 = QuantizableDense(embed_dim, embed_dim * mlp_ratio,
                                        dtype=dtype)
        self.Dense_1 = QuantizableDense(embed_dim * mlp_ratio, embed_dim,
                                        dtype=dtype)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.MHSA_0(self.LayerNorm_0(x).to(self.dtype))
        x = x + self.drop(y, train, rng)
        y = self.LayerNorm_1(x).to(self.dtype)
        y = F.gelu(self.Dense_0(y), approximate="tanh")  # Flax nn.gelu
        return x + self.drop(self.Dense_1(y), train, rng)


class ViT(nn.Module):
    """``forward(x [B, H, W, C], train, rng) -> f32 logits``. ``in_shape``
    is the inputs' (H, W, C): the length of ``pos_embed`` depends on it
    (Flax reads it off the first batch)."""

    def __init__(self, num_classes: int = 100, patch_size: int = 4,
                 embed_dim: int = 192, depth: int = 12, num_heads: int = 3,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 in_shape: Sequence[int] = (32, 32, 3)):
        super().__init__()
        h, w, c = in_shape
        p = patch_size
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.dtype = dtype
        self.patch_embed = Conv(c, embed_dim, (p, p), strides=p,
                                padding="VALID", dtype=dtype)
        self.cls = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.empty(1, (h // p) * (w // p) + 1, embed_dim))
        for i in range(depth):
            self.add_module(f"EncoderBlock_{i}", EncoderBlock(
                embed_dim, num_heads, dropout=dropout, dtype=dtype))
        self.LayerNorm_0 = LayerNorm(embed_dim)
        self.Dense_0 = QuantizableDense(embed_dim, num_classes, dtype=dtype)
        flax_init_(self)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        B = x.shape[0]
        x = self.patch_embed(x.to(self.dtype).permute(0, 3, 1, 2))
        x = x.permute(0, 2, 3, 1).reshape(B, -1, self.embed_dim)  # NHWC order
        cls = self.cls.to(x.dtype).expand(B, 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"EncoderBlock_{i}")(x, train, rng)
        x = self.LayerNorm_0(x)
        return self.Dense_0(x[:, 0].to(self.dtype)).float()


def ViTTiny(num_classes: int = 100, patch_size: int = 4,
            dtype: torch.dtype = torch.float32, **kw) -> ViT:
    return ViT(num_classes=num_classes, patch_size=patch_size, embed_dim=192,
               depth=12, num_heads=3, dtype=dtype, **kw)
