"""BERT encoder for sequence classification: the port of
``kubeml_tpu/models/bert.py`` (BERT-base for SST-2).

The input is ``[B, L]`` integer token ids; id 0 is padding and sets the
attention's ``kv_valid`` (``token_ids != PAD_ID``), so the model keeps the
platform's one-input contract. Self-attention is non-causal through
``ops.attention.dot_product_attention``, which takes the flash kernels on
a CUDA tensor. BERT's conventions: post-LayerNorm layers, the exact (erf)
GELU, a tanh pooler over ``[CLS]`` (position 0), and dropout after the
embedding LayerNorm, after attention and the MLP, and on the pooled
vector, drawn from the ``rng`` generator.

``dtype`` is the compute dtype: matmuls run in it, LayerNorm and the
attention softmax in f32, parameters (the embeddings included) stay f32
and logits are f32. Names are Flax's (``token_embed``, ``pos_embed``,
``LayerNorm_0``, ``BertLayer_i.{BertSelfAttention_0.{query, key, value,
output}, LayerNorm_0, Dense_0, Dense_1, LayerNorm_1}``, ``pooler``,
``Dense_0``), so ``interop.from_flax.from_flax_variables`` carries a Flax
tree, and ``interop.torch_import.import_hf_bert`` a HuggingFace one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import (DenseGeneral, Dropout, Embed, LayerNorm,
                     QuantizableDense, flax_init_)

PAD_ID = 0


class BertSelfAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        H = num_heads
        D = embed_dim // H
        self.query = DenseGeneral((embed_dim,), (H, D), dtype=dtype)
        self.key = DenseGeneral((embed_dim,), (H, D), dtype=dtype)
        self.value = DenseGeneral((embed_dim,), (H, D), dtype=dtype)
        self.output = DenseGeneral((H, D), (embed_dim,), dtype=dtype)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        out = dot_product_attention(self.query(x), self.key(x), self.value(x),
                                    kv_valid=valid)
        return self.output(out)


class BertLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.BertSelfAttention_0 = BertSelfAttention(embed_dim, num_heads,
                                                     dtype=dtype)
        self.LayerNorm_0 = LayerNorm(embed_dim)
        self.Dense_0 = QuantizableDense(embed_dim, mlp_dim, dtype=dtype)
        self.Dense_1 = QuantizableDense(mlp_dim, embed_dim, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(embed_dim)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, valid: torch.Tensor,
                train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.drop(self.BertSelfAttention_0(x, valid), train, rng)
        x = self.LayerNorm_0(x + y).to(self.dtype)
        y = F.gelu(self.Dense_0(x), approximate="none")  # BERT's exact gelu
        y = self.drop(self.Dense_1(y), train, rng)
        return self.LayerNorm_1(x + y).to(self.dtype)


class BertClassifier(nn.Module):
    """``forward(token_ids [B, L], train, rng) -> f32 logits``."""

    def __init__(self, num_classes: int = 2, vocab_size: int = 30522,
                 max_len: int = 512, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
        self.dtype = dtype
        self.token_embed = Embed(vocab_size, embed_dim)
        self.pos_embed = nn.Parameter(torch.empty(1, max_len, embed_dim))
        self.LayerNorm_0 = LayerNorm(embed_dim)
        for i in range(depth):
            self.add_module(f"BertLayer_{i}", BertLayer(
                embed_dim, num_heads, mlp_dim, dropout, dtype=dtype))
        self.pooler = QuantizableDense(embed_dim, embed_dim, dtype=dtype)
        self.Dense_0 = QuantizableDense(embed_dim, num_classes, dtype=dtype)
        self.drop = Dropout(dropout)
        flax_init_(self)

    def forward(self, token_ids: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        ids = token_ids.long()
        L = ids.shape[1]
        valid = ids != PAD_ID  # [B, L]: the keys attention may read
        x = self.LayerNorm_0(self.token_embed(ids) + self.pos_embed[:, :L])
        x = self.drop(x, train, rng).to(self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"BertLayer_{i}")(x, valid, train, rng)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        pooled = self.drop(pooled, train, rng)
        return self.Dense_0(pooled).float()


def BertBase(num_classes: int = 2, vocab_size: int = 30522,
             dtype: torch.dtype = torch.float32, **kw) -> BertClassifier:
    return BertClassifier(num_classes=num_classes, vocab_size=vocab_size,
                          dtype=dtype, **kw)


def BertTiny(num_classes: int = 2, vocab_size: int = 1000, max_len: int = 128,
             dtype: torch.dtype = torch.float32, **kw) -> BertClassifier:
    """Test-sized config (2 layers, 128 wide)."""
    return BertClassifier(num_classes=num_classes, vocab_size=vocab_size,
                          max_len=max_len, embed_dim=128, depth=2,
                          num_heads=2, mlp_dim=256, dtype=dtype, **kw)
