"""Attention core shared by the port's transformer models (plain PyTorch).

Port of ``kubeml_tpu/ops/attention.py::dot_product_attention``, plain path
only: heads stay a separate axis (``[B, L, H, D]``) until the output
projection, and the softmax runs in f32 even under bf16 activations. The
flash-attention dispatch for structured masks at long KV lengths comes with
the port of the flash kernels (ROADMAP, training slice); until then every
caller takes this path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def dot_product_attention(
    q: torch.Tensor,  # [B, Lq, H, D]
    k: torch.Tensor,  # [B, Lk, H, D]
    v: torch.Tensor,  # [B, Lk, H, D]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Lq, Lk]; True = attend
    *,
    causal: bool = False,
    kv_valid: Optional[torch.Tensor] = None,  # [B, Lk] True = real token
) -> torch.Tensor:
    """Scaled dot-product attention; returns ``[B, Lq, H, D]``.

    Masking comes as a dense ``mask`` and/or structurally as ``causal`` /
    ``kv_valid``. Masked scores take ``finfo(f32).min`` and masked weights
    are zeroed, so a fully masked row yields zeros, not NaN."""
    if causal or kv_valid is not None:
        lq, lk = q.shape[1], k.shape[1]
        extra = torch.ones((1, 1, lq, lk), dtype=torch.bool, device=q.device)
        if causal:
            extra = extra & (torch.arange(lk, device=q.device)[None, :]
                             <= torch.arange(lq, device=q.device)[:, None])
        if kv_valid is not None:
            extra = extra & kv_valid[:, None, None, :].bool()
        mask = extra if mask is None else mask & extra
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    scores = scores.float()
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    if mask is not None:
        weights = weights.masked_fill(~mask, 0.0)
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
