"""Attention core shared by the port's transformer models.

Port of ``kubeml_tpu/ops/attention.py::dot_product_attention``: heads stay
a separate axis (``[B, L, H, D]``) until the output projection, and the
softmax runs in f32 even under bf16 activations.

Dispatch (``impl``), as in the JAX package: callers that express masking
structurally (``causal`` / ``kv_valid``, no dense ``mask``) get the
hand-written flash-attention kernels (``ops.flash_attention``) on a CUDA
tensor automatically; a dense ``mask`` forces the plain path, which is
also the CPU path. ``"plain"`` (legacy ``"xla"``) forces the plain path,
``"cuda"`` (legacy ``"pallas"``) the flash kernels (on CPU tensors their
plain versions).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import flash_attention as _flash

# Automatic choice of the flash kernels: structured-mask callers on a CUDA
# tensor with KV length >= this take the kernels; None disables the
# automatic choice. 0 takes the kernels at every length. The JAX package's
# value (1024) was measured on a TPU and does not carry over; a threshold
# measured on the H100 is later work (ROADMAP).
FLASH_MIN_KV_LEN: Optional[int] = 0

VALID_IMPLS = ("auto", "plain", "xla", "cuda", "pallas")


def dot_product_attention(
    q: torch.Tensor,  # [B, Lq, H, D]
    k: torch.Tensor,  # [B, Lk, H, D]
    v: torch.Tensor,  # [B, Lk, H, D]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Lq, Lk]; True = attend
    *,
    causal: bool = False,
    kv_valid: Optional[torch.Tensor] = None,  # [B, Lk] True = real token
    impl: Optional[str] = None,  # None/"auto" | "plain" ("xla") | "cuda" ("pallas")
) -> torch.Tensor:
    """Scaled dot-product attention; returns ``[B, Lq, H, D]``.

    Masking comes as a dense ``mask`` (plain path only) and/or structurally
    as ``causal`` / ``kv_valid`` (eligible for the flash kernels). On the
    plain path masked scores take ``finfo(f32).min`` and masked weights are
    zeroed, so a fully masked row yields zeros, not NaN. On a CUDA tensor
    the automatic choice does not fall back to the plain path: a head dim
    or dtype the kernels are not built for raises there; pass
    ``impl="plain"`` to take the plain path."""
    impl = (impl or "auto").lower()
    if impl not in VALID_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r} (valid: "
                         f"{', '.join(VALID_IMPLS)})")
    if impl == "auto":
        impl = ("cuda" if FLASH_MIN_KV_LEN is not None and mask is None
                and q.is_cuda and k.shape[1] >= FLASH_MIN_KV_LEN
                else "plain")
    if impl in ("cuda", "pallas"):
        if mask is not None:
            raise ValueError("the flash kernels take causal/kv_valid, not a "
                             "dense mask")
        return _flash.flash_attention(q, k, v, causal=causal,
                                      kv_valid=kv_valid)
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
    scores = scores.to(torch.promote_types(scores.dtype, torch.float32))
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    if mask is not None:
        weights = weights.masked_fill(~mask, 0.0)
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
