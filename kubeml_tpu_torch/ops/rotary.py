"""Rotary position embeddings (RoPE), port of ``kubeml_tpu/ops/rotary.py``.

Each (q, k) head-dim pair rotates by an angle proportional to the token's
absolute position (the "rotate-half" convention); angles are computed in
f32 whatever the activation dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables ``[..., L, head_dim/2]`` (f32) for ``positions``."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x`` ``[B, L, H, D]`` by its positions ``[L]`` or ``[B, L]``;
    returns the input dtype."""
    d = x.shape[-1]
    cos, sin = rope_angles(positions, d, theta)
    if cos.dim() == 2:  # positions were [L]
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # [B, L]
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1 = x[..., : d // 2].float()
    x2 = x[..., d // 2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
