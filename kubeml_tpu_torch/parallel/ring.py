"""Ring attention over the ``sp`` mesh axis, the port of
``kubeml_tpu/parallel/ring.py``.

The sequence is sharded over the ranks of ``sp``: each rank keeps its
query block and the K/V blocks rotate around the ring (:func:`~.
collectives.ppermute`, whose backward rotates the gradients back), with
flash-style online-softmax accumulation, so no rank holds the whole
``[L, L]`` scores. It runs in plain PyTorch, as the JAX function runs in
``jax.numpy`` (no kernel), with JAX's numerics: f32 accumulation, masked
scores at ``_NEG``, causal masking by global positions ``coord * Lb +
arange(Lb)``, ``kv_valid`` rotating with its K/V block, ``p`` zeroed where
the scores are masked, the denominator clamped at 1e-9, and the output
cast back to ``q``'s dtype. The JAX loop rotates once more after the last
block and drops the result; this one stops at the last block.
"""

from __future__ import annotations

from typing import Optional

import torch

from .collectives import ppermute

_NEG = -1e30  # large-negative instead of -inf: keeps exp() NaN-free for
# fully masked rows (the flash-attention trick)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis_name: str = "sp", causal: bool = False,
                   kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention over the ring: ``q``/``k``/``v`` are this rank's
    ``[B, Lb, H, D]`` blocks, ``kv_valid [B, Lb]`` its keys' validity;
    returns the local output block ``[B, Lb, H, D]``."""
    sp = mesh.shape.get(axis_name, 1) if mesh is not None else 1
    my = mesh.coord.get(axis_name, 0) if mesh is not None else 0
    B, Lb, H, D = q.shape
    dev = q.device
    # 1 / sqrt(D) in f32, as JAX rounds it
    scale = torch.tensor(float(D), dtype=torch.float32).sqrt().reciprocal()
    scale = scale.to(dev)
    qf = q.float()
    q_pos = my * Lb + torch.arange(Lb, device=dev)
    acc = torch.zeros((B, Lb, H, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Lb), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Lb), dtype=torch.float32, device=dev)
    kv = torch.stack((k, v))  # one rotation carries both
    valid = kv_valid
    for s in range(sp):
        src = (my - s) % sp  # the global block kv holds now
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kv[0].float()) * scale
        k_pos = src * Lb + torch.arange(Lb, device=dev)
        if causal:
            keep = (k_pos[None, :] <= q_pos[:, None])[None, None]
            scores = torch.where(keep, scores, _NEG)
        if valid is not None:
            scores = torch.where(valid.bool()[:, None, None, :], scores, _NEG)
        m_new = torch.maximum(m, scores.amax(dim=-1))  # [B, H, Lq]
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        # rows where everything (the running max too) is masked stay zero
        p = torch.where(scores <= _NEG / 2, 0.0, p)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, kv[1].float())
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
        if s < sp - 1:
            kv = ppermute(kv, mesh, axis_name)
            if valid is not None:
                valid = ppermute(valid, mesh, axis_name)
    denom = l.clamp_min(1e-9).transpose(1, 2)[..., None]  # [B, Lq, H, 1]
    return (acc / denom).to(q.dtype)
