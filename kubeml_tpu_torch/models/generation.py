"""Decode-side helpers of the port, from ``kubeml_tpu/models/generation.py``:
the paged KV cache, the paged-decode capability probe, and the per-row
knob-adjusted logits the samplers draw from."""

from __future__ import annotations

import inspect
from typing import Dict, List

import torch

from ..ops.paged_attention import resolve_kv_quant, resolve_paged_attn
from .gpt import PAD_ID

__all__ = ["PAD_ID", "GenerationInputError", "PagedCache", "init_paged_cache",
           "supports_paged_decode"]

# width of the top-k threshold scratch for runtime per-row knobs (the
# serving bound, serving.batcher.TOP_K_MAX)
SPEC_TOP_K_CAP = 128


class GenerationInputError(ValueError):
    """A USER-input problem in a generation request (bad shapes, a model
    that cannot serve): the wire layer maps exactly this type to 400."""


class PagedCache:
    """The per-layer K/V page arenas of one paged decoder.

    ``layers[i]`` holds ``k_pages``/``v_pages`` ``[kv_pages, page_tokens,
    H, D]`` (the compute dtype, or int8 with ``k_scale``/``v_scale``
    ``[kv_pages, H]`` f32 per-page-per-head absmax scales) - the JAX arena
    layout, byte for byte. ``paged_attn`` is the resolved read path
    (``cuda`` kernel or ``gather`` plain version) and ``kv_quant`` the
    resolved storage mode."""

    def __init__(self, layers: List[Dict[str, torch.Tensor]],
                 page_tokens: int, kv_quant: str, paged_attn: str):
        self.layers = layers
        self.page_tokens = page_tokens
        self.kv_quant = kv_quant
        self.paged_attn = paged_attn

    def zero_(self) -> "PagedCache":
        for arena in self.layers:
            for t in arena.values():
                t.zero_()
        return self


def init_paged_cache(module, kv_pages: int, page_tokens: int,
                     kv_quant: str = "off", paged_attn: str = "auto"
                     ) -> PagedCache:
    """Zeroed paged arenas for every layer of ``module``, on the module's
    device. The JAX function sizes the arena from clone fields on the
    module; here the geometry is passed and carried by the cache."""
    kvq = resolve_kv_quant(kv_quant)
    dev = module.device
    H = module.num_heads
    D = module.embed_dim // H
    store = torch.int8 if kvq == "int8" else module.dtype
    layers = []
    for _ in range(module.depth):
        arena = {name: torch.zeros((kv_pages, page_tokens, H, D), dtype=store,
                                   device=dev)
                 for name in ("k_pages", "v_pages")}
        if kvq == "int8":
            arena.update({name: torch.zeros((kv_pages, H),
                                            dtype=torch.float32, device=dev)
                          for name in ("k_scale", "v_scale")})
        layers.append(arena)
    return PagedCache(layers, page_tokens, kvq,
                      resolve_paged_attn(paged_attn, dev))


def supports_paged_decode(module) -> bool:
    """Whether ``module`` can serve through the paged engine: its forward
    takes ``positions``/``pages``/``seq_lens``/``cache`` and it does not
    interleave MoE blocks."""
    if getattr(module, "moe_every", 0):
        return False
    try:
        params = inspect.signature(module.forward).parameters
    except (TypeError, ValueError):
        return False
    return all(p in params for p in ("positions", "pages", "seq_lens",
                                     "cache"))


def _masked_scaled(logits, temp, topk, topk_cap: int = SPEC_TOP_K_CAP):
    """Per-row knob-adjusted logits: temperature scaling + top-k truncation
    with RUNTIME knobs. logits ``[S, V]`` f32, temp ``[S]`` (rows <= 0 give
    junk the greedy branch discards), topk ``[S]`` int (0 = off)."""
    V = logits.shape[-1]
    scaled = logits / temp.clamp_min(1e-6)[:, None]
    kwide = min(topk_cap, V)
    vals = torch.topk(scaled, kwide, dim=-1).values  # sorted desc
    kth = torch.gather(vals, 1, (topk.long() - 1).clamp(0, kwide - 1)[:, None])
    return torch.where((topk > 0)[:, None] & (scaled < kth),
                       torch.finfo(torch.float32).min, scaled)
