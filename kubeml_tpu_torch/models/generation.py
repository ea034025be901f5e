"""Decode-side helpers of the port, from ``kubeml_tpu/models/generation.py``:
the paged KV cache, the paged-decode capability probe, the per-row
knob-adjusted logits the samplers draw from, and the acceptance math of
speculative decoding (``draft_sample``, ``spec_accept``,
``spec_mask_emissions``), which the serving engine's spec mode runs.

Randomness: the JAX functions take a PRNG key per row; here a row that
samples (temperature > 0) carries its own ``torch.Generator`` and a greedy
row carries None. A row's draws come from its generator alone, in a fixed
order, so its stream does not depend on the rows it is batched with.
Greedy rows are exact (argmax); sampled rows keep the target distribution
(accept a draft with probability min(1, p/q), resample the residual), as
the JAX functions do, but not the JAX key chain's values."""

from __future__ import annotations

import inspect
from typing import Dict, List, Optional, Sequence

import torch

from ..ops.paged_attention import resolve_kv_quant, resolve_paged_attn
from .gpt import PAD_ID

__all__ = ["PAD_ID", "GenerationInputError", "PagedCache", "init_paged_cache",
           "supports_paged_decode", "draft_sample", "spec_accept",
           "spec_mask_emissions"]

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


def _knob_probs(logits, temp, topk, topk_cap: int = SPEC_TOP_K_CAP):
    """The per-row sampling distribution under runtime knobs: softmax over
    the temperature-scaled, top-k-truncated logits - the p (target) and q
    (drafter) the acceptance rule compares."""
    return torch.softmax(_masked_scaled(logits, temp, topk, topk_cap), dim=-1)


def _hot(gens: Sequence[Optional[torch.Generator]]) -> List[int]:
    return [i for i, g in enumerate(gens) if g is not None]


def draft_sample(logits, temp, topk, gens, topk_cap: int = SPEC_TOP_K_CAP,
                 with_probs: bool = True):
    """One draw per row with runtime knobs: greedy rows (``gens[i]`` None)
    take the argmax, sampled rows draw one token from their generator.
    Returns ``(tokens [S], probs [S, V])``: probs is the knob-adjusted
    distribution (the drafter's q, which the acceptance test of sampled
    rows reads); ``with_probs=False`` computes it for the sampled rows
    only and returns None in its place."""
    toks = torch.argmax(logits, dim=-1)
    hot = _hot(gens)
    probs = _knob_probs(logits, temp, topk, topk_cap) if with_probs else None
    if hot:
        idx = torch.tensor(hot, device=logits.device)
        hp = (probs[idx] if probs is not None
              else _knob_probs(logits[idx], temp[idx], topk[idx], topk_cap))
        toks[idx] = torch.cat([torch.multinomial(hp[j], 1, generator=gens[i])
                               for j, i in enumerate(hot)])
    return toks, probs


def spec_accept(tgt_logits, draft_tokens, draft_probs, temp, topk, gens,
                topk_cap: int = SPEC_TOP_K_CAP):
    """The distribution-preserving acceptance rule, per row.

    ``tgt_logits [S, k+1, V]`` f32 - the verify forward's logits (position
    i is the distribution after feeding draft i-1; position 0 follows the
    row's current token); ``draft_tokens [S, k]``; ``draft_probs [S, k,
    V]`` (the drafter's q; None when no row samples); ``temp``, ``topk``
    ``[S]``; ``gens`` a generator per sampled row, None per greedy row.

    Greedy rows: draft i is accepted iff it is the target argmax at
    position i, and the correction is the target argmax at the first
    mismatch - the emitted stream is the plain argmax chain. Sampled rows
    draw k uniforms, then one correction token, from their generator:
    accept draft d_i while u_i * q_i(d_i) < p_i(d_i); at the first
    rejection draw from the normalized residual max(p - q, 0); if all k
    drafts survive, the bonus token draws from p_k. Returns ``(emit [S,
    k+1]`` - accepted drafts, then the correction or bonus, -1 past it;
    ``n_acc [S]`` - accepted drafts in [0, k])."""
    S, k1, V = tgt_logits.shape
    k = k1 - 1
    dev = tgt_logits.device
    tgt_arg = torch.argmax(tgt_logits, dim=-1)  # [S, k+1]
    drafts = draft_tokens.long()
    acc = tgt_arg[:, :k] == drafts  # the greedy rule; sampled rows below
    hot = _hot(gens)
    if hot:
        idx = torch.tensor(hot, device=dev)
        n = len(hot)
        p = _knob_probs(tgt_logits[idx].reshape(n * k1, V),
                        temp[idx].repeat_interleave(k1),
                        topk[idx].repeat_interleave(k1),
                        topk_cap).reshape(n, k1, V)
        if k > 0:
            q = draft_probs[idx]
            d = drafts[idx][..., None]
            p_d = p[:, :k].gather(-1, d)[..., 0]
            q_d = q.gather(-1, d)[..., 0]
            u = torch.stack([torch.rand(k, generator=gens[i], device=dev)
                             for i in hot])
            # u < min(1, p/q)  <=>  u * q < p  (u < 1: p >= q accepts)
            acc[idx] = u * q_d < p_d
    # leading-run length: drafts past the first rejection never count
    n_acc = (acc.long().cumprod(dim=1).sum(dim=1) if k > 0
             else torch.zeros(S, dtype=torch.long, device=dev))
    correction = tgt_arg.gather(1, n_acc[:, None])[:, 0]
    if hot:
        nh = n_acc[idx]
        rows = torch.arange(n, device=dev)
        p_j = p[rows, nh]  # [n, V]
        if k > 0:
            q_j = q[rows, nh.clamp(max=k - 1)]
            resid = (p_j - q_j).clamp_min(0.0)
            rs = resid.sum(-1, keepdim=True)
            # an empty residual at a rejection means p ~= q: the acceptance
            # probability was ~1, so sampling p is the limit
            resid = torch.where(rs > 1e-9, resid / rs.clamp_min(1e-30), p_j)
            corr = torch.where((nh < k)[:, None], resid, p_j)
        else:
            corr = p_j
        correction[idx] = torch.cat([
            torch.multinomial(corr[j], 1, generator=gens[i])
            for j, i in enumerate(hot)])
    pos = torch.arange(k1, device=dev)[None, :]
    drafts_wide = torch.cat(
        [drafts, drafts.new_zeros((S, 1))], dim=1)
    emit = torch.where(pos < n_acc[:, None], drafts_wide,
                       torch.full_like(drafts_wide, -1))
    emit = torch.where(pos == n_acc[:, None], correction[:, None], emit)
    return emit, n_acc


def spec_mask_emissions(emit, n_acc, live, remaining, eos, tok):
    """Clip one spec step's emissions to what each row may emit: only live
    rows emit, at most ``remaining`` tokens, and nothing after the first
    ``eos`` (the eos itself counts). Returns ``(out [S, k+1]`` with -1 past
    the clip, ``n_take [S]``, ``live2 [S]``, ``rem2 [S]``, ``feed [S]`` -
    the next token to feed, frozen for dead rows)."""
    S, k1 = emit.shape
    idx = torch.arange(k1, device=emit.device)[None, :]
    valid = ((idx <= n_acc[:, None]) & (idx < remaining[:, None])
             & live[:, None])
    is_eos = (eos >= 0)[:, None] & (emit == eos[:, None]) & valid
    eos_before = is_eos.long().cumsum(dim=1) - is_eos.long()
    valid = valid & (eos_before == 0)
    n_take = valid.sum(dim=1)
    out = torch.where(valid, emit, torch.full_like(emit, -1))
    hit_eos = (is_eos & valid).any(dim=1)
    rem2 = remaining - n_take
    live2 = live & ~hit_eos & (rem2 > 0)
    last = out.gather(1, (n_take - 1).clamp(0, k1 - 1)[:, None])[:, 0]
    feed = torch.where(live & (n_take > 0), last, tok)
    return out, n_take, live2, rem2, feed
