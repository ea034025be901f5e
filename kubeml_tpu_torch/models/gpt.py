"""Causal transformer LM, the port of ``kubeml_tpu/models/gpt.py``.

Ported: the non-cache forward (causal attention over the whole sequence,
learned or rotary positions) with its training options, and the PAGED
decode branch (:121-265) the serving engine drives. The dense per-row
cache decode, MoE interleaving, sequence parallelism (a mesh) and dropout
other than 0.0 are still to be ported (ROADMAP) and raise.

Training (:558-582): ``remat=True`` recomputes each block's forward in the
backward (``torch.utils.checkpoint``, non-reentrant) on the non-decode
path, the counterpart of Flax ``nn.remat``; the block names stay
``block_{i}``, so a remat model's Flax weights convert unchanged. The
non-cache attention goes through ``ops.attention.dot_product_attention``,
which takes the flash kernels on a CUDA tensor.

Layout and names follow the Flax module, so a Flax variables tree maps
onto ``state_dict`` names one for one (``interop.from_flax``): dense
kernels ``[in, out]``, ``token_embed.embedding``, ``pos_embed
[1, max_len, E]``, ``block_{i}.{ln1,attn,ln2,mlp_in,mlp_out}``, ``ln_f``,
``lm_head``. ``dtype`` is the computation dtype (parameters stay f32);
LayerNorm and the attention softmax run in f32 and logits return f32.

Two Flax defaults the port must match: ``nn.gelu`` is the tanh
approximation, and ``nn.LayerNorm`` uses epsilon 1e-6 unless told
otherwise (GPT-2 checkpoints use 1e-5, ``ln_eps``).

Paged decode (``decode=True`` with ``pages``/``positions``/``cache``): the
cache is one shared physical arena per layer, ``[kv_pages, page_tokens, H,
D]`` (``models.generation.init_paged_cache``), addressed through per-row
page tables ``pages [B, P]``. ``positions [B]`` is the logical position of
each row's first token this call, so L == 1 decode steps and L > 1 suffix
prefill share one code path. The arenas are updated IN PLACE (the JAX
module returns a new cache collection; here the engine owns one arena and
writes into it). Writes are coordinate scatters at (physical page,
offset); invalid positions - padding past ``seq_lens``, positions past the
table - go to physical page 0, the pool's reserved trash page, so a stale
row can never corrupt a reallocated page. Reads go through
``ops.paged_attention``: the CUDA kernel or the gather-then-attend plain
version, as the cache's ``paged_attn`` says.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dot_product_attention
from ..ops.paged_attention import paged_attention, paged_attention_ref
from ..ops.rotary import apply_rope
from ..utils.device import resolve_device
from .layers import QuantizableDense

PAD_ID = 0

# Flax lecun_normal: truncated normal on [-2, 2] std, rescaled so the
# truncated distribution keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(dtype=float32)``: params ``scale``/``bias``,
    statistics and output in f32."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias,
                            self.eps)


class Embed(nn.Module):
    """Flax ``nn.Embed``: param ``embedding [vocab, features]``."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]


class CausalSelfAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32, rope: bool = False,
                 rope_theta: float = 10000.0):
        super().__init__()
        self.num_heads = num_heads
        self.rope = rope
        self.rope_theta = rope_theta
        dense = lambda n: QuantizableDense(embed_dim, n, use_bias=use_bias,
                                           dtype=dtype)
        self.query = dense(embed_dim)
        self.key = dense(embed_dim)
        self.value = dense(embed_dim)
        self.proj = dense(embed_dim)

    def forward(self, x, valid, decode: bool = False, positions=None,
                pages=None, seq_lens=None, cache=None, layer: int = 0):
        B, L, E = x.shape
        H = self.num_heads
        D = E // H
        q = self.query(x).reshape(B, L, H, D)
        k = self.key(x).reshape(B, L, H, D)
        v = self.value(x).reshape(B, L, H, D)
        if decode:
            out = self._paged(q, k, v, valid, positions, pages, seq_lens,
                              cache, layer)
        else:
            if self.rope:
                pos = torch.arange(L, device=x.device)
                q = apply_rope(q, pos, self.rope_theta)
                k = apply_rope(k, pos, self.rope_theta)
            out = dot_product_attention(q, k, v, causal=True, kv_valid=valid)
        return self.proj(out.reshape(B, L, H * D))

    def _paged(self, q, k, v, valid, positions, pages, seq_lens, cache,
               layer):
        if pages is None or positions is None or cache is None:
            raise ValueError("decode needs pages, positions and a paged cache "
                             "(models.generation.init_paged_cache); the dense "
                             "cache decode is not ported yet")
        B, L, H, D = q.shape
        dev = q.device
        pt = cache.page_tokens
        tw = pages.shape[1]  # table width (logical pages per row)
        arena = cache.layers[layer]
        pos_full = positions.long()[:, None] + torch.arange(L, device=dev)
        if self.rope:
            q = apply_rope(q, pos_full, self.rope_theta)
            k = apply_rope(k, pos_full, self.rope_theta)
        wvalid = (torch.arange(L, device=dev)[None, :] < seq_lens[:, None]
                  if seq_lens is not None else valid.bool())
        # writes past the table go to the trash page, never clamped onto
        # the last logical page (that would scatter over live data)
        wvalid = wvalid & (pos_full < tw * pt)
        page_idx = (pos_full // pt).clamp(0, tw - 1)
        phys = torch.gather(pages.long(), 1, page_idx)  # [B, L]
        phys = torch.where(wvalid, phys, torch.zeros_like(phys))
        off = pos_full % pt
        if cache.kv_quant == "int8":
            _quant_write(arena["k_pages"], arena["k_scale"], k, phys, off)
            _quant_write(arena["v_pages"], arena["v_scale"], v, phys, off)
            scales = dict(k_scale=arena["k_scale"], v_scale=arena["v_scale"])
        else:
            arena["k_pages"][phys, off] = k.to(arena["k_pages"].dtype)
            arena["v_pages"][phys, off] = v.to(arena["v_pages"].dtype)
            scales = {}
        read = (paged_attention if cache.paged_attn == "cuda"
                else paged_attention_ref)
        return read(q, arena["k_pages"], arena["v_pages"], pages, positions,
                    **scales)


def _quant_write(arena, scales, x, phys, off) -> None:
    """int8 scatter write (the JAX ``_quant_write``), in place: (1)
    scatter-max this call's per-head absmax into the touched pages' scales
    (monotone); (2) requantize the touched pages' existing values for the
    scale growth; (3) quantize and scatter this call's values at the final
    scale. A page touched by several (row, position) pairs is requantized
    from the same old bytes with the same final scale by each of them, so
    the duplicate writes are byte-identical."""
    H = scales.shape[1]
    xf = x.float()
    amax = xf.abs().amax(dim=-1)  # [B, L, H]
    old_at = scales[phys]  # [B, L, H] (a copy)
    scales.scatter_reduce_(0, phys.reshape(-1, 1).expand(-1, H),
                           amax.reshape(-1, H), reduce="amax",
                           include_self=True)
    new_at = scales[phys]
    ratio = torch.where(new_at > 0.0, old_at / new_at.clamp_min(1e-30),
                        torch.ones_like(new_at))
    old_q = arena[phys].float()  # [B, L, pt, H, D]
    arena[phys] = torch.round(old_q * ratio[:, :, None, :, None]
                              ).clamp(-127, 127).to(torch.int8)
    qv = torch.round(xf * 127.0 / new_at.clamp_min(1e-30)[..., None]
                     ).clamp(-127, 127).to(torch.int8)
    arena[phys, off] = qv


class GPTBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32, ln_eps: float = 1e-6,
                 attn_bias: bool = False, rope: bool = False,
                 rope_theta: float = 10000.0):
        super().__init__()
        self.dtype = dtype
        self.ln1 = LayerNorm(embed_dim, ln_eps)
        self.attn = CausalSelfAttention(embed_dim, num_heads,
                                        use_bias=attn_bias, dtype=dtype,
                                        rope=rope, rope_theta=rope_theta)
        self.ln2 = LayerNorm(embed_dim, ln_eps)
        self.mlp_in = QuantizableDense(embed_dim, embed_dim * mlp_ratio,
                                       dtype=dtype)
        self.mlp_out = QuantizableDense(embed_dim * mlp_ratio, embed_dim,
                                        dtype=dtype)

    def forward(self, x, valid, decode: bool = False, positions=None,
                pages=None, seq_lens=None, cache=None, layer: int = 0):
        y = self.ln1(x).to(self.dtype)
        y = self.attn(y, valid, decode=decode, positions=positions,
                      pages=pages, seq_lens=seq_lens, cache=cache,
                      layer=layer)
        x = x + y
        y = self.ln2(x).to(self.dtype)
        y = F.gelu(self.mlp_in(y), approximate="tanh")  # Flax nn.gelu
        return x + self.mlp_out(y)


class CausalTransformer(nn.Module):
    """Decoder-only LM over integer token ids ``[B, L]``; id 0 = padding.

    Weights are initialised like the Flax module (normal(0.02) embeddings,
    lecun-normal kernels, zero biases) from a ``torch.Generator`` seeded
    with ``seed``, on the CPU, then moved to ``device`` (CUDA unless the
    caller passes another; see ``utils.device.resolve_device``)."""

    def __init__(self, vocab_size: int = 32000, max_len: int = 2048,
                 embed_dim: int = 512, depth: int = 8, num_heads: int = 8,
                 mlp_ratio: int = 4, dtype: torch.dtype = torch.float32,
                 ln_eps: float = 1e-6, attn_bias: bool = False,
                 pos: str = "learned", rope_theta: float = 10000.0,
                 remat: bool = False, dropout: float = 0.0,
                 moe_every: int = 0, mesh=None, seed: int = 0, device=None):
        super().__init__()
        if pos not in ("learned", "rope"):
            raise ValueError(f"unknown pos {pos!r} (valid: 'learned', 'rope')")
        if dropout != 0.0:
            raise NotImplementedError(
                "dropout > 0 is not ported yet (every JAX trainer of this "
                "path uses 0.0; dropout with an explicit generator is a "
                "ROADMAP item)")
        if moe_every > 0:
            raise NotImplementedError("MoE interleaving is not ported yet")
        if mesh is not None:
            raise NotImplementedError("the port runs on one card; a mesh "
                                      "(sharding over torch.distributed) is "
                                      "not ported yet")
        dev = resolve_device(device)
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.dtype = dtype
        self.pos = pos
        self.remat = remat
        self.dropout = dropout
        self.token_embed = Embed(vocab_size, embed_dim)
        if pos == "learned":
            self.pos_embed = nn.Parameter(torch.empty(1, max_len, embed_dim))
        for i in range(depth):
            self.add_module(f"block_{i}", GPTBlock(
                embed_dim, num_heads, mlp_ratio, dtype=dtype, ln_eps=ln_eps,
                attn_bias=attn_bias, rope=pos == "rope",
                rope_theta=rope_theta))
        self.ln_f = LayerNorm(embed_dim, ln_eps)
        self.lm_head = QuantizableDense(embed_dim, vocab_size, use_bias=False,
                                        dtype=dtype)
        self._init_weights(seed)
        self.to(dev)

    def _init_weights(self, seed: int) -> None:
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("embedding") or name == "pos_embed":
                    p.normal_(0.0, 0.02, generator=g)
                elif name.endswith("kernel"):
                    std = math.sqrt(1.0 / p.shape[0]) / _TRUNC_STD
                    nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                          generator=g)

    @property
    def device(self) -> torch.device:
        return self.token_embed.embedding.device

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.depth)]

    def forward(self, token_ids, train: bool = False, decode: bool = False,
                return_hidden: bool = False, positions=None, pages=None,
                seq_lens=None, cache=None):
        """Logits ``[B, L, vocab]`` (f32), or the final hidden states
        ``[B, L, E]`` with ``return_hidden``. ``decode=True`` runs the paged
        decode branch against ``cache`` (see the module docstring).
        ``train`` steers dropout in the JAX module; with dropout 0.0 (the
        only value ported) it changes nothing."""
        ids = token_ids.long()
        B, L = ids.shape
        dev = ids.device
        # decode trusts every input token as real (a sampled id 0 is a live
        # vocab token); the plain forward treats id 0 as padding
        valid = (torch.ones((B, L), dtype=torch.bool, device=dev) if decode
                 else ids != PAD_ID)
        x = self.token_embed(ids)
        if self.pos == "rope":
            x = x.to(self.dtype)
        elif decode:
            # per-row positions; the clip keeps bucket-padding rows whose
            # nominal positions run past the table in bounds (their output
            # is discarded)
            pos_full = (positions.long()[:, None]
                        + torch.arange(L, device=dev)).clamp(0,
                                                             self.max_len - 1)
            x = (x + self.pos_embed[0][pos_full]).to(self.dtype)
        else:
            x = (x + self.pos_embed[:, :L]).to(self.dtype)
        remat = self.remat and not decode and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks()):
            if remat:
                x = checkpoint(block, x, valid, use_reentrant=False)
            else:
                x = block(x, valid, decode=decode, positions=positions,
                          pages=pages, seq_lens=seq_lens, cache=cache,
                          layer=i)
        x = self.ln_f(x).to(self.dtype)
        if return_hidden:
            return x
        return self.lm_head(x).float()


def GPTTiny(vocab_size: int = 1000, max_len: int = 128,
            dtype: torch.dtype = torch.float32, seed: int = 0,
            device=None) -> CausalTransformer:
    """Test-sized config."""
    return CausalTransformer(vocab_size=vocab_size, max_len=max_len,
                             embed_dim=64, depth=2, num_heads=4, dtype=dtype,
                             seed=seed, device=device)


def GPTSmall(vocab_size: int = 32000, max_len: int = 2048,
             dtype: torch.dtype = torch.float32, attn_bias: bool = False,
             ln_eps: float = 1e-6, seed: int = 0,
             device=None) -> CausalTransformer:
    """GPT-2-small-ish (124M). GPT-2 itself is ``vocab_size=50257,
    max_len=1024, attn_bias=True, ln_eps=1e-5``."""
    return CausalTransformer(vocab_size=vocab_size, max_len=max_len,
                             embed_dim=768, depth=12, num_heads=12,
                             dtype=dtype, attn_bias=attn_bias, ln_eps=ln_eps,
                             seed=seed, device=device)
