"""Causal transformer LM, the port of ``kubeml_tpu/models/gpt.py``.

Ported: the non-cache forward (causal attention over the whole sequence,
learned or rotary positions) with its training options, dropout included;
the PAGED decode branch (:121-265) the paged serving engine drives; the
DENSE KV-cache decode branches (:266-323, :499-525) of ``generate`` and
the dense slot engine; and MoE interleaving (``moe_every``: block ``i`` is
a ``parallel.moe.MoEBlock`` when ``(i + 1) % moe_every == 0``, never
rematerialised, and without a paged or early-exit path, as in JAX).

Tensor and sequence parallelism (JAX :38-356, :395-408, :491-595): built
with a ``mesh`` of several ranks (``parallel.mesh.make_mesh`` over the
process group), the model holds this rank's shards, cut from the full
weights its ``seed`` draws, by :func:`partition_spec` (JAX's ``_part``
specs): the query/key/value kernels' columns (= heads), ``proj``'s rows,
``mlp_in``'s columns and bias, ``mlp_out``'s rows, the embeddings' width
E and ``lm_head``'s vocabulary over ``tp``; LayerNorms and the biases of
row-parallel layers stay whole. Its forward takes this rank's
``[B/dp, L/sp]`` block of token ids and equals the unsharded model: the
local E columns of the embeddings are gathered over ``tp``, a
column-parallel input enters through ``collectives.copy_to`` (Megatron's
f), row-parallel partial outputs are summed by ``collectives.psum``
before their replicated bias, and the vocabulary-sharded logits are
gathered (``[B/dp, L/sp, vocab]``). Under ``sp`` the rank's positions are
``[coord_sp * L/sp, (coord_sp + 1) * L/sp)``, which ``pos_embed`` and
RoPE use, and attention is ``parallel.ring`` or ``parallel.ulysses``
(``sp_impl``); with ``sp == 1`` it is ``dot_product_attention`` over the
rank's heads (the flash kernels on the card). A MoE block's expert
stacks are sharded over ``ep`` x ``tp`` (``parallel.moe``, JAX :415-556):
its attention is the dense block's, its routing reads the global batch.
A mesh of one device only places the model.

Meshed serving (JAX ``serving/batcher.py`` ``BatchingDecoder(mesh=)``):
on a serving mesh (``parallel.mesh.serving_mesh``; a model built whole
is put on it by :func:`place_on_mesh`) every leaf is cut by the fit rule,
so a vocabulary that does not divide over ``tp`` keeps ``lm_head`` whole
and its logits need no gather, and the dense decode runs over ``tp``
with ``H / tp`` heads of KV cache a rank (``models.generation.
init_cache``); ranks over ``dp`` (and ``ep`` for a dense model) compute
the whole model each. A quantized projection's partial product takes
its int8 route (the CUDA kernel on the card) before the ``psum``. Decode
under ``sp`` raises, as in JAX, and the paged path under a mesh of
several ranks raises too (JAX's paged engine refuses a mesh).

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

Dense decode (``decode=True`` without ``pages``, ``cache`` a
``models.generation.DenseCache``): per layer ``k``/``v`` ``[B, Lc, H, D]``
in the compute dtype and ``valid [B, Lc]``, and one cursor ``index``.
Without ``positions`` the call writes its L tokens at the cursor and
advances it (prefill, and the one-shot generate's steps); with per-row
``positions [B]`` (L == 1, the slot engine) each row writes at its own
position. Attention runs over the whole cache under a dense mask (written
and valid slots at or before the query's position), so it takes the plain
path, as JAX's XLA path does. The cache is updated in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dot_product_attention
from ..ops.paged_attention import paged_attention, paged_attention_ref
from ..ops.rotary import apply_rope
from ..parallel.collectives import all_gather, copy_to, psum
from ..parallel.mesh import check_mesh
from ..utils.device import resolve_device
from .layers import (Dropout, Embed, LayerNorm, QuantizableDense,
                     fold_in, lecun_normal_, make_generator, seed_of)

PAD_ID = 0



def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get("tp", 1)


def _seq_offset(mesh, L: int) -> int:
    """The global position of this rank's first token under ``sp``."""
    return 0 if mesh is None else mesh.coord.get("sp", 0) * L


def _col_bias(dense, x, mesh):
    """A column-parallel layer whose bias is whole on every rank (the
    attention's query/key/value: JAX leaves their bias unpartitioned):
    this rank's slice of the bias, entering through ``copy_to`` so its
    gradient is the sum of every rank's slice. The product takes the
    layer's int8 route when it is quantized."""
    if dense.bias is None or _tp(mesh) == 1:
        return dense(x)
    y = dense.matmul(x)
    n = y.shape[-1]
    b = copy_to(dense.bias, mesh, "tp").narrow(0, mesh.coord["tp"] * n, n)
    return y + b.to(y.dtype)


def _row(dense, x, mesh):
    """A row-parallel layer: the partial products (through the layer's
    int8 route when it is quantized) summed over ``tp``, then the whole
    bias."""
    if _tp(mesh) == 1:
        return dense(x)
    y = psum(dense.matmul(x), mesh, "tp")
    return y if dense.bias is None else y + dense.bias.to(y.dtype)


# JAX's ``_part`` specs (kubeml_tpu/models/gpt.py :99, :402-407, :491-494,
# :595; kubeml_tpu/parallel/moe.py :69-74 for the expert stacks) by
# parameter name; every other parameter (the MoE router too) is whole
_TP_SPECS = (
    (".attn.query.kernel", (None, "tp")),
    (".attn.key.kernel", (None, "tp")),
    (".attn.value.kernel", (None, "tp")),
    (".attn.proj.kernel", ("tp", None)),
    (".mlp_in.kernel", (None, "tp")),
    (".mlp_in.bias", ("tp",)),
    (".mlp_out.kernel", ("tp", None)),
    ("token_embed.embedding", (None, "tp")),
    ("pos_embed", (None, None, "tp")),
    ("lm_head.kernel", (None, "tp")),
    (".moe.w_in", ("ep", None, "tp")),
    (".moe.w_out", ("ep", "tp", None)),
)


def partition_spec(name: str, ndim: int) -> tuple:
    """The mesh axis of each dim of the parameter ``name`` (None: whole),
    as ``flax.linen.get_partition_spec`` gives it for the JAX module. A
    pipelined model's stacked stage leaf (``stages.layer_{j}.<leaf>``,
    ``models.gpt_pipeline``) has ``pp`` on its leading stage axis, then
    its block leaf's spec (JAX's ``nn.vmap`` with ``metadata_params``)."""
    if name.startswith("stages."):
        return ("pp",) + partition_spec(name[len("stages."):], ndim - 1)
    for suffix, spec in _TP_SPECS:
        if name == suffix or name.endswith(suffix):
            return spec
    return (None,) * ndim


def init_weights_(module: nn.Module, seed: int) -> None:
    """Initialise ``module``'s parameters as the Flax module does, in
    their order, from a ``torch.Generator`` seeded with ``seed``:
    normal(0.02) embeddings and ``pos_embed``, lecun-normal kernels (the
    fan-in their second-to-last dim, so a stage-stacked ``[S, in, out]``
    kernel is drawn as ``S`` kernels), MoE weights lecun-normal with every
    axis but the last as fan-in (Flax's rule for an n-d kernel); every
    other leaf keeps its value (unit scales, zero biases)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(("embedding", "pos_embed")):
                p.normal_(0.0, 0.02, generator=g)
            elif name.endswith("kernel"):
                lecun_normal_(p, p.shape[-2], g)
            elif name.endswith((".router", ".w_in", ".w_out")):
                lecun_normal_(p, p.numel() // p.shape[-1], g)


class CausalSelfAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32, rope: bool = False,
                 rope_theta: float = 10000.0, mesh=None,
                 sp_impl: str = "ring"):
        super().__init__()
        self.num_heads = num_heads
        self.rope = rope
        self.rope_theta = rope_theta
        self.mesh = mesh  # a mesh of several ranks, or None
        self.sp_impl = sp_impl
        dense = lambda n: QuantizableDense(embed_dim, n, use_bias=use_bias,
                                           dtype=dtype)
        self.query = dense(embed_dim)
        self.key = dense(embed_dim)
        self.value = dense(embed_dim)
        self.proj = dense(embed_dim)

    def forward(self, x, valid, decode: bool = False, positions=None,
                pages=None, seq_lens=None, cache=None, layer: int = 0):
        B, L, E = x.shape
        mesh = self.mesh
        D = E // self.num_heads
        H = self.num_heads // _tp(mesh)  # this rank's heads
        x = copy_to(x, mesh, "tp")
        q = _col_bias(self.query, x, mesh).reshape(B, L, H, D)
        k = _col_bias(self.key, x, mesh).reshape(B, L, H, D)
        v = _col_bias(self.value, x, mesh).reshape(B, L, H, D)
        if decode and pages is not None:
            out = self._paged(q, k, v, valid, positions, pages, seq_lens,
                              cache, layer)
        elif decode:
            out = self._dense(q, k, v, valid, positions, cache, layer)
        else:
            if self.rope:
                pos = _seq_offset(mesh, L) + torch.arange(L, device=x.device)
                q = apply_rope(q, pos, self.rope_theta)
                k = apply_rope(k, pos, self.rope_theta)
            if mesh is not None and mesh.shape.get("sp", 1) > 1:
                if self.sp_impl == "ulysses":
                    from ..parallel.ulysses import ulysses_attention as sp_fn
                else:
                    from ..parallel.ring import ring_attention as sp_fn
                out = sp_fn(q, k, v, mesh, "sp", causal=True, kv_valid=valid)
            else:
                out = dot_product_attention(q, k, v, causal=True,
                                            kv_valid=valid)
        return _row(self.proj, out.reshape(B, L, H * D), mesh)

    def _dense(self, q, k, v, valid, positions, cache, layer):
        """Dense KV-cache decode (JAX :266-323): write this call's K/V into
        the layer's stripes, attend over the whole cache."""
        if cache is None or not hasattr(cache, "index"):
            raise ValueError("dense decode needs a DenseCache "
                             "(models.generation.init_cache)")
        B, L, H, D = q.shape
        dev = q.device
        arena = cache.layers[layer]
        ck, cv, cvalid = arena["k"], arena["v"], arena["valid"]
        Lc = ck.shape[1]
        k_pos = torch.arange(Lc, device=dev)[None, None, None, :]
        if positions is not None:
            # per-row cursors (the slot engine): one token a row, written
            # at (row, positions[row])
            if L != 1:
                raise ValueError("per-row positions decode is one token "
                                 "per step (L == 1); prefill uses the "
                                 "scalar-cursor path")
            pos = positions.long()
            if self.rope:
                q = apply_rope(q, pos[:, None], self.rope_theta)
                k = apply_rope(k, pos[:, None], self.rope_theta)
            rows = torch.arange(B, device=dev)
            ck[rows, pos] = k[:, 0].to(ck.dtype)
            cv[rows, pos] = v[:, 0].to(cv.dtype)
            cvalid[rows, pos] = valid[:, 0].bool()
            mask = cvalid[:, None, None, :] & (
                k_pos <= pos[:, None, None, None])
            return dot_product_attention(q, ck, cv, mask=mask)
        i0 = int(cache.index)
        if self.rope:
            # keys are cached already rotated by their absolute position
            pos = i0 + torch.arange(L, device=dev)
            q = apply_rope(q, pos, self.rope_theta)
            k = apply_rope(k, pos, self.rope_theta)
        # dynamic_update_slice clamps the start so the update fits
        w0 = max(0, min(i0, Lc - L))
        ck[:, w0:w0 + L] = k.to(ck.dtype)
        cv[:, w0:w0 + L] = v.to(cv.dtype)
        cvalid[:, w0:w0 + L] = valid.bool()
        q_pos = (i0 + torch.arange(L, device=dev))[None, None, :, None]
        mask = cvalid[:, None, None, :] & (k_pos <= q_pos)
        return dot_product_attention(q, ck, cv, mask=mask)

    def _paged(self, q, k, v, valid, positions, pages, seq_lens, cache,
               layer):
        if positions is None or cache is None:
            raise ValueError("paged decode needs positions and a paged "
                             "cache (models.generation.init_paged_cache)")
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
                 rope_theta: float = 10000.0, dropout: float = 0.0,
                 mesh=None, sp_impl: str = "ring"):
        super().__init__()
        self.dtype = dtype
        self.mesh = mesh  # a mesh of several ranks, or None
        self.drop = Dropout(dropout)
        self.ln1 = LayerNorm(embed_dim, ln_eps)
        self.attn = CausalSelfAttention(embed_dim, num_heads,
                                        use_bias=attn_bias, dtype=dtype,
                                        rope=rope, rope_theta=rope_theta,
                                        mesh=mesh, sp_impl=sp_impl)
        self.ln2 = LayerNorm(embed_dim, ln_eps)
        self.mlp_in = QuantizableDense(embed_dim, embed_dim * mlp_ratio,
                                       dtype=dtype)
        self.mlp_out = QuantizableDense(embed_dim * mlp_ratio, embed_dim,
                                        dtype=dtype)

    def forward(self, x, valid, decode: bool = False, positions=None,
                pages=None, seq_lens=None, cache=None, layer: int = 0,
                train: bool = False, dropout_seed=None):
        # the masks come from a generator made here from the block's own
        # seed, so a checkpointed block's recompute draws the same masks
        # (torch.utils.checkpoint replays the global RNG, not a generator)
        g = (make_generator(dropout_seed, x.device)
             if train and dropout_seed is not None else None)
        y = self.ln1(x).to(self.dtype)
        y = self.attn(y, valid, decode=decode, positions=positions,
                      pages=pages, seq_lens=seq_lens, cache=cache,
                      layer=layer)
        x = x + self.drop(y, train, g)
        y = self.ln2(x).to(self.dtype)
        y = copy_to(y, self.mesh, "tp")
        y = F.gelu(self.mlp_in(y), approximate="tanh")  # Flax nn.gelu
        return x + self.drop(_row(self.mlp_out, y, self.mesh), train, g)


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
                 moe_every: int = 0, num_experts: int = 8, top_k: int = 2,
                 moe_capacity: float = 1.25, mesh=None,
                 sp_impl: str = "ring", seed: int = 0, device=None):
        super().__init__()
        if pos not in ("learned", "rope"):
            raise ValueError(f"unknown pos {pos!r} (valid: 'learned', 'rope')")
        if sp_impl not in ("ring", "ulysses"):
            raise ValueError(f"unknown sp_impl {sp_impl!r} (valid: 'ring', "
                             f"'ulysses')")
        # the device of this rank on the mesh; a mesh of one device only
        # places the model, one of several ranks shards it
        mesh_dev = check_mesh(mesh)
        dev = resolve_device(device if device is not None or mesh_dev is None
                             else mesh_dev)
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        if self.mesh is not None:
            # a serving mesh keeps a vocabulary that does not divide whole
            _check_tp(self.mesh, num_heads, embed_dim,
                      None if self.mesh.serving else vocab_size)
        self.sp_impl = sp_impl
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.dtype = dtype
        self.ln_eps = ln_eps
        self.attn_bias = attn_bias
        self.pos = pos
        self.remat = remat
        self.dropout = dropout
        self.moe_every = moe_every
        self.num_experts = num_experts
        self.top_k = top_k
        self.moe_capacity = moe_capacity
        self.token_embed = Embed(vocab_size, embed_dim)
        if pos == "learned":
            self.pos_embed = nn.Parameter(torch.empty(1, max_len, embed_dim))
        for i in range(depth):
            if moe_every > 0 and (i + 1) % moe_every == 0:
                from ..parallel.moe import MoEBlock  # imports this module

                block = MoEBlock(embed_dim, num_heads, num_experts,
                                 mlp_ratio, top_k, moe_capacity, dropout,
                                 dtype=dtype, rope=pos == "rope",
                                 rope_theta=rope_theta, mesh=self.mesh,
                                 sp_impl=sp_impl)
            else:
                block = GPTBlock(
                    embed_dim, num_heads, mlp_ratio, dtype=dtype,
                    ln_eps=ln_eps, attn_bias=attn_bias, rope=pos == "rope",
                    rope_theta=rope_theta, dropout=dropout, mesh=self.mesh,
                    sp_impl=sp_impl)
            self.add_module(f"block_{i}", block)
        self.ln_f = LayerNorm(embed_dim, ln_eps)
        self.lm_head = QuantizableDense(embed_dim, vocab_size, use_bias=False,
                                        dtype=dtype)
        init_weights_(self, seed)
        # each parameter's mesh axis a dim, on the whole shapes (the int8
        # quantizer reads them: serving.quant.quantize_tree)
        self.mesh_specs = None
        if self.mesh is not None:
            _cut(self, self.mesh)
        self.to(dev)

    def partition_specs(self):
        """``{parameter name: partition_spec}`` over every parameter."""
        return {name: partition_spec(name, p.dim())
                for name, p in self.named_parameters()}

    @property
    def device(self) -> torch.device:
        return self.token_embed.embedding.device

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.depth)]

    def forward(self, token_ids, train: bool = False, decode: bool = False,
                return_hidden: bool = False, positions=None, pages=None,
                seq_lens=None, cache=None, exit_layer=None, rng=None):
        """Logits ``[B, L, vocab]`` (f32), or the final hidden states
        ``[B, L, E]`` with ``return_hidden``. ``decode=True`` runs the paged
        decode branch against ``cache`` when given ``pages``, else the
        dense one (see the module docstring).

        ``train=True`` with ``dropout > 0`` drops the attention and MLP
        outputs of every block (where the JAX module does); ``rng`` (an
        int seed or a ``torch.Generator``, required then) gives block i
        the seed ``fold_in(seed_of(rng), i)``, from which the block draws
        its masks.

        ``exit_layer`` (an int in [1, depth]) runs only the first
        ``exit_layer`` blocks, then ``ln_f`` and ``lm_head``: the early-exit
        head of self-drafting speculative decoding. The arenas of the
        layers it skips stay as they are, so a truncated drafter forward
        and the full verify forward share one paged cache: the drafter
        writes layers < ``exit_layer``, the verify rewrites them and fills
        the rest."""
        if exit_layer is not None and not 1 <= int(exit_layer) <= self.depth:
            raise ValueError(f"exit_layer must be in [1, depth={self.depth}]"
                             f", got {exit_layer}")
        if exit_layer is not None and self.moe_every > 0:
            raise ValueError("early-exit drafting does not cover "
                             "MoE-interleaved models")
        if pages is not None and self.moe_every > 0:
            raise ValueError("paged decode does not cover MoE-interleaved "
                             "models; serve them through the dense cache")
        mesh = self.mesh
        if mesh is not None and (decode or pages is not None):
            if mesh.shape.get("sp", 1) > 1:
                raise ValueError("decode does not run under sequence "
                                 "parallelism; use an sp=1 mesh for serving")
            if pages is not None:
                raise ValueError(f"paged decode does not run over a mesh "
                                 f"({mesh.shape}); serve a mesh through the "
                                 f"dense cache")
        run_depth = self.depth if exit_layer is None else int(exit_layer)
        ids = token_ids.long()
        B, L = ids.shape
        dev = ids.device
        # the dense cache's shared cursor: this call writes at i0 and
        # advances it after the last block
        cursor = (int(cache.index) if decode and pages is None
                  and positions is None else None)
        # decode trusts every input token as real (a sampled id 0 is a live
        # vocab token); the plain forward treats id 0 as padding
        valid = (torch.ones((B, L), dtype=torch.bool, device=dev) if decode
                 else ids != PAD_ID)
        x = self.token_embed(ids)  # this rank's E columns under tp
        if self.pos != "rope":  # rope: positions enter inside attention
            if cursor is not None:
                # the scalar cursor: dynamic_slice clamps the start in
                # bounds
                s0 = max(0, min(cursor, self.max_len - L))
                x = x + self.pos_embed[:, s0:s0 + L]
            elif decode:
                # per-row positions; the clip keeps bucket-padding rows
                # whose nominal positions run past the table in bounds
                # (their output is discarded)
                pos_full = (positions.long()[:, None]
                            + torch.arange(L, device=dev)).clamp(
                                0, self.max_len - 1)
                x = x + self.pos_embed[0][pos_full]
            else:  # this rank's positions under sp
                off = _seq_offset(mesh, L)
                x = x + self.pos_embed[:, off:off + L]
        x = all_gather(x, mesh, "tp", dim=-1).to(self.dtype)
        seed = None
        if train and self.dropout > 0.0:
            if rng is None:
                raise ValueError(f"dropout {self.dropout} in training needs "
                                 f"rng (an int seed or a torch.Generator)")
            seed = seed_of(rng)
        elif train and rng is not None and self.moe_every > 0:
            seed = seed_of(rng)  # the MoE router noise draws from it
        # the router noise is drawn for the global batch, from the seed
        # itself on every rank
        noise = seed
        if seed is not None and mesh is not None:
            # each dp x sp block draws its own masks; tp ranks the same
            seed = fold_in(seed, mesh.coord.get("dp", 0)
                           * mesh.shape.get("sp", 1) + mesh.coord.get("sp", 0))
        remat = self.remat and not decode and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks()[:run_depth]):
            moe = not isinstance(block, GPTBlock)
            drop = dict(train=train, dropout_seed=(
                None if seed is None or self.dropout == 0.0
                else fold_in(seed, i)))
            if moe and noise is not None:
                from ..parallel.moe import _NOISE_FOLD

                drop["noise_seed"] = fold_in(fold_in(noise, i), _NOISE_FOLD)
            if remat and not moe:  # MoE blocks are never rematerialised
                x = checkpoint(block, x, valid, use_reentrant=False, **drop)
            else:
                x = block(x, valid, decode=decode, positions=positions,
                          pages=pages, seq_lens=seq_lens, cache=cache,
                          layer=i, **drop)
        if cursor is not None:
            cache.index = cursor + L
        x = self.ln_f(x).to(self.dtype)
        if return_hidden:
            return x
        return self.logits(x)

    def logits(self, hidden):
        """f32 logits ``[..., vocab]`` of final hidden states: ``lm_head``
        over this rank's vocabulary columns gathered over ``tp``, or
        ``lm_head`` whole where the fit rule kept it whole."""
        mesh = self.mesh
        if self.lm_head.features == self.vocab_size:
            return self.lm_head(hidden).float()
        logits = self.lm_head(copy_to(hidden, mesh, "tp"))
        return all_gather(logits, mesh, "tp", dim=-1).float()


def _check_tp(mesh, num_heads: int, embed_dim: int,
              vocab_size=None) -> None:
    """The dims tensor parallelism cuts always (heads, width), and the
    vocabulary where given, must divide over ``tp``."""
    tp = _tp(mesh)
    for what, n in (("num_heads", num_heads), ("embed_dim", embed_dim),
                    ("vocab_size", vocab_size)):
        if n is not None and n % tp:
            raise ValueError(f"{what} {n} does not divide over tp={tp}")


def place_on_mesh(module: CausalTransformer, mesh) -> CausalTransformer:
    """Put a model built whole onto a serving mesh, in place: each layer
    computes over ``mesh`` and every parameter keeps this rank's block by
    the fit rule (``interop.from_flax.leaf_block``), so loading a rank's
    shard tree (``shard_tree``, or a sharded restore onto the mesh)
    follows. The model must be dense (quantize after placing:
    ``serving.quant.quantize_tree`` reduces the scales over the mesh)."""
    if not isinstance(module, CausalTransformer):
        raise TypeError(f"{type(module).__name__} does not serve over a "
                        f"mesh (a CausalTransformer does)")
    if not getattr(mesh, "serving", False) or not mesh.distributed:
        raise ValueError("place_on_mesh takes a serving mesh of several "
                         "ranks (parallel.mesh.serving_mesh)")
    if module.mesh is not None:
        raise ValueError(f"the model is on a mesh already ({module.mesh.shape})")
    if any(getattr(m, "quantized", False) for m in module.modules()):
        raise ValueError("place a dense model on the mesh, then quantize it")
    _check_tp(mesh, module.num_heads, module.embed_dim)
    for m in module.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh
    return _cut(module, mesh)


def _cut(module: CausalTransformer, mesh) -> CausalTransformer:
    """Keep this rank's block of every parameter of a model built whole,
    and record each parameter's mesh axes (``mesh_specs``)."""
    from ..interop.from_flax import leaf_spec, shard_module  # imports serving

    module.mesh_specs = {name: leaf_spec(name, p.shape, mesh)
                         for name, p in module.named_parameters()}
    return shard_module(module, mesh)


def GPTTiny(vocab_size: int = 1000, max_len: int = 128,
            dtype: torch.dtype = torch.float32, seed: int = 0,
            device=None, mesh=None) -> CausalTransformer:
    """Test-sized config."""
    return CausalTransformer(vocab_size=vocab_size, max_len=max_len,
                             embed_dim=64, depth=2, num_heads=4, dtype=dtype,
                             mesh=mesh, seed=seed, device=device)


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
