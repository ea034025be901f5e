"""Mixture-of-Experts blocks, the port of ``kubeml_tpu/parallel/moe.py``.

Switch/GShard dense dispatch: tokens route top-k over the experts with a
per-expert capacity; dispatch and combine are products against one-hot
masks, and the expert weights carry a leading ``[E, ...]`` axis. Every
product here is a plain ``torch.einsum`` / ``matmul``, as the JAX
module's are outside any Pallas kernel.

Parameters keep the Flax names and layouts (``block_{i}.moe.router
[D, E]``, ``w_in [E, D, H]``, ``w_out [E, H, D]``), so a Flax tree loads
through ``interop.from_flax`` name for name.

Rules the port holds to the JAX code (not to its docstring):

* capacity is ``max(1, int((S / E) * capacity_factor))`` - a floor - with
  ``S = B * L`` counting pad tokens too;
* queue positions are the ``cumsum`` of the one-hot choices over the
  row-major ``[S]`` order plus what earlier top-k rounds enqueued; a
  position at or past the capacity drops the assignment and its one-hot
  slot row is all zeros (``jax.nn.one_hot`` of an out-of-range index);
* ``argmax`` ties break at the first index; the decode path keeps every
  expert whose gate reaches the k-th largest (``gates >= kth``), so a tie
  keeps more than ``top_k``;
* gradients flow through the gate values and the renormalising
  denominator only (the one-hots and ``dispatch = combine > 0`` carry
  none), and through the router's mean gate in the aux loss;
* the router runs in f32; the expert weights are cast to the token dtype.

Over a mesh of several ranks (JAX's ``MoEMlp`` under GSPMD, outside any
``shard_map``, so every rule above reads the GLOBAL batch):

* the expert stacks are sharded ``w_in ("ep", None, "tp")`` and ``w_out
  ("ep", "tp", None)``: a rank holds ``E / ep`` experts and ``H / tp`` of
  their hidden width; the router is whole on every rank;
* the tokens are the rank's ``P("dp", "sp")`` block, whole over ``ep``
  and ``tp``: every rank of an ``ep`` x ``tp`` group routes the same
  tokens over all ``E`` experts, runs its experts' slices, and the
  partial outputs are summed over ``ep`` x ``tp`` (``collectives.psum``);
* capacity comes from the global ``S``, and a token's queue position is
  its rank in the global row-major order (``b`` major, ``l`` minor): the
  rank gathers every rank's per-row, per-expert counts ``[B/dp, E]`` over
  ``dp`` x ``sp`` (``collectives.all_gather``) and offsets its own by
  the rows before its first row and, under ``sp``, by the earlier
  sequence blocks of each of its rows; no token moves. A rank's tokens
  fill their global slots of each expert's queue, the other ranks'
  slots are zero rows, whose FFN output is zero (no biases);
* the aux loss and the overflow share are global (their sums taken over
  ``dp`` x ``sp``), the same value on every rank;
* router noise is drawn for the global ``[S, E]`` and the rank's block
  taken, so a mesh changes no step.

Gradients over ``ep`` follow the ``tp`` rule (Megatron's f/g pair): a
rank's output uses its own experts' slices (and ``H / tp`` of their
width), so the gradients reaching the combine weights' gates and the
expert inputs are partial until summed over ``ep`` x ``tp``. The gates
enter the combine path, and the tokens the expert path, through
``collectives.copy_to`` over ``ep`` x ``tp``; the aux loss, computed whole
on every rank, reads the gates directly, so its gradient is counted
once. The router and every other leaf replicated over ``ep`` then hold
their whole gradient on every ``ep`` rank and each expert leaf its
slice's, and the trainer sums over ``dp`` x ``sp`` only. (An f on the
``[S, E, cap]`` combine tensor would carry the same gradient in many
times the bytes.)

Router noise (train only, ``router_noise`` x N(0, 1), on by default) is
drawn from an explicit generator seeded by the caller (``noise_seed``,
derived with ``layers.fold_in`` from the step's seed): JAX's threefry bits
cannot be reproduced, so the draws differ from JAX's while following its
rules.

Flax sows the aux loss and the capacity overflow into collections; here
each :class:`MoEMlp` keeps the values of its last capped forward in
``last_aux`` (the weighted aux loss, a tensor that carries gradients) and
``last_overflow``, which ``SPMDTrainer`` collects (:func:`moe_layers`) and
clears around each step. The decode path sets neither.

Decode over a serving mesh (JAX's ``BatchingDecoder(mesh=)`` on a MoE
model): the slab is whole on every rank, so every rank routes all its
tokens with the same f32 router and keeps the same experts a token; it
runs the experts it holds (``E / ep`` of them where the fit rule cut the
stacks over ``ep``, ``H / tp`` of their width where it cut them over
``tp``), and the partial outputs are summed over the axes that cut the
stacks, no others. Decode is uncapped, so no count is gathered over
``dp`` x ``sp``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Dropout, LayerNorm, make_generator
from .collectives import all_gather, all_reduce_, copy_to, psum
from .mesh import local_block

# the axes a MoE layer's tokens are sharded over, and those its experts'
# partial outputs are summed over
_TOKENS, _EXPERTS = ("dp", "sp"), ("ep", "tp")


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a row of zeros (``jax.nn.one_hot``'s rule;
    ``F.one_hot`` raises there)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


class MoEMlp(nn.Module):
    """Routed expert FFNs in place of a transformer MLP (``x [B, L, D]`` ->
    ``[B, L, D]``): top-``top_k`` gating over ``num_experts`` with a
    per-expert capacity in training and evaluation (overflowing tokens
    fall through the residual), uncapped routing in decode.

    The weights may be int8 (:meth:`set_quantized`, the serving engine's
    ``quantize="int8"`` for MoE): they then stay int8 on the device and
    each forward dequantizes them (``q * s`` in f32), as the JAX dense
    engine's in-program dequantize does."""

    def __init__(self, embed_dim: int, num_experts: int = 8,
                 mlp_ratio: int = 4, top_k: int = 2,
                 capacity_factor: float = 1.25,
                 aux_loss_weight: float = 1e-2, router_noise: float = 1e-2,
                 mesh=None):
        super().__init__()
        D, E, H = embed_dim, num_experts, embed_dim * mlp_ratio
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        if self.mesh is not None:
            for what, n, ax in (("num_experts", E, "ep"),
                                ("hidden width", H, "tp")):
                if n % self.mesh.shape.get(ax, 1):
                    raise ValueError(f"MoE {what} {n} does not divide over "
                                     f"{ax}={self.mesh.shape[ax]}")
        self.num_experts = E
        self.hidden = H
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.router_noise = router_noise
        self.router = nn.Parameter(torch.empty(D, E))
        self.w_in = nn.Parameter(torch.empty(E, D, H))
        self.w_out = nn.Parameter(torch.empty(E, H, D))
        self.last_aux: Optional[torch.Tensor] = None
        self.last_overflow: Optional[torch.Tensor] = None

    # --- int8 weights (serving) ---

    QUANT_LEAVES = ("router", "w_in", "w_out")

    def set_quantized(self, name: str, qt) -> None:
        """Hold leaf ``name`` as int8 values + per-channel scales (a
        ``serving.quant.QuantizedTensor``) instead of a dense parameter."""
        if name not in self.QUANT_LEAVES:
            raise KeyError(f"{name}: not a MoE weight")
        cur = self._weight(name)
        if tuple(qt.q.shape) != tuple(cur.shape) or qt.q.dtype != torch.int8:
            raise ValueError(f"{name}: quantized weight must be int8 "
                             f"{tuple(cur.shape)}, got {qt.q.dtype} "
                             f"{tuple(qt.q.shape)}")
        dev = cur.device
        setattr(self, name, None)
        self.register_buffer(f"{name}_q", qt.q.to(dev).contiguous())
        self.register_buffer(f"{name}_s", qt.s.to(dev, torch.float32)
                             .contiguous())

    @property
    def quantized(self) -> bool:
        return any(getattr(self, f"{n}_q", None) is not None
                   for n in self.QUANT_LEAVES)

    def _weight(self, name: str) -> torch.Tensor:
        q = getattr(self, f"{name}_q", None)
        if q is not None:
            # in-step dequantize: the same f32 values as
            # serving.quant.dequantize_tree(tree, torch.float32)
            return q.to(torch.float32) * getattr(self, f"{name}_s")
        return getattr(self, name)

    # --- forward ---

    def capacity(self, S: int) -> int:
        return max(1, int((S / self.num_experts) * self.capacity_factor))

    def forward(self, x: torch.Tensor, train: bool = False,
                decode: bool = False,
                noise_seed: Optional[int] = None) -> torch.Tensor:
        B, L, D = x.shape
        E = self.num_experts
        mesh = self.mesh
        tokens = x.reshape(B * L, D)
        # --- router (always f32: gate ordering must be stable) ---
        logits = tokens.float() @ self._weight("router").float()
        if train and self.router_noise > 0:
            if noise_seed is None:
                raise ValueError("MoE router noise in training needs rng "
                                 "(an int seed or a torch.Generator)")
            # drawn for the global [S, E], this rank's block kept
            g = make_generator(noise_seed, logits.device)
            Bg, Lg = self._global(B, L)
            noise = torch.randn((Bg * Lg, E), generator=g,
                                device=logits.device)
            logits = logits + self.router_noise * local_block(
                mesh, noise.reshape(Bg, Lg, E)).reshape(B * L, E)
        gates = torch.softmax(logits, dim=-1)  # [S, E]
        w_in = self._weight("w_in").to(tokens.dtype)
        w_out = self._weight("w_out").to(tokens.dtype)
        if decode:
            return self._uncapped(tokens, gates, w_in, w_out).reshape(B, L, D)
        return self._capped(tokens, gates, w_in, w_out, B, L).reshape(B, L, D)

    def _global(self, B: int, L: int):
        """The global (batch, length) of a rank's ``[B, L]`` block."""
        shape = {} if self.mesh is None else self.mesh.shape
        return B * shape.get("dp", 1), L * shape.get("sp", 1)

    def _uncapped(self, tokens, gates, w_in, w_out) -> torch.Tensor:
        """Serving: each token keeps the experts whose gate reaches its
        k-th largest, renormalised, and every expert runs on every token
        (the zeroed gates drop the rest), one expert after another - the
        JAX ``scan`` - so incremental decode equals a full decode forward.
        Over a mesh: this rank's experts and hidden columns, the partial
        outputs summed over the axes that cut them."""
        kth = torch.topk(gates, self.top_k, dim=-1).values[:, -1:]
        keep = (gates >= kth).float() * gates
        keep = keep / keep.sum(-1, keepdim=True).clamp_min(1e-9)
        keep = keep.to(tokens.dtype)
        n, width = w_in.shape[0], w_in.shape[-1]  # what this rank holds
        cut = [ax for ax, held, whole in (("ep", n, self.num_experts),
                                          ("tp", width, self.hidden))
               if held < whole]
        e0 = self.mesh.coord["ep"] * n if "ep" in cut else 0
        out = torch.zeros_like(tokens)
        for e in range(n):
            h = F.gelu(tokens @ w_in[e], approximate="tanh")
            out = out + keep[:, e0 + e:e0 + e + 1] * (h @ w_out[e])
        return psum(out, self.mesh, cut) if cut else out

    def _queue(self, onehot: torch.Tensor, B: int, L: int):
        """(each token's place in its chosen expert's global queue this
        round, ``[S, E]``, before what earlier rounds enqueued: the
        ``cumsum`` of the global row-major one-hots less one; the tokens
        each expert got this round over the global batch, ``[E]``). The
        rank's per-row counts are gathered over ``dp`` x ``sp``; a row's
        sequence blocks lie on the ``sp`` ranks in order."""
        mesh = self.mesh
        E = onehot.shape[-1]
        oh = onehot.reshape(B, L, E)
        counts = oh.sum(dim=1)  # [B, E] this rank's rows
        if mesh is None:
            every = counts[:, None]  # [B, 1, E]
            b0, s = 0, 0
        else:
            dp, sp = mesh.shape.get("dp", 1), mesh.shape.get("sp", 1)
            every = all_gather(counts[None], mesh, _TOKENS, 0).reshape(
                dp, sp, B, E).transpose(1, 2).reshape(dp * B, sp, E)
            b0, s = mesh.coord.get("dp", 0) * B, mesh.coord.get("sp", 0)
        rows = every.sum(dim=1)  # [Bg, E]
        before = (torch.cumsum(rows, dim=0) - rows)[b0:b0 + B] \
            + (torch.cumsum(every, dim=1) - every)[b0:b0 + B, s]
        pos = torch.cumsum(oh, dim=1) - 1.0 + before[:, None, :]
        return pos.reshape(B * L, E), rows.sum(dim=0)

    def _capped(self, tokens, gates, w_in, w_out, B: int, L: int
                ) -> torch.Tensor:
        """Top-k dispatch with capacity (GShard) into this rank's experts;
        records the aux loss and the overflow share in ``last_aux`` /
        ``last_overflow``."""
        mesh = self.mesh
        S = tokens.shape[0]
        E = self.num_experts
        Bg, Lg = self._global(B, L)
        cap = self.capacity(Bg * Lg)
        n = w_in.shape[0]  # this rank's experts
        e0 = 0 if mesh is None else mesh.coord.get("ep", 0) * n
        dev = tokens.device
        # the combine path's gradient is partial over ep x tp (f)
        gates_c = copy_to(gates, mesh, _EXPERTS)
        used = torch.zeros((S, E), dtype=torch.float32, device=dev)
        enqueued = torch.zeros((E,), dtype=torch.float32, device=dev)
        rounds = []  # (kept gate [S, E], slot [S]) of each round
        for _ in range(self.top_k):
            g = gates * (1.0 - used)
            choice = torch.argmax(g, dim=-1)  # first index on ties
            onehot = _one_hot(choice, E)  # [S, E]
            # this round's rank in the chosen expert's queue, after what
            # earlier rounds enqueued
            at, got = self._queue(onehot, B, L)
            pos = (at + enqueued[None, :]) * onehot
            in_cap = (pos < cap).float() * onehot
            slot = (pos * onehot).sum(-1).to(torch.int64)
            gate_val = (gates_c * onehot).sum(-1, keepdim=True)  # [S, 1]
            rounds.append((in_cap * gate_val, slot))
            used = used + onehot
            enqueued = enqueued + got
        # renormalise the kept gates so each token's routed mass sums to 1
        # (over all E experts: the sum of the JAX combine's [E, cap] slots)
        denom = sum(w.sum(-1) for w, _ in rounds).clamp_min(1e-9)
        combine = torch.zeros((S, n, cap), dtype=torch.float32, device=dev)
        for w, slot in rounds:
            combine = combine + w[:, e0:e0 + n, None] \
                * _one_hot(slot, cap)[:, None, :]
        combine = combine / denom[:, None, None]
        dispatch = (combine > 0.0).to(tokens.dtype)  # [S, n, cap]
        # the aux load-balancing loss (Switch eq. 4) and the share of
        # top-k assignments the capacity dropped, over the global batch
        kept = sum((w > 0.0).float().sum(dim=0) for w, _ in rounds)  # [E]
        kept = all_reduce_(kept.detach(), mesh, _TOKENS)
        # JAX sums the dispatch mask in the token dtype
        d = tokens.dtype
        frac_routed = (kept.to(d) / kept.sum().to(d).clamp_min(1.0)).float()
        mean_gate = psum(gates.sum(dim=0), mesh, _TOKENS) / (Bg * Lg)
        aux = E * torch.sum(frac_routed * mean_gate)
        self.last_aux = self.aux_loss_weight * aux
        asked = float(Bg * Lg * self.top_k)
        self.last_overflow = 1.0 - kept.sum() / max(asked, 1.0)
        # the expert FFNs over [n, cap, D] per-expert batches: this rank's
        # experts, their H / tp columns; partial outputs summed over ep x tp
        expert_in = torch.einsum("sec,sd->ecd", dispatch,
                                 copy_to(tokens, mesh, _EXPERTS))
        h = F.gelu(torch.einsum("ecd,edh->ech", expert_in, w_in),
                   approximate="tanh")
        expert_out = torch.einsum("ech,ehd->ecd", h, w_out)
        out = torch.einsum("sec,ecd->sd", combine.to(tokens.dtype),
                           expert_out)
        return psum(out, mesh, _EXPERTS)


class MoEBlock(nn.Module):
    """Transformer block with the MLP replaced by routed experts. As the
    JAX block: LayerNorm epsilon 1e-6 and bias-free attention whatever the
    parent's ``ln_eps``/``attn_bias``, dropout on the attention output
    only."""

    def __init__(self, embed_dim: int, num_heads: int, num_experts: int = 8,
                 mlp_ratio: int = 4, top_k: int = 2,
                 capacity_factor: float = 1.25, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, rope: bool = False,
                 rope_theta: float = 10000.0, mesh=None,
                 sp_impl: str = "ring"):
        super().__init__()
        from ..models.gpt import CausalSelfAttention

        self.dtype = dtype
        self.drop = Dropout(dropout)
        self.ln1 = LayerNorm(embed_dim)
        self.attn = CausalSelfAttention(embed_dim, num_heads, dtype=dtype,
                                        rope=rope, rope_theta=rope_theta,
                                        mesh=mesh, sp_impl=sp_impl)
        self.ln2 = LayerNorm(embed_dim)
        self.moe = MoEMlp(embed_dim, num_experts, mlp_ratio, top_k,
                          capacity_factor, mesh=mesh)

    def forward(self, x, valid, decode: bool = False, positions=None,
                pages=None, seq_lens=None, cache=None, layer: int = 0,
                train: bool = False, dropout_seed=None, noise_seed=None):
        """``dropout_seed`` seeds the attention output's dropout,
        ``noise_seed`` the router noise."""
        g = (make_generator(dropout_seed, x.device)
             if train and dropout_seed is not None
             and self.drop.rate > 0.0 else None)
        y = self.ln1(x).to(self.dtype)
        y = self.attn(y, valid, decode=decode, positions=positions,
                      pages=pages, seq_lens=seq_lens, cache=cache,
                      layer=layer)
        x = x + self.drop(y, train, g)
        y = self.ln2(x).to(self.dtype)
        return x + self.moe(y, train=train, decode=decode,
                            noise_seed=noise_seed)


# fold_in datum of a MoE block's router-noise seed, folded into the
# block's seed before any mesh coordinate (its dropout draws from the
# block's seed itself)
_NOISE_FOLD = 0x6E6F6973


def moe_layers(module: nn.Module) -> List[MoEMlp]:
    """Every :class:`MoEMlp` of ``module``, in registration order."""
    return [m for m in module.modules() if isinstance(m, MoEMlp)]


def MoETransformer(**kwargs):
    """Decoder-only LM with MoE MLPs every ``moe_every`` blocks (default
    2): a configuration of ``models.gpt.CausalTransformer``."""
    from ..models.gpt import CausalTransformer

    kwargs.setdefault("moe_every", 2)
    return CausalTransformer(**kwargs)


def MoETiny(vocab_size: int = 1000, max_len: int = 64, num_experts: int = 4,
            mesh=None, seed: int = 0, device=None):
    """Test-sized MoE config."""
    return MoETransformer(vocab_size=vocab_size, max_len=max_len,
                          embed_dim=64, depth=2, num_heads=4,
                          num_experts=num_experts, moe_every=2, mesh=mesh,
                          seed=seed, device=device)
