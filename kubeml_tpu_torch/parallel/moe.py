"""Mixture-of-Experts blocks, the port of ``kubeml_tpu/parallel/moe.py``.

Switch/GShard dense dispatch: tokens route top-k over the experts with a
per-expert capacity; dispatch and combine are products against one-hot
masks, and the expert weights carry a leading ``[E, ...]`` axis. The
port does not shard them over an ``ep`` axis yet (MoE ``ep``, ROADMAP
Queue 1 item 1; a MoE model over a mesh of several ranks raises), so
every product here is a plain
``torch.einsum`` / ``matmul``, as the JAX module's are outside any Pallas
kernel.

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
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Dropout, LayerNorm, make_generator

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
                 aux_loss_weight: float = 1e-2, router_noise: float = 1e-2):
        super().__init__()
        D, E, H = embed_dim, num_experts, embed_dim * mlp_ratio
        self.num_experts = E
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
        S = B * L
        tokens = x.reshape(S, D)
        # --- router (always f32: gate ordering must be stable) ---
        logits = tokens.float() @ self._weight("router").float()
        if train and self.router_noise > 0:
            if noise_seed is None:
                raise ValueError("MoE router noise in training needs rng "
                                 "(an int seed or a torch.Generator)")
            g = make_generator(noise_seed, logits.device)
            logits = logits + self.router_noise * torch.randn(
                logits.shape, generator=g, device=logits.device)
        gates = torch.softmax(logits, dim=-1)  # [S, E]
        w_in = self._weight("w_in").to(tokens.dtype)
        w_out = self._weight("w_out").to(tokens.dtype)
        if decode:
            return self._uncapped(tokens, gates, w_in, w_out).reshape(B, L, D)
        return self._capped(tokens, gates, w_in, w_out).reshape(B, L, D)

    def _uncapped(self, tokens, gates, w_in, w_out) -> torch.Tensor:
        """Serving: each token keeps the experts whose gate reaches its
        k-th largest, renormalised, and every expert runs on every token
        (the zeroed gates drop the rest), one expert after another - the
        JAX ``scan`` - so incremental decode equals a full decode forward."""
        kth = torch.topk(gates, self.top_k, dim=-1).values[:, -1:]
        keep = (gates >= kth).float() * gates
        keep = keep / keep.sum(-1, keepdim=True).clamp_min(1e-9)
        keep = keep.to(tokens.dtype)
        out = torch.zeros_like(tokens)
        for e in range(self.num_experts):
            h = F.gelu(tokens @ w_in[e], approximate="tanh")
            out = out + keep[:, e:e + 1] * (h @ w_out[e])
        return out

    def _capped(self, tokens, gates, w_in, w_out) -> torch.Tensor:
        """Top-k dispatch with capacity (GShard); records the aux loss and
        the overflow share in ``last_aux`` / ``last_overflow``."""
        S = tokens.shape[0]
        E = self.num_experts
        cap = self.capacity(S)
        dev = tokens.device
        combine = torch.zeros((S, E, cap), dtype=torch.float32, device=dev)
        used = torch.zeros((S, E), dtype=torch.float32, device=dev)
        enqueued = torch.zeros((E,), dtype=torch.float32, device=dev)
        for _ in range(self.top_k):
            g = gates * (1.0 - used)
            choice = torch.argmax(g, dim=-1)  # first index on ties
            onehot = _one_hot(choice, E)  # [S, E]
            # this round's rank in the chosen expert's queue, after what
            # earlier rounds enqueued
            pos = (torch.cumsum(onehot, dim=0) - 1.0 + enqueued[None, :]) \
                * onehot
            in_cap = (pos < cap).float() * onehot
            slot = _one_hot((pos * onehot).sum(-1).to(torch.int64), cap)
            gate_val = (gates * onehot).sum(-1, keepdim=True)  # [S, 1]
            combine = combine + (in_cap * gate_val)[:, :, None] \
                * slot[:, None, :]
            used = used + onehot
            enqueued = enqueued + onehot.sum(dim=0)
        # renormalise the kept gates so each token's routed mass sums to 1
        denom = combine.sum(dim=(1, 2), keepdim=True).clamp_min(1e-9)
        combine = combine / denom
        dispatch = (combine > 0.0).to(tokens.dtype)  # [S, E, cap]
        # the aux load-balancing loss (Switch eq. 4) and the share of
        # top-k assignments the capacity dropped
        frac_routed = dispatch.sum(dim=(0, 2)) / dispatch.sum().clamp_min(1.0)
        mean_gate = gates.mean(dim=0)
        aux = E * torch.sum(frac_routed.float() * mean_gate)
        self.last_aux = self.aux_loss_weight * aux
        asked = float(S * self.top_k)
        kept = dispatch.float().sum()
        self.last_overflow = (1.0 - kept / max(asked, 1.0)).detach()
        # the expert FFNs over [E, cap, D] per-expert batches
        expert_in = torch.einsum("sec,sd->ecd", dispatch, tokens)
        h = F.gelu(torch.einsum("ecd,edh->ech", expert_in, w_in),
                   approximate="tanh")
        expert_out = torch.einsum("ech,ehd->ecd", h, w_out)
        return torch.einsum("sec,ecd->sd", combine.to(tokens.dtype),
                            expert_out)


class MoEBlock(nn.Module):
    """Transformer block with the MLP replaced by routed experts. As the
    JAX block: LayerNorm epsilon 1e-6 and bias-free attention whatever the
    parent's ``ln_eps``/``attn_bias``, dropout on the attention output
    only."""

    def __init__(self, embed_dim: int, num_heads: int, num_experts: int = 8,
                 mlp_ratio: int = 4, top_k: int = 2,
                 capacity_factor: float = 1.25, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, rope: bool = False,
                 rope_theta: float = 10000.0):
        super().__init__()
        from ..models.gpt import CausalSelfAttention

        self.dtype = dtype
        self.drop = Dropout(dropout)
        self.ln1 = LayerNorm(embed_dim)
        self.attn = CausalSelfAttention(embed_dim, num_heads, dtype=dtype,
                                        rope=rope, rope_theta=rope_theta)
        self.ln2 = LayerNorm(embed_dim)
        self.moe = MoEMlp(embed_dim, num_experts, mlp_ratio, top_k,
                          capacity_factor)

    def forward(self, x, valid, decode: bool = False, positions=None,
                pages=None, seq_lens=None, cache=None, layer: int = 0,
                train: bool = False, dropout_seed=None):
        from ..models.layers import fold_in

        g = (make_generator(dropout_seed, x.device)
             if train and dropout_seed is not None
             and self.drop.rate > 0.0 else None)
        y = self.ln1(x).to(self.dtype)
        y = self.attn(y, valid, decode=decode, positions=positions,
                      pages=pages, seq_lens=seq_lens, cache=cache,
                      layer=layer)
        x = x + self.drop(y, train, g)
        y = self.ln2(x).to(self.dtype)
        noise = (fold_in(dropout_seed, _NOISE_FOLD)
                 if dropout_seed is not None else None)
        return x + self.moe(y, train=train, decode=decode, noise_seed=noise)


# fold_in datum of a block's router-noise seed (its dropout draws from the
# block seed itself)
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
