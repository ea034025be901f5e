"""Pipeline parallelism over the ``pp`` mesh axis (the GPipe schedule),
the port of ``kubeml_tpu/parallel/pipeline.py``.

The transformer stack is split into stages of identical structure whose
parameters are stacked on a leading ``[S, ...]`` axis, sharded over the
``pp`` ranks of a mesh (``parallel.mesh.make_mesh`` over the process
group). :func:`schedule` runs the GPipe schedule over those ranks: every
rank applies its stages on every tick, activations hop stage to stage
through ``collectives.ppermute``, and microbatches stream through to fill
the pipe (``T = M + S - 1`` ticks, a bubble share of ``(S - 1) / T``).
Autograd replays the schedule in reverse: each ``ppermute``'s backward
sends the gradient one stage back.

Every rank must make the same collectives in the same order, in the
forward and in the backward, so every tick's output on every rank stays
in the graph, as every tick stays in the VJP of JAX's ``lax.scan``:

* the port's ``ppermute`` is a ring, so the last stage's output reaches
  the first stage's rank, which injects a microbatch instead; every rank
  takes its input through :class:`_Select`, which passes the microbatch
  (stage 0) or the received activation on and gives the other a zero
  gradient;
* the outputs of the last tick that no stage collects enter the result
  through :class:`_Tie` with a zero gradient.

So each rank runs the backward of every tick, bubbles included, as JAX
does; the flash launches of a step follow from the schedule alone.

The gradient rule (the same as tensor parallelism's): the microbatches
enter through ``collectives.copy_to`` over ``pp`` (Megatron's f: its
backward sums the input gradient over the stages, only the first of which
is nonzero), and the last stage's outputs leave through ``collectives.
psum`` over ``pp`` (g: the others add zeros), so every ``pp`` rank holds
the same outputs and computes the same loss, and the leaves replicated
over ``pp`` (the embeddings, the final norm, the head) hold their whole
gradient on every rank. The stage stack is sharded over ``pp`` and gets
no ``pp`` sum: a trainer sums gradients over ``dp`` (and ``sp``) only.

:class:`PipelinedLM` is the JAX module's decoder-only LM (embedding and
head replicated, the block stack pipelined) and :class:`PipelineTrainer`
its training loop (AdamW and ``lm_loss``, an
:class:`~kubeml_tpu_torch.parallel.trainer.SPMDTrainer` over its mesh).
``models.gpt_pipeline.PipelinedCausalLM`` runs :func:`schedule` with the
``CausalTransformer`` blocks and the SPMD engine's trainer.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models.layers import Embed, LayerNorm, QuantizableDense
from ..ops.attention import dot_product_attention
from ..utils.device import resolve_device
from .collectives import copy_to, ppermute, psum
from .mesh import check_mesh
from .trainer import SPMDTrainer, adamw

def _zeros(meta):
    shape, dtype, device = meta
    return torch.zeros(shape, dtype=dtype, device=device)


def _meta(t: torch.Tensor):
    return t.shape, t.dtype, t.device


class _Select(torch.autograd.Function):
    """``a if take else b``; the input not taken gets a zero gradient, so
    both stay in the graph (JAX's ``jnp.where`` over a tick's input)."""

    @staticmethod
    def forward(ctx, take: bool, a, b):
        ctx.take = take
        ctx.metas = (_meta(a), _meta(b))
        return (a if take else b).view_as(a if take else b)

    @staticmethod
    def backward(ctx, g):
        if ctx.take:
            return None, g, _zeros(ctx.metas[1])
        return None, _zeros(ctx.metas[0]), g


class _Tie(torch.autograd.Function):
    """``x``, with ``dead`` (outputs nothing reads) in the graph at a zero
    gradient, so the backward runs through them on every rank."""

    @staticmethod
    def forward(ctx, x, *dead):
        ctx.metas = [_meta(d) for d in dead]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *[_zeros(m) for m in ctx.metas])


def pp_layout(mesh, stages: int, axis: str = "pp"):
    """(``pp`` size, this rank's coordinate, its stage count, its first
    stage's global index) of ``stages`` stages cut into equal contiguous
    blocks over the ``axis`` ranks of ``mesh`` (all of them on one rank
    without a mesh)."""
    pp = 1 if mesh is None else mesh.shape.get(axis, 1)
    if stages % pp:
        raise ValueError(f"{stages} stages do not divide over {axis}={pp}")
    c = 0 if mesh is None else mesh.coord.get(axis, 0)
    local = stages // pp
    return pp, c, local, c * local


def schedule(stage_fn: Callable[[int, int, torch.Tensor], torch.Tensor],
             x_mb: torch.Tensor, stages: int, mesh=None,
             axis: str = "pp") -> torch.Tensor:
    """The GPipe schedule over the ``axis`` ranks of ``mesh`` (see the
    module docstring); returns ``[M, mb, ...]``, the same on every rank.

    ``stage_fn(s, t, x)`` applies global stage ``s`` (one of this rank's)
    at tick ``t``; ``x_mb [M, mb, ...]`` is the microbatches, the same on
    every ``axis`` rank. On tick ``t`` stage 0 takes microbatch ``t``
    clipped to ``M - 1`` (JAX's ``gpipe``), and stage ``s`` completes
    microbatch ``t - s``; what the drain ticks feed stage 0 reaches the
    last stage after the last tick and is never collected."""
    pp, c, local, s0 = pp_layout(mesh, stages, axis)
    M = x_mb.shape[0]
    T = M + stages - 1
    x_mb = copy_to(x_mb, mesh, axis)
    buf: List[torch.Tensor] = [torch.zeros_like(x_mb[0])] * local
    done: List[Optional[torch.Tensor]] = [None] * M
    last = c == pp - 1
    for t in range(T):
        buf[0] = _Select.apply(c == 0, x_mb[min(t, M - 1)], buf[0])
        ys = [stage_fn(s0 + i, t, buf[i]) for i in range(local)]
        if last and t >= stages - 1:
            done[t - (stages - 1)] = ys[-1]
        if t < T - 1:
            # stage s -> s + 1: across ranks by the ring, within this
            # rank's block by the list (the first stage's rank takes the
            # last stage's output from the ring)
            buf = [ppermute(ys[-1], mesh, axis, 1)] + ys[:-1]
    dead = ys[:-1] if last else ys
    out = torch.stack(done) if last else torch.zeros_like(x_mb)
    return psum(_Tie.apply(out, *dead), mesh, axis)


def gpipe(stage_apply: Callable[[Mapping[str, torch.Tensor], torch.Tensor],
                                torch.Tensor],
          stage_params: Mapping[str, torch.Tensor], x_mb: torch.Tensor,
          mesh=None, axis: str = "pp") -> torch.Tensor:
    """The GPipe schedule with one stage a rank (JAX ``gpipe``):
    ``stage_params`` is this rank's stage, its leaves with a leading axis
    of size 1, and ``stage_apply(params, x)`` applies it; ``x_mb [M, mb,
    ...]`` the microbatches, the same on every ``axis`` rank. Returns the
    last stage's ``[M, mb, ...]`` outputs on every rank."""
    pp = 1 if mesh is None else mesh.shape.get(axis, 1)
    params = {k: v[0] for k, v in stage_params.items()}
    return schedule(lambda s, t, x: stage_apply(params, x), x_mb, pp,
                    mesh, axis)


def stack_params(module: nn.Module, n: int) -> nn.Module:
    """Replace each parameter of ``module`` by ``n`` copies of it stacked
    on a new leading axis (the stage axis); returns the module, which is
    then applied through :func:`call_stacked`."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        m = module.get_submodule(owner) if owner else module
        m._parameters[leaf] = nn.Parameter(
            p.detach().unsqueeze(0).repeat(n, *([1] * p.dim())))
    return module


def call_stacked(module: nn.Module, index: int, args: tuple,
                 kwargs: Optional[dict] = None, remat: bool = False):
    """``module(*args, **kwargs)`` with its stacked parameters' slice
    ``index`` (views, so the gradient reaches the stack); ``remat``
    recomputes the call in the backward (``torch.utils.checkpoint``,
    non-reentrant)."""
    names, stacked = zip(*module.named_parameters())
    kwargs = kwargs or {}

    def run(*flat):
        params = dict(zip(names, flat[len(args):]))
        return torch.func.functional_call(module, params, flat[:len(args)],
                                          kwargs)

    flat = (*args, *(p[index] for p in stacked))
    if remat:
        return checkpoint(run, *flat, use_reentrant=False)
    return run(*flat)


class StageBlock(nn.Module):
    """The JAX ``PipelinedLM``'s block: pre-LN, no query/key/value/proj
    biases, Flax's LayerNorm (epsilon 1e-6) and tanh ``gelu``, causal
    attention without a key mask."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.num_heads = num_heads
        E = embed_dim
        self.ln1 = LayerNorm(E)
        self.query = QuantizableDense(E, E, use_bias=False)
        self.key = QuantizableDense(E, E, use_bias=False)
        self.value = QuantizableDense(E, E, use_bias=False)
        self.proj = QuantizableDense(E, E, use_bias=False)
        self.ln2 = LayerNorm(E)
        self.mlp_in = QuantizableDense(E, E * mlp_ratio)
        self.mlp_out = QuantizableDense(E * mlp_ratio, E)

    def forward(self, x):
        B, L, E = x.shape
        H = self.num_heads
        D = E // H
        y = self.ln1(x)
        q = self.query(y).reshape(B, L, H, D)
        k = self.key(y).reshape(B, L, H, D)
        v = self.value(y).reshape(B, L, H, D)
        a = dot_product_attention(q, k, v, causal=True)
        x = x + self.proj(a.reshape(B, L, E))
        y = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(y)


class _Stage(nn.Module):
    """One stage: ``layers`` blocks ``layer_{i}``."""

    def __init__(self, layers: int, embed_dim: int, num_heads: int,
                 mlp_ratio: int):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"layer_{i}",
                            StageBlock(embed_dim, num_heads, mlp_ratio))

    def forward(self, x):
        for i in range(self.layers):
            x = getattr(self, f"layer_{i}")(x)
        return x


class _Embed(nn.Module):
    def __init__(self, vocab: int, max_len: int, dim: int):
        super().__init__()
        self.token_embed = Embed(vocab, dim)
        self.pos_embed = nn.Parameter(torch.empty(1, max_len, dim))

    def forward(self, ids):
        return self.token_embed(ids) + self.pos_embed[:, :ids.shape[1]]


class _Head(nn.Module):
    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.ln_f = LayerNorm(dim)
        self.lm_head = QuantizableDense(dim, vocab, use_bias=False)

    def forward(self, x, return_hidden: bool = False):
        x = self.ln_f(x)
        return x if return_hidden else self.lm_head(x)


def partition_spec(name: str, ndim: int) -> tuple:
    """:class:`PipelinedLM`'s partition table: the stage stack over
    ``pp``, every other leaf whole (``interop.from_flax.shard_tree``'s
    ``spec_of``)."""
    if name.startswith("stages."):
        return ("pp",) + (None,) * (ndim - 1)
    return (None,) * ndim


class PipelinedLM(nn.Module):
    """Decoder-only LM with its block stack pipelined over ``pp`` (JAX
    ``PipelinedLM``): the embedding (``embed.token_embed``,
    ``embed.pos_embed``) and the head (``head.ln_f``, ``head.lm_head``)
    are replicated, the ``depth`` blocks run as ``pp`` stages of ``depth
    / pp`` blocks through :func:`gpipe`, their leaves stacked
    ``stages.layer_{i}.<leaf> [pp, ...]``, this rank holding its stage's
    slice. The mesh is ``dp x pp`` (``tp`` and ``sp`` above 1 raise, as
    the JAX module runs only those two axes); without one the model is
    one stage on one card. Pad positions are zeroed in the embedding.

    Weights are drawn from ``seed`` (the whole model, then this rank's
    slice kept); :func:`pipeline_from_flax` carries the JAX module's."""

    def __init__(self, mesh=None, vocab_size: int = 1000,
                 max_len: int = 128, embed_dim: int = 64, depth: int = 4,
                 num_heads: int = 4, mlp_ratio: int = 4,
                 microbatches: int = 4, pad_id: int = 0, seed: int = 0,
                 device=None):
        super().__init__()
        mesh_dev = check_mesh(mesh)
        dev = resolve_device(device if device is not None or mesh_dev is None
                             else mesh_dev)
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        for ax in ("tp", "sp", "ep"):
            if self.mesh is not None and self.mesh.shape.get(ax, 1) > 1:
                raise ValueError(f"PipelinedLM runs dp x pp; mesh "
                                 f"{self.mesh.shape} has {ax} > 1 (use "
                                 f"models.gpt_pipeline.PipelinedCausalLM)")
        # the module ``stages`` holds the stacked blocks
        self.num_stages = (1 if self.mesh is None
                           else self.mesh.shape.get("pp", 1))
        if depth % self.num_stages:
            raise ValueError(f"depth {depth} must divide into "
                             f"pp={self.num_stages} stages")
        self.layers_per_stage = depth // self.num_stages
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.microbatches = microbatches
        self.pad_id = pad_id
        self.embed = _Embed(vocab_size, max_len, embed_dim)
        self.add_module("stages", stack_params(
            _Stage(self.layers_per_stage, embed_dim, num_heads, mlp_ratio),
            self.num_stages))
        self.head = _Head(vocab_size, embed_dim)
        # imported here: models.gpt imports this package
        from ..interop.from_flax import shard_module
        from ..models.gpt import init_weights_

        init_weights_(self, seed)
        shard_module(self, self.mesh, partition_spec)
        self.to(dev)

    @property
    def lm_head(self) -> QuantizableDense:
        """The head's projection (the trainer's chunked loss reads it)."""
        return self.head.lm_head

    def partition_specs(self) -> Dict[str, tuple]:
        return {n: partition_spec(n, p.dim())
                for n, p in self.named_parameters()}

    def _embed(self, ids):
        x = self.embed(ids)
        return x * (ids != self.pad_id)[..., None]

    def forward(self, token_ids, train: bool = False,
                return_hidden: bool = False):
        """Logits ``[B, L, vocab]`` (f32) of this rank's ``[B/dp, L]``
        rows (the final norm's output with ``return_hidden``)."""
        ids = token_ids.long()
        B, L = ids.shape
        M = self.microbatches
        if B % M:
            raise ValueError(f"batch {B} must divide into {M} microbatches")
        x = self._embed(ids).reshape(M, B // M, L, self.embed_dim)
        stage = self.stages

        def apply(params, a):
            return torch.func.functional_call(stage, params, (a,))

        y = gpipe(apply, dict(stage.named_parameters()), x, self.mesh)
        return self.head(y.reshape(B, L, self.embed_dim), return_hidden)

    def apply(self, variables: Optional[Mapping[str, torch.Tensor]],
              token_ids) -> torch.Tensor:
        """The pipelined forward on ``variables`` (this rank's
        ``{name: tensor}``; None: the module's own)."""
        if variables is None:
            return self(token_ids)
        return torch.func.functional_call(self, dict(variables),
                                          (token_ids,))

    def reference_apply(self, variables: Optional[
            Mapping[str, torch.Tensor]], token_ids) -> torch.Tensor:
        """The sequential (non-pipelined) forward, for correctness checks:
        every stage in turn on the whole batch (one rank holding every
        stage)."""
        if self.mesh is not None and self.num_stages > 1:
            raise ValueError("reference_apply needs every stage on this "
                             "rank (a model without a pp mesh)")
        params = {**dict(self.named_parameters()), **(variables or {})}

        def part(prefix):
            return {k[len(prefix) + 1:]: v for k, v in params.items()
                    if k.startswith(prefix + ".")}

        ids = torch.as_tensor(token_ids, device=self.lm_head.kernel.device
                              ).long()
        x = torch.func.functional_call(self.embed, part("embed"), (ids,))
        x = x * (ids != self.pad_id)[..., None]
        stage = part("stages")
        for s in range(next(iter(stage.values())).shape[0]):
            x = torch.func.functional_call(
                self.stages, {k: v[s] for k, v in stage.items()}, (x,))
        return torch.func.functional_call(self.head, part("head"), (x,))


def pipeline_from_flax(variables: Mapping[str, Mapping]) -> Dict[str, object]:
    """The JAX ``PipelinedLM``'s three variables trees (``{"embed": ...,
    "stages": ..., "head": ...}``, each with its ``params``, numpy leaves;
    the stage leaves stacked ``[S, ...]``) as the port's ``{name:
    tensor}`` (whole leaves: ``interop.from_flax.shard_tree`` with
    ``spec_of=partition_spec`` cuts a rank's stage)."""
    from ..interop.from_flax import from_flax

    return {f"{part}.{name}": t for part in ("embed", "stages", "head")
            for name, t in from_flax(variables[part]).items()}


class PipelineTrainer(SPMDTrainer):
    """The training loop of :class:`PipelinedLM` (JAX
    ``PipelineTrainer``): AdamW at ``lr`` (optax's defaults), ``lm_loss``
    over the global batch, f32. The stage stack stays sharded over ``pp``
    and the embedding and head replicated (see the module docstring);
    gradients are summed over ``dp``."""

    def __init__(self, model: PipelinedLM, optimizer=None,
                 lr: float = 3e-4):
        super().__init__(model, model.mesh, optimizer=optimizer or adamw(lr),
                         precision="f32")
        self.model = model

    @property
    def variables(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())
