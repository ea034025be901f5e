"""Pipeline-parallel causal LM, the port of
``kubeml_tpu/models/gpt_pipeline.py``: the ``pp`` mesh axis, reachable
from the SPMD engine (``kubeml train --engine spmd --mesh pp=2`` with a
function file that builds :class:`PipelinedCausalLM`).

The block stack is split into ``stages`` stages of ``depth / stages``
``GPTBlock`` layers. Their parameters are stacked on a leading ``[S,
...]`` axis under the Flax names (``stages.layer_{j}.<leaf>``), so a Flax
tree converts name for name (``interop.from_flax``) and the partition
table (``models.gpt.partition_spec``) gives them ``("pp", ..., "tp")``:
over a mesh of several ranks each ``pp`` rank holds its contiguous block
of ``S / pp`` stages, and within a stage the blocks are tensor-parallel
over ``tp`` as the flat model's are. The embeddings, ``ln_f`` and
``lm_head`` are replicated over ``pp`` (and sharded over ``tp`` as the
flat model's).

The schedule is JAX's (``parallel.pipeline.schedule``): every stage
computes on every tick, bubbles included (``T = M + S - 1`` ticks of
``microbatches`` M), and a validity buffer rolls with the activations,
all False on the fill's bubbles (each stage past 0 then attends with no
valid key: the flash kernels give zeros there). On the drain ticks stage
0 takes the last microbatch again where JAX's rolled buffer hands it the
last stage's output; neither is ever collected. Over ranks the shift is
a ring of ``ppermute`` s and the result is broadcast over ``pp``; on one
rank (``mesh=None``) every stage runs each tick, as JAX's vmap does. At
dropout 0 the results are JAX's; dropout masks come from explicit
generators (``fold_in`` of the step's seed by tick, stage and layer, and
by the ``dp`` coordinate over ranks), not JAX's threefry stream.

Sequence parallelism: the JAX module never shards L, and JAX's trainer on
a ``pp x sp`` mesh gives the loss of the unsharded model. Here each rank
gathers its rows' whole sequence over ``sp``, runs the schedule on it (the
``sp`` ranks of a stage compute alike) and keeps its ``L / sp`` positions
of the output, so the trainer's loss over ``dp x sp`` and its gradient sum
over ``dp x sp`` are those of the unsharded model.

Decode and generation are served by the flat model from the same
checkpoint family: :meth:`PipelinedCausalLM.flat_equivalent` and
:func:`flat_serving_remap`.
"""

from __future__ import annotations

import re
from typing import List

import torch
from torch import nn

from ..parallel.collectives import all_gather, copy_to
from ..parallel.mesh import check_mesh
from ..parallel.pipeline import (call_stacked, pp_layout, schedule,
                                 stack_params)
from ..utils.device import resolve_device
from .gpt import PAD_ID, GPTBlock, init_weights_, partition_spec
from .layers import Embed, LayerNorm, QuantizableDense, fold_in, seed_of


class _TpView:
    """A mesh as a stage's blocks see it: its ``tp`` axis alone (a stage
    never shards the sequence, and ``pp`` is the schedule's)."""

    distributed = True

    def __init__(self, mesh):
        self.mesh = mesh
        self.shape = {"tp": mesh.shape["tp"]}
        self.coord = {"tp": mesh.coord["tp"]}
        self.rank = mesh.rank

    def group(self, *axes):
        return self.mesh.group(*(ax for ax in axes if ax == "tp"))


class PipelinedCausalLM(nn.Module):
    """Decoder-only LM over integer token ids ``[B, L]``; id 0 = padding.
    The ``CausalTransformer`` tail (``ln_f``, ``lm_head``,
    ``return_hidden``), so ``parallel.trainer.SPMDTrainer`` trains it
    unchanged. ``B`` (this rank's rows) must divide into ``microbatches``,
    ``depth`` into ``stages``, ``stages`` over the mesh's ``pp``.

    Weights are drawn like the flat model's (normal(0.02) embeddings,
    lecun-normal kernels, zero biases) from a ``torch.Generator`` seeded
    with ``seed``, the whole model on the CPU, whatever the mesh; this
    rank's block of each leaf is then kept and moved to ``device``."""

    def __init__(self, vocab_size: int = 32000, max_len: int = 2048,
                 embed_dim: int = 512, depth: int = 8, num_heads: int = 8,
                 mlp_ratio: int = 4, dropout: float = 0.0, stages: int = 2,
                 microbatches: int = 4, mesh=None,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 ln_eps: float = 1e-6, attn_bias: bool = False,
                 pos: str = "learned", rope_theta: float = 10000.0,
                 seed: int = 0, device=None):
        super().__init__()
        if pos not in ("learned", "rope"):
            raise ValueError(f"unknown pos {pos!r} (valid: 'learned', 'rope')")
        if depth % stages:
            raise ValueError(f"depth {depth} must divide into {stages} "
                             f"stages")
        mesh_dev = check_mesh(mesh)
        dev = resolve_device(device if device is not None or mesh_dev is None
                             else mesh_dev)
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        tp = 1 if self.mesh is None else self.mesh.shape.get("tp", 1)
        for what, n in (("num_heads", num_heads), ("embed_dim", embed_dim),
                        ("vocab_size", vocab_size)):
            if n % tp:
                raise ValueError(f"{what} {n} does not divide over tp={tp}")
        pp_layout(self.mesh, stages)  # the stages divide over pp
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.mlp_ratio = mlp_ratio
        self.dropout = dropout
        self.num_stages = stages  # the module ``stages`` holds the blocks
        self.layers_per_stage = depth // stages
        self.microbatches = microbatches
        self.dtype = dtype
        self.remat = remat
        self.ln_eps = ln_eps
        self.attn_bias = attn_bias
        self.pos = pos
        self.rope_theta = rope_theta
        self.token_embed = Embed(vocab_size, embed_dim)
        if pos == "learned":
            self.pos_embed = nn.Parameter(torch.empty(1, max_len, embed_dim))
        view = _TpView(self.mesh) if tp > 1 else None
        stage = nn.Module()
        for j in range(self.layers_per_stage):
            stage.add_module(f"layer_{j}", GPTBlock(
                embed_dim, num_heads, mlp_ratio, dtype=dtype, ln_eps=ln_eps,
                attn_bias=attn_bias, rope=pos == "rope",
                rope_theta=rope_theta, dropout=dropout, mesh=view))
        self.add_module("stages", stack_params(stage, stages))
        self.ln_f = LayerNorm(embed_dim, ln_eps)
        self.lm_head = QuantizableDense(embed_dim, vocab_size, use_bias=False,
                                        dtype=dtype)
        init_weights_(self, seed)
        from ..interop.from_flax import shard_module  # imports serving

        shard_module(self, self.mesh)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.token_embed.embedding.device

    def partition_specs(self):
        """``{parameter name: partition_spec}`` over every parameter."""
        return {name: partition_spec(name, p.dim())
                for name, p in self.named_parameters()}

    def _layers(self) -> List[nn.Module]:
        return [getattr(self.stages, f"layer_{j}")
                for j in range(self.layers_per_stage)]

    def _embed(self, ids):
        x = self.token_embed(ids)  # this rank's E columns under tp
        if self.pos == "learned":
            x = x + self.pos_embed[:, :ids.shape[1]]
        return all_gather(x, self.mesh, "tp", dim=-1).to(self.dtype)

    def _head(self, x, return_hidden: bool):
        x = self.ln_f(x).to(self.dtype)
        if return_hidden:
            return x
        logits = self.lm_head(copy_to(x, self.mesh, "tp"))
        return all_gather(logits, self.mesh, "tp", dim=-1).float()

    def _stage(self, local: int, x, valid, train: bool, seeds=None):
        """Stage ``local`` of this rank's block on ``x``; ``seeds`` the
        layers' dropout seeds."""
        remat = self.remat and torch.is_grad_enabled()
        for j, block in enumerate(self._layers()):
            kw = dict(train=train,
                      dropout_seed=None if seeds is None else seeds[j])
            x = call_stacked(block, local, (x, valid), kw, remat=remat)
        return x

    def forward(self, token_ids, train: bool = False,
                return_hidden: bool = False, rng=None):
        """Logits ``[B, L, vocab]`` (f32) of this rank's ``[B/dp, L/sp]``
        block of token ids, or its final hidden states ``[B, L, E]`` with
        ``return_hidden``. ``train=True`` with ``dropout > 0`` needs
        ``rng`` (an int seed or a ``torch.Generator``)."""
        mesh = self.mesh
        ids = token_ids.long()
        sp = 1 if mesh is None else mesh.shape.get("sp", 1)
        if sp > 1:  # the whole sequence: a stage never shards L
            ids = all_gather(ids, mesh, "sp", dim=1)
        B, L = ids.shape
        S, M = self.num_stages, self.microbatches
        if B % M:
            raise ValueError(f"batch {B} must divide into {M} microbatches")
        seed = None
        if train and self.dropout > 0.0:
            if rng is None:
                raise ValueError(f"dropout {self.dropout} in training needs "
                                 f"rng (an int seed or a torch.Generator)")
            seed = seed_of(rng)
            if mesh is not None:  # each dp block draws its own masks
                seed = fold_in(seed, mesh.coord.get("dp", 0))
        valid = ids != PAD_ID
        mb = B // M
        x_mb = self._embed(ids).reshape(M, mb, L, self.embed_dim)
        valid_mb = valid.reshape(M, mb, L)
        # the validity buffer: stage 0 takes its microbatch's mask, then
        # the buffer rolls one stage on (all False on the fill's bubbles)
        vbuf = [torch.zeros_like(valid_mb[0])] * S
        vtable = []
        for t in range(M + S - 1):
            vbuf = [valid_mb[min(t, M - 1)]] + vbuf[1:]
            vtable.append(vbuf)
            vbuf = [vbuf[-1]] + vbuf[:-1]
        _, _, _, s0 = pp_layout(mesh, S)
        lps = self.layers_per_stage

        def stage_fn(s, t, x):
            seeds = (None if seed is None else
                     [fold_in(seed, (t * S + s) * lps + j)
                      for j in range(lps)])
            return self._stage(s - s0, x, vtable[t][s], train, seeds)

        y = schedule(stage_fn, x_mb, S, mesh, "pp")
        x = y.reshape(B, L, self.embed_dim)
        if sp > 1:  # this rank's positions
            x = x.narrow(1, mesh.coord["sp"] * (L // sp), L // sp)
        return self._head(x, return_hidden)

    @torch.no_grad()
    def sequential_apply(self, token_ids, train: bool = False):
        """The non-pipelined forward with the same (stacked) parameters:
        every stage in turn on the whole batch, the oracle of the schedule
        (on one rank holding every stage)."""
        if self.mesh is not None:
            raise ValueError("sequential_apply runs on one rank holding "
                             "every stage (a model without a mesh)")
        ids = token_ids.long()
        valid = ids != PAD_ID
        x = self._embed(ids)
        for s in range(self.num_stages):
            x = self._stage(s, x, valid, train)
        return self._head(x, False)

    def flat_equivalent(self, mesh=None, device=None, dtype=None):
        """The flat ``CausalTransformer`` with the same dimensions: the
        module that serves this pipeline-trained family (decode wants the
        flat cache path); restore this model's checkpoints into it through
        :func:`flat_serving_remap`."""
        from .gpt import CausalTransformer

        return CausalTransformer(
            vocab_size=self.vocab_size, max_len=self.max_len,
            embed_dim=self.embed_dim, depth=self.depth,
            num_heads=self.num_heads, mlp_ratio=self.mlp_ratio,
            dropout=self.dropout, mesh=mesh,
            dtype=self.dtype if dtype is None else dtype,
            ln_eps=self.ln_eps, attn_bias=self.attn_bias, pos=self.pos,
            rope_theta=self.rope_theta,
            device=self.device if device is None else device)


def flat_serving_remap(stages: int, layers_per_stage: int):
    """The restore-time leaf remap from a :class:`PipelinedCausalLM`
    checkpoint to the flat ``CausalTransformer`` layout (the same
    ``GPTBlock`` children, so only the stacking moves): a stored
    ``params/stages/layer_j/...`` leaf, stacked ``[S, ...]``, fans out to
    ``params/block_{s * layers_per_stage + j}/...`` with index prefix
    ``(s,)``; every other leaf passes through. Give it to
    ``ShardedCheckpointStore.restore(remap=...)`` or to
    ``apply_remap_host`` (a function's ``serving_remap``)."""
    pat = re.compile(r"^params/stages/layer_(\d+)/(.+)$")

    def remap(path: str):
        m = pat.match(path)
        if m is None:
            return None
        j, rest = int(m.group(1)), m.group(2)
        return [(f"params/block_{s * layers_per_stage + j}/{rest}", (s,))
                for s in range(stages)]

    return remap
