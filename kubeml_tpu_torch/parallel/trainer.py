"""SPMDTrainer: forward, loss, gradients, optimizer update, on one card or
over the ranks of a mesh.

Port of ``kubeml_tpu/parallel/trainer.py``. The JAX trainer owns sharded
parameters and one compiled step over a mesh; the port owns the module's
parameters (already initialised from the module's seed, this rank's
shards under a mesh of several ranks), an optimizer built from them, and
one eager step. A ``mesh`` of one device (``parallel.mesh.make_mesh(
devices=[dev])``) and a ``batch_spec`` are accepted as the JAX trainer
takes them and change nothing.

Over a mesh of several ranks (``make_mesh`` after ``parallel.distributed.
init_distributed``; the module built with the same mesh) every rank calls
``train_step`` with the same GLOBAL batch, as in JAX, and computes on its
``P("dp", "sp")`` block. The target of a rank's last position is the
first token of the next ``sp`` block, so each rank takes its targets from
the global batch (the last global position has none). The loss is the
global masked cross-entropy sum over the global mask count (JAX
``lm_loss``), both summed over ``dp`` x ``sp``: the returned value is the
global loss on every rank, and each rank differentiates only its own
terms. Over ranks the loss is taken from the final hidden states: under
``tp`` the vocabulary-sharded ``lm_head``'s logits stay sharded, and
the cross-entropy is Megatron's vocabulary-parallel one (the log-sum-exp
and the target's logit summed over ``tp``), equal to JAX's loss but for
f32 rounding. Gradients are then summed over ``dp`` and ``sp``, where the
parameters are replicated; the parameters replicated over ``tp`` already
hold their whole gradient from the model's f/g pair
(``collectives.copy_to``/``psum``), so ``tp`` gets no second reduction.
AdamW then runs on the local shards: its update is elementwise, so it
equals the unsharded update. A pipelined model (``models.gpt_pipeline``)
over a ``pp`` axis needs no other rule: its stage stack is sharded over
``pp`` and each rank computes the same loss from the outputs the model
broadcasts over ``pp``, its replicated leaves holding their whole
gradient through the model's own f/g pair (``parallel.pipeline``), so
``pp`` gets no reduction either. Under ``remat`` the recomputed forward
re-runs its collectives in the backward, in the same order on every
rank. Over
ranks the loss is ``lm_loss`` (a custom ``loss_fn`` sees one rank's
logits only and raises).

MoE (JAX :187-216): every ``parallel.moe.MoEMlp`` of the module leaves
its weighted load-balancing loss in ``last_aux``; the step adds them all
to the loss, and ``last_moe_overflow`` becomes the mean of the layers'
capacity-overflow shares (-1.0 for a model with no MoE layer). Over
ranks each layer computes both over the global batch (its sums taken
over ``dp`` x ``sp``), so they are the same on every rank and the loss
stays the global one. The gradient rule over ``ep`` is the ``tp`` rule:
the layer's f/g pair over ``ep`` x ``tp`` (``parallel.moe``) leaves every
leaf replicated over ``ep`` (the router, the attention, the dense blocks,
the embeddings) its whole gradient on every ``ep`` rank and each expert
stack its slice's, so ``ep`` gets no reduction here; the expert stacks
are summed over ``dp`` x ``sp`` like every other leaf.

The loss functions keep the JAX definitions: :func:`lm_loss` is the masked
next-token cross-entropy, :func:`chunked_lm_loss` the same loss streamed
over sequence chunks of the lm_head so the ``[B, L, vocab]`` logits never
exist whole (each chunk's logits live inside one checkpoint region and
are recomputed in the backward).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .collectives import all_gather, all_reduce_, copy_to, psum
from .mesh import check_mesh, local_block
from .moe import moe_layers

# the axes the batch is sharded over, the parameters replicated over
_REPLICAS = ("dp", "sp")


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
            pad_id: int = 0) -> torch.Tensor:
    """Next-token cross-entropy over valid (non-pad) positions."""
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1]
    mask = (targets != pad_id).float()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                         targets.reshape(-1), reduction="none")
    return (ce.reshape(targets.shape) * mask).sum() / mask.sum().clamp_min(1.0)


def _lm_terms(logits, targets, pad_id: int):
    """(masked CE sum, masked top-1 hits, mask count) of logits against
    their aligned targets."""
    mask = (targets != pad_id).float()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         targets.reshape(-1),
                         reduction="none").reshape(targets.shape)
    hit = (logits.argmax(dim=-1) == targets).float()
    return (ce * mask).sum(), (hit * mask).sum(), mask.sum()


def _vocab_parallel_terms(logits, targets, pad_id: int, mesh):
    """:func:`_lm_terms` of this rank's vocabulary columns of the logits
    (Megatron's vocab-parallel cross-entropy): the log-sum-exp and the
    target's logit summed over ``tp`` (the max over ``tp`` shifts the
    exponentials), the prediction the first of the ranks' largest logits,
    so ``[B, L, vocab]`` logits never exist whole. Equal to the gathered
    logits' terms but for f32 rounding."""
    n = logits.shape[-1]
    v0 = mesh.coord["tp"] * n
    m = all_reduce_(logits.detach().amax(-1), mesh, "tp",
                    op=dist.ReduceOp.MAX)
    lse = torch.log(psum(torch.exp(logits - m[..., None]).sum(-1), mesh,
                         "tp")) + m
    inside = (targets >= v0) & (targets < v0 + n)
    picked = logits.gather(-1, (targets - v0).clamp(0, n - 1)[..., None])
    target = psum(torch.where(inside, picked[..., 0], 0.0), mesh, "tp")
    best, idx = logits.detach().max(dim=-1)
    bests = all_gather(best[None], mesh, "tp", dim=0)
    preds = all_gather((idx + v0)[None], mesh, "tp", dim=0)
    pred = preds.gather(0, bests.argmax(dim=0)[None])[0]
    mask = (targets != pad_id).float()
    hit = (pred == targets).float()
    return ((lse - target) * mask).sum(), (hit * mask).sum(), mask.sum()


def _chunk_terms(h_c, lm_kernel, t_c, pad_id: int, mesh=None):
    """:func:`_lm_terms` of one chunk; under ``tp`` ``lm_kernel`` is this
    rank's vocabulary shard (:func:`_vocab_parallel_terms`)."""
    logits = torch.einsum("bce,ev->bcv", copy_to(h_c, mesh, "tp"),
                          lm_kernel).float()
    if mesh is None or mesh.shape.get("tp", 1) == 1:
        return _lm_terms(logits, t_c, pad_id)
    return _vocab_parallel_terms(logits, t_c, pad_id, mesh)


def _chunked_sums(h, lm_kernel, targets, pad_id: int,
                  chunk: Optional[int], mesh=None):
    """The chunk terms of aligned hidden states and targets, summed in
    chunk order, one checkpoint region a chunk (``chunk=None``: one piece,
    no checkpoint)."""
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    s = a = c = zero
    n = h.shape[1]
    if n == 0:
        return s, a, c
    if chunk is None:
        return _chunk_terms(h, lm_kernel, targets, pad_id, mesh)
    chunk = min(chunk, n)
    for start in range(0, n, chunk):
        ds, da, dc = checkpoint(_chunk_terms, h[:, start:start + chunk],
                                lm_kernel, targets[:, start:start + chunk],
                                pad_id, mesh, use_reentrant=False)
        s, a, c = s + ds, a + da, c + dc
    return s, a, c


def local_targets(mesh, tokens: torch.Tensor, pad_id: int = 0
                  ) -> torch.Tensor:
    """The next-token targets of this rank's ``P("dp", "sp")`` block of the
    global ``tokens [B, L]``: position ``p`` targets ``tokens[:, p + 1]``,
    the last global position ``pad_id`` (no target)."""
    shifted = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1],
                                                        pad_id)], dim=1)
    return local_block(mesh, shifted).long()


def chunked_lm_loss(hidden: torch.Tensor, lm_kernel: torch.Tensor,
                    tokens: torch.Tensor, pad_id: int = 0,
                    chunk: Optional[int] = 2048, with_acc: bool = False,
                    mesh=None):
    """``lm_loss`` from the final hidden states ``[B, L, E]`` and the
    lm_head kernel ``[E, V]`` without materialising ``[B, L, V]`` logits:
    one checkpoint region per sequence chunk, sums taken in chunk order.
    ``with_acc=True`` also returns next-token top-1 accuracy.

    Over a ``mesh`` of several ranks ``hidden`` is this rank's
    ``[B/dp, L/sp, E]`` block, ``lm_kernel`` its vocabulary shard and
    ``tokens`` the global batch (``chunk=None`` computes the block in one
    piece): the sums are taken over ``dp`` x ``sp``, every rank returns
    the global loss, and its gradient reaches this rank's terms only."""
    if mesh is not None and mesh.distributed:
        s, a, c = _chunked_sums(hidden, lm_kernel,
                                local_targets(mesh, tokens, pad_id), pad_id,
                                chunk, mesh)
        c = all_reduce_(c.detach().clone(), mesh, _REPLICAS)
        loss = psum(s / c.clamp_min(1.0), mesh, _REPLICAS)
        if with_acc:
            return loss, psum(a.detach(), mesh, _REPLICAS) / c.clamp_min(1.0)
        return loss
    s, a, c = _chunked_sums(hidden[:, :-1], lm_kernel, tokens[:, 1:].long(),
                            pad_id, chunk)
    loss = s / c.clamp_min(1.0)
    if with_acc:
        return loss, a / c.clamp_min(1.0)
    return loss


def adamw(lr: float = 3e-4, weight_decay: float = 1e-4
          ) -> Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]:
    """The factory of ``optax.adamw(lr)``'s twin: betas (0.9, 0.999), eps
    1e-8 and weight decay 1e-4 on every parameter (PyTorch's ``AdamW``
    defaults to 1e-2)."""
    return lambda params: torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay)


class SPMDTrainer:
    """Owns a module's optimizer and one train step, on one card or over
    the ranks of ``mesh`` (see the module docstring).

    ``module`` takes ``(token_ids, train=...)`` (and ``return_hidden=True``
    for ``logits_chunk``). ``optimizer`` is a factory ``params ->
    torch.optim.Optimizer``; the default is :func:`adamw`. ``precision``
    ``"bf16"`` casts floating inputs to bf16 before the module (token ids
    are not cast; the module's own ``dtype`` sets its compute dtype)."""

    def __init__(
        self,
        module: nn.Module,
        mesh=None,
        optimizer: Optional[Callable[[Iterable[nn.Parameter]],
                                     torch.optim.Optimizer]] = None,
        loss_fn: Callable[[torch.Tensor, torch.Tensor],
                          torch.Tensor] = lm_loss,
        precision: str = "bf16",
        input_transform: Optional[Callable[[torch.Tensor],
                                           torch.Tensor]] = None,
        logits_chunk: Optional[int] = None,
        batch_spec=None,
    ):
        check_mesh(mesh)
        if logits_chunk is not None and loss_fn is not lm_loss:
            raise ValueError("logits_chunk streams the default lm_loss; "
                             "custom loss_fn needs the full logits")
        self.ranks = mesh if mesh is not None and mesh.distributed else None
        if self.ranks is not None:
            if getattr(module, "mesh", None) is not mesh:
                raise ValueError("over a mesh of several ranks the module "
                                 "must be built with the trainer's mesh")
            if loss_fn is not lm_loss:
                raise ValueError("over a mesh of several ranks the trainer "
                                 "computes lm_loss; a custom loss_fn sees "
                                 "one rank's logits only")
            mesh.group(*_REPLICAS)  # collective at first use: make it now
        self.module = module
        self.mesh = mesh
        self.batch_spec = batch_spec
        self.make_optimizer = optimizer or adamw()
        self.loss_fn = loss_fn
        self.precision = precision
        self.input_transform = input_transform
        self.logits_chunk = logits_chunk
        self.opt: Optional[torch.optim.Optimizer] = None
        # expert-capacity overflow rate of the last step; -1 = no MoE layers
        self.last_moe_overflow = -1.0

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def init(self, sample_batch=None) -> None:
        """Build the optimizer state over the module's parameters (the
        weights themselves come from the module, seeded at construction).
        ``sample_batch`` is checked through ``input_transform`` if given."""
        if sample_batch is not None:
            self._inputs(sample_batch)
        self.opt = self.make_optimizer(list(self.module.parameters()))

    def _inputs(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the batch on the card, the module's input): over ranks, the
        global batch and this rank's block of it."""
        tokens = torch.as_tensor(batch, device=self.device)
        x = local_block(self.ranks, tokens)
        if self.precision == "bf16" and x.is_floating_point():
            x = x.to(torch.bfloat16)
        if self.input_transform is not None:
            x = self.input_transform(x)
        return tokens, x

    def _hidden_loss(self, tokens, x, train: bool, with_acc=False,
                     pad_id: int = 0, **kw):
        """The LM loss from the final hidden states and the lm_head
        kernel: chunked (``logits_chunk``), and over ranks always (the
        vocabulary-parallel loss under tp)."""
        hidden = self.module(x, train=train, return_hidden=True, **kw)
        kernel = self.module.lm_head.kernel.to(hidden.dtype)
        return chunked_lm_loss(hidden, kernel, tokens, pad_id=pad_id,
                               chunk=self.logits_chunk, with_acc=with_acc,
                               mesh=self.ranks)

    def _loss(self, tokens, x, train: bool, rng=None) -> torch.Tensor:
        kw = {} if rng is None else {"rng": rng}
        if self.logits_chunk is not None or self.ranks is not None:
            return self._hidden_loss(tokens, x, train, **kw)
        return self.loss_fn(self.module(x, train=train, **kw).float(),
                            tokens)

    def _reduce_grads(self) -> None:
        """Sum the gradients over ``dp`` x ``sp`` in one flat buffer."""
        params = list(self.module.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        all_reduce_(flat, self.ranks, _REPLICAS)
        at = 0
        for p in params:
            n = p.numel()
            p.grad.copy_(flat[at:at + n].view_as(p.grad))
            at += n

    def _moe_terms(self, loss: torch.Tensor) -> torch.Tensor:
        """Add every MoE layer's aux loss of the forward just run to
        ``loss``, set ``last_moe_overflow`` (the layers' mean, -1.0 with
        none), and clear what the layers left."""
        layers = moe_layers(self.module)
        aux = [m.last_aux for m in layers if m.last_aux is not None]
        over = [m.last_overflow for m in layers
                if m.last_overflow is not None]
        for a in aux:
            loss = loss + a
        self.last_moe_overflow = (torch.stack(over).mean() if over
                                  else -1.0)
        for m in layers:
            m.last_aux = m.last_overflow = None
        return loss

    def train_step(self, batch, rng=None) -> torch.Tensor:
        """One optimizer step on a batch; returns the loss (a detached
        device scalar, computed before the update, MoE aux losses
        included). ``rng`` (an int seed or a ``torch.Generator``, as the
        JAX step's dropout key) goes to the module, whose dropout and MoE
        router noise draw from it; a module with dropout 0.0 and no MoE
        layer draws nothing. Each parameter's ``grad`` holds this step's
        gradient afterwards; ``last_moe_overflow`` the step's overflow
        share (a device scalar; -1.0 without MoE layers)."""
        if self.opt is None:
            raise RuntimeError("call init() before train_step()")
        self.module.train()
        tokens, x = self._inputs(batch)
        self.opt.zero_grad(set_to_none=True)
        loss = self._moe_terms(self._loss(tokens, x, train=True, rng=rng))
        loss.backward()
        if self.ranks is not None:
            self._reduce_grads()
        self.opt.step()
        return loss.detach()

    @torch.no_grad()
    def eval_metrics(self, batch, pad_id: int = 0) -> Tuple[float, float]:
        """(eval loss, next-token top-1 accuracy) over non-pad positions."""
        self.module.eval()
        tokens, x = self._inputs(batch)
        if self.logits_chunk is not None or self.ranks is not None:
            l, a = self._hidden_loss(tokens, x, False, with_acc=True,
                                     pad_id=pad_id)
            return float(l), float(a)
        logits = self.module(x, train=False).float()
        loss = float(self.loss_fn(logits, tokens))
        targets = tokens[:, 1:].long()
        mask = (targets != pad_id).float()
        correct = (logits[:, :-1].argmax(dim=-1) == targets).float()
        acc = float((correct * mask).sum() / mask.sum().clamp_min(1.0))
        return loss, acc

    def eval_loss(self, batch) -> float:
        return self.eval_metrics(batch)[0]
