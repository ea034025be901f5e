"""SPMDTrainer on one card: forward, loss, gradients, optimizer update.

Port of ``kubeml_tpu/parallel/trainer.py``. The JAX trainer owns sharded
parameters and one compiled step over a mesh; on one card the batch
``PartitionSpec`` and buffer donation do not exist, so the port owns the
module's parameters (already initialised from the module's seed), an
optimizer built from them, and one eager step. A ``mesh`` of one device
(``parallel.mesh.make_mesh(devices=[dev])``) and a ``batch_spec`` are
accepted as the JAX trainer takes them and change nothing; a mesh of
several devices raises (sharding over ``torch.distributed`` is the next
slice, ROADMAP).

MoE (JAX :187-216): every ``parallel.moe.MoEMlp`` of the module leaves
its weighted load-balancing loss in ``last_aux``; the step adds them all
to the loss, and ``last_moe_overflow`` becomes the mean of the layers'
capacity-overflow shares (-1.0 for a model with no MoE layer).

The loss functions keep the JAX definitions: :func:`lm_loss` is the masked
next-token cross-entropy, :func:`chunked_lm_loss` the same loss streamed
over sequence chunks of the lm_head so the ``[B, L, vocab]`` logits never
exist whole (each chunk's logits live inside one checkpoint region and
are recomputed in the backward).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .mesh import check_mesh
from .moe import moe_layers


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
            pad_id: int = 0) -> torch.Tensor:
    """Next-token cross-entropy over valid (non-pad) positions."""
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1]
    mask = (targets != pad_id).float()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                         targets.reshape(-1), reduction="none")
    return (ce.reshape(targets.shape) * mask).sum() / mask.sum().clamp_min(1.0)


def _chunk_terms(h_c, lm_kernel, t_c, pad_id: int):
    """(masked CE sum, masked top-1 hits, mask count) of one chunk."""
    logits = torch.einsum("bce,ev->bcv", h_c, lm_kernel).float()
    mask = (t_c != pad_id).float()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         t_c.reshape(-1), reduction="none").reshape(t_c.shape)
    hit = (logits.argmax(dim=-1) == t_c).float()
    return (ce * mask).sum(), (hit * mask).sum(), mask.sum()


def chunked_lm_loss(hidden: torch.Tensor, lm_kernel: torch.Tensor,
                    tokens: torch.Tensor, pad_id: int = 0, chunk: int = 2048,
                    with_acc: bool = False):
    """``lm_loss`` from the final hidden states ``[B, L, E]`` and the
    lm_head kernel ``[E, V]`` without materialising ``[B, L, V]`` logits:
    one checkpoint region per sequence chunk, sums taken in chunk order.
    ``with_acc=True`` also returns next-token top-1 accuracy."""
    targets = tokens[:, 1:].long()
    h = hidden[:, :-1]
    n = h.shape[1]
    if n == 0:  # length-1 sequences have no next-token targets
        zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
        return (zero, zero) if with_acc else zero
    chunk = min(chunk, n)
    s = a = c = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, n, chunk):
        ds, da, dc = checkpoint(_chunk_terms, h[:, start:start + chunk],
                                lm_kernel, targets[:, start:start + chunk],
                                pad_id, use_reentrant=False)
        s, a, c = s + ds, a + da, c + dc
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
    """Owns a module's optimizer and one train step on one card.

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
        """(the batch on the card, the module's input)."""
        tokens = torch.as_tensor(batch, device=self.device)
        x = tokens
        if self.precision == "bf16" and x.is_floating_point():
            x = x.to(torch.bfloat16)
        if self.input_transform is not None:
            x = self.input_transform(x)
        return tokens, x

    def _loss(self, tokens, x, train: bool, rng=None) -> torch.Tensor:
        kw = {} if rng is None else {"rng": rng}
        if self.logits_chunk is not None:
            hidden = self.module(x, train=train, return_hidden=True, **kw)
            kernel = self.module.lm_head.kernel.to(hidden.dtype)
            return chunked_lm_loss(hidden, kernel, tokens,
                                   chunk=self.logits_chunk)
        return self.loss_fn(self.module(x, train=train, **kw).float(),
                            tokens)

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
        self.opt.step()
        return loss.detach()

    @torch.no_grad()
    def eval_metrics(self, batch, pad_id: int = 0) -> Tuple[float, float]:
        """(eval loss, next-token top-1 accuracy) over non-pad positions."""
        self.module.eval()
        tokens, x = self._inputs(batch)
        if self.logits_chunk is not None:
            hidden = self.module(x, train=False, return_hidden=True)
            l, a = chunked_lm_loss(hidden,
                                   self.module.lm_head.kernel.to(hidden.dtype),
                                   tokens, pad_id=pad_id,
                                   chunk=self.logits_chunk, with_acc=True)
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
