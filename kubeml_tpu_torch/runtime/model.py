"""KubeModel, the user-facing model API: the port of
``kubeml_tpu/runtime/model.py``.

The user writes a model and never touches devices or distribution:

* ``build()`` returns an ``nn.Module`` (required) whose ``forward(x,
  train)`` gives logits (a module with dropout also takes ``rng``, the
  ``torch.Generator`` its masks are drawn from);
* ``per_sample_loss``/``per_sample_correct`` act on logits and return
  per-sample vectors: the engine applies validity masks and reductions, so
  padded batches and failed workers stay out of user code;
* ``configure_optimizers(params)`` returns a fresh ``torch.optim``
  optimizer at ``self.lr`` (``self.epoch`` is set too, for schedules); the
  engine calls it once per worker per sync round, so optimizer state never
  survives an averaging barrier;
* ``preprocess`` runs on the device, e.g. to scale staged uint8 images;
* ``serving_remap`` re-lays a training-shaped checkpoint out for serving
  (default None); the SPMD engine sets ``self.mesh`` before ``build()``.

Variables are ``{"params": {name: tensor}, "batch_stats": {name:
tensor}}`` (``batch_stats`` only for modules with BatchNorm), the
module's ``named_parameters`` and ``named_buffers`` under Flax's
collection names. :meth:`forward` is the functional form, used for
evaluation and inference; the K-AVG engine trains a worker by pointing the
module's own parameters and buffers at that worker's replica and calling
the module, so nothing is re-bound per step.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..data.dataset import KubeDataset
from ..models.layers import flax_init_, takes_rng

Variables = Dict[str, Dict[str, torch.Tensor]]


def module_variables(module: nn.Module) -> Variables:
    """The module's own tensors (not copies) as a variables tree."""
    out: Variables = {"params": dict(module.named_parameters())}
    stats = dict(module.named_buffers())
    if stats:
        out["batch_stats"] = stats
    return out


def bind(module: nn.Module, variables: Variables) -> None:
    """Point ``module``'s parameters and buffers at ``variables``' tensors
    (no copy): training then updates those tensors in place."""
    params = dict(module.named_parameters())
    for name, t in variables["params"].items():
        params[name].data = t
    for name, t in variables.get("batch_stats", {}).items():
        owner, _, leaf = name.rpartition(".")
        module.get_submodule(owner)._buffers[leaf] = t


class KubeModel(ABC):
    """Subclass, implement :meth:`build`, optionally override the hooks::

        class KubeLeNet(KubeModel):
            def __init__(self):
                super().__init__(MnistDataset())

            def build(self):
                return LeNet(num_classes=10)

            def configure_optimizers(self, params):
                return torch.optim.SGD(params, lr=self.lr, momentum=0.9)
    """

    def __init__(self, dataset: KubeDataset):
        self._dataset = dataset
        self._module: Optional[nn.Module] = None
        # per-invocation parameters, set by the runtime before any task runs
        self.lr: float = 0.01
        self.batch_size: int = 64
        self.epoch: int = 0
        self.k: int = -1
        self.task: str = ""
        # the SPMD engine's mesh (parallel.mesh.Mesh), set by the job
        # before build(); None under K-AVG
        self.mesh = None

    @property
    def dataset(self) -> KubeDataset:
        return self._dataset

    @property
    def module(self) -> nn.Module:
        """The module the engine computes with (built once)."""
        if self._module is None:
            self._module = self.build()
        return self._module

    def rebind_mesh(self, mesh) -> None:
        """Point the model at a new mesh and drop the built module, so the
        next ``module`` access builds it again over the new mesh (the SPMD
        job's elastic remesh; JAX :84)."""
        self.mesh = mesh
        self._module = None

    def _set_params(self, *, lr: float, batch_size: int, epoch: int, k: int,
                    task: str) -> None:
        self.lr = lr
        self.batch_size = batch_size
        self.epoch = epoch
        self.k = k
        self.task = task

    @abstractmethod
    def build(self) -> nn.Module:
        """Return the ``nn.Module`` of this model (on the CPU)."""

    def init(self, generator: torch.Generator, sample_x=None) -> Variables:
        """Fresh variables on the CPU: a new module from :meth:`build`
        with Flax's initialisers drawn from ``generator``. ``sample_x`` is
        accepted for the JAX package's signature; shapes are fixed by
        ``build``."""
        return module_variables(flax_init_(self.build(), generator))

    def forward(self, variables: Variables, x: torch.Tensor, train: bool,
                rng: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Variables]:
        """Run the module on ``variables``; returns (logits, updated mutable
        state). The state (BatchNorm statistics) is updated, in a copy, only
        when training. ``rng``, a generator on ``x``'s device, goes to a
        module whose forward takes one (its dropout draws from it), and
        only when training, as the JAX package passes its dropout key."""
        stats = variables.get("batch_stats", {})
        if train:
            stats = {k: v.clone() for k, v in stats.items()}
        kw = {"train": train}
        if train and rng is not None and takes_rng(self.module):
            kw["rng"] = rng
        logits = torch.func.functional_call(
            self.module, {**variables["params"], **stats}, (x,), kw)
        return logits, ({"batch_stats": stats} if train and stats else {})

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        """Device-side input preprocessing (default identity), e.g. to
        stage uint8 images and scale them on the card::

            def preprocess(self, x):
                return x.to(torch.bfloat16) / 127.5 - 1.0
        """
        return x

    def per_sample_loss(self, logits: torch.Tensor, y: torch.Tensor
                        ) -> torch.Tensor:
        """Per-sample losses [B]; default integer-label cross-entropy."""
        return F.cross_entropy(logits, y.long(), reduction="none")

    def per_sample_correct(self, logits: torch.Tensor, y: torch.Tensor
                           ) -> torch.Tensor:
        """Per-sample 0/1 correctness [B]; default argmax match."""
        return (logits.argmax(dim=-1) == y).float()

    def configure_optimizers(self, params: Iterable[nn.Parameter]
                             ) -> torch.optim.Optimizer:
        """A fresh optimizer over ``params``; default plain SGD at the
        job's lr."""
        return torch.optim.SGD(params, lr=self.lr)

    def serving_remap(self):
        """A restore-time re-layout of this model's checkpoints into the
        serving module's layout (``storage.sharded_checkpoint.
        apply_remap_host``: ``stored_path -> None | [(target_path,
        index_prefix)]``), or None (default) when they already match."""
        return None

    def infer(self, variables: Variables, x: torch.Tensor) -> torch.Tensor:
        """Prediction for raw inference payloads; default class ids."""
        logits, _ = self.forward(variables, x, train=False)
        return logits.argmax(dim=-1)
