"""VGG-11, the reference's CIFAR-100 demo model: the port of
``kubeml_tpu/models/vgg.py``.

NHWC inputs at the API, channels-last NCHW inside, as ``models/resnet.py``.
The plan's numbers are 3x3 SAME convs (without bias when followed by
BatchNorm), ``"M"`` a 2x2 max pool of stride 2; BatchNorm keeps f32
statistics with Flax's momentum 0.9. The classifier flattens in NHWC order
(Flax's ``reshape`` of an NHWC map), so ``Dense_0``'s rows line up with a
Flax tree's at any input size, then runs two hidden layers with dropout
(0.5 by default) drawn from the ``rng`` generator. Names are Flax's
auto-names (``Conv_i``, ``BatchNorm_i``, ``Dense_0..2``). ``dtype`` is the
compute dtype; parameters are f32 and logits f32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv, Dropout, QuantizableDense, flax_init_

VGG11_PLAN: Sequence[Union[int, str]] = (64, "M", 128, "M", 256, 256, "M",
                                         512, 512, "M", 512, 512, "M")


class VGG(nn.Module):
    """``forward(x [B, H, W, C], train, rng) -> f32 logits``. ``in_shape``
    is the inputs' (H, W, C): the first dense layer's width depends on it
    (Flax reads it off the first batch)."""

    def __init__(self, plan: Sequence[Union[int, str]] = VGG11_PLAN,
                 num_classes: int = 100, batch_norm: bool = True,
                 classifier_width: int = 512, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 in_shape: Sequence[int] = (32, 32, 3)):
        super().__init__()
        h, w, c = in_shape
        self.plan = tuple(plan)
        self.batch_norm = batch_norm
        self.dtype = dtype
        n_conv = 0
        for step in self.plan:
            if step == "M":
                h, w = h // 2, w // 2
                continue
            setattr(self, f"Conv_{n_conv}",
                    Conv(c, int(step), (3, 3), use_bias=not batch_norm,
                         dtype=dtype))
            if batch_norm:
                setattr(self, f"BatchNorm_{n_conv}", BatchNorm(int(step)))
            c = int(step)
            n_conv += 1
        self.Dense_0 = QuantizableDense(h * w * c, classifier_width,
                                        dtype=dtype)
        self.Dense_1 = QuantizableDense(classifier_width, classifier_width,
                                        dtype=dtype)
        self.Dense_2 = QuantizableDense(classifier_width, num_classes,
                                        dtype=dtype)
        self.drop = Dropout(dropout)
        flax_init_(self)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> channels-last NCHW
        i = 0
        for step in self.plan:
            if step == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = getattr(self, f"Conv_{i}")(x)
            if self.batch_norm:
                # BN statistics in f32 whatever the compute dtype
                x = getattr(self, f"BatchNorm_{i}")(x, train).to(self.dtype)
            x = F.relu(x)
            i += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        x = self.drop(F.relu(self.Dense_0(x)), train, rng)
        x = self.drop(F.relu(self.Dense_1(x)), train, rng)
        return self.Dense_2(x).float()


def VGG11(num_classes: int = 100, batch_norm: bool = True,
          dtype: torch.dtype = torch.float32, **kw) -> VGG:
    return VGG(VGG11_PLAN, num_classes=num_classes, batch_norm=batch_norm,
               dtype=dtype, **kw)
