"""LeNet-5 for MNIST: the port of ``kubeml_tpu/models/lenet.py``.

NHWC inputs at the API, channels-last NCHW inside; the flatten before the
first dense layer follows the NHWC order, as Flax's ``reshape`` does, so
``Dense_0``'s rows line up with a Flax tree's. ``dtype`` is the compute
dtype; parameters are f32 and logits f32. ``in_shape`` is the inputs'
(H, W, C): the first dense layer's width depends on it (Flax reads it off
the first batch).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, QuantizableDense, flax_init_


class LeNet(nn.Module):
    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32,
                 in_shape: Sequence[int] = (28, 28, 1)):
        super().__init__()
        h, w, c = in_shape
        self.dtype = dtype
        self.Conv_0 = Conv(c, 6, (5, 5), padding="SAME", dtype=dtype)
        self.Conv_1 = Conv(6, 16, (5, 5), padding="VALID", dtype=dtype)
        flat = 16 * ((h // 2 - 4) // 2) * ((w // 2 - 4) // 2)
        self.Dense_0 = QuantizableDense(flat, 120, dtype=dtype)
        self.Dense_1 = QuantizableDense(120, 84, dtype=dtype)
        self.Dense_2 = QuantizableDense(84, num_classes, dtype=dtype)
        flax_init_(self)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> channels-last NCHW
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x).float()
