"""ResNet family: the port of ``kubeml_tpu/models/resnet.py``.

The K-AVG flagship (ResNet-18 on CIFAR-10). The API stays NHWC
(``[B, H, W, C]``, as the JAX package's); inside, activations are NCHW
with channels-last strides, which is what cuDNN's tensor-core convolutions
read. Submodules carry Flax's auto-names (``Conv_0``, ``BatchNorm_0``,
``BasicBlock_3``, ``Dense_0``), so a Flax variables tree maps onto
``named_parameters``/``named_buffers`` name for name.

``dtype`` is the compute dtype of the convs and the dense head; parameters
stay f32 (the optimizer and the K-AVG average act on f32 masters),
BatchNorm runs in f32 and logits are f32. ``cifar_stem=True`` is the
3x3/stride-1 stem for 32x32 inputs; ``False`` the ImageNet 7x7/stride-2
stem with a 3x3/stride-2 SAME max-pool.
"""

from __future__ import annotations

from typing import Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv, QuantizableDense, flax_init_, max_pool_same


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, (3, 3), strides,
                           use_bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, (3, 3), use_bias=False,
                           dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters)
        # Flax projects the shortcut when its shape differs from the output
        self.project = strides != 1 or in_features != filters
        if self.project:
            self.Conv_2 = Conv(in_features, filters, (1, 1), strides,
                               use_bias=False, dtype=dtype)
            self.BatchNorm_2 = BatchNorm(filters)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        residual = (self.BatchNorm_2(self.Conv_2(x), train) if self.project
                    else x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = filters * self.expansion
        self.Conv_0 = Conv(in_features, filters, (1, 1), use_bias=False,
                           dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, use_bias=False,
                           dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, out, (1, 1), use_bias=False, dtype=dtype)
        self.BatchNorm_2 = BatchNorm(out)
        self.project = strides != 1 or in_features != out
        if self.project:
            self.Conv_3 = Conv(in_features, out, (1, 1), strides,
                               use_bias=False, dtype=dtype)
            self.BatchNorm_3 = BatchNorm(out)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = (self.BatchNorm_3(self.Conv_3(x), train) if self.project
                    else x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """``forward(x [B, H, W, C], train) -> f32 logits [B, num_classes]``.
    ``in_channels`` is the inputs' C (Flax reads it off the first batch)."""

    def __init__(self, stage_sizes: Sequence[int],
                 block: Type[nn.Module] = BasicBlock, num_classes: int = 10,
                 num_filters: int = 64, cifar_stem: bool = True,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        self.cifar_stem = cifar_stem
        if cifar_stem:
            self.Conv_0 = Conv(in_channels, num_filters, (3, 3),
                               use_bias=False, dtype=dtype)
        else:
            self.Conv_0 = Conv(in_channels, num_filters, (7, 7), 2,
                               use_bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(num_filters)
        self.blocks = []
        features = num_filters
        for i, n_blocks in enumerate(stage_sizes):
            filters = num_filters * 2 ** i
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                name = f"{block.__name__}_{len(self.blocks)}"
                self.add_module(name, block(features, filters, strides, dtype))
                self.blocks.append(name)
                features = filters * block.expansion
        self.Dense_0 = QuantizableDense(features, num_classes, dtype=dtype)
        flax_init_(self)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> channels-last NCHW
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        if not self.cifar_stem:
            x = max_pool_same(x, 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        x = x.float().mean(dim=(2, 3))
        return self.Dense_0(x).float()


def ResNet18(num_classes: int = 10, cifar_stem: bool = True,
             dtype: torch.dtype = torch.float32, **kw) -> ResNet:
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes=num_classes,
                  cifar_stem=cifar_stem, dtype=dtype, **kw)


def ResNet34(num_classes: int = 10, cifar_stem: bool = True,
             dtype: torch.dtype = torch.float32, **kw) -> ResNet:
    return ResNet([3, 4, 6, 3], BasicBlock, num_classes=num_classes,
                  cifar_stem=cifar_stem, dtype=dtype, **kw)


def ResNet50(num_classes: int = 10, cifar_stem: bool = True,
             dtype: torch.dtype = torch.float32, **kw) -> ResNet:
    return ResNet([3, 4, 6, 3], Bottleneck, num_classes=num_classes,
                  cifar_stem=cifar_stem, dtype=dtype, **kw)
