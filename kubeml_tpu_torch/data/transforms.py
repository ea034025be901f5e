"""Batched host-side data transforms, the torchvision-transforms
equivalent: a copy of ``kubeml_tpu/data/transforms.py`` (pure numpy, so
the same ``np.random.Generator`` gives bit-identical batches in both
packages).

Reference user functions compose torchvision transforms and switch them on
``is_training()`` (reference: ml/experiments/kubeml/function_resnet34.py:13-44:
RandomCrop(32, padding=4) + RandomHorizontalFlip + Normalize for train,
Normalize alone for val). ``KubeDataset.transform`` receives whole
``[B, H, W, C]`` numpy slabs per sync round (NHWC, the models' input
layout), so these transforms are **vectorized over the batch** instead of
per-item: one stride-tricks gather replaces B crop calls.

All randomness flows through an explicit ``numpy.random.Generator`` so a worker
can derive a per-round generator from (seed, epoch, round) and stay
reproducible under elastic re-sharding.

Example (the reference's CIFAR recipe)::

    from kubeml_tpu_torch.data import transforms as T

    class Cifar(KubeDataset):
        def transform(self, x, y):
            if self.is_training():
                rng = np.random.default_rng()
                x = T.random_crop(x, padding=4, rng=rng)
                x = T.random_horizontal_flip(x, rng=rng)
            return T.normalize(x, T.CIFAR10_MEAN, T.CIFAR10_STD), y
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

# channel statistics users would otherwise copy from torchvision docs
CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)
CIFAR100_MEAN = (0.5071, 0.4865, 0.4409)
CIFAR100_STD = (0.2673, 0.2564, 0.2762)
MNIST_MEAN = (0.1307,)
MNIST_STD = (0.3081,)


def _rng(rng: Optional[np.random.Generator]) -> np.random.Generator:
    return rng if rng is not None else np.random.default_rng()


def normalize(x: np.ndarray, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    """Per-channel ``(x - mean) / std`` over the trailing channel axis.

    uint8 inputs are first rescaled to [0, 1] (torchvision ``ToTensor``
    semantics — which rescales only uint8) so the published CIFAR/MNIST
    statistics apply directly to the uint8 slabs datasets store at rest;
    wider integer types pass through unscaled like floats."""
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 255.0
    mean = np.asarray(mean, x.dtype if np.issubdtype(x.dtype, np.floating) else np.float32)
    std = np.asarray(std, mean.dtype)
    return (x.astype(mean.dtype) - mean) / std


def random_crop(
    x: np.ndarray,
    padding: int = 4,
    rng: Optional[np.random.Generator] = None,
    fill: float = 0.0,
) -> np.ndarray:
    """Pad each image by ``padding`` on every side, then crop back to the
    original H×W at a per-sample random offset (torchvision
    ``RandomCrop(size, padding)``), vectorized over the batch.

    x: [B, H, W, C]."""
    if padding <= 0:
        return x
    g = _rng(rng)
    b, h, w, c = x.shape
    padded = np.pad(
        x, ((0, 0), (padding, padding), (padding, padding), (0, 0)),
        mode="constant", constant_values=fill,
    )
    # all crop windows as a view [B, 2p+1, 2p+1, H, W, C], then one gather at
    # the per-sample offsets — no per-item python loop
    windows = np.lib.stride_tricks.sliding_window_view(padded, (h, w), axis=(1, 2))
    oh = g.integers(0, 2 * padding + 1, size=b)
    ow = g.integers(0, 2 * padding + 1, size=b)
    out = windows[np.arange(b), oh, ow]  # [B, C, H, W] (window dims trail)
    return np.ascontiguousarray(np.moveaxis(out, 1, -1))


def random_horizontal_flip(
    x: np.ndarray, p: float = 0.5, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Flip a random subset of the batch left-right (torchvision
    ``RandomHorizontalFlip``). x: [B, H, W, C]."""
    g = _rng(rng)
    flip = g.random(x.shape[0]) < p
    out = x.copy()
    out[flip] = out[flip, :, ::-1]
    return out


def cutout(
    x: np.ndarray, size: int = 8, rng: Optional[np.random.Generator] = None,
    fill: float = 0.0,
) -> np.ndarray:
    """Zero one random ``size``×``size`` square per image (DeVries & Taylor
    2017) — a common CIFAR regularizer. Vectorized via broadcasted coordinate
    masks. x: [B, H, W, C]."""
    if size <= 0:
        return x
    g = _rng(rng)
    b, h, w, _ = x.shape
    cy = g.integers(0, h, size=b)[:, None]
    cx = g.integers(0, w, size=b)[:, None]
    rows = np.arange(h)[None, :]
    cols = np.arange(w)[None, :]
    half = size // 2
    row_in = (rows >= cy - half) & (rows < cy - half + size)  # [B, H]
    col_in = (cols >= cx - half) & (cols < cx - half + size)  # [B, W]
    mask = row_in[:, :, None] & col_in[:, None, :]  # [B, H, W]
    out = x.copy()
    out[mask] = fill
    return out


def compose(
    *fns: Callable[[np.ndarray], np.ndarray]
) -> Callable[[np.ndarray], np.ndarray]:
    """Chain image transforms left to right (torchvision ``Compose``)."""

    def run(x: np.ndarray) -> np.ndarray:
        for f in fns:
            x = f(x)
        return x

    return run


def cifar_train_transform(
    mean: Sequence[float] = CIFAR10_MEAN,
    std: Sequence[float] = CIFAR10_STD,
    padding: int = 4,
    rng: Optional[np.random.Generator] = None,
) -> Callable[[np.ndarray], np.ndarray]:
    """The reference's CIFAR train recipe (function_resnet34.py:13-26):
    RandomCrop(padding) + RandomHorizontalFlip + Normalize."""
    return compose(
        lambda x: random_crop(x, padding=padding, rng=rng),
        lambda x: random_horizontal_flip(x, rng=rng),
        lambda x: normalize(x, mean, std),
    )


def cifar_eval_transform(
    mean: Sequence[float] = CIFAR10_MEAN,
    std: Sequence[float] = CIFAR10_STD,
) -> Callable[[np.ndarray], np.ndarray]:
    """The reference's CIFAR eval recipe (function_resnet34.py:28-38):
    Normalize only."""
    return lambda x: normalize(x, mean, std)
