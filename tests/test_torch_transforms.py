"""The port's ``data/transforms.py`` against the JAX package's: both are
pure numpy, so the same input and the same ``np.random.Generator`` state
must give bit-identical batches (and leave the generators in the same
state)."""

import numpy as np
import pytest

from kubeml_tpu.data import transforms as J
from kubeml_tpu_torch.data import transforms as T


def _images(dtype, seed=0, shape=(6, 12, 10, 3)):
    r = np.random.default_rng(seed)
    if dtype == np.uint8:
        return r.integers(0, 256, size=shape).astype(np.uint8)
    return r.normal(size=shape).astype(dtype)


def _both(fn_name, x, *args, **kw):
    gj, gt = np.random.default_rng(7), np.random.default_rng(7)
    out_j = getattr(J, fn_name)(x.copy(), *args, rng=gj, **kw)
    out_t = getattr(T, fn_name)(x.copy(), *args, rng=gt, **kw)
    assert gj.bit_generator.state == gt.bit_generator.state
    return out_j, out_t


def test_constants_are_the_jax_packages():
    for name in ("CIFAR10_MEAN", "CIFAR10_STD", "CIFAR100_MEAN",
                 "CIFAR100_STD", "MNIST_MEAN", "MNIST_STD"):
        assert getattr(T, name) == getattr(J, name)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
def test_normalize_bit_identical(dtype):
    x = _images(dtype)
    a = J.normalize(x, J.CIFAR100_MEAN, J.CIFAR100_STD)
    b = T.normalize(x, T.CIFAR100_MEAN, T.CIFAR100_STD)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn,kw", [
    ("random_crop", dict(padding=4)), ("random_crop", dict(padding=2,
                                                           fill=0.5)),
    ("random_crop", dict(padding=0)),
    ("random_horizontal_flip", dict()), ("random_horizontal_flip",
                                         dict(p=0.2)),
    ("cutout", dict(size=8)), ("cutout", dict(size=3, fill=7.0)),
    ("cutout", dict(size=0))])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_random_transforms_bit_identical(fn, kw, dtype):
    x = _images(dtype, seed=1)
    a, b = _both(fn, x, **kw)
    assert a.dtype == b.dtype and a.shape == b.shape == x.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_cifar_recipes_bit_identical(dtype):
    x = _images(dtype, seed=2, shape=(8, 32, 32, 3))
    gj, gt = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(2):  # the second call continues each generator's stream
        a = J.cifar_train_transform(J.CIFAR100_MEAN, J.CIFAR100_STD,
                                    rng=gj)(x)
        b = T.cifar_train_transform(T.CIFAR100_MEAN, T.CIFAR100_STD,
                                    rng=gt)(x)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(J.cifar_eval_transform()(x),
                                  T.cifar_eval_transform()(x))
    composed = T.compose(lambda v: v + 1, lambda v: v * 2)
    np.testing.assert_array_equal(composed(x.astype(np.float32)),
                                  (x.astype(np.float32) + 1) * 2)
