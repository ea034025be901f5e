"""Ranks sharing one card (needs an NVIDIA card: marker ``cuda``, skipped
without one). Imports torch and the port only, never JAX, so it runs on
the card's machine with ``--noconftest``:

    python -m pytest --noconftest -m cuda tests/test_torch_dist_cuda.py

Two ranks over gloo (passed explicitly) run Ulysses over ``sp=2`` through
the flash kernels, which the test process builds before it starts the
ranks: one forward, one dQ and one dK/dV launch a rank, and the output and
dQ/dK/dV gathered over the ranks equal the plain version on the whole
input (largest abs error over max(1, max |ref|): f32 1e-5, bf16 0.05, as
``chip_smoke.py`` phase 17 holds them). Two NCCL ranks on one card raise
an error that names ``backend="gloo"``."""

import pytest
import torch

import torch_dist_ranks as R
from kubeml_tpu_torch.parallel import distributed as D

pytestmark = pytest.mark.cuda

TOL = {"float32": 1e-5, "bfloat16": 0.05}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    from kubeml_tpu_torch.ops import kernels

    kernels.library()  # built once here, loaded by the ranks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ulysses_over_two_gloo_ranks_through_the_flash_kernels(card, dtype):
    ranks = R.run(R.cuda_ulysses_rank, 2, dtype)
    assert all(r["launches"] == (1, 1, 1) for r in ranks)
    assert all(r["device"] == "cuda:0" for r in ranks)
    assert ranks[0]["err"] <= TOL[dtype]


def test_two_nccl_ranks_on_one_card_are_refused(card):
    if torch.cuda.device_count() > 1:
        pytest.skip("the host has a card for each rank")
    with pytest.raises(Exception, match="backend='gloo'"):
        D.spawn(R.nccl_rank, 2, args=("unused",), timeout_s=120)
