"""The port's flash attention (``kubeml_tpu_torch/ops/flash_attention.py``)
against the JAX package's Pallas kernels, which run here in interpret mode
as ``tests/test_ops.py`` runs them: forward output and per-row logsumexp,
and the FlashAttention-2 gradients, from the same numpy inputs. On CPU
tensors the port takes its plain versions, so these tests hold the plain
arithmetic the CUDA kernels are in turn held to on the card.

Tolerances, each with its reason:
- f32 output, lse and gradients: 1e-5 absolute and relative. Both sides
  compute in f32; the Pallas kernel's online softmax rescales block by
  block where the plain version takes one max per row, and sums run in
  other orders.
- bf16 output and gradients: one bf16 ulp of each element (2^-7 of its
  value) plus 2^-8 of the tensor's rms for elements near zero. Both sides
  are bf16 and round P and dS to bf16 before the products, as the kernels
  do, so they agree to within one rounding flip of each value (observed:
  identical).
- f64 gradcheck: torch's defaults (eps 1e-6, atol 1e-5, rtol 1e-3).
Padded keys must get exactly zero dK and dV on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeml_tpu.ops.flash_attention import _flash_fwd_impl
from kubeml_tpu.ops.flash_attention import flash_attention as jax_flash
from kubeml_tpu_torch.ops import attention, flash_attention as fa

TOL = dict(atol=1e-5, rtol=1e-5)


def bf16_tol(ref) -> dict:
    """One bf16 ulp of each element, plus 2^-8 of the rms near zero."""
    return dict(rtol=2.0 ** -7, atol=2.0 ** -8 * float(np.sqrt(np.mean(
        np.square(ref)))))


def qkv(rng, b=2, l=64, h=2, d=16, lk=None):
    lk = l if lk is None else lk
    mk = lambda lx: rng.normal(size=(b, lx, h, d)).astype(np.float32)
    return mk(l), mk(lk), mk(lk)


def jax_fwd(q, k, v, valid, causal, block=512, dtype=jnp.float32):
    """JAX output and lse [B, H, Lq] (the kernel returns it padded)."""
    valid = (np.ones(k.shape[:2], np.float32) if valid is None
             else valid.astype(np.float32))
    out, lse = _flash_fwd_impl(
        *(jnp.asarray(t, dtype) for t in (q, k, v)), jnp.asarray(valid),
        causal=causal, block_q=block, block_k=block, interpret=True,
        return_lse=True)
    return (np.asarray(out.astype(jnp.float32)),
            np.asarray(lse)[:, :, 0, :q.shape[1]])


def torch_fwd(q, k, v, valid, causal, dtype=torch.float32):
    t = lambda x: torch.from_numpy(x).to(dtype)
    out, lse = fa.flash_attention_fwd_ref(
        t(q), t(k), t(v), None if valid is None else torch.from_numpy(valid),
        causal)
    return out.float().numpy(), lse.numpy()


def jax_grads(q, k, v, cot, valid=None, causal=False, block=512,
              dtype=jnp.float32):
    def fn(q, k, v):
        return jax_flash(q, k, v, causal=causal,
                         kv_valid=None if valid is None else jnp.asarray(valid),
                         block_q=block, block_k=block, interpret=True)
    args = [jnp.asarray(t, dtype) for t in (q, k, v)]
    _, vjp = jax.vjp(fn, *args)
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(cot, dtype))]


def torch_grads(q, k, v, cot, valid=None, causal=False, dtype=torch.float32):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*ts, causal=causal, kv_valid=None if valid is None
                             else torch.from_numpy(valid))
    out.backward(torch.from_numpy(cot).to(dtype))
    return [t.grad.float().numpy() for t in ts]


@pytest.mark.parametrize("case", ["plain", "causal", "kv_valid",
                                  "causal_valid_odd", "cross", "multiblock"])
def test_forward_and_lse_match_jax(rng, case):
    """The cases of test_ops.py's forward tests (plain, causal, kv_valid,
    causal + valid at odd lengths, Lq != Lk, several blocks)."""
    causal = case in ("causal", "causal_valid_odd", "multiblock")
    block, valid = 512, None
    if case == "cross":
        q, k, v = qkv(rng, l=24, lk=72)
    elif case == "multiblock":
        q, k, v = qkv(rng, b=1, l=80, h=1, d=8)
        block = 16
    elif case == "causal_valid_odd":
        q, k, v = qkv(rng, l=50)
    else:
        q, k, v = qkv(rng)
    if case == "kv_valid":
        valid = (rng.random(size=q.shape[:2]) > 0.3).astype(np.float32)
        valid[:, 0] = 1.0
    elif case == "causal_valid_odd":
        valid = np.ones(q.shape[:2], np.float32)
        valid[:, 40:] = 0.0
    jo, jl = jax_fwd(q, k, v, valid, causal, block=block)
    to, tl = torch_fwd(q, k, v, valid, causal)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)


def test_forward_bf16_matches_jax(rng):
    q, k, v = qkv(rng)
    jo, jl = jax_fwd(q, k, v, None, True, dtype=jnp.bfloat16)
    out, lse = fa.flash_attention_fwd_ref(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), None, True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), jo, **bf16_tol(jo))
    np.testing.assert_allclose(lse.numpy(), jl, **TOL)


def test_fully_masked_rows_give_zero_output_and_huge_negative_lse():
    q = torch.randn(1, 4, 1, 8)
    out, lse = fa.flash_attention_fwd_ref(q, q, q, torch.zeros(1, 4), True)
    assert torch.equal(out, torch.zeros_like(out))
    assert (lse < -1e29).all()


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_multiblock_match_jax(rng, causal):
    """Several q and k blocks on the JAX side (8 in interpret mode), so its
    dK/dV walk starts at the diagonal and both kernels recompute P."""
    q, k, v = qkv(rng, b=2, l=32, h=2, d=8)
    cot = rng.normal(size=q.shape).astype(np.float32)
    for a, b in zip(torch_grads(q, k, v, cot, causal=causal),
                    jax_grads(q, k, v, cot, causal=causal, block=8)):
        np.testing.assert_allclose(a, b, **TOL)


def test_gradients_kv_valid_odd_lengths_zero_on_padded_keys(rng):
    q, k, v = qkv(rng, b=1, l=19, h=1, d=8, lk=27)
    valid = np.ones((1, 27), np.float32)
    valid[:, 21:] = 0.0
    cot = rng.normal(size=q.shape).astype(np.float32)
    tg = torch_grads(q, k, v, cot, valid=valid, causal=True)
    jg = jax_grads(q, k, v, cot, valid=valid, causal=True)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **TOL)
    for g in (tg[1], tg[2], jg[1], jg[2]):
        assert np.abs(g[:, 21:]).max() == 0.0


def test_gradients_cross_attention_match_jax(rng):
    q, k, v = qkv(rng, b=2, l=16, h=2, d=8, lk=48)
    cot = rng.normal(size=q.shape).astype(np.float32)
    for a, b in zip(torch_grads(q, k, v, cot), jax_grads(q, k, v, cot)):
        np.testing.assert_allclose(a, b, **TOL)


def test_gradients_bf16_match_jax(rng):
    q, k, v = qkv(rng, b=1, l=16, h=1, d=8)
    cot = rng.normal(size=q.shape).astype(np.float32)
    tg = torch_grads(q, k, v, cot, causal=True, dtype=torch.bfloat16)
    jg = jax_grads(q, k, v, cot, causal=True, dtype=jnp.bfloat16)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **bf16_tol(b))


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_gradcheck_and_plain_attention(causal):
    """``_FlashAttention`` in f64: its backward against finite differences,
    and its gradients against autograd through the plain
    ``dot_product_attention`` (which, in f64, also computes in f64)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 5, 2, 4, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    valid = torch.tensor([[1.0, 1.0, 1.0, 0.0, 1.0]])
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa._FlashAttention.apply(q, k, v, valid, causal),
        (q, k, v))
    cot = torch.randn(1, 5, 2, 4, generator=g, dtype=torch.float64)
    flash = torch.autograd.grad(
        fa.flash_attention(q, k, v, causal=causal, kv_valid=valid), (q, k, v),
        cot)
    plain = torch.autograd.grad(
        attention.dot_product_attention(q, k, v, causal=causal,
                                        kv_valid=valid, impl="plain"),
        (q, k, v), cot)
    for a, b in zip(flash, plain):
        torch.testing.assert_close(a, b, atol=1e-10, rtol=1e-10)


def test_dispatch_impls():
    """The JAX ``impl`` values: "plain"/"xla" and "cuda"/"pallas"; the
    automatic choice takes the plain path on CPU tensors; a dense mask
    with the kernels raises, as in JAX."""
    q = torch.randn(1, 6, 2, 8, requires_grad=True)
    mask = torch.ones(1, 1, 6, 6, dtype=torch.bool)
    for impl in ("cuda", "pallas"):
        out = attention.dot_product_attention(q, q, q, causal=True, impl=impl)
        assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
        with pytest.raises(ValueError, match="dense mask"):
            attention.dot_product_attention(q, q, q, mask, impl=impl)
    for impl in (None, "auto", "plain", "xla"):
        out = attention.dot_product_attention(q, q, q, causal=True, impl=impl)
        assert "Flash" not in type(out.grad_fn).__name__
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention.dot_product_attention(q, q, q, impl="sdpa")
    assert attention.FLASH_MIN_KV_LEN == 0


def test_cuda_wrapper_rejects_what_the_kernels_do_not_take():
    """The checks run before any launch (here on CPU tensors)."""
    valid = torch.ones(1, 4)
    mk = lambda d, dt=torch.float32: torch.zeros(1, 4, 2, d, dtype=dt)
    with pytest.raises(ValueError, match="head dim 32"):
        fa._check_cuda_args(mk(32), mk(32), mk(32), valid)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._check_cuda_args(mk(64, torch.float16), mk(64), mk(64), valid)
    with pytest.raises(TypeError, match="share one dtype"):
        fa._check_cuda_args(mk(64), mk(64, torch.bfloat16), mk(64), valid)
    with pytest.raises(ValueError, match="kv_valid"):
        fa._check_cuda_args(mk(64), mk(64), mk(64), torch.ones(1, 3))
    fa._check_cuda_args(mk(128), mk(128), mk(128), valid)
