"""Flash attention: forward and FlashAttention-2 backward.

Port of ``kubeml_tpu/ops/flash_attention.py``. Queries ``[B, Lq, H, D]``
attend keys and values ``[B, Lk, H, D]`` under two structured masks:
``causal`` (key position <= query position, both counted from 0, also when
Lq != Lk) and ``kv_valid [B, Lk]`` (> 0 = a real key). The forward writes
the output and the per-row logsumexp ``lse [B, H, Lq]`` (f32); the backward
recomputes the probabilities from ``lse`` tile by tile, so the ``[Lq, Lk]``
score matrix never exists in device memory in either direction.

Two versions of each function:

* the wrappers of the hand-written CUDA kernels in ``csrc/flash_attention.cu``
  (:func:`_flash_fwd_cuda`, :func:`_flash_dq_cuda`, :func:`_flash_dkv_cuda`,
  the ports of the Pallas ``_fa_kernel``, ``_dq_kernel`` and
  ``_dkv_kernel``). Each counts its launches on :func:`flash_attention`
  (``fwd_launches``, ``dq_launches``, ``dkv_launches``);
* the plain PyTorch versions :func:`flash_attention_fwd_ref` and
  :func:`flash_attention_bwd_ref`. They follow the Pallas kernels'
  arithmetic, not ``dot_product_attention``'s: scores are the f32 product
  times ``1/sqrt(D)``, masked scores are ``-1e30`` and their weights exactly
  0, the row sum is clamped at ``1e-9``, P is rounded to v's dtype before
  P.V, dS to k's dtype for dQ and to q's dtype for dK. They run on CPU
  tensors, and on the card only as the oracle the kernels are held against.

:func:`flash_attention` is the public entry point, differentiable through
:class:`_FlashAttention` (the counterpart of the JAX ``custom_vjp``). CUDA
tensors launch the kernels; CPU tensors take the plain versions. There is
no other branch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import kernels

_NEG = -1e30  # masked score; exp() of a fully masked row stays finite

# head dims and dtypes the CUDA kernels are instantiated for
SUPPORTED_HEAD_DIMS = (64, 128)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def _scale(d: int) -> float:
    """``1/sqrt(D)`` rounded to f32 once, as the kernels compute it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for f32/bf16 inputs; f64 inputs keep f64 (gradient checks)."""
    return torch.promote_types(dtype, torch.float32)


def _masked_scores(q, k, kv_valid, causal: bool) -> torch.Tensor:
    """``[B, H, Lq, Lk]`` scaled scores in the accumulation dtype, masked
    entries ``-1e30``."""
    acc = _acc_dtype(q.dtype)
    lq, lk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * _scale(
        q.shape[-1])
    keep = torch.ones((1, 1, lq, lk), dtype=torch.bool, device=q.device)
    if kv_valid is not None:
        keep = keep & (kv_valid[:, None, None, :] > 0)
    if causal:
        keep = keep & (torch.arange(lk, device=q.device)[None, :]
                       <= torch.arange(lq, device=q.device)[:, None])
    return torch.where(keep, s, torch.full_like(s, _NEG))


def _probs(s, m) -> torch.Tensor:
    """``exp(s - m)`` with masked scores' weights exactly 0."""
    return torch.where(s <= _NEG / 2, torch.zeros_like(s), torch.exp(s - m))


def flash_attention_fwd_ref(q, k, v, kv_valid=None, causal: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: ``(out [B, Lq, H, D] in q's dtype, lse [B, H, Lq])``."""
    acc = _acc_dtype(q.dtype)
    s = _masked_scores(q, k, kv_valid, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = _probs(s, m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(acc), v.to(acc))
    out = (pv / l.permute(0, 2, 1, 3)).to(q.dtype)
    lse = (m + torch.log(l)).squeeze(-1)
    return out, lse


def _dsum(dout, out) -> torch.Tensor:
    """``rowsum(dO * O)`` as ``[B, H, Lq]``: the FA2 row term, an
    elementwise pass outside the kernels (as in the JAX package)."""
    acc = _acc_dtype(out.dtype)
    return (dout.to(acc) * out.to(acc)).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_ref(q, k, v, kv_valid, out, lse, dout,
                            causal: bool = False):
    """Plain FlashAttention-2 backward: ``(dq, dk, dv)`` in the dtypes of
    q, k and v."""
    acc = _acc_dtype(q.dtype)
    s = _masked_scores(q, k, kv_valid, causal)
    p = _probs(s, lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.to(acc), v.to(acc))
    ds = p * (dp - _dsum(dout, out)[..., None]) * _scale(q.shape[-1])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).to(acc), k.to(acc))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).to(acc), q.to(acc))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).to(acc),
                      dout.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --- the CUDA kernels --------------------------------------------------


def _check_cuda_args(q, k, v, valid) -> None:
    B, Lq, H, D = q.shape
    if q.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if k.dim() != 4 or k.shape[0] != B or k.shape[2:] != (H, D) \
            or v.shape != k.shape:
        raise ValueError(f"k and v must be [{B}, Lk, {H}, {D}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {D} is not supported by the flash "
                         f"kernels (supported: {SUPPORTED_HEAD_DIMS})")
    if Lq < 1 or k.shape[1] < 1:
        raise ValueError("flash attention needs Lq >= 1 and Lk >= 1")
    if valid.shape != (B, k.shape[1]):
        raise ValueError(f"kv_valid must be [{B}, {k.shape[1]}]")
    for t in (k, v, valid):
        if t.device != q.device:
            raise ValueError(f"all tensors must be on {q.device}, got "
                             f"{t.device}")


def _dense(t):
    """Contiguous, and 16-byte aligned for the bf16 kernels' TMA maps and
    vector loads (a contiguous view may start at an odd offset of its
    storage)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, *args) -> None:
    err = getattr(kernels.library(), name)(*args)
    kernels.check(err, name)


def _code(t) -> int:
    return kernels.DTYPE_CODES[str(t.dtype).split(".")[-1]]


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _flash_fwd_cuda(q, k, v, valid, causal: bool):
    """Forward kernel: ``(out, lse [B, H, Lq] f32)``. ``valid`` is f32
    ``[B, Lk]``."""
    _check_cuda_args(q, k, v, valid)
    q, k, v, valid = (_dense(t) for t in (q, k, v, valid))
    B, Lq, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Lq, dtype=torch.float32, device=q.device)
    _launch("kubeml_flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            valid.data_ptr(), out.data_ptr(), lse.data_ptr(), B, Lq,
            k.shape[1], H, D, int(causal), _code(q), _stream(q))
    flash_attention.fwd_launches += 1
    return out, lse


def _flash_dq_cuda(q, k, v, valid, lse, dout, dsum, causal: bool):
    """dQ kernel: one block per (b, h, q-tile) walks the K/V tiles."""
    _check_cuda_args(q, k, v, valid)
    q, k, v, valid, lse, dout, dsum = (_dense(t) for t in (
        q, k, v, valid, lse, dout, dsum))
    B, Lq, H, D = q.shape
    dq = torch.empty_like(q)
    _launch("kubeml_flash_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            valid.data_ptr(), lse.data_ptr(), dout.data_ptr(),
            dsum.data_ptr(), dq.data_ptr(), B, Lq, k.shape[1], H, D,
            int(causal), _code(q), _stream(q))
    flash_attention.dq_launches += 1
    return dq


def _flash_dkv_cuda(q, k, v, valid, lse, dout, dsum, causal: bool):
    """dK/dV kernel: one block per (b, h, k-tile) walks the Q/dO tiles."""
    _check_cuda_args(q, k, v, valid)
    q, k, v, valid, lse, dout, dsum = (_dense(t) for t in (
        q, k, v, valid, lse, dout, dsum))
    B, Lq, H, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("kubeml_flash_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            valid.data_ptr(), lse.data_ptr(), dout.data_ptr(),
            dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Lq,
            k.shape[1], H, D, int(causal), _code(q), _stream(q))
    flash_attention.dkv_launches += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward through the kernel (CUDA) or the plain forward (CPU); the
    backward through the dQ and dK/dV kernels or the plain backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal: bool):
        if q.is_cuda:
            out, lse = _flash_fwd_cuda(q, k, v, kv_valid, causal)
        else:
            out, lse = flash_attention_fwd_ref(q, k, v, kv_valid, causal)
        ctx.save_for_backward(q, k, v, kv_valid, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        if q.is_cuda:
            dsum = _dsum(dout, out)
            dq = _flash_dq_cuda(q, k, v, kv_valid, lse, dout, dsum,
                                ctx.causal)
            dk, dv = _flash_dkv_cuda(q, k, v, kv_valid, lse, dout, dsum,
                                     ctx.causal)
        else:
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, kv_valid, out, lse,
                                                 dout, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash attention, differentiable; returns ``[B, Lq, H, D]`` in q's
    dtype. ``kv_valid [B, Lk]``: > 0 (or True) marks a real key."""
    if kv_valid is None:
        kv_valid = torch.ones(k.shape[:2], dtype=torch.float32,
                              device=k.device)
    return _FlashAttention.apply(q, k, v, kv_valid.to(torch.float32),
                                 causal)


# kernel launches since the last reset (plain counters: the smoke run
# zeroes them before driving the training path and reads them after)
flash_attention.fwd_launches = 0
flash_attention.dq_launches = 0
flash_attention.dkv_launches = 0
