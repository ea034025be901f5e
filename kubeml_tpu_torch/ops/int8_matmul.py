"""Weight-only int8 matmul ``y = (x @ Q) * s`` for the decode path.

Port of ``kubeml_tpu/ops/int8_matmul.py``. The activations contract
against the int8 weight values directly and the per-output-channel scale
multiplies the f32 sum after the contraction, so no dense ``W~`` exists.

* :func:`int8_matmul` - the wrapper of the hand-written CUDA kernel
  (``csrc/int8_matmul.cu``, the port of the Pallas ``_mm_kernel``): int8
  converts on its load into shared memory, f32 accumulation over all of K,
  the scale once in the epilogue, ragged edges masked in the kernel. It
  launches the kernel for CUDA tensors and takes :func:`int8_dot` for CPU
  tensors; there is no other fallback.
* :func:`int8_dot` - the plain PyTorch version (the JAX ``int8_dot``): the
  contraction in f32 on the int8-valued weights, then the scale. Accepts q
  of any rank (x's last axis against q's first).

``resolve_int8_matmul`` maps the serving knob: ``auto`` takes the kernel on
CUDA and ``int8_dot`` on the CPU, ``cuda`` (and the legacy ``pallas``) the
kernel, ``dot`` the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels

VALID_IMPLS = ("auto", "cuda", "pallas", "dot")

# tile geometry of csrc/int8_matmul.cu: output tiles are BM x 64 (BM 16 for
# decode-sized M, else 64), K is walked in 64-deep tiles
_BM_SMALL, _BM, _BN, _BK = 16, 64, 64, 64


def resolve_int8_matmul(value: Optional[str], device) -> str:
    """Resolve an int8-matmul knob to ``cuda`` (the kernel) or ``dot`` (the
    plain version) for tensors on ``device``."""
    v = (value or "auto").lower()
    if v not in VALID_IMPLS:
        raise ValueError(f"unknown int8 matmul impl {value!r} (valid: "
                         f"{', '.join(VALID_IMPLS)})")
    if v == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "dot"
    return "dot" if v == "dot" else "cuda"


def int8_dot(x, q, s, *, out_dtype=None):
    """Plain version of ``(x @ q) * s``: f32 contraction, scale after."""
    out_dtype = out_dtype or x.dtype
    acc = torch.tensordot(x.float(), q.float(), dims=([x.dim() - 1], [0]))
    # per-output-channel = per LAST axis of q, whatever its rank
    scale = s.float().reshape((1,) * (acc.dim() - 1) + (-1,))
    return (acc * scale).to(out_dtype)


def _plan(M: int, K: int, N: int, sm_count: int):
    """Tile height, K splits and K rows per split for one launch: split K
    only as far as needed to put about two blocks on every SM."""
    bm = _BM_SMALL if M <= _BM_SMALL else _BM
    tiles = -(-M // bm) * -(-N // _BN)
    k_tiles = -(-K // _BK)
    splits = max(1, min(k_tiles, -(-2 * sm_count // tiles)))
    per = -(-k_tiles // splits)  # K tiles per split
    splits = -(-k_tiles // per)  # no empty split
    return bm, splits, per * _BK


def int8_matmul(x, q, s, *, out_dtype=None):
    """``(x @ q) * s`` through the CUDA kernel.

    x ``[..., K]`` f32/bf16, q ``[K, N]`` int8, s with N elements (``[1, N]``
    or ``[N]``) f32. Returns ``[..., N]`` in ``out_dtype`` (default x's
    dtype). CPU tensors take :func:`int8_dot`."""
    if q.dim() != 2:
        raise ValueError(f"int8_matmul wants a 2-d quantized kernel, got "
                         f"shape {tuple(q.shape)}")
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return int8_dot(x, q, s, out_dtype=out_dtype)
    K, N = q.shape
    if x.shape[-1] != K:
        raise ValueError(f"x has {x.shape[-1]} features, q expects {K}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16")
    if q.dtype != torch.int8 or s.dtype != torch.float32 or s.numel() != N:
        raise ValueError("q must be int8 [K, N] and s float32 with N values")
    for t in (q, s):
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}")
        if not t.is_contiguous():
            raise ValueError("q and s must be contiguous")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return y.reshape(*lead, N)
    bm, splits, k_per_split = _plan(M, K, N,
                                    kernels.sm_count(x.device.index))
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    codes = kernels.DTYPE_CODES
    err = kernels.library().kubeml_int8_matmul(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
        ws.data_ptr() if ws is not None else None, M, K, N, bm, splits,
        k_per_split, codes[str(x.dtype).split(".")[-1]],
        codes[str(out_dtype).split(".")[-1]],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return y.reshape(*lead, N)


# launches of the CUDA kernel since the last reset (see paged_attention)
int8_matmul.launches = 0
