"""Weight-only int8 matmul ``y = (x @ Q) * s`` for the decode path.

Port of ``kubeml_tpu/ops/int8_matmul.py``. The activations contract
against the int8 weight values directly and the per-output-channel scale
multiplies the f32 sum after the contraction, so no dense ``W~`` exists.

* :func:`int8_matmul` - the wrapper of the hand-written CUDA kernel
  (``csrc/int8_matmul.cu``, the port of the Pallas ``_mm_kernel``): one
  launch of warpgroup products with the int8 weights as the 64-row operand
  (converted to bf16 in registers), f32 x split exactly into three bf16
  terms, weights and x streamed into a shared-memory ring, split K over a
  thread-block cluster reduced in rank order, the scale once in the
  epilogue. It launches the kernel for CUDA tensors and takes
  :func:`int8_dot` for CPU tensors; there is no other fallback.
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

# tile geometry of csrc/int8_matmul.cu: a block computes 128 columns of y
# for an M tile of 8 or 32 rows over a K range walked in 64-deep chunks; a
# cluster of up to 8 blocks splits K
_M_TILES, _BN, _BK, _MAX_CLUSTER = (8, 32), 128, 64, 8
# blocks resident on one SM (bound by registers: about 100 a thread at M
# tile 8, 150 at 32), which sets how many blocks make one wave
_BLOCKS_PER_SM = {8: 3, 32: 2}


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
    """M tile, cluster size and K rows per cluster rank for one launch:
    8 rows for M <= 8 (decode), else 32 (measured faster than 64 at every
    prefill shape on the H100), then K split over a cluster only as far as
    needed for about one wave of blocks."""
    mt = next((t for t in _M_TILES if M <= t), _M_TILES[-1])
    tiles = -(-M // mt) * -(-N // _BN)
    chunks = -(-K // _BK)
    cluster = max(1, min(_MAX_CLUSTER, chunks,
                         _BLOCKS_PER_SM[mt] * sm_count // tiles))
    per = -(-chunks // cluster)  # K chunks per rank
    cluster = -(-chunks // per)  # no empty rank
    return mt, cluster, per * _BK


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
    mt, cluster, k_per_rank = _plan(M, K, N,
                                    kernels.sm_count(x.device.index))
    codes = kernels.DTYPE_CODES
    err = kernels.library().kubeml_int8_matmul(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), M, K, N, mt,
        cluster, k_per_rank, codes[str(x.dtype).split(".")[-1]],
        codes[str(out_dtype).split(".")[-1]],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return y.reshape(*lead, N)


# launches of the CUDA kernel since the last reset (see paged_attention)
int8_matmul.launches = 0
