"""Paged attention: attend straight through per-row page tables.

Port of ``kubeml_tpu/ops/paged_attention.py``. The paged serving engine
keeps K/V in one shared physical arena ``[kv_pages, page_tokens, H, D]``
addressed through per-row page tables ``pages [B, P]``; query ``l`` of row
``b`` sits at logical position ``positions[b] + l`` and attends every key
at or before it (a purely positional mask).

Two versions of one function:

* :func:`paged_attention` - the wrapper of the hand-written CUDA kernel
  (``csrc/paged_attention.cu``, the port of the Pallas ``_pa_kernel``). It
  walks each row's pages up to the row's live depth and never builds a
  contiguous copy of the table. It launches the kernel for CUDA tensors
  and takes the plain version for CPU tensors; there is no other fallback.
* :func:`paged_attention_ref` - the plain PyTorch version: the gather-then-
  attend read of the paged decode branch (``kubeml_tpu/models/gpt.py``
  :246-264). It gathers each row's whole table into ``[B, P*pt, H, D]``,
  dequantizes int8 pages as ``q * scale / 127`` and attends under the
  positional mask. The CPU path, and the oracle the kernel is held against
  on the card.

``resolve_paged_attn`` maps the serving knob to one of them: ``auto`` takes
the kernel on CUDA and the plain version on the CPU, ``cuda`` (and the
legacy ``pallas``) the kernel, ``gather`` the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels
from .attention import dot_product_attention

VALID_IMPLS = ("auto", "cuda", "pallas", "gather")

VALID_KV_QUANT = ("off", "int8", "auto")

# dequant convention shared with the write path in models/gpt.py: an int8
# page value q reconstructs as q * scale / 127 where scale is the page's
# per-head running absmax
_KV_QMAX = 127.0

# query tile of csrc/paged_attention.cu (queries per block)
_QTILE = 16


def resolve_kv_quant(value: Optional[str]) -> str:
    """Resolve a KV storage knob to ``off`` or ``int8``. ``auto`` resolves
    to ``off``, as in the JAX package (reserved for a later auto-enable)."""
    v = (value or "off").lower()
    if v not in VALID_KV_QUANT:
        raise ValueError(f"unknown kv-quant mode {value!r} (valid: "
                         f"{', '.join(VALID_KV_QUANT)})")
    return "off" if v == "auto" else v


def resolve_paged_attn(value: Optional[str], device) -> str:
    """Resolve a paged-attention knob to ``cuda`` (the kernel) or ``gather``
    (the plain version) for arenas on ``device``."""
    v = (value or "auto").lower()
    if v not in VALID_IMPLS:
        raise ValueError(f"unknown paged-attention impl {value!r} (valid: "
                         f"{', '.join(VALID_IMPLS)})")
    if v == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "gather"
    return "gather" if v == "gather" else "cuda"


def paged_attention_ref(q, k_pages, v_pages, pages, positions,
                        k_scale=None, v_scale=None):
    """Plain version: gather the table, attend under the positional mask.
    Returns ``[B, L, H, D]`` in q's dtype."""
    B, L, H, D = q.shape
    pt = k_pages.shape[1]
    P = pages.shape[1]
    idx = pages.long()
    kg = k_pages[idx]  # [B, P, pt, H, D]
    vg = v_pages[idx]
    if k_scale is not None:
        kg = (kg.float() * (k_scale[idx] / _KV_QMAX)[:, :, None, :, None]
              ).to(q.dtype)
        vg = (vg.float() * (v_scale[idx] / _KV_QMAX)[:, :, None, :, None]
              ).to(q.dtype)
    kg = kg.reshape(B, P * pt, H, D)
    vg = vg.reshape(B, P * pt, H, D)
    k_pos = torch.arange(P * pt, device=q.device)[None, None, None, :]
    pos_full = positions.long()[:, None] + torch.arange(L, device=q.device)
    mask = k_pos <= pos_full[:, None, :, None]  # [B, 1, L, P*pt]
    return dot_product_attention(q, kg, vg, mask=mask)


def _check_cuda_args(q, k_pages, v_pages, pages, positions, k_scale,
                     v_scale) -> None:
    B, L, H, D = q.shape
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pages.dim() != 4 or k_pages.shape[2:] != (H, D):
        raise ValueError(f"k_pages must be [N, pt, {H}, {D}], got "
                         f"{tuple(k_pages.shape)}")
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages must share shape and dtype")
    quant = k_pages.dtype == torch.int8
    if quant != (k_scale is not None):
        raise ValueError("int8 arenas need k_scale/v_scale, and only they do")
    if k_pages.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise TypeError(f"unsupported arena dtype {k_pages.dtype}")
    if D > 128:
        raise ValueError(f"head dim {D} > 128 is not supported by the kernel")
    if pages.dtype != torch.int32 or pages.dim() != 2 or pages.shape[0] != B:
        raise ValueError(f"pages must be int32 [{B}, P], got {pages.dtype} "
                         f"{tuple(pages.shape)}")
    if positions.dtype != torch.int32 or positions.shape != (B,):
        raise ValueError(f"positions must be int32 [{B}], got "
                         f"{positions.dtype} {tuple(positions.shape)}")
    tensors = [q, k_pages, v_pages, pages, positions]
    if quant:
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or s.shape != (k_pages.shape[0], H):
                raise ValueError(f"scales must be float32 [N, {H}]")
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("paged_attention needs contiguous tensors")


def _split_pages(blocks: int, P: int, sm_count: int):
    """(splits, pages per split) for a grid of ``blocks`` (row, head, query
    tile) blocks over P-page tables: split the page walk until about eight
    blocks sit on every SM, keeping at least two pages per split."""
    splits = max(1, min(-(-P // 2), -(-8 * sm_count // blocks)))
    per = -(-P // splits)
    return -(-P // per), per


def paged_attention(q, k_pages, v_pages, pages, positions,
                    k_scale=None, v_scale=None):
    """Paged attention through the CUDA kernel; ``[B, L, H, D]`` in q's
    dtype.

    q ``[B, L, H, D]`` f32/bf16; arenas ``[N, pt, H, D]`` f32/bf16/int8
    (int8 with ``k_scale``/``v_scale`` ``[N, H]`` f32); pages ``[B, P]`` and
    positions ``[B]`` int32. Callers have already written this call's K/V
    into the arenas. CPU tensors take :func:`paged_attention_ref`."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if not q.is_cuda:
        return paged_attention_ref(q, k_pages, v_pages, pages, positions,
                                   k_scale, v_scale)
    _check_cuda_args(q, k_pages, v_pages, pages, positions, k_scale, v_scale)
    B, L, H, D = q.shape
    P = int(pages.shape[1])
    out = torch.empty_like(q)
    splits, per = _split_pages(B * H * -(-L // _QTILE), P,
                               kernels.sm_count(q.device.index))
    ws = (torch.empty(splits * B * L * H * (D + 2), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    lib = kernels.library()
    codes = kernels.DTYPE_CODES
    ptr = lambda t: t.data_ptr() if t is not None else None
    err = lib.kubeml_paged_attention(
        ptr(q), ptr(k_pages), ptr(v_pages), ptr(k_scale), ptr(v_scale),
        ptr(pages), ptr(positions), ptr(out), ptr(ws), B, L, H, D,
        int(k_pages.shape[1]), P, splits, per,
        codes[str(q.dtype).split(".")[-1]],
        codes[str(k_pages.dtype).split(".")[-1]],
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


# launches of the CUDA kernel since the last reset (a plain counter: the
# serving smoke run zeroes it before driving the engine and reads it after)
paged_attention.launches = 0
