"""Paged attention: attend straight through per-row page tables.

Port of ``kubeml_tpu/ops/paged_attention.py``. The paged serving engine
keeps K/V in one shared physical arena ``[kv_pages, page_tokens, H, D]``
addressed through per-row page tables ``pages [B, P]``; query ``l`` of row
``b`` sits at logical position ``positions[b] + l`` and attends every key
at or before it (a purely positional mask).

Two versions of one function:

* :func:`paged_attention` - the wrapper of the hand-written CUDA kernel
  (``csrc/paged_attention.cu``, the port of the Pallas ``_pa_kernel``): one
  launch a call, pages streamed by TMA into a shared-memory ring,
  a row's page walk split over a thread-block cluster and merged inside
  it. It walks each row's pages up to the row's live depth and never
  builds a contiguous copy of the table. It launches the kernel for CUDA
  tensors and takes the plain version for CPU tensors; there is no other
  fallback. :func:`_plan` sizes the launch.
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

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import kernels
from .attention import dot_product_attention

VALID_IMPLS = ("auto", "cuda", "pallas", "gather")

VALID_KV_QUANT = ("off", "int8", "auto")

# dequant convention shared with the write path in models/gpt.py: an int8
# page value q reconstructs as q * scale / 127 where scale is the page's
# per-head running absmax
_KV_QMAX = 127.0

# launch limits of csrc/paged_attention.cu: consumer warps a block, blocks a
# cluster, tokens a TMA box, head dim; a ring of at most _MAX_STAGES stages
# within _SMEM_BUDGET, so that two blocks share an SM (the kernel takes up
# to 227 KB). L up to _DECODE_MAX_L[bytes a K/V value] takes the decode
# mapping (a warp per (head, query), in tiles of at most 7 queries), longer
# L the tile mapping (lanes over queries). The mapping thresholds and the
# cluster targets in _plan come from sweeps on the H100 at GPT-2-small
# width (``scripts/kernel_timing.py paged-mapping``; PERF.md): the decode
# mapping is the faster one up to L 64 over f32 and bf16 arenas, up to 12
# over int8 ones.
_MAX_WARPS, _MAX_CLUSTER, _MAX_BOX, _MAX_D = 7, 8, 256, 128
_MAX_STAGES, _SMEM_BUDGET = 8, 112 * 1024
_DECODE_MAX_L = {4: 64, 2: 64, 1: 12}


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
    if D > _MAX_D:
        raise ValueError(f"head dim {D} > {_MAX_D} is not supported by the "
                         f"kernel")
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
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the arenas must be 16-byte aligned")


class Plan(NamedTuple):
    """One launch of the kernel and its block's shared-memory layout (the
    ``Plan`` struct of csrc/paged_attention.cu, field for field): ``hg``
    heads and ``qtile`` queries a block, the ``tile`` mapping or the decode
    one, a ring of ``stages`` stages of ``ct``-token slabs (``ct`` divides
    the page), ``cluster`` blocks splitting a tile's slabs, ``warps``
    consumer warps; a stage holds a K box and a V box of ``box_bytes``
    (``[ct, hg, DP]``, DP the head dim padded to 64 or 128) and the int8
    scales; ``area_bytes`` holds the ring and the merge buffer, ``smem``
    that and the mbarriers; ``tma`` streams slabs by TMA (else the
    producer copies them value by value: rows of D values whose bytes are
    not a multiple of 16)."""
    hg: int
    qtile: int
    tile: bool
    stages: int
    cluster: int
    ct: int
    warps: int
    box_bytes: int
    stage_bytes: int
    area_bytes: int
    smem: int
    tma: bool


class _CPlan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in Plan._fields]


@functools.lru_cache(maxsize=4096)
def _plan(B: int, L: int, H: int, D: int, pt: int, P: int, es: int,
          quant: bool, sm_count: int) -> Plan:
    """The launch for q ``[B, L, H, D]`` over ``[N, pt, H, D]`` arenas of
    ``es``-byte values and ``[B, P]`` tables. Head groups of 4, halved
    while (decode mapping) more than one query tile's warps would not fit a
    block, or while the grid (with 8-rank clusters) cannot fill the card;
    then the head group and after it the slab shrink until the stages the
    mapping needs (3 tile, 6 decode: it holds two slabs a pass) fit the
    budget; then clusters of ranks to about four blocks an SM for the
    decode mapping, two for the tile mapping."""
    dp = 64 if D <= 64 else 128
    tile = L > _DECODE_MAX_L[es]
    lpw = 2048 // dp  # tile mapping: queries a warp

    def qtile_of(hg):
        if tile:
            return lpw * max(1, min(_MAX_WARPS // hg, -(-L // lpw)))
        return min(L, _MAX_WARPS // hg)

    def layout(hg, ct, stages):
        """(warps, box, stage, area, smem) bytes of a block: a stage holds
        the slab's K box and V box, each rounded up to 128 bytes, then 128
        bytes of int8 scales; the merge buffer of split walks (a lane's m,
        l and values per query; tile: 2 x 32) shares the ring's space;
        mbarriers and 128 bytes of alignment after."""
        warps = hg * (qtile_of(hg) // lpw if tile else qtile_of(hg))
        box = -(-ct * hg * dp * es // 128) * 128
        stage = 2 * box + (128 if quant else 0)
        area = max(stages * stage,
                   warps * 32 * (68 if tile else dp // 32 + 2) * 4)
        return warps, box, stage, area, area + 16 * stages + 128

    def divisor_below(n):  # the largest divisor of pt below n
        return max(d for d in range(1, n) if pt % d == 0)

    hg = 4 if H >= 4 else 2 if H >= 2 else 1
    if not tile:
        while hg > 1 and hg * L > _MAX_WARPS:
            hg //= 2
    while hg > 1 and (B * -(-H // hg) * -(-L // qtile_of(hg)) * _MAX_CLUSTER
                      < sm_count):
        hg //= 2
    need = 3 if tile else 6
    ct = pt if pt <= _MAX_BOX else divisor_below(_MAX_BOX + 1)
    while hg > 1 and need * layout(hg, ct, 1)[2] > _SMEM_BUDGET:
        hg //= 2
    while ct > 1 and need * layout(hg, ct, 1)[2] > _SMEM_BUDGET:
        ct = divisor_below(ct)
    qtile = qtile_of(hg)
    stage = layout(hg, ct, 1)[2]
    slabs = P * (pt // ct)
    blocks = B * -(-H // hg) * -(-L // qtile)
    target = (2 if tile else 4) * sm_count
    cluster = max(1, min(_MAX_CLUSTER, slabs, -(-target // blocks)))
    per = -(-slabs // cluster)
    cluster = -(-slabs // per)  # no rank without slabs on a full table
    stages = max(2, min(_MAX_STAGES, _SMEM_BUDGET // stage, per))
    warps, box, stage, area, smem = layout(hg, ct, stages)
    return Plan(hg, qtile, tile, stages, cluster, ct, warps, box, stage, area,
                smem, (D * es) % 16 == 0)


@functools.lru_cache(maxsize=4096)
def _plan_struct(plan: Plan) -> _CPlan:
    """The plan as the C struct the entry point reads (kept alive here)."""
    return _CPlan(*plan)


def map_stats() -> dict:
    """The kernel library's table of arena tensor maps since the process
    started: maps ``encoded``, times the table was ``cleared`` (full), maps
    ``held``. Serving runs read it to see that calls find their maps."""
    out = (ctypes.c_longlong * 3)()
    kernels.library().kubeml_paged_attention_map_stats(out)
    return dict(encoded=out[0], cleared=out[1], held=out[2])


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
    pt = int(k_pages.shape[1])
    plan = _plan(B, L, H, D, pt, P, k_pages.element_size(),
                 k_scale is not None, kernels.sm_count(q.device.index))
    codes = kernels.DTYPE_CODES
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = kernels.library().kubeml_paged_attention(
        ptr(q), ptr(k_pages), ptr(v_pages), ptr(k_scale), ptr(v_scale),
        ptr(pages), ptr(positions), ptr(out), B, L, H, D,
        int(k_pages.shape[0]), pt, P, ctypes.byref(_plan_struct(plan)),
        codes[str(q.dtype).split(".")[-1]],
        codes[str(k_pages.dtype).split(".")[-1]],
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


# launches of the CUDA kernel since the last reset (a plain counter: the
# serving smoke run zeroes it before driving the engine and reads it after)
paged_attention.launches = 0
