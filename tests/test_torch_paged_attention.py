"""The port's paged attention (``kubeml_tpu_torch.ops.paged_attention``)
against the JAX package: the plain version against the Pallas kernel (run
in interpret mode, as the JAX suite runs it on the CPU) and against the JAX
gather-then-attend reference, at the JAX suite's shapes
(``tests/test_paged_attention.py``).

Tolerances: f32 2e-6 (f32 accumulation in another summation order), bf16
0.05 (one bf16 rounding of the inputs and of p; the JAX suite's bound),
int8 arenas 2e-5 (the dequantized values q*s/127 differ in the last bit
between a fold after the matmul and a dequant before it). The poisoned
arena must give bit-identical output: masked keys contribute exactly 0.
The CUDA kernel itself runs only on the card (``chip_smoke.py``); on CPU
tensors its wrapper takes the plain version, checked here too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeml_tpu.ops.attention import dot_product_attention as jax_attention
from kubeml_tpu.ops.paged_attention import paged_attention as jax_paged
from kubeml_tpu_torch.ops.paged_attention import (paged_attention,
                                                  paged_attention_ref,
                                                  resolve_kv_quant,
                                                  resolve_paged_attn)

CASES = [
    (1, [5, 0, 17]),        # per-token decode step at mixed depths
    (4, [3, 0, 12]),        # a 4-token window
    (8, [0, 8, 16]),        # suffix prefill, incl. page-aligned bases
]


def jax_gather(q, k_pages, v_pages, pages, positions):
    """The JAX gather path of models/gpt.py, on numpy inputs."""
    B, L = q.shape[:2]
    P, pt = pages.shape[1], k_pages.shape[1]
    H, D = k_pages.shape[2], k_pages.shape[3]
    kg = jnp.asarray(k_pages)[pages].reshape(B, P * pt, H, D)
    vg = jnp.asarray(v_pages)[pages].reshape(B, P * pt, H, D)
    k_pos = jnp.arange(P * pt)[None, None, None, :]
    pos_full = jnp.asarray(positions)[:, None] + jnp.arange(L)
    return np.asarray(jax_attention(jnp.asarray(q), kg, vg,
                                    mask=k_pos <= pos_full[:, None, :, None]))


def quantize_pages(pages_f32):
    """The write path's storage format, offline: per-page-per-head absmax
    scales ``[N, H]``, values ``round(x * 127 / scale)``."""
    amax = np.abs(pages_f32).max(axis=(1, 3))
    s = np.maximum(amax, 1e-30)
    q = np.clip(np.round(pages_f32 * 127.0 / s[:, None, :, None]),
                -127, 127).astype(np.int8)
    return q, amax.astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("L,positions", CASES)
def test_plain_matches_jax_kernel_and_gather_f32(L, positions):
    rng = np.random.default_rng(0)
    B, H, D, pt, P, N = 3, 2, 16, 4, 6, 20
    kp = rng.normal(size=(N, pt, H, D)).astype(np.float32)
    vp = rng.normal(size=(N, pt, H, D)).astype(np.float32)
    pages = rng.integers(1, N, size=(B, P)).astype(np.int32)
    q = rng.normal(size=(B, L, H, D)).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    out = paged_attention_ref(t(q), t(kp), t(vp), t(pages), t(pos)).numpy()
    ref_kernel = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kp),
                                      jnp.asarray(vp), jnp.asarray(pages),
                                      jnp.asarray(pos), interpret=True))
    np.testing.assert_allclose(out, ref_kernel, atol=2e-6, rtol=2e-6)
    np.testing.assert_allclose(out, jax_gather(q, kp, vp, pages, pos),
                               atol=2e-6, rtol=2e-6)
    # the kernel's wrapper takes the plain version for CPU tensors
    wrapped = paged_attention(t(q), t(kp), t(vp), t(pages), t(pos)).numpy()
    np.testing.assert_array_equal(wrapped, out)


def test_plain_bf16_storage_matches_jax_kernel():
    rng = np.random.default_rng(1)
    B, H, D, pt, P, N = 2, 2, 16, 4, 4, 12
    kp = rng.normal(size=(N, pt, H, D)).astype(np.float32)
    vp = rng.normal(size=(N, pt, H, D)).astype(np.float32)
    pages = rng.integers(1, N, size=(B, P)).astype(np.int32)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    pos = np.asarray([7, 11], np.int32)
    bf = lambda x: t(x).to(torch.bfloat16)
    out = paged_attention_ref(bf(q), bf(kp), bf(vp), t(pages), t(pos))
    assert out.dtype == torch.bfloat16
    ref = jax_paged(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
                    jnp.asarray(vp, jnp.bfloat16), jnp.asarray(pages),
                    jnp.asarray(pos), interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=0.05)


@pytest.mark.parametrize("L,positions", CASES)
def test_plain_int8_arena_matches_jax_kernel(L, positions):
    rng = np.random.default_rng(10)
    B, H, D, pt, P, N = 3, 2, 16, 4, 6, 20
    kq, ks = quantize_pages(rng.normal(size=(N, pt, H, D)).astype(np.float32))
    vq, vs = quantize_pages(rng.normal(size=(N, pt, H, D)).astype(np.float32))
    pages = rng.integers(1, N, size=(B, P)).astype(np.int32)
    q = rng.normal(size=(B, L, H, D)).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    out = paged_attention_ref(t(q), t(kq), t(vq), t(pages), t(pos),
                              k_scale=t(ks), v_scale=t(vs)).numpy()
    ref = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kq),
                               jnp.asarray(vq), jnp.asarray(pages),
                               jnp.asarray(pos), interpret=True,
                               k_scale=jnp.asarray(ks),
                               v_scale=jnp.asarray(vs)))
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("int8", [False, True])
def test_poisoned_arena_cannot_leak(int8):
    """Every arena position a live row did NOT write - trash page 0,
    unallocated pages, the slots past each row's cursor - is poisoned; the
    output must be bit-identical to the clean run (and, int8, unallocated
    pages' scales are poisoned too)."""
    rng = np.random.default_rng(2)
    B, H, D, pt, P, N = 2, 2, 8, 4, 4, 10
    positions = np.array([5, 9], np.int32)
    pages = np.zeros((B, P), np.int32)
    pages[0, :2] = [3, 4]
    pages[1, :3] = [5, 6, 7]
    clean = np.zeros((N, pt, H, D), np.float32)
    written = set()
    for b in range(B):
        for p_log in range(positions[b] + 1):
            phys, off = pages[b, p_log // pt], p_log % pt
            clean[phys, off] = rng.normal(size=(H, D))
            written.add((phys, off))
    q = t(rng.normal(size=(B, 1, H, D)).astype(np.float32))
    kw_clean, kw_poison = {}, {}
    if int8:
        clean, scales = quantize_pages(clean)
        poison_scales = scales.copy()
        for phys in range(N):
            if phys not in {3, 4, 5, 6, 7}:
                poison_scales[phys] = 1e9  # incl. trash page 0
        kw_clean = dict(k_scale=t(scales), v_scale=t(scales))
        kw_poison = dict(k_scale=t(poison_scales), v_scale=t(poison_scales))
    poisoned = clean.copy()
    for phys in range(N):
        for off in range(pt):
            if (phys, off) not in written:
                poisoned[phys, off] = 127 if int8 else 1e9
    out_clean = paged_attention_ref(q, t(clean), t(clean), t(pages),
                                    t(positions), **kw_clean)
    out_poison = paged_attention_ref(q, t(poisoned), t(poisoned), t(pages),
                                     t(positions), **kw_poison)
    torch.testing.assert_close(out_poison, out_clean, rtol=0, atol=0)


def test_resolver_values():
    assert resolve_paged_attn("gather", "cpu") == "gather"
    assert resolve_paged_attn("gather", "cuda") == "gather"
    # "pallas" is the legacy name of the kernel, so config values carry over
    assert resolve_paged_attn("pallas", "cpu") == "cuda"
    assert resolve_paged_attn("cuda", "cpu") == "cuda"
    assert resolve_paged_attn("auto", "cpu") == "gather"
    assert resolve_paged_attn(None, "cpu") == "gather"
    assert resolve_paged_attn("auto", "cuda") == "cuda"
    with pytest.raises(ValueError):
        resolve_paged_attn("einsum", "cpu")
    assert resolve_kv_quant(None) == "off"
    assert resolve_kv_quant("int8") == "int8"
    assert resolve_kv_quant("auto") == "off"
    with pytest.raises(ValueError):
        resolve_kv_quant("fp8")


def test_wrapper_rejects_unpaired_scales():
    q = torch.zeros(1, 1, 2, 8)
    arena = torch.zeros(4, 4, 2, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="together"):
        paged_attention(q, arena, arena, torch.zeros(1, 2, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32),
                        k_scale=torch.ones(4, 2))


@pytest.mark.parametrize("H,D,pt,es", [
    (12, 64, 16, 4),    # GPT-2 small, f32 arena
    (12, 64, 16, 2),    # GPT-2 small, bf16 arena
    (12, 64, 16, 1),    # GPT-2 small, int8 arena
    (16, 128, 16, 4),   # H 16 / D 128
    (16, 128, 32, 4),   # head groups shrink to fit
    (16, 128, 8, 1),
    (12, 64, 8, 2),
    (12, 64, 32, 1),
    (3, 64, 16, 4),     # a ragged head group
    (4, 16, 16, 4),     # GPTTiny (D 16, padded to 64)
    (8, 96, 16, 2),     # D 96, padded to 128
    (4, 20, 16, 1),     # rows TMA cannot address: copied value by value
    (16, 128, 128, 4),  # large pages: slabs of part of a page
    (16, 128, 256, 4),
    (12, 80, 100, 4),   # a page size that is no power of two
])
def test_launch_plan_covers_the_table(H, D, pt, es):
    """The kernel's launch plan (computed in Python, checked and used on
    the card) over B 1-64, P 1-64 and decode, spec-verify and prefill L:
    the slabs tile every page exactly once (ct divides pt, at most 256
    tokens, a TMA box's limit) and every rank of a full table gets slabs,
    the cluster has at most 8 blocks, the ring has at least two stages and
    the block at most 227 KB (boxes, scales, ring and merge buffer as the
    kernel lays them out), the head groups cover every head and the query
    tiles cover L."""
    from kubeml_tpu_torch.ops.paged_attention import _DECODE_MAX_L, _plan

    quant = es == 1
    dp = 64 if D <= 64 else 128
    lpw = 2048 // dp
    for B in (1, 3, 8, 64):
        for P in (1, 2, 7, 64):
            for L in (1, 2, 5, 7, 8, 16, 17, 32, 33, 128, 300):
                plan = _plan(B, L, H, D, pt, P, es, quant, 132)
                assert 1 <= plan.ct <= 256 and pt % plan.ct == 0
                slabs = P * pt // plan.ct
                assert 1 <= plan.cluster <= min(8, slabs)
                per = -(-slabs // plan.cluster)
                assert (plan.cluster - 1) * per < slabs
                assert 2 <= plan.stages and plan.smem <= 232448
                assert plan.box_bytes % 128 == 0
                assert plan.box_bytes >= plan.ct * plan.hg * dp * es
                assert plan.stage_bytes >= (2 * plan.box_bytes
                                            + (8 * plan.hg if quant else 0))
                assert plan.area_bytes >= plan.stages * plan.stage_bytes
                merge = plan.warps * 32 * (68 if plan.tile
                                           else dp // 32 + 2) * 4
                assert plan.area_bytes >= merge
                assert plan.smem >= plan.area_bytes + 16 * plan.stages + 128
                groups = -(-H // plan.hg)
                assert plan.hg <= H and (groups - 1) * plan.hg < H
                tiles = -(-L // plan.qtile)
                assert (tiles - 1) * plan.qtile < L <= tiles * plan.qtile
                assert plan.tile == (L > _DECODE_MAX_L[es])
                assert plan.warps == plan.hg * (plan.qtile // lpw
                                                if plan.tile else plan.qtile)
                assert 1 <= plan.warps <= 7
                if plan.tile:
                    assert plan.qtile % lpw == 0
                assert plan.tma == ((D * es) % 16 == 0)
