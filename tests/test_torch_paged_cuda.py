"""The paged-attention CUDA kernel (``csrc/paged_attention.cu``) against its
plain version ``paged_attention_ref`` on an NVIDIA card. Card-only: every
test carries the ``cuda`` marker and skips on a host without a card.
Imports torch and the port only, so it runs on a machine without JAX::

    python -m pytest -m cuda tests/test_torch_paged_cuda.py

Tolerance, as ``chip_smoke.py`` holds the kernel (``PA_TOL``), absolute:
f32 1e-5 (both sum in f32, in other orders); bf16 0.05 (the plain version
rounds scores and p to bf16, the kernel keeps f32); int8 arenas 1e-5 (the
same int8 values, the scale folded after the product instead of before).
"""

import pytest
import torch

from kubeml_tpu_torch.ops.paged_attention import (_plan, paged_attention,
                                                  paged_attention_ref)

pytestmark = pytest.mark.cuda

PA_TOL = {torch.float32: 1e-5, torch.bfloat16: 0.05, torch.int8: 1e-5}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.Generator().manual_seed(0)


def inputs(g, positions, L, H, D, pt, P, kv_dtype, q_dtype=None):
    """q, arenas (+ scales), a table of distinct pages per row (page 0
    unused, as the engine's trash page)."""
    B = len(positions)
    n = B * P + 1
    q_dtype = q_dtype or (torch.float32 if kv_dtype == torch.int8
                          else kv_dtype)
    q = torch.randn(B, L, H, D, generator=g).to(q_dtype).cuda()
    kf = torch.randn(n, pt, H, D, generator=g)
    vf = torch.randn(n, pt, H, D, generator=g)
    pages = (torch.randperm(n - 1, generator=g) + 1).reshape(B, P)
    scales = {}
    if kv_dtype == torch.int8:
        ks, vs = kf.abs().amax(dim=(1, 3)), vf.abs().amax(dim=(1, 3))
        kf = torch.round(kf * 127 / ks[:, None, :, None]).clamp(-127, 127)
        vf = torch.round(vf * 127 / vs[:, None, :, None]).clamp(-127, 127)
        scales = dict(k_scale=ks.cuda(), v_scale=vs.cuda())
    return (q, kf.to(kv_dtype).cuda(), vf.to(kv_dtype).cuda(),
            pages.to(torch.int32).cuda(),
            torch.tensor(positions, dtype=torch.int32).cuda(), scales)


def edge_positions(B, pt, P, L, seed):
    """B positions at page edges (last slot of a page, first of the next,
    0, the last position of the table, past the table) and between them."""
    top = P * pt
    picks = [0, pt - 1, pt, 2 * pt - 1, top - 1, top - L, top + 3,
             (seed * 37) % top]
    return [max(0, picks[(i + seed) % len(picks)]) for i in range(B)]


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16,
                                      torch.int8])
@pytest.mark.parametrize("pt", [8, 16, 32])
@pytest.mark.parametrize("D", [64, 128])
def test_kernel_matches_plain(card, D, pt, kv_dtype):
    """B 1, 3 and 8 over L 1 (decode), 2, 5, 7 (one query tile), 8 up to
    the arena dtype's threshold (12 int8, 64 f32 and bf16: the decode
    mapping in tiles of up to 7 queries), L past it (13, 16, 17, 32, 33
    int8; 65 and 128 all: the tile mapping), at positions on page edges
    and past the table; two launches bit-identical."""
    H, P = (16 if D == 128 else 12), 12
    for B in (1, 3, 8):
        for L in (1, 2, 5, 7, 8, 12, 13, 16, 17, 32, 33, 64, 65, 128):
            pos = edge_positions(B, pt, P, L, seed=B + L)
            q, kp, vp, pages, positions, sc = inputs(card, pos, L, H, D, pt,
                                                     P, kv_dtype)
            out = paged_attention(q, kp, vp, pages, positions, **sc)
            again = paged_attention(q, kp, vp, pages, positions, **sc)
            ref = paged_attention_ref(q, kp, vp, pages, positions, **sc)
            torch.cuda.synchronize()
            plan = _plan(B, L, H, D, pt, P, kp.element_size(), bool(sc),
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)
            err = (out.float() - ref.float()).abs().max().item()
            assert out.shape == q.shape and out.dtype == q.dtype
            assert err <= PA_TOL[kv_dtype], (B, L, pos, plan, err)
            assert torch.equal(out, again), (B, L, plan)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16,
                                      torch.int8])
def test_spec_verify_and_prefill_chunk_shapes(card, kv_dtype):
    """GPT-2-small geometry (H 12, D 64, 16-token pages, 64-page tables):
    the spec verify at L 2, 3 and 5 over 8 rows at any cursor (mid-page,
    page edges, the table's last positions), and a 256-token prefill chunk
    at the whole-page cursors 256, 512 and 768; two launches
    bit-identical."""
    cases = [(L, [0, 15, 16, 31, 200, 511, 1018, 1024 - L])
             for L in (2, 3, 5)]
    cases.append((256, [256, 512, 768]))
    for L, pos in cases:
        q, kp, vp, pages, positions, sc = inputs(card, pos, L, 12, 64, 16,
                                                 64, kv_dtype)
        out = paged_attention(q, kp, vp, pages, positions, **sc)
        again = paged_attention(q, kp, vp, pages, positions, **sc)
        ref = paged_attention_ref(q, kp, vp, pages, positions, **sc)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= PA_TOL[kv_dtype], (L, pos, err)
        assert torch.equal(out, again), (L, pos)


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
def test_bf16_queries(card, kv_dtype):
    """bf16 queries over bf16 and int8 arenas (the bf16 tolerance)."""
    for L in (1, 5, 40):
        pos = [0, 17, 100, 190]
        q, kp, vp, pages, positions, sc = inputs(card, pos, L, 12, 64, 16,
                                                 12, kv_dtype,
                                                 q_dtype=torch.bfloat16)
        out = paged_attention(q, kp, vp, pages, positions, **sc)
        # the plain version dequantizes int8 pages to q's dtype: f32 there
        ref = paged_attention_ref(q.float() if sc else q, kp, vp, pages,
                                  positions, **sc)
        torch.cuda.synchronize()
        assert out.dtype == torch.bfloat16
        assert (out.float() - ref.float()).abs().max().item() <= 0.05


def test_one_launch_per_call(card):
    """The counter moves by one per call and the profiler sees exactly one
    kernel, ``paged_attention_ring_kernel``, per call: no combine kernel,
    also where the plan splits the page walk over a cluster."""
    from torch.profiler import ProfilerActivity, profile

    for B, L in ((8, 1), (1, 1), (8, 128)):
        pos = [1023 - 100 * i for i in range(B)]
        q, kp, vp, pages, positions, sc = inputs(card, pos, L, 12, 64, 16,
                                                 64, torch.float32)
        assert _plan(B, L, 12, 64, 16, 64, 4, False, 132).cluster > 1
        paged_attention(q, kp, vp, pages, positions)
        torch.cuda.synchronize()
        before = paged_attention.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                paged_attention(q, kp, vp, pages, positions)
            torch.cuda.synchronize()
        assert paged_attention.launches - before == 3
        kernels = [(e.key, e.count) for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")]
        assert len(kernels) == 1
        assert "paged_attention_ring_kernel" in kernels[0][0]
        assert kernels[0][1] == 3


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.int8])
def test_poisoned_arena_cannot_leak(card, kv_dtype):
    """Every arena slot past each row's live position, and every page no row
    owns, poisoned (scales too): the output is bit-identical."""
    pt, P, L = 16, 8, 3
    pos = [0, 14, 15, 16, 40, 77, 120, 125]
    q, kp, vp, pages, positions, sc = inputs(card, pos, L, 12, 64, pt, P,
                                             kv_dtype)
    written = torch.zeros(kp.shape[:2], dtype=torch.bool)
    owned = torch.zeros(kp.shape[0], dtype=torch.bool)
    for b, p0 in enumerate(pos):
        for lp in range(min(p0 + L, P * pt)):
            phys = int(pages[b, lp // pt])
            written[phys, lp % pt] = True
            owned[phys] = True
    w = written.cuda()[:, :, None, None]
    bad = 127 if kv_dtype == torch.int8 else 1e9
    poison = [torch.where(w, a, torch.full_like(a, bad)) for a in (kp, vp)]
    psc = {k: torch.where(owned.cuda()[:, None], s, torch.full_like(s, 1e9))
           for k, s in sc.items()}
    clean = [torch.where(w, a, torch.zeros_like(a)) for a in (kp, vp)]
    a = paged_attention(q, *clean, pages, positions, **sc)
    b = paged_attention(q, *poison, pages, positions, **psc)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("D,pt,kv_dtype", [
    (16, 16, torch.float32),     # GPTTiny's head dim, padded to 64
    (16, 16, torch.int8),
    (32, 16, torch.float32),
    (32, 8, torch.bfloat16),
    (96, 16, torch.float32),     # padded to 128
    (96, 16, torch.int8),
    (80, 32, torch.bfloat16),
    (20, 16, torch.float32),     # 80-byte rows: TMA
    (20, 16, torch.bfloat16),    # 40- and 20-byte rows, which TMA cannot
    (20, 16, torch.int8),        # address: copied value by value
    (128, 128, torch.float32),   # large pages: slabs of part of a page
    (128, 256, torch.float32),
    (64, 64, torch.int8),
])
def test_head_dims_and_page_sizes(card, D, pt, kv_dtype):
    """Head dims other than 64 and 128 and pages of up to 256 tokens, as
    the kernel of the first port served them: B 1, 3 and 8 over decode,
    spec-verify and tile-mapping L at page edges; two launches
    bit-identical."""
    H, P = 4, max(2, 192 // pt)
    for B in (1, 3, 8):
        for L in (1, 5, 40):
            pos = edge_positions(B, pt, P, L, seed=B + L)
            q, kp, vp, pages, positions, sc = inputs(card, pos, L, H, D, pt,
                                                     P, kv_dtype)
            out = paged_attention(q, kp, vp, pages, positions, **sc)
            again = paged_attention(q, kp, vp, pages, positions, **sc)
            ref = paged_attention_ref(q, kp, vp, pages, positions, **sc)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            assert err <= PA_TOL[kv_dtype], (B, L, pos, err)
            assert torch.equal(out, again), (B, L)


def test_gpt_tiny_serves_through_the_kernel(card):
    """GPTTiny (embed 64, 4 heads: D 16) served through the kernel gives the
    greedy tokens of the same engine reading through the plain gather
    path."""
    from kubeml_tpu_torch.api import GenerateRequest
    from kubeml_tpu_torch.models import GPTTiny
    from kubeml_tpu_torch.serving import PagedBatchingDecoder

    model = GPTTiny(vocab_size=1000, max_len=128, seed=0, device="cuda")
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, 1000, (n,), generator=gen).tolist()
               for n in (3, 17, 40, 9)]
    runs = {}
    for impl in ("cuda", "gather"):
        dec = PagedBatchingDecoder(model, slots=4, chunk_steps=4,
                                   page_tokens=16, paged_attn=impl,
                                   device="cuda")
        try:
            before = paged_attention.launches
            entries = [dec.submit(GenerateRequest(prompts=[p],
                                                  max_new_tokens=12))
                       for p in prompts]
            runs[impl] = [dec.wait(e, timeout=300)["tokens"][0][:12]
                          for e in entries]
            launched = paged_attention.launches - before
        finally:
            dec.close()
        assert (launched > 0) == (impl == "cuda"), (impl, launched)
    assert runs["cuda"] == runs["gather"]


def test_bad_arguments_raise(card):
    q, kp, vp, pages, positions, _ = inputs(card, [3], 1, 2, 160, 16, 4,
                                            torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        paged_attention(q, kp, vp, pages, positions)
    q, kp, vp, pages, positions, _ = inputs(card, [3], 1, 2, 64, 16, 4,
                                            torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention(q, kp.transpose(2, 3).contiguous().transpose(2, 3),
                        vp, pages, positions)
    with pytest.raises(ValueError, match="int32"):
        paged_attention(q, kp, vp, pages.long(), positions)
