"""The flash-attention CUDA kernels (``csrc/flash_attention.cu``) against
their plain versions on an NVIDIA card. Card-only: every test carries the
``cuda`` marker and skips on a host without a card. Imports torch and the
port only, so it runs on a machine without JAX::

    python -m pytest -m cuda tests/test_torch_flash_cuda.py

Tolerances, as ``chip_smoke.py`` holds the kernels: the relative
Frobenius error ||a - b|| / ||b|| of every 64-row tile of each (batch,
head) (rows are queries for out, lse and dQ, keys for dK and dV), so that a
fault confined to late tiles is held to those tiles' own values. f32 1e-5
(both sum in f32, the kernel with an online softmax over 64-key tiles);
bf16 2^-7, one bf16 ulp of each value (the tensor-core products sum in
another order, so a value can round to the neighbouring bf16). lse is f32
in both dtypes: 1e-5, over the rows that attend at least one key. dQ and
dK tiles that are 0 but for rounding (a query attending one key has no
softmax gradient) are held to a bound of that rounding instead
(``cancellation_floors``).
"""

import pytest
import torch
import torch.nn.functional as F

from kubeml_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.Generator().manual_seed(0)


TILE_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def tile_sq(t):
    """Squared Frobenius norms of the 64-row tiles of each (batch, head):
    ``[B, L, H, D]`` tiles along L, lse ``[B, H, L]`` along its last
    dim."""
    t = t.float().square()
    if t.dim() == 4:
        t = t.sum(-1).transpose(1, 2)
    return F.pad(t, (0, -t.shape[-1] % 64)).unflatten(-1, (-1, 64)).sum(-1)


def assert_tiles_close(a, b, dtype, floor=None):
    """Every 64-row tile of each (batch, head) within ``TILE_RTOL[dtype]``
    relative Frobenius error; with ``floor`` (a rounding bound, see
    ``cancellation_floors``), a tile whose reference and kernel values
    both lie within it is 0 but for rounding and passes."""
    e, r = tile_sq(a - b.float()), tile_sq(b)
    rel = (e / r.clamp_min(1e-30)).sqrt()
    if floor is not None:
        f = tile_sq(floor)
        rel = rel.where(~((r <= f) & (tile_sq(a) <= f)),
                        torch.zeros_like(rel))
    err = rel.max().item()
    assert err <= TILE_RTOL[dtype], f"tile relative error {err}"


def cancellation_floors(q, k, v, do, out, lse, valid, causal):
    """Rounding bounds of dQ and dK where dS = P (dP - dsum) scale cancels
    (0 in exact arithmetic for a query attending one key): dP and dsum are
    D-term f32 sums of exact bf16 products, each within gamma_D = D u /
    (1 - D u) of the sum of |terms| (u = 2^-23, a margin over f32's
    2^-24), so dQ's floor is 2 gamma_D scale sum_k P |dO|.(|V_k| + |O|)
    |K_k| and dK's the same with |Q_q| (``chip_smoke.py``'s)."""
    D = q.shape[-1]
    u = 2.0 ** -23
    gamma = 2 * D * u / (1 - D * u)
    p = fa._probs(fa._masked_scores(q, k, valid, causal), lse[..., None])
    ado, av, aq, ak = (t.float().abs() for t in (do, v, q, k))
    terms = (torch.einsum("bqhd,bkhd->bhqk", ado, av)
             + (ado * out.float().abs()).sum(-1).transpose(1, 2)[..., None])
    ds = gamma * fa._scale(D) * p * terms
    return (torch.einsum("bhqk,bkhd->bqhd", ds, ak),
            torch.einsum("bhqk,bqhd->bkhd", ds, aq))


def run(g, B, Lq, Lk, H, D, dtype, causal, valid=None, strided=False):
    """Kernel forward and backward against the plain versions; returns
    the kernel's (out, lse, dq, dk, dv)."""
    mk = lambda L: torch.randn(B, L, H, D, generator=g).to(dtype).cuda()
    q, k, v, do = mk(Lq), mk(Lk), mk(Lk), mk(Lq)
    if strided:  # [B, H, L, D] storage seen as [B, L, H, D]
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    valid = (torch.ones(B, Lk) if valid is None else valid).cuda()
    out, lse = fa._flash_fwd_cuda(q, k, v, valid, causal)
    ro, rl = fa.flash_attention_fwd_ref(q, k, v, valid, causal)
    dsum = fa._dsum(do, ro)
    bwd = lambda: (fa._flash_dq_cuda(q, k, v, valid, rl, do, dsum, causal),
                   *fa._flash_dkv_cuda(q, k, v, valid, rl, do, dsum, causal))
    grads, again = bwd(), bwd()
    refs = fa.flash_attention_bwd_ref(q, k, v, valid, ro, rl, do, causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert_tiles_close(out, ro, dtype)
    live = rl > -1e29
    assert_tiles_close(lse.where(live, 0.0), rl.where(live, 0.0),
                       torch.float32)
    assert (lse[~live] < -1e29).all()
    floors = cancellation_floors(q, k, v, do, ro, rl, valid, causal)
    for a, b, c, f in zip(grads, again, refs, floors + (None,)):
        assert torch.equal(a, b)  # no atomics: bit-identical on repeat
        assert_tiles_close(a, c, dtype, f)
    return (out, lse, *grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Lq,Lk,causal", [(150, 150, True), (70, 200, True),
                                          (200, 70, True), (100, 260, False),
                                          (130, 130, True), (130, 300, False)])
def test_kernels_match_plain_versions(card, dtype, D, Lq, Lk, causal):
    """Ragged lengths, Lq != Lk both ways under the top-left causal mask,
    cross attention, Lq 130 (the last 128-query block of the bf16 forward
    and dQ holds 2 real rows, so one consumer warpgroup's rows all lie past
    Lq); padded keys in one row get exactly zero dK/dV."""
    valid = torch.ones(2, Lk)
    valid[1, -13:] = 0
    _, _, _, dk, dv = run(card, 2, Lq, Lk, 3, D, dtype, causal, valid)
    assert dk[1, -13:].abs().max() == 0 and dv[1, -13:].abs().max() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq,Lk,D,causal,holes", [
    (1000, 1100, 128, False, True),  # padded keys inside tiles
    (384, 1024, 64, True, False),    # causal, Lq < Lk, full tiles
    (1000, 640, 64, True, False)])   # causal, Lq > Lk, ragged tiles
def test_masks_inside_tiles_and_causal_cross_lengths(card, dtype, Lq, Lk, D,
                                                     causal, holes):
    """The per-tile mask decisions of the bf16 kernels (the diagonal, a
    tile holding a padded key, a ragged last tile) and TMA's zero fill
    past L: every 7th key of row 0 and the last 13 keys of row 1 padded,
    or causal masks with Lq != Lk; padded keys get exactly zero dK/dV."""
    valid = torch.ones(2, Lk)
    if holes:
        valid[0, 3::7] = 0
        valid[1, -13:] = 0
    _, _, _, dk, dv = run(card, 2, Lq, Lk, 2, D, dtype, causal, valid)
    dead = valid.cuda() == 0
    if holes:
        assert dk[dead].abs().max() == 0 and dv[dead].abs().max() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fully_masked_rows(card, dtype):
    """A row whose keys are all padding: output 0, lse ~ -1e30, zero
    gradients for its keys, and no NaN anywhere."""
    valid = torch.ones(2, 90)
    valid[0] = 0
    out, lse, dq, dk, dv = run(card, 2, 90, 90, 2, 64, dtype, True, valid)
    assert out[0].abs().max() == 0 and (lse[0] < -1e29).all()
    for t in (dq[0], dk[0], dv[0]):
        assert t.abs().max() == 0
    assert all(torch.isfinite(t).all() for t in (out, dq, dk, dv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [2048, 300])
def test_batch_with_no_valid_key(card, dtype, L):
    """A pipeline bubble: every key of every row padded (the rolled
    validity buffer of ``models.gpt_pipeline`` on the fill's ticks), at
    the flagship's microbatch (B 2, L 2048, 8 heads of 64, causal) and at
    a ragged L: the forward, dQ and dK/dV kernels give exact zeros like
    their plain versions, lse at most -1e29, and no NaN."""
    out, lse, dq, dk, dv = run(card, 2, L, L, 8, 64, dtype, True,
                               torch.zeros(2, L))
    for t in (out, dq, dk, dv):
        assert torch.equal(t, torch.zeros_like(t))
    assert (lse <= -1e29).all() and torch.isfinite(lse).all()


def encoder_valid(B, L):
    """BERT's trailing padding: 0-120 PAD keys a row (seeded), row 1
    keeping only [CLS]."""
    g = torch.Generator().manual_seed(1)
    pads = torch.randint(0, 121, (B,), generator=g)
    pads[0], pads[1] = 0, L - 1
    return (torch.arange(L)[None, :] < (L - pads)[:, None]).float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["vit 65x65", "bert 128 padded"])
def test_encoder_shapes(card, dtype, shape):
    """The encoders' non-causal self-attention: ViT-Tiny (B 256, L 65,
    H 3: one 64-key tile and a tail of one key; the second query
    warpgroup of a 128-query block holds one real row) and BERT-base
    (B 32, L 128, H 12, trailing padding): padded keys' dK/dV exactly 0."""
    if shape.startswith("vit"):
        run(card, 256, 65, 65, 3, 64, dtype, False)
        return
    valid = encoder_valid(32, 128)
    out, lse, dq, dk, dv = run(card, 32, 128, 128, 12, 64, dtype, False,
                               valid)
    dead = valid == 0
    assert dk[dead].abs().max() == 0 and dv[dead].abs().max() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_query_is_read_after_a_copy(card, dtype):
    run(card, 2, 80, 80, 2, 64, dtype, True, strided=True)


def test_autograd_on_the_card_launches_each_kernel(card):
    q, k, v = (torch.randn(1, 64, 2, 64, generator=card).cuda()
               .requires_grad_() for _ in range(3))
    counts = (fa.flash_attention.fwd_launches, fa.flash_attention.dq_launches,
              fa.flash_attention.dkv_launches)
    fa.flash_attention(q, k, v, causal=True).sum().backward()
    after = (fa.flash_attention.fwd_launches, fa.flash_attention.dq_launches,
             fa.flash_attention.dkv_launches)
    assert [b - a for a, b in zip(counts, after)] == [1, 1, 1]
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :32], k[..., :32], v[..., :32])


@pytest.mark.parametrize("D,dtype,error", [(32, torch.float32, ValueError),
                                           (96, torch.bfloat16, ValueError),
                                           (64, torch.float16, TypeError)])
def test_automatic_choice_raises_where_the_kernels_do_not_apply(card, D,
                                                                dtype, error):
    """``dot_product_attention(impl=None)`` with structured masks on a CUDA
    tensor goes to the kernels whatever the head dim and dtype: no silent
    plain fallback. ``impl="plain"`` is the caller's way to the plain path."""
    from kubeml_tpu_torch.ops import attention

    q = torch.randn(1, 64, 2, D, generator=card).to(dtype).cuda()
    with pytest.raises(error):
        attention.dot_product_attention(q, q, q, causal=True)
    out = attention.dot_product_attention(q, q, q, causal=True, impl="plain")
    assert out.shape == q.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_training_shape(card, dtype):
    """``bench_moe``'s attention: B 16, L 512, 12 heads of 64, causal, no
    padding (the GPT-2-small MoE skeleton's training step)."""
    run(card, 16, 512, 512, 12, 64, dtype, True)
