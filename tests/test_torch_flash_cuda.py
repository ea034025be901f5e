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
in both dtypes: 1e-5, over the rows that attend at least one key.
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


def assert_tiles_close(a, b, dtype):
    """Every 64-row tile of each (batch, head) within ``TILE_RTOL[dtype]``
    relative Frobenius error: ``[B, L, H, D]`` tiles along L, lse
    ``[B, H, L]`` along its last dim."""
    e, r = (a.float() - b.float()).square(), b.float().square()
    if a.dim() == 4:
        e, r = (t.sum(-1).transpose(1, 2) for t in (e, r))
    pad = -e.shape[-1] % 64
    e, r = (F.pad(t, (0, pad)).unflatten(-1, (-1, 64)).sum(-1)
            for t in (e, r))
    err = (e / r.clamp_min(1e-30)).sqrt().max().item()
    assert err <= TILE_RTOL[dtype], f"tile relative error {err}"


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
    for a, b, c in zip(grads, again, refs):
        assert torch.equal(a, b)  # no atomics: bit-identical on repeat
        assert_tiles_close(a, c, dtype)
    return (out, lse, *grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Lq,Lk,causal", [(150, 150, True), (70, 200, True),
                                          (200, 70, True), (100, 260, False)])
def test_kernels_match_plain_versions(card, dtype, D, Lq, Lk, causal):
    """Ragged lengths, Lq != Lk both ways under the top-left causal mask,
    cross attention; padded keys in one row get exactly zero dK/dV."""
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
