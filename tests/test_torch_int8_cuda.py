"""The int8 weight matmul CUDA kernel (``csrc/int8_matmul.cu``) against its
plain version ``int8_dot`` on an NVIDIA card. Card-only: every test carries
the ``cuda`` marker and skips on a host without a card. Imports torch and
the port only, so it runs on a machine without JAX::

    python -m pytest -m cuda tests/test_torch_int8_cuda.py

Tolerance, as ``chip_smoke.py`` holds the kernel (``MM_RTOL``), relative to
the largest |output|: f32 out 1e-5 (f32 x splits exactly into three bf16
terms and every product is exact; the tensor cores add them in f32 in
another order than the plain version); bf16 out 1e-2 (one rounding of the
output to bf16).
"""

import pytest
import torch

from kubeml_tpu_torch.ops.int8_matmul import _plan, int8_dot, int8_matmul
from kubeml_tpu_torch.serving.quant import quantize_tree

pytestmark = pytest.mark.cuda

MM_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.Generator().manual_seed(0)


def weights(g, K, N):
    q = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    return q.cuda(), (torch.rand(1, N, generator=g) * 0.02).cuda()


@pytest.mark.parametrize("K", [100, 101, 768, 3072, 3100])
@pytest.mark.parametrize("N", [257, 768, 50257])
def test_kernel_matches_int8_dot(card, K, N):
    """M 1, 3, 8 (one 8-row tile), 9, 16, 17, 24, 40 (16, 24 and 40: the
    spec verify of 8 rows at k 1, 2 and 4) and 200 (32-row tiles, ragged);
    ragged K and N (257 and 50257 are not multiples of 16, so Q arrives by
    16-byte copies of each row, not TMA boxes; K 101 leaves x's rows 4-byte
    aligned in f32 and 2-byte aligned in bf16, copied value by value); f32
    and bf16 in and out; repeated calls bit-identical."""
    q, s = weights(card, K, N)
    for M in (1, 3, 8, 9, 16, 17, 24, 40, 200):
        for xd in (torch.float32, torch.bfloat16):
            x = torch.randn(M, K, generator=card).to(xd).cuda()
            for yd in (torch.float32, torch.bfloat16):
                y = int8_matmul(x, q, s, out_dtype=yd)
                again = int8_matmul(x, q, s, out_dtype=yd)
                ref = int8_dot(x, q, s, out_dtype=torch.float32)
                torch.cuda.synchronize()
                assert y.shape == (M, N) and y.dtype == yd
                err = (y.float() - ref).abs().max().item()
                tol = MM_RTOL[yd] * ref.abs().max().item()
                assert err <= tol, (M, K, N, xd, yd, _plan(M, K, N, 132), err)
                assert torch.equal(y, again)


def test_one_launch_per_call(card):
    """The counter moves by one per call and the profiler sees exactly one
    kernel, ``int8_mm_wgmma_kernel``, per call: no reduce kernel, also where
    the plan splits K over a cluster."""
    from torch.profiler import ProfilerActivity, profile

    for M, K, N in ((8, 3072, 768), (8, 768, 50257), (256, 768, 3072)):
        q, s = weights(card, K, N)
        x = torch.randn(M, K, generator=card).cuda()
        int8_matmul(x, q, s)
        torch.cuda.synchronize()
        before = int8_matmul.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                int8_matmul(x, q, s)
            torch.cuda.synchronize()
        assert int8_matmul.launches - before == 3
        kernels = [(e.key, e.count) for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")]
        assert len(kernels) == 1 and "int8_mm_wgmma_kernel" in kernels[0][0]
        assert kernels[0][1] == 3


@pytest.mark.parametrize("xd", [torch.float32, torch.bfloat16])
def test_non_finite_x_propagates_as_in_int8_dot(card, xd):
    q, s = weights(card, 768, 3072)
    x = torch.randn(8, 768, generator=card)
    x[0, 3], x[2, 5], x[3, 7] = float("inf"), float("nan"), -float("inf")
    x[5, 0] = x[5, 1] = float("inf")
    x = x.to(xd).cuda()
    y, ref = int8_matmul(x, q, s), int8_dot(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(y.isnan(), ref.isnan())
    assert torch.equal(y.isposinf(), ref.isposinf())
    assert torch.equal(y.isneginf(), ref.isneginf())
    fin = ref.isfinite()
    tol = MM_RTOL[xd] * ref[fin].float().abs().max().item()
    assert (y[fin].float() - ref[fin].float()).abs().max().item() <= tol


def test_bad_arguments_raise(card):
    q, s = weights(card, 64, 96)
    x = torch.randn(4, 64, generator=card).cuda()
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul(x, q.t().contiguous().t(), s)
    with pytest.raises(ValueError):
        int8_matmul(x, q.float(), s)
    with pytest.raises(ValueError):
        int8_matmul(x, q, s.double())
    with pytest.raises(TypeError):
        int8_matmul(x.half(), q, s)
    with pytest.raises(ValueError, match="features"):
        int8_matmul(x[:, :32], q, s)


def test_quantize_on_the_card_matches_the_cpu_rule(card):
    """Weights quantized on the card get the q and s of the CPU (and the
    JAX package's) rule bit for bit: ``scale = absmax / 127`` divides, it
    does not multiply by the reciprocal, which CUDA division by a Python
    scalar does."""
    tree = {"a.kernel": torch.randn(768, 3072, generator=card),
            "b.kernel": torch.randn(3072, 768, generator=card) * 0.02}
    cpu = quantize_tree(tree)
    gpu = quantize_tree({k: v.cuda() for k, v in tree.items()})
    for k in tree:
        assert torch.equal(gpu[k].q.cpu(), cpu[k].q), k
        assert torch.equal(gpu[k].s.cpu(), cpu[k].s), k


@pytest.mark.parametrize("K,N", [(768, 768), (768, 3072), (3072, 768),
                                 (768, 50257)])
def test_dense_engine_decode_shapes(card, K, N):
    """The dense slot engine's int8 products at GPT-2-small width: a
    decode step runs every slot (M 8), a prefill wave the bucketed
    prompts (M 8 x 512); f32 x and out, within ``MM_RTOL``."""
    q, s = weights(card, K, N)
    for M in (8, 4096):
        x = torch.randn(M, K, generator=card).cuda()
        y = int8_matmul(x, q, s)
        ref = int8_dot(x, q, s, out_dtype=torch.float32)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        assert err <= MM_RTOL[torch.float32] * ref.abs().max().item()


def test_dense_engine_launches_the_kernel_per_projection(card):
    """``BatchingDecoder(quantize="int8", int8_matmul=True)`` on the card:
    every projection and the lm_head of every forward (prefill waves and
    decode steps) is one kernel launch - 13 a forward at depth 2 - and the
    greedy tokens equal an engine on the plain version (``dot``)."""
    from kubeml_tpu_torch.api.types import GenerateRequest
    from kubeml_tpu_torch.models.gpt import CausalTransformer
    from kubeml_tpu_torch.serving import BatchingDecoder

    outs = []
    for impl in ("cuda", "dot"):
        m = CausalTransformer(vocab_size=4096, max_len=64, embed_dim=128,
                              depth=2, num_heads=2, seed=1, device="cuda")
        dec = BatchingDecoder(m, slots=4, chunk_steps=4, quantize="int8",
                              int8_matmul=True, int8_matmul_impl=impl,
                              device="cuda")
        before = int8_matmul.launches
        try:
            entries = [dec.submit(GenerateRequest(
                prompts=[list(range(1 + i, 9 + 2 * i))], max_new_tokens=7))
                for i in range(5)]
            outs.append([dec.wait(e, timeout=300)["tokens"]
                         for e in entries])
            t = dec.telemetry()
        finally:
            dec.close()
        launched = int8_matmul.launches - before
        forwards = int(t["admission_waves"] + t["device_steps"])
        assert launched == (13 * forwards if impl == "cuda" else 0)
    assert outs[0] == outs[1]
