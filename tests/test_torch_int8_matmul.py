"""The port's int8 weight matmul and weight quantization against the JAX
package: ``int8_dot`` (the plain version of the CUDA kernel) against the
Pallas ``int8_matmul`` in interpret mode and the JAX ``int8_dot`` on ragged
shapes, and ``quantize_tree`` against JAX's.

Tolerances: matmul rtol 1e-5 (f32 accumulation in another summation
order; the emulated three-term kernel arithmetic within 1e-5 of the largest
|output|, as the card check holds the kernel); quantized values must be EQUAL (both round w/scale half-to-even
in f32), scales within rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeml_tpu.ops.int8_matmul import int8_dot as jax_int8_dot
from kubeml_tpu.ops.int8_matmul import int8_matmul as jax_int8_matmul
from kubeml_tpu.serving.quant import quantize_tree as jax_quantize_tree
from kubeml_tpu_torch.ops.int8_matmul import (int8_dot, int8_matmul,
                                              resolve_int8_matmul)
from kubeml_tpu_torch.serving.quant import (MIN_QUANT_SIZE, QuantizedTensor,
                                            dequantize_tree, quantize_tree,
                                            quantized_dot)


@pytest.mark.parametrize("lead,K,N", [((3,), 100, 257), ((2, 5), 64, 130),
                                      ((8,), 256, 96)])
def test_int8_dot_matches_jax_kernel_and_dot(lead, K, N):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(*lead, K)).astype(np.float32)
    q = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    s = (rng.random((1, N)) * 0.02).astype(np.float32)
    out = int8_dot(torch.from_numpy(x), torch.from_numpy(q),
                   torch.from_numpy(s)).numpy()
    assert out.shape == (*lead, N) and out.dtype == np.float32
    kern = np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(q),
                                      jnp.asarray(s), interpret=True))
    dot = np.asarray(jax_int8_dot(jnp.asarray(x), jnp.asarray(q),
                                  jnp.asarray(s)))
    np.testing.assert_allclose(out, kern, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out, dot, rtol=1e-5, atol=1e-6)
    # the kernel's wrapper takes the plain version for CPU tensors
    wrapped = int8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                          torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(wrapped, out)


def test_quantize_tree_matches_jax():
    rng = np.random.default_rng(1)
    tree = {
        "token_embed": {"embedding": rng.normal(size=(300, 32))},
        "block_0": {"mlp_in": {"kernel": rng.normal(size=(32, 128)),
                               "bias": rng.normal(size=(128,))},
                    "attn": {"query": {"kernel": rng.normal(size=(32, 32))}}},
        "lm_head": {"kernel": rng.normal(size=(64, 257)) * 0.3},
    }
    f32 = lambda d: {k: (f32(v) if isinstance(v, dict)
                         else v.astype(np.float32)) for k, v in d.items()}
    tree = f32(tree)
    jq = jax_quantize_tree({"params": tree})["params"]
    flat = {"token_embed.embedding": tree["token_embed"]["embedding"],
            "block_0.mlp_in.kernel": tree["block_0"]["mlp_in"]["kernel"],
            "block_0.mlp_in.bias": tree["block_0"]["mlp_in"]["bias"],
            "block_0.attn.query.kernel":
                tree["block_0"]["attn"]["query"]["kernel"],
            "lm_head.kernel": tree["lm_head"]["kernel"]}
    tq = quantize_tree({k: torch.from_numpy(v) for k, v in flat.items()})
    for name, jleaf in (("block_0.mlp_in.kernel", jq["block_0"]["mlp_in"]["kernel"]),
                        ("lm_head.kernel", jq["lm_head"]["kernel"])):
        assert isinstance(tq[name], QuantizedTensor), name
        np.testing.assert_array_equal(tq[name].q.numpy(), np.asarray(jleaf.q))
        np.testing.assert_allclose(tq[name].s.numpy(), np.asarray(jleaf.s),
                                   rtol=1e-6)
    # embeddings stay exact whatever their size; small leaves and vectors too
    assert tq["token_embed.embedding"].numel() >= MIN_QUANT_SIZE
    for name in ("token_embed.embedding", "block_0.mlp_in.bias",
                 "block_0.attn.query.kernel"):
        assert not isinstance(tq[name], QuantizedTensor), name
        np.testing.assert_array_equal(tq[name].numpy(), flat[name])
    # dequantize rebuilds q * s
    dq = dequantize_tree(tq, torch.float32)["lm_head.kernel"]
    np.testing.assert_allclose(dq.numpy(), flat["lm_head.kernel"],
                               atol=float(tq["lm_head.kernel"].s.max()))


def test_quantized_dot_rejects_a_3d_leaf():
    rng = np.random.default_rng(2)
    stack = quantize_tree({"experts.kernel": torch.from_numpy(
        rng.normal(size=(4, 32, 64)).astype(np.float32))})["experts.kernel"]
    assert isinstance(stack, QuantizedTensor) and stack.q.dim() == 3
    with pytest.raises(ValueError, match="2-d"):
        quantized_dot(torch.zeros(2, 32), stack)


def test_quantized_dot_impls_and_resolver():
    rng = np.random.default_rng(3)
    qt = quantize_tree({"w": torch.from_numpy(
        rng.normal(size=(64, 80)).astype(np.float32))})["w"]
    x = torch.from_numpy(rng.normal(size=(5, 64)).astype(np.float32))
    ref = int8_dot(x, qt.q, qt.s)
    for impl in ("auto", "dot", "cuda", "pallas"):
        torch.testing.assert_close(quantized_dot(x, qt, impl=impl), ref,
                                   rtol=0, atol=0)
    assert resolve_int8_matmul("auto", "cpu") == "dot"
    assert resolve_int8_matmul("auto", "cuda") == "cuda"
    assert resolve_int8_matmul("pallas", "cpu") == "cuda"
    assert resolve_int8_matmul("dot", "cuda") == "dot"
    with pytest.raises(ValueError):
        resolve_int8_matmul("cublas", "cpu")


@pytest.mark.parametrize("M,K,N", [(8, 768, 768), (8, 3072, 768),
                                   (8, 768, 50257), (256, 768, 3072),
                                   (3, 100, 257), (4096, 768, 3072),
                                   (1, 768, 768), (4096, 768, 50257)])
def test_launch_plan_covers_k_without_empty_splits(M, K, N):
    """The kernel's launch plan (computed in Python, used only on the
    card): the M tile covers M (8 rows at decode), the cluster has at most
    8 ranks of 64-row K chunks, every rank's K range is non-empty and the
    ranks cover all of K."""
    from kubeml_tpu_torch.ops.int8_matmul import _plan

    mt, cluster, per = _plan(M, K, N, sm_count=132)
    assert mt == (8 if M <= 8 else 32)
    assert 1 <= cluster <= 8
    assert per % 64 == 0 and per > 0
    assert (cluster - 1) * per < K <= cluster * per


def _split3(x):
    """The kernel's split of f32 x into three bf16 terms: each term is the
    leading 8 significant bits (truncation) of what the earlier terms left;
    a non-finite x is all in the first term."""
    bits = torch.from_numpy(x).view(torch.int32)
    hi = (bits & -65536).view(torch.float32)
    r = torch.from_numpy(x) - hi
    mid = (r.view(torch.int32) & -65536).view(torch.float32)
    lo = r - mid
    return hi, mid, lo


@pytest.mark.parametrize("M,K,N", [(3, 100, 257), (8, 3072, 768),
                                   (5, 768, 130), (17, 3100, 96)])
def test_three_bf16_terms_reproduce_int8_dot(M, K, N):
    """The arithmetic of the CUDA kernel on f32 x, emulated in PyTorch: x
    splits exactly into three bf16 terms (hi + mid + lo == x, each exact in
    bf16), each term times the int8 values is exact in f32, and the three
    products summed in f32 then scaled match the JAX ``int8_dot`` and the
    Pallas kernel (interpret mode) within 1e-5 of the largest |output|, for
    x of magnitudes 1e-6 to 1e4."""
    rng = np.random.default_rng(M * 7 + K)
    x = (rng.normal(size=(M, K)) * 10.0 ** rng.uniform(-6, 4, size=(M, K))
         ).astype(np.float32)
    q = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    s = (rng.random((1, N)) * 0.02).astype(np.float32)
    hi, mid, lo = _split3(x)
    assert torch.equal(hi + mid + lo, torch.from_numpy(x))
    for t in (hi, mid, lo):
        assert torch.equal(t.to(torch.bfloat16).float(), t)
    qf = torch.from_numpy(q).float()
    acc = hi @ qf + mid @ qf + lo @ qf
    out = (acc * torch.from_numpy(s)).numpy()
    kern = np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(q),
                                      jnp.asarray(s), interpret=True))
    dot = np.asarray(jax_int8_dot(jnp.asarray(x), jnp.asarray(q),
                                  jnp.asarray(s)))
    scale = np.abs(dot).max()
    np.testing.assert_allclose(out, dot, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(out, kern, rtol=0, atol=1e-5 * scale)
