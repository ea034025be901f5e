"""The port's paged serving engine on ``device="cpu"`` against the JAX
``PagedBatchingDecoder(paged_attn="gather")``, same weights, on the JAX
suite's mixed-length workload (``tests/test_paged_attention.py``): greedy
tokens identical, the shared-prefix request served 8 cached tokens, and
the page pool's accounting identical once every request has finished.

Greedy tokens must be EQUAL: both engines compute the same f32 logits to
~1e-6 and an argmax flip would need two logits of a 101-token vocabulary
within that distance. Sampled tokens cannot be compared across frameworks
(different generators); the port is held to reproducibility instead.
"""

import numpy as np
import pytest

from kubeml_tpu.api.errors import KubeMLError as JaxKubeMLError
from kubeml_tpu.api.types import GenerateRequest as JaxRequest
from kubeml_tpu.serving.batcher import PagedBatchingDecoder as JaxDecoder
from kubeml_tpu_torch.api import GenerateRequest, KubeMLError
from kubeml_tpu_torch.serving import PagedBatchingDecoder
from torch_port_helpers import VOCAB, jax_init, jax_tiny, torch_twin

MAX_NEWS = [6, 8, 5, 3]


def workload():
    rng = np.random.default_rng(7)
    sysp = rng.integers(1, VOCAB, size=8).astype(np.int32)
    return [
        rng.integers(1, VOCAB, size=(1, 3)).astype(np.int32),
        np.concatenate([sysp, rng.integers(1, VOCAB, size=4).astype(np.int32)])[None],
        np.concatenate([sysp, rng.integers(1, VOCAB, size=2).astype(np.int32)])[None],
        rng.integers(1, VOCAB, size=(1, 11)).astype(np.int32),
    ]


def drive(dec, request_cls, prompts, max_news, **kw):
    entries = [dec.submit(request_cls(prompts=p.tolist(), max_new_tokens=n,
                                      **kw))
               for p, n in zip(prompts, max_news)]
    return [dec.wait(e, timeout=600) for e in entries]


def run_both(jax_kw, port_kw, prompts=None, max_news=MAX_NEWS, **req):
    """Serve the workload through both engines; returns (jax results, port
    results, jax pool check, port pool check, port telemetry)."""
    jm = jax_tiny(max_len=48)
    variables = jax_init(jm)
    tm = torch_twin(jm, variables)
    prompts = workload() if prompts is None else prompts
    common = dict(slots=2, chunk_steps=4, page_tokens=4)
    jdec = JaxDecoder(jm, variables, paged_attn="gather", **common, **jax_kw)
    try:
        jres = drive(jdec, JaxRequest, prompts, max_news, **req)
        jchk = jdec._pool.check()
    finally:
        jdec.close()
    tdec = PagedBatchingDecoder(tm, device="cpu", **common, **port_kw)
    try:
        tres = drive(tdec, GenerateRequest, prompts, max_news, **req)
        tchk = tdec._pool.check()
        tele = tdec.telemetry()
    finally:
        tdec.close()
    return jres, tres, jchk, tchk, tele


@pytest.mark.parametrize("paged_attn", ["gather", "cuda"])
def test_greedy_tokens_prefix_reuse_and_pool_match_jax(paged_attn):
    jres, tres, jchk, tchk, tele = run_both({}, {"paged_attn": paged_attn})
    assert [r["tokens"] for r in tres] == [r["tokens"] for r in jres]
    assert [r["lengths"] for r in tres] == [r["lengths"] for r in jres]
    assert tres[2]["prefix_cached_tokens"] == 8
    assert ([r["prefix_cached_tokens"] for r in tres]
            == [r["prefix_cached_tokens"] for r in jres])
    assert tchk == jchk
    assert tchk["held"] == tchk["trie_pages"] > 0
    # "cuda" on a CPU engine reads through the kernel's wrapper, which
    # takes the plain version for CPU tensors
    assert tele["paged_attn_kernel"] == (1.0 if paged_attn == "cuda" else 0.0)
    assert tele["requests_completed"] == 4
    assert tele["tokens_emitted"] == sum(MAX_NEWS)


def test_eos_matches_jax():
    jm = jax_tiny(max_len=48)
    tm = torch_twin(jm, jax_init(jm))
    dec = PagedBatchingDecoder(tm, slots=2, chunk_steps=4, page_tokens=4,
                               device="cpu")
    try:
        greedy = drive(dec, GenerateRequest, workload()[1:2], [8])
    finally:
        dec.close()
    eos = greedy[0]["tokens"][0][2]  # stops the request at its 3rd token
    jres, tres, jchk, tchk, _ = run_both({}, {}, eos_id=eos)
    assert [r["tokens"] for r in tres] == [r["tokens"] for r in jres]
    assert [r["lengths"] for r in tres] == [r["lengths"] for r in jres]
    assert tres[1]["lengths"] == [greedy[0]["tokens"][0].index(eos) + 1]
    assert tchk == jchk


@pytest.mark.parametrize("int8_matmul", [False, True])
def test_int8_weights_and_kv_compose_match_jax(int8_matmul):
    """int8 weights (the dequantize path or the native int8 matmul) with
    int8 KV pages: same quantized weights and storage format in both
    engines, so the greedy tokens agree."""
    kw = dict(quantize="int8", int8_matmul=int8_matmul, kv_quant="int8")
    jres, tres, jchk, tchk, tele = run_both(kw, kw)
    assert [r["tokens"] for r in tres] == [r["tokens"] for r in jres]
    assert tchk == jchk
    assert tele["kv_quant"] == 1.0
    assert tele["pages_total"] == jchk["free"] + jchk["held"]


def test_request_too_big_for_the_arena_is_a_400():
    jm = jax_tiny(max_len=48)
    variables = jax_init(jm)
    tm = torch_twin(jm, variables)
    req = dict(prompts=[list(range(1, 21))], max_new_tokens=4)
    # 5 pages = 4 allocatable x 4 tokens: 16 positions < 20 + 4 - 1
    jdec = JaxDecoder(jm, variables, slots=2, page_tokens=4, pages=5,
                      paged_attn="gather")
    tdec = PagedBatchingDecoder(tm, slots=2, page_tokens=4, pages=5,
                                device="cpu")
    try:
        with pytest.raises(JaxKubeMLError) as jerr:
            jdec.submit(JaxRequest(**req))
        with pytest.raises(KubeMLError) as terr:
            tdec.submit(GenerateRequest(**req))
        assert terr.value.status_code == jerr.value.status_code == 400
        assert tdec.telemetry()["requests_rejected"] == 1
        # a request that fits still serves
        out = tdec.wait(tdec.submit(GenerateRequest(
            prompts=[[1, 2, 3]], max_new_tokens=4)), timeout=60)
        assert out["lengths"] == [4]
    finally:
        jdec.close()
        tdec.close()


def test_sampling_top_k_1_is_greedy_and_seeded_draws_reproduce():
    jm = jax_tiny(max_len=48)
    tm = torch_twin(jm, jax_init(jm))
    dec = PagedBatchingDecoder(tm, slots=2, chunk_steps=4, page_tokens=4,
                               device="cpu")
    prompts = workload()
    try:
        greedy = drive(dec, GenerateRequest, prompts, MAX_NEWS)
        top1 = drive(dec, GenerateRequest, prompts, MAX_NEWS,
                     temperature=0.8, top_k=1, seed=3)
        assert [r["tokens"] for r in top1] == [r["tokens"] for r in greedy]
        sampled = [drive(dec, GenerateRequest, prompts, MAX_NEWS,
                         temperature=1.5, seed=11) for _ in range(2)]
        assert ([r["tokens"] for r in sampled[0]]
                == [r["tokens"] for r in sampled[1]])
        # a hot temperature leaves the greedy chain somewhere
        assert ([r["tokens"] for r in sampled[0]]
                != [r["tokens"] for r in greedy])
    finally:
        dec.close()


def test_stream_then_close_refuses_with_503():
    jm = jax_tiny(max_len=48)
    tm = torch_twin(jm, jax_init(jm))
    dec = PagedBatchingDecoder(tm, slots=2, chunk_steps=4, page_tokens=4,
                               device="cpu")
    try:
        entry = dec.submit(GenerateRequest(prompts=[[4, 5, 6]],
                                           max_new_tokens=7, stream=True))
        items = list(dec.stream(entry))
        assert items[-1]["done"] and items[-1]["lengths"] == [7]
        streamed = [t for it in items[:-1] for t in it["tokens"]]
        assert streamed == entry.result()["tokens"][0]
    finally:
        dec.close()
    from kubeml_tpu_torch.serving import DecoderClosed

    with pytest.raises(DecoderClosed) as err:
        dec.submit(GenerateRequest(prompts=[[1]], max_new_tokens=1))
    assert err.value.status_code == 503
    chk = dec._pool.check()
    assert chk["held"] == chk["trie_pages"]


def test_queue_limit_is_a_429_and_cancel_frees_the_slot():
    from kubeml_tpu_torch.api import OverloadedError

    jm = jax_tiny(max_len=48)
    tm = torch_twin(jm, jax_init(jm))
    dec = PagedBatchingDecoder(tm, slots=1, chunk_steps=1, page_tokens=4,
                               queue_limit=1, device="cpu")
    try:
        # A holds the only slot for 40 one-step chunks; B queues behind it
        a = dec.submit(GenerateRequest(prompts=[[1, 2, 3]],
                                       max_new_tokens=40, stream=True))
        assert next(dec.stream(a))["tokens"]
        b = dec.submit(GenerateRequest(prompts=[[4, 5]], max_new_tokens=2))
        with pytest.raises(OverloadedError) as err:
            dec.submit(GenerateRequest(prompts=[[6]], max_new_tokens=2))
        assert err.value.status_code == 429
        # canceling A frees its slot and pages at the next chunk edge
        dec.cancel(a)
        assert dec.wait(b, timeout=60)["lengths"] == [2]
        tele = dec.telemetry()
        assert tele["requests_overload"] == 1
        assert tele["requests_canceled"] == 1
        assert len(a.rows[0].out) < 40
        chk = dec._pool.check()
        assert chk["held"] == chk["trie_pages"]
    finally:
        dec.close()
