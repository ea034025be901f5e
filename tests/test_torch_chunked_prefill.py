"""Chunked prefill in the port against the JAX package, on the CPU:
page-aligned prompt chunks interleaved with decode
(``PagedBatchingDecoder(prefill_chunk_tokens=)``), with the same weights
carried across by ``interop.from_flax``.

Bars: the chunk cap resolves as JAX's does; greedy tokens are the same
chunked, monolithic and in the JAX engine (cold prompts, prefix hits,
self-drafting), and so are the chunk counters; seeded sampling is the same
chunked and monolithic; int8 arenas match within the int8 rule (+-1 only
at a rounding tie; ``tests/test_torch_gpt.py``) and f32 logits within
atol/rtol 1e-5; a knob of 0 is the monolithic engine; a cancel between
chunks returns the row's pages exactly once.
"""

import time

import numpy as np
import pytest
import torch

from kubeml_tpu.api.types import GenerateRequest as JaxRequest
from kubeml_tpu.models.generation import init_paged_cache as jax_init_cache
from kubeml_tpu.models.gpt import CausalTransformer as JaxTransformer
from kubeml_tpu.serving.batcher import PagedBatchingDecoder as JaxDecoder
from kubeml_tpu.serving.batcher import _chunk_cap as jax_chunk_cap
from kubeml_tpu.serving.kvpool import KVPool as JaxPool
from kubeml_tpu_torch.api import GenerateRequest
from kubeml_tpu_torch.models.generation import init_paged_cache
from kubeml_tpu_torch.serving import KVPool, PagedBatchingDecoder
from kubeml_tpu_torch.serving.batcher import _chunk_cap, _Row
from torch_port_helpers import VOCAB, jax_init, torch_twin


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models gain nothing from intra-op threads; one thread keeps
    this module from crowding the other test workers' timed waits."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_model(max_len=96):
    return JaxTransformer(vocab_size=VOCAB, max_len=max_len, embed_dim=64,
                          depth=4, num_heads=4)


@pytest.fixture(scope="module")
def served():
    jm = jax_model()
    variables = jax_init(jm)
    return jm, variables, torch_twin(jm, variables)


def prompts_of(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=(1, n)).astype(np.int32)
            for n in lens]


def drive(dec, request_cls, prompts, news, **req):
    entries = [dec.submit(request_cls(prompts=p.tolist(), max_new_tokens=n,
                                      **req))
               for p, n in zip(prompts, news)]
    return [dec.wait(e, timeout=600) for e in entries]


def serve_port(tm, prompts, news, **kw):
    dec = PagedBatchingDecoder(tm, device="cpu", **kw)
    try:
        res = drive(dec, GenerateRequest, prompts, news)
        return res, dec.telemetry(), dec._pool.check()
    finally:
        dec.close()


def serve_jax(jm, variables, prompts, news, **kw):
    dec = JaxDecoder(jm, variables, paged_attn="gather", **kw)
    try:
        res = drive(dec, JaxRequest, prompts, news)
        return res, dec.telemetry(), dec._pool.check()
    finally:
        dec.close()


def tokens_of(results):
    return [r["tokens"][0] for r in results]


# --- host units ---


@pytest.mark.parametrize("page_tokens", [4, 8, 16])
def test_chunk_cap_resolution_matches_jax(page_tokens):
    """The largest power of two at most the knob, floored at one page; 0
    below a page: every cap is whole pages."""
    for tokens in range(0, 300):
        cap = _chunk_cap(tokens, page_tokens)
        assert cap == jax_chunk_cap(tokens, page_tokens)
        if cap:
            assert cap % page_tokens == 0 and cap & (cap - 1) == 0
            assert cap <= tokens


def test_lease_prefill_pos_starts_at_prefix_cursor():
    """A cold lease's cursor is 0, a prefix hit's the shared pages' end
    (page-aligned), exactly as in the JAX pool."""
    prompt = np.arange(1, 14)
    for pool in (KVPool(33, 4), JaxPool(33, 4)):
        a = pool.admit(prompt, 4)
        assert a.prefill_pos == a.prefix_tokens == 0
        pool.register_prefix(prompt, a)
        b = pool.admit(prompt, 4)
        assert b.shared == 3
        assert b.prefill_pos == b.prefix_tokens == 12
        for lease in (a, b):
            pool.release(lease)
        pool.trie.flush()
        assert pool.free_pages() == pool.capacity


def test_stalled_rows_exclude_prefilling_finished_and_fresh_rows():
    """The rows a prefill forward delays are the decoding rows with tokens
    left: not a row mid chunked prefill, finished, canceled, done with its
    tokens, or admitted in the same turn (no token yet)."""
    def row(out=(5,), **kw):
        r = _Row(entry=None, index=0, prompt=np.arange(1, 5, dtype=np.int32),
                 max_new=8, temp=0.0, topk=0, eos=-1, out=list(out))
        for k, v in kw.items():
            setattr(r, k, v)
        return r

    victim = row()
    dec = object.__new__(PagedBatchingDecoder)
    dec._slot_rows = [victim, row(prefilling=True), row(done=True),
                      row(canceled=True), row(out=range(8)), row(out=()),
                      None]
    assert PagedBatchingDecoder._stalled_rows(dec) == [victim]


# --- model level: chunks are the suffix-prefill forward at a later base ---


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_chunked_module_prefill_matches_monolithic_and_jax(kv_quant):
    """Two page-aligned prefill forwards (base 0, then 8) against one
    monolithic forward, in the port: the same last-token logits (1e-5)
    and arenas (f32 1e-5; int8 +-1 at rounding ties, scales 1e-6). The
    chunked logits also match JAX's chunked applies."""
    jm = jax_model(max_len=32)
    variables = jax_init(jm)
    tm = torch_twin(jm, variables)
    pt, tp = 4, 8
    prompt = np.arange(1, 13, dtype=np.int32)[None]  # 12 = 8 + 4
    table = torch.arange(1, tp + 1, dtype=torch.int32)[None]

    def prefill(cache, toks, base):
        with torch.inference_mode():
            lg = tm(torch.from_numpy(toks), decode=True,
                    positions=torch.tensor([base], dtype=torch.int32),
                    pages=table, cache=cache)
        return lg[:, -1].numpy()

    mono_cache = init_paged_cache(tm, tp + 1, pt, kv_quant)
    mono = prefill(mono_cache, prompt, 0)
    cache = init_paged_cache(tm, tp + 1, pt, kv_quant)
    prefill(cache, prompt[:, :8], 0)
    chunked = prefill(cache, prompt[:, 8:], 8)
    np.testing.assert_allclose(chunked, mono, atol=1e-5, rtol=1e-5)
    for a, b in zip(cache.layers, mono_cache.layers):
        for name in a:
            x, y = a[name].float(), b[name].float()
            if name in ("k_scale", "v_scale"):
                np.testing.assert_allclose(x, y, rtol=1e-6)
            elif kv_quant == "int8":
                assert (x - y).abs().max() <= 1
            else:
                np.testing.assert_allclose(x, y, atol=1e-5)

    mod = jm.clone(page_tokens=pt, kv_pages=tp + 1, paged_attn="gather",
                   kv_quant=kv_quant)
    jcache = jax_init_cache(mod, variables, 1, tp)
    for toks, base in ((prompt[:, :8], 0), (prompt[:, 8:], 8)):
        jl, vs = mod.apply({**variables, "cache": jcache}, toks, decode=True,
                           positions=np.array([base], np.int32),
                           pages=table.numpy(),
                           seq_lens=np.array([toks.shape[1]], np.int32),
                           mutable=["cache"])
        jcache = vs["cache"]
    np.testing.assert_allclose(chunked, np.asarray(jl[:, -1]), atol=1e-5,
                               rtol=1e-5)


# --- the engine ---


def test_chunked_greedy_tokens_and_counters_match_jax(served):
    """Cold long prompts prefill in chunks of 16 while short prompts
    decode: tokens equal the monolithic engine's and the JAX chunked
    engine's; each request's chunk count and the chunk counters equal
    JAX's; the pools balance identically."""
    jm, variables, tm = served
    rng = np.random.default_rng(19)
    prompts = [rng.integers(1, VOCAB, size=(1, n)).astype(np.int32)
               for n in (50, 5, 41, 9)]
    news = [8, 10, 6, 7]
    kw = dict(slots=3, chunk_steps=4, page_tokens=4)
    jres, jt, jchk = serve_jax(jm, variables, prompts, news,
                               prefill_chunk_tokens=16, **kw)
    tres, tt, tchk = serve_port(tm, prompts, news, prefill_chunk_tokens=16,
                                **kw)
    mono, _, _ = serve_port(tm, prompts, news, **kw)
    assert tokens_of(tres) == tokens_of(mono) == tokens_of(jres)
    # 16 + 16 + 16 + a final 2; 16 + 16 + a final 9; short prompts none
    assert [r["prefill_chunks"] for r in tres] == [4, 0, 3, 0]
    assert ([r["prefill_chunks"] for r in tres]
            == [r["prefill_chunks"] for r in jres])
    for key in ("prefill_chunks", "prefill_chunk_tokens",
                "prefills_in_progress", "tokens_emitted", "pages_free"):
        assert tt[key] == jt[key], key
    assert tt["prefill_chunk_tokens"] == 50 + 41
    assert tchk == jchk and tchk["held"] == tchk["trie_pages"]


def test_chunked_seeded_sampling_matches_monolithic(served):
    """A row's generator starts at its final chunk's admission, so seeded
    sampled tokens are the same chunked and monolithic."""
    _, _, tm = served
    p = prompts_of([44], seed=7)
    outs = []
    for knob in (0, 16):
        dec = PagedBatchingDecoder(tm, slots=2, chunk_steps=4, page_tokens=4,
                                   prefill_chunk_tokens=knob, device="cpu")
        try:
            outs.append(dec.wait(dec.submit(GenerateRequest(
                prompts=p[0].tolist(), max_new_tokens=9, temperature=0.8,
                top_k=7, seed=42)), timeout=600))
        finally:
            dec.close()
    assert outs[0]["tokens"] == outs[1]["tokens"]
    assert outs[0]["lengths"] == outs[1]["lengths"]
    assert outs[0]["prefill_chunks"] == 0 and outs[1]["prefill_chunks"] == 3


def test_chunked_prefix_hit_starts_at_shared_cursor(served):
    """A prefix hit chunks only its suffix: the cursor starts at the shared
    pages' end, the result reports the cached tokens, and the tokens equal
    JAX's."""
    jm, variables, tm = served
    rng = np.random.default_rng(5)
    sysp = rng.integers(1, VOCAB, size=24).astype(np.int32)
    p1 = np.concatenate([sysp, rng.integers(1, VOCAB, size=9)
                         .astype(np.int32)])[None]
    p2 = np.concatenate([sysp, rng.integers(1, VOCAB, size=29)
                         .astype(np.int32)])[None]
    kw = dict(slots=2, chunk_steps=4, page_tokens=4, prefill_chunk_tokens=8)
    outs = {}
    for name, cls, dec in (
            ("jax", JaxRequest, JaxDecoder(jm, variables, paged_attn="gather",
                                           **kw)),
            ("port", GenerateRequest, PagedBatchingDecoder(tm, device="cpu",
                                                           **kw))):
        try:
            outs[name] = [dec.wait(dec.submit(cls(prompts=p.tolist(),
                                                  max_new_tokens=6)),
                                   timeout=600) for p in (p1, p2)]
        finally:
            dec.close()
    assert tokens_of(outs["port"]) == tokens_of(outs["jax"])
    r2 = outs["port"][1]
    assert r2["prefix_cached_tokens"] == 24  # 6 full pages of 4
    assert r2["prefill_chunks"] == 4  # suffix 29: 8 + 8 + 8 + a final 5
    assert r2["prefill_chunks"] == outs["jax"][1]["prefill_chunks"]


def test_chunked_spec_self_draft_matches_monolithic_and_jax(served):
    """Self-drafting composes with chunked prefill: the same greedy tokens
    chunked and monolithic, and as the JAX chunked spec engine."""
    jm, variables, tm = served
    prompts = prompts_of([45, 7], seed=3)
    news = [8, 6]
    spec = dict(slots=2, chunk_steps=4, page_tokens=4, spec="self", spec_k=2,
                spec_adaptive=False, spec_exit_layer=1)
    chunked, tele, _ = serve_port(tm, prompts, news, prefill_chunk_tokens=16,
                                  **spec)
    mono, _, _ = serve_port(tm, prompts, news, **spec)
    jres, _, _ = serve_jax(jm, variables, prompts, news,
                           prefill_chunk_tokens=16, **spec)
    assert tokens_of(chunked) == tokens_of(mono) == tokens_of(jres)
    assert tele["spec_steps"] > 0 and tele["prefill_chunks"] == 3


def test_chunked_int8_kv_arena_matches_monolithic(served):
    """Chunks are whole pages, so each int8 page's scale comes from one
    forward's tokens: the row's pages after a chunked prefill equal the
    monolithic ones within the int8 rule, and the tokens are the same."""
    jm, variables, tm = served
    p = prompts_of([42], seed=11)[0]
    arenas, toks = {}, {}
    for knob in (0, 16):
        dec = PagedBatchingDecoder(tm, slots=2, chunk_steps=4, page_tokens=4,
                                   pages=41, kv_quant="int8",
                                   prefix_cache=False,
                                   prefill_chunk_tokens=knob, device="cpu")
        try:
            toks[knob] = dec.wait(dec.submit(GenerateRequest(
                prompts=p.tolist(), max_new_tokens=1)), timeout=600)["tokens"]
            # max_new 1: the arena holds the prompt's K/V alone
            arenas[knob] = [{n: t.clone() for n, t in layer.items()}
                            for layer in dec.cache.layers]
        finally:
            dec.close()
    assert toks[0] == toks[16]
    for a, b in zip(arenas[0], arenas[16]):
        for name in a:
            if name.endswith("scale"):
                np.testing.assert_allclose(a[name], b[name], rtol=1e-6)
            else:
                assert (a[name].float() - b[name].float()).abs().max() <= 1
    jres, _, _ = serve_jax(jm, variables, [p], [7], slots=2, chunk_steps=4,
                           page_tokens=4, pages=41, kv_quant="int8",
                           prefill_chunk_tokens=16)
    tres, _, _ = serve_port(tm, [p], [7], slots=2, chunk_steps=4,
                            page_tokens=4, pages=41, kv_quant="int8",
                            prefill_chunk_tokens=16)
    assert tokens_of(tres) == tokens_of(jres)


def test_knob_zero_takes_the_monolithic_path(served):
    """Knob 0 (and any knob below a page) is the monolithic engine: no
    chunk counters, no pending ledger, the same tokens."""
    _, _, tm = served
    p = prompts_of([40], seed=2)
    ref, _, _ = serve_port(tm, p, [6], slots=2, chunk_steps=4, page_tokens=4)
    for knob in (0, 3):
        dec = PagedBatchingDecoder(tm, slots=2, chunk_steps=4, page_tokens=4,
                                   prefill_chunk_tokens=knob, device="cpu")
        try:
            assert dec.prefill_chunk == 0
            r = dec.wait(dec.submit(GenerateRequest(
                prompts=p[0].tolist(), max_new_tokens=6)), timeout=600)
            t = dec.telemetry()
            assert r["tokens"] == ref[0]["tokens"]
            assert r["prefill_chunks"] == 0
            assert t["prefill_chunks"] == t["prefill_chunk_tokens"] == 0.0
            assert t["prefills_in_progress"] == 0.0
            assert dec._prefill_pending == []
        finally:
            dec.close()


def test_mid_prefill_cancel_returns_pages_exactly_once(served):
    """Cancels landing between a row's chunks: the evicted row's lease
    returns exactly once, the prefill ledger drops it, and at drain the
    trie is the only page holder and every slot is free; a request after
    the storm still gets the monolithic engine's tokens."""
    _, _, tm = served
    dec = PagedBatchingDecoder(tm, slots=2, chunk_steps=4, page_tokens=4,
                               pages=41, prefill_chunk_tokens=8,
                               device="cpu")
    rng = np.random.default_rng(23)
    try:
        for i in range(6):
            p = rng.integers(1, VOCAB, size=(1, 40)).astype(np.int32)
            e = dec.submit(GenerateRequest(prompts=p.tolist(),
                                           max_new_tokens=8))
            time.sleep(0.002 * i)  # cancels at varied points of 5 chunks
            dec.cancel(e)
        p = rng.integers(1, VOCAB, size=(1, 33)).astype(np.int32)
        r = dec.wait(dec.submit(GenerateRequest(prompts=p.tolist(),
                                                max_new_tokens=5)),
                     timeout=600)
        deadline = time.time() + 60
        while time.time() < deadline:
            with dec._cond:
                idle = not dec._pending and not dec._busy()
            if idle:
                break
            time.sleep(0.02)
        assert idle, "engine did not drain"
        assert dec._prefill_pending == []
        chk = dec._pool.check()
        assert chk["held"] == chk["trie_pages"]
        dec._pool.trie.flush()
        assert dec._pool.free_pages() == dec._pool.capacity
        assert sorted(dec._free) == [0, 1]
        assert all(s is None for s in dec._slot_rows)
    finally:
        dec.close()
    ref, _, _ = serve_port(tm, [p], [5], slots=2, chunk_steps=4,
                           page_tokens=4)
    assert r["tokens"] == ref[0]["tokens"]


def test_prefill_forwards_charge_head_of_line_stall(served):
    """Rows decoding while a long prompt prefills are charged the wall of
    every prefill forward that delays them (``hol_stall_seconds``), one
    forward monolithic, six chunks of 16 chunked (80 + a final 8)."""
    _, _, tm = served
    short = prompts_of([5, 6], seed=31)
    long_p = prompts_of([88], seed=32)[0]
    for knob in (0, 16):
        dec = PagedBatchingDecoder(tm, slots=3, chunk_steps=2, page_tokens=4,
                                   prefill_chunk_tokens=knob, device="cpu")
        try:
            es = [dec.submit(GenerateRequest(prompts=p.tolist(),
                                             max_new_tokens=80))
                  for p in short]
            while any(e.first_token_at == 0.0 for e in es):
                time.sleep(0.001)
            dec.wait(dec.submit(GenerateRequest(prompts=long_p.tolist(),
                                                max_new_tokens=2)),
                     timeout=600)
            for e in es:
                dec.wait(e, timeout=600)
            t = dec.telemetry()
        finally:
            dec.close()
        assert t["hol_stall_seconds"] > 0.0
        assert t["prefill_chunks"] == (0.0 if knob == 0 else 6.0)
