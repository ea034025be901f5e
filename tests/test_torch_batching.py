"""The port's dense slot engine (``serving.batcher.BatchingDecoder``), the
mirror of ``tests/test_batching.py``: greedy tokens equal to the JAX
``BatchingDecoder``'s with the same weights (GPTTiny-sized models with
learned and rotary positions, and MoETiny, whose decode routes uncapped)
and to the port's one-shot ``generate``; eos, ragged rows, streams,
threads, timeouts, retire and close; counters under the JAX names;
seeded sampling equal slot against paged; int8 weights (the int8 matmul's
plain version, and MoE's in-step dequantize); the queue limit, shedding
and deadlines; a fault; the A/B harness's in-engine cancel.

Greedy tokens must be equal (f32 throughout; near ties would be logged by
``test_torch_dense_decode``'s check, and none occurs at these seeds).
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from kubeml_tpu.api.types import GenerateRequest as JaxRequest
from kubeml_tpu.models.gpt import CausalTransformer as JaxTransformer
from kubeml_tpu.parallel.moe import MoETransformer as JaxMoE
from kubeml_tpu.serving.batcher import BatchingDecoder as JaxDecoder
from kubeml_tpu_torch.api.errors import (EngineFaultError, KubeMLError,
                                         OverloadedError)
from kubeml_tpu_torch.api.types import GenerateRequest
from kubeml_tpu_torch.interop.from_flax import from_flax
from kubeml_tpu_torch.models.generation import generate
from kubeml_tpu_torch.models.gpt import PAD_ID, CausalTransformer
from kubeml_tpu_torch.models.layers import load_tree
from kubeml_tpu_torch.parallel.moe import MoETransformer
from kubeml_tpu_torch.serving.batcher import (BatchingDecoder,
                                              PagedBatchingDecoder)
from torch_port_helpers import numpy_tree

VOCAB = 101
CFG = dict(vocab_size=VOCAB, max_len=64, embed_dim=64, depth=2, num_heads=4)


def jax_module(kind):
    if kind == "moe":
        return JaxMoE(num_experts=4, **CFG)
    return JaxTransformer(pos=kind, **CFG)


def port_module(kind, variables):
    if kind == "moe":
        tm = MoETransformer(num_experts=4, device="cpu", **CFG)
    else:
        tm = CausalTransformer(pos=kind, device="cpu", **CFG)
    return load_tree(tm, from_flax(numpy_tree(variables)))


@pytest.fixture(scope="module", params=["learned", "rope", "moe"])
def served(request):
    kind = request.param
    jm = jax_module(kind)
    variables = jm.init(jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))
    return kind, jm, variables, lambda: port_module(kind, variables)


def one_shot(tm, prompt, n, **kw):
    out = generate(tm, np.asarray(prompt, np.int32), max_new_tokens=n, **kw)
    return out.tokens.numpy(), out.lengths.numpy()


def test_greedy_tokens_equal_the_jax_batching_decoder(served):
    """A mixed workload - more rows than slots, a ragged batch, an eos
    row - through both engines: the same tokens and lengths."""
    kind, jm, variables, build = served
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, VOCAB, size=int(n)).tolist()
               for n in rng.integers(3, 14, size=6)]
    wide = np.zeros((2, 9), np.int32)
    wide[0] = rng.integers(1, VOCAB, size=9)
    wide[1, :4] = rng.integers(1, VOCAB, size=4)
    bodies = [dict(prompts=[p], max_new_tokens=int(n))
              for p, n in zip(prompts, rng.integers(2, 12, size=6))]
    bodies.append(dict(prompts=wide.tolist(), prompt_lengths=[9, 4],
                       max_new_tokens=7))
    bodies.append(dict(prompts=[prompts[0]], max_new_tokens=10,
                       eos_id=int(one_shot(build(), [prompts[0]], 10)[0][0,
                                                                          3])))
    jdec = JaxDecoder(jm, variables, slots=3, chunk_steps=4)
    try:
        want = [jdec.wait(jdec.submit(JaxRequest(**b)), timeout=600)
                for b in [*bodies]]
    finally:
        jdec.close()
    dec = BatchingDecoder(build(), slots=3, chunk_steps=4, device="cpu")
    try:
        entries = [dec.submit(GenerateRequest(**b)) for b in bodies]
        got = [dec.wait(e, timeout=300) for e in entries]
    finally:
        dec.close()
    for g, w in zip(got, want):
        assert g["tokens"] == w["tokens"] and g["lengths"] == w["lengths"]


def test_more_rows_than_slots_queue_and_match(served):
    """12 rows through 3 slots: every row token-identical to one-shot."""
    _, _, _, build = served
    tm = build()
    dec = BatchingDecoder(tm, slots=3, chunk_steps=4, device="cpu")
    try:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, VOCAB, size=(1, int(n))).astype(np.int32)
                   for n in rng.integers(3, 12, size=12)]
        refs = [one_shot(tm, p, 6)[0][0].tolist() for p in prompts]
        entries = [dec.submit(GenerateRequest(prompts=p.tolist(),
                                              max_new_tokens=6))
                   for p in prompts]
        for entry, ref in zip(entries, refs):
            assert dec.wait(entry, timeout=600)["tokens"][0] == ref
    finally:
        dec.close()


def test_eos_masking_and_single_token(served):
    """The row stops at eos (pad after, the one-shot length); a 1-token
    request and an eos first token finish at the prefill."""
    _, _, _, build = served
    tm = build()
    p = np.arange(2, 10, dtype=np.int32)[None]
    ref, _ = one_shot(tm, p, 8)
    eos = int(ref[0, 2])
    ref_eos, ref_len = one_shot(tm, p, 8, eos_id=eos)
    dec = BatchingDecoder(tm, slots=2, chunk_steps=8, device="cpu")
    try:
        out = dec.wait(dec.submit(GenerateRequest(
            prompts=p.tolist(), max_new_tokens=8, eos_id=eos)), timeout=300)
        assert out["tokens"][0] == ref_eos[0].tolist()
        assert out["lengths"] == [int(ref_len[0])]
        assert all(t == PAD_ID for t in out["tokens"][0][out["lengths"][0]:])
        one = dec.wait(dec.submit(GenerateRequest(prompts=p.tolist(),
                                                  max_new_tokens=1)),
                       timeout=300)
        assert one["tokens"][0] == ref[0, :1].tolist()
        first = dec.wait(dec.submit(GenerateRequest(
            prompts=p.tolist(), max_new_tokens=6, eos_id=int(ref[0, 0]))),
            timeout=300)
        assert first["lengths"] == [1]
    finally:
        dec.close()


def test_mixed_knobs_stream_and_threads(served):
    """Greedy, temperature and top-k rows share the slab (greedy is not
    perturbed); stream deltas concatenate to the result; racing client
    threads each get their own answer."""
    _, _, _, build = served
    tm = build()
    p = np.arange(1, 7, dtype=np.int32)[None]
    ref, _ = one_shot(tm, p, 6)
    dec = BatchingDecoder(tm, slots=4, chunk_steps=4, device="cpu")
    try:
        g = dec.submit(GenerateRequest(prompts=p.tolist(), max_new_tokens=6))
        hot = dec.submit(GenerateRequest(prompts=p.tolist(), max_new_tokens=6,
                                         temperature=1.2, seed=11))
        topk = dec.submit(GenerateRequest(prompts=p.tolist(),
                                          max_new_tokens=6, temperature=0.9,
                                          top_k=5, seed=3))
        assert dec.wait(g, timeout=300)["tokens"][0] == ref[0].tolist()
        for e in (hot, topk):
            arr = np.asarray(dec.wait(e, timeout=300)["tokens"][0])
            assert arr.shape == (6,) and np.all((arr >= 0) & (arr < VOCAB))
        entry = dec.submit(GenerateRequest(prompts=p.tolist(),
                                           max_new_tokens=6, stream=True))
        got, final = [], None
        for rec in dec.stream(entry):
            if rec.get("done"):
                final = rec
            else:
                got += rec["tokens"]
        assert got == ref[0].tolist() and final["lengths"] == [6]
        prompts = [np.arange(1, 4 + i, dtype=np.int32)[None]
                   for i in range(6)]
        refs = [one_shot(tm, q, 5)[0][0].tolist() for q in prompts]
        results, errors = [None] * 6, []

        def run(i):
            try:
                results[i] = dec.wait(dec.submit(GenerateRequest(
                    prompts=prompts[i].tolist(), max_new_tokens=5)),
                    timeout=600)["tokens"][0]
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        assert not errors and results == refs
    finally:
        dec.close()


def test_sampling_reproducible_across_decoders(served):
    _, _, _, build = served
    p = np.arange(1, 7, dtype=np.int32)[None]
    req = dict(prompts=p.tolist(), max_new_tokens=6, temperature=0.8,
               seed=42)
    outs = []
    for _ in range(2):
        dec = BatchingDecoder(build(), slots=2, chunk_steps=4, device="cpu")
        try:
            outs.append(dec.wait(dec.submit(GenerateRequest(**req)),
                                 timeout=300))
        finally:
            dec.close()
    assert outs[0]["tokens"] == outs[1]["tokens"]


def test_seeded_sampling_slot_equals_paged():
    """Both engines draw a sampled row's tokens from one generator seeded
    by ``_seed_for(seed, row)`` - first at the prefill, then once a step -
    so a seeded request samples the same tokens dense and paged, whatever
    else shares the batch."""
    variables = jax_module("learned").init(jax.random.PRNGKey(0),
                                           np.zeros((1, 8), np.int32))
    rng = np.random.default_rng(4)
    bodies = [dict(prompts=[rng.integers(1, VOCAB, size=int(n)).tolist()],
                   max_new_tokens=int(m), temperature=0.8, top_k=20,
                   seed=100 + i)
              for i, (n, m) in enumerate(zip(rng.integers(3, 20, size=6),
                                             rng.integers(4, 20, size=6)))]
    bodies.append(dict(prompts=[[5, 6, 7]], max_new_tokens=9))
    outs = []
    for make in (lambda m: BatchingDecoder(m, slots=3, chunk_steps=4,
                                           device="cpu"),
                 lambda m: PagedBatchingDecoder(m, slots=2, chunk_steps=4,
                                                page_tokens=8,
                                                device="cpu")):
        dec = make(port_module("learned", variables))
        try:
            entries = [dec.submit(GenerateRequest(**b)) for b in bodies]
            outs.append([dec.wait(e, timeout=300)["tokens"]
                         for e in entries])
        finally:
            dec.close()
    assert outs[0] == outs[1]


def test_counters_under_the_jax_names(served):
    """One request at a time through both engines: the shared counters
    agree and the telemetry carries the JAX engine's gauge names."""
    kind, jm, variables, build = served
    bodies = [dict(prompts=[[3, 4, 5, 6]], max_new_tokens=5),
              dict(prompts=[[7, 8]], max_new_tokens=3, eos_id=200)]
    jdec = JaxDecoder(jm, variables, slots=2, chunk_steps=4)
    dec = BatchingDecoder(build(), slots=2, chunk_steps=4, device="cpu")
    try:
        for b in bodies:
            jdec.wait(jdec.submit(JaxRequest(**b)), timeout=600)
            dec.wait(dec.submit(GenerateRequest(**b)), timeout=300)
        jt, pt = jdec.telemetry(), dec.telemetry()
    finally:
        jdec.close()
        dec.close()
    for key in ("requests_submitted", "requests_completed",
                "tokens_emitted", "goodput_tokens", "wasted_tokens",
                "admission_waves", "prefill_tokens", "requests_rejected",
                "requests_timeout", "requests_canceled", "requests_failed"):
        assert pt[key] == jt[key], key
    for key in ("queue_depth", "slots_busy", "slots_total",
                "slot_occupancy", "weight_bytes", "queue_limit", "draining",
                "slot_steps", "live_slot_steps", "dead_slot_steps",
                "idle_slot_steps", "first_token_p50_seconds",
                "latency_p50_seconds"):
        assert key in jt and key in pt, key
    assert pt["slots_total"] == 2.0 and pt["slots_busy"] == 0.0
    assert set(pt) - set(jt) <= {"hist"}


def test_capacity_and_topk_rejections(served):
    _, _, _, build = served
    dec = BatchingDecoder(build(), slots=2, chunk_steps=2, device="cpu")
    try:
        for body in (dict(prompts=[[1, 2, 3]], max_new_tokens=63),
                     dict(prompts=[[1, 2]], max_new_tokens=2, top_k=129),
                     dict(prompts=[[1.5, 2.0]], max_new_tokens=2)):
            with pytest.raises((KubeMLError, ValueError)) as e:
                dec.submit(GenerateRequest(**body))
            if isinstance(e.value, KubeMLError):
                assert e.value.status_code == 400
        assert dec.telemetry()["requests_rejected"] >= 1
    finally:
        dec.close()


def test_timeout_cancels_and_frees_slots():
    tm = port_module("learned", jax_module("learned").init(
        jax.random.PRNGKey(0), np.zeros((1, 8), np.int32)))
    dec = BatchingDecoder(tm, slots=1, chunk_steps=2, device="cpu")
    try:
        p = np.arange(1, 5, dtype=np.int32)[None]
        dec.wait(dec.submit(GenerateRequest(prompts=p.tolist(),
                                            max_new_tokens=2)), timeout=300)
        big = dec.submit(GenerateRequest(prompts=p.tolist(),
                                         max_new_tokens=48))
        with pytest.raises(KubeMLError) as e:
            dec.wait(big, timeout=0.0)
        assert e.value.status_code == 504
        ref, _ = one_shot(tm, p, 4)
        out = dec.wait(dec.submit(GenerateRequest(prompts=p.tolist(),
                                                  max_new_tokens=4)),
                       timeout=300)
        assert out["tokens"][0] == ref[0].tolist()
        assert dec.telemetry()["requests_timeout"] == 1.0
    finally:
        dec.close()


def test_retire_close_and_queue_limits():
    """retire: in-flight work completes, new work is refused; close fails
    everything; a queue limit answers 429 (``reject``) or sheds the
    oldest queued request (``oldest``); a queued request past its
    deadline fails with 504."""
    from kubeml_tpu_torch.utils import resilience

    variables = jax_module("learned").init(jax.random.PRNGKey(0),
                                           np.zeros((1, 8), np.int32))
    tm = port_module("learned", variables)
    p = np.arange(1, 6, dtype=np.int32)[None]
    ref, _ = one_shot(tm, p, 8)
    dec = BatchingDecoder(tm, slots=2, chunk_steps=2, device="cpu")
    entry = dec.submit(GenerateRequest(prompts=p.tolist(), max_new_tokens=8))
    dec.retire()
    with pytest.raises(KubeMLError):
        dec.submit(GenerateRequest(prompts=p.tolist(), max_new_tokens=2))
    assert dec.wait(entry, timeout=300)["tokens"][0] == ref[0].tolist()
    dec.close()
    with pytest.raises(KubeMLError) as e:
        dec.submit(GenerateRequest(prompts=[[1, 2]], max_new_tokens=2))
    assert e.value.status_code == 503

    for policy in ("reject", "oldest"):
        dec = BatchingDecoder(tm, slots=1, chunk_steps=2, queue_limit=2,
                              shed_policy=policy, device="cpu")
        try:
            req = GenerateRequest(prompts=p.tolist(), max_new_tokens=2)
            with dec._cond:  # hold the engine: everything stays queued
                first, second = dec.submit(req), dec.submit(req)
                if policy == "reject":
                    with pytest.raises(OverloadedError):
                        dec.submit(req)
                else:
                    third = dec.submit(req)
            if policy == "oldest":
                with pytest.raises(OverloadedError):
                    dec.wait(first, timeout=300)
                assert dec.telemetry()["requests_shed"] == 1.0
                dec.wait(third, timeout=300)
            else:
                dec.wait(first, timeout=300)
                assert dec.telemetry()["requests_overload"] == 1.0
            dec.wait(second, timeout=300)
        finally:
            dec.close()

    dec = BatchingDecoder(tm, slots=1, chunk_steps=2, device="cpu")
    try:
        dec.wait(dec.submit(GenerateRequest(prompts=p.tolist(),
                                            max_new_tokens=2)), timeout=300)
        with dec._cond:
            long = dec.submit(GenerateRequest(prompts=p.tolist(),
                                              max_new_tokens=30))
            with resilience.bind_deadline(time.time() - 1.0):
                late = dec.submit(GenerateRequest(prompts=p.tolist(),
                                                  max_new_tokens=2))
        with pytest.raises(KubeMLError) as e:
            dec.wait(late, timeout=300)
        assert e.value.status_code == 504
        dec.wait(long, timeout=300)
        assert dec.telemetry()["requests_deadline_expired"] == 1.0
    finally:
        dec.close()


def test_fault_fails_requests_with_their_tokens_then_serves_again():
    """A fault in the loop: the resident requests fail with a retryable
    503 carrying their tokens (the JAX dense engine has no snapshot
    replay), the stripes are rebuilt, and the next request is served."""
    variables = jax_module("learned").init(jax.random.PRNGKey(0),
                                           np.zeros((1, 8), np.int32))
    tm = port_module("learned", variables)
    p = np.arange(1, 6, dtype=np.int32)[None]
    ref, _ = one_shot(tm, p, 6)
    dec = BatchingDecoder(tm, slots=2, chunk_steps=2, device="cpu")
    real = dec._decode_chunk
    calls = []

    def faulty(size):
        calls.append(size)
        if len(calls) == 2:
            raise RuntimeError("injected")
        return real(size)

    dec._decode_chunk = faulty
    try:
        entry = dec.submit(GenerateRequest(prompts=p.tolist(),
                                           max_new_tokens=12))
        with pytest.raises(EngineFaultError) as e:
            dec.wait(entry, timeout=300)
        assert e.value.status_code == 503
        assert e.value.partial_tokens[0] == ref[0, :3].tolist()
        out = dec.wait(dec.submit(GenerateRequest(prompts=p.tolist(),
                                                  max_new_tokens=6)),
                       timeout=300)
        assert out["tokens"][0] == ref[0].tolist()
        assert dec.telemetry()["requests_failed"] == 1.0
    finally:
        dec.close()


def test_chunk_ladder_and_pressure_sizing():
    """The JAX ladder: chunks of ``chunk_steps`` or the tail length, sized
    to the longest row; under queue pressure to the earliest completion."""
    variables = jax_module("learned").init(jax.random.PRNGKey(0),
                                           np.zeros((1, 8), np.int32))
    tm = port_module("learned", variables)
    dec = BatchingDecoder(tm, slots=2, chunk_steps=24, device="cpu")
    assert dec._chunk_sizes == [8, 24]
    sizes = []
    real = dec._decode_chunk
    dec._decode_chunk = lambda n: (sizes.append(n), real(n))
    try:
        a = dec.submit(GenerateRequest(prompts=[[1, 2, 3]],
                                       max_new_tokens=30))
        b = dec.submit(GenerateRequest(prompts=[[4, 5, 6]],
                                       max_new_tokens=5))
        dec.wait(a, timeout=300)
        dec.wait(b, timeout=300)
    finally:
        dec.close()
    assert sizes[0] == 24 and set(sizes) <= {8, 24}
    assert dec.telemetry()["dead_slot_steps"] > 0  # b froze mid-chunk


@pytest.mark.parametrize("kind", ["learned", "moe"])
def test_int8_weights(kind):
    """``quantize="int8"``: a dense model's projections run the int8 matmul
    (here its plain version) and give the paged int8 engine's tokens; an
    MoE model turns the int8 matmul off and dequantizes each step - its
    tokens are the one-shot generate's over the dequantized weights."""
    from kubeml_tpu_torch.serving.quant import dequantize_tree, quantize_tree

    variables = jax_module(kind).init(jax.random.PRNGKey(0),
                                      np.zeros((1, 8), np.int32))
    p = np.arange(3, 12, dtype=np.int32)[None]
    tm = port_module(kind, variables)
    dec = BatchingDecoder(tm, slots=2, chunk_steps=4, quantize="int8",
                          int8_matmul=True, device="cpu")
    try:
        got = dec.wait(dec.submit(GenerateRequest(prompts=p.tolist(),
                                                  max_new_tokens=8)),
                       timeout=300)["tokens"][0]
        assert dec.weight_bytes < sum(t.numel() * 4 for t in
                                      port_module(kind, variables)
                                      .parameters())
    finally:
        dec.close()
    if kind == "moe":
        assert not dec.int8_matmul and tm.block_1.moe.quantized
        assert all(m.int8_impl == "dequant" for m in tm.modules()
                   if getattr(m, "kernel_q", None) is not None)
        ref = port_module(kind, variables)
        load_tree(ref, dequantize_tree(quantize_tree(ref.state_dict()),
                                       torch.float32))
        assert got == one_shot(ref, p, 8)[0][0].tolist()
    else:
        assert dec.int8_matmul
        pdec = PagedBatchingDecoder(port_module(kind, variables), slots=2,
                                    chunk_steps=4, quantize="int8",
                                    int8_matmul=True, device="cpu")
        try:
            want = pdec.wait(pdec.submit(GenerateRequest(
                prompts=p.tolist(), max_new_tokens=8)),
                timeout=300)["tokens"][0]
        finally:
            pdec.close()
        assert got == want


def test_paged_serving_ab_holds_its_gate_on_the_cpu():
    """``benchmarks/paged_serving.py`` (the JAX A/B's tiny model and
    workload): the paged engine's occupancy and dead steps beat the slot
    engine's, twice the rows waste no more tokens, the shared prompt hits
    the trie, and every surviving request - greedy and seeded-sampled -
    has the same tokens slot and paged."""
    from kubeml_tpu_torch.benchmarks.paged_serving import gate, run_demo

    rows = run_demo(device="cpu")
    by = {r.get("engine"): r for r in rows}
    assert set(by) == {"slot", "paged", "paged-2x", None}
    parity = rows[-1]
    assert parity["match"] and parity["compared_requests"] == 19
    assert gate(rows), rows


@pytest.mark.parametrize("engine", ["slot", "paged"])
def test_cancel_after_wastes_the_rest_of_its_delta(engine):
    """An entry's ``cancel_after`` (the A/B harness's abandonment): the
    engine cancels the request itself once the row holds that many
    tokens, counts the tokens of that delta past it as wasted, and emits
    nothing after it. A row alone has a fixed chunk schedule (the
    prefill's token, then chunks of 16: tokens 2-17 and 18-33), so a
    cancel at token 20 wastes 13."""
    module = CausalTransformer(device="cpu", seed=0, **CFG)
    dec = (BatchingDecoder(module, slots=2, chunk_steps=16, device="cpu")
           if engine == "slot" else
           PagedBatchingDecoder(module, slots=2, chunk_steps=16,
                                page_tokens=8, device="cpu"))
    try:
        with dec._cond:
            entry = dec.submit(GenerateRequest(prompts=[[5, 6, 7, 8]],
                                               max_new_tokens=40))
            entry.cancel_after = 20
        deadline = time.time() + 120
        while time.time() < deadline:
            with dec._cond:
                if entry.aborted and not dec._pending and not dec._busy():
                    break
            time.sleep(0.01)
        t = dec.telemetry()
        assert len(entry.rows[0].out) == 33
        assert (t["goodput_tokens"], t["wasted_tokens"]) == (20.0, 13.0)
        assert t["tokens_emitted"] == 33.0
        assert t["requests_canceled"] == 1.0
    finally:
        dec.close()
