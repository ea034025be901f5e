"""The port's dense KV-cache decode against the JAX cache path with the same
weights (``interop.from_flax``): the scalar-cursor prefill followed by
cursor steps, and per-row ``positions`` steps (the slot engine's), for
GPTTiny-sized models with learned and rotary positions and for MoETiny
(whose decode routes uncapped); the one-shot greedy ``generate``
token-identical to JAX's; ``generate_from_request`` bodies equal to
JAX's, ragged rows included.

Tolerance: logits atol/rtol 1e-5 (f32 throughout; the frameworks sum in
other orders). Greedy tokens must be equal; a step whose top-2 logits lie
within 1e-5 of each other would be a near tie and is reported, not hidden
(none occurs at these seeds).
"""

import numpy as np
import pytest
import torch

from kubeml_tpu.api.types import GenerateRequest as JaxRequest
from kubeml_tpu.models.generation import generate as jax_generate
from kubeml_tpu.models.generation import \
    generate_from_request as jax_from_request
from kubeml_tpu.models.generation import init_cache as jax_init_cache
from kubeml_tpu.parallel.moe import MoETransformer as JaxMoE
from kubeml_tpu_torch.api.types import GenerateRequest
from kubeml_tpu_torch.interop.from_flax import from_flax
from kubeml_tpu_torch.models.generation import (generate,
                                                generate_from_request,
                                                init_cache)
from kubeml_tpu_torch.models.layers import load_tree
from kubeml_tpu_torch.parallel.moe import MoETransformer
from torch_port_helpers import (VOCAB, jax_init, jax_tiny, numpy_tree,
                                torch_twin)

TOL = dict(atol=1e-5, rtol=1e-5)


def jax_moe(max_len=48, pos="learned"):
    return JaxMoE(vocab_size=VOCAB, max_len=max_len, embed_dim=32, depth=2,
                  num_heads=2, num_experts=4, pos=pos)


def torch_moe(jm, variables):
    tm = MoETransformer(vocab_size=jm.vocab_size, max_len=jm.max_len,
                        embed_dim=jm.embed_dim, depth=jm.depth,
                        num_heads=jm.num_heads, num_experts=jm.num_experts,
                        moe_every=jm.moe_every, pos=jm.pos, device="cpu")
    return load_tree(tm, from_flax(numpy_tree(variables)))


def pair(kind, pos="learned", max_len=48):
    jm = jax_moe(max_len, pos) if kind == "moe" else jax_tiny(pos=pos,
                                                              max_len=max_len)
    variables = jax_init(jm)
    tm = (torch_moe if kind == "moe" else torch_twin)(jm, variables)
    return jm, variables, tm


CASES = [("gpt", "learned"), ("gpt", "rope"), ("moe", "learned")]


@pytest.mark.parametrize("kind,pos", CASES)
def test_prefill_then_cursor_steps_match_jax(kind, pos):
    jm, variables, tm = pair(kind, pos)
    rng = np.random.default_rng(0)
    B, Lp = 3, 7
    ids = rng.integers(1, VOCAB, size=(B, Lp)).astype(np.int32)
    jcache = jax_init_cache(jm, variables, B)
    jl, vs = jm.apply({**variables, "cache": jcache}, ids, decode=True,
                      mutable=["cache"])
    tcache = init_cache(tm, B)
    with torch.inference_mode():
        tl = tm(torch.from_numpy(ids), decode=True, cache=tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache.index == Lp
    jcache = vs["cache"]
    for step in range(4):
        tok = rng.integers(1, VOCAB, size=(B, 1)).astype(np.int32)
        jl, vs = jm.apply({**variables, "cache": jcache}, tok, decode=True,
                          mutable=["cache"])
        jcache = vs["cache"]
        with torch.inference_mode():
            tl = tm(torch.from_numpy(tok), decode=True, cache=tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # the caches themselves: K/V and the valid stripes of every layer
    for i in range(jm.depth):
        jattn = jcache[f"block_{i}"]["attn"]
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache.layers[i][name].numpy(),
                                       np.asarray(jattn[name]), **TOL)
        np.testing.assert_array_equal(tcache.layers[i]["valid"].numpy(),
                                      np.asarray(jattn["valid"]))
        assert int(jattn["index"]) == tcache.index


@pytest.mark.parametrize("kind,pos", CASES)
def test_per_row_position_steps_match_jax(kind, pos):
    """One-token steps at per-row positions over a cache whose rows sit
    at different depths (the slot engine's decode step)."""
    jm, variables, tm = pair(kind, pos)
    rng = np.random.default_rng(1)
    B, Lp = 3, 9
    ids = rng.integers(1, VOCAB, size=(B, Lp)).astype(np.int32)
    _, vs = jm.apply({**variables, "cache": jax_init_cache(jm, variables, B)},
                     ids, decode=True, mutable=["cache"])
    jcache = vs["cache"]
    tcache = init_cache(tm, B)
    with torch.inference_mode():
        tm(torch.from_numpy(ids), decode=True, cache=tcache)
    positions = np.array([4, 9, 6], np.int32)  # rows at their own depths
    for step in range(3):
        tok = rng.integers(1, VOCAB, size=(B, 1)).astype(np.int32)
        jl, vs = jm.apply({**variables, "cache": jcache}, tok, decode=True,
                          positions=positions, mutable=["cache"])
        jcache = vs["cache"]
        with torch.inference_mode():
            tl = tm(torch.from_numpy(tok), decode=True, cache=tcache,
                    positions=torch.from_numpy(positions))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        positions = positions + 1
    with pytest.raises(ValueError, match="one token"):
        tm(torch.from_numpy(ids[:, :2]), decode=True, cache=tcache,
           positions=torch.from_numpy(positions))


def _near_ties(tm, ids, tokens):
    """Steps of a greedy run whose top-2 logits lie within 1e-5 (the only
    places two frameworks may legitimately pick different tokens), read
    through the decode path (MoE routes uncapped there)."""
    ties = []
    full = np.concatenate([ids, tokens[:, :-1]], axis=1)
    with torch.inference_mode():
        logits = tm(torch.from_numpy(full.astype(np.int64)), decode=True,
                    cache=init_cache(tm, full.shape[0])).numpy()
    top2 = np.sort(logits[:, ids.shape[1] - 1:], axis=-1)[..., -2:]
    for b, t in zip(*np.nonzero(top2[..., 1] - top2[..., 0] < 1e-5)):
        ties.append((int(b), int(t)))
    return ties


@pytest.mark.parametrize("kind,pos", CASES)
def test_greedy_generate_token_identical_to_jax(kind, pos):
    jm, variables, tm = pair(kind, pos)
    ids = np.random.default_rng(2).integers(1, VOCAB,
                                            size=(2, 6)).astype(np.int32)
    ref = jax_generate(jm, variables, ids, max_new_tokens=12)
    out = generate(tm, ids, max_new_tokens=12)
    want = np.asarray(ref.tokens)
    assert not _near_ties(tm, ids, want), "near tie: inspect before trusting"
    np.testing.assert_array_equal(out.tokens.numpy(), want)
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))


def test_generate_eos_lengths_and_pad_rows_match_jax():
    """eos ends a row: later slots PAD, lengths count the eos."""
    jm, variables, tm = pair("gpt")
    ids = np.random.default_rng(3).integers(1, VOCAB,
                                            size=(3, 5)).astype(np.int32)
    free = np.asarray(jax_generate(jm, variables, ids,
                                   max_new_tokens=10).tokens)
    eos = int(free[0, 3])  # a token row 0 emits mid-way
    ref = jax_generate(jm, variables, ids, max_new_tokens=10, eos_id=eos)
    out = generate(tm, ids, max_new_tokens=10, eos_id=eos)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    assert int(out.lengths[0]) <= 4


def test_generate_sampling_rules():
    """Sampling needs an rng; the same seed draws the same tokens; top_k 1
    is greedy; capacity overflow is a GenerationInputError."""
    from kubeml_tpu_torch.models.generation import GenerationInputError

    _, _, tm = pair("gpt")
    ids = np.random.default_rng(4).integers(1, VOCAB,
                                            size=(2, 5)).astype(np.int32)
    with pytest.raises(GenerationInputError, match="rng"):
        generate(tm, ids, max_new_tokens=4, temperature=0.8)
    a = generate(tm, ids, max_new_tokens=8, temperature=0.8, rng=7)
    b = generate(tm, ids, max_new_tokens=8, temperature=0.8, rng=7)
    assert a.tokens.tolist() == b.tokens.tolist()
    greedy = generate(tm, ids, max_new_tokens=8)
    top1 = generate(tm, ids, max_new_tokens=8, temperature=0.8, top_k=1,
                    rng=3)
    assert top1.tokens.tolist() == greedy.tokens.tolist()
    with pytest.raises(GenerationInputError, match="max_len"):
        generate(tm, ids, max_new_tokens=tm.max_len)


@pytest.mark.parametrize("kind", ["gpt", "moe"])
def test_generate_from_request_bodies_match_jax(kind):
    """Uniform and ragged batches (grouped by true length), eos, and the
    400s for bad shapes and capacity, greedy, against the JAX body."""
    jm, variables, tm = pair(kind)
    rng = np.random.default_rng(5)
    prompts = rng.integers(1, VOCAB, size=(3, 8)).astype(np.int32)
    bodies = [
        dict(prompts=prompts.tolist(), max_new_tokens=6),
        dict(prompts=prompts.tolist(), max_new_tokens=6,
             prompt_lengths=[8, 3, 5]),
        dict(prompts=prompts.tolist(), max_new_tokens=5, eos_id=7,
             prompt_lengths=[2, 8, 2]),
    ]
    for body in bodies:
        want = jax_from_request(jm, variables, JaxRequest(**body))
        got = generate_from_request(tm, GenerateRequest(**body))
        assert got == {"tokens": want["tokens"], "lengths": want["lengths"]}
    from kubeml_tpu_torch.api.errors import KubeMLError

    for body in (dict(prompts=[[1.5, 2.0]], max_new_tokens=2),
                 dict(prompts=prompts.tolist(), max_new_tokens=48)):
        with pytest.raises(KubeMLError) as e:
            generate_from_request(tm, GenerateRequest(**body))
        assert e.value.status_code == 400
