"""Speculative decoding in the port against the JAX package, on the CPU: the
acceptance math (``models.generation``), the adaptive-k controller
(``serving.spec``), the pool's lookahead reservation (``serving.kvpool``),
the early-exit head (``models.gpt`` ``exit_layer``) and the engine's spec
mode (``serving.batcher``), with the same weights carried across by
``interop.from_flax``.

Tolerances (``tests/test_torch_gpt.py``): f32 logits atol/rtol 1e-5.
Greedy tokens, acceptance counts, k trajectories, pool accounting and
counters are held EXACTLY equal. Sampled draws come from a torch generator
per row, not a JAX key chain, so sampled output is held in distribution
(a chi-square bound, stated below) and to reproducibility.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeml_tpu.api.types import GenerateRequest as JaxRequest
from kubeml_tpu.models import generation as jgen
from kubeml_tpu.models.gpt import CausalTransformer as JaxTransformer
from kubeml_tpu.serving.batcher import PagedBatchingDecoder as JaxDecoder
from kubeml_tpu.serving.kvpool import KVPool as JaxPool
from kubeml_tpu.serving.spec import AdaptiveK as JaxAdaptiveK
from kubeml_tpu_torch.api import GenerateRequest, KubeMLError
from kubeml_tpu_torch.models import generation as tgen
from kubeml_tpu_torch.models.generation import GenerationInputError
from kubeml_tpu_torch.models.layers import QuantizableDense
from kubeml_tpu_torch.serving import KVPool, PagedBatchingDecoder
from kubeml_tpu_torch.serving.spec import AdaptiveK
from torch_port_helpers import VOCAB, jax_init, torch_twin

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models gain nothing from intra-op threads; one thread keeps
    this module from crowding the other test workers' timed waits."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


LENS = [3, 9, 5, 12, 7, 4]
NEWS = [6, 12, 3, 1, 9, 17]


def jax_model(pos="learned", max_len=64, embed_dim=64, depth=4, heads=4):
    return JaxTransformer(vocab_size=VOCAB, max_len=max_len,
                          embed_dim=embed_dim, depth=depth, num_heads=heads,
                          pos=pos)


@pytest.fixture(scope="module", params=["learned", "rope"])
def served(request):
    jm = jax_model(request.param)
    variables = jax_init(jm)
    return jm, variables, torch_twin(jm, variables)


@pytest.fixture(scope="module")
def drafter():
    jd = jax_model(embed_dim=32, depth=1)
    dvs = jax_init(jd, seed=5)
    return jd, dvs, torch_twin(jd, dvs)


def prompts_of(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=(1, n)).astype(np.int32)
            for n in lens]


def drive(dec, request_cls, prompts, news, serial=False, **req):
    """Greedy results of ``prompts`` through ``dec``: all submitted at once,
    or one at a time (``serial``, so no two requests share a step)."""
    if serial:
        return [dec.wait(dec.submit(request_cls(
            prompts=p.tolist(), max_new_tokens=n, **req)), timeout=600)
            for p, n in zip(prompts, news)]
    entries = [dec.submit(request_cls(prompts=p.tolist(), max_new_tokens=n,
                                      **req))
               for p, n in zip(prompts, news)]
    return [dec.wait(e, timeout=600) for e in entries]


def serve_jax(jm, variables, prompts, news, serial=False, **kw):
    dec = JaxDecoder(jm, variables, paged_attn="gather", **kw)
    try:
        res = drive(dec, JaxRequest, prompts, news, serial)
        return res, dec.telemetry(), dec._pool.check()
    finally:
        dec.close()


def serve_port(tm, prompts, news, serial=False, **kw):
    dec = PagedBatchingDecoder(tm, device="cpu", **kw)
    try:
        res = drive(dec, GenerateRequest, prompts, news, serial)
        return res, dec.telemetry(), dec._pool.check()
    finally:
        dec.close()


def tokens_of(results):
    return [r["tokens"][0] for r in results]


# --- acceptance math ---


def jax_keys(S, seed=0):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 i))(np.arange(S))


def test_spec_accept_greedy_prefix_rule_matches_jax():
    """The JAX suite's case: the leading argmax-match run is accepted and
    the correction is the target argmax at the first mismatch."""
    S, k, V = 3, 3, 7
    logits = np.full((S, k + 1, V), -10.0, np.float32)
    for i in range(k + 1):
        logits[:, i, 2 + i] = 5.0  # target argmax chain [2, 3, 4, 5]
    drafts = np.array([[2, 3, 4], [2, 6, 4], [0, 3, 4]], np.int32)
    q = np.full((S, k, V), 1.0 / V, np.float32)
    temp, topk = np.zeros(S, np.float32), np.zeros(S, np.int32)
    jemit, jn = jgen.spec_accept(jnp.asarray(logits), jnp.asarray(drafts),
                                 jnp.asarray(q), jnp.asarray(temp),
                                 jnp.asarray(topk), jax_keys(S))
    temit, tn = tgen.spec_accept(torch.from_numpy(logits),
                                 torch.from_numpy(drafts), None,
                                 torch.from_numpy(temp),
                                 torch.from_numpy(topk), [None] * S)
    assert tn.tolist() == np.asarray(jn).tolist() == [3, 1, 0]
    assert temit.tolist() == np.asarray(jemit).tolist() == [
        [2, 3, 4, 5], [2, 3, -1, -1], [2, -1, -1, -1]]


@pytest.mark.parametrize("k", [0, 1, 3, 5])
def test_spec_accept_greedy_matches_jax_on_random_logits(k):
    """Greedy rows on random logits, drafts agreeing with the target argmax
    for a random leading run: emissions and accepted counts exact."""
    S, V = 12, 29
    rng = np.random.default_rng(k)
    logits = rng.normal(size=(S, k + 1, V)).astype(np.float32)
    arg = logits.argmax(-1)
    drafts = rng.integers(0, V, size=(S, k)).astype(np.int32)
    for s in range(S):
        run = int(rng.integers(0, k + 1))
        drafts[s, :run] = arg[s, :run]
    q = rng.dirichlet(np.ones(V), size=(S, k)).astype(np.float32)
    temp = np.zeros(S, np.float32)
    topk = rng.integers(0, 5, size=S).astype(np.int32)
    jemit, jn = jgen.spec_accept(jnp.asarray(logits), jnp.asarray(drafts),
                                 jnp.asarray(q), jnp.asarray(temp),
                                 jnp.asarray(topk), jax_keys(S))
    temit, tn = tgen.spec_accept(torch.from_numpy(logits),
                                 torch.from_numpy(drafts),
                                 torch.from_numpy(q), torch.from_numpy(temp),
                                 torch.from_numpy(topk), [None] * S)
    assert tn.tolist() == np.asarray(jn).tolist()
    assert temit.tolist() == np.asarray(jemit).tolist()


def test_spec_mask_emissions_matches_jax():
    """The JAX suite's case (remaining clips, eos clips after itself, a dead
    row emits nothing and keeps its feed) and random cases: every output
    exact."""
    cases = [(np.array([[5, 6, 7, 8], [5, 9, 7, 8], [5, 6, 7, 8]]),
              np.array([3, 3, 3]), np.array([True, True, False]),
              np.array([2, 4, 4]), np.array([-1, 9, -1]), np.array([1, 1, 1]))]
    rng = np.random.default_rng(3)
    for _ in range(20):
        S, k1 = 7, 5
        emit = rng.integers(0, 6, size=(S, k1))
        n_acc = rng.integers(0, k1, size=S)
        emit[np.arange(k1)[None, :] > n_acc[:, None]] = -1
        cases.append((emit, n_acc, rng.random(S) < 0.8,
                      rng.integers(0, 7, size=S),
                      rng.integers(-1, 6, size=S), rng.integers(0, 6, size=S)))
    for emit, n_acc, live, rem, eos, tok in cases:
        want = jgen.spec_mask_emissions(
            jnp.asarray(emit, jnp.int32), jnp.asarray(n_acc, jnp.int32),
            jnp.asarray(live), jnp.asarray(rem, jnp.int32),
            jnp.asarray(eos, jnp.int32), jnp.asarray(tok, jnp.int32))
        got = tgen.spec_mask_emissions(
            torch.tensor(emit), torch.tensor(n_acc), torch.tensor(live),
            torch.tensor(rem), torch.tensor(eos), torch.tensor(tok))
        for w, g in zip(want, got):
            assert g.tolist() == np.asarray(w).tolist()


def test_knob_probs_match_jax():
    """The sampling distribution p and q compare, under runtime
    temperature and top-k: within 1e-6 of JAX's."""
    S, V = 9, 101
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(S, V)).astype(np.float32) * 3
    temp = rng.uniform(0.3, 1.5, size=S).astype(np.float32)
    topk = np.array([0, 1, 2, 7, 50, 0, 128, 3, 0], np.int32)
    want = np.asarray(jgen._knob_probs(jnp.asarray(logits),
                                       jnp.asarray(temp), jnp.asarray(topk)))
    got = tgen._knob_probs(torch.from_numpy(logits), torch.from_numpy(temp),
                           torch.from_numpy(topk)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def generators(S, seed):
    return [torch.Generator().manual_seed(seed * 100_003 + i)
            for i in range(S)]


def test_spec_accept_identical_p_q_always_accepts():
    """p == q: every draft drawn from q is accepted (u * q < p for u < 1)."""
    S, k, V = 512, 4, 7
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(np.tile(rng.normal(size=V).astype(np.float32),
                                      (S, k + 1, 1)))
    temp, topk = torch.ones(S), torch.zeros(S, dtype=torch.int64)
    gens = generators(S, 1)
    drafts = torch.empty((S, k), dtype=torch.int64)
    q = torch.empty((S, k, V))
    for i in range(k):
        drafts[:, i], q[:, i] = tgen.draft_sample(logits[:, i], temp, topk,
                                                  gens)
    _, n_acc = tgen.spec_accept(logits, drafts, q, temp, topk, gens)
    assert n_acc.tolist() == [k] * S


def test_spec_accept_marginal_is_target_distribution():
    """Drafts from a WRONG q, accepted or corrected by the rule, leave the
    first emitted token distributed as p: chi-square of 6000 rows (each
    with its own generator) against the analytic p. Bound: df = V - 1 = 6,
    critical value 22.46 at p = 0.001 (the JAX suite's bound)."""
    S, V = 6000, 7
    rng = np.random.default_rng(2)
    tgt = np.tile(rng.normal(size=V).astype(np.float32) * 1.5, (S, 2, 1))
    dl = np.tile(rng.normal(size=V).astype(np.float32) * 1.5, (S, 1))
    temp, topk = torch.ones(S), torch.zeros(S, dtype=torch.int64)
    gens = generators(S, 3)
    drafts, q = tgen.draft_sample(torch.from_numpy(dl), temp, topk, gens)
    emit, _ = tgen.spec_accept(torch.from_numpy(tgt), drafts[:, None],
                               q[:, None], temp, topk, gens)
    p = np.asarray(jgen._knob_probs(jnp.asarray(tgt[:1, 0]),
                                    jnp.ones(1), jnp.zeros(1, jnp.int32)))[0]
    obs = np.bincount(emit[:, 0].numpy(), minlength=V).astype(np.float64)
    exp = p.astype(np.float64) * S
    chi2 = float(((obs - exp) ** 2 / np.maximum(exp, 1e-9)).sum())
    assert chi2 < 22.46, (chi2, obs.tolist(), exp.tolist())


def test_sampled_acceptance_reproduces_from_its_generators():
    """Sampled rows draw only from their own generators: the same seeds give
    the same emissions, whatever greedy rows sit beside them."""
    S, k, V = 6, 3, 13
    rng = np.random.default_rng(9)
    tgt = torch.from_numpy(rng.normal(size=(S, k + 1, V)).astype(np.float32))
    q = torch.softmax(torch.from_numpy(
        rng.normal(size=(S, k, V)).astype(np.float32)), -1)
    drafts = torch.from_numpy(rng.integers(0, V, size=(S, k)))
    temp = torch.tensor([0.8, 0.0, 1.2, 0.0, 0.5, 1.0])
    topk = torch.tensor([0, 0, 5, 0, 0, 3])

    def run(seed):
        gens = [torch.Generator().manual_seed(seed + i) if t > 0 else None
                for i, t in enumerate(temp.tolist())]
        return tgen.spec_accept(tgt, drafts, q, temp, topk, gens)

    a, b = run(7), run(7)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    greedy = tgen.spec_accept(tgt, drafts, q, temp, topk, [None] * S)
    for s in (1, 3):  # greedy rows follow the argmax rule alone
        assert torch.equal(a[0][s], greedy[0][s])


# --- the adaptive-k controller ---


def trajectory(ctl, events):
    """k after each event: ("step", drafted, accepted) or ("plain",)."""
    out = []
    for ev in events:
        if ev[0] == "step":
            ctl.on_step(ev[1], ev[2])
        else:
            ctl.on_plain_chunk()
        out.append((ctl.current(), ctl.disabled, ctl.suspensions, ctl.moves,
                    round(ctl.ratio, 12)))
    return out


def _random_events(seed, n=300):
    rng = np.random.default_rng(seed)
    ev = []
    for _ in range(n):
        if rng.random() < 0.2:
            ev.append(("plain",))
        else:
            d = int(rng.integers(0, 9))
            ev.append(("step", d, int(rng.integers(0, d + 1))))
    return ev


@pytest.mark.parametrize("cfg,events", [
    # walk down 4 -> 2 -> 1, suspend, re-probe at k 1
    (dict(k_max=4, cooldown=2, probe_every=3),
     [("step", 8, 0)] * 20 + [("plain",)] * 3 + [("step", 8, 8)] * 10),
    # grow back to the cap on high acceptance
    (dict(k_max=8, cooldown=2),
     [("step", 8, 0)] * 12 + [("step", 4, 4)] * 30),
    # the draft backend floors at 1, never suspends
    (dict(k_max=4, cooldown=1, allow_off=False), [("step", 8, 0)] * 50),
    (dict(k_max=4, adaptive=False), [("step", 8, 0)] * 50),
    # min_accept: permanent, waits out the cooldown, fires when pinned
    (dict(k_max=4, cooldown=3, min_accept=0.10),
     [("step", 8, 0)] * 10 + [("plain",)] * 50 + [("step", 4, 4)] * 20),
    (dict(k_max=4, cooldown=5, min_accept=0.10), [("step", 8, 0)] * 6),
    (dict(k_max=4, cooldown=2, min_accept=0.10), [("step", 8, 4)] * 100),
    (dict(k_max=4, adaptive=False, cooldown=3, min_accept=0.10),
     [("step", 8, 0)] * 10),
    (dict(k_max=4, cooldown=1, min_accept=0.0), [("step", 8, 0)] * 100),
    # random acceptance with plain chunks, both backends
    (dict(k_max=8, cooldown=3, probe_every=5), _random_events(1)),
    (dict(k_max=4, cooldown=2, allow_off=False, min_accept=0.2),
     _random_events(2)),
    (dict(k_max=5, cooldown=4, probe_every=7), _random_events(3)),
])
def test_adaptive_k_trajectory_matches_jax(cfg, events):
    cfg = dict(cfg)
    k_max = cfg.pop("k_max")
    port, ref = AdaptiveK(k_max, **cfg), JaxAdaptiveK(k_max, **cfg)
    assert port.ladder == ref.ladder
    assert trajectory(port, events) == trajectory(ref, events)


@pytest.mark.parametrize("args,kw", [((0,), {}), ((4,), {"min_accept": 1.0}),
                                     ((4,), {"min_accept": -0.1})])
def test_adaptive_k_validation_matches_jax(args, kw):
    with pytest.raises(ValueError):
        JaxAdaptiveK(*args, **kw)
    with pytest.raises(ValueError):
        AdaptiveK(*args, **kw)


# --- the pool's lookahead reservation ---


def test_pool_lookahead_accounting_matches_jax():
    """``total_positions``/``can_admit`` over a grid, and a sequence of
    admissions with lookahead (prefix hits, refusals, releases): the same
    page tables and the same ``check()`` as the JAX pool."""
    for num_pages, pt in ((5, 4), (17, 4), (33, 8)):
        port, ref = KVPool(num_pages, pt), JaxPool(num_pages, pt)
        for plen in (1, 3, 8, 15):
            for new in (1, 4, 9):
                for la in (0, 1, 3, 4):
                    for cap in (None, 12, 16, 64):
                        args = (plen, new, la, cap)
                        assert (port.total_positions(*args)
                                == ref.total_positions(*args))
                        assert port.can_admit(*args) == ref.can_admit(*args)
    port, ref = KVPool(17, 4), JaxPool(17, 4)
    rng = np.random.default_rng(5)
    sysp = list(range(1, 10))
    held = []
    for i in range(12):
        prompt = sysp + rng.integers(1, VOCAB, size=int(rng.integers(0, 6))
                                     ).tolist()
        new, la = int(rng.integers(1, 8)), int(rng.integers(0, 4))
        a = port.admit(prompt, new, lookahead=la, max_positions=24)
        b = ref.admit(prompt, new, lookahead=la, max_positions=24)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.pages, a.shared, a.prefix_tokens, a.prefill_pos) == (
                b.pages, b.shared, b.prefix_tokens, b.prefill_pos)
            port.register_prefix(prompt, a)
            ref.register_prefix(prompt, b)
            held.append((a, b))
        if i % 3 == 2 and held:
            a, b = held.pop(0)
            port.release(a)
            ref.release(b)
        assert port.check() == ref.check()


def test_pool_lookahead_reserves_spec_window():
    """The JAX suite's numbers: +3 lookahead takes 15 -> 18 positions, 4 ->
    5 pages; clamped at the model cap it reserves the plain worst case."""
    pool = KVPool(17, 4, prefix_cache=False)
    a = pool.admit(np.arange(1, 9), 8, lookahead=3)
    assert len(a.pages) == 5
    pool.release(a)
    b = pool.admit(np.arange(1, 9), 8, lookahead=3, max_positions=15)
    assert len(b.pages) == 4
    pool.release(b)
    assert pool.free_pages() == pool.capacity
    assert not KVPool(5, 4).can_admit(8, 9, lookahead=4)
    assert KVPool(5, 4).can_admit(8, 9, lookahead=4, max_positions=16)


# --- the early-exit head ---


@pytest.mark.parametrize("exit_layer", [1, 2, 4])
def test_exit_layer_logits_match_jax(exit_layer):
    """The non-cache forward and a paged prefill + one decode step through
    the first ``exit_layer`` blocks: logits within 1e-5 of JAX's; the
    arenas of the layers it skipped stay zero, the others match JAX's."""
    jm = jax_model(max_len=32)
    variables = jax_init(jm)
    tm = torch_twin(jm, variables)
    rng = np.random.default_rng(exit_layer)
    ids = rng.integers(1, VOCAB, size=(2, 9)).astype(np.int32)
    want = np.asarray(jm.apply(variables, ids, exit_layer=exit_layer))
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids), exit_layer=exit_layer).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    pt, tp = 4, 8
    mod = jm.clone(page_tokens=pt, kv_pages=2 * tp + 1, paged_attn="gather")
    table = np.arange(1, 2 * tp + 1, dtype=np.int32).reshape(2, tp)
    jcache = jgen.init_paged_cache(mod, variables, 2, tp)
    tcache = tgen.init_paged_cache(tm, 2 * tp + 1, pt)
    pos = np.zeros(2, np.int32)
    for step in (ids, ids[:, -1:]):
        jl, vs = mod.apply({**variables, "cache": jcache}, step, decode=True,
                           positions=pos, pages=table, exit_layer=exit_layer,
                           mutable=["cache"])
        jcache = vs["cache"]
        with torch.inference_mode():
            tl = tm(torch.from_numpy(step), decode=True,
                    positions=torch.from_numpy(pos),
                    pages=torch.from_numpy(table), cache=tcache,
                    exit_layer=exit_layer)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=1e-5)
        pos = pos + step.shape[1]
    for i, arena in enumerate(tcache.layers):
        k = arena["k_pages"].numpy()
        if i < exit_layer:
            jk = np.asarray(jcache[f"block_{i}"]["attn"]["k_pages"])
            np.testing.assert_allclose(k, jk, atol=1e-5)
        else:
            assert not k.any()


def test_exit_layer_validation_matches_jax():
    jm = jax_model(max_len=16)
    variables = jax_init(jm)
    tm = torch_twin(jm, variables)
    ids = np.ones((1, 2), np.int32)
    for bad in (0, 5):
        with pytest.raises(ValueError):
            jm.apply(variables, ids, exit_layer=bad)
        with pytest.raises(ValueError, match="exit_layer"):
            tm(torch.from_numpy(ids), exit_layer=bad)


# --- the engine's spec mode ---


def spec_kw(mode, drafter):
    if mode == "draft":
        return (dict(spec="draft", draft_module=drafter[0],
                     draft_variables=drafter[1]),
                dict(spec="draft", draft_module=drafter[2]))
    e = int(mode.split("-")[1])
    kw = dict(spec="self", spec_exit_layer=e)
    return kw, dict(kw)


@pytest.mark.parametrize("mode", ["self-2", "self-1", "draft"])
def test_engine_spec_greedy_tokens_match_jax(served, drafter, mode):
    """Mixed prompt and generation lengths through 3 slots, k 3: the port's
    spec tokens equal the JAX spec engine's and the port's spec-off
    engine's, and the pools balance identically at drain."""
    jm, variables, tm = served
    prompts = prompts_of(LENS)
    common = dict(slots=3, chunk_steps=8, page_tokens=4, spec_k=3,
                  spec_adaptive=False)
    jkw, tkw = spec_kw(mode, drafter)
    jres, _, jchk = serve_jax(jm, variables, prompts, NEWS, **common, **jkw)
    tres, tele, tchk = serve_port(tm, prompts, NEWS, **common, **tkw)
    plain, _, _ = serve_port(tm, prompts, NEWS, slots=3, chunk_steps=8,
                             page_tokens=4)
    assert tokens_of(tres) == tokens_of(jres) == tokens_of(plain)
    assert [r["lengths"] for r in tres] == [r["lengths"] for r in jres]
    assert tele["spec_steps"] > 0
    for r in tres:
        assert r["spec_proposed_tokens"] >= r["spec_accepted_tokens"] >= 0
    assert tchk == jchk
    assert tchk["held"] == tchk["trie_pages"]


@pytest.mark.parametrize("mode", ["self-2", "draft", "draft-same"])
def test_engine_spec_counters_match_jax(served, drafter, mode):
    """Requests one at a time (no two share a step), k fixed: the spec
    counters, the controller's EWMA and each request's proposed/accepted
    tokens equal the JAX engine's. ``draft-same`` drafts with a copy of
    the target, so every step accepts all k drafts: the draft backend's
    write-only iteration must have put the last draft's K/V in its arena,
    or its next proposals (and the counts) drift from JAX's."""
    jm, variables, tm = served
    prompts = prompts_of(LENS, seed=1)
    common = dict(slots=2, chunk_steps=4, page_tokens=4, spec_k=3,
                  spec_adaptive=False, spec_min_accept=0.0)
    if mode == "draft-same":
        jkw = dict(spec="draft", draft_module=jm, draft_variables=variables)
        tkw = dict(spec="draft", draft_module=torch_twin(jm, variables))
    else:
        jkw, tkw = spec_kw(mode, drafter)
    jres, jt, _ = serve_jax(jm, variables, prompts, NEWS, serial=True,
                            **common, **jkw)
    tres, tt, _ = serve_port(tm, prompts, NEWS, serial=True, **common, **tkw)
    assert tokens_of(tres) == tokens_of(jres)
    for key in ("spec_steps", "spec_drafted_tokens", "spec_proposed_tokens",
                "spec_accepted_tokens", "spec_accept_rate", "spec_k",
                "spec_disabled", "tokens_emitted", "prefix_hits",
                "prefill_chunks", "prefill_chunk_tokens",
                "prefills_in_progress", "pages_free", "prefix_cache_pages"):
        assert tt[key] == jt[key], key
    assert tt["spec_accept_ewma"] == pytest.approx(jt["spec_accept_ewma"],
                                                   abs=1e-12)
    for key in ("spec_proposed_tokens", "spec_accepted_tokens",
                "prefix_cached_tokens", "prefill_chunks"):
        assert [r[key] for r in tres] == [r[key] for r in jres], key
    if mode == "draft-same":
        assert tt["spec_accept_rate"] == 1.0


@pytest.mark.parametrize("int8_matmul", [False, True])
def test_engine_spec_int8_weights_and_kv_match_jax(int8_matmul):
    """int8 weights (dequantized or through the int8 matmul) with int8 KV
    pages under self-drafting: the drafter's writes to layers < e, then
    the verify's, in the same order as JAX's, so the scale growth and the
    greedy tokens agree."""
    jm = jax_model()
    variables = jax_init(jm)
    tm = torch_twin(jm, variables)
    prompts = prompts_of([9, 4, 13])
    news = [8, 11, 6]
    kw = dict(slots=2, chunk_steps=4, page_tokens=4, quantize="int8",
              int8_matmul=int8_matmul, kv_quant="int8", spec="self",
              spec_exit_layer=2, spec_k=3, spec_adaptive=False)
    jres, _, jchk = serve_jax(jm, variables, prompts, news, **kw)
    tres, tele, tchk = serve_port(tm, prompts, news, **kw)
    assert tokens_of(tres) == tokens_of(jres)
    assert tchk == jchk
    assert tele["kv_quant"] == 1.0 and tele["spec_steps"] > 0


def test_engine_draft_module_rides_the_int8_path(drafter):
    jm = jax_model()
    tm = torch_twin(jm, jax_init(jm))
    dm = torch_twin(drafter[0], drafter[1])
    dec = PagedBatchingDecoder(tm, slots=2, page_tokens=4, quantize="int8",
                               int8_matmul=True, spec="draft",
                               draft_module=dm, device="cpu")
    try:
        assert any(m.quantized for m in dm.modules()
                   if isinstance(m, QuantizableDense))
        out = dec.wait(dec.submit(GenerateRequest(
            prompts=[[3, 4, 5, 6, 7]], max_new_tokens=6)), timeout=60)
        assert out["lengths"] == [6]
    finally:
        dec.close()


def test_engine_sampled_spec_reproduces_and_stops_at_eos(served):
    """Sampled spec reproduces across repeats and batch neighbours; greedy
    spec stops at an eos exactly where the spec-off engine does."""
    _, _, tm = served
    p = np.arange(1, 12, dtype=np.int32)[None]
    kw = dict(slots=2, chunk_steps=4, page_tokens=4, spec="self",
              spec_exit_layer=2, spec_k=2, spec_adaptive=False)
    dec = PagedBatchingDecoder(tm, device="cpu", **kw)
    try:
        req = dict(prompts=p.tolist(), max_new_tokens=9, temperature=0.8,
                   top_k=7, seed=42)
        a = dec.wait(dec.submit(GenerateRequest(**req)), timeout=600)
        noise = dec.submit(GenerateRequest(prompts=[[5, 6, 7]],
                                           max_new_tokens=12))
        b = dec.wait(dec.submit(GenerateRequest(**req)), timeout=600)
        dec.wait(noise, timeout=600)
        assert a["tokens"] == b["tokens"] and a["lengths"] == b["lengths"]
        plain = PagedBatchingDecoder(tm, slots=2, chunk_steps=4,
                                     page_tokens=4, device="cpu")
        try:
            ref = plain.wait(plain.submit(GenerateRequest(
                prompts=p.tolist(), max_new_tokens=8)), timeout=600)
            eos = ref["tokens"][0][2]
            want = plain.wait(plain.submit(GenerateRequest(
                prompts=p.tolist(), max_new_tokens=8, eos_id=eos)),
                timeout=600)
        finally:
            plain.close()
        got = dec.wait(dec.submit(GenerateRequest(
            prompts=p.tolist(), max_new_tokens=8, eos_id=eos)), timeout=600)
        assert got["tokens"] == want["tokens"]
        assert got["lengths"] == want["lengths"]
        assert got["lengths"][0] <= 3
    finally:
        dec.close()


def test_spec_rollback_exact_under_cancel_and_timeout(served):
    """Spec traffic with waiters giving up mid-flight: at drain the pool
    balances exactly (the lookahead writes leaked no page) and every
    request that finished holds the spec-off engine's tokens."""
    _, _, tm = served
    dec = PagedBatchingDecoder(tm, slots=3, chunk_steps=8, page_tokens=4,
                               pages=41, spec="self", spec_exit_layer=2,
                               spec_k=3, device="cpu")
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(1, VOCAB, size=(1, int(rng.integers(3, 14))))
             .astype(np.int32), int(rng.integers(4, 24))) for _ in range(10)]
    try:
        entries = [dec.submit(GenerateRequest(prompts=p.tolist(),
                                              max_new_tokens=n))
                   for p, n in reqs]
        done = {}
        for i, e in enumerate(entries):
            if i % 3 == 0:
                dec.cancel(e)
            elif i % 3 == 1:
                try:
                    done[i] = dec.wait(e, timeout=0.0)
                except KubeMLError as err:
                    assert err.status_code == 504
            else:
                done[i] = dec.wait(e, timeout=600)
        deadline = time.time() + 60
        while time.time() < deadline:
            with dec._cond:
                idle = not dec._pending and not dec._busy()
            if idle:
                break
            time.sleep(0.02)
        assert idle, "engine did not drain"
        chk = dec._pool.check()
        assert chk["held"] == chk["trie_pages"]
        dec._pool.trie.flush()
        assert dec._pool.free_pages() == dec._pool.capacity
        assert sorted(dec._free) == [0, 1, 2]
    finally:
        dec.close()
    plain, _, _ = serve_port(tm, [reqs[i][0] for i in done],
                             [reqs[i][1] for i in done], slots=3,
                             chunk_steps=8, page_tokens=4)
    assert [done[i]["tokens"][0] for i in done] == tokens_of(plain)


def test_engine_rejects_bad_spec_configs_as_jax_does(served):
    jm, variables, tm = served
    wrong = JaxTransformer(vocab_size=7, max_len=64, embed_dim=32, depth=1,
                           num_heads=4)
    wv = jax_init(wrong)
    short = jax_model(max_len=16, embed_dim=32, depth=1)
    sv = jax_init(short)
    cases = [
        (dict(spec="banana"), dict(spec="banana"), ValueError),
        (dict(spec="draft"), dict(spec="draft"), GenerationInputError),
        (dict(spec="draft", draft_module=wrong, draft_variables=wv),
         dict(spec="draft", draft_module=torch_twin(wrong, wv)),
         GenerationInputError),
        (dict(spec="draft", draft_module=short, draft_variables=sv),
         dict(spec="draft", draft_module=torch_twin(short, sv)),
         GenerationInputError),
        (dict(spec="self", spec_exit_layer=99),
         dict(spec="self", spec_exit_layer=99), GenerationInputError),
    ]
    for jkw, tkw, err in cases:
        with pytest.raises(Exception) as jerr:
            JaxDecoder(jm, variables, slots=2, page_tokens=4, **jkw)
        with pytest.raises(err):
            PagedBatchingDecoder(tm, slots=2, page_tokens=4, device="cpu",
                                 **tkw)
        assert isinstance(jerr.value, (ValueError, GenerationInputError,
                                       jgen.GenerationInputError))
    # spec off keeps the plain engine: no spec series, no lookahead
    dec = PagedBatchingDecoder(tm, slots=2, page_tokens=4, spec="off",
                               device="cpu")
    try:
        assert dec.spec == "" and dec._spec_lookahead == 0
        assert "spec_k" not in dec.telemetry()
    finally:
        dec.close()


def test_spec_capacity_guard_uses_the_lookahead():
    """A request that fits the arena only without the lookahead is a 400
    under spec at an uncapped max_len, in both engines alike."""
    jm = jax_model(max_len=64)
    variables = jax_init(jm)
    tm = torch_twin(jm, variables)
    req = dict(prompts=[list(range(1, 9))], max_new_tokens=9)  # 16 positions
    kw = dict(slots=1, page_tokens=4, pages=5, spec="self", spec_k=4)
    jdec = JaxDecoder(jm, variables, paged_attn="gather", **kw)
    tdec = PagedBatchingDecoder(tm, device="cpu", **kw)
    try:
        with pytest.raises(Exception) as jerr:
            jdec.submit(JaxRequest(**req))
        with pytest.raises(KubeMLError) as terr:
            tdec.submit(GenerateRequest(**req))
        assert terr.value.status_code == jerr.value.status_code == 400
    finally:
        jdec.close()
        tdec.close()


# --- benchmarks/spec_decode.py ---


def test_coherent_tail_matches_jax():
    """The port's ``coherent_tail`` on a twin equals the twin of the JAX
    ``coherent_tail``'s variables, and its early exit then tracks the full
    forward closely."""
    from kubeml_tpu.benchmarks.spec_decode import coherent_tail as jax_tail
    from kubeml_tpu_torch.benchmarks.spec_decode import coherent_tail

    jm = jax_model(max_len=32)
    variables = jax_init(jm)
    got = coherent_tail(torch_twin(jm, variables), 2)
    want = torch_twin(jm, jax_tail(variables, 2))
    for (name, a), (_, b) in zip(got.state_dict().items(),
                                 want.state_dict().items()):
        assert torch.equal(a, b), name
    ids = torch.from_numpy(prompts_of([9])[0])
    with torch.inference_mode():
        full, early = got(ids), got(ids, exit_layer=2)
    assert torch.equal(full.argmax(-1), early.argmax(-1))


def test_spec_decode_rows_cpu():
    """``run_rows`` at the tiny model on the CPU: greedy parity with the
    spec-off engine in every mode, self-drafting above one token a step."""
    from kubeml_tpu_torch.benchmarks.spec_decode import main, run_rows

    rows, ok = run_rows(0, 3, 10, 4, 4, 8, 3, model="tiny", device="cpu")
    assert ok
    assert len(rows) == 13
    self_b1 = next(r for r in rows if r["mode"] == "self"
                   and r["batch"] == 1 and r["sampling"] == "greedy")
    assert self_b1["spec_tokens_per_step"] > 1.0
    assert all(r["greedy_parity"] for r in rows if r["sampling"] == "greedy")
    assert main(["--device", "cpu", "--requests", "2", "--max-new", "6"]) == 0
