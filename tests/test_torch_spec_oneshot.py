"""The port's one-shot speculative path (``models/generation.py``
``make_speculative_generate_fn`` and ``generate(spec=...)``) against the
JAX package's on the CPU, with the same weights carried across by
``interop.from_flax``.

Tolerances: greedy tokens, lengths and the acceptance accounting
(``proposed``/``accepted``/``drafted``/``steps``) are held EXACTLY equal
to JAX's, and greedy tokens exactly equal to the port's spec-off
``generate``. Sampled rows draw from a torch generator per row, not a JAX
key chain, so they are held to reproducibility at a seed and to their
lengths, not to JAX's values. Validation errors are held to JAX's type.
"""

import numpy as np
import pytest
import torch

from kubeml_tpu.models import generation as jgen
from kubeml_tpu.models.gpt import CausalTransformer as JaxTransformer
from kubeml_tpu.serving.quant import quantize_tree as jax_quantize_tree
from kubeml_tpu_torch.models import CausalTransformer
from kubeml_tpu_torch.models import generation as tgen
from kubeml_tpu_torch.models.generation import GenerationInputError
from kubeml_tpu_torch.models.layers import load_tree
from kubeml_tpu_torch.serving.quant import quantize_tree
from torch_port_helpers import VOCAB, jax_init, torch_twin


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_model(pos="learned", max_len=40, depth=2):
    return JaxTransformer(vocab_size=VOCAB, max_len=max_len, embed_dim=32,
                          depth=depth, num_heads=2, pos=pos)


@pytest.fixture(scope="module", params=["learned", "rope"])
def pair(request):
    jm = jax_model(request.param)
    variables = jax_init(jm)
    return jm, variables, torch_twin(jm, variables)


@pytest.fixture(scope="module")
def drafter():
    jd = JaxTransformer(vocab_size=VOCAB, max_len=40, embed_dim=16, depth=1,
                        num_heads=2)
    dvars = jax_init(jd, seed=5)
    return jd, dvars, torch_twin(jd, dvars)


def prompts(B, Lp, seed=0):
    return np.random.default_rng(seed).integers(
        1, VOCAB, size=(B, Lp)).astype(np.int32)


def run_both(jm, variables, tm, prompt, n, drafter=None, jax_vars=None,
             port_kw=None, **kw):
    """JAX's and the port's one-shot spec over one prompt: (jax result,
    port result). ``port_kw`` goes to the port alone."""
    jkw, tkw = dict(kw), dict(kw, **(port_kw or {}))
    if kw.get("spec") == "draft":
        jkw["draft_module"], tkw["draft_module"] = drafter[0], drafter[2]
    jfn = jgen.make_speculative_generate_fn(jm, max_new_tokens=n, **jkw)
    jout = jfn(jax_vars if jax_vars is not None else variables, prompt,
               draft_variables=drafter[1] if kw.get("spec") == "draft"
               else None)
    tout = tgen.make_speculative_generate_fn(tm, max_new_tokens=n,
                                             **tkw)(prompt)
    return jout, tout


def assert_same(jout, tout):
    assert tout.tokens.tolist() == np.asarray(jout.tokens).tolist()
    assert tout.lengths.tolist() == np.asarray(jout.lengths).tolist()
    assert ((tout.proposed, tout.accepted, tout.drafted, tout.steps)
            == (jout.proposed, jout.accepted, jout.drafted, jout.steps))


@pytest.mark.parametrize("kw", [
    dict(spec="self", exit_layer=1, spec_k=3),
    dict(spec="self", exit_layer=2, spec_k=4),
    dict(spec="draft", spec_k=3),
], ids=["self-1", "self-2", "draft"])
def test_greedy_tokens_and_accounting_equal_jax(pair, drafter, kw):
    """B 3, Lp 7, 12 new tokens, pages of 4: tokens and the acceptance
    accounting equal JAX's exactly, and the tokens equal the port's
    spec-off ``generate``."""
    jm, variables, tm = pair
    prompt = prompts(3, 7)
    jout, tout = run_both(jm, variables, tm, prompt, 12, drafter,
                          page_tokens=4, **kw)
    assert_same(jout, tout)
    ref = tgen.generate(tm, prompt, max_new_tokens=12)
    assert tout.tokens.tolist() == ref.tokens.tolist()
    assert tout.lengths.tolist() == ref.lengths.tolist()
    assert tout.proposed >= tout.drafted >= tout.accepted >= 0
    assert 0 < tout.steps <= 12


def test_row_at_max_len_keeps_its_lookahead_in_the_table(pair):
    """Lp + max_new - 1 == max_len: the table covers max_len positions and
    the k lookahead past it goes to the trash page, as in JAX."""
    jm, variables, tm = pair
    prompt = prompts(2, 30, seed=3)
    jout, tout = run_both(jm, variables, tm, prompt, 11, spec="self",
                          exit_layer=1, spec_k=4, page_tokens=4)
    assert_same(jout, tout)
    ref = tgen.generate(tm, prompt, max_new_tokens=11)
    assert tout.tokens.tolist() == ref.tokens.tolist()


@pytest.mark.parametrize("spec", ["self", "draft"])
def test_eos_parity(pair, drafter, spec):
    """An eos inside an accepted draft ends the row: tokens, lengths and
    accounting equal JAX's, and the spec-off ``generate``'s."""
    jm, variables, tm = pair
    prompt = np.arange(2, 10, dtype=np.int32)[None]
    ref = tgen.generate(tm, prompt, max_new_tokens=10)
    eos = int(ref.tokens[0, 3])
    jout, tout = run_both(jm, variables, tm, prompt, 10, drafter,
                          spec=spec, spec_k=3, exit_layer=2, eos_id=eos,
                          page_tokens=4)
    assert_same(jout, tout)
    ref_e = tgen.generate(tm, prompt, max_new_tokens=10, eos_id=eos)
    assert tout.tokens.tolist() == ref_e.tokens.tolist()
    assert tout.lengths.tolist() == ref_e.lengths.tolist()
    assert int(tout.lengths[0]) <= 4


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_int8_weights_equal_jax(kv_quant):
    """int8 weights (the int8 matmul's plain version on the CPU), with f32
    or int8 KV pages, under self-drafting: the drafter's writes to layers
    < exit and the verify's rewrite keep JAX's tokens and accounting."""
    jm = jax_model(depth=3).clone(kv_quant=kv_quant)
    variables = jax_init(jm)
    tm = torch_twin(jm, variables)
    load_tree(tm, quantize_tree(tm.state_dict()))
    prompt = prompts(2, 9, seed=4)
    # the JAX module carries kv_quant as a field, the port's cache as an
    # argument
    jout, tout = run_both(jm, variables, tm, prompt, 10,
                          jax_vars=jax_quantize_tree(variables),
                          port_kw=dict(kv_quant=kv_quant), spec="self",
                          exit_layer=1, spec_k=3, page_tokens=4)
    assert_same(jout, tout)
    assert any(m.quantized for m in tm.modules()
               if hasattr(m, "quantized"))


def _moe_pair():
    jm = JaxTransformer(vocab_size=VOCAB, max_len=40, embed_dim=32, depth=2,
                        num_heads=2, moe_every=2, num_experts=2)
    tm = CausalTransformer(vocab_size=VOCAB, max_len=40, embed_dim=32,
                           depth=2, num_heads=2, moe_every=2, num_experts=2,
                           device="cpu")
    return jm, tm


@pytest.mark.parametrize("case", [
    "unknown-spec", "spec-k-0", "no-paged-path", "draft-vocab",
    "exit-above-depth", "exit-negative", "draft-without-module",
    "temperature-without-rng"])
def test_validation_errors_match_jax(pair, case):
    """Each refusal raises the JAX function's exception type."""
    jm, variables, tm = pair
    jd = JaxTransformer(vocab_size=VOCAB + 1, max_len=40, embed_dim=16,
                        depth=1, num_heads=2)
    td = CausalTransformer(vocab_size=VOCAB + 1, max_len=40, embed_dim=16,
                           depth=1, num_heads=2, device="cpu")
    jmod, tmod = jm, tm
    kw = dict(max_new_tokens=4)
    jkw, tkw = {}, {}
    if case == "unknown-spec":
        kw["spec"] = "medusa"
    elif case == "spec-k-0":
        kw["spec_k"] = 0
    elif case == "no-paged-path":
        jmod, tmod = _moe_pair()
    elif case == "draft-vocab":
        kw["spec"] = "draft"
        jkw["draft_module"], tkw["draft_module"] = jd, td
    elif case == "exit-above-depth":
        kw["exit_layer"] = jm.depth + 1
    elif case == "exit-negative":
        kw["exit_layer"] = -1
    elif case == "draft-without-module":
        kw["spec"] = "draft"
    else:
        kw["temperature"] = 0.8
    prompt = prompts(1, 5)
    errors = []
    for make, mod, extra, call in (
            (jgen.make_speculative_generate_fn, jmod, jkw,
             lambda fn: fn(variables, prompt)),
            (tgen.make_speculative_generate_fn, tmod, tkw,
             lambda fn: fn(prompt))):
        with pytest.raises(ValueError) as info:
            call(make(mod, **kw, **extra))
        errors.append(type(info.value))
    assert errors[0].__name__ == errors[1].__name__
    if case in ("no-paged-path", "draft-vocab", "temperature-without-rng"):
        assert errors[1] is GenerationInputError
    else:
        assert errors[1] is ValueError


@pytest.mark.parametrize("spec", ["self", "draft"])
def test_sampled_rows_reproducible_with_right_lengths(pair, drafter, spec):
    """Sampled spec rows (temperature 0.9, top-k 20): the same seed gives
    the same tokens and accounting, another seed other tokens, and every
    row has max_new tokens without eos; with an eos, a row's length stops
    at its first eos and PAD_ID fills the rest."""
    _, _, tm = pair
    prompt = prompts(3, 6, seed=9)
    kw = dict(max_new_tokens=9, spec=spec, spec_k=3, exit_layer=1,
              temperature=0.9, top_k=20, page_tokens=4,
              draft_module=drafter[2] if spec == "draft" else None)
    fn = tgen.make_speculative_generate_fn(tm, **kw)
    a, b, c = fn(prompt, rng=11), fn(prompt, rng=11), fn(prompt, rng=12)
    assert a.tokens.tolist() == b.tokens.tolist()
    assert (a.proposed, a.accepted, a.steps) == (b.proposed, b.accepted,
                                                 b.steps)
    assert a.tokens.tolist() != c.tokens.tolist()
    assert a.lengths.tolist() == [9, 9, 9]
    assert a.accepted <= a.drafted <= 3 * 3 * a.steps  # k * B * steps
    eos = int(a.tokens[0, 2])
    e = tgen.make_speculative_generate_fn(tm, eos_id=eos, **kw)(prompt,
                                                               rng=11)
    for row, n in zip(e.tokens.tolist(), e.lengths.tolist()):
        assert 1 <= n <= 9
        assert eos not in row[:n - 1]
        assert n == 9 or row[n - 1] == eos
        assert all(t == tgen.PAD_ID for t in row[n:])
    assert int(e.lengths[0]) <= 3


def test_generate_spec_equals_spec_off(pair, drafter):
    """``generate(spec=...)`` returns the spec-off tokens and lengths for
    both backends (greedy), and refuses sampling without an rng first."""
    _, _, tm = pair
    prompt = prompts(2, 5, seed=2)
    ref = tgen.generate(tm, prompt, max_new_tokens=8)
    for kw in (dict(spec="self", spec_exit_layer=1, spec_k=2),
               dict(spec="draft", draft_module=drafter[2])):
        out = tgen.generate(tm, prompt, max_new_tokens=8, **kw)
        assert out.tokens.tolist() == ref.tokens.tolist()
        assert out.lengths.tolist() == ref.lengths.tolist()
    with pytest.raises(GenerationInputError):
        tgen.generate(tm, prompt, max_new_tokens=8, temperature=0.5,
                      spec="self")
