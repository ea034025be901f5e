"""The port's causal transformer against the JAX ``CausalTransformer`` with
the same weights (carried across by ``interop.from_flax``): the non-cache
forward, and paged prefill followed by per-token steps - logits and the
arenas they write - in f32 and int8 KV storage, plus int8 weights.

Tolerance: logits atol 1e-5 (f32 throughout; the two frameworks sum in
other orders). f32 arenas atol 1e-5. int8 arenas may differ by +-1 only
where a value sits at a rounding tie in one framework and not the other.

Hazards these tests pin (each breaks parity when the port gets it wrong):
Flax ``nn.gelu`` is the tanh approximation; LayerNorm epsilon is 1e-6 by
default and 1e-5 for GPT-2 (``ln_eps``); rows past ``max_len`` clip their
position-embedding index; writes from padding and from positions past the
table go to trash page 0; int8 scales grow by scatter-max and a page
touched twice in one call is requantized identically both times.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeml_tpu.models.generation import init_paged_cache as jax_init_cache
from kubeml_tpu.serving.quant import quantize_tree as jax_quantize_tree
from kubeml_tpu_torch.interop.from_flax import from_flax
from kubeml_tpu_torch.models.generation import init_paged_cache
from kubeml_tpu_torch.models.layers import load_tree
from torch_port_helpers import VOCAB, jax_init, jax_tiny, torch_twin


def tokens(rng, B, L, pad_tail=0):
    ids = rng.integers(1, VOCAB, size=(B, L)).astype(np.int32)
    if pad_tail:
        ids[-1, -pad_tail:] = 0  # PAD_ID: masked out as keys
    return ids


@pytest.mark.parametrize("pos", ["learned", "rope"])
@pytest.mark.parametrize("gpt2", [False, True])
def test_forward_logits_match_jax(pos, gpt2):
    kw = dict(attn_bias=True, ln_eps=1e-5) if gpt2 else {}
    jm = jax_tiny(pos=pos, max_len=32, **kw)
    variables = jax_init(jm)
    tm = torch_twin(jm, variables)
    ids = tokens(np.random.default_rng(0), 3, 12, pad_tail=3)
    ref = np.asarray(jm.apply(variables, ids))
    with torch.inference_mode():
        out = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_forward_int8_weights_match_jax():
    """int8 weights through the native path: the JAX module applied to its
    QuantizedTensor tree, the port's QuantizableDense holding the same
    int8 values (converted by from_flax)."""
    jm = jax_tiny(max_len=32)
    qvars = jax_quantize_tree(jax_init(jm))
    tm = torch_twin(jm, jax_init(jm))
    load_tree(tm, from_flax(jax.tree.map(np.asarray, qvars)))
    assert tm.block_0.mlp_in.quantized and tm.block_0.mlp_out.quantized
    ids = tokens(np.random.default_rng(1), 2, 10)
    ref = np.asarray(jm.apply(qvars, ids))
    for impl in ("dot", "cuda"):  # "cuda" on CPU tensors = the plain version
        for m in tm.modules():
            if getattr(m, "quantized", False):
                m.int8_impl = impl
        with torch.inference_mode():
            out = tm(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def _jax_arenas(cache):
    return [{k: np.asarray(v) for k, v in cache[f"block_{i}"]["attn"].items()}
            for i in range(2)]


@pytest.mark.parametrize("pos", ["learned", "rope"])
@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_paged_prefill_then_steps_match_jax(pos, kv_quant):
    """Two rows prefill together (row 1 shorter: its padding writes go to
    the trash page), then 4 teacher-forced steps with a third dead row whose
    position runs past max_len and whose table is all trash."""
    pt, tw, max_len = 4, 8, 32
    npages = 2 * tw + 1
    jm = jax_tiny(pos=pos, max_len=max_len)
    variables = jax_init(jm)
    tm = torch_twin(jm, variables)
    jmod = jm.clone(page_tokens=pt, kv_pages=npages, paged_attn="gather",
                    kv_quant=kv_quant)
    jcache = jax_init_cache(jmod, variables, 2, tw)
    tcache = init_paged_cache(tm, npages, pt, kv_quant=kv_quant,
                              paged_attn="gather")
    rng = np.random.default_rng(2)
    prompt = tokens(rng, 2, 10)
    table = np.asarray([[1 + j for j in range(tw)],
                        [1 + tw + j for j in range(tw)]], np.int32)
    seq_lens = np.asarray([10, 6], np.int32)

    def step(ids, positions, tbl, lens=None):
        nonlocal jcache
        kw = {} if lens is None else {"seq_lens": jnp.asarray(lens)}
        jl, vs = jmod.apply({**variables, "cache": jcache}, ids, decode=True,
                            positions=jnp.asarray(positions),
                            pages=jnp.asarray(tbl), mutable=["cache"], **kw)
        jcache = vs["cache"]
        with torch.inference_mode():
            tl = tm(torch.from_numpy(ids), decode=True,
                    positions=torch.from_numpy(positions),
                    pages=torch.from_numpy(tbl),
                    seq_lens=None if lens is None else torch.from_numpy(lens),
                    cache=tcache)
        return np.asarray(jl), tl.numpy()

    jl, tl = step(prompt, np.zeros(2, np.int32), table, seq_lens)
    for b in range(2):
        np.testing.assert_allclose(tl[b, :seq_lens[b]], jl[b, :seq_lens[b]],
                                   atol=1e-5, rtol=1e-5)
    nxt = [int(jl[b, seq_lens[b] - 1].argmax()) for b in range(2)]
    dead_table = np.zeros((1, tw), np.int32)
    for i in range(4):
        ids = np.asarray([[nxt[0]], [nxt[1]], [5]], np.int32)
        positions = np.asarray([10 + i, 6 + i, 40], np.int32)
        jl, tl = step(ids, positions, np.concatenate([table, dead_table]))
        np.testing.assert_allclose(tl[:2], jl[:2], atol=1e-5, rtol=1e-5)
        nxt = [int(jl[b, -1].argmax()) for b in range(2)]
    # arenas agree on every page but the trash page (which takes several
    # conflicting writes per call, in an order neither framework fixes)
    for layer, jarena in enumerate(_jax_arenas(jcache)):
        tarena = {k: v.numpy() for k, v in tcache.layers[layer].items()}
        assert set(tarena) == set(jarena)
        for name, jv in jarena.items():
            tv = tarena[name][1:]
            jv = jv[1:]
            if name.endswith("_scale"):
                np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
            elif kv_quant == "int8":
                diff = np.abs(tv.astype(np.int32) - jv.astype(np.int32))
                assert diff.max() <= 1, (layer, name)
                assert (diff > 0).mean() < 0.01, (layer, name)
            else:
                np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=1e-4)


def test_quant_write_duplicate_pages_are_byte_identical():
    """One call writing three positions of one page: the page's scale grows
    once, by scatter-max over all three, its old values are requantized
    for that final scale and the new values quantize at it - the same bytes
    whichever of the duplicate (page, position) writes lands last. Held
    against that rule written out in numpy."""
    from kubeml_tpu_torch.models.gpt import _quant_write

    rng = np.random.default_rng(3)
    arena = rng.integers(-127, 128, size=(4, 4, 2, 8)).astype(np.int8)
    scales = rng.random((4, 2)).astype(np.float32)
    x = (rng.normal(size=(1, 3, 2, 8)) * 4).astype(np.float32)
    a, s = torch.from_numpy(arena.copy()), torch.from_numpy(scales.copy())
    _quant_write(a, s, torch.from_numpy(x), torch.tensor([[2, 2, 2]]),
                 torch.tensor([[0, 1, 2]]))
    new = np.maximum(scales[2], np.abs(x[0]).max(axis=(0, 2)))  # [H]
    want = arena.copy()
    want[2] = np.clip(np.round(arena[2].astype(np.float32)
                               * (scales[2] / new)[None, :, None]),
                      -127, 127)
    want[2, :3] = np.clip(np.round(x[0] * 127.0 / new[None, :, None]),
                          -127, 127)
    np.testing.assert_array_equal(s.numpy()[2], new)
    np.testing.assert_array_equal(s.numpy()[[0, 1, 3]], scales[[0, 1, 3]])
    np.testing.assert_array_equal(a.numpy(), want)
