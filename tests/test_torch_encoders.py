"""The port's encoder models (ViT, BERT, VGG) against the JAX package's.

Same inputs (numpy seeds) and the same weights (Flax init -> numpy ->
``from_flax_variables``) through ``kubeml_tpu.models.{vit,bert,vgg}`` and
``kubeml_tpu_torch.models.{vit,bert,vgg}`` on the CPU, at small sizes (a
depth-2 ViT, ``BertTiny``, VGG-11 on 32x32 and 64x64). Tolerances: f32
logits within 1e-5 absolute (the frameworks sum in other orders; ~1e-6
observed); bf16 logits within 5e-2 of the f32 logit scale (bf16 keeps 8
bits of mantissa, 2^-8 = 3.9e-3 a rounding, and the two frameworks round
different intermediates over 2-8 layers; ~1e-2 observed); gradients
through the flash path's plain versions within 1e-5 of each gradient's
largest entry plus 1e-7 (f32; the kernels' arithmetic differs from XLA's
softmax in order only; the key bias's gradient is 0 in exact arithmetic,
as softmax ignores a shift of a row's scores, so both sides hold rounding
noise of ~1e-8 there)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as nn

from kubeml_tpu.models import bert as jbert
from kubeml_tpu.models import vgg as jvgg
from kubeml_tpu.models import vit as jvit
from kubeml_tpu_torch.interop.from_flax import (from_flax_variables,
                                                to_flax_variables)
from kubeml_tpu_torch.models import bert as tbert
from kubeml_tpu_torch.models import layers
from kubeml_tpu_torch.models import vgg as tvgg
from kubeml_tpu_torch.models import vit as tvit
from kubeml_tpu_torch.ops import attention as tattention

F32_ATOL = 1e-5
BF16_RTOL = 5e-2
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jdtype(dtype):
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]


def make(kind, dtype=torch.float32, hw=32):
    """(JAX module, port module, input) of one small encoder."""
    r = np.random.default_rng({"vit": 0, "bert": 1, "vgg": 2}[kind] + hw)
    if kind == "vit":
        kw = dict(num_classes=10, depth=2, embed_dim=64, num_heads=2)
        jm = jvit.ViT(**kw, dtype=_jdtype(dtype))
        tm = tvit.ViT(**kw, dtype=dtype)
        x = r.normal(size=(3, 32, 32, 3)).astype(np.float32)
    elif kind == "bert":
        jm = jbert.BertTiny(dtype=_jdtype(dtype))
        tm = tbert.BertTiny(dtype=dtype)
        x = r.integers(1, 1000, size=(3, 16)).astype(np.int32)
        x[1, 9:] = 0     # trailing padding
        x[2, 1:] = 0     # only [CLS] is a real key
    else:
        jm = jvgg.VGG11(num_classes=7, dtype=_jdtype(dtype))
        tm = tvgg.VGG11(num_classes=7, dtype=dtype, in_shape=(hw, hw, 3))
        x = r.normal(size=(2, hw, hw, 3)).astype(np.float32)
    return jm, tm, x


@functools.lru_cache(maxsize=None)
def jax_variables(kind, hw=32):
    jm, _, x = make(kind, hw=hw)
    # one compiled init: Flax's eager init dispatches op by op (slower)
    init = jax.jit(lambda rng: jm.init(rng, x, train=False))
    return _np(init(jax.random.PRNGKey(hw)))


@functools.lru_cache(maxsize=None)
def jax_logits(kind, hw=32):
    jm, _, x = make(kind, hw=hw)
    return np.asarray(jm.apply(jax_variables(kind, hw), x, train=False))


def load(tm, v):
    tv = from_flax_variables(v, tm)
    tm.load_state_dict({**tv["params"], **tv.get("batch_stats", {})})
    return tm


CASES = [("vit", 32), ("bert", 32), ("vgg", 32), ("vgg", 64)]
IDS = ["vit", "bert", "vgg32", "vgg64"]


@pytest.mark.parametrize("kind,hw", CASES, ids=IDS)
def test_names_and_shapes_equal_the_flax_tree(kind, hw):
    _, tm, _ = make(kind, hw=hw)
    v = jax_variables(kind, hw)
    tv = from_flax_variables(v, tm)
    got = {n: tuple(t.shape) for n, t in tm.state_dict().items()}
    want = {n: tuple(t.shape) for c in tv.values() for n, t in c.items()}
    assert got == want
    # and the Flax shapes are kept leaf for leaf but the conv kernels
    flat = {f"{c}/{n}": t for c, d in tv.items() for n, t in d.items()}
    back = _np(to_flax_variables(tv, tm))
    for c in v:
        for path, leaf in jax.tree_util.tree_leaves_with_path(v[c]):
            name = ".".join(p.key for p in path)
            kept = flat[f"{c}/{name}"]
            if name.endswith("kernel") and leaf.ndim == 4 and (
                    name.startswith("Conv") or name.startswith("patch")):
                assert tuple(kept.shape) == tuple(np.transpose(
                    leaf, (3, 2, 0, 1)).shape)
            else:
                assert tuple(kept.shape) == leaf.shape, name
    jax.tree.map(np.testing.assert_array_equal, back, v)


@pytest.mark.parametrize("kind,hw", CASES, ids=IDS)
def test_f32_eval_logits_match_flax(kind, hw):
    jm, tm, x = make(kind, hw=hw)
    v = jax_variables(kind, hw)
    load(tm, v)
    jy = jax_logits(kind, hw)
    ty = tm(torch.from_numpy(x), train=False)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == jy.shape
    np.testing.assert_allclose(ty.detach().numpy(), jy, atol=F32_ATOL,
                               rtol=0)


@pytest.mark.parametrize("kind", ["vit", "bert", "vgg"])
def test_bf16_eval_logits_match_flax(kind):
    jm, tm, x = make(kind, torch.bfloat16)
    v = jax_variables(kind)
    load(tm, v)
    jy = np.asarray(jm.apply(v, x, train=False))
    ty = tm(torch.from_numpy(x), train=False).detach().numpy()
    assert ty.dtype == np.float32
    scale = np.abs(jax_logits(kind)).max()
    assert np.abs(ty - jy).max() <= BF16_RTOL * scale
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_vgg_flattens_in_nhwc_order():
    """At 64x64 the last map is 2x2: a channel-major flatten permutes
    Dense_0's rows and misses Flax's logits (at 32x32 the map is 1x1 and
    the order does not show)."""
    jm, tm, x = make("vgg", hw=64)
    v = jax_variables("vgg", 64)
    load(tm, v)
    h = torch.from_numpy(x).permute(0, 3, 1, 2)
    i = 0
    for step in tm.plan:
        if step == "M":
            h = F.max_pool2d(h, 2, 2)
            continue
        h = F.relu(getattr(tm, f"BatchNorm_{i}")(getattr(tm, f"Conv_{i}")(h)))
        i += 1
    assert h.shape[2:] == (2, 2)
    nchw = tm.Dense_2(F.relu(tm.Dense_1(F.relu(tm.Dense_0(
        h.reshape(2, -1)))))).detach().numpy()
    jy = np.asarray(jm.apply(v, x))
    assert np.abs(nchw - jy).max() > 1e-3


def test_vit_gelu_is_the_tanh_approximation():
    """Flax's ``nn.gelu`` defaults to the tanh form: the exact erf GELU in
    the ViT MLP moves the logits past the f32 tolerance."""
    jm, tm, x = make("vit")
    v = jax_variables("vit")
    load(tm, v)
    jy = np.asarray(jm.apply(v, x))
    gelu = F.gelu
    try:
        tvit.F.gelu = lambda t, approximate="none": gelu(t)
        exact = tm(torch.from_numpy(x)).detach().numpy()
    finally:
        tvit.F.gelu = gelu
    assert np.abs(exact - jy).max() > 10 * F32_ATOL
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), jy,
                               atol=F32_ATOL, rtol=0)


def test_bert_padding_invariance():
    """Trailing PAD tokens change no row's logits (the JAX package's
    ``test_bert_padding_invariance``, on the port)."""
    _, tm, _ = make("bert")
    load(tm, jax_variables("bert"))
    short = torch.tensor([[5, 8, 9, 0, 0]])
    long = torch.tensor([[5, 8, 9, 0, 0, 0, 0, 0, 0, 0, 0, 0]])
    np.testing.assert_allclose(tm(short).detach().numpy(),
                               tm(long).detach().numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_bert_fully_padded_row_matches_flax(impl, monkeypatch):
    """Every key padded: attention yields zeros (no NaN) on the plain path
    and the flash kernels' plain versions, and the logits equal JAX's."""
    q = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 4, 2, 64)).astype(np.float32))
    dead = torch.zeros(1, 4, dtype=torch.bool)
    out = tattention.dot_product_attention(q, q, q, kv_valid=dead, impl=impl)
    assert torch.equal(out, torch.zeros_like(out))
    jm, tm, _ = make("bert")
    v = jax_variables("bert")
    load(tm, v)
    monkeypatch.setattr(tbert, "dot_product_attention", functools.partial(
        tattention.dot_product_attention, impl=impl))
    ids = np.zeros((2, 8), np.int32)
    np.testing.assert_allclose(tm(torch.from_numpy(ids)).detach().numpy(),
                               np.asarray(jm.apply(v, ids)), atol=F32_ATOL,
                               rtol=0)


def test_bert_flash_path_matches_flax_forward_and_gradients(monkeypatch):
    """BERT with the flash path forced (``impl="cuda"``: on CPU tensors the
    kernels' plain versions) against JAX's XLA attention, with padded keys:
    logits and every parameter's gradient of a weighted logit sum."""
    jm, tm, ids = make("bert")
    v = jax_variables("bert")
    load(tm, v)
    w = np.random.default_rng(4).normal(size=(3, 2)).astype(np.float32)

    def jloss(params):
        return (jm.apply({"params": params}, ids) * w).sum()

    jl, jg = jax.jit(jax.value_and_grad(jloss))(v["params"])
    calls = []

    def flash(*a, **kw):
        calls.append(kw.get("kv_valid") is not None)
        return tattention.dot_product_attention(*a, impl="cuda", **kw)

    monkeypatch.setattr(tbert, "dot_product_attention", flash)
    loss = (tm(torch.from_numpy(ids)) * torch.from_numpy(w)).sum()
    loss.backward()
    assert calls == [True] * tm.depth
    np.testing.assert_allclose(loss.item(), float(jl), atol=F32_ATOL,
                               rtol=0)
    want = from_flax_variables({"params": _np(jg)}, tm)["params"]
    for name, p in tm.named_parameters():
        scale = max(float(want[name].abs().max()), 1e-30)
        err = float((p.grad - want[name]).abs().max())
        assert err <= GRAD_RTOL * scale + GRAD_ATOL, (name, err, scale)


def test_dense_general_and_layer_norm_match_flax():
    r = np.random.default_rng(5)
    x = r.normal(size=(2, 3, 4, 8)).astype(np.float32)
    jd = nn.DenseGeneral(6, axis=(-2, -1))
    v = _np(jd.init(jax.random.PRNGKey(6), x))
    td = layers.DenseGeneral((4, 8), (6,))
    td.kernel.data, td.bias.data = (torch.tensor(v["params"]["kernel"]),
                                    torch.tensor(v["params"]["bias"]))
    np.testing.assert_allclose(td(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jd.apply(v, x)), atol=F32_ATOL,
                               rtol=0)
    # Flax's epsilon 1e-6, not PyTorch's 1e-5: rows of small variance show
    # the difference
    y = (r.normal(size=(4, 16)) * 3e-3).astype(np.float32)
    jy = np.asarray(nn.LayerNorm(dtype=jnp.float32).apply(
        {"params": {"scale": np.ones(16, np.float32),
                    "bias": np.zeros(16, np.float32)}}, y))
    ty = layers.LayerNorm(16)(torch.from_numpy(y)).detach().numpy()
    np.testing.assert_allclose(ty, jy, atol=1e-4, rtol=0)
    torch_eps = F.layer_norm(torch.from_numpy(y), (16,)).numpy()
    assert np.abs(torch_eps - jy).max() > 1e-2


def test_flax_init_of_the_encoders():
    """pos_embed normal(0.02), cls zeros, LayerNorm scale 1 and bias 0,
    Embed a normal of variance 1/width, DenseGeneral lecun_normal over the
    contracted axes; deterministic from the generator."""
    a = layers.flax_init_(tbert.BertTiny(), torch.Generator().manual_seed(0))
    b = layers.flax_init_(tbert.BertTiny(), torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert abs(a.pos_embed.std().item() - 0.02) < 2e-3
    e = a.token_embed.embedding
    assert abs(e.std().item() * np.sqrt(e.shape[1]) - 1.0) < 0.05
    assert e.abs().max().item() > 2.5 / np.sqrt(e.shape[1])  # not truncated
    k = a.BertLayer_0.BertSelfAttention_0.output.kernel  # [H, D, E]
    fan_in = k.shape[0] * k.shape[1]
    assert abs(k.std().item() * np.sqrt(fan_in) - 1.0) < 0.05
    assert torch.all(a.BertLayer_1.LayerNorm_1.scale == 1)
    assert torch.all(a.BertLayer_1.BertSelfAttention_0.query.bias == 0)
    vit = layers.flax_init_(tvit.ViT(depth=1, embed_dim=32, num_heads=2),
                            torch.Generator().manual_seed(1))
    assert torch.all(vit.cls == 0)
    assert abs(vit.pos_embed.std().item() - 0.02) < 4e-3
    assert tuple(vit.EncoderBlock_0.MHSA_0.qkv.kernel.shape) == (32, 3, 2, 16)
