"""The port's conv models against the JAX package's Flax models.

Same inputs (numpy seeds) and the same weights (Flax -> numpy ->
``from_flax_variables``) through ``kubeml_tpu.models.{resnet,lenet}`` and
``kubeml_tpu_torch.models.{resnet,lenet}`` on the CPU. Tolerances: f32
logits and updated BatchNorm statistics within 1e-5 absolute (the two
frameworks sum in other orders; ~5e-7 on the CPU); bf16 logits within 5e-2
of the f32 logit scale (bf16 rounds each conv's output to 8 bits of
mantissa, 2^-8 = 3.9e-3, over 2-3 layers)."""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
import flax.linen as nn

from kubeml_tpu.models import lenet as jlenet
from kubeml_tpu.models import resnet as jresnet
from kubeml_tpu_torch.interop.from_flax import from_flax_variables
from kubeml_tpu_torch.models import layers
from kubeml_tpu_torch.models import lenet as tlenet
from kubeml_tpu_torch.models import resnet as tresnet

F32_ATOL = 1e-5
BF16_RTOL = 5e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, variables):
    tv = from_flax_variables(_np(variables))
    module.load_state_dict({**tv["params"], **tv.get("batch_stats", {})})
    return module


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(block, cifar_stem, dtype=jnp.float32):
    jb = {"basic": jresnet.BasicBlock, "bottleneck": jresnet.Bottleneck}[block]
    tb = {"basic": tresnet.BasicBlock, "bottleneck": tresnet.Bottleneck}[block]
    tdtype = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    jm = jresnet.ResNet([1, 1], jb, num_classes=5, num_filters=8,
                        cifar_stem=cifar_stem, dtype=dtype)
    tm = tresnet.ResNet([1, 1], tb, num_classes=5, num_filters=8,
                        cifar_stem=cifar_stem, dtype=tdtype)
    return jm, tm


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("cifar_stem", [True, False], ids=["cifar", "imagenet"])
@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_resnet_matches_flax(block, cifar_stem, train):
    jm, tm = _pair(block, cifar_stem)
    x = _x((2, 16, 16, 3))
    v = jm.init(jax.random.PRNGKey(1), x)
    _load(tm, v)
    # names and shapes map one to one (no num_batches_tracked)
    tv = from_flax_variables(_np(v))
    assert sorted(tv["params"]) == sorted(dict(tm.named_parameters()))
    assert sorted(tv["batch_stats"]) == sorted(dict(tm.named_buffers()))
    if train:
        jy, jstate = jm.apply(v, x, train=True, mutable=["batch_stats"])
    else:
        jy = jm.apply(v, x, train=False)
    ty = tm(torch.from_numpy(x), train=train)
    assert ty.dtype == torch.float32 and ty.shape == (2, 5)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=F32_ATOL, rtol=0)
    if train:
        want = from_flax_variables(_np(dict(jstate)))["batch_stats"]
        got = dict(tm.named_buffers())
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                       atol=F32_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_bf16_matches_flax(train):
    jm, tm = _pair("basic", True, jnp.bfloat16)
    x = _x((2, 16, 16, 3), seed=3)
    v = jm.init(jax.random.PRNGKey(2), x)
    _load(tm, v)
    if train:
        jy, _ = jm.apply(v, x, train=True, mutable=["batch_stats"])
    else:
        jy = jm.apply(v, x, train=False)
    ty = tm(torch.from_numpy(x), train=train).detach().numpy()
    jy = np.asarray(jy)
    assert ty.dtype == np.float32
    assert np.abs(ty - jy).max() <= BF16_RTOL * np.abs(jy).max()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_lenet_matches_flax(train):
    jm = jlenet.LeNet(num_classes=10)
    tm = tlenet.LeNet(num_classes=10, in_shape=(28, 28, 1))
    x = _x((3, 28, 28, 1), seed=4)
    v = jm.init(jax.random.PRNGKey(3), x)
    _load(tm, v)
    jy = jm.apply(v, x, train=train)
    ty = tm(torch.from_numpy(x), train=train).detach().numpy()
    np.testing.assert_allclose(ty, np.asarray(jy), atol=F32_ATOL, rtol=0)


def test_lenet_flatten_follows_nhwc_order():
    """A channel-major (NCHW) flatten permutes Dense_0's rows: the logits
    then miss Flax's."""
    jm = jlenet.LeNet(num_classes=10)
    tm = tlenet.LeNet(num_classes=10)
    x = _x((2, 28, 28, 1), seed=5)
    v = jm.init(jax.random.PRNGKey(4), x)
    _load(tm, v)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    h = F.max_pool2d(F.relu(tm.Conv_0(xt)), 2, 2)
    h = F.max_pool2d(F.relu(tm.Conv_1(h)), 2, 2)
    nchw = tm.Dense_2(F.relu(tm.Dense_1(F.relu(tm.Dense_0(
        h.reshape(2, -1)))))).detach().numpy()
    jy = np.asarray(jm.apply(v, x))
    assert np.abs(nchw - jy).max() > 1e-3
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), jy,
                               atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("kernel,stride,size", [(3, 2, 16), (7, 2, 16),
                                                (1, 2, 16), (3, 1, 16),
                                                (3, 2, 15)])
def test_conv_same_padding_matches_flax(kernel, stride, size):
    """XLA's SAME pads (0, 1) for a stride-2 3x3 conv on an even input;
    PyTorch's symmetric padding=1 shifts every output by one pixel."""
    jc = nn.Conv(4, (kernel, kernel), strides=(stride, stride),
                 padding="SAME", use_bias=False)
    x = _x((2, size, size, 3), seed=6)
    v = jc.init(jax.random.PRNGKey(5), x)
    tc = layers.Conv(3, 4, (kernel, kernel), stride, use_bias=False)
    tc.kernel.data = from_flax_variables(_np(v))["params"]["kernel"]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ty = tc(xt).permute(0, 2, 3, 1).detach().numpy()
    jy = np.asarray(jc.apply(v, x))
    np.testing.assert_allclose(ty, jy, atol=F32_ATOL, rtol=0)
    if (kernel, stride, size) == (3, 2, 16):
        assert layers.same_pads(16, 3, 2) == (0, 1)
        sym = F.conv2d(xt, tc.kernel, None, 2, 1).permute(0, 2, 3, 1)
        assert np.abs(sym.detach().numpy() - jy).max() > 1e-2


def test_imagenet_stem_max_pool_pads_with_minus_inf():
    x = -np.abs(_x((2, 8, 8, 3), seed=7)) - 1.0  # all negative
    jy = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                padding="SAME"))
    ty = layers.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2)
    np.testing.assert_array_equal(ty.permute(0, 2, 3, 1).numpy(), jy)
    # zero padding would lift the border windows' maxima to 0
    zero = F.max_pool2d(F.pad(torch.from_numpy(x).permute(0, 3, 1, 2),
                              (0, 1, 0, 1)), 3, 2)
    assert (zero.permute(0, 2, 3, 1).numpy() != jy).any()


def test_batchnorm_running_variance_is_biased():
    """Flax moves the running variance toward the biased batch variance
    with momentum 0.9; PyTorch's own BatchNorm uses the unbiased one."""
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.9)
    x = _x((4, 3, 3, 5), seed=8) * 2.0 + 1.0
    v = jbn.init(jax.random.PRNGKey(6), x)
    jy, state = jbn.apply(v, x, mutable=["batch_stats"])
    tbn = layers.BatchNorm(5)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ty = tbn(xt, train=True)
    np.testing.assert_allclose(ty.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(jy), atol=F32_ATOL, rtol=0)
    want_var = np.asarray(state["batch_stats"]["var"])
    want_mean = np.asarray(state["batch_stats"]["mean"])
    np.testing.assert_allclose(tbn.var.numpy(), want_var, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(tbn.mean.numpy(), want_mean, atol=F32_ATOL,
                               rtol=0)
    # torch.nn.BatchNorm2d(momentum=0.1) lands on the unbiased variance
    ref = torch.nn.BatchNorm2d(5, momentum=0.1, eps=1e-5)
    ref(xt)
    assert np.abs(ref.running_var.numpy() - want_var).max() > 1e-3
    np.testing.assert_allclose(ref.running_mean.numpy(), want_mean,
                               atol=F32_ATOL, rtol=0)


def test_from_flax_variables_layouts():
    jm = jresnet.ResNet([1], jresnet.BasicBlock, num_classes=3,
                        num_filters=4)
    v = _np(jm.init(jax.random.PRNGKey(7), _x((1, 8, 8, 3))))
    tv = from_flax_variables(v)
    k = v["params"]["Conv_0"]["kernel"]  # HWIO
    np.testing.assert_array_equal(tv["params"]["Conv_0.kernel"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tv["params"]["Dense_0.kernel"].numpy(),
                                  v["params"]["Dense_0"]["kernel"])
    np.testing.assert_array_equal(
        tv["batch_stats"]["BasicBlock_0.BatchNorm_1.var"].numpy(),
        v["batch_stats"]["BasicBlock_0"]["BatchNorm_1"]["var"])


def test_flax_init_statistics():
    """Kernels lecun_normal (std sqrt(1/fan_in), truncated at 2 std),
    biases zero, BatchNorm scales and variances one; deterministic from
    the generator."""
    a = layers.flax_init_(tresnet.ResNet18(), torch.Generator().manual_seed(0))
    b = layers.flax_init_(tresnet.ResNet18(), torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    k = a.BasicBlock_2.Conv_1.kernel
    fan_in = k[0].numel()
    assert abs(k.std().item() * np.sqrt(fan_in) - 1.0) < 0.05
    assert k.abs().max().item() <= 2 / 0.87962566103423978 / np.sqrt(fan_in)
    assert torch.all(a.Dense_0.bias == 0)
    assert torch.all(a.BatchNorm_0.scale == 1)
    assert torch.all(a.BasicBlock_0.BatchNorm_0.var == 1)
    assert not any("num_batches" in n for n, _ in a.named_buffers())


# --- K-AVG rounds of the encoders against the JAX KAvgTrainer ---------------
# One round of N 2 workers, K 2 steps of SGD with momentum 0.9, dropout 0
# (the masks of JAX's threefry bits cannot be reproduced; the dropout rules
# are held in tests/test_torch_dropout.py), f32: the merged weights within
# 1e-4 absolute and the loss within 1e-5 relative, the tolerances of
# tests/test_torch_kavg.py (~1e-7 observed: the frameworks sum in other
# orders).
ROUND_W_ATOL, ROUND_LOSS_RTOL = 1e-4, 1e-5


def _encoder_pair(kind):
    from kubeml_tpu.models import bert as jbert, vit as jvit
    from kubeml_tpu_torch.models import bert as tbert, vit as tvit

    r = np.random.default_rng({"vit": 10, "bert": 11}[kind])
    if kind == "vit":
        kw = dict(num_classes=4, patch_size=4, embed_dim=32, depth=2,
                  num_heads=2)
        pair = jvit.ViT(**kw), tvit.ViT(**kw, in_shape=(16, 16, 3))
        x = r.normal(size=(2, 2, 4, 16, 16, 3)).astype(np.float32)
    else:
        kw = dict(num_classes=4, vocab_size=100, max_len=16, embed_dim=32,
                  depth=2, num_heads=2, mlp_dim=64, dropout=0.0)
        pair = jbert.BertClassifier(**kw), tbert.BertClassifier(**kw)
        x = r.integers(1, 100, size=(2, 2, 4, 16)).astype(np.int32)
        x[:, :, 1, 9:] = 0  # trailing padding
    y = r.integers(0, 4, size=(2, 2, 4)).astype(np.int64)
    return pair, x, y, np.ones((2, 2, 4), np.float32)


@pytest.mark.parametrize("kind", ["vit", "bert"])
def test_encoder_sync_round_matches_jax(kind):
    import optax

    from kubeml_tpu.engine.kavg import KAvgTrainer as JTrainer
    from kubeml_tpu.runtime.model import KubeModel as JKubeModel
    from kubeml_tpu_torch.data.dataset import KubeDataset
    from kubeml_tpu_torch.engine.kavg import KAvgTrainer
    from kubeml_tpu_torch.runtime.model import KubeModel

    (jmod, tmod), x, y, m = _encoder_pair(kind)

    class _Data:
        dataset = "synthetic"

    class JNet(JKubeModel):
        def __init__(self):
            super().__init__(_Data())

        def build(self):
            return jmod

        def configure_optimizers(self):
            return optax.sgd(self.lr, momentum=0.9)

    class TNet(KubeModel):
        def __init__(self):
            super().__init__(KubeDataset("synthetic"))

        def build(self):
            return tmod

        def configure_optimizers(self, params):
            return torch.optim.SGD(params, lr=self.lr, momentum=0.9)

    j = JTrainer(JNet(), precision="f32", devices=jax.devices()[:1],
                 donate=False)
    t = KAvgTrainer(TNet(), precision="f32", device="cpu")
    jv = j.init_variables(jax.random.PRNGKey(0), x[0, 0], 2)
    tv = t.place_reference(from_flax_variables(j.reference_variables(jv),
                                               tmod), 2)
    jv, jl = j.sync_round(jv, x, y, m, jax.random.PRNGKey(1), lr=0.05)
    tv, tl = t.sync_round(tv, x, y, m, lr=0.05, rng=1)
    assert abs(float(tl) - float(jl)) <= ROUND_LOSS_RTOL * abs(float(jl))
    want = from_flax_variables(j.reference_variables(jv), tmod)["params"]
    got = t.reference_variables(tv)["params"]
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w.numpy(), atol=ROUND_W_ATOL,
                                   rtol=0, err_msg=k)
