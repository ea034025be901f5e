"""Dropout on explicit generators, on the CPU: the Flax ``nn.Dropout``
rule, the K-AVG round's seeds (``KAvgTrainer.sync_round(rng=...)``), a
``TrainJob`` resumed with dropout on, and GPT dropout under remat.

JAX's threefry bits cannot be reproduced, so no mask is held to JAX's;
every rule that can be held is: the keep rate and ``1/(1-p)`` scaling,
the identity at eval, the same seed drawing the same masks, workers and
steps drawing different ones, a skipped worker drawing nothing, a resumed
job equal to the uninterrupted one bit for bit, and remat's recompute
drawing the forward's masks (its gradients equal to no-remat's bit for
bit: the same f32 operations on the CPU)."""

import numpy as np
import pytest
import torch

from kubeml_tpu_torch.api.config import Config
from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.engine.job import TrainJob
from kubeml_tpu_torch.engine.kavg import KAvgTrainer
from kubeml_tpu_torch.models import layers
from kubeml_tpu_torch.models.gpt import GPTTiny
from kubeml_tpu_torch.models.vgg import VGG
from kubeml_tpu_torch.models.vit import ViT
from kubeml_tpu_torch.parallel.trainer import SPMDTrainer, adamw
from kubeml_tpu_torch.runtime.model import KubeModel
from kubeml_tpu_torch.storage import HistoryStore, ShardStore
from kubeml_tpu_torch.storage.checkpoint import CheckpointStore
from test_job import synthetic_mnist


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_rate_and_scaling(rate, dtype):
    x = torch.full((200_000,), 3.0, dtype=dtype)
    y = layers.Dropout(rate)(x, True, layers.make_generator(0, "cpu"))
    kept = y != 0
    assert y.dtype == dtype
    # the kept fraction within 5 binomial standard deviations of 1 - rate
    sd = np.sqrt(rate * (1 - rate) / x.numel())
    assert abs(kept.float().mean().item() - (1 - rate)) < 5 * sd
    assert torch.equal(y[kept], (x / (1 - rate))[kept])


def test_dropout_identity_at_eval_and_rate_zero():
    x = torch.randn(4, 8)
    assert layers.Dropout(0.5)(x, False) is x
    assert layers.Dropout(0.0)(x, True) is x
    assert torch.equal(layers.Dropout(1.0)(x, True), torch.zeros_like(x))
    with pytest.raises(ValueError, match="needs a generator"):
        layers.Dropout(0.5)(x, True)


def test_fold_in_and_seed_of():
    a = layers.fold_in(7, 1)
    assert a == layers.fold_in(7, 1) and 0 <= a < 2 ** 63
    assert len({layers.fold_in(s, d) for s in range(20)
                for d in range(20)}) == 400
    assert layers.seed_of(5) == 5
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    assert layers.seed_of(g1) == layers.seed_of(g2)
    assert layers.seed_of(g1) != layers.seed_of(torch.Generator()
                                                 .manual_seed(4))


class Synthetic(KubeModel):
    def __init__(self, module):
        super().__init__(KubeDataset("synthetic"))
        self._build = module

    def build(self):
        return self._build

    def configure_optimizers(self, params):
        return torch.optim.SGD(params, lr=self.lr, momentum=0.9)


def tiny_vit(dropout):
    return ViT(num_classes=4, patch_size=4, embed_dim=16, depth=1,
               num_heads=1, dropout=dropout, in_shape=(8, 8, 3))


def slab(n, k=2, b=4, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, k, b, 8, 8, 3)).astype(np.float32),
            r.integers(0, 4, size=(n, k, b)).astype(np.int64),
            np.ones((n, k, b), np.float32))


def one_round(rng, n=3, worker_mask=None, dropout=0.3):
    torch.manual_seed(0)
    t = KAvgTrainer(Synthetic(tiny_vit(dropout)), precision="f32",
                    device="cpu")
    v = t.init_variables(0, None, n)
    v, loss = t.sync_round(v, *slab(n), lr=0.1, rng=rng,
                           worker_mask=worker_mask)
    return t.reference_variables(v)["params"], float(loss)


def test_round_is_repeatable_and_seed_sensitive():
    a, la = one_round(11)
    b, lb = one_round(11)
    c, lc = one_round(12)
    assert la == lb
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert la != lc
    assert any(not np.array_equal(a[k], c[k]) for k in a)
    # a generator round seeds from one draw of it
    g = layers.seed_of(torch.Generator().manual_seed(9))
    d, _ = one_round(torch.Generator().manual_seed(9))
    e, _ = one_round(g)
    for k in d:
        np.testing.assert_array_equal(d[k], e[k], err_msg=k)


def test_workers_and_steps_draw_their_own_masks(monkeypatch):
    """Each (worker, step) draws from a generator seeded
    ``fold_in(fold_in(seed, w), s)``: all seeds differ; a worker that does
    not take part draws nothing, and the others keep their seeds."""
    seen = []
    forward = layers.Dropout.forward

    def spy(self, x, train=False, rng=None):
        if train and self.rate > 0 and rng is not None:
            seen.append(rng.initial_seed())
        return forward(self, x, train, rng)

    monkeypatch.setattr(layers.Dropout, "forward", spy)
    one_round(5)
    want = [layers.fold_in(layers.fold_in(5, w), s)
            for w in range(3) for s in range(2)]
    # two dropout sites a block, both on the step's generator
    assert seen == [s for s in want for _ in range(2)]
    assert len(set(want)) == 6
    seen.clear()
    one_round(5, worker_mask=np.array([1, 0, 1], np.float32))
    assert seen == [s for s in want if s not in want[2:4] for _ in range(2)]
    seen.clear()
    one_round(None, dropout=0.0)
    assert seen == []
    with pytest.raises(ValueError, match="needs a generator"):
        one_round(None)


class Mnist(KubeDataset):
    def __init__(self):
        super().__init__("mnist")

    def transform(self, x, y):
        return x.astype(np.float32), y


class DropVGG(KubeModel):
    """A two-conv VGG with dropout 0.5 on MNIST shapes."""

    def __init__(self):
        super().__init__(Mnist())

    def build(self):
        return VGG(plan=(8, "M", 16, "M"), num_classes=10,
                   classifier_width=32, dropout=0.5, in_shape=(28, 28, 1))

    def configure_optimizers(self, params):
        return torch.optim.SGD(params, lr=self.lr, momentum=0.9)


@pytest.fixture
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_resumed_job_with_dropout_equals_the_uninterrupted_run(
        tmp_path, monkeypatch, one_torch_thread):
    """Two epochs, then a resumed job for four, against four uninterrupted
    epochs, with dropout on: the same losses and weights, bit for bit."""
    cfg = Config(data_root=tmp_path)
    cfg.ensure_dirs()
    ShardStore(root=cfg.datasets_dir).create(
        "mnist", *synthetic_mnist(256, seed=1), *synthetic_mnist(64, seed=2))
    draws = []
    forward = layers.Dropout.forward
    monkeypatch.setattr(layers.Dropout, "forward",
                        lambda self, x, train=False, rng=None: (
                            draws.append(rng is not None and train)
                            or forward(self, x, train, rng)))

    def run(job_id, epochs, resume=False):
        req = TrainRequest(
            model_type="vgg", batch_size=32, epochs=epochs, dataset="mnist",
            lr=0.05, function_name="vggfn",
            options=TrainOptions(precision="f32", default_parallelism=2,
                                 static_parallelism=True, k=2,
                                 checkpoint_every=1, validate_every=0,
                                 resume=resume))
        j = TrainJob(job_id, req, DropVGG(),
                     store=ShardStore(root=cfg.datasets_dir),
                     history_store=HistoryStore(root=cfg.history_path),
                     checkpoint_store=CheckpointStore(config=cfg),
                     device="cpu", seed=3)
        return j, j.train()

    full, full_hist = run("full", 4)
    assert any(draws)
    run("cut", 2)
    resumed, hist = run("cut", 4, resume=True)
    assert hist.train_loss == full_hist.train_loss
    for c in full.final_variables:
        for k, v in full.final_variables[c].items():
            np.testing.assert_array_equal(resumed.final_variables[c][k], v,
                                          err_msg=k)


def gpt_grads(remat, dropout=0.1, rng=7):
    m = GPTTiny(vocab_size=64, max_len=16, seed=0, device="cpu")
    if remat or dropout:
        m = type(m)(vocab_size=64, max_len=16, embed_dim=64, depth=2,
                    num_heads=4, remat=remat, dropout=dropout, seed=0,
                    device="cpu")
    trainer = SPMDTrainer(m, optimizer=adamw(), precision="f32")
    tokens = np.random.default_rng(0).integers(1, 64, size=(2, 16))
    trainer.init(tokens)
    loss = float(trainer.train_step(tokens, rng))
    return loss, {n: p.grad.clone() for n, p in m.named_parameters()}


def test_gpt_remat_and_no_remat_gradients_agree_with_dropout():
    """torch.utils.checkpoint replays the global RNG, not a generator: the
    blocks draw from generators seeded per (step, layer) inside the block,
    so the recompute draws the forward's masks."""
    l0, g0 = gpt_grads(remat=False)
    l1, g1 = gpt_grads(remat=True)
    assert l0 == l1
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    # the masks matter: another seed, or no dropout, moves the gradients
    l2, g2 = gpt_grads(remat=True, rng=8)
    l3, _ = gpt_grads(remat=False, dropout=0.0)
    assert l2 != l1 and l3 != l1
    assert any(not torch.equal(g1[n], g2[n]) for n in g1)
    with pytest.raises(ValueError, match="needs rng"):
        gpt_grads(remat=False, rng=None)
