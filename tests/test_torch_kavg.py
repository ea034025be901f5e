"""The port's K-AVG engine and data path against the JAX package's.

``KAvgTrainer.sync_round`` of both packages from the same weights (Flax
init -> numpy -> ``from_flax_variables``) on the same numpy slabs, on the
CPU, for a small ResNet with BatchNorm and SGD with momentum 0.9.
Tolerances: f32 weights within 1e-4 absolute and round losses within 1e-5
relative (~1e-7 on the CPU: the frameworks sum in other orders); bf16
compute within 2e-2 on weights and 5e-2 relative on losses (bf16 rounds
every conv output to 8 bits of mantissa, and the two frameworks round
different intermediates). Host-side planning, slabs and chaos masks are
held exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeml_tpu.api.errors import MergeError as JMergeError
from kubeml_tpu.data import loader as jloader
from kubeml_tpu.data import sharding as jsharding
from kubeml_tpu.engine import failures as jfailures
from kubeml_tpu.engine.kavg import KAvgTrainer as JTrainer
from kubeml_tpu.models import resnet as jresnet
from kubeml_tpu.runtime.model import KubeModel as JKubeModel
from kubeml_tpu.storage.store import ShardStore as JShardStore
from kubeml_tpu_torch.api.errors import MergeError
from kubeml_tpu_torch.data import loader as tloader
from kubeml_tpu_torch.data import sharding as tsharding
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.engine import failures as tfailures
from kubeml_tpu_torch.engine.kavg import (KAvgTrainer, RoundPrefetcher,
                                          _mean_over_workers)
from kubeml_tpu_torch.interop.from_flax import from_flax_variables
from kubeml_tpu_torch.models import resnet as tresnet
from kubeml_tpu_torch.runtime.model import KubeModel, bind
from kubeml_tpu_torch.storage.store import ShardStore

W_ATOL, LOSS_RTOL = 1e-4, 1e-5
BF16_W_ATOL, BF16_LOSS_RTOL = 2e-2, 5e-2
B, K, HW = 4, 2, 8


class _FakeDataset:
    dataset = "fake"


class JaxNet(JKubeModel):
    def __init__(self, dtype=jnp.float32):
        super().__init__(_FakeDataset())
        self.dtype = dtype

    def build(self):
        return jresnet.ResNet([1, 1], jresnet.BasicBlock, num_classes=4,
                              num_filters=4, dtype=self.dtype)

    def configure_optimizers(self):
        return optax.sgd(self.lr, momentum=0.9)


class TorchNet(KubeModel):
    def __init__(self, dtype=torch.float32):
        super().__init__(KubeDataset("fake"))
        self.dtype = dtype

    def build(self):
        return tresnet.ResNet([1, 1], tresnet.BasicBlock, num_classes=4,
                              num_filters=4, dtype=self.dtype)

    def configure_optimizers(self, params):
        return torch.optim.SGD(params, lr=self.lr, momentum=0.9)


def _slab(n, seed):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, K, B, HW, HW, 3)).astype(np.float32)
    y = r.integers(0, 4, size=(n, K, B)).astype(np.int64)
    return x, y, np.ones((n, K, B), np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class Pair:
    """A JAX trainer and a port trainer holding the same weights."""

    def __init__(self, n, bf16=False):
        self.j = JTrainer(JaxNet(jnp.bfloat16 if bf16 else jnp.float32),
                          precision="bf16" if bf16 else "f32",
                          devices=jax.devices()[:1], donate=False)
        self.t = KAvgTrainer(TorchNet(torch.bfloat16 if bf16
                                      else torch.float32),
                             precision="bf16" if bf16 else "f32",
                             device="cpu")
        x0 = _slab(1, 0)[0][0, 0]
        self.jv = self.j.init_variables(jax.random.PRNGKey(0), x0, n)
        self.tv = self.t.place_reference(
            from_flax_variables(self.j.reference_variables(self.jv)), n)
        self.n = n

    def round(self, x, y, m, worker_mask=None, lr=0.1, r=0):
        self.jv, jl = self.j.sync_round(self.jv, x, y, m,
                                        jax.random.PRNGKey(r), lr=lr,
                                        worker_mask=worker_mask)
        self.tv, tl = self.t.sync_round(self.tv, x, y, m, lr=lr,
                                        worker_mask=worker_mask)
        return float(jl), float(tl)

    def resize(self, new_n):
        self.jv = self.j.resize(self.jv, self.n, new_n)
        self.tv = self.t.resize(self.tv, self.n, new_n)
        self.n = new_n

    def check(self, atol=W_ATOL):
        want = from_flax_variables(self.j.reference_variables(self.jv))
        got = self.t.reference_variables(self.tv)
        for coll, leaves in want.items():
            for k, w in leaves.items():
                np.testing.assert_allclose(got[coll][k], w.numpy(), atol=atol,
                                           rtol=0, err_msg=f"{coll}/{k}")
        # replicas identical after the merge
        for v in (l for c in self.tv.values() for l in c.values()):
            assert torch.equal(v, v[:1].expand_as(v))


def _close(jl, tl, rtol=LOSS_RTOL):
    assert np.isfinite(tl)
    assert abs(tl - jl) <= rtol * abs(jl), (tl, jl)


@pytest.mark.parametrize("n", [1, 3])
def test_sync_rounds_match_jax(n):
    p = Pair(n)
    for r in range(3):
        _close(*p.round(*_slab(n, 10 + r), r=r))
        p.check()


def test_optimizer_state_resets_every_round():
    """Two rounds with momentum: the second round's first step starts from
    a fresh momentum buffer, as optax re-initialised per round."""
    p = Pair(1)
    for r in range(2):
        _close(*p.round(*_slab(1, 20 + r), r=r))
    p.check()
    # an optimizer kept across rounds lands elsewhere
    t = KAvgTrainer(TorchNet(), precision="f32", device="cpu")
    module = t.module
    p0 = Pair(1)
    bind(module, t._replica0(p0.tv))
    t.model.lr = 0.1
    opt = t.model.configure_optimizers(list(module.parameters()))
    for r in range(2):
        x, y, _ = _slab(1, 20 + r)
        for s in range(K):
            loss = torch.nn.functional.cross_entropy(
                module(torch.from_numpy(x[0, s]), train=True),
                torch.from_numpy(y[0, s]))
            opt.zero_grad()
            loss.backward()
            opt.step()
    kept = module.Dense_0.kernel.detach().numpy()
    reset = p.t.reference_variables(p.tv)["params"]["Dense_0.kernel"]
    assert np.abs(kept - reset).max() > 10 * W_ATOL


def test_worker_mask_drops_one_worker():
    p = Pair(3)
    _close(*p.round(*_slab(3, 30), worker_mask=np.array([1, 0, 1],
                                                         np.float32)))
    p.check()
    # the average of the two healthy workers, not three
    solo = [Pair(1) for _ in range(3)]
    x, y, m = _slab(3, 30)
    for w, s in enumerate(solo):
        s.t.sync_round(s.tv, x[w:w + 1], y[w:w + 1], m[w:w + 1], lr=0.1)
    got = p.t.reference_variables(p.tv)["params"]["Dense_0.kernel"]
    want = (solo[0].t.reference_variables(solo[0].tv)["params"]["Dense_0.kernel"]
            + solo[2].t.reference_variables(solo[2].tv)["params"][
                "Dense_0.kernel"]) / 2
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_fully_padded_worker_and_empty_step():
    p = Pair(3)
    x, y, m = _slab(3, 40)
    m[2] = 0.0          # worker 2 holds no data this round
    m[0, 1] = 0.0       # worker 0's second step is all padding
    m[1, 0, 2:] = 0.0   # worker 1's first batch is half padding
    _close(*p.round(x, y, m))
    p.check()


def test_round_without_participants_keeps_weights():
    p = Pair(3)
    x, y, m = _slab(3, 50)
    m[1] = 0.0
    before = p.t.reference_variables(p.tv)
    jl, tl = p.round(x, y, m, worker_mask=np.array([0, 1, 0], np.float32))
    assert np.isnan(jl) and np.isnan(tl)
    after = p.t.reference_variables(p.tv)
    for k, v in before["params"].items():
        np.testing.assert_array_equal(after["params"][k], v)
    p.check()


def test_resize_three_to_two():
    p = Pair(3)
    _close(*p.round(*_slab(3, 60)))
    p.resize(2)
    assert all(v.shape[0] == 2 for c in p.tv.values() for v in c.values())
    _close(*p.round(*_slab(2, 61), r=1))
    p.check()


def test_bf16_rounds_match_jax():
    p = Pair(3, bf16=True)
    for r in range(2):
        _close(*p.round(*_slab(3, 70 + r), r=r), rtol=BF16_LOSS_RTOL)
    p.check(atol=BF16_W_ATOL)


def test_no_healthy_worker_raises_merge_error():
    p = Pair(3)
    x, y, m = _slab(3, 80)
    dead = np.zeros(3, np.float32)
    with pytest.raises(JMergeError):
        p.j.sync_round(p.jv, x, y, m, jax.random.PRNGKey(0), lr=0.1,
                       worker_mask=dead)
    with pytest.raises(MergeError, match="no healthy workers"):
        p.t.sync_round(p.tv, x, y, m, lr=0.1, worker_mask=dead)


def test_evaluate_and_infer_match_jax():
    p = Pair(2)
    _close(*p.round(*_slab(2, 90)))
    x, y, m = _slab(2, 91)
    m[1, 1, 1:] = 0.0
    ja, jl = p.j.evaluate(p.jv, x, y, m)
    ta, tl = p.t.evaluate(p.tv, x, y, m)
    assert ta == pytest.approx(ja, abs=1e-6)
    assert tl == pytest.approx(jl, rel=LOSS_RTOL)
    np.testing.assert_array_equal(p.t.infer(p.tv, x[0, 0]),
                                  np.asarray(p.j.infer(p.jv, x[0, 0])))


def test_mean_over_workers_weights_and_rounds_integers():
    tree = {"params": {"w": torch.tensor([[1.0, 2.0], [3.0, 4.0],
                                          [100.0, 100.0]])},
            "batch_stats": {"n": torch.tensor([1, 2, 9], dtype=torch.int32)}}
    out = _mean_over_workers(tree, np.array([1, 1, 0], np.float32))
    np.testing.assert_array_equal(out["params"]["w"].numpy(), [2.0, 3.0])
    assert out["batch_stats"]["n"].dtype == torch.int32
    assert int(out["batch_stats"]["n"]) == 2  # round(1.5) to even


def test_staging_casts_f32_to_bf16_and_keeps_uint8():
    t = KAvgTrainer(TorchNet(), precision="bf16", device="cpu")
    x, y, m = _slab(2, 95)
    sx, sy, sm = t.stage_round(x, y, m, 2)
    assert sx.dtype == torch.bfloat16 and sy.dtype == torch.int64
    assert sm.device.type == "cpu"
    ux = (np.abs(x) * 50).astype(np.uint8)
    assert t.stage_round(ux, y, m, 2)[0].dtype == torch.uint8
    rounds = [type("R", (), {"x": x, "y": y, "mask": m})() for _ in range(3)]
    got = list(RoundPrefetcher(t, rounds, 2))
    assert [rb for rb, _ in got] == rounds
    assert all(s[0].dtype == torch.bfloat16 for _, s in got)


def test_trainer_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KAvgTrainer(TorchNet())


# --- data path -------------------------------------------------------------

@pytest.mark.parametrize("num_docs,n,b,k,samples", [
    (10, 3, 16, 1, None), (10, 3, 16, -1, None), (7, 4, 48, 2, 400),
    (40, 4, 32, 8, 2530), (3, 5, 64, 1, 150), (16, 2, 100, 3, None)])
def test_plans_equal_jax(num_docs, n, b, k, samples):
    want = jsharding.plan_epoch(num_docs, n, b, k, num_samples=samples)
    got = tsharding.plan_epoch(num_docs, n, b, k, num_samples=samples)
    assert got.__dict__ == want.__dict__
    for r in range(got.num_rounds):
        np.testing.assert_array_equal(got.data_bearing(r),
                                      want.data_bearing(r))
    we = jsharding.plan_eval(num_docs, n, b, num_samples=samples,
                             max_steps_per_round=3)
    ge = tsharding.plan_eval(num_docs, n, b, num_samples=samples,
                             max_steps_per_round=3)
    assert ge.__dict__ == we.__dict__


def test_store_reads_jax_dataset_and_slabs_equal(tmp_path):
    r = np.random.default_rng(0)
    xtr = r.integers(0, 256, size=(700, 4, 4, 3)).astype(np.uint8)
    ytr = r.integers(0, 10, size=700).astype(np.int64)
    xte, yte = xtr[:130], ytr[:130]
    JShardStore(root=tmp_path).create("ds", xtr, ytr, xte, yte)
    jh = JShardStore(root=tmp_path).get("ds")
    th = ShardStore(root=tmp_path).get("ds")
    assert th.summary().to_dict() == jh.summary().to_dict()
    assert th.num_subsets("train") == jh.num_subsets("train") == 11

    def tf(x, y):
        return x.astype(np.float32) / 255.0, y

    for k in (2, -1):
        jp = jsharding.plan_epoch(jh.num_subsets("train"), 3, 32, k,
                                  num_samples=700)
        tp = tsharding.plan_epoch(th.num_subsets("train"), 3, 32, k,
                                  num_samples=700)
        jr = list(jloader.RoundLoader(jh, "train", jp, transform=tf))
        tr = list(tloader.RoundLoader(th, "train", tp, transform=tf))
        assert len(tr) == len(jr) == tp.num_rounds
        for a, b in zip(tr, jr):
            assert a.round_index == b.round_index
            for f in ("x", "y", "mask"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
                assert getattr(a, f).dtype == getattr(b, f).dtype
    jv = list(jloader.validation_loader(jh, 2, 16, max_steps_per_round=2))
    tv = list(tloader.validation_loader(th, 2, 16, max_steps_per_round=2))
    assert len(tv) == len(jv)
    for a, b in zip(tv, jv):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.mask, b.mask)
    # the port writes the same format: the JAX store reads it back
    ShardStore(root=tmp_path).create("ds2", xte, yte, xte, yte)
    np.testing.assert_array_equal(
        JShardStore(root=tmp_path).get("ds2").raw("train"), xte)


def test_failure_injector_and_health_identical():
    sched = {1: [0], 4: [2, 3]}
    j = jfailures.FailureInjector(prob=0.3, schedule=sched, seed=7)
    t = tfailures.FailureInjector(prob=0.3, schedule=sched, seed=7)
    jh, th = jfailures.WorkerHealth(2), tfailures.WorkerHealth(2)
    for n in (4, 4, 4, 3, 4, 2, 4, 4):
        a, b = t.mask(n), j.mask(n)
        np.testing.assert_array_equal(a, b)
        assert th.update(a) == jh.update(b)
        assert th.suggest_parallelism(n) == jh.suggest_parallelism(n)
    jz = jfailures.FailureInjector(prob=1.0, seed=3)
    tz = tfailures.FailureInjector(prob=1.0, seed=3)
    for _ in range(5):  # keep_one_alive draws from the same stream
        np.testing.assert_array_equal(tz.mask(5), jz.mask(5))
