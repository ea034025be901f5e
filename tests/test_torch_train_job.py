"""The port's TrainJob, wire types and flagship benchmark against the JAX
package's.

LeNet on ``tests/test_job.py``'s synthetic MNIST store through
``kubeml_tpu.engine.job.TrainJob`` and ``kubeml_tpu_torch.engine.job.
TrainJob`` from the same initial weights (the port's model initialises
from the Flax tree), with an elastic callback and chaos. Held equal: the
parallelism trace, the rounds of every epoch and the chaos decisions;
epoch losses within 1e-4 relative (f32; differences of ~1e-7 a step grow
over 2 epochs of momentum SGD); validation accuracy within one test
sample."""

import json

import jax
import numpy as np
import optax
import pytest
import torch

from kubeml_tpu.api import types as jtypes
from kubeml_tpu.engine.job import TrainJob as JTrainJob
from kubeml_tpu.models.lenet import LeNet as JLeNet
from kubeml_tpu.runtime.model import KubeModel as JKubeModel
from kubeml_tpu.storage import HistoryStore as JHistoryStore
from kubeml_tpu.storage import ShardStore as JShardStore
from kubeml_tpu_torch.api import types as ttypes
from kubeml_tpu_torch.api.errors import KubeMLError
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.engine.job import TrainJob
from kubeml_tpu_torch.interop.from_flax import from_flax_variables
from kubeml_tpu_torch.models.lenet import LeNet
from kubeml_tpu_torch.runtime.model import KubeModel
from kubeml_tpu_torch.storage import (CheckpointStore, HistoryStore,
                                      ShardStore)
from test_job import MnistDataset, synthetic_mnist

LOSS_RTOL = 1e-4
TEST_SAMPLES = 128


class JaxLeNet(JKubeModel):
    def __init__(self):
        super().__init__(MnistDataset())

    def build(self):
        return JLeNet(num_classes=10)

    def configure_optimizers(self):
        return optax.sgd(self.lr, momentum=0.9)


class TorchMnist(KubeDataset):
    def __init__(self):
        super().__init__("mnist")

    def transform(self, x, y):
        return x.astype(np.float32), y


class TorchLeNet(KubeModel):
    """The port's LeNet, initialised from the Flax LeNet's tree at the JAX
    job's seed, so both jobs start from the same weights."""

    def __init__(self):
        super().__init__(TorchMnist())

    def build(self):
        return LeNet(num_classes=10, in_shape=(28, 28, 1))

    def init(self, generator, sample_x=None):
        v = JLeNet(num_classes=10).init(jax.random.PRNGKey(0),
                                        np.asarray(sample_x, np.float32))
        return from_flax_variables(jax.tree.map(np.asarray, v))

    def configure_optimizers(self, params):
        return torch.optim.SGD(params, lr=self.lr, momentum=0.9)


@pytest.fixture
def stores(tmp_config, tmp_path):
    """The synthetic MNIST set written by the JAX store; the port reads the
    same directory."""
    JShardStore(config=tmp_config).create(
        "mnist", *synthetic_mnist(640, seed=1),
        *synthetic_mnist(TEST_SAMPLES, seed=2))
    return (JShardStore(config=tmp_config),
            ShardStore(root=tmp_config.datasets_dir),
            tmp_path / "torch-history")


def _request(pkg, **opts):
    return pkg.TrainRequest(
        model_type="lenet", batch_size=32, epochs=2, dataset="mnist",
        lr=0.05, function_name="lenet",
        options=pkg.TrainOptions(precision="f32", **opts))


def test_train_job_matches_jax(stores, tmp_config):
    jstore, tstore, thist = stores
    opts = dict(default_parallelism=2, k=2, chaos_prob=0.25)
    runs = {}
    for tag in ("jax", "torch"):
        calls, updates = [], []

        def policy(state, calls=calls):
            calls.append(state.parallelism)
            return 4 if state.parallelism == 2 else state.parallelism

        if tag == "jax":
            job = JTrainJob("job-parity", _request(jtypes, **opts), JaxLeNet(),
                            store=jstore,
                            history_store=JHistoryStore(config=tmp_config),
                            on_epoch_end=policy, on_metrics=updates.append)
        else:
            job = TrainJob("job-parity", _request(ttypes, **opts),
                           TorchLeNet(), store=tstore,
                           history_store=HistoryStore(root=thist),
                           checkpoint_store=CheckpointStore(
                               root=thist.parent / "torch-checkpoints"),
                           on_epoch_end=policy, on_metrics=updates.append,
                           device="cpu")
        runs[tag] = (job.train(), calls, updates, job)
    (jh, jcalls, jup, jjob), (th, tcalls, tup, tjob) = runs["jax"], runs["torch"]
    assert th.parallelism == jh.parallelism == [2, 4]
    assert tcalls == jcalls == [2, 4]
    assert ([len(u.round_seconds) for u in tup]
            == [len(u.round_seconds) for u in jup])
    np.testing.assert_allclose(th.train_loss, jh.train_loss, rtol=LOSS_RTOL)
    assert th.train_loss[-1] < th.train_loss[0]
    assert len(th.accuracy) == len(jh.accuracy) == 2
    for a, b in zip(th.accuracy, jh.accuracy):
        assert abs(a - b) <= 100.0 / TEST_SAMPLES + 1e-6
    np.testing.assert_allclose(th.validation_loss, jh.validation_loss,
                               rtol=1e-3)
    assert len(th.worker_divergence) == len(jh.worker_divergence) == 2
    np.testing.assert_allclose(th.worker_divergence, jh.worker_divergence,
                               rtol=1e-2)
    assert [u.epoch for u in tup] == [u.epoch for u in jup] == [1, 2]
    # the persisted history reads back through the JAX package's store
    saved = HistoryStore(root=thist).get("job-parity")
    assert saved.train_loss == th.train_loss
    assert JHistoryStore(root=thist).get("job-parity").parallelism == [2, 4]
    # the final model is the reference replica, and it serves /infer
    fv = tjob.final_variables
    assert fv["params"]["Conv_0.kernel"].shape == (6, 1, 5, 5)
    x = synthetic_mnist(4, seed=9)[0]
    np.testing.assert_array_equal(tjob.infer(x), np.asarray(jjob.infer(x)))


@pytest.mark.parametrize("opts", [
    {"engine": "spmd"}, {"checkpoint_every": 1}, {"resume": True},
    {"sharded_checkpoints": True}, {"mesh_shape": {"dp": 2}}],
    ids=["spmd", "checkpoint_every", "resume", "sharded", "mesh"])
def test_unported_options_raise(opts, tmp_path):
    """Options whose modules the port once lacked construct a job now:
    checkpoints, resume, the SPMD engine, sharded checkpoints, and a K-AVG
    job's mesh_shape (K-AVG reads only the worker axis, as in JAX)."""
    req = _request(ttypes, **opts)
    req.options.check_ported()
    job = TrainJob("job-x", req, TorchLeNet(),
                   store=ShardStore(root=tmp_path / "d"),
                   history_store=HistoryStore(root=tmp_path / "h"),
                   checkpoint_store=CheckpointStore(root=tmp_path / "c"),
                   device="cpu")
    assert job.request.options == req.options
    # the JAX package reads the same request
    assert jtypes.TrainRequest.from_json(req.to_json()).to_dict() == req.to_dict()


def test_wire_types_read_the_same_json():
    jreq = jtypes.TrainRequest(
        model_type="resnet", batch_size=128, epochs=3, dataset="cifar",
        lr=0.1, function_name="f", job_id="j1",
        options=jtypes.TrainOptions(k=8, chaos_prob=0.1,
                                    mesh_shape={"worker": 2}, tenant="t.a"))
    treq = ttypes.TrainRequest.from_json(jreq.to_json())
    assert treq.to_dict() == jreq.to_dict()
    treq.options.check_ported()  # {"worker": d} is the K-AVG option
    for bad in ({"k": 0}, {"chaos_prob": 2.0}, {"engine": "x"},
                {"priority": True}, {"mesh_shape": {"worker": 0}},
                {"validate_every": -1}, {"tenant": "a b"}):
        with pytest.raises(ValueError):
            jtypes.TrainOptions(**bad)
        with pytest.raises(ValueError):
            ttypes.TrainOptions(**bad)
        with pytest.raises(KubeMLError) as e:
            ttypes.TrainOptions.parse_request(bad)
        assert e.value.status_code == 400
    h = jtypes.History(id="h", train_loss=[1.0], worker_divergence=[float("nan")])
    th = ttypes.History.from_json(h.to_json())
    assert json.loads(th.to_json()) == json.loads(h.to_json())
    assert np.isnan(th.worker_divergence[0])
    up = jtypes.MetricUpdate(job_id="j", round_seconds=[0.5], epoch=2)
    assert ttypes.MetricUpdate.from_json(up.to_json()).to_dict() == up.to_dict()
    st = jtypes.JobState(parallelism=3, elapsed_time=1.5)
    assert ttypes.JobState.from_json(st.to_json()).to_dict() == st.to_dict()


def test_harness_cli_prints_the_bench_row(capsys):
    from kubeml_tpu_torch.benchmarks import harness

    assert harness.main(["--device", "cpu", "--batch", "2", "--k", "1",
                         "--rounds", "1", "--reps", "1"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["metric"] == "resnet18-cifar10-kavg-train-throughput"
    assert row["device"] == "cpu" and row["value"] > 0
    assert row["end_to_end"] > 0 and np.isfinite(row["loss"])
    # 2 x in x out per output position, x3 for the backward: ResNet-18 at
    # 32x32 is 0.556 G multiply-adds a sample forward
    assert row["train_flops_per_sample"] == pytest.approx(3.33e9, rel=1e-2)


def test_harness_raises_without_a_card(monkeypatch):
    from kubeml_tpu_torch.benchmarks import harness

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.main(["--batch", "2", "--k", "1", "--rounds", "1"])
