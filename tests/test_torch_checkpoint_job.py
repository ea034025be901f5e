"""The port's ``TrainJob`` checkpoints, on the CPU: the job tests of
``tests/test_checkpoint.py`` (:119-258) on the port, resume against an
uninterrupted run, the preemption yield checkpoint, and a LeNet ``final``
served across the packages.

LeNet on ``tests/test_job.py``'s synthetic MNIST set. A resumed run is held
EQUAL to the uninterrupted one (the same f32 operations on the CPU, and
the restored weights are the saved ones bit for bit); the cross-package
``infer`` outputs are class ids, held equal."""

import shutil

import numpy as np
import pytest
import torch

from kubeml_tpu_torch.api.config import Config
from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.engine.job import TrainJob
from kubeml_tpu_torch.engine.kavg import KAvgTrainer
from kubeml_tpu_torch.functions.registry import FunctionRegistry
from kubeml_tpu_torch.interop.from_flax import from_flax_variables
from kubeml_tpu_torch.models.lenet import LeNet
from kubeml_tpu_torch.ps.parameter_server import ParameterServer
from kubeml_tpu_torch.runtime.model import KubeModel
from kubeml_tpu_torch.storage import HistoryStore, ShardStore
from kubeml_tpu_torch.storage.checkpoint import FINAL_TAG, CheckpointStore
from test_job import synthetic_mnist

PORT_LENET_FN = """
import numpy as np
import torch
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.lenet import LeNet
from kubeml_tpu_torch.runtime.model import KubeModel

class Ds(KubeDataset):
    def __init__(self):
        super().__init__("mnist")
    def transform(self, x, y):
        return x.astype(np.float32), y

class Model(KubeModel):
    def __init__(self):
        super().__init__(Ds())
    def build(self):
        return LeNet(num_classes=10)
    def configure_optimizers(self, params):
        return torch.optim.SGD(params, lr=self.lr, momentum=0.9)
"""

JAX_LENET_FN = """
import numpy as np, optax
from kubeml_tpu.data.dataset import KubeDataset
from kubeml_tpu.models.lenet import LeNet
from kubeml_tpu.runtime.model import KubeModel

class Ds(KubeDataset):
    def __init__(self):
        super().__init__("mnist")
    def transform(self, x, y):
        return x.astype(np.float32), y

class Model(KubeModel):
    def __init__(self):
        super().__init__(Ds())
    def build(self):
        return LeNet(num_classes=10)
    def configure_optimizers(self):
        return optax.sgd(self.lr, momentum=0.9)
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Mnist(KubeDataset):
    def __init__(self):
        super().__init__("mnist")

    def transform(self, x, y):
        return x.astype(np.float32), y


class PortLeNet(KubeModel):
    def __init__(self):
        super().__init__(Mnist())

    def build(self):
        return LeNet(num_classes=10)

    def configure_optimizers(self, params):
        return torch.optim.SGD(params, lr=self.lr, momentum=0.9)


@pytest.fixture
def cfg(tmp_path):
    """The port's data root, holding the synthetic MNIST set."""
    c = Config(data_root=tmp_path / "port")
    c.ensure_dirs()
    ShardStore(root=c.datasets_dir).create(
        "mnist", *synthetic_mnist(640, seed=1), *synthetic_mnist(128, seed=2))
    return c


def request(epochs=2, **opts):
    opts = {"default_parallelism": 1, "static_parallelism": True, "k": 4,
            **opts}
    return TrainRequest(model_type="lenet", batch_size=32, epochs=epochs,
                        dataset="mnist", lr=0.05, function_name="lenetfn",
                        options=TrainOptions(precision="f32", **opts))


def job(job_id, req, cfg, **kw):
    return TrainJob(job_id, req, PortLeNet(),
                    store=ShardStore(root=cfg.datasets_dir),
                    history_store=HistoryStore(root=cfg.history_path),
                    checkpoint_store=CheckpointStore(config=cfg),
                    device="cpu", **kw)


def assert_vars_equal(a, b):
    assert a.keys() == b.keys()
    for c in a:
        assert a[c].keys() == b[c].keys()
        for k in a[c]:
            np.testing.assert_array_equal(np.asarray(a[c][k]),
                                          np.asarray(b[c][k]), err_msg=k)


def restored(cfg, job_id, **kw):
    ck = CheckpointStore(config=cfg).restore(job_id, **kw)
    return {c: {k: v.numpy() for k, v in leaves.items()}
            for c, leaves in from_flax_variables(ck.variables).items()}


def test_job_saves_final_model_and_periodic(cfg):
    j = job("ckjob1", request(epochs=2, checkpoint_every=1), cfg)
    j.train()
    store = CheckpointStore(config=cfg)
    assert store.epochs("ckjob1") == [0, 1]
    assert FINAL_TAG in store.tags("ckjob1")
    ck = store.restore("ckjob1", tag=FINAL_TAG)
    assert ck.epoch == 2
    assert ck.meta["request"]["function_name"] == "lenetfn"
    assert len(ck.meta["history"]["train_loss"]) == 2
    # the Flax layout: a conv kernel is HWIO in the file
    assert ck.variables["params"]["Conv_0"]["kernel"].shape == (5, 5, 1, 6)
    assert_vars_equal(restored(cfg, "ckjob1", tag=FINAL_TAG),
                      j.final_variables)
    # the last epoch checkpoint holds the same weights as the final export
    assert_vars_equal(restored(cfg, "ckjob1", epoch=1), j.final_variables)


def test_periodic_checkpoint_holds_its_epochs_weights(cfg):
    """The epoch-0 checkpoint, written while epoch 1 trains the replicas in
    place, holds the weights after epoch 0: those a one-epoch job ends
    with."""
    job("two", request(epochs=2, checkpoint_every=1,
                       validate_every=0), cfg).train()
    one = job("one", request(epochs=1, validate_every=0), cfg)
    one.train()
    assert_vars_equal(restored(cfg, "two", epoch=0), one.final_variables)
    with pytest.raises(AssertionError):
        assert_vars_equal(restored(cfg, "two", epoch=1), one.final_variables)


def test_reference_variables_are_copies():
    """``reference_variables`` on the CPU returns copies: a later round,
    which updates the replicas in place, leaves them as they were."""
    trainer = KAvgTrainer(PortLeNet(), precision="f32", device="cpu")
    x, y = synthetic_mnist(8, seed=3)
    stacked = trainer.init_variables(0, x, 1)
    ref = trainer.reference_variables(stacked)
    before = {k: v.copy() for k, v in ref["params"].items()}
    trainer.sync_round(stacked, x.reshape(1, 1, 8, 28, 28, 1),
                       y.reshape(1, 1, 8), np.ones((1, 1, 8), np.float32),
                       lr=0.5)
    for k, v in ref["params"].items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    assert not np.array_equal(trainer.reference_variables(stacked)[
        "params"]["Dense_2.kernel"], before["Dense_2.kernel"])


def test_job_checkpoint_keep(cfg):
    """checkpoint_keep keeps the newest N epoch checkpoints (validation
    off: the goal-accuracy stop would end the job early)."""
    job("ckkeep", request(epochs=4, validate_every=0, checkpoint_every=1,
                          checkpoint_keep=2), cfg).train()
    store = CheckpointStore(config=cfg)
    assert store.epochs("ckkeep") == [2, 3]
    assert FINAL_TAG in store.tags("ckkeep")


def test_resume_equals_an_uninterrupted_run(cfg):
    """Two epochs, then a resumed job for four, against four uninterrupted
    epochs: the same losses and the same final weights, bit for bit."""
    opts = dict(default_parallelism=2, checkpoint_every=1, validate_every=0)
    full = job("full", request(epochs=4, **opts), cfg)
    full_hist = full.train()
    job("cut", request(epochs=2, **opts), cfg).train()
    resumed = job("cut", request(epochs=4, resume=True, **opts), cfg)
    hist = resumed.train()
    assert hist.train_loss == full_hist.train_loss
    assert hist.parallelism == full_hist.parallelism == [2, 2, 2, 2]
    assert_vars_equal(resumed.final_variables, full.final_variables)
    assert CheckpointStore(config=cfg).epochs("cut") == [0, 1, 2, 3]


def test_resume_with_no_checkpoint_starts_fresh(cfg):
    hist = job("ckjob3", request(epochs=1, resume=True), cfg).train()
    assert len(hist.train_loss) == 1


def test_resume_from_final_only(cfg):
    """A job run with default options (only final.npz) resumes from it."""
    first = job("ckfin", request(epochs=2), cfg).train()
    assert CheckpointStore(config=cfg).epochs("ckfin") == []
    hist = job("ckfin", request(epochs=3, resume=True), cfg).train()
    assert len(hist.train_loss) == 3
    assert hist.train_loss[:2] == first.train_loss


def test_noop_resume_keeps_history_aligned(cfg):
    """A resume with no epoch left appends nothing and keeps the final."""
    job("cknop", request(epochs=2, checkpoint_every=1), cfg).train()
    store = CheckpointStore(config=cfg)
    mtime = store.export_path("cknop", tag=FINAL_TAG).stat().st_mtime_ns
    hist = job("cknop", request(epochs=2, checkpoint_every=1, resume=True),
               cfg).train()
    assert len(hist.train_loss) == 2
    assert len(hist.accuracy) == len(hist.validation_loss) == 2
    assert store.export_path("cknop",
                             tag=FINAL_TAG).stat().st_mtime_ns == mtime


def test_no_save_model_opt_out(cfg):
    job("ckjob4", request(epochs=1, save_model=False), cfg).train()
    assert CheckpointStore(config=cfg).tags("ckjob4") == []


def test_preempt_writes_a_yield_checkpoint(cfg):
    """A job preempted after its first epoch writes that epoch's weights as
    a resume checkpoint and no final export; resuming it runs the rest."""
    box = {}

    def on_metrics(update):
        if update.epoch == 1:
            box["job"].preempt()

    box["job"] = j = job("ckpre", request(epochs=3, validate_every=0), cfg,
                         on_metrics=on_metrics)
    hist = j.train()
    assert j.preempted and len(hist.train_loss) == 1
    store = CheckpointStore(config=cfg)
    assert store.tags("ckpre") == ["ep00000"]
    assert_vars_equal(restored(cfg, "ckpre", epoch=0), j.final_variables)
    hist = job("ckpre", request(epochs=3, validate_every=0, resume=True),
               cfg).train()
    assert len(hist.train_loss) == 3
    assert FINAL_TAG in store.tags("ckpre")


def test_check_ported_accepts_checkpoint_options():
    TrainOptions(checkpoint_every=2, checkpoint_keep=1,
                 resume=True).check_ported()


# --- a LeNet final served across the packages ---


def jax_ps(tmp_config):
    from kubeml_tpu.functions.registry import FunctionRegistry as JRegistry
    from kubeml_tpu.ps.parameter_server import ParameterServer as JPS

    reg = JRegistry(config=tmp_config)
    reg.create("lenetfn", JAX_LENET_FN)
    return JPS(registry=reg, config=tmp_config)


def port_ps(cfg):
    reg = FunctionRegistry(config=cfg)
    reg.create("lenetfn", PORT_LENET_FN)
    return ParameterServer(registry=reg, config=cfg, device="cpu")


def copy_final(src_root, dst_root, job_id):
    (dst_root / job_id).mkdir(parents=True, exist_ok=True)
    shutil.copyfile(src_root / job_id / "final.npz",
                    dst_root / job_id / "final.npz")


def test_port_final_served_by_the_jax_ps(cfg, tmp_config):
    """The port job's final export, copied into the JAX data root, serves
    the JAX PS's ``infer`` with the job's own outputs; the port PS serves
    the same file with them too."""
    j = job("portjob", request(epochs=1), cfg)
    j.train()
    copy_final(cfg.checkpoints_dir, tmp_config.checkpoints_dir, "portjob")
    x = synthetic_mnist(16, seed=9)[0]
    want = j.infer(x).tolist()
    assert jax_ps(tmp_config).infer("portjob", x.tolist()) == want
    ps = port_ps(cfg)
    assert ps.infer("portjob", x) == want
    assert ps.metrics.running_snapshot()["inference"] == 0


def test_jax_final_served_by_the_port_ps(cfg, tmp_config):
    """A JAX job's final export, copied into the port's data root, serves
    the port PS's ``infer`` with the JAX job's outputs."""
    from kubeml_tpu.api.types import TrainOptions as JOptions
    from kubeml_tpu.api.types import TrainRequest as JRequest
    from kubeml_tpu.engine.job import TrainJob as JTrainJob
    from kubeml_tpu.storage import HistoryStore as JHistory
    from kubeml_tpu.storage import ShardStore as JShards
    from kubeml_tpu.storage.checkpoint import CheckpointStore as JStore
    from test_job import KubeLeNet

    jstore = JShards(config=tmp_config)
    jstore.create("mnist", *synthetic_mnist(640, seed=1),
                  *synthetic_mnist(128, seed=2))
    req = JRequest(model_type="lenet", batch_size=32, epochs=1,
                   dataset="mnist", lr=0.05, function_name="lenetfn",
                   options=JOptions(precision="f32", default_parallelism=1,
                                    static_parallelism=True, k=4))
    jj = JTrainJob("jaxjob", req, KubeLeNet(), store=jstore,
                   history_store=JHistory(config=tmp_config),
                   checkpoint_store=JStore(config=tmp_config))
    jj.train()
    copy_final(tmp_config.checkpoints_dir, cfg.checkpoints_dir, "jaxjob")
    x = synthetic_mnist(16, seed=9)[0]
    want = np.asarray(jj.infer(x)).tolist()
    assert port_ps(cfg).infer("jaxjob", x) == want
