"""The port's SPMD job (``engine/spmd_job.py``) against the JAX package's
``SPMDJob`` on the CPU, on the model of JAX ``tests/test_spmd_job.py``
(vocab 64, max_len 16, E 32, depth 2, 4 heads, f32), the weights carried
from Flax by ``interop.from_flax``, and the paths around it: resume and
preemption, flat and sharded; the job through the parameter server, the
controller and ``kubeml train --engine spmd``; the sharded final served
and quantized.

Tolerances: per-epoch train and eval losses within rel 1e-4 of JAX's
(f32, 16 AdamW steps); validation accuracy within 0.5 percentage points
(two of the 480 next-token predictions of the test split, the room near
ties leave); served greedy tokens equal to the JAX server's exactly.
"""

import shutil
import time

import jax
import numpy as np
import pytest
import torch

from kubeml_tpu.api.config import Config as JConfig
from kubeml_tpu.api.types import TrainOptions as JOptions
from kubeml_tpu.api.types import TrainRequest as JRequest
from kubeml_tpu.engine.spmd_job import SPMDJob as JSPMDJob
from kubeml_tpu.functions.registry import FunctionRegistry as JRegistry
from kubeml_tpu.ps.parameter_server import ParameterServer as JPS
from kubeml_tpu.serving.quant import quantize_final_checkpoint as jquantize
from kubeml_tpu.storage import CheckpointStore as JCheckpointStore
from kubeml_tpu.storage import HistoryStore as JHistoryStore
from kubeml_tpu.storage import ShardStore as JShardStore
from kubeml_tpu.storage.sharded_checkpoint import \
    ShardedCheckpointStore as JShardedStore
from kubeml_tpu_torch.api.config import Config
from kubeml_tpu_torch.api.errors import KubeMLError
from kubeml_tpu_torch.api.types import (GenerateRequest, TrainOptions,
                                        TrainRequest, TrainTask)
from kubeml_tpu_torch.controller import KubemlClient
from kubeml_tpu_torch.engine import job_class_for
from kubeml_tpu_torch.engine.job import TrainJob
from kubeml_tpu_torch.engine.spmd_job import SPMDJob
from kubeml_tpu_torch.functions.registry import FunctionRegistry
from kubeml_tpu_torch.interop.from_flax import from_flax
from kubeml_tpu_torch.models.generation import generate_from_request
from kubeml_tpu_torch.models.layers import load_tree
from kubeml_tpu_torch.ps.parameter_server import ParameterServer
from kubeml_tpu_torch.serving.quant import (INT8_TAG,
                                            quantize_final_checkpoint)
from kubeml_tpu_torch.storage import CheckpointStore, HistoryStore, ShardStore
from kubeml_tpu_torch.storage.sharded_checkpoint import ShardedCheckpointStore
from torch_port_helpers import numpy_tree

PORT_LM_FN = """
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.gpt import CausalTransformer
from kubeml_tpu_torch.parallel.trainer import adamw
from kubeml_tpu_torch.runtime.model import KubeModel

class Tokens(KubeDataset):
    def __init__(self):
        super().__init__("tokens")

class Model(KubeModel):
    def __init__(self):
        super().__init__(Tokens())
    def build(self):
        # self.mesh is set by the SPMD engine before build()
        return CausalTransformer(vocab_size=64, max_len=16, embed_dim=32,
                                 depth=2, num_heads=4, mesh=self.mesh,
                                 device="cpu")
    def configure_optimizers(self, params):
        return adamw(self.lr)(params)
"""

JAX_LM_FN = """
import optax
from kubeml_tpu.runtime.model import KubeModel
from kubeml_tpu.data.dataset import KubeDataset
from kubeml_tpu.models.gpt import CausalTransformer

class Tokens(KubeDataset):
    def __init__(self):
        super().__init__("tokens")

class Model(KubeModel):
    def __init__(self):
        super().__init__(Tokens())
    def build(self):
        return CausalTransformer(vocab_size=64, max_len=16, embed_dim=32,
                                 depth=2, num_heads=4, mesh=self.mesh)
    def configure_optimizers(self):
        return optax.adamw(self.lr)
"""

SERVE = dict(serving_slots=2, serving_chunk_steps=4, serving_page_tokens=4)
PROMPTS = [[5, 9, 3, 17, 2, 40], [1, 2, 3, 4, 5, 6]]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def token_data(n, l=16, vocab=64, seed=0):
    r = np.random.default_rng(seed)
    x = r.integers(1, vocab, size=(n, l)).astype(np.int32)
    x[:, -1] = 0
    return x


def make_roots(tmp_path, **serve):
    """(JAX config, port config), each with the token set and its own
    ``lmfn``."""
    xtr, xte = token_data(128, seed=1), token_data(32, seed=2)
    ytr, yte = np.zeros(len(xtr), np.int64), np.zeros(len(xte), np.int64)
    jcfg = JConfig(data_root=tmp_path / "jax", paged_attn="gather",
                   int8_matmul_impl="dot", **serve)
    pcfg = Config(data_root=tmp_path / "port", **serve)
    for cfg, store, reg, src in ((jcfg, JShardStore, JRegistry, JAX_LM_FN),
                                 (pcfg, ShardStore, FunctionRegistry,
                                  PORT_LM_FN)):
        cfg.ensure_dirs()
        store(config=cfg).create("tokens", xtr, ytr, xte, yte)
        reg(config=cfg).create("lmfn", src)
    return jcfg, pcfg


@pytest.fixture
def roots(tmp_path):
    return make_roots(tmp_path)


def request(types, epochs=2, **opts):
    opts.setdefault("engine", "spmd")
    opts.setdefault("precision", "f32")
    opts.setdefault("validate_every", 1)
    return types[0](batch_size=16, epochs=epochs, dataset="tokens", lr=1e-3,
                    function_name="lmfn", options=types[1](**opts))


PORT_TYPES, JAX_TYPES = (TrainRequest, TrainOptions), (JRequest, JOptions)


def port_job(pcfg, jid, req, **kw):
    model = FunctionRegistry(config=pcfg).load("lmfn")
    model._set_params(lr=req.lr, batch_size=req.batch_size, epoch=0, k=1,
                      task="train")
    return SPMDJob(jid, req, model, store=ShardStore(config=pcfg),
                   history_store=HistoryStore(config=pcfg),
                   checkpoint_store=CheckpointStore(config=pcfg),
                   device="cpu", **kw)


def jax_job(jcfg, jid, req):
    model = JRegistry(config=jcfg).load("lmfn")
    model._set_params(lr=req.lr, batch_size=req.batch_size, epoch=0, k=1,
                      task="train")
    return JSPMDJob(jid, req, model, store=JShardStore(config=jcfg),
                    history_store=JHistoryStore(config=jcfg),
                    checkpoint_store=JCheckpointStore(config=jcfg),
                    devices=jax.devices()[:1])


def twin_jobs(jcfg, pcfg, jid, epochs=2, **opts):
    """A JAX job on one device and a port job that starts from the JAX
    job's initial weights."""
    jjob = jax_job(jcfg, jid, request(JAX_TYPES, epochs, **opts))
    first = next(jjob._token_batches("train", 16))
    jjob.trainer.init(jax.random.PRNGKey(0), first)
    tjob = port_job(pcfg, jid, request(PORT_TYPES, epochs, **opts))
    load_tree(tjob.model.module, from_flax(numpy_tree(jjob.trainer.params)))
    return jjob, tjob


def test_losses_and_accuracy_match_jax_per_epoch(roots):
    jcfg, pcfg = roots
    jjob, tjob = twin_jobs(*roots, "parity")
    jh, th = jjob.train(), tjob.train()
    assert th.parallelism == [1, 1]
    np.testing.assert_allclose(th.train_loss, jh.train_loss, rtol=1e-4)
    np.testing.assert_allclose(th.validation_loss, jh.validation_loss,
                               rtol=1e-4)
    np.testing.assert_allclose(th.accuracy, jh.accuracy, atol=0.5)
    assert th.train_loss[-1] < th.train_loss[0]
    # the final exports hold the same leaves, in the same layout
    mine = CheckpointStore(config=pcfg).restore("parity", tag="final")
    theirs = JCheckpointStore(config=jcfg).restore("parity", tag="final")
    assert mine.epoch == theirs.epoch == 2
    flat = dict(from_flax(mine.variables))
    other = dict(from_flax(theirs.variables))
    assert set(flat) == set(other)
    for k in flat:
        np.testing.assert_allclose(flat[k].numpy(), other[k].numpy(),
                                   rtol=1e-3, atol=1e-5)


def test_validation_reports_next_token_accuracy(roots):
    """One epoch: the recorded accuracy is 100 x the mean of the test
    batches' next-token accuracy, and live ``infer``/``generate`` answer
    from the trained module."""
    _, pcfg = roots
    job = port_job(pcfg, "acc", request(PORT_TYPES, 1))
    hist = job.train()
    accs = [job.trainer.eval_metrics(b)[1]
            for b in job._token_batches("test", 16)]
    assert len(accs) == 2
    assert hist.accuracy == [pytest.approx(100.0 * float(np.mean(accs)))]
    assert 0.0 <= hist.accuracy[0] <= 100.0
    x = token_data(2)
    preds = job.infer(x)
    assert preds.shape == (2, 16) and preds.max() < 64
    req = GenerateRequest(prompts=PROMPTS, max_new_tokens=5)
    assert job.generate(req) == generate_from_request(job.model.module, req)


def test_goal_loss_stops_early(roots):
    """A goal eval loss the first epoch already meets stops the job after
    it (of 5), and the job still exports its final."""
    _, pcfg = roots
    job = port_job(pcfg, "goal", request(PORT_TYPES, 5, goal_loss=100.0))
    assert len(job.train().train_loss) == 1
    assert "final" in CheckpointStore(config=pcfg).tags("goal")


@pytest.mark.parametrize("sharded", [False, True], ids=["flat", "sharded"])
def test_resume(roots, sharded):
    """Checkpoints every epoch; a resumed job restores the newest one with
    its history and continues at the next epoch (JAX
    ``test_spmd_job_resume``). Sharded jobs write only sharded
    checkpoints and resume from them."""
    _, pcfg = roots
    opts = dict(checkpoint_every=1, sharded_checkpoints=sharded)
    h1 = port_job(pcfg, "res", request(PORT_TYPES, 2, **opts)).train()
    flat = CheckpointStore(config=pcfg)
    shards = ShardedCheckpointStore(root=flat.root)
    written = ["ep00000", "ep00001", "final"]
    assert (shards.tags("res"), flat.tags("res")) == (
        (written, []) if sharded else ([], written))
    job = port_job(pcfg, "res", request(PORT_TYPES, 4, resume=True, **opts))
    h2 = job.train()
    assert len(h2.train_loss) == 4
    assert h2.train_loss[:2] == h1.train_loss
    assert h2.train_loss[-1] < h1.train_loss[-1]
    store = shards if sharded else flat
    meta = (store.read_manifest("res", "final") if sharded
            else store.read_meta("res", "final"))
    assert meta["epoch"] == 4


@pytest.mark.parametrize("sharded", [False, True], ids=["flat", "sharded"])
def test_preempt_yields_a_resume_checkpoint(roots, sharded):
    """``preempt()`` leaves before the next epoch, writes the last
    completed epoch's checkpoint and no final; a resumed job continues
    from it."""
    _, pcfg = roots
    opts = dict(sharded_checkpoints=sharded, static_parallelism=False)
    holder = {}

    def epoch_end(state):
        holder["job"].preempt()
        return 4  # any answer keeps the one device

    job = port_job(pcfg, "yield", request(PORT_TYPES, 3, **opts),
                   on_epoch_end=epoch_end)
    holder["job"] = job
    hist = job.train()
    assert job.preempted and len(hist.train_loss) == 1
    assert job.state.parallelism == 1
    flat = CheckpointStore(config=pcfg)
    tags = (ShardedCheckpointStore(root=flat.root).tags("yield") if sharded
            else flat.tags("yield"))
    assert tags == ["ep00000"]
    again = port_job(pcfg, "yield", request(PORT_TYPES, 3, resume=True,
                                            **opts)).train()
    assert len(again.train_loss) == 3
    assert again.train_loss[0] == hist.train_loss[0]


def test_job_through_the_ps(roots):
    """``engine="spmd"`` dispatches to the SPMD job class; the finished
    job's flat final serves ``/generate``."""
    _, pcfg = roots
    assert job_class_for(TrainOptions(engine="spmd")) is SPMDJob
    assert job_class_for(TrainOptions()) is TrainJob
    ps = ParameterServer(config=pcfg, device="cpu")
    ps.start_task(TrainTask(job_id="viaps",
                            parameters=request(PORT_TYPES, 1)))
    with ps._lock:
        assert isinstance(ps._jobs["viaps"].job, SPMDJob)
    assert ps.wait("viaps", timeout=120)
    hist = HistoryStore(config=pcfg).get("viaps")
    assert len(hist.train_loss) == 1 and np.isfinite(hist.train_loss[0])
    out = ps.generate("viaps", {"prompts": PROMPTS, "max_new_tokens": 5})
    assert np.asarray(out["tokens"]).shape == (2, 5)
    assert out["lengths"] == [5, 5]
    for d, _ in ps._decoders.values():
        d.close()


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_sharded_final_served_like_the_jax_ps(tmp_path, mode):
    """A sharded final written by the port job, copied into a JAX data
    root: both servers serve it (int8: each its own ``final-int8``
    quantized from it, written sharded) with equal greedy tokens."""
    kw = dict(serving_quantize="int8", int8_matmul=True) if mode == "int8" \
        else {}
    jcfg, pcfg = make_roots(tmp_path, **SERVE, **kw)
    port_job(pcfg, "shfinal", request(PORT_TYPES, 1,
                                      sharded_checkpoints=True)).train()
    src = pcfg.checkpoints_dir / "shfinal" / "final.shards"
    assert not (pcfg.checkpoints_dir / "shfinal" / "final.npz").exists()
    shutil.copytree(src, jcfg.checkpoints_dir / "shfinal" / "final.shards")
    jps = JPS(registry=JRegistry(config=jcfg), config=jcfg)
    tps = ParameterServer(config=pcfg, device="cpu")
    if mode == "int8":
        assert jquantize("shfinal", JCheckpointStore(config=jcfg),
                         JShardedStore(root=jcfg.checkpoints_dir),
                         registry=jps.registry) == "sharded"
        assert quantize_final_checkpoint(
            "shfinal", CheckpointStore(config=pcfg),
            registry=tps.registry) == "sharded"
        mine = ShardedCheckpointStore(root=pcfg.checkpoints_dir)
        theirs = JShardedStore(root=jcfg.checkpoints_dir)
        assert (sorted(mine.read_manifest("shfinal", INT8_TAG)["leaves"])
                == sorted(theirs.read_manifest("shfinal", INT8_TAG)["leaves"]))
    assert tps._serving_source("shfinal")[:2] == (
        "sharded", INT8_TAG if mode == "int8" else "final")
    try:
        for prompt, n in ((PROMPTS[0], 6), (PROMPTS[1], 8)):
            req = {"prompts": [prompt], "max_new_tokens": n}
            got = tps.generate("shfinal", req)
            want = jps.generate("shfinal", req)
            assert got["tokens"] == np.asarray(want["tokens"]).tolist()
    finally:
        for ps in (jps, tps):
            for d in list(ps._decoders.values()):
                d[0].close()


def wait_history(cluster, jid, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with cluster.ps._lock:
            live = jid in cluster.ps._jobs
        if not live:
            try:
                return cluster.history_store.get(jid)
            except KubeMLError:
                pass
        time.sleep(0.1)
    raise AssertionError(f"job {jid} did not finish")


def test_cli_train_engine_spmd_and_the_controller_routes(tmp_path, capsys):
    """``kubeml train --engine spmd --goal-loss`` trains through the
    control plane and stops at the goal; the controller lists, exports
    and deletes the job's sharded checkpoints; ``--goal-loss`` without
    the SPMD engine is a CLI error, and a mesh of two cards a 400 naming
    the multi-card slice."""
    from kubeml_tpu_torch.cli import main
    from kubeml_tpu_torch.cluster import LocalCluster

    def cli(*argv):
        rc = main(["--url", c.controller_url, *argv])
        out = capsys.readouterr()
        return rc, out.out, out.err

    cfg = Config(data_root=tmp_path / "kubeml", controller_port=0,
                 scheduler_port=0, ps_port=0, storage_port=0)
    with LocalCluster(config=cfg, device="cpu") as c:
        client_store = ShardStore(config=cfg)
        client_store.create("tokens", token_data(64, seed=1),
                            np.zeros(64, np.int64), token_data(32, seed=2),
                            np.zeros(32, np.int64))
        fn = tmp_path / "lmfn.py"
        fn.write_text(PORT_LM_FN)
        assert cli("function", "create", "-n", "lmfn", "--code", str(fn))[0] \
            == 0
        rc, out, _ = cli("train", "-f", "lmfn", "-d", "tokens", "-e", "5",
                         "-b", "16", "--lr", "0.001", "--engine", "spmd",
                         "--goal-loss", "100", "--checkpoint-every", "1")
        assert rc == 0
        jid = out.strip()
        hist = wait_history(c, jid)
        assert len(hist.train_loss) == 1 and not hist.task.get("error")
        # a sharded checkpoint beside the flat ones: listed, exported once
        # through the flat store, deleted
        flat = CheckpointStore(config=cfg)
        ck = flat.restore(jid, tag="final")
        ShardedCheckpointStore(root=flat.root).save(
            jid, ck.variables, epoch=7, tag="ep00007", meta=ck.meta)
        client = KubemlClient(c.controller_url)
        assert client.checkpoints().list(jid) == ["ep00000", "final",
                                                   "ep00007"]
        assert client.checkpoints().list_jobs()[jid][-1] == "ep00007"
        dest = client.checkpoints().export(jid, tmp_path / "out", epoch=7)
        back = CheckpointStore.load_export(dest)
        assert back.epoch == 7
        for k, v in from_flax(ck.variables).items():
            np.testing.assert_array_equal(
                from_flax(back.variables)[k].numpy(), v.numpy())
        assert "ep00007" in flat.tags(jid)
        client.checkpoints().delete(jid, tag="ep00007")
        assert ShardedCheckpointStore(root=flat.root).tags(jid) == []
        assert flat.tags(jid) == ["ep00000", "final"]
        rc, out, _ = cli("checkpoint", "delete", "--id", jid)
        assert rc == 0 and client.checkpoints().list(jid) == []
        rc, _, err = cli("train", "-f", "lmfn", "-d", "tokens",
                         "--goal-loss", "1")
        assert rc == 1 and "--engine spmd" in err
        rc, _, err = cli("train", "-f", "lmfn", "-d", "tokens", "--engine",
                         "spmd", "--mesh", "tp=2")
        assert rc != 0 and "multi-card" in err


def test_two_card_mesh_is_a_400_naming_the_multi_card_slice(roots):
    _, pcfg = roots
    for opts in ({"mesh_shape": {"tp": 2}}, {"mesh_shape": {"dp": 2}}):
        with pytest.raises(KubeMLError, match="multi-card SPMD") as e:
            port_job(pcfg, "mesh", request(PORT_TYPES, 1, **opts))
        assert e.value.status_code == 400
    # axes of one device are a one-card mesh
    job = port_job(pcfg, "mesh1", request(
        PORT_TYPES, 1, mesh_shape={"tp": 1, "sp": 1}))
    assert job.mesh.shape == {"dp": 1, "pp": 1, "ep": 1, "sp": 1, "tp": 1}
