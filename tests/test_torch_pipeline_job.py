"""The port's SPMD job over ``pp`` ranks (``engine/spmd_job.py`` with
``models/gpt_pipeline.py``; ``storage/sharded_checkpoint.py`` with the
stage stack sharded over ``pp``) against the JAX package's
``SPMDJob`` on as many host devices.

The ranks run ``tests/torch_job_ranks.py``'s cluster (rank 0 the leader,
the others followers); both packages' jobs resume from one flat ``final``
JAX wrote of its initial weights, so they start equal. Tolerances: the
job losses within rel 1e-4 (``tests/test_torch_spmd_ranks.py``'s bound);
checkpoints crossing between the packages bit-equal.
"""

import shutil
from types import SimpleNamespace

import flax.linen as nn
import jax
import numpy as np
import pytest

import torch_dist_ranks as R
import torch_job_ranks as J
from kubeml_tpu.api.config import Config as JConfig
from kubeml_tpu.api.types import TrainOptions as JOptions
from kubeml_tpu.api.types import TrainRequest as JRequest
from kubeml_tpu.engine.spmd_job import SPMDJob as JSPMDJob
from kubeml_tpu.functions.registry import FunctionRegistry as JRegistry
from kubeml_tpu.models.gpt_pipeline import PipelinedCausalLM as JaxPipe
from kubeml_tpu.models.gpt_pipeline import \
    flat_serving_remap as jax_flat_remap
from kubeml_tpu.parallel.mesh import make_mesh as jax_mesh
from kubeml_tpu.parallel.trainer import SPMDTrainer as JaxTrainer
from kubeml_tpu.storage import CheckpointStore as JCheckpointStore
from kubeml_tpu.storage import HistoryStore as JHistoryStore
from kubeml_tpu.storage import ShardStore as JShardStore
from kubeml_tpu.storage.sharded_checkpoint import \
    ShardedCheckpointStore as JShardedStore
from kubeml_tpu_torch.api.config import Config
from kubeml_tpu_torch.functions.registry import FunctionRegistry
from kubeml_tpu_torch.interop.from_flax import from_flax, leaf_block
from kubeml_tpu_torch.models.gpt import partition_spec
from kubeml_tpu_torch.models.gpt_pipeline import (PipelinedCausalLM,
                                                  flat_serving_remap)
from kubeml_tpu_torch.models.layers import load_tree
from kubeml_tpu_torch.storage import ShardStore
from kubeml_tpu_torch.storage.sharded_checkpoint import ShardedCheckpointStore
from torch_port_helpers import numpy_tree

# the model of tests/test_torch_gpt_pipeline.py: 2 stages of 2 blocks
CFG = dict(vocab_size=64, max_len=16, embed_dim=32, depth=4, num_heads=4,
           stages=2, microbatches=4)


PP_FN = """
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.gpt_pipeline import (PipelinedCausalLM,
                                                  flat_serving_remap)
from kubeml_tpu_torch.parallel.trainer import adamw
from kubeml_tpu_torch.runtime.model import KubeModel

class Tokens(KubeDataset):
    def __init__(self):
        super().__init__("tokens")

class Model(KubeModel):
    def __init__(self):
        super().__init__(Tokens())
    def build(self):
        return PipelinedCausalLM(vocab_size=64, max_len=16, embed_dim=32,
                                 depth=4, num_heads=4, stages=2,
                                 microbatches=4, mesh=self.mesh,
                                 device="cpu")
    def serving_remap(self):
        return flat_serving_remap(2, 2)
    def configure_optimizers(self, params):
        return adamw(self.lr)(params)
"""

JAX_PP_FN = """
import optax
from kubeml_tpu.runtime.model import KubeModel
from kubeml_tpu.data.dataset import KubeDataset
from kubeml_tpu.models.gpt_pipeline import PipelinedCausalLM

class Tokens(KubeDataset):
    def __init__(self):
        super().__init__("tokens")

class Model(KubeModel):
    def __init__(self):
        super().__init__(Tokens())
    def build(self):
        return PipelinedCausalLM(vocab_size=64, max_len=16, embed_dim=32,
                                 depth=4, num_heads=4, stages=2,
                                 microbatches=4, mesh=self.mesh)
    def configure_optimizers(self):
        return optax.adamw(self.lr)
"""

# the elastic job: pp=2 over 4 ranks, the scheduler answers 2, then 4
# (dp 2 -> 1 -> 2; the last answer changes nothing)
LEVELS = [2, 4, 4]
PP_SHARDED = dict(mesh_shape={"pp": 2}, static_parallelism=True,
                  sharded_checkpoints=True, checkpoint_every=1)


def _data(cfg, store, registry, src):
    cfg.ensure_dirs()
    store(config=cfg).create("tokens", J.token_data(64, 1),
                             np.zeros(64, np.int64), J.token_data(16, 2),
                             np.zeros(16, np.int64))
    registry(config=cfg).create("lmfn", src)


def _jax_request(epochs, **opts):
    return JRequest(batch_size=16, epochs=epochs, dataset="tokens", lr=1e-3,
                    function_name="lmfn", options=JOptions(
                        engine="spmd", precision="f32", validate_every=1,
                        **opts))


def _jax_job(jcfg, jid, req, n, on_epoch_end=None):
    model = JRegistry(config=jcfg).load("lmfn")
    model._set_params(lr=req.lr, batch_size=req.batch_size, epoch=0, k=1,
                      task="train")
    return JSPMDJob(jid, req, model, store=JShardStore(config=jcfg),
                    history_store=JHistoryStore(config=jcfg),
                    checkpoint_store=JCheckpointStore(config=jcfg),
                    devices=jax.devices()[:n], on_epoch_end=on_epoch_end)


@pytest.fixture(scope="module")
def job_roots(tmp_path_factory):
    """Both packages' data roots with the token set and a pipelined
    function each; the JAX initial weights as a flat ``final`` at epoch 0
    under both job ids (so both packages' jobs start equal); JAX's elastic
    job on 4 devices; and a sharded checkpoint JAX writes from 4 devices
    under pp=2 (dp=2)."""
    tmp = tmp_path_factory.mktemp("pp_jobs")
    jcfg = JConfig(data_root=tmp / "jax")
    pcfg = Config(data_root=tmp / "port")
    _data(jcfg, JShardStore, JRegistry, JAX_PP_FN)
    _data(pcfg, ShardStore, FunctionRegistry, PP_FN)
    init = _jax_job(jcfg, "init", _jax_request(1), 1)
    init.trainer.init(jax.random.PRNGKey(0),
                      next(init._token_batches("train", 16)))
    weights = numpy_tree(init.trainer.params)
    for jid in ("ppel", "ppck"):
        path = JCheckpointStore(config=jcfg).save(jid, weights, epoch=0,
                                                  tag="final", meta={})
        dst = pcfg.checkpoints_dir / jid
        dst.mkdir(parents=True, exist_ok=True)
        shutil.copy(path, dst / path.name)
    levels = list(LEVELS)
    h = _jax_job(jcfg, "ppel", _jax_request(3, resume=True,
                                            mesh_shape={"pp": 2}), 4,
                 on_epoch_end=lambda state: levels.pop(0)).train()
    elastic = dict(train_loss=list(h.train_loss),
                   validation_loss=list(h.validation_loss),
                   parallelism=list(h.parallelism))
    mesh = jax_mesh(devices=jax.devices()[:4], dp=2, pp=2)
    tr = JaxTrainer(JaxPipe(**CFG, mesh=mesh), mesh, precision="f32")
    tr.init(jax.random.PRNGKey(1), J.token_data(16, 3))
    JShardedStore(root=pcfg.checkpoints_dir).save(
        "jaxpp", nn.meta.unbox(tr.params), epoch=0, tag="ep00000")
    full = {k: np.asarray(v) for k, v in from_flax(
        numpy_tree(tr.params)).items()}
    return dict(jcfg=jcfg, pcfg=pcfg, elastic=elastic, jaxpp=full)


@pytest.fixture(scope="module")
def job_ranks(job_roots):
    return R.run(J.cluster_rank, 4, dict(
        root=str(job_roots["pcfg"].data_root),
        jobs=[dict(id="ppel", epochs=3,
                   opts=dict(resume=True, mesh_shape={"pp": 2}),
                   levels=LEVELS),
              dict(id="ppck", epochs=1, opts=dict(resume=True,
                                                  **PP_SHARDED))],
        restore=("jaxpp", "ep00000", {"dp": 2, "pp": 2})))


def test_pp_job_keeps_pp_through_an_elastic_dp_resize(job_roots, job_ranks):
    """pp=2 over 4 ranks while the scheduler moves dp 2 -> 1 -> 2 (JAX
    ``test_pp_through_spmd_job_with_elastic_dp``): parallelism [4, 2, 4],
    losses equal to JAX's job on 4 host devices."""
    got = job_ranks[0]["jobs"]["ppel"]
    want = job_roots["elastic"]
    assert got["error"] is None, got
    assert got["parallelism"] == want["parallelism"] == [4, 2, 4]
    assert got["asked"] == [4, 2, 4]
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["validation_loss"],
                               want["validation_loss"], rtol=1e-4)


def test_stage_sharded_checkpoint_restores_in_jax_through_the_remap(
        job_roots, job_ranks):
    """The pp=2 job's sharded final (4 ranks, dp=2): each stage slice of a
    stacked leaf written once, by the first dp replica of its stage; JAX's
    ``restore(remap=flat_serving_remap(2, 2))`` equals the port's restore
    through its own remap, bit for bit, and the flat model the PS serves
    loads it."""
    got = job_ranks[0]["jobs"]["ppck"]
    assert got["error"] is None, got
    root = job_roots["pcfg"].checkpoints_dir
    store = ShardedCheckpointStore(root=root)
    man = store.read_manifest("ppck", "final")
    assert man["processes"] == 4
    q = man["leaves"]["params/stages/layer_0/attn/query/kernel"]
    assert q["shape"] == [2, 32, 32]
    # ranks 0 and 1 are (dp 0, pp 0) and (dp 0, pp 1)
    assert [(s["start"], s["shard"]) for s in q["slices"]] == [
        ([0, 0, 0], 0), ([1, 0, 0], 1)]
    emb = man["leaves"]["params/token_embed/embedding"]["slices"]
    assert [(s["start"], s["shard"]) for s in emb] == [([0, 0], 0)]
    mine = from_flax(store.restore("ppck", "final",
                                   remap=flat_serving_remap(2, 2)).variables)
    theirs = from_flax(numpy_tree(JShardedStore(root=root).restore(
        "ppck", "final", remap=jax_flat_remap(2, 2)).variables))
    assert set(mine) == set(theirs)
    assert "block_3.attn.query.kernel" in mine
    for name in mine:
        np.testing.assert_array_equal(np.asarray(mine[name]),
                                      np.asarray(theirs[name]), name)
    whole = from_flax(store.restore("ppck", "final").variables)
    np.testing.assert_array_equal(
        np.asarray(mine["block_3.mlp_in.kernel"]),
        np.asarray(whole["stages.layer_1.mlp_in.kernel"][1]))
    flat = PipelinedCausalLM(**CFG, device="cpu").flat_equivalent()
    load_tree(flat, mine)


def test_jax_stage_sharded_checkpoint_restores_over_4_ranks(job_roots,
                                                           job_ranks):
    """Written by JAX from 4 devices under pp=2 (dp=2), restored over 4
    ranks under dp=2, pp=2: each rank reads its stage's slices only."""
    full = job_roots["jaxpp"]
    size = sum(v.nbytes for v in full.values())
    for res in job_ranks:
        got = res["restore"]
        rank = SimpleNamespace(shape={"dp": 2, "pp": 2}, coord=got["coord"])
        assert set(got["blocks"]) == set(full)
        for name, block in got["blocks"].items():
            start, shape = leaf_block(name, full[name].shape, rank)
            want = full[name][tuple(slice(a, a + n)
                                    for a, n in zip(start, shape))]
            np.testing.assert_array_equal(block, want, name)
            if name.startswith("stages."):
                assert block.shape[0] == 1
        assert 0 < got["bytes_read"] < size
    assert partition_spec("stages.layer_0.ln1.scale", 2) == ("pp", None)
