"""A MoE SPMD job over ranks: ``engine/spmd_job.py`` over ``mesh_shape=
{"ep": 2}`` on two gloo ranks through the leader's parameter server (rank
0 ``LocalCluster``, rank 1 the follower, ``tests/torch_job_ranks.py``),
with ep-sharded checkpoints, against the same job on one rank.

The model is ``torch_job_ranks.MOE_FN``'s (vocab 64, max_len 16, E 32,
depth 2, 4 heads, 4 experts, top-2; block 1 is the MoE block, router
noise on), the data ``tests/test_spmd_job.py``'s token rows, f32, B 16:

- two epochs over ``ep=2`` equal the one-rank job's (train and eval
  losses within rel 1e-4, accuracy within 0.5 points, as
  ``tests/test_torch_spmd_ranks.py``): the router noise is drawn for the
  global batch from the step's seed, so the mesh changes no step;
- each epoch's ``MetricUpdate`` from rank 0 carries the MoE overflow (the
  one-rank job's, in (0, 1)), and the parameter server's ``/metrics``
  renders it as ``kubeml_job_moe_overflow``; the port's ``History``, like
  JAX's, has no overflow field;
- the checkpoints are ep-sharded: two files, each expert stack a half (2
  of the 4 experts) in its owner's file, every other leaf whole in rank
  0's, written once; the JAX package restores them bit-equal to the port's
  flat restore;
- the job resumes from them under ``dp=2`` for a third epoch, held
  against the one-rank continuation, the history spliced exactly;
- the ep-sharded final restores flat and a parameter server on one rank
  serves it through the dense engine with greedy tokens equal to an
  in-process ``generate_from_request`` on the restored weights.
"""

import numpy as np
import pytest

import torch_dist_ranks as R
import torch_job_ranks as J
from kubeml_tpu.storage.sharded_checkpoint import \
    ShardedCheckpointStore as JShardedStore
from kubeml_tpu_torch.api.config import Config
from kubeml_tpu_torch.api.types import GenerateRequest
from kubeml_tpu_torch.engine.spmd_job import SPMDJob
from kubeml_tpu_torch.functions.registry import FunctionRegistry
from kubeml_tpu_torch.interop.from_flax import from_flax
from kubeml_tpu_torch.storage import CheckpointStore, HistoryStore, ShardStore
from kubeml_tpu_torch.storage.sharded_checkpoint import ShardedCheckpointStore
from torch_port_helpers import numpy_tree

SHARDED = dict(static_parallelism=True, sharded_checkpoints=True,
               checkpoint_every=1)
ATTOL = 0.5
PROMPTS = [[5, 9, 3, 17], [40, 2, 2, 8, 61, 7]]


def _data(cfg):
    xtr, xte = J.token_data(128, 1), J.token_data(32, 2)
    cfg.ensure_dirs()
    ShardStore(config=cfg).create("tokens", xtr, np.zeros(128, np.int64),
                                  xte, np.zeros(32, np.int64))
    FunctionRegistry(config=cfg).create("lmfn", J.MOE_FN)


def _one_rank(cfg, epochs, **opts):
    """The job on one rank in this process: its history and each epoch's
    MetricUpdate."""
    req = J.request("moe", epochs, **SHARDED, **opts)
    model = FunctionRegistry(config=cfg).load("lmfn")
    model._set_params(lr=req.lr, batch_size=req.batch_size, epoch=0, k=1,
                      task="train")
    updates = []
    h = SPMDJob("moe", req, model, store=ShardStore(config=cfg),
                history_store=HistoryStore(config=cfg),
                checkpoint_store=CheckpointStore(config=cfg), device="cpu",
                on_metrics=updates.append).train()
    return dict(train_loss=list(h.train_loss),
                validation_loss=list(h.validation_loss),
                accuracy=list(h.accuracy), parallelism=list(h.parallelism),
                overflow=[u.moe_overflow for u in updates])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep_job")
    ref_cfg, cfg = Config(data_root=tmp / "ref"), Config(data_root=tmp / "ep")
    _data(ref_cfg)
    _data(cfg)
    ref = {"first": _one_rank(ref_cfg, 2),
           "resumed": _one_rank(ref_cfg, 3, resume=True, save_model=False)}
    ranks = R.run(J.cluster_rank, 2, dict(
        root=str(cfg.data_root),
        jobs=[dict(id="moe", epochs=2, metrics=True,
                   opts=dict(mesh_shape={"ep": 2}, **SHARDED)),
              dict(id="moe", key="moe-resumed", epochs=3,
                   opts=dict(mesh_shape={"dp": 2}, resume=True,
                             save_model=False, **SHARDED))]))
    return dict(cfg=cfg, ref=ref, ranks=ranks)


def _held(got, want):
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["validation_loss"],
                               want["validation_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=ATTOL)


def test_ep_job_equals_one_rank_and_reports_its_overflow(runs):
    got = runs["ranks"][0]["jobs"]["moe"]
    want = runs["ref"]["first"]
    assert got["status"] == "finished" and got["error"] is None, got
    assert got["parallelism"] == [2, 2]
    _held(got, want)
    over = [m["moe_overflow"] for m in got["metrics"]]
    assert len(over) == 2 and all(0.0 < x < 1.0 for x in over), over
    np.testing.assert_allclose(over, want["overflow"], atol=1e-6)
    for m in got["metrics"]:
        assert m["gauge"] == [f'kubeml_job_moe_overflow{{jobid="moe"}} '
                              f'{m["moe_overflow"]}'], m
    assert runs["ranks"][1]["jobs_followed"] == 2


def test_checkpoints_split_each_expert_stack_over_the_ep_files(runs):
    cfg = runs["cfg"]
    store = ShardedCheckpointStore(root=cfg.checkpoints_dir)
    assert store.tags("moe") == ["ep00000", "ep00001", "ep00002", "final"]
    for tag in ("ep00001", "final"):
        man = store.read_manifest("moe", tag)
        assert man["processes"] == 2
        d = cfg.checkpoints_dir / "moe" / f"{tag}.shards"
        written = {}
        for r in range(2):
            with np.load(d / f"shard-{r}.npz") as z:
                for key in z.files:
                    assert key not in written, key  # written once
                    written[key] = (r, z[key].shape)
        leaves = man["leaves"]
        for leaf in ("w_in", "w_out"):
            path = f"params/block_1/moe/{leaf}"
            full = leaves[path]["shape"]
            assert full[0] == 4
            got = [(s["start"], s["shard"]) for s in leaves[path]["slices"]]
            assert got == [([0, 0, 0], 0), ([2, 0, 0], 1)], (path, got)
            for start, r in got:
                key = f"{path}@{','.join(map(str, start))}"
                assert written[key] == (r, (2, *full[1:]))
        for path in ("params/block_1/moe/router",
                     "params/block_1/attn/query/kernel",
                     "params/token_embed/embedding"):
            assert [(s["start"], s["shard"]) for s in
                    leaves[path]["slices"]] == [([0] * len(
                        leaves[path]["shape"]), 0)]
        # the JAX package reads the port's ep-sharded checkpoint bit-equal
        mine = from_flax(store.restore("moe", tag).variables)
        theirs = from_flax(numpy_tree(JShardedStore(
            root=cfg.checkpoints_dir).restore("moe", tag).variables))
        assert set(mine) == set(theirs)
        for name in mine:
            np.testing.assert_array_equal(mine[name].numpy(),
                                          theirs[name].numpy(), name)
    # the final is the state after the last epoch: ep00001's
    a = from_flax(store.restore("moe", "ep00001").variables)
    b = from_flax(store.restore("moe", "final").variables)
    for name in a:
        np.testing.assert_array_equal(a[name].numpy(), b[name].numpy())


def test_resumed_under_dp2_equals_the_one_rank_continuation(runs):
    first = runs["ranks"][0]["jobs"]["moe"]
    got = runs["ranks"][0]["jobs"]["moe-resumed"]
    want = runs["ref"]["resumed"]
    assert got["error"] is None, got
    assert got["train_loss"][:2] == first["train_loss"]
    assert got["parallelism"] == [2, 2, 2]
    _held(got, want)
    # rank 0 read both halves of every expert stack under dp=2
    assert got["restore_bytes"] > first["last_save"]["bytes"]


def test_ep_final_served_flat_through_the_dense_engine(runs):
    from kubeml_tpu_torch.models.generation import generate_from_request
    from kubeml_tpu_torch.models.layers import load_tree
    from kubeml_tpu_torch.ps.parameter_server import ParameterServer

    cfg = runs["cfg"]
    ps = ParameterServer(config=cfg, device="cpu")
    assert ps._serving_source("moe")[:2] == ("sharded", "final")
    model = FunctionRegistry(config=cfg).load("lmfn")
    module = load_tree(model.build(), from_flax(ShardedCheckpointStore(
        root=cfg.checkpoints_dir).restore("moe", "final").variables))
    try:
        for prompt, n in ((PROMPTS[0], 6), (PROMPTS[1], 8)):
            req = GenerateRequest(prompts=[prompt], max_new_tokens=n)
            got = ps.generate("moe", req)
            want = generate_from_request(module.eval(), req)
            assert got["tokens"] == want["tokens"], (got, want)
        assert ps._decoders["moe"][0].__class__.__name__ == "BatchingDecoder"
    finally:
        ps.close()
