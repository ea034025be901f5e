"""The port's GPipe schedule (``kubeml_tpu_torch/parallel/pipeline.py``:
``schedule``, ``gpipe``, ``PipelinedLM``, ``PipelineTrainer``) against the
JAX package's ``kubeml_tpu/parallel/pipeline.py``.

The JAX modules run on conftest's host devices; the port's over spawned
gloo ranks on the CPU (``tests/torch_pipeline_ranks.py``), rank ``r``
standing for JAX device ``r``. Weights cross from Flax through
``pipeline_from_flax`` and ``interop.from_flax.shard_tree`` (each rank
keeps its stage). Tolerances: logits at f32 2e-4 (the JAX suite's own,
``tests/test_pipeline_moe.py``); the trainer's losses at 1e-4 (f32, the
stages' sums in other orders).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
import torch_pipeline_ranks as PR
from kubeml_tpu.models.gpt_pipeline import PipelinedCausalLM as JaxCausal
from kubeml_tpu.parallel import PipelinedLM as JaxLM
from kubeml_tpu.parallel import PipelineTrainer as JaxPipelineTrainer
from kubeml_tpu.parallel import make_mesh as jax_mesh
from kubeml_tpu_torch.interop.from_flax import from_flax
from kubeml_tpu_torch.models.layers import load_tree
from kubeml_tpu_torch.parallel import PipelinedLM, PipelineTrainer, gpipe
from kubeml_tpu_torch.parallel.pipeline import (partition_spec,
                                                pipeline_from_flax,
                                                pp_layout, schedule)
from torch_port_helpers import numpy_tree

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
LM = dict(vocab_size=64, max_len=16, embed_dim=32, num_heads=4,
          microbatches=4)
# the trainer case of JAX tests/test_pipeline_moe.py: vocab 32, L 12,
# depth 2 over pp=2, dp=2, two microbatches, lr 1e-2
TRAIN = dict(vocab_size=32, max_len=12, embed_dim=32, depth=2, num_heads=4,
             microbatches=2)
TRAIN_LR = 1e-2
CAUSAL = dict(vocab_size=64, max_len=16, embed_dim=32, depth=4, num_heads=4,
              stages=2, microbatches=4)


def token_batch(seed, b, l, vocab=64):
    ids = np.random.default_rng(seed).integers(1, vocab, size=(b, l)).astype(
        np.int32)
    ids[:, -2:] = 0  # some padding
    return ids


def jax_lm(axes, depth, **cfg):
    """JAX's PipelinedLM on the first host devices, its ``init`` jitted
    (the same variables, one compile instead of op-by-op dispatch)."""
    n = int(np.prod(list(axes.values())))
    mesh = jax_mesh(devices=jax.devices()[:n], **axes)
    m = JaxLM(mesh, depth=depth, **cfg)
    m.init = jax.jit(m.init)
    return mesh, m


@pytest.fixture(scope="module")
def jax_side():
    """JAX's pipelined logits at (pp 4, dp 1) and (pp 2, dp 2), 2 layers
    a stage; three PipelineTrainer steps; PipelinedCausalLM's logits
    (learned and rope)."""
    ids = token_batch(0, 8, 16)
    out = {"ids": ids, "lm": {}}
    for tag, axes, depth in (("pp4", dict(pp=4), 8),
                             ("pp2dp2", dict(pp=2, dp=2), 4)):
        mesh, m = jax_lm(axes, depth, **LM)
        variables = m.init(jax.random.PRNGKey(1), ids)
        with jax.set_mesh(mesh):
            logits = np.asarray(jax.jit(m.apply)(variables, ids))
        out["lm"][tag] = dict(axes=axes, depth=depth, logits=logits,
                              ref=np.asarray(m.reference_apply(variables,
                                                               ids)),
                              weights=pipeline_from_flax(
                                  numpy_tree(variables)))
    cfg = dict(TRAIN)
    depth = cfg.pop("depth")
    mesh, m = jax_lm(dict(pp=2, dp=2), depth, **cfg)
    tr = JaxPipelineTrainer(m, lr=TRAIN_LR)
    batches = [token_batch(i, 8, 12, vocab=32) for i in range(3)]
    tr.init(jax.random.PRNGKey(0), batches[0])
    weights = pipeline_from_flax(numpy_tree(tr.variables))
    out["trainer"] = dict(weights=weights, batches=batches, losses=[
        float(tr.train_step(b)) for b in batches])
    out["causal"] = {}
    for pos in ("learned", "rope"):
        jm = JaxCausal(pos=pos, **CAUSAL)
        v = jax.jit(lambda r: jm.init(r, ids))(jax.random.PRNGKey(2))
        out["causal"][pos] = dict(logits=np.asarray(jm.apply(v, ids)),
                                  weights=from_flax(numpy_tree(v)))
    return out


@pytest.fixture(scope="module")
def ranks(jax_side):
    lm = [(tag, c["axes"], dict(LM, depth=c["depth"]), c["weights"])
          for tag, c in jax_side["lm"].items()]
    t = jax_side["trainer"]
    cfgs = {pos: dict(CAUSAL, pos=pos) for pos in ("learned", "rope")}
    spec = dict(ids=jax_side["ids"], lm=lm,
                trainer=(dict(pp=2, dp=2), TRAIN, t["weights"], t["batches"],
                         TRAIN_LR),
                causal=(dict(pp=2, dp=2), cfgs,
                        {p: c["weights"] for p, c in
                         jax_side["causal"].items()}))
    return R.run(PR.lm_rank, 4, spec)


@pytest.mark.parametrize("tag", ["pp4", "pp2dp2"])
def test_pipelined_lm_over_ranks_equals_jax(jax_side, ranks, tag):
    """(pp, dp) = (4, 1) and (2, 2), 2 layers a stage: the logits over
    ranks equal JAX's pipelined and sequential ones, each rank holding
    its stage's slice only."""
    want = jax_side["lm"][tag]
    got = R.assemble([r[tag] for r in ranks], "logits", ("dp",))
    np.testing.assert_allclose(got, want["logits"], **LOGIT_TOL)
    np.testing.assert_allclose(got, want["ref"], **LOGIT_TOL)
    for r in ranks:
        assert r[tag]["stage"] == (1, 32, 32)


def test_pipeline_trainer_over_ranks_equals_jax(jax_side, ranks):
    """Three AdamW steps at pp=2, dp=2 on every rank: JAX's losses."""
    want = jax_side["trainer"]["losses"]
    for r in ranks:
        np.testing.assert_allclose(r["trainer"], want, rtol=1e-4, atol=1e-4)
    assert want[-1] < want[0]


@pytest.mark.parametrize("pos", ["learned", "rope"])
def test_causal_schedule_over_ranks_equals_jax(jax_side, ranks, pos):
    """``PipelinedCausalLM`` over pp=2, dp=2 ranks: JAX's logits (its
    schedule on one device)."""
    got = R.assemble([r[f"causal-{pos}"] for r in ranks], "logits", ("dp",))
    np.testing.assert_allclose(got, jax_side["causal"][pos]["logits"],
                               **LOGIT_TOL)


def test_one_rank_lm_equals_jax_reference(jax_side):
    """Without a mesh the model is one stage of every block: JAX's
    reference_apply on a pp=1 mesh, from the same weights."""
    mesh, m = jax_lm(dict(pp=1), 2, **LM)
    ids = jax_side["ids"]
    variables = m.init(jax.random.PRNGKey(3), ids)
    tm = PipelinedLM(None, depth=2, device="cpu", **LM)
    load_tree(tm, pipeline_from_flax(numpy_tree(variables)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
        ref = tm.reference_apply(None, ids).numpy()
    want = np.asarray(m.reference_apply(variables, ids))
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    np.testing.assert_allclose(ref, want, **LOGIT_TOL)
    assert tm.num_stages == 1 and tm.layers_per_stage == 2


def test_pipeline_trainer_learns_on_one_rank():
    tm = PipelinedLM(None, device="cpu", seed=0, **TRAIN)
    tr = PipelineTrainer(tm, lr=TRAIN_LR)
    ids = token_batch(0, 8, 12, vocab=32)
    tr.init(ids)
    losses = [float(tr.train_step(ids)) for _ in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert set(tr.variables) == {n for n, _ in tm.named_parameters()}


def test_gpipe_on_one_rank_is_the_stages_in_turn():
    """``gpipe`` with one stage and ``schedule`` with three on one rank:
    each microbatch through every stage in order; the drain's recycled
    inputs are never collected; the gradient reaches the inputs once."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 2, 3, generator=g, requires_grad=True)
    w = torch.randn(3, 3, 3, generator=g)
    y = gpipe(lambda p, a: a @ p["w"], {"w": w[:1]}, x)
    torch.testing.assert_close(y, x @ w[0])
    calls = []

    def stage(s, t, a):
        calls.append((s, t))
        return torch.tanh(a @ w[s])

    y = schedule(stage, x, 3)
    want = torch.tanh(torch.tanh(torch.tanh(x @ w[0]) @ w[1]) @ w[2])
    torch.testing.assert_close(y, want)
    # every stage on every tick, bubbles included (T = M + S - 1)
    assert calls == [(s, t) for t in range(6) for s in range(3)]
    gx, = torch.autograd.grad(y.sum(), x)
    wx, = torch.autograd.grad(want.sum(), x)
    torch.testing.assert_close(gx, wx)


def test_partition_table_and_refusals():
    assert partition_spec("stages.layer_0.query.kernel", 3) == (
        "pp", None, None)
    assert partition_spec("embed.token_embed.embedding", 2) == (None, None)
    mesh = SimpleNamespace(shape={"pp": 2}, coord={"pp": 1})
    assert pp_layout(mesh, 4) == (2, 1, 2, 2)
    with pytest.raises(ValueError, match="do not divide over pp=2"):
        pp_layout(mesh, 3)
    with pytest.raises(ValueError, match="microbatches"):
        PipelinedLM(None, depth=2, device="cpu", **LM)(
            torch.ones(3, 16, dtype=torch.long))
