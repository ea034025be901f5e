"""The port's pipelined causal LM (``kubeml_tpu_torch/models/
gpt_pipeline.py``), on one rank and trained over ``pp`` ranks by
``SPMDTrainer``, against the JAX package's ``kubeml_tpu/models/gpt_pipeline.py`` (the
SPMD job over ``pp`` ranks: ``tests/test_torch_pipeline_job.py``).

The JAX modules run on conftest's host devices; the port's over spawned
gloo ranks on the CPU (``tests/torch_pipeline_ranks.py``), rank ``r``
standing for JAX device ``r``. Weights cross from Flax through
``interop.from_flax``. Tolerances: logits at f32 2e-4 (the JAX suite's
own, ``tests/test_pipeline_engine.py``); f32 trainer losses within 1e-4
and first-step gradients within 1e-5 (absolute and relative: the stages'
and ranks' sums in other orders).
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
import torch_pipeline_ranks as PR
from kubeml_tpu.models.gpt_pipeline import PipelinedCausalLM as JaxPipe
from kubeml_tpu.models.gpt_pipeline import \
    flat_serving_remap as jax_flat_remap
from kubeml_tpu.parallel.mesh import make_mesh as jax_mesh
from kubeml_tpu.parallel.trainer import SPMDTrainer as JaxTrainer
from kubeml_tpu.parallel.trainer import lm_loss as jax_lm_loss
from kubeml_tpu_torch.api.errors import KubeMLError
from kubeml_tpu_torch.api.types import TrainOptions
from kubeml_tpu_torch.interop.from_flax import (from_flax,
                                                from_flax_variables, to_flax)
from kubeml_tpu_torch.models.gpt_pipeline import (PipelinedCausalLM,
                                                  flat_serving_remap)
from kubeml_tpu_torch.models.layers import load_tree
from kubeml_tpu_torch.ops import attention
from kubeml_tpu_torch.ops import flash_attention as fa
from kubeml_tpu_torch.parallel.mesh import make_mesh
from kubeml_tpu_torch.parallel.trainer import SPMDTrainer
from kubeml_tpu_torch.storage.sharded_checkpoint import apply_remap_host
from torch_port_helpers import numpy_tree

VOCAB = 64
CFG = dict(vocab_size=VOCAB, max_len=16, embed_dim=32, depth=4,
           num_heads=4, stages=2, microbatches=4)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
# the world-8 meshes: JAX tests/test_pipeline_engine.py's pp x tp x dp,
# and pp x sp x tp (JAX's pipelined model never shards L; its trainer on
# such a mesh gives the unsharded model's loss)
MESHES = (("dp2pp2tp2", dict(dp=2, pp=2, tp=2)),
          ("pp2sp2tp2", dict(pp=2, sp=2, tp=2)))


def toks(n, l=16, seed=0):
    """JAX tests/test_pipeline_engine.py's rows: a pad column exercises
    the valid mask through the stages."""
    r = np.random.default_rng(seed)
    x = r.integers(1, VOCAB, size=(n, l)).astype(np.int32)
    x[:, -1] = 0
    return x


def jax_pipe(mesh=None, **kw):
    return JaxPipe(**dict(CFG, **kw), mesh=mesh)


def twin(variables, mesh=None, **kw):
    """The port's model with the JAX model's weights (one rank)."""
    tm = PipelinedCausalLM(**dict(CFG, **kw), mesh=mesh, device="cpu")
    return load_tree(tm, from_flax(numpy_tree(variables)))


def _flat(tree, prefix=""):
    out = {}
    for key, child in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        out.update(_flat(child, name) if isinstance(child, dict)
                   else {name: child})
    return out


# --- one rank --------------------------------------------------------------

@pytest.mark.parametrize("pos", ["learned", "rope"])
def test_schedule_equals_jax_apply_and_sequential(pos):
    """One rank runs every stage each tick (JAX's vmap): the logits equal
    JAX's pipelined ``apply`` and its ``sequential_apply``, and the
    port's own sequential oracle."""
    jm = jax_pipe(pos=pos)
    ids = toks(8)
    v = jax.jit(lambda r: jm.init(r, ids))(jax.random.PRNGKey(0))
    tm = twin(v, pos=pos)
    x = torch.from_numpy(ids)
    with torch.no_grad():
        got = tm(x).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, ids)),
                               **LOGIT_TOL)
    np.testing.assert_allclose(got, np.asarray(jm.sequential_apply(v, ids)),
                               **LOGIT_TOL)
    np.testing.assert_allclose(tm.sequential_apply(x).numpy(), got,
                               **LOGIT_TOL)


def test_partition_table_equals_flax_get_partition_spec():
    """``stages.*`` leaves ``("pp", ..., "tp")``, the head and the
    embeddings as the flat model's (JAX
    ``test_partition_specs_put_stages_on_pp``). Flax's ``nn.vmap`` names
    the stage axis ``pp`` only on the leaves ``_part`` annotates; its
    LayerNorms and ``mlp_out`` bias stay unannotated, so JAX places those
    stacks whole on every device. The port keeps each rank's stage slice
    of every stage leaf (what the stage's blocks use), ``pp`` on dim 0."""
    jm = jax_pipe()
    abstract = jax.eval_shape(lambda r: jm.init(r, toks(8)),
                              jax.random.PRNGKey(0))
    specs = _flat(jax.tree.map(tuple, nn.get_partition_spec(abstract),
                               is_leaf=lambda x: isinstance(
                                   x, jax.sharding.PartitionSpec))["params"])
    tm = PipelinedCausalLM(**CFG, device="cpu")
    mine = tm.partition_specs()
    assert set(mine) == set(specs)
    whole = set()
    for name, spec in mine.items():
        want = specs[name] + (None,) * (len(spec) - len(specs[name]))
        if name.startswith("stages.") and want[0] is None:
            whole.add(name.split(".", 2)[2])
            want = ("pp",) + want[1:]
        assert spec == want, name
    assert whole == {"ln1.scale", "ln1.bias", "ln2.scale", "ln2.bias",
                     "mlp_out.bias"}
    assert mine["stages.layer_0.attn.query.kernel"] == ("pp", None, "tp")
    assert mine["stages.layer_1.mlp_in.bias"] == ("pp", "tp")
    assert mine["lm_head.kernel"] == (None, "tp")


def test_spmd_trainer_one_rank_equals_jax(jax_meshes):
    """Three f32 SPMDTrainer steps on one device, every stage on it, from
    JAX's initial weights: JAX's losses (its trainer over 8 devices gives
    the unsharded model's), its eval metrics after them, and the first
    step's gradients ``jax.grad``'s."""
    batches = jax_meshes["batches"]
    tm = twin(jax_meshes["init"])
    tr = SPMDTrainer(tm, make_mesh(devices=["cpu"]), precision="f32")
    tr.init(batches[0])
    got = []
    for i, b in enumerate(batches):
        got.append(float(tr.train_step(b)))
        if i == 0:
            grads = {n: p.grad.numpy().copy()
                     for n, p in tm.named_parameters()}
    want = jax_meshes["dp2pp2tp2"]
    np.testing.assert_allclose(got, want["losses"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tr.eval_metrics(batches[0]), want["eval"],
                               rtol=1e-4, atol=1e-4)
    for name, ref in jax_meshes["grads"].items():
        np.testing.assert_allclose(grads[name], ref, err_msg=name,
                                   **GRAD_TOL)


def _count_flash(monkeypatch):
    """Route the blocks' attention through the flash autograd Function
    (its plain versions on the CPU, the card's structure) and count the
    forward and backward calls, with the forwards' fully masked rows."""
    calls = {"fwd": 0, "bwd": 0, "masked_rows": 0}
    fwd, bwd = fa.flash_attention_fwd_ref, fa.flash_attention_bwd_ref

    def counted_fwd(q, k, v, kv_valid=None, causal=False):
        calls["fwd"] += 1
        calls["masked_rows"] += int((kv_valid.sum(-1) == 0).sum())
        return fwd(q, k, v, kv_valid, causal)

    def counted_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_fwd_ref", counted_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_ref", counted_bwd)
    import kubeml_tpu_torch.models.gpt as gpt

    monkeypatch.setattr(gpt, "dot_product_attention", functools.partial(
        attention.dot_product_attention, impl="cuda"))
    return calls


@pytest.mark.parametrize("remat", [False, True])
def test_bubbles_through_the_flash_path_give_zero_gradient(monkeypatch,
                                                           remat):
    """The fill's bubbles attend with no valid key (the rolled validity
    buffer is all False): through the plain flash versions they give
    exact zeros and zero gradients, no NaN, and the step's gradients equal
    the plain attention path's. Launches follow the schedule: T x depth
    forwards (twice under remat), T x depth backwards, T = M + S - 1."""
    ids = toks(8)
    g = torch.Generator().manual_seed(0)
    tm = PipelinedCausalLM(**CFG, remat=remat, device="cpu", seed=3)

    def grads():
        tm.zero_grad(set_to_none=True)
        out = tm(torch.from_numpy(ids), train=True)
        out.float().square().mean().backward()
        return {n: p.grad.clone() for n, p in tm.named_parameters()}

    want = grads()
    calls = _count_flash(monkeypatch)
    got = grads()
    T = CFG["microbatches"] + CFG["stages"] - 1
    assert calls["fwd"] == T * CFG["depth"] * (2 if remat else 1)
    assert calls["bwd"] == T * CFG["depth"]
    # stage 1's bubble on tick 0: 2 rows x 4 heads x 16 queries, in each
    # of its 2 layers (and again in the recompute under remat)
    assert calls["masked_rows"] == 2 * (2 if remat else 1) * 2
    for name, t in got.items():
        assert torch.isfinite(t).all(), name
        torch.testing.assert_close(t, want[name], atol=1e-5, rtol=1e-5)
    del g
    # the kernels' plain versions on a batch with no valid key at all
    q = torch.randn(2, 16, 4, 8, generator=torch.Generator().manual_seed(1))
    k, v, do = q.flip(1), q * 2, q.flip(2)
    none = torch.zeros(2, 16)
    out, lse = fa.flash_attention_fwd_ref(q, k, v, none, True)
    assert torch.equal(out, torch.zeros_like(out)) and (lse <= -1e29).all()
    dq, dk, dv = fa.flash_attention_bwd_ref(q, k, v, none, out, lse, do,
                                            True)
    for t in (dq, dk, dv):
        assert torch.equal(t, torch.zeros_like(t))


def test_dropout_draws_follow_the_seed():
    """Dropout masks come from explicit generators (per tick, stage and
    layer): the same seed gives the same step, another seed another."""
    ids = torch.from_numpy(toks(8))

    def loss(seed):
        tm = PipelinedCausalLM(**CFG, dropout=0.2, device="cpu", seed=0)
        return float(tm(ids, train=True, rng=seed).detach().square().mean())

    assert loss(7) == loss(7)
    assert loss(7) != loss(8)
    with pytest.raises(ValueError, match="rng"):
        PipelinedCausalLM(**CFG, dropout=0.2, device="cpu")(ids, train=True)


def test_flat_serving_remap_serves_the_flat_model():
    """``flat_serving_remap`` fans the stacked leaves out as JAX's does,
    and the flat ``CausalTransformer`` on the remapped weights computes
    the pipelined model's logits."""
    tm = PipelinedCausalLM(**CFG, device="cpu", seed=5)
    tree = to_flax(dict(tm.named_parameters()))
    for path in ("params/stages/layer_1/attn/query/kernel",
                 "params/ln_f/scale", "params/pos_embed"):
        assert flat_serving_remap(2, 2)(path) == jax_flat_remap(2, 2)(path)
    flat = tm.flat_equivalent()
    load_tree(flat, from_flax(apply_remap_host(tree, flat_serving_remap(
        tm.num_stages, tm.layers_per_stage))))
    ids = torch.from_numpy(toks(8))
    with torch.no_grad():
        torch.testing.assert_close(flat(ids), tm(ids), atol=2e-5, rtol=2e-5)


def test_stacked_leaves_cross_the_converters():
    """``to_flax``/``from_flax`` carry the stacked ``[S, ...]`` leaves
    unchanged, and ``from_flax_variables`` without a module never takes a
    stacked leaf for a conv kernel, even a 4-D one."""
    tm = PipelinedCausalLM(**CFG, device="cpu")
    named = dict(tm.named_parameters())
    back = from_flax(to_flax(named))
    assert set(back) == set(named)
    for name, t in named.items():
        torch.testing.assert_close(back[name], t.detach())
    stacked4 = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    got = from_flax_variables({"params": {"stages": {"layer_0": {
        "qkv": {"kernel": stacked4}}}, "conv": {"kernel": stacked4}}})
    np.testing.assert_array_equal(
        got["params"]["stages.layer_0.qkv.kernel"].numpy(), stacked4)
    assert got["params"]["conv.kernel"].shape == (5, 4, 2, 3)


def test_meshes_take_pp_and_refuse_ep():
    """A pp axis, and an ep axis (MoE expert sharding) beside it, need the
    process group as every axis does, and an SPMD job takes both on a
    cluster they fit; ep is refused where it still stands, a cluster it
    does not fit, and a K-AVG job takes it (K-AVG reads only the worker
    axis, as in JAX)."""
    for axes in ({"pp": 2}, {"pp": 2, "ep": 2}):
        with pytest.raises(RuntimeError, match="init_distributed"):
            make_mesh(axes, devices=["cpu"] * 2 ** len(axes))
    TrainOptions(engine="spmd", mesh_shape={"pp": 2, "tp": 2}).check_ported(4)
    TrainOptions(engine="spmd", mesh_shape={"ep": 2}).check_ported(2)
    TrainOptions(engine="spmd", mesh_shape={"pp": 2, "ep": 2}).check_ported(4)
    TrainOptions(mesh_shape={"ep": 2}).check_ported(1)
    for opts, world, words in (
            (TrainOptions(engine="spmd", mesh_shape={"ep": 2}), 1,
             "does not fit a cluster of 1"),):
        with pytest.raises(KubeMLError, match=words) as e:
            opts.check_ported(world)
        assert e.value.status_code == 400


# --- over ranks: SPMDTrainer ----------------------------------------------

@pytest.fixture(scope="module")
def jax_meshes():
    """JAX's SPMDTrainer on the 8 host devices over each of MESHES: the
    initial weights, three steps' losses, the eval metrics after them,
    and ``jax.grad`` of the first batch's loss on the unsharded model."""
    batches = [toks(8, seed=i) for i in range(3)]
    out = {"batches": batches}
    for tag, axes in MESHES:
        mesh = jax_mesh(**axes)
        tr = JaxTrainer(jax_pipe(mesh=mesh), mesh, precision="f32")
        tr.init(jax.random.PRNGKey(0), batches[0])
        if "init" not in out:
            out["init"] = jax.tree.map(lambda x: np.array(x, copy=True),
                                       numpy_tree(tr.params))
        out[tag] = dict(
            losses=[float(tr.train_step(b, jax.random.PRNGKey(i)))
                    for i, b in enumerate(batches)],
            eval=tr.eval_metrics(batches[0]))
    free = jax_pipe()
    grads = jax.grad(lambda p: jax_lm_loss(
        free.apply({"params": p}, jnp.asarray(batches[0])),
        jnp.asarray(batches[0])))(out["init"]["params"])
    out["grads"] = _flat(jax.tree.map(np.asarray, grads))
    return out


@pytest.fixture(scope="module")
def trainer_ranks(jax_meshes):
    return R.run(PR.trainer_rank, 8, dict(
        meshes=MESHES, cfg=CFG, weights=from_flax(jax_meshes["init"]),
        batches=jax_meshes["batches"]))


@pytest.mark.parametrize("tag", [t for t, _ in MESHES])
def test_three_steps_over_8_ranks_equal_jax(jax_meshes, trainer_ranks, tag):
    """pp x tp x dp and pp x sp x tp: every rank's losses and eval metrics
    within 1e-4 of JAX's SPMDTrainer on the same mesh of host devices,
    each rank holding one stage's tp half."""
    want = jax_meshes[tag]
    for res in trainer_ranks:
        r = res[tag]
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(r["eval"], want["eval"], rtol=1e-4,
                                   atol=1e-4)
        assert r["stage"] == (1, 32, 16)
    assert want["losses"][-1] < want["losses"][0]


@pytest.mark.parametrize("tag", [t for t, _ in MESHES])
def test_first_step_gradients_equal_jax_grad(jax_meshes, trainer_ranks,
                                             tag):
    """Every leaf's first-step gradient, gathered whole over pp and tp:
    ``jax.grad`` of the unsharded loss. The stage stack is summed over
    dp x sp only, the replicated embeddings and head hold their whole
    gradient once (the pp f/g pair), nothing counted per stage."""
    got = trainer_ranks[0][tag]["grads"]
    want = jax_meshes["grads"]
    assert set(got) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("tag", [t for t, _ in MESHES])
def test_replicated_leaves_stay_bit_equal_over_pp(trainer_ranks, tag):
    """After three steps the leaves replicated over pp (embeddings, ln_f,
    lm_head) are bit-equal on every rank of a tp coordinate."""
    by_tp = {}
    for res in trainer_ranks:
        r = res[tag]
        by_tp.setdefault(r["coord"]["tp"], set()).add(r["digest"])
    assert len(by_tp) == 2
    assert all(len(d) == 1 for d in by_tp.values()), by_tp
