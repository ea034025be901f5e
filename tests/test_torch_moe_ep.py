"""The port's MoE over a mesh of ranks (``parallel/moe.py`` with the
``ep`` axis, the MoE blocks of ``models/gpt.py`` under dp, sp, ep and tp)
against the JAX package's GSPMD semantics on its 8 host devices.

JAX's ``MoEMlp`` runs under GSPMD outside any ``shard_map``: its capacity
``int(S / E * cf)``, its queue ``cumsum`` and its aux loss read the GLOBAL
batch, whatever mesh shards it. The port's ranks hold blocks of it, so
each must compute those global quantities from its own block and the
other ranks' counts. Held here, over world-8 gloo ranks from carried
weights (``interop.from_flax.shard_tree``), for ``MoETransformer`` at
embed 64, depth 2, 4 heads, 4 experts (block 1 is the MoE block):

- on ``dp=2, ep=2, tp=2`` (JAX's own test mesh, ``tests/test_pipeline_
  moe.py``) and ``dp=2, sp=2, ep=2`` with Ulysses and with the ring: the
  gathered logits equal JAX's on the same mesh at 2e-4 (the JAX suite's
  tolerance); one f32 ``SPMDTrainer`` step with the router noise off (the
  deterministic forward JAX computes at ``train=False``): its loss,
  the aux loss included, at 1e-5 and the overflow equal to JAX's, and
  every gradient, gathered over ep and tp, against ``jax.grad`` at 1e-5
  (a gradient summed twice over ep, or left partial, is off by a factor);
- the capacity trap: a ``MoEMlp`` (E 4, top-2, capacity factor 0.5) whose
  routing overflows, over ``dp=2`` and over ``sp=2`` (ranks 0 and 1 of the
  world), equals JAX's global forward at 1e-5, its aux and overflow too,
  while the per-rank capacity (each block routed alone, as a rank-local
  ``cumsum`` would) differs from it, which the test computes and shows;
- the partition table of a MoE model equals ``flax.linen.get_partition_
  spec`` of the JAX one (the expert stacks ``("ep", None, "tp")`` and
  ``("ep", "tp", None)``, the router whole), and ``mesh_shape_for`` with
  ``ep`` equals JAX's.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks as R
import torch_moe_ranks as M
from kubeml_tpu.models.gpt import CausalTransformer as JaxTransformer
from kubeml_tpu.parallel.mesh import make_mesh
from kubeml_tpu.parallel.mesh import mesh_shape_for as jax_mesh_shape_for
from kubeml_tpu.parallel.moe import MoEMlp as JaxMoEMlp
from kubeml_tpu.parallel.trainer import lm_loss as jax_lm_loss
from kubeml_tpu_torch.interop.from_flax import from_flax
from kubeml_tpu_torch.models.gpt import CausalTransformer
from kubeml_tpu_torch.parallel.mesh import mesh_shape_for
from torch_port_helpers import numpy_tree

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=2e-4)
CFG = dict(vocab_size=64, max_len=16, embed_dim=64, depth=2, num_heads=4,
           moe_every=2, num_experts=4)
MESHES = [("dp2 ep2 tp2", dict(dp=2, ep=2, tp=2), "ring"),
          ("dp2 sp2 ep2 ulysses", dict(dp=2, sp=2, ep=2), "ulysses"),
          ("dp2 sp2 ep2 ring", dict(dp=2, sp=2, ep=2), "ring")]
TRAP_CFG = dict(num_experts=4, top_k=2, capacity_factor=0.5)
TRAP = [("trap dp2", {"dp": 2}), ("trap sp2", {"sp": 2})]


def _ids():
    """JAX ``tests/test_pipeline_moe.py``'s token batch: [4, 16], the last
    two positions padding."""
    ids = np.random.default_rng(0).integers(1, 64, size=(4, 16)).astype(
        np.int32)
    ids[:, -2:] = 0
    return ids


def _trap_x():
    return np.random.default_rng(1).normal(size=(4, 8, 16)).astype(
        np.float32)


def _flat(tree, prefix=""):
    out = {}
    for key, child in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        out.update(_flat(child, name) if isinstance(child, dict)
                   else {name: child})
    return out


def _sown(variables, module, x, **kw):
    out, sown = module.apply(variables, x, mutable=["aux_loss", "moe_stats"],
                             **kw)
    aux = sum(jnp.sum(a) for a in jax.tree.leaves(sown["aux_loss"]))
    stats = jax.tree.leaves(sown["moe_stats"])
    return out, aux, sum(jnp.mean(s) for s in stats) / len(stats)


@pytest.fixture(scope="module")
def jax_side():
    """JAX: the MoE LM's logits on each mesh, its loss (aux included) and
    overflow at train=False and ``jax.grad`` of that loss; the trap's
    global forward and its per-rank-capacity twin."""
    ids = jnp.asarray(_ids())
    plain = JaxTransformer(**CFG)
    variables = plain.init(jax.random.PRNGKey(0), ids, train=False)
    logits = {}
    for tag, axes, impl in MESHES:
        mesh = make_mesh(**axes)
        m = JaxTransformer(mesh=mesh, sp_impl=impl, **CFG)
        with jax.set_mesh(mesh):
            logits[tag] = np.asarray(jax.jit(
                lambda v, x: m.apply(v, x, train=False))(variables, ids))
    params = numpy_tree(variables)["params"]

    def loss_fn(p):
        out, aux, _ = _sown({"params": p}, plain, ids, train=False)
        return jax_lm_loss(out, ids) + aux

    loss = float(loss_fn(params))
    grads = jax.grad(loss_fn)(jax.tree.map(jnp.asarray, params))
    _, aux, over = _sown(variables, plain, ids, train=False)
    x = jnp.asarray(_trap_x())
    mlp = JaxMoEMlp(**TRAP_CFG)
    mvars = mlp.init(jax.random.PRNGKey(2), x)
    trap, trap_aux, trap_over = _sown(mvars, mlp, x)
    # each rank's block routed alone: capacity and cumsum of the block
    local = {"trap dp2": np.concatenate(
        [np.asarray(mlp.apply(mvars, x[i:i + 2])) for i in (0, 2)], 0),
        "trap sp2": np.concatenate(
            [np.asarray(mlp.apply(mvars, x[:, i:i + 4])) for i in (0, 4)],
            1)}
    return dict(weights=from_flax(numpy_tree(variables)), logits=logits,
                loss=loss, over=float(over),
                grads=_flat(jax.tree.map(np.asarray, grads)),
                trap=np.asarray(trap), trap_aux=float(trap_aux),
                trap_over=float(trap_over), trap_local=local,
                trap_weights=numpy_tree(mvars)["params"])


@pytest.fixture(scope="module")
def ranks(jax_side):
    spec = dict(ids=_ids(), cfg=CFG, weights=jax_side["weights"],
                meshes=MESHES, trap=TRAP, trap_cfg=dict(embed_dim=16,
                                                        **TRAP_CFG),
                trap_weights=jax_side["trap_weights"], trap_x=_trap_x())
    return R.run(M.model_rank, 8, spec)


@pytest.mark.parametrize("tag", [m[0] for m in MESHES])
def test_gathered_logits_equal_jax_on_the_same_mesh(jax_side, ranks, tag):
    parts = [dict(r[tag], out=r[tag]["logits"]) for r in ranks]
    got = R.assemble(parts, "out")
    assert got.shape == (4, 16, 64)
    np.testing.assert_allclose(got, jax_side["logits"][tag], **LOGIT_TOL)


@pytest.mark.parametrize("tag", [m[0] for m in MESHES])
def test_loss_aux_overflow_and_gradients_equal_jax(jax_side, ranks, tag):
    """The global loss, the global overflow and every whole gradient on
    every rank: the router and the other ep-replicated leaves through the
    f/g pair once, the expert stacks gathered over ep and tp."""
    want = jax_side["grads"]
    assert 0.0 < jax_side["over"] < 1.0  # capacity 20 of 64 x 2 asked
    for res in ranks:
        got = res[tag]
        np.testing.assert_allclose(got["loss"], jax_side["loss"], **TOL)
        assert got["overflow"] == pytest.approx(jax_side["over"], abs=1e-7)
        assert set(got["grads"]) == set(want)
        for name, ref in want.items():
            np.testing.assert_allclose(got["grads"][name], ref,
                                       err_msg=f"{tag} {name}", **TOL)
    # really expert-parallel: each rank holds 2 of the 4 experts and, under
    # tp, half their hidden width
    shards = ranks[0][tag]["shards"]
    tp = dict(MESHES[[m[0] for m in MESHES].index(tag)][1]).get("tp", 1)
    assert shards["block_1.moe.w_in"] == (2, 64, 256 // tp)
    assert shards["block_1.moe.w_out"] == (2, 256 // tp, 64)
    assert shards["block_1.moe.router"] == (64, 4)


@pytest.mark.parametrize("tag", [t[0] for t in TRAP])
def test_capacity_is_global_over_dp_and_sp(jax_side, ranks, tag):
    """cf 0.5 drops most assignments: capacity 4 over the global 32
    tokens (2 a block of 16 under a rank-local rule). The ranks' outputs equal
    JAX's global forward; routing each block alone does not."""
    parts = [r[tag] for r in ranks[:2]]
    axis = "dp" if "dp" in tag else "sp"
    got = R.assemble(parts, "out", axes=("dp", "sp"))
    want = jax_side["trap"]
    assert jax_side["trap_over"] > 0.5
    np.testing.assert_allclose(got, want, **TOL)
    for res in parts:
        np.testing.assert_allclose(res["aux"], jax_side["trap_aux"], **TOL)
        assert res["overflow"] == pytest.approx(jax_side["trap_over"],
                                                abs=1e-7)
        assert res["shape"][axis] == 2
    local = jax_side["trap_local"][tag]
    assert np.abs(local - want).max() > 0.1, np.abs(local - want).max()
    assert all("trap dp2" not in r for r in ranks[2:])


def test_partition_table_equals_flax_get_partition_spec():
    jm = JaxTransformer(**CFG)
    abstract = jax.eval_shape(lambda r: jm.init(r, jnp.zeros((1, 8),
                                                             jnp.int32)),
                              jax.random.PRNGKey(0))
    specs = _flat(jax.tree.map(tuple, nn.get_partition_spec(abstract),
                               is_leaf=lambda x: isinstance(
                                   x, jax.sharding.PartitionSpec))["params"])
    port = CausalTransformer(device="cpu", **CFG).partition_specs()
    assert set(port) == set(specs)
    for name, spec in port.items():
        padded = tuple(specs[name]) + (None,) * (len(spec)
                                                 - len(specs[name]))
        assert spec == padded, name
    assert port["block_1.moe.w_in"] == ("ep", None, "tp")
    assert port["block_1.moe.w_out"] == ("ep", "tp", None)
    assert port["block_1.moe.router"] == (None, None)
    for n, req in ((8, dict(ep=2)), (8, dict(ep=2, tp=2)),
                   (8, dict(sp=2, ep=2)), (4, dict(ep=4))):
        assert mesh_shape_for(n, **req) == jax_mesh_shape_for(n, **req)
