"""The tensor- and sequence-parallel GPT and ``SPMDTrainer`` of the port
over spawned gloo ranks (``dp=2, sp=2, tp=2``, world 8 on the CPU) against
the JAX package on the same mesh of its 8 host devices, from carried
weights (``interop.from_flax.shard_tree``):

- the gathered logits of ``GPTTiny`` (ring) and of ``CausalTransformer
  (embed 64, depth 2, heads 4, sp_impl="ulysses")`` equal JAX's at 2e-4,
  the JAX suite's own tolerance (``tests/test_parallel.py``);
- three f32 ``SPMDTrainer`` steps: the losses at 1e-5 (f32 both sides,
  summed in other orders); the first step's gradients, gathered over tp,
  equal ``jax.grad`` of the loss at 1e-5 absolute and relative (a
  gradient summed twice over tp, or not summed over dp x sp, is off by a
  factor); the final parameters' movement within 1e-5 of JAX's but for
  Adam's sign flips of near-zero gradients (at most 0.1 % of the entries,
  each within 2 x lr a step; see ``tests/test_torch_trainer.py``); the
  eval metrics before and after at 1e-5;
- the shard shapes (JAX ``tests/test_parallel.py:187-190``), the chunked
  loss under tp (``logits_chunk=5``) and an input transform at 1e-5, and
  one step on ``dp=8`` (its loss is the first step's);
- the port's partition table equals ``flax.linen.get_partition_spec`` of
  the JAX module;
- decode, decode under sp and MoE over a mesh of several ranks raise,
  each naming its later ROADMAP item or JAX's message, and a training job
  whose mesh does not fit the cluster's ranks is a 400;
- ``chip_smoke.py``'s check of 17b (gradient norms by leaf against one
  rank's within ``MR_GRAD_RTOL``, the ranks' whole parameters bit-equal)
  passes sound world-2 meshes in bf16 and fails planted faults: a gradient
  summed twice over tp (which leaves the losses within ``MR_LOSS_ATOL``)
  and a dropped dp x sp all-reduce."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from kubeml_tpu.models.gpt import CausalTransformer as JaxTransformer
from kubeml_tpu.models.gpt import GPTTiny as JaxTiny
from kubeml_tpu.parallel.mesh import make_mesh
from kubeml_tpu.parallel.trainer import SPMDTrainer as JaxTrainer
from kubeml_tpu.parallel.trainer import lm_loss as jax_lm_loss
from kubeml_tpu_torch.api.errors import KubeMLError
from kubeml_tpu_torch.api.types import TrainOptions
from kubeml_tpu_torch.interop.from_flax import from_flax
from kubeml_tpu_torch.models.gpt import CausalTransformer
from torch_port_helpers import numpy_tree

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=2e-4)
ADAM_LR = 3e-4
LOGIT_CFG = dict(vocab_size=50, max_len=16, embed_dim=64, depth=2,
                 num_heads=4)
TRAIN_CFG = dict(vocab_size=100, max_len=32, embed_dim=64, depth=2,
                 num_heads=4)


def _ids():
    r = np.random.default_rng(0)
    return np.concatenate([r.integers(1, 50, size=(4, 12)),
                           np.zeros((4, 4), int)], axis=1).astype(np.int32)


def _batches():
    r = np.random.default_rng(0)
    out = []
    for _ in range(3):
        b = r.integers(1, 100, size=(8, 32)).astype(np.int32)
        b[-1, -5:] = 0  # padding: masked as keys and as targets
        out.append(b)
    return out


def _flat(tree, prefix=""):
    out = {}
    for key, child in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        out.update(_flat(child, name) if isinstance(child, dict)
                   else {name: child})
    return out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package on the dp=2, sp=2, tp=2 mesh: the logits of both
    models, three trainer steps, the first step's gradient, the eval
    metrics and an input transform's eval loss."""
    mesh = make_mesh(dp=2, sp=2, tp=2)
    ids = jnp.asarray(_ids())
    plain = JaxTransformer(**LOGIT_CFG)
    lvars = plain.init(jax.random.PRNGKey(0), ids, train=False)
    logits = {}
    for tag, impl in (("ring", "ring"), ("ulysses", "ulysses")):
        m = JaxTransformer(mesh=mesh, sp_impl=impl, **LOGIT_CFG)
        with jax.set_mesh(mesh):
            logits[tag] = np.asarray(jax.jit(
                lambda v, x: m.apply(v, x, train=False))(lvars, ids))
    bs = _batches()
    tr = JaxTrainer(JaxTiny(vocab_size=100, max_len=32, mesh=mesh), mesh,
                    precision="f32")
    tr.init(jax.random.PRNGKey(0), bs[0])
    init = numpy_tree(tr.params)
    init = jax.tree.map(lambda x: np.array(x, copy=True), init)
    eval0 = tr.eval_metrics(bs[0])
    losses = [float(tr.train_step(b, jax.random.PRNGKey(i)))
              for i, b in enumerate(bs)]
    eval3 = tr.eval_metrics(bs[0])
    final = _flat(numpy_tree(tr.params)["params"])
    free = JaxTiny(vocab_size=100, max_len=32)
    grads = jax.grad(lambda p: jax_lm_loss(
        free.apply({"params": p}, jnp.asarray(bs[0]), train=False),
        jnp.asarray(bs[0])))(init["params"])
    shifted = JaxTrainer(JaxTiny(vocab_size=100, max_len=32, mesh=mesh), mesh,
                         precision="f32",
                         input_transform=lambda x: jnp.where(x > 0, 1, 0))
    shifted.init(jax.random.PRNGKey(0), bs[0])
    return dict(lvars=numpy_tree(lvars), logits=logits, init=init,
                losses=losses, eval0=eval0, eval3=eval3, final=final,
                grads=_flat(jax.tree.map(np.asarray, grads)),
                transform_eval=shifted.eval_loss(bs[0]))


@pytest.fixture(scope="module")
def ranks(jax_side):
    cfg = dict(TRAIN_CFG)
    spec = dict(ids=_ids(),
                logits={"ring": dict(LOGIT_CFG, sp_impl="ring"),
                        "ulysses": dict(LOGIT_CFG, sp_impl="ulysses")},
                logit_weights=from_flax(jax_side["lvars"]),
                train_cfg=cfg, train_weights=from_flax(jax_side["init"]),
                batches=_batches())
    return R.run(R.gpt_rank, 8, spec)


@pytest.mark.parametrize("tag", ["ring", "ulysses"])
def test_gathered_logits_equal_jax_on_the_same_mesh(jax_side, ranks, tag):
    got = R.assemble(ranks, tag)
    assert got.shape == (4, 16, 50)
    np.testing.assert_allclose(got, jax_side["logits"][tag], **LOGIT_TOL)


def test_three_steps_equal_the_jax_trainer(jax_side, ranks):
    start = _flat(jax_side["init"]["params"])
    for res in ranks:
        np.testing.assert_allclose(res["losses"], jax_side["losses"], **TOL)
        np.testing.assert_allclose(res["eval"], jax_side["eval3"], **TOL)
    flips = entries = 0
    for name, want in jax_side["final"].items():
        got = ranks[0]["final"][name]
        assert all(np.array_equal(r["final"][name], got) for r in ranks[1:])
        off = np.abs((got - start[name]) - (want - start[name]))
        assert off.max() <= 3 * 2 * ADAM_LR, name
        flips += int((off > 1e-5).sum())
        entries += off.size
    assert flips <= entries // 1000, f"{flips} of {entries} entries"


def test_first_step_gradients_equal_jax_grad(jax_side, ranks):
    """Every parameter's gradient, whole: the tp-replicated LayerNorms and
    biases through the f/g pair once, everything summed over dp x sp."""
    want = jax_side["grads"]
    for res in ranks:
        assert set(res["grads"]) == set(want)
        for name, ref in want.items():
            np.testing.assert_allclose(res["grads"][name], ref,
                                       err_msg=name, **TOL)


def test_tp_shards_chunked_loss_transform_and_dp8(jax_side, ranks):
    full = {n: v.shape for n, v in _flat(jax_side["init"]["params"]).items()}
    shards = ranks[0]["shards"]
    # really tensor-parallel: each tp shard holds half the columns
    assert shards["block_0.mlp_in.kernel"] == (64, 128)
    assert full["block_0.mlp_in.kernel"] == (64, 256)
    assert shards["block_0.attn.proj.kernel"] == (32, 64)
    assert shards["lm_head.kernel"] == (64, 50)
    assert shards["token_embed.embedding"] == (100, 32)
    assert shards["pos_embed"] == (1, 32, 32)
    assert shards["block_0.ln1.scale"] == full["block_0.ln1.scale"]
    for res in ranks:
        np.testing.assert_allclose(res["chunked_loss"],
                                   jax_side["losses"][0], **TOL)
        np.testing.assert_allclose(res["chunked_eval"], jax_side["eval0"],
                                   **TOL)
        np.testing.assert_allclose(res["transform_eval"],
                                   jax_side["transform_eval"], **TOL)
        assert abs(res["transform_eval"] - jax_side["eval0"][0]) > 1e-6
        np.testing.assert_allclose(res["dp8_loss"], jax_side["losses"][0],
                                   **TOL)


def test_partition_table_equals_flax_get_partition_spec():
    jm = JaxTiny(vocab_size=100, max_len=32)
    abstract = jax.eval_shape(lambda r: jm.init(r, jnp.zeros((1, 8),
                                                             jnp.int32)),
                              jax.random.PRNGKey(0))
    specs = _flat(jax.tree.map(tuple, nn.get_partition_spec(abstract),
                               is_leaf=lambda x: isinstance(
                                   x, jax.sharding.PartitionSpec))["params"])
    port = CausalTransformer(device="cpu", **TRAIN_CFG).partition_specs()
    assert set(port) == set(specs)
    for name, spec in port.items():
        padded = tuple(specs[name]) + (None,) * (len(spec)
                                                 - len(specs[name]))
        assert spec == padded, name


def test_mesh_refusals_name_their_later_items(ranks):
    for res in ranks:
        r = res["refusals"]
        assert r["decode_sp"] == ("ValueError: decode does not run under "
                                  "sequence parallelism; use an sp=1 mesh "
                                  "for serving")
        assert r["decode"].startswith("NotImplementedError")
        assert "meshed serving" in r["decode"] and "ROADMAP" in r["decode"]
        assert "MoE expert sharding over ep" in r["moe"]
    # a job over ranks runs now (the SPMD job over ranks): an sp=2 mesh is
    # refused on one rank and accepted on a cluster of two, pp still
    # refused with its item
    with pytest.raises(KubeMLError, match="does not fit a cluster of 1") as e:
        TrainOptions(engine="spmd", mesh_shape={"sp": 2}).check_ported()
    assert e.value.status_code == 400
    TrainOptions(engine="spmd", mesh_shape={"sp": 2}).check_ported(2)
    with pytest.raises(KubeMLError, match="the pipeline") as e:
        TrainOptions(engine="spmd", mesh_shape={"pp": 2}).check_ported(2)
    assert e.value.status_code == 400
    TrainOptions(engine="spmd", mesh_shape={"sp": 1, "tp": 1}).check_ported()


PLANTED_MODEL = dict(vocab_size=128, max_len=32, embed_dim=32, depth=2,
                     num_heads=4, remat=True, dtype=torch.bfloat16)


def test_chip_gradient_check_sees_planted_faults():
    import chip_smoke as cs
    from kubeml_tpu_torch.parallel.mesh import make_mesh as torch_mesh
    from kubeml_tpu_torch.parallel.trainer import SPMDTrainer

    tokens = np.random.default_rng(0).integers(1, 128, size=(4, 32)).astype(
        np.int32)
    one = SPMDTrainer(CausalTransformer(seed=0, device="cpu",
                                        **PLANTED_MODEL),
                      torch_mesh(devices=["cpu"]), precision="bf16")
    one.init(tokens)
    ref = [float(one.train_step(tokens))]
    ref_norms = cs.grad_norms(one)
    ref += [float(one.train_step(tokens)) for _ in range(cs.MR_STEPS - 1)]
    cases = [({"tp": 2}, "ring", None), ({"tp": 2}, "ring", "tp_double"),
             ({"dp": 2}, "ring", None), ({"dp": 2}, "ring", "no_reduce"),
             ({"sp": 2}, "ulysses", None), ({"sp": 2}, "ring", "no_reduce")]
    got = R.run(R.planted_rank, 2, dict(cases=cases, tokens=tokens,
                                        model=PLANTED_MODEL))
    replicated = [n for n, s in one.module.partition_specs().items()
                  if "tp" not in s]
    for axes, impl, fault in cases:
        key = (tuple(axes.items()), impl, fault)
        errs = cs.grad_errors(got[0][key]["norms"], ref_norms)
        assert set(errs) == set(ref_norms), key
        equal = got[0][key]["digest"] == got[1][key]["digest"]
        loss_off = max(abs(a - b) for a, b in zip(got[0][key]["losses"],
                                                  ref))
        if fault is None:
            assert max(errs.values()) <= cs.MR_GRAD_RTOL, (key, errs)
            assert equal and loss_off <= cs.MR_LOSS_ATOL, key
        elif fault == "tp_double":
            # twice the gradient on every tp-replicated leaf, the rest
            # sound; AdamW's losses do not show it
            for n, e in errs.items():
                if n in replicated:
                    assert abs(e - 1.0) < 0.05, (n, e)
                else:
                    assert e <= cs.MR_GRAD_RTOL, (n, e)
            assert loss_off <= cs.MR_LOSS_ATOL, key
        else:
            assert min(errs.values()) > cs.MR_GRAD_RTOL, (key, errs)
            assert not equal, key
