"""The port's MoE (``parallel/moe.py``) against the JAX ``MoEMlp`` and
``MoETransformer`` with the same weights, and ``SPMDTrainer`` on MoETiny.

Tolerance: outputs, aux loss and gradients atol/rtol 1e-5 (f32; the
frameworks sum in other orders); overflow and per-token routing choices
equal. A token whose k-th and (k+1)-th gates lie within 1e-5 would be a
near tie whose choice may legitimately differ: such tokens are counted and
reported by the choice test, and at these seeds there are none.

Router noise cannot match JAX's threefry draws; its rules are held
instead: drawn only in training, from the caller's seed (the same seed
draws the same noise, another seed other noise), 1e-2 x N(0, 1) on the
router logits, and training without an rng raises as JAX's missing
``dropout`` rng does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kubeml_tpu.parallel.mesh import mesh_shape_for as jax_mesh_shape_for
from kubeml_tpu.parallel.mesh import parse_mesh_spec as jax_parse
from kubeml_tpu.parallel.moe import MoEMlp as JaxMoEMlp
from kubeml_tpu.parallel.moe import MoETransformer as JaxMoE
from kubeml_tpu.serving.quant import quantize_tree as jax_quantize_tree
from kubeml_tpu_torch.interop.from_flax import from_flax, to_flax
from kubeml_tpu_torch.models.gpt import CausalTransformer
from kubeml_tpu_torch.models.layers import load_tree
from kubeml_tpu_torch.parallel.mesh import (Mesh, make_mesh, mesh_shape_for,
                                            parse_mesh_spec)
from kubeml_tpu_torch.parallel.moe import MoEMlp, MoETiny, MoETransformer
from kubeml_tpu_torch.parallel.trainer import SPMDTrainer
from kubeml_tpu_torch.serving.quant import QuantizedTensor, quantize_tree
from torch_port_helpers import VOCAB, jax_init, numpy_tree

TOL = dict(atol=1e-5, rtol=1e-5)
D, E = 16, 4


def jax_mlp(cf=1.25, top_k=2):
    return JaxMoEMlp(num_experts=E, top_k=top_k, capacity_factor=cf)


def pair_mlp(x, cf=1.25, top_k=2, seed=0):
    jm = jax_mlp(cf, top_k)
    variables = jm.init(jax.random.PRNGKey(seed), x)
    params = numpy_tree(variables)["params"]
    tm = MoEMlp(D, E, top_k=top_k, capacity_factor=cf)
    with torch.no_grad():
        for name, v in params.items():
            getattr(tm, name).copy_(torch.from_numpy(v))
    return jm, variables, tm


def inputs(B=2, L=12, seed=0):
    return np.random.default_rng(seed).normal(size=(B, L, D)).astype(
        np.float32)


def jax_sown(jm, variables, x, **kw):
    out, sown = jm.apply(variables, x, mutable=["aux_loss", "moe_stats"],
                         **kw)
    aux = float(jax.tree.leaves(sown["aux_loss"])[0])
    over = float(jax.tree.leaves(sown["moe_stats"])[0])
    return np.asarray(out), aux, over


@pytest.mark.parametrize("cf,top_k", [(1.25, 2), (2.0, 1), (4.0, 2)])
def test_capped_forward_aux_and_overflow_match_jax(cf, top_k):
    x = inputs()
    jm, variables, tm = pair_mlp(x, cf, top_k)
    ref, aux, over = jax_sown(jm, variables, x)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(float(tm.last_aux), aux, **TOL)
    assert float(tm.last_overflow) == pytest.approx(over, abs=1e-7)
    assert tm.capacity(x.shape[0] * x.shape[1]) == max(
        1, int((24 / E) * cf))  # floor, not the docstring's ceil


def test_overflow_case_drops_assignments_like_jax():
    """A capacity small enough that queue positions run past it: the
    dropped assignments' one-hot slot rows are zero (jax.nn.one_hot of an
    out-of-range index), the overflow is positive, outputs still match."""
    x = inputs(B=3, L=16, seed=4)
    jm, variables, tm = pair_mlp(x, cf=0.5)
    ref, aux, over = jax_sown(jm, variables, x)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert over > 0.5  # most assignments dropped at cap 6 of 48 tokens
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(float(tm.last_aux), aux, **TOL)
    assert float(tm.last_overflow) == pytest.approx(over, abs=1e-7)
    # tokens routed nowhere fall through (zero output rows), as in JAX
    zero_rows = np.all(np.abs(ref.reshape(-1, D)) < 1e-12, axis=-1)
    assert zero_rows.any()
    np.testing.assert_array_equal(
        np.all(np.abs(out.numpy().reshape(-1, D)) < 1e-12, axis=-1),
        zero_rows)


def test_routing_choices_match_jax():
    """Per-token top-k expert choices from the JAX router (f32 gates) and
    the port's are equal; near ties (k-th and (k+1)-th gates within 1e-5)
    are counted, and none occurs here."""
    x = inputs(B=4, L=16, seed=2)
    jm, variables, tm = pair_mlp(x)
    router = numpy_tree(variables)["params"]["router"]
    jg = np.asarray(jax.nn.softmax(jnp.asarray(x.reshape(-1, D))
                                   @ jnp.asarray(router), axis=-1))
    with torch.no_grad():
        tg = torch.softmax(torch.from_numpy(x.reshape(-1, D))
                           @ tm.router, dim=-1).numpy()
    np.testing.assert_allclose(tg, jg, **TOL)
    srt = np.sort(jg, axis=-1)
    ties = int((srt[:, -2] - srt[:, -3] < 1e-5).sum())
    assert ties == 0, f"{ties} near ties"
    jtop = np.argsort(-jg, axis=-1, kind="stable")[:, :2]
    ttop = torch.topk(torch.from_numpy(tg), 2, dim=-1).indices.numpy()
    np.testing.assert_array_equal(ttop, jtop)


def test_decode_path_matches_jax():
    """The uncapped serving path: every expert on every token, gates kept
    where they reach the k-th largest, renormalised."""
    x = inputs(B=3, L=5, seed=5)
    jm, variables, tm = pair_mlp(x)
    ref = np.asarray(jm.apply(variables, x, decode=True))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), decode=True)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert tm.last_aux is None  # the decode path records nothing


def test_decode_tie_keeps_more_than_top_k():
    """Equal gates (a zero router): ``gates >= kth`` keeps every expert,
    as the JAX decode path does."""
    x = inputs(B=1, L=3, seed=6)
    jm, variables, tm = pair_mlp(x)
    params = numpy_tree(variables)["params"]
    params["router"] = np.zeros_like(params["router"])
    with torch.no_grad():
        tm.router.zero_()
        out = tm(torch.from_numpy(x), decode=True)
    ref = np.asarray(jm.apply({"params": params}, x, decode=True))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_gradients_match_jax_grad():
    """d(sum(out * w) + aux) for the input and every weight, at
    train=False (no noise): autograd through the gate values, the
    renormalising denominator and the aux loss's mean gate equals
    ``jax.grad``."""
    x = inputs(B=2, L=10, seed=7)
    jm, variables, tm = pair_mlp(x)
    w = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def jloss(params, xx):
        out, sown = jm.apply({"params": params}, xx,
                             mutable=["aux_loss", "moe_stats"])
        return (jnp.sum(out * w)
                + jnp.sum(jax.tree.leaves(sown["aux_loss"])[0]))

    params = jax.tree.map(jnp.asarray, numpy_tree(variables)["params"])
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    loss = (tm(xt) * torch.from_numpy(w)).sum() + tm.last_aux
    loss.backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
    for name in ("router", "w_in", "w_out"):
        np.testing.assert_allclose(getattr(tm, name).grad.numpy(),
                                   np.asarray(jgp[name]), **TOL)
    assert np.abs(np.asarray(jgp["router"])).max() > 0


def jax_moe_tiny(max_len=32):
    return JaxMoE(vocab_size=VOCAB, max_len=max_len, embed_dim=32, depth=2,
                  num_heads=2, num_experts=E)


def torch_moe(jm, variables):
    tm = MoETransformer(vocab_size=jm.vocab_size, max_len=jm.max_len,
                        embed_dim=jm.embed_dim, depth=jm.depth,
                        num_heads=jm.num_heads, num_experts=jm.num_experts,
                        device="cpu")
    return load_tree(tm, from_flax(numpy_tree(variables)))


def test_moe_tiny_logits_through_from_flax():
    """The whole MoE LM (capped routing over the padded batch: pads
    compete for capacity) from the Flax tree: block 1 is the MoE block,
    its leaves ``block_1.moe.{router,w_in,w_out}`` in Flax's layout."""
    jm = jax_moe_tiny()
    variables = jax_init(jm)
    tm = torch_moe(jm, variables)
    names = dict(tm.named_parameters())
    assert tuple(names["block_1.moe.w_in"].shape) == (E, 32, 128)
    assert tuple(names["block_1.moe.w_out"].shape) == (E, 128, 32)
    assert tuple(names["block_1.moe.router"].shape) == (32, E)
    ids = np.random.default_rng(9).integers(1, VOCAB,
                                            size=(3, 11)).astype(np.int32)
    ids[-1, -3:] = 0
    ref = np.asarray(jm.apply(variables, ids))
    with torch.no_grad():
        out = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_moe_leaves_round_trip_flax_layout():
    """to_flax gives the Flax tree back leaf for leaf (raw params, not
    permuted), and the int8 rule quantizes a 3-D expert stack with one
    scale per last-axis channel over all experts, as JAX's does."""
    jm = jax_moe_tiny()
    variables = numpy_tree(jax_init(jm))
    tm = torch_moe(jm, variables)
    back = to_flax(tm.state_dict())["params"]
    for name in ("router", "w_in", "w_out"):
        np.testing.assert_array_equal(back["block_1"]["moe"][name],
                                      variables["params"]["block_1"]["moe"][
                                          name])
    jq = jax_quantize_tree(variables)["params"]["block_1"]["moe"]["w_in"]
    tq = quantize_tree(tm.state_dict())["block_1.moe.w_in"]
    assert isinstance(tq, QuantizedTensor) and tuple(tq.s.shape) == (1, 1,
                                                                     128)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.s.numpy(), np.asarray(jq.s))


def test_int8_moe_weights_dequantize_each_forward():
    """int8 MoE weights loaded through load_tree stay int8 and compute the
    values of the dequantized tree (in f32), in both routing paths."""
    from kubeml_tpu_torch.serving.quant import dequantize_tree

    jm = jax_moe_tiny()
    variables = numpy_tree(jax_init(jm))
    tm = torch_moe(jm, variables)
    tree = quantize_tree(tm.state_dict())
    dense = torch_moe(jm, variables)
    load_tree(dense, dequantize_tree(tree, torch.float32))
    load_tree(tm, tree, int8_impl="dequant")
    assert tm.block_1.moe.quantized and tm.block_1.moe.w_in_q.dtype == \
        torch.int8
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        1, VOCAB, size=(2, 9)))
    with torch.no_grad():
        assert torch.equal(tm(ids), dense(ids))


def test_router_noise_rules():
    x = torch.from_numpy(inputs(B=2, L=8, seed=3))
    tm = MoEMlp(D, E)
    torch.nn.init.normal_(tm.router, std=0.3)
    torch.nn.init.normal_(tm.w_in, std=0.1)
    torch.nn.init.normal_(tm.w_out, std=0.1)
    with torch.no_grad():
        with pytest.raises(ValueError, match="rng"):
            tm(x, train=True)
        clean = tm(x)
        a = tm(x, train=True, noise_seed=5)
        b = tm(x, train=True, noise_seed=5)
        c = tm(x, train=True, noise_seed=6)
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert torch.equal(tm(x, noise_seed=5), clean)  # eval: no noise
        tm.router_noise = 0.0
        assert torch.equal(tm(x, train=True), clean)
    # the noise on the logits is 1e-2 x N(0, 1)
    from kubeml_tpu_torch.models.layers import make_generator

    g = make_generator(5, "cpu")
    draw = 1e-2 * torch.randn((16, E), generator=g)
    assert 0.005 < float(draw.std()) < 0.015


def test_model_training_forward_needs_rng_for_router_noise():
    tm = MoETiny(vocab_size=VOCAB, device="cpu")
    ids = torch.randint(1, VOCAB, (2, 8))
    with pytest.raises(ValueError, match="rng"):
        tm(ids, train=True)
    assert torch.equal(tm(ids, train=True, rng=3), tm(ids, train=True,
                                                      rng=3))


def test_spmd_trainer_three_steps_on_moe_tiny():
    """The loss (aux losses included) falls over three steps on one
    batch; the overflow is the MoE layers' mean share in [0, 1]; a dense
    model reports -1. The trainer takes a one-device mesh and a batch
    spec, as bench_moe passes them."""
    mesh = make_mesh(devices=["cpu"])
    tm = MoETiny(vocab_size=VOCAB, device="cpu")
    trainer = SPMDTrainer(tm, mesh, precision="f32", batch_spec=("dp",))
    batch = np.random.default_rng(0).integers(1, VOCAB,
                                              size=(4, 16)).astype(np.int32)
    trainer.init(batch)
    losses = [float(trainer.train_step(batch, rng=i)) for i in range(3)]
    assert losses[2] < losses[0]
    assert 0.0 <= float(trainer.last_moe_overflow) <= 1.0
    assert all(m.last_aux is None for m in tm.modules()
               if isinstance(m, MoEMlp))  # collected and cleared
    dense = CausalTransformer(vocab_size=VOCAB, max_len=16, embed_dim=32,
                              depth=2, num_heads=2, device="cpu")
    dt = SPMDTrainer(dense, precision="f32")
    dt.init(batch)
    dt.train_step(batch)
    assert dt.last_moe_overflow == -1.0


def test_spmd_trainer_loss_includes_aux_losses():
    """The step's loss is lm_loss plus every MoE layer's weighted aux
    loss (JAX's sum over the aux_loss collection)."""
    from kubeml_tpu_torch.parallel.trainer import lm_loss

    tm = MoETiny(vocab_size=VOCAB, device="cpu")
    for m in tm.modules():
        if isinstance(m, MoEMlp):
            m.router_noise = 0.0  # a deterministic forward to compare
    batch = np.random.default_rng(1).integers(1, VOCAB,
                                              size=(2, 12)).astype(np.int32)
    ids = torch.from_numpy(batch)
    with torch.no_grad():
        want = float(lm_loss(tm(ids), ids) + tm.block_1.moe.last_aux)
    trainer = SPMDTrainer(tm, precision="f32")
    trainer.init(batch)
    assert float(trainer.train_step(batch)) == pytest.approx(want, abs=1e-6)


def test_mesh_helpers_match_jax():
    for spec in ("", "tp=2,sp=2", " dp=4 "):
        assert parse_mesh_spec(spec) == jax_parse(spec)
    with pytest.raises(ValueError, match="mesh spec"):
        parse_mesh_spec("tp:2")
    for n, req in ((8, dict(tp=2)), (4, dict(sp=2, tp=2)), (1, {})):
        assert mesh_shape_for(n, **req) == jax_mesh_shape_for(n, **req)
    for bad in (dict(xx=1), dict(tp=0), dict(tp=3)):
        with pytest.raises(ValueError):
            mesh_shape_for(4, **bad)
    m = make_mesh(devices=["cpu"])
    jm = jax_make_mesh(devices=jax.devices()[:1])
    assert m.shape == dict(jm.shape)
    assert m.devices == [torch.device("cpu")]
    # a mesh of several ranks needs the process group, whatever its axes:
    # an ep axis (MoE expert sharding) is a mesh axis like dp
    for axes in ({"dp": 2}, {"ep": 2}, {"ep": 2, "tp": 2}):
        with pytest.raises(RuntimeError, match="init_distributed"):
            make_mesh(axes, devices=["cpu"] * 2 ** len(axes))
    assert mesh_shape_for(8, ep=2, tp=2) == jax_mesh_shape_for(8, ep=2,
                                                               tp=2)
    with pytest.raises(RuntimeError, match="process groups"):
        SPMDTrainer(MoETiny(vocab_size=VOCAB, device="cpu"),
                    Mesh({"tp": 2}, [torch.device("cpu")] * 2))


def test_bench_moe_row_and_flop_count():
    """``bench_moe`` at tiny widths on the CPU: the JAX row's keys, a
    falling loss, no flash launch off the card; the analytic count at the
    full configuration: capacity 1280 of 8 x 1280 slots, and the one-hot
    dispatch and combine at S / 4D = 2.67x the expert FFNs."""
    from kubeml_tpu_torch.benchmarks.transformers import (MOE_ROUTING,
                                                          MOE_WIDTHS,
                                                          bench_moe,
                                                          moe_flops)

    row = bench_moe(steps=1, batch=2, seq=16, device="cpu",
                    vocab_size=VOCAB, embed_dim=32, depth=2, num_heads=2)
    for key in ("metric", "value", "unit", "batch", "seq", "num_experts",
                "top_k", "moe_every", "flops_per_step", "peak_flops", "mfu",
                "roofline_mfu_ceiling", "moe_overflow", "loss"):
        assert key in row, key
    assert row["metric"] == "gpt-moe-train-throughput"
    assert row["losses"][-1] < row["losses"][0]
    assert row["flash_launches_per_step"] == {"fwd": 0, "dq": 0, "dkv": 0}
    full = moe_flops(16, 512, **MOE_WIDTHS, **MOE_ROUTING)
    assert full["capacity"] == 1280
    assert full["dispatch_combine_over_expert_ffn"] == pytest.approx(
        8192 / (4 * 768))
    terms = full["forward_terms"]
    assert terms["lm_head"] == 2 * 8192 * 768 * 32000
    assert full["flops_per_step"] == 3 * sum(terms.values())
