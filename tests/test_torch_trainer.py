"""The port's training slice against the JAX package: ``lm_loss`` and
``chunked_lm_loss`` (value and gradient), three ``SPMDTrainer`` steps of the
tiny GPT with and without remat against the JAX ``SPMDTrainer`` on a
one-device mesh from the same weights and batches, the remat model's
weights, and the long-context entry point at a tiny size.

On the CPU the port's attention takes the plain path; the "flash" cases
route it through ``ops.flash_attention`` (its autograd Function over the
plain versions), the structure the card runs with the kernels.

Tolerances, each with its reason:
- losses (values and gradients): 1e-5 absolute and relative; f32 on both
  sides, summed in other orders.
- SGD steps: per-step losses 1e-5 and final parameters 1e-5; SGD is linear
  in the gradient, so f32 rounding differences stay at that size.
- AdamW steps: per-step losses 1e-5; each parameter's movement (final
  minus initial) within 1e-5 of JAX's movement, which is about lr per step
  (so a trainer that leaves a parameter in place, or updates only some of
  them, fails). Adam's normalised step m / (sqrt(v) + eps) is about +-lr
  whatever the gradient's size, so where a gradient is near zero the two
  frameworks' other summation orders can flip its sign: such an entry may
  move up to 2 x lr a step differently. At most 0.1% of the entries may
  take that allowance (none does at this size).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from kubeml_tpu.parallel.mesh import make_mesh
from kubeml_tpu.parallel.trainer import SPMDTrainer as JaxTrainer
from kubeml_tpu.parallel.trainer import chunked_lm_loss as jax_chunked
from kubeml_tpu.parallel.trainer import lm_loss as jax_lm_loss
from kubeml_tpu_torch.models import gpt as torch_gpt
from kubeml_tpu_torch.models.gpt import CausalTransformer
from kubeml_tpu_torch.ops import attention, flash_attention as fa
from kubeml_tpu_torch.parallel import SPMDTrainer, chunked_lm_loss, lm_loss
from torch_port_helpers import VOCAB, jax_init, jax_tiny, numpy_tree, torch_twin

TOL = dict(atol=1e-5, rtol=1e-5)
LR_SGD = 0.1
ADAM_LR = 3e-4  # optax.adamw's and the port's default


def batches(seed=0, n=3, B=2, L=12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(1, VOCAB, size=(B, L)).astype(np.int32)
        ids[-1, -3:] = 0  # padding: masked as keys and as targets
        out.append(ids)
    return out


def test_lm_loss_value_and_gradient_match_jax(rng):
    logits = rng.normal(size=(2, 7, 11)).astype(np.float32) * 3
    tokens = rng.integers(0, 11, size=(2, 7)).astype(np.int32)
    tokens[0, 1:3] = 0
    jv, jg = jax.value_and_grad(jax_lm_loss)(jnp.asarray(logits),
                                             jnp.asarray(tokens))
    t = torch.from_numpy(logits).requires_grad_()
    tv = lm_loss(t, torch.from_numpy(tokens))
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), **TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **TOL)
    # every target padding: the mask floor keeps the loss at 0
    assert lm_loss(t, torch.zeros(2, 7, dtype=torch.int32)).item() == 0.0


@pytest.mark.parametrize("chunk", [3, 4, 2048])
def test_chunked_lm_loss_matches_jax(rng, chunk):
    """Ragged chunks (7 targets in chunks of 3), even ones, one chunk;
    loss and accuracy values, gradients on the hidden states and the
    kernel."""
    h = rng.normal(size=(2, 8, 6)).astype(np.float32)
    w = rng.normal(size=(6, 13)).astype(np.float32)
    tokens = rng.integers(0, 13, size=(2, 8)).astype(np.int32)
    tokens[1, -2:] = 0
    jl, ja = jax_chunked(jnp.asarray(h), jnp.asarray(w), jnp.asarray(tokens),
                         chunk=chunk, with_acc=True)
    jgh, jgw = jax.grad(lambda h, w: jax_chunked(h, w, jnp.asarray(tokens),
                                                 chunk=chunk),
                        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl, ta = chunked_lm_loss(th, tw, torch.from_numpy(tokens), chunk=chunk,
                             with_acc=True)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    np.testing.assert_allclose(ta.item(), float(ja), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), **TOL)
    # the unchunked loss over the same logits agrees
    full = lm_loss(torch.einsum("ble,ev->blv", torch.from_numpy(h),
                                torch.from_numpy(w)), torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.item(), full.item(), **TOL)


def test_chunked_lm_loss_length_one_is_zero():
    h, w = torch.randn(2, 1, 4), torch.randn(4, 5)
    tokens = torch.ones(2, 1, dtype=torch.int32)
    assert chunked_lm_loss(h, w, tokens).item() == 0.0
    assert [x.item() for x in chunked_lm_loss(h, w, tokens,
                                              with_acc=True)] == [0.0, 0.0]


@functools.lru_cache(maxsize=None)
def jax_run(remat: bool, opt: str):
    """Three JAX SPMDTrainer steps (compiled once per configuration):
    the initial weights, the per-step losses and the final weights."""
    jm = jax_tiny(remat=remat, max_len=16)
    mesh = make_mesh(devices=jax.devices()[:1])
    trainer = JaxTrainer(jm, mesh,
                         optimizer=optax.sgd(LR_SGD) if opt == "sgd" else None,
                         batch_spec=P("dp"))
    bs = batches()
    trainer.init(jax.random.PRNGKey(0), bs[0])
    copy = lambda tree: jax.tree.map(lambda x: np.array(x, copy=True),
                                     numpy_tree(tree))
    init = copy(trainer.params)
    losses = [float(trainer.train_step(b, jax.random.PRNGKey(i)))
              for i, b in enumerate(bs)]
    return jm, init, losses, copy(trainer.params)["params"]


def _flat(tree, prefix=""):
    out = {}
    for key, child in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        out.update(_flat(child, name) if isinstance(child, dict)
                   else {name: child})
    return out


@pytest.mark.parametrize("attn", ["plain", "flash"])
@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("remat", [False, True])
def test_three_train_steps_match_jax_trainer(monkeypatch, remat, opt, attn):
    jm, init, jlosses, jfinal = jax_run(remat, opt)
    if attn == "flash":
        monkeypatch.setattr(torch_gpt, "dot_product_attention",
                            functools.partial(attention.dot_product_attention,
                                              impl="cuda"))
    tm = torch_twin(jm, init)
    assert tm.remat == remat
    make = ((lambda ps: torch.optim.SGD(ps, lr=LR_SGD)) if opt == "sgd"
            else None)
    trainer = SPMDTrainer(tm, optimizer=make)
    bs = batches()
    trainer.init(bs[0])
    tlosses = [trainer.train_step(b).item() for b in bs]
    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    assert trainer.last_moe_overflow == -1.0
    params = dict(tm.named_parameters())
    start = _flat(init["params"])
    flips = entries = 0
    for name, want in _flat(jfinal).items():
        got = params[name].detach().numpy()
        if opt == "sgd":
            np.testing.assert_allclose(got, want, err_msg=name, **TOL)
            continue
        off = np.abs((got - start[name]) - (want - start[name]))
        assert off.max() <= 3 * 2 * ADAM_LR, name
        flips += int((off > 1e-5).sum())
        entries += off.size
    assert flips <= entries // 1000, f"{flips} of {entries} entries"


def test_default_optimizer_is_optax_adamw_twin():
    tm = CausalTransformer(vocab_size=11, max_len=8, embed_dim=8, depth=1,
                           num_heads=2, device="cpu")
    trainer = SPMDTrainer(tm)
    trainer.init()
    (group,) = trainer.opt.param_groups
    assert isinstance(trainer.opt, torch.optim.AdamW)
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (3e-4, (0.9, 0.999), 1e-8, 1e-4)
    assert len(group["params"]) == len(list(tm.parameters()))
    with pytest.raises(RuntimeError, match="init"):
        SPMDTrainer(tm).train_step(np.ones((1, 4), np.int32))


def test_remat_launch_counts_through_the_flash_function(monkeypatch):
    """What the card's launch counters assert, counted here on the plain
    versions: per train step the forward runs 2 x depth times under remat
    (the backward recomputes each block) and depth times without; the
    backward depth times."""
    monkeypatch.setattr(torch_gpt, "dot_product_attention",
                        functools.partial(attention.dot_product_attention,
                                          impl="cuda"))
    calls = {"fwd": 0, "bwd": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fa, "flash_attention_fwd_ref",
                        counting("fwd", fa.flash_attention_fwd_ref))
    monkeypatch.setattr(fa, "flash_attention_bwd_ref",
                        counting("bwd", fa.flash_attention_bwd_ref))
    for remat in (False, True):
        tm = CausalTransformer(vocab_size=VOCAB, max_len=16, embed_dim=32,
                               depth=3, num_heads=2, remat=remat,
                               device="cpu")
        trainer = SPMDTrainer(tm)
        trainer.init()
        calls.update(fwd=0, bwd=0)
        trainer.train_step(batches(n=1)[0])
        assert calls == {"fwd": (2 if remat else 1) * 3, "bwd": 3}


def test_eval_metrics_and_logits_chunk_match_jax():
    jm = jax_tiny(max_len=16)
    b = batches(seed=1, n=1)[0]
    mesh = make_mesh(devices=jax.devices()[:1])
    jt = JaxTrainer(jm, mesh, batch_spec=P("dp"), logits_chunk=5)
    jt.init(jax.random.PRNGKey(1), b)
    variables = jt.params
    want = jt.eval_metrics(b)
    for chunk in (None, 5):
        tt = SPMDTrainer(torch_twin(jm, variables), logits_chunk=chunk)
        np.testing.assert_allclose(tt.eval_metrics(b), want, **TOL)
        assert tt.eval_loss(b) == pytest.approx(want[0], rel=1e-5)
    with pytest.raises(ValueError, match="logits_chunk"):
        SPMDTrainer(torch_twin(jm, variables), loss_fn=lambda a, b: a.sum(),
                    logits_chunk=4)


def test_remat_weights_convert_unchanged_and_forward_matches():
    """Flax ``nn.remat`` keeps the ``block_{i}`` names: a remat model's tree
    has the same names and shapes as the plain one and loads into the
    port's remat model, whose forward (and its checkpointed forward under
    autograd) matches JAX."""
    jm = jax_tiny(remat=True, max_len=16)
    variables = jax_init(jm)
    plain = jax_init(jax_tiny(max_len=16))
    shapes = lambda v: {k: np.shape(x) for k, x in
                        _flat(numpy_tree(v)["params"]).items()}
    assert shapes(variables) == shapes(plain)
    tm = torch_twin(jm, variables)
    ids = batches(seed=2, n=1)[0]
    want = np.asarray(jm.apply(variables, ids))
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(ids)).numpy(), want,
                                   **TOL)
    np.testing.assert_allclose(
        tm(torch.from_numpy(ids), train=True).detach().numpy(), want, **TOL)


def test_twin_carries_dtype_remat_dropout():
    jm = jax_tiny(max_len=16, dtype=jnp.bfloat16, remat=True)
    tm = torch_twin(jm, jax_init(jm))
    assert (tm.dtype, tm.remat, tm.dropout) == (torch.bfloat16, True, 0.0)
    with pytest.raises(NotImplementedError, match="dropout"):
        torch_twin(jax_tiny(max_len=16, dropout=0.1), jax_init(jm))


def test_unported_options_raise():
    kw = dict(vocab_size=11, max_len=8, embed_dim=8, depth=1, num_heads=2,
              device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        CausalTransformer(moe_every=2, **kw)
    with pytest.raises(NotImplementedError, match="mesh"):
        CausalTransformer(mesh=object(), **kw)


def test_longcontext_run_point_tiny_on_cpu(monkeypatch):
    from kubeml_tpu_torch.benchmarks.longcontext import main, run_point

    row = run_point(seq_len=16, tokens_per_step=32, steps=2, dtype="f32",
                    depth=1, embed_dim=64, num_heads=1, vocab=50, repeats=1,
                    device="cpu")
    assert row["metric"] == "gpt-longcontext-train-throughput"
    assert (row["seq_len"], row["global_batch"], row["steps_run"]) == (16, 2,
                                                                         3)
    assert row["device"] == "cpu" and row["value"] > 0
    assert np.isfinite(row["loss"]) and row["loss"] < row["first_loss"]
    # the entry point runs on the card unless asked for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--seq-lens", "16", "--depth", "1"])
