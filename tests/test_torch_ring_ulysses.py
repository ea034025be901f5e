"""Ring and Ulysses attention of the port over spawned gloo ranks against
the JAX package's ``shard_map`` versions, built as
``tests/test_parallel.py`` builds them (B 2, L 16, D 8, f32; ring H 2,
Ulysses H 4): outputs and the input gradients of ``sum(out * w)`` for full,
causal, padded and causal-padded inputs at sp 2 (on a ``dp=2, sp=2`` mesh,
rows over dp) and sp 4, ring degree invariance, the indivisible-heads
error, and Ulysses' local attention through the flash autograd Function
(one forward and one backward a call; the ring none).

Tolerance 1e-5 absolute and relative, as ``tests/test_parallel.py`` holds
the JAX versions to full attention: f32 on both sides, summed in other
orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_dist_ranks as R
from kubeml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kubeml_tpu.parallel.ring import ring_attention as jax_ring
from kubeml_tpu.parallel.ulysses import ulysses_attention as jax_ulysses

TOL = dict(atol=1e-5, rtol=1e-5)
B, L, D = 2, 16, 8
HEADS = {"ring": 2, "ulysses": 4}
MODES = {"full": (False, False), "causal": (True, False),
         "padded": (False, True), "causal_padded": (True, True)}


def _inputs(impl):
    r = np.random.default_rng(0)
    mk = lambda: r.normal(size=(B, L, HEADS[impl], D)).astype(np.float32)
    q, k, v, w = mk(), mk(), mk(), mk()
    valid = np.random.default_rng(1).random((B, L)) > 0.3
    return q, k, v, w, valid


def _cases():
    out = {}
    for impl in ("ring", "ulysses"):
        q, k, v, w, valid = _inputs(impl)
        for sp in (2, 4):
            for mode, (causal, padded) in MODES.items():
                out[f"{impl}-{sp}-{mode}"] = (
                    impl, sp, causal, (q, k, v, w, valid if padded else None))
    return out


def _jax(impl, sp, causal, q, k, v, w, valid):
    """The JAX shard_map version's output and input gradients."""
    fn = jax_ring if impl == "ring" else jax_ulysses
    mesh = jax_make_mesh(sp=sp)
    n = 3 if valid is None else 4
    sm = jax.shard_map(
        lambda q, k, v, *val: fn(q, k, v, axis_name="sp", causal=causal,
                                 kv_valid=val[0] if val else None),
        mesh=mesh, in_specs=(P(None, "sp"),) * n, out_specs=P(None, "sp"),
        check_vma=False)
    extra = () if valid is None else (jnp.asarray(valid),)
    # the gradients of sum(out * w) are the pullback of w
    out, grads = jax.jit(lambda q, k, v, w: (
        lambda o, pull: (o, pull(w)))(*jax.vjp(
            lambda q, k, v: sm(q, k, v, *extra), q, k, v)))(q, k, v, w)
    return [np.asarray(x) for x in (out, *grads)]


@pytest.fixture(scope="module")
def ranks():
    return R.run(R.attention_rank, 4, _cases())


@pytest.mark.parametrize("tag", list(_cases()))
def test_output_and_gradients_equal_jax_shard_map(ranks, tag):
    impl, sp, causal, arrays = _cases()[tag]
    want = _jax(impl, sp, causal, *arrays)
    parts = [r[tag] for r in ranks]
    for name, ref in zip(("out", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(R.assemble(parts, name), ref,
                                   err_msg=f"{tag} {name}", **TOL)
    flash = {"fwd": 1, "bwd": 1} if impl == "ulysses" else {"fwd": 0,
                                                             "bwd": 0}
    assert all(p["flash"] == flash for p in parts)


def test_ring_degree_invariance(ranks):
    for mode in MODES:
        a = R.assemble([r[f"ring-2-{mode}"] for r in ranks], "out")
        b = R.assemble([r[f"ring-4-{mode}"] for r in ranks], "out")
        np.testing.assert_allclose(a, b, err_msg=mode, **TOL)


def test_ulysses_equals_ring(ranks):
    """Both schemes at sp 4 on the same (4-head) input are the same exact
    attention: compare Ulysses against the port's ring run on the JAX
    ring's output for that input."""
    impl, sp, causal, arrays = _cases()["ulysses-4-causal_padded"]
    ring = _jax("ring", sp, causal, *arrays)[0]
    got = R.assemble([r["ulysses-4-causal_padded"] for r in ranks], "out")
    np.testing.assert_allclose(got, ring, **TOL)


def test_indivisible_heads_raise(ranks):
    assert all("divisible by sp (2)" in r["indivisible"] for r in ranks)
