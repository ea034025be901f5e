"""A mesh changes no step of the port's MoE training: three f32
``SPMDTrainer`` steps of a ``MoETransformer`` (embed 64, depth 2, 4 heads,
4 experts; block 1 is the MoE block) with the router noise ON, over
world-2 gloo ranks on ``ep=2``, ``dp=2``, ``tp=2`` and ``sp=2`` (Ulysses),
equal the port's one-rank trainer from the same seed, batch and step
seeds: the losses at 1e-5 (f32, summed in other orders) and each step's
overflow equal. The noise is drawn for the global ``[S, E]`` from the
step's seed and each rank keeps its block, so the routing is the
one-rank routing. Its scale is raised from JAX's 1e-2 to ``NOISE`` on
both sides: at 1e-2 a rank drawing noise of its own moved the losses by
less than the tolerance over dp and sp (a mutation check did that); at
1.0 the draw reroutes tokens. The one-rank trainer is held against JAX by
``tests/test_torch_moe.py``. The trained model decodes over the ep=2
ranks (meshed serving: each rank runs its experts, the outputs summed over
ep) with the greedy tokens of one rank holding the gathered weights."""

import numpy as np
import pytest

import torch_dist_ranks as R
import torch_moe_ranks as M
from kubeml_tpu_torch.models.gpt import CausalTransformer
from kubeml_tpu_torch.parallel.trainer import SPMDTrainer

CFG = dict(vocab_size=64, max_len=16, embed_dim=64, depth=2, num_heads=4,
           moe_every=2, num_experts=4)
SEED = 3
NOISE = 1.0
RNGS = (11, 12, 13)
MESHES = [("ep=2", dict(ep=2), "ring"), ("dp=2", dict(dp=2), "ring"),
          ("tp=2", dict(tp=2), "ring"), ("sp=2", dict(sp=2), "ulysses")]


def _batch():
    b = np.random.default_rng(5).integers(1, 64, size=(4, 16)).astype(
        np.int32)
    b[-1, -3:] = 0
    return b


@pytest.fixture(scope="module")
def one_rank():
    tr = SPMDTrainer(M.router_noise(CausalTransformer(
        seed=SEED, device="cpu", **CFG), NOISE), precision="f32")
    tr.init(_batch())
    losses, over = [], []
    for r in RNGS:
        losses.append(float(tr.train_step(_batch(), rng=r)))
        over.append(float(tr.last_moe_overflow))
    return dict(losses=losses, overflow=over)


@pytest.fixture(scope="module")
def ranks():
    return R.run(M.steps_rank, 2, dict(cfg=CFG, seed=SEED, rngs=RNGS,
                                       noise=NOISE, batch=_batch(),
                                       meshes=MESHES))


@pytest.mark.parametrize("tag", [m[0] for m in MESHES])
def test_three_noisy_steps_equal_one_rank(one_rank, ranks, tag):
    assert 0.0 < one_rank["overflow"][0] < 1.0
    for res in ranks:
        got = res[tag]
        np.testing.assert_allclose(got["losses"], one_rank["losses"],
                                   atol=1e-5, rtol=1e-5)
        assert got["overflow"] == pytest.approx(one_rank["overflow"],
                                                abs=1e-7)
    assert one_rank["losses"][-1] < one_rank["losses"][0]


def test_noise_moves_the_routing(one_rank):
    """The router noise is on: another step seed gives a loss beyond the
    tolerance."""
    tr = SPMDTrainer(M.router_noise(CausalTransformer(
        seed=SEED, device="cpu", **CFG), NOISE), precision="f32")
    tr.init(_batch())
    other = float(tr.train_step(_batch(), rng=RNGS[0] + 100))
    assert abs(other - one_rank["losses"][0]) > 1e-3


def test_moe_decode_over_ranks_still_refused(ranks):
    """No longer refused: MoE decode over ep=2 gives one rank's tokens."""
    for res in ranks:
        assert res["decode"] == res["decode_one_rank"]
        assert len(res["decode"][0]) == 6
