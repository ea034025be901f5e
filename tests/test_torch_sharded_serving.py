"""Meshed serving of the port over two gloo ranks on the CPU against the
JAX package's ``BatchingDecoder(mesh=make_mesh(..., jax.devices()[:2]))``
on conftest's host devices (JAX ``tests/test_sharded_serving.py`` and
``tests/test_quant.py::test_int8_composes_with_serving_mesh``).

The ranks run once for the module (``torch_serving_ranks.serving_rank``),
beside the JAX side. Held:

- greedy tokens identical to JAX's meshed decoder on ``tp=2``, ``dp=2``,
  and for ``MoETiny`` on ``tp=2`` (its expert stacks whole over experts,
  cut over their width) and ``ep=2`` (the stacks cut over experts), and
  to the port's own decoder on one rank; a rank's KV stripes hold ``H /
  tp`` heads and its column block of ``query.kernel``;
- seeded sampling over ``tp=2`` equal to the port's one rank, draw for
  draw;
- the placed models' f32 logits within 1e-4 of JAX's;
- int8 with ``tp=2``: greedy tokens identical to JAX's int8 meshed
  decoder, and each rank's ``q``/``s`` blocks equal to the blocks of
  JAX's ``quantize_tree`` (a row-parallel leaf's scales whole: the
  global ones);
- a parameter server over the two ranks (``serving_mesh="tp=2"``) serves
  a tp=2 SPMD job's sharded final, a pp=2 job's stage-sharded final
  through its ``serving_remap``, and the sharded ``final-int8`` restored
  block by block, each with the tokens of one rank's server over the
  same final.
"""

import threading

import jax
import numpy as np
import pytest

import torch_dist_ranks as R
import torch_job_ranks as J
import torch_serving_ranks as S
from kubeml_tpu.api.types import GenerateRequest as JRequest
from kubeml_tpu.models.gpt import CausalTransformer as JaxTransformer
from kubeml_tpu.parallel.mesh import make_mesh
from kubeml_tpu.parallel.moe import MoETiny as JaxMoETiny
from kubeml_tpu.serving.batcher import BatchingDecoder as JaxDecoder
from kubeml_tpu.serving.quant import quantize_tree as jax_quantize
from kubeml_tpu_torch.api.config import Config
from kubeml_tpu_torch.functions.registry import FunctionRegistry
from kubeml_tpu_torch.interop.from_flax import from_flax
from kubeml_tpu_torch.serving.quant import (INT8_TAG, QuantizedTensor,
                                            from_storage_tree)
from kubeml_tpu_torch.storage.checkpoint import FINAL_TAG, CheckpointStore
from kubeml_tpu_torch.storage.sharded_checkpoint import \
    ShardedCheckpointStore
from kubeml_tpu_torch.storage.store import ShardStore
from torch_port_helpers import numpy_tree

VOCAB = 101
LOGIT_TOL = dict(atol=1e-4, rtol=0)
TINY = dict(vocab_size=VOCAB, max_len=64, embed_dim=64, depth=2, num_heads=4)
MOE = dict(TINY, moe_every=2, num_experts=4)


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, VOCAB, size=(1, int(n))).astype(np.int32)
            for n in (5, 8, 11)]


P8 = np.arange(1, 9, dtype=np.int32)[None]
P6 = np.arange(1, 7, dtype=np.int32)[None]
SAMPLED = dict(prompts=[[3, 1, 4, 1, 5]], max_new_tokens=8,
               temperature=0.9, top_k=20, seed=11)
QKV = ("block_0.attn.query.kernel", "block_0.attn.proj.kernel",
       "lm_head.kernel")
INT8_LEAVES = QKV + ("block_0.mlp_in.kernel", "block_0.mlp_out.kernel")
STACKS = ("block_1.moe.w_in", "block_1.moe.w_out")
# the cluster's requests: greedy rows and a sampled one
CLUSTER_REQS = [dict(prompts=[[1, 2, 3], [9, 8, 7]], max_new_tokens=8),
                dict(prompts=[[5, 6, 7, 8]], max_new_tokens=6,
                     temperature=0.8, top_k=10, seed=3)]


def _init(module):
    return module.init(jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))


def _cases():
    tiny = numpy_tree(_init(JaxTransformer(**TINY)))
    moe = numpy_tree(_init(JaxMoETiny(vocab_size=VOCAB, max_len=64)))
    greedy = lambda ps, n: [dict(prompts=p.tolist(), max_new_tokens=n)
                            for p in ps]
    return {
        "tp": dict(model=TINY, weights=tiny, mesh={"tp": 2},
                   requests=greedy(_prompts(), 9), leaves=QKV),
        "sample": dict(model=TINY, weights=tiny, mesh={"tp": 2}, slots=2,
                       requests=[SAMPLED]),
        "dp": dict(model=TINY, weights=tiny, mesh={"dp": 2}, slots=2,
                   requests=greedy([P6], 6), leaves=QKV),
        "moe_tp": dict(model=MOE, weights=moe, mesh={"tp": 2}, slots=2,
                       requests=greedy([P8], 8), leaves=STACKS),
        "moe_ep": dict(model=MOE, weights=moe, mesh={"ep": 2}, slots=2,
                       requests=greedy([P8], 8), leaves=STACKS),
        "int8": dict(model=TINY, weights=tiny, mesh={"tp": 2}, slots=2,
                     requests=greedy([P8], 8), leaves=INT8_LEAVES,
                     knobs=dict(quantize="int8", int8_matmul=True)),
    }


def _ids():
    return np.random.default_rng(1).integers(1, VOCAB, size=(2, 12)).astype(
        np.int64)


def _cluster_root(tmp):
    """A data root with the token set and the two jobs' functions."""
    cfg = Config(data_root=tmp)
    cfg.ensure_dirs()
    x = J.token_data(64, 1)
    ShardStore(config=cfg).create("tokens", x, np.zeros(len(x), np.int64),
                                  x[:16], np.zeros(16, np.int64))
    reg = FunctionRegistry(config=cfg)
    reg.create("lmfn", J.LM_FN)
    reg.create("ppfn", S.PP_FN)
    reg.create("linfn", S.LINEAR_FN)
    CheckpointStore(config=cfg).save(
        "linjob", {"params": {"weight": np.zeros((2, 4), np.float32),
                              "bias": np.zeros(2, np.float32)}},
        tag=FINAL_TAG, meta={"request": {"function_name": "linfn"}})
    return cfg


def _jax_side(cases):
    """JAX's meshed decoder's greedy tokens and the models' logits."""
    out = {}
    ids = _ids()
    for tag, case in cases.items():
        if tag == "sample":
            continue
        m = (JaxMoETiny(vocab_size=VOCAB, max_len=64) if "moe" in tag
             else JaxTransformer(**TINY))
        variables = _init(m)
        mesh = make_mesh(shape=case["mesh"], devices=jax.devices()[:2])
        dec = JaxDecoder(m, variables, slots=case.get("slots", 4),
                         chunk_steps=4, mesh=mesh,
                         **case.get("knobs", {}))
        try:
            out[tag] = [dec.wait(dec.submit(JRequest(**r)),
                                 timeout=300)["tokens"]
                        for r in case["requests"]]
        finally:
            dec.close()
        if tag != "int8":
            out[f"{tag}_logits"] = np.asarray(m.apply(variables, ids,
                                                      train=False))
    out["int8_q"] = numpy_tree(jax_quantize(_init(JaxTransformer(**TINY))))
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cases = _cases()
    root = tmp_path_factory.mktemp("meshed")
    cfg = _cluster_root(root)
    spec = dict(cases=cases, ids=_ids(),
                cluster=dict(root=str(root), requests=CLUSTER_REQS))
    ranks = {}

    def run():
        try:
            ranks["out"] = R.run(S.serving_rank, 2, spec)
        except BaseException as e:  # surfaced in the test thread
            ranks["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    try:
        jax_out = _jax_side(cases)
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    return dict(cases=cases, jax=jax_out, ranks=ranks["out"], cfg=cfg)


@pytest.mark.parametrize("tag", ["tp", "dp", "moe_tp", "moe_ep", "int8"])
def test_greedy_tokens_equal_jax_meshed_decoder(served, tag):
    lead = served["ranks"][0][tag]
    assert lead["mesh"] == served["cases"][tag]["mesh"]
    assert lead["tokens"] == served["jax"][tag]
    assert lead["tokens"] == lead["one_rank"]
    # the follower ran every prefill and decode chunk the leader ran
    assert served["ranks"][1][tag]["ops"] > 0


def test_tp_shards_the_kv_and_the_columns(served):
    """One rank's KV stripes hold H / tp heads; its query kernel is its
    column block, proj its row block, the vocabulary of 101 (odd) keeps
    lm_head whole on both ranks."""
    w = served["cases"]["tp"]["weights"]["params"]
    assert served["ranks"][0]["tp"]["cache_k"] == (4, 64, 2, 16)
    for rank, res in enumerate(served["ranks"]):
        blocks = res["tp"]["blocks"]
        cols = slice(32 * rank, 32 * (rank + 1))
        np.testing.assert_array_equal(
            blocks["block_0.attn.query.kernel"],
            w["block_0"]["attn"]["query"]["kernel"][:, cols])
        np.testing.assert_array_equal(
            blocks["block_0.attn.proj.kernel"],
            w["block_0"]["attn"]["proj"]["kernel"][cols, :])
        np.testing.assert_array_equal(blocks["lm_head.kernel"],
                                      w["lm_head"]["kernel"])
        # dp cuts nothing
        np.testing.assert_array_equal(
            res["dp"]["blocks"]["block_0.attn.query.kernel"],
            w["block_0"]["attn"]["query"]["kernel"])


def test_moe_stacks_follow_the_fit_rule(served):
    """tp=2: every expert on each rank, half its hidden width; ep=2: half
    the experts a rank, whole."""
    w = served["cases"]["moe_tp"]["weights"]["params"]["block_1"]["moe"]
    for rank, res in enumerate(served["ranks"]):
        half = slice(128 * rank, 128 * (rank + 1))
        tp, ep = res["moe_tp"]["blocks"], res["moe_ep"]["blocks"]
        np.testing.assert_array_equal(tp["block_1.moe.w_in"],
                                      w["w_in"][:, :, half])
        np.testing.assert_array_equal(tp["block_1.moe.w_out"],
                                      w["w_out"][:, half, :])
        experts = slice(2 * rank, 2 * (rank + 1))
        np.testing.assert_array_equal(ep["block_1.moe.w_in"],
                                      w["w_in"][experts])
        np.testing.assert_array_equal(ep["block_1.moe.w_out"],
                                      w["w_out"][experts])


def test_seeded_sampling_equals_one_rank(served):
    lead = served["ranks"][0]["sample"]
    assert lead["tokens"] == lead["one_rank"]
    assert len(lead["tokens"][0][0]) == 8


@pytest.mark.parametrize("tag", ["tp", "dp", "moe_tp", "moe_ep"])
def test_logits_equal_jax(served, tag):
    for res in served["ranks"]:
        np.testing.assert_allclose(res[tag]["logits"],
                                   served["jax"][f"{tag}_logits"],
                                   **LOGIT_TOL)


def test_int8_blocks_carry_the_global_scales(served):
    """Each rank's q/s blocks equal the blocks of JAX's quantize_tree of
    the whole tree: q cut as the kernel, s along its channel axis, so a
    row-parallel leaf (proj, mlp_out) keeps the whole scales."""
    q = served["jax"]["int8_q"]["params"]
    for rank, res in enumerate(served["ranks"]):
        blocks = res["int8"]["blocks"]
        for name, (got_q, got_s) in blocks.items():
            node = q
            for part in name.split("."):
                node = node[part]
            want_q, want_s = np.asarray(node.q), np.asarray(node.s)
            if name.endswith(("query.kernel", "mlp_in.kernel")):
                n = want_q.shape[1] // 2
                want_q = want_q[:, n * rank:n * (rank + 1)]
                want_s = want_s[:, n * rank:n * (rank + 1)]
            elif name.endswith(("proj.kernel", "mlp_out.kernel")):
                n = want_q.shape[0] // 2
                want_q = want_q[n * rank:n * (rank + 1)]
            np.testing.assert_array_equal(got_q, want_q, err_msg=name)
            np.testing.assert_array_equal(got_s, want_s, err_msg=name)


def test_ps_serves_finals_on_the_mesh(served):
    """The tp=2 job's sharded final, the pp=2 job's stage-sharded final
    (assembled on the host, remapped flat, then cut) and the sharded
    final-int8 (its blocks read from the stored slices) serve on the tp=2
    mesh with one rank's tokens."""
    res = served["ranks"][0]["cluster"]
    for key in ("job", "ppjob_train"):
        assert res[key]["status"] == "finished", res[key]
    man = ShardedCheckpointStore(
        root=served["cfg"].checkpoints_dir).read_manifest("ppjob", FINAL_TAG)
    assert man["processes"] == 2 and any(
        p.startswith("params/stages/") for p in man["leaves"])
    assert res["source"] == "sharded" and res["int8_form"] == "sharded"
    for key in ("tpjob", "ppjob", "int8"):
        assert res[f"{key}_mesh"] == {"tp": 2}, key
        assert res[key] == res[f"{key}_one_rank"], key
        assert len(res[key][0][0]) == 8
    assert res["tpjob_cache_k"][2] == 2  # 4 heads over tp=2
    # the follower ran the three jobs, then both clusters through their
    # shutdown, and every shard it built was released
    follower = served["ranks"][1]["cluster"]
    assert follower["followed"] == [3, 0]
    assert follower["shards"] == [(2, 0), (1, 0)]
    # the final-int8 blocks: mlp_in's columns, mlp_out's rows with the
    # whole scales
    ck = ShardedCheckpointStore(root=served["cfg"].checkpoints_dir).restore(
        "tpjob", INT8_TAG)
    whole = from_flax(from_storage_tree(ck.variables))
    blocks = res["int8_blocks"]  # rank 0's
    for name, cut in (("block_0.mlp_in.kernel", 1),
                      ("block_0.mlp_out.kernel", 0)):
        qt = whole[name]
        assert isinstance(qt, QuantizedTensor)
        q, s = qt.q.numpy(), qt.s.numpy()
        n = q.shape[cut] // 2
        want_q = q[:, :n] if cut else q[:n]
        want_s = s[:, :n] if cut else s
        np.testing.assert_array_equal(blocks[name][0], want_q)
        np.testing.assert_array_equal(blocks[name][1], want_s)


def test_busy_ranks_neither_lose_closes_nor_hold_unmeshable_models(served):
    """While a job over the ranks holds them: /generate of a final that
    cannot be meshed answers at once, as one rank does, and the refusal is
    remembered; the meshed decoders retired then leave their closes to the
    job, which sends them at its end (the follower's shards are empty at
    shutdown, checked in test_ps_serves_finals_on_the_mesh)."""
    res = served["ranks"][0]["cluster"]
    busy = res["busy"]
    assert busy["job"]["status"] == "finished", busy["job"]
    assert busy["linjob"] == res["linjob_one_rank"]
    assert busy["linjob"][0] == 400
    assert busy["unmeshable"]
    assert busy["linjob_s"] < 30
    assert busy["deferred"] == 2  # both closes waited for the job
    assert busy["after"] == 0  # and the job's end sent them
