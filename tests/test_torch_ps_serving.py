"""The port's ``ParameterServer`` serving half against the JAX package's,
on the CPU, over one ``final`` checkpoint file.

Each package gets a data root of its own, holding a function of the same
name written against its own package (``kubeml_tpu_torch.models.gpt.
CausalTransformer`` for the port) and the same checkpoint file. The model
is vocab 64, E 64, depth 2, 4 heads: at E 64 every projection and the
lm_head reach ``MIN_QUANT_SIZE``, so the int8 export quantizes them all.
The JAX PS reads the arena through ``paged_attn="gather"`` and runs int8
through the ``dot`` path; the port PS runs on ``device="cpu"``.

Held equal: greedy tokens, ``prefix_cached_tokens`` and the engines'
counters (``test_torch_stats``'s exceptions: timings and the by-design
differences) over requests served one at a time, plain, int8 (the
``final-int8`` files' ``q`` and ``s`` bit for bit) and self-drafting (k
fixed); drain and restore across servers; a JAX-drained frame restored by
the port."""

import os
import time

import jax
import numpy as np
import pytest
import torch

from kubeml_tpu.api.config import Config as JConfig
from kubeml_tpu.functions.registry import FunctionRegistry as JRegistry
from kubeml_tpu.models.gpt import CausalTransformer as JaxTransformer
from kubeml_tpu.ps.parameter_server import ParameterServer as JPS
from kubeml_tpu.serving.quant import \
    quantize_final_checkpoint as jax_quantize
from kubeml_tpu.storage.checkpoint import CheckpointStore as JStore
from kubeml_tpu.storage.sharded_checkpoint import ShardedCheckpointStore
from kubeml_tpu_torch.api.config import Config
from kubeml_tpu_torch.api.errors import KubeMLError
from kubeml_tpu_torch.functions.registry import FunctionRegistry
from kubeml_tpu_torch.ps.parameter_server import ParameterServer
from kubeml_tpu_torch.serving import PagedBatchingDecoder
from kubeml_tpu_torch.serving.quant import (INT8_TAG, Q8_Q, Q8_S,
                                            quantize_final_checkpoint)
from kubeml_tpu_torch.storage.checkpoint import FINAL_TAG, CheckpointStore
from test_torch_serving_recovery import hold_steps
from test_torch_stats import BY_DESIGN, counters
from torch_port_helpers import numpy_tree

MODEL = dict(vocab_size=64, max_len=32, embed_dim=64, depth=2, num_heads=4)
JOB = "lmjob"
SERVE = dict(serving_slots=2, serving_chunk_steps=4, serving_page_tokens=4)

PORT_FN = """
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.gpt import CausalTransformer
from kubeml_tpu_torch.runtime.model import KubeModel

class Tokens(KubeDataset):
    def __init__(self):
        super().__init__("tokens")

class Model(KubeModel):
    def __init__(self):
        super().__init__(Tokens())
    def build(self):
        return CausalTransformer(vocab_size=64, max_len=32, embed_dim=64,
                                 depth=2, num_heads=4, device="cpu")
"""

JAX_FN = """
import optax
from kubeml_tpu.data.dataset import KubeDataset
from kubeml_tpu.models.gpt import CausalTransformer
from kubeml_tpu.runtime.model import KubeModel

class Tokens(KubeDataset):
    def __init__(self):
        super().__init__("tokens")

class Model(KubeModel):
    def __init__(self):
        super().__init__(Tokens())
    def build(self):
        return CausalTransformer(vocab_size=64, max_len=32, embed_dim=64,
                                 depth=2, num_heads=4)
    def configure_optimizers(self):
        return optax.adamw(self.lr)
"""

LENET_FN = """
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.lenet import LeNet
from kubeml_tpu_torch.runtime.model import KubeModel

class Model(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("mnist"))
    def build(self):
        return LeNet(num_classes=10)
"""

# the counters a spec engine holds equal to the JAX one's, requests one at
# a time and k fixed (tests/test_torch_spec_decode.py)
SPEC_KEYS = ("spec_steps", "spec_drafted_tokens", "spec_proposed_tokens",
             "spec_accepted_tokens", "spec_accept_rate", "spec_k",
             "spec_disabled", "tokens_emitted", "prefix_hits",
             "prefill_chunks", "prefill_chunk_tokens", "prefills_in_progress",
             "pages_free", "prefix_cache_pages")

# served one at a time: the second request's first page comes from the trie
WORKLOAD = [([1, 2, 3, 4, 5, 6, 7, 8], 4), ([1, 2, 3, 4, 5, 6, 7, 8], 4),
            ([9, 10, 11, 12, 13], 8), ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], 6)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights():
    module = JaxTransformer(**MODEL)
    v = module.init(jax.random.PRNGKey(0), np.zeros((1, 4), np.int32))
    return numpy_tree(v)


def roots(tmp_path, weights):
    """Both data roots with their functions and one final file, written by
    the JAX store and copied into the port's."""
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    JStore(root=jroot / "checkpoints").save(
        JOB, weights, epoch=1, tag=FINAL_TAG,
        meta={"request": {"function_name": "lmfn"}})
    (proot / "checkpoints" / JOB).mkdir(parents=True)
    src = jroot / "checkpoints" / JOB / "final.npz"
    (proot / "checkpoints" / JOB / "final.npz").write_bytes(src.read_bytes())
    return jroot, proot


def port_ps(proot, **kw):
    cfg = Config(data_root=proot, **{**SERVE, **kw})
    cfg.ensure_dirs()
    reg = FunctionRegistry(config=cfg)
    if not reg.exists("lmfn"):
        reg.create("lmfn", PORT_FN)
    return ParameterServer(registry=reg, config=cfg, device="cpu")


def jax_ps(jroot, **kw):
    cfg = JConfig(data_root=jroot, paged_attn="gather",
                  int8_matmul_impl="dot", **{**SERVE, **kw})
    cfg.ensure_dirs()
    reg = JRegistry(config=cfg)
    if not reg.exists("lmfn"):
        reg.create("lmfn", JAX_FN)
    return JPS(registry=reg, config=cfg)


def close(ps):
    for d, _ in list(ps._decoders.values()):
        d.close()


def serve(ps, workload=WORKLOAD):
    """Requests one at a time; (tokens, prefix_cached_tokens, spec
    proposed) per request and the decoder's telemetry."""
    try:
        out = []
        for prompt, n in workload:
            r = ps.generate(JOB, {"prompts": [prompt], "max_new_tokens": n})
            out.append((r["tokens"][0][:r["lengths"][0]],
                        r["prefix_cached_tokens"], r["spec_proposed_tokens"]))
        return out, ps._decoders[JOB][0].telemetry()
    finally:
        close(ps)


@pytest.mark.parametrize("mode", ["f32", "int8", "spec_self"])
def test_generate_matches_the_jax_ps(tmp_path, weights, mode):
    """The same final file through both servers: greedy tokens, shared
    prefix tokens and the counters equal (int8: both serve their own
    ``final-int8`` exports, whose q and s are bit for bit equal)."""
    jroot, proot = roots(tmp_path, weights)
    kw = {"f32": {}, "int8": dict(serving_quantize="int8", int8_matmul=True),
          "spec_self": dict(serving_spec="self", spec_exit_layer=1, spec_k=2,
                            spec_adaptive=False)}[mode]
    jps, tps = jax_ps(jroot, **kw), port_ps(proot, **kw)
    if mode == "int8":
        assert jax_quantize(JOB, JStore(root=jroot / "checkpoints"),
                            ShardedCheckpointStore(root=jroot / "checkpoints"),
                            registry=jps.registry) == "flat"
        assert quantize_final_checkpoint(
            JOB, CheckpointStore(root=proot / "checkpoints"),
            registry=tps.registry) == "flat"
        assert tps._serving_source(JOB)[1] == INT8_TAG
    want, jt = serve(jps)
    got, tt = serve(tps)
    assert got == want
    assert got[1][1] == 4  # one full page of 4 from the trie
    if mode == "spec_self":
        assert all(p > 0 for _, _, p in got)
        assert isinstance(tps._decoders[JOB][0], PagedBatchingDecoder)
        assert tps._decoders[JOB][0].spec == "self"
    assert set(tt) - BY_DESIGN == set(jt) - BY_DESIGN
    if mode == "spec_self":
        # the spec engine's chunk and slot-step accounting differs by
        # design: the keys tests/test_torch_spec_decode.py holds equal
        for key in SPEC_KEYS:
            assert tt[key] == jt[key], key
    else:
        assert counters(tt) == counters(jt)
    if mode == "int8":
        assert tps._decoders[JOB][0].int8_matmul
        # every projection and the lm_head run int8
        assert tt["weight_bytes"] == jt["weight_bytes"]


def test_quantized_exports_are_bit_identical(tmp_path, weights):
    """``quantize_final_checkpoint`` writes the same leaves, the same q and
    s bit for bit, the same epoch and meta as the JAX package's."""
    jroot, proot = roots(tmp_path, weights)
    jstore = JStore(root=jroot / "checkpoints")
    pstore = CheckpointStore(root=proot / "checkpoints")
    jax_quantize(JOB, jstore, ShardedCheckpointStore(root=jstore.root))
    quantize_final_checkpoint(JOB, pstore)
    theirs = jstore.read_meta(JOB, INT8_TAG)
    mine = pstore.read_meta(JOB, INT8_TAG)
    assert mine["dtypes"] == theirs["dtypes"]
    assert (mine["epoch"], mine["meta"]) == (theirs["epoch"], theirs["meta"])
    assert mine["meta"]["quantized"] == "int8"
    quantized = [p for p in mine["dtypes"] if p.endswith(Q8_Q)]
    assert len(quantized) == 2 * 6 + 1  # 6 projections a block, lm_head
    assert not any("embed" in p for p in quantized)
    with np.load(pstore.export_path(JOB, tag=INT8_TAG)) as a, \
            np.load(jstore.export_path(JOB, tag=INT8_TAG)) as b:
        for p in mine["dtypes"]:
            assert a[p].dtype == b[p].dtype, p
            assert a[p].tobytes() == b[p].tobytes(), p
    s = pstore.restore(JOB, tag=INT8_TAG).variables["params"]["lm_head"][
        "kernel"][Q8_S]
    assert s.shape == (1, 64) and s.dtype == np.float32


def test_final_int8_is_served_only_while_fresh(tmp_path, weights):
    """Under int8 serving a final-int8 at least as fresh as the final is
    served; a newer final (a retrain) is served instead."""
    _, proot = roots(tmp_path, weights)
    ps = port_ps(proot, serving_quantize="int8")
    store = CheckpointStore(root=proot / "checkpoints")
    quantize_final_checkpoint(JOB, store)
    assert ps._serving_source(JOB)[1] == INT8_TAG
    final = store.export_path(JOB, tag=FINAL_TAG)
    later = store.export_path(JOB, tag=INT8_TAG).stat().st_mtime_ns + 10**9
    os.utime(final, ns=(later, later))
    assert ps._serving_source(JOB)[1:] == (FINAL_TAG, later)
    assert port_ps(proot)._serving_source(JOB)[1] == FINAL_TAG


def test_stream_and_metrics(tmp_path, weights):
    """A streamed request concatenates to the one-shot tokens; the
    exposition carries the serving series under the JAX names, and the
    running-inference gauge returns to 0."""
    jroot, proot = roots(tmp_path, weights)
    ps = port_ps(proot)
    try:
        one = ps.generate(JOB, {"prompts": [[5, 6, 7]], "max_new_tokens": 6})
        parts = list(ps.generate(JOB, {"prompts": [[5, 6, 7]],
                                       "max_new_tokens": 6, "stream": True}))
        toks = [t for p in parts if "tokens" in p for t in p["tokens"]]
        assert toks == one["tokens"][0] and parts[-1]["done"]
        text = ps.metrics.render()
        assert f'kubeml_serving_tokens_total{{model="{JOB}"}} 12' in text
        assert 'kubeml_job_running_total{type="inference"} 0' in text
        assert f'kubeml_serving_first_token_seconds_bucket{{model="{JOB}"' \
            in text
        # the same metric names as the JAX exposition's serving series
        jps = jax_ps(jroot)
        jps.generate(JOB, {"prompts": [[5, 6, 7]], "max_new_tokens": 6})
        names = {ln.split()[2] for ln in jps.metrics.render().splitlines()
                 if ln.startswith("# TYPE kubeml_serving")}
        close(jps)
        assert names == {ln.split()[2] for ln in text.splitlines()
                         if ln.startswith("# TYPE kubeml_serving")}
    finally:
        close(ps)


def test_resaved_checkpoint_builds_a_new_decoder(tmp_path, weights):
    """A re-saved final (new mtime) builds a new decoder and retires the
    old one; a closed decoder is rebuilt."""
    _, proot = roots(tmp_path, weights)
    ps = port_ps(proot)
    req = {"prompts": [[1, 2, 3]], "max_new_tokens": 3}
    try:
        first = ps.generate(JOB, req)
        old = ps._decoders[JOB][0]
        assert ps.generate(JOB, req)["tokens"] == first["tokens"]
        assert ps._decoders[JOB][0] is old
        path = CheckpointStore(root=proot / "checkpoints").export_path(JOB)
        bumped = path.stat().st_mtime_ns + 10**9
        os.utime(path, ns=(bumped, bumped))
        assert ps.generate(JOB, req)["tokens"] == first["tokens"]
        new = ps._decoders[JOB][0]
        assert new is not old and old._retired and not new._retired
        new.close()
        ps.generate(JOB, req)
        assert ps._decoders[JOB][0] is not new
    finally:
        close(ps)


def test_bad_spec_config_degrades_to_plain(tmp_path, weights):
    """A spec configuration the engine rejects (an exit layer past the
    depth, a draft with no model, a draft model that does not load)
    serves without speculation (tests/test_spec_decode.py:651)."""
    _, proot = roots(tmp_path, weights)
    for kw in (dict(serving_spec="self", spec_exit_layer=99),
               dict(serving_spec="draft"),
               dict(serving_spec="draft", spec_draft_model="nosuchjob"),
               dict(serving_spec="sideways")):
        ps = port_ps(proot, **kw)
        try:
            out = ps.generate(JOB, {"prompts": [[1, 2, 3, 4]],
                                    "max_new_tokens": 4})
            assert len(out["tokens"][0]) == 4
            assert out["spec_proposed_tokens"] == 0
            assert ps._decoders[JOB][0].spec == ""
        finally:
            close(ps)


def test_spec_degrade_does_not_hide_other_failures(tmp_path, weights,
                                                   monkeypatch):
    """A failure that is not the spec configuration's (here, the arena's
    allocation) propagates with spec on."""
    from kubeml_tpu_torch.serving import batcher

    _, proot = roots(tmp_path, weights)
    ps = port_ps(proot, serving_spec="self", spec_exit_layer=1)

    def broken(*a, **kw):
        raise RuntimeError("kernel build failed")

    monkeypatch.setattr(batcher, "init_paged_cache", broken)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        ps.generate(JOB, {"prompts": [[1, 2]], "max_new_tokens": 2})
    assert JOB not in ps._decoders


def test_draft_model_serves_from_its_checkpoint(tmp_path, weights):
    """``spec=draft`` loads the drafter from another finished job's final
    through the same loader; greedy tokens equal plain decode."""
    _, proot = roots(tmp_path, weights)
    (proot / "checkpoints" / "draftjob").mkdir()
    (proot / "checkpoints" / "draftjob" / "final.npz").write_bytes(
        (proot / "checkpoints" / JOB / "final.npz").read_bytes())
    want, _ = serve(port_ps(proot))
    ps = port_ps(proot, serving_spec="draft", spec_draft_model="draftjob",
                 spec_k=2, spec_adaptive=False)
    got, tele = serve(ps)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert tele["spec_steps"] > 0 and ps._decoders[JOB][0].spec == "draft"


def drain_one(ps, prompt, n):
    """Stream one request through ``ps``, drain its decoder right after
    the first token; returns the partial tokens of the 503."""
    ps.generate(JOB, {"prompts": [[1]], "max_new_tokens": 1})  # the decoder
    dec = ps._decoders[JOB][0]
    hold_steps(dec, lambda: dec._drain_req is not None)
    gen = ps.generate(JOB, {"prompts": [prompt], "max_new_tokens": n,
                            "stream": True})
    next(gen)
    out = ps.drain_serving(grace=0.0)
    assert out["snapshots"] == 1 and len(out["written"]) == 1
    assert out["written"][0].endswith(".kms")
    with pytest.raises(Exception) as err:
        list(gen)
    assert getattr(err.value, "status_code", None) == 503
    return err.value.partial_tokens[0]


def restore_all(ps):
    out = ps.restore_serving()
    assert out["failed"] == [] and len(out["restored"]) == 1
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        rows = ps.restored_snapshot()
        if all(r["done"] for r in rows):
            return rows
        time.sleep(0.02)
    raise AssertionError("restored requests did not finish")


@pytest.mark.parametrize("drainer", ["port", "jax"])
def test_drain_and_restore_in_a_fresh_server(tmp_path, weights, drainer):
    """A request drained mid-stream into ``snap_dir`` by one server (the
    port's, or the JAX package's: greedy f32) is restored by a fresh port
    server, and its stream equals the uninterrupted run."""
    jroot, proot = roots(tmp_path, weights)
    snap = str(tmp_path / "snaps")
    prompt, n = [7, 8, 9, 10, 11, 12], 20
    want, _ = serve(port_ps(proot), [(prompt, n)])
    first = (port_ps(proot, snap_dir=snap) if drainer == "port"
             else jax_ps(jroot, snap_dir=snap))
    try:
        partial = drain_one(first, prompt, n)
    finally:
        close(first)
    assert 0 < len(partial) < n and want[0][0][:len(partial)] == partial
    fresh = port_ps(proot, snap_dir=snap)
    try:
        rows = restore_all(fresh)
        assert rows[0]["tokens"][0] == want[0][0]
        assert rows[0]["model"] == JOB and rows[0]["error"] is None
        assert os.listdir(snap) == []
        assert fresh._decoders[JOB][0].telemetry()["snapshot_restored"] == 1
    finally:
        close(fresh)


def test_not_found_and_not_ported(tmp_path, weights, caplog):
    """404 for an unknown or malformed id; a serving mesh on a server of
    one rank logs and serves on that rank with the same tokens (JAX's
    fallback); 404 for a job's epoch checkpoints before its final (as
    JAX's ``_load_serving``); a model with no decode path is the one-shot path's
    400, as in the JAX server. A
    sharded final (ported now) serves the tokens of the same weights'
    flat final and quantizes into a sharded ``final-int8``."""
    _, proot = roots(tmp_path, weights)
    ps = port_ps(proot)
    req = {"prompts": [[1, 2]], "max_new_tokens": 2}
    for mid in ("nosuchjob", "a/b", ".hidden"):
        for call in (lambda: ps.generate(mid, req),
                     lambda: ps.infer(mid, [[1]])):
            with pytest.raises(KubeMLError) as e:
                call()
            assert e.value.status_code == 404
    one, meshed = port_ps(proot), port_ps(proot, serving_mesh="tp=2")
    want = one.generate(JOB, req)
    with caplog.at_level("WARNING", logger="kubeml.ps"):
        assert meshed.generate(JOB, req)["tokens"] == want["tokens"]
    assert "serving mesh 'tp=2' refused" in caplog.text
    assert getattr(meshed._decoders[JOB][0], "mesh", None) is None
    close(one)
    close(meshed)
    store = CheckpointStore(root=proot / "checkpoints")
    store.save("livejob", {"params": {"w": np.zeros(2, np.float32)}},
               epoch=0)
    # epoch checkpoints without a final export serve nothing: JAX's 404
    for call in (lambda: ps.generate("livejob", req),
                 lambda: ps.infer("livejob", [[1]])):
        with pytest.raises(KubeMLError) as e:
            call()
        assert e.value.status_code == 404
    ps.registry.create("lenetfn", LENET_FN)
    store.save("lenetjob", {"params": {"w": np.zeros(2, np.float32)}},
               tag=FINAL_TAG, meta={"request": {"function_name": "lenetfn"}})
    with pytest.raises(KubeMLError, match="KV-cache decode") as e:
        ps.generate("lenetjob", req)
    assert e.value.status_code == 400
    assert ps._decoders == {}
    from kubeml_tpu_torch.storage.sharded_checkpoint import \
        ShardedCheckpointStore as PortShardedStore

    PortShardedStore(root=proot / "checkpoints").save(
        "shardjob", weights, epoch=1, tag=FINAL_TAG,
        meta={"request": {"function_name": "lmfn"}})
    try:
        assert ps._serving_source("shardjob")[0] == "sharded"
        req = {"prompts": [[1, 2, 3, 4]], "max_new_tokens": 6}
        assert (ps.generate("shardjob", req)["tokens"]
                == ps.generate(JOB, req)["tokens"])
    finally:
        close(ps)
    assert quantize_final_checkpoint("shardjob", store) == "sharded"
    assert INT8_TAG in PortShardedStore(root=store.root).tags("shardjob")


# --- the dense engine, the one-shot path, MoE finals, live jobs ---------

MOE_MODEL = dict(MODEL, num_experts=4, moe_every=2)

PORT_MOE_FN = PORT_FN.replace("depth=2, num_heads=4, device=\"cpu\")",
                              "depth=2, num_heads=4, moe_every=2, "
                              "num_experts=4, device=\"cpu\")")
JAX_MOE_FN = JAX_FN.replace("depth=2, num_heads=4)",
                            "depth=2, num_heads=4, moe_every=2, "
                            "num_experts=4)")


@pytest.fixture(scope="module")
def moe_weights():
    module = JaxTransformer(**MOE_MODEL)
    v = module.init(jax.random.PRNGKey(1), np.zeros((1, 4), np.int32))
    return numpy_tree(v)


def moe_pair(tmp_path, moe_weights, **kw):
    """A JAX and a port server over one MoE final (the functions of the
    same name build each package's MoE model)."""
    assert PORT_MOE_FN != PORT_FN and JAX_MOE_FN != JAX_FN
    jroot, proot = roots(tmp_path, moe_weights)
    jps, tps = jax_ps(jroot, **kw), port_ps(proot, **kw)
    jps.registry.delete("lmfn")
    jps.registry.create("lmfn", JAX_MOE_FN)
    tps.registry.delete("lmfn")
    tps.registry.create("lmfn", PORT_MOE_FN)
    return jroot, proot, jps, tps


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_moe_final_is_served_by_the_dense_engine(tmp_path, moe_weights,
                                                 mode):
    """An MoE final has no paged decode path: both servers serve it
    through their dense ``BatchingDecoder`` (int8: the ``final-int8``
    export, the int8 matmul turned off for MoE and the weights
    dequantized in each step), with equal greedy tokens and counters."""
    from kubeml_tpu_torch.serving import BatchingDecoder

    kw = dict(serving_quantize="int8", int8_matmul=True) if mode == "int8" \
        else {}
    jroot, proot, jps, tps = moe_pair(tmp_path, moe_weights, **kw)
    if mode == "int8":
        jax_quantize(JOB, JStore(root=jroot / "checkpoints"),
                     ShardedCheckpointStore(root=jroot / "checkpoints"),
                     registry=jps.registry)
        quantize_final_checkpoint(
            JOB, CheckpointStore(root=proot / "checkpoints"),
            registry=tps.registry)
    want, jt = serve(jps)
    got, tt = serve(tps)
    assert [g[0] for g in got] == [w[0] for w in want]
    dec = tps._decoders[JOB][0]
    assert isinstance(dec, BatchingDecoder)
    assert type(jps._decoders[JOB][0]).__name__ == "BatchingDecoder"
    if mode == "int8":
        assert dec.quantize == "int8" and not dec.int8_matmul
        assert dec.module.block_1.moe.quantized
    for key in ("requests_submitted", "requests_completed",
                "tokens_emitted", "admission_waves", "prefill_tokens",
                "goodput_tokens", "wasted_tokens"):
        assert tt[key] == jt[key], key


def test_moe_final_int8_is_bit_identical_to_jax(tmp_path, moe_weights):
    """``final-int8`` of an MoE final: every leaf, the 3-D expert stacks'
    per-last-axis scales over all experts included, bit for bit the JAX
    package's."""
    jroot, proot, jps, tps = moe_pair(tmp_path, moe_weights)
    jstore = JStore(root=jroot / "checkpoints")
    pstore = CheckpointStore(root=proot / "checkpoints")
    jax_quantize(JOB, jstore, ShardedCheckpointStore(root=jstore.root))
    quantize_final_checkpoint(JOB, pstore)
    mine, theirs = (st.read_meta(JOB, INT8_TAG) for st in (pstore, jstore))
    assert mine["dtypes"] == theirs["dtypes"]
    assert "params/block_1/moe/w_in/" + Q8_Q in mine["dtypes"]
    assert "params/block_1/moe/w_out/" + Q8_S in mine["dtypes"]
    with np.load(pstore.export_path(JOB, tag=INT8_TAG)) as a, \
            np.load(jstore.export_path(JOB, tag=INT8_TAG)) as b:
        for p in mine["dtypes"]:
            assert a[p].tobytes() == b[p].tobytes(), p
        assert a["params/block_1/moe/w_in/" + Q8_S].shape == (1, 1, 256)


@pytest.mark.parametrize("kw", [dict(serving_paged=False),
                                dict(serving_batcher=False)])
def test_dense_model_without_the_paged_engine(tmp_path, weights, kw):
    """``serving_paged=False`` serves through the dense engine,
    ``serving_batcher=False`` through the one-shot
    ``generate_from_request`` (no decoder): the JAX server's tokens."""
    from kubeml_tpu_torch.serving import BatchingDecoder

    jroot, proot = roots(tmp_path, weights)
    jps, tps = jax_ps(jroot, **kw), port_ps(proot, **kw)
    if kw.get("serving_batcher") is False:
        for prompt, n in WORKLOAD:
            body = {"prompts": [prompt], "max_new_tokens": n}
            assert tps.generate(JOB, body) == jps.generate(JOB, body)
        assert tps._decoders == {}
        return
    want, _ = serve(jps)
    got, tt = serve(tps)
    assert [g[0] for g in got] == [w[0] for w in want]
    assert isinstance(tps._decoders[JOB][0], BatchingDecoder)
    assert tt["prefix_hits"] == 0.0


def test_live_job_generate_serves_its_published_weights(tmp_path, weights):
    """``generate`` on a live job goes through ``TrainJob.generate``: the
    one-shot path on the replica-0 weights published at the last round's
    edge (the ones ``infer`` reads), with the JAX one-shot's tokens on
    those weights; a job still starting answers 503, as in JAX."""
    from kubeml_tpu.models.generation import \
        generate_from_request as jax_from_request
    from kubeml_tpu.api.types import GenerateRequest as JaxRequest
    from kubeml_tpu_torch.api.types import (TrainOptions, TrainRequest,
                                            TrainTask)
    from kubeml_tpu_torch.engine.job import TrainJob
    from kubeml_tpu_torch.interop.from_flax import to_flax
    from kubeml_tpu_torch.ps.parameter_server import _JobRecord
    from kubeml_tpu_torch.storage.history import HistoryStore
    from kubeml_tpu_torch.storage.store import ShardStore

    _, proot = roots(tmp_path, weights)
    ps = port_ps(proot)
    model = ps.registry.load("lmfn")
    req = TrainRequest(function_name="lmfn", dataset="tokens", epochs=1,
                       batch_size=2, lr=0.01,
                       options=TrainOptions(default_parallelism=1,
                                            precision="f32"))
    job = TrainJob("live", req, model, store=ShardStore(root=tmp_path / "d"),
                   history_store=HistoryStore(root=tmp_path / "h"),
                   device="cpu")
    with ps._lock:
        ps._jobs["live"] = _JobRecord(task=TrainTask(job_id="live"),
                                      job=None, thread=None)
    body = {"prompts": [[1, 2, 3, 4], [5, 6, 7, 0]], "max_new_tokens": 5,
            "prompt_lengths": [4, 3]}
    with pytest.raises(KubeMLError) as e:
        ps.generate("live", body)
    assert e.value.status_code == 503
    ps._jobs["live"].job = job
    with pytest.raises(KubeMLError, match="no model yet"):
        ps.generate("live", body)
    job._stacked_vars = job.trainer.init_variables(
        torch.Generator().manual_seed(3), np.zeros((1, 4), np.int64), 1)
    job._publish()
    got = ps.generate("live", body)
    flat = {k: v for k, v in job._published["params"].items()}
    jm = JaxTransformer(**MODEL)
    want = jax_from_request(jm, to_flax(flat), JaxRequest(**body))
    assert got == {"tokens": want["tokens"], "lengths": want["lengths"]}
    streamed = list(ps.generate("live", {**body, "stream": True}))
    assert streamed[-1] == {"done": True, "lengths": got["lengths"]}
