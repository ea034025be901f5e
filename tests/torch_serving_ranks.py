"""Rank functions for ``tests/test_torch_sharded_serving.py``: meshed
serving over two gloo ranks on the CPU.

Spawned ranks import this module to find their function, so it imports
torch and the port only, never JAX. A rank writes what the test checks to
``{out}/rank{r}.pt`` (``torch_dist_ranks.run`` reads them back).

:func:`serving_rank` runs, in order on both ranks:

1. the dense ``BatchingDecoder(mesh=)`` on rank 0 and ``serve_follower``
   on rank 1, once a case of ``spec["cases"]``: each serves its requests
   one at a time, and rank 0 serves them again on one rank (no mesh)
   from the same weights; after each case both ranks compute the placed
   model's plain forward on ``spec["ids"]`` (its f32 logits) and keep
   their blocks of a few leaves;
2. a cluster over the ranks (``LocalCluster`` on rank 0, no HTTP, with
   ``serving_mesh="tp=2"``; ``run_follower`` on rank 1): a tp=2 SPMD job
   and a pp=2 one (``PP_FN``) with sharded checkpoints, the first's final
   quantized into a sharded ``final-int8``, then ``/generate`` of both
   finals on the mesh (the pp=2 one through its ``serving_remap``), each
   beside a one-rank parameter server's tokens; then a third job over the
   ranks during which (:func:`busy_ranks`) the meshed decoders retire and
   a final that is no causal LM (``LINEAR_FN``) is asked to generate;
   the follower records its serving shards at each shutdown; then a second
   cluster with ``serving_quantize="int8"`` serves the ``final-int8``
   block by block.
"""

from __future__ import annotations

import os
import threading
import time
from pathlib import Path

import torch

from kubeml_tpu_torch.api.errors import KubeMLError
from kubeml_tpu_torch.api.types import GenerateRequest
from kubeml_tpu_torch.parallel import distributed as D

# an LM trained as a two-stage pipeline over pp and served flat: its final
# holds params/stages/layer_{0,1}/* [2, ...], a stage a rank's file
PP_FN = """
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.gpt import CausalTransformer
from kubeml_tpu_torch.models.gpt_pipeline import (PipelinedCausalLM,
                                                  flat_serving_remap)
from kubeml_tpu_torch.parallel.trainer import adamw
from kubeml_tpu_torch.runtime.model import KubeModel

class Tokens(KubeDataset):
    def __init__(self):
        super().__init__("tokens")

class Model(KubeModel):
    def __init__(self):
        super().__init__(Tokens())
    def build(self):
        dims = dict(vocab_size=64, max_len=16, embed_dim=32, depth=4,
                    num_heads=4, device="cpu")
        if self.task == "train":
            return PipelinedCausalLM(stages=2, microbatches=4,
                                     mesh=self.mesh, **dims)
        return CausalTransformer(**dims)
    def serving_remap(self):
        return flat_serving_remap(2, 2)
    def configure_optimizers(self, params):
        return adamw(self.lr)(params)
"""


# a finished model that is no causal LM: it cannot be meshed, and its
# /generate is the one-rank answer (a 400: no decode path)
LINEAR_FN = """
import torch
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.runtime.model import KubeModel

class Tokens(KubeDataset):
    def __init__(self):
        super().__init__("tokens")

class Model(KubeModel):
    def __init__(self):
        super().__init__(Tokens())
    def build(self):
        return torch.nn.Linear(4, 2)
"""


def _requests(reqs):
    return [GenerateRequest(**r) for r in reqs]


def _serve(dec, reqs) -> list:
    """Each request's result, served one at a time."""
    try:
        return [dec.wait(dec.submit(r), timeout=120) for r in reqs]
    finally:
        dec.close()


def _blocks(module, names) -> dict:
    """This rank's block of each named leaf (int8 ones as (q, s))."""
    out = {}
    for name in names:
        owner, _, leaf = name.rpartition(".")
        m = module.get_submodule(owner)
        if getattr(m, "quantized", False) and leaf == "kernel":
            out[name] = (m.kernel_q.numpy().copy(), m.kernel_s.numpy().copy())
        else:
            out[name] = getattr(m, leaf).detach().numpy().copy()
    return out


def _model(case: dict):
    """The case's model built whole on the CPU with its weights."""
    from kubeml_tpu_torch.interop.from_flax import from_flax
    from kubeml_tpu_torch.models.gpt import CausalTransformer
    from kubeml_tpu_torch.models.layers import load_tree

    return load_tree(CausalTransformer(device="cpu", **case["model"]),
                     from_flax(case["weights"]))


def decoder_case(rank: int, case: dict, ids) -> dict:
    """One case: rank 0's meshed decoder (and its one-rank twin), rank 1
    following; then the placed model's logits and blocks."""
    from kubeml_tpu_torch.parallel.mesh import serving_mesh
    from kubeml_tpu_torch.serving import BatchingDecoder
    from kubeml_tpu_torch.serving.batcher import serve_follower

    mesh = serving_mesh(case["mesh"])
    module = _model(case)
    knobs = dict(slots=case.get("slots", 4), chunk_steps=4, device="cpu",
                 **case.get("knobs", {}))
    res = dict(coord=mesh.coord)
    if rank == 0:
        dec = BatchingDecoder(module, mesh=mesh, **knobs)
        res["mesh"] = dict(dec.mesh.shape)
        res["cache_k"] = tuple(dec.cache.layers[0]["k"].shape)
        res["tokens"] = [r["tokens"] for r in _serve(
            dec, _requests(case["requests"]))]
        one = BatchingDecoder(_model(case), **knobs)
        res["one_rank"] = [r["tokens"] for r in _serve(
            one, _requests(case["requests"]))]
    else:
        res["ops"] = serve_follower(module, mesh)
    res["blocks"] = _blocks(module, case.get("leaves", ()))
    if not case.get("knobs", {}).get("quantize"):
        with torch.no_grad():
            res["logits"] = module(torch.from_numpy(ids)).numpy()
    return res


def _generate(ps, job: str, req: dict) -> dict:
    return ps.generate(job, GenerateRequest(model_id=job, **req))


def _answer(ps, job: str, req: dict):
    """The tokens of a /generate, or its error's (status, message)."""
    try:
        return _generate(ps, job, req)["tokens"]
    except KubeMLError as e:
        return (e.status_code, e.message)


def busy_ranks(cluster, requests) -> dict:
    """A tp=2 job over the ranks that, at its first epoch's end (its thread
    holding the ranks' lock), lets another thread ask for the non-LM
    final's /generate and retire the two meshed decoders; their closes
    are left to the job (a wait of 0.2 s for the lock)."""
    import kubeml_tpu_torch.serving.batcher as B

    import torch_job_ranks as J

    ps = cluster.ps
    out = {}

    def act():
        t0 = time.monotonic()
        out["linjob"] = _answer(ps, "linjob", requests[0])
        out["linjob_s"] = time.monotonic() - t0
        out["unmeshable"] = "linjob" in ps._unmeshable
        decoders = [ps._decoders[job][0] for job in ("tpjob", "ppjob")]
        for dec in decoders:
            dec.retire()
        for dec in decoders:  # an engine thread exits once its close ends
            if dec._thread is not None:
                dec._thread.join(10)
        out["deferred"] = len(B._pending_closes)

    take = ps.metrics.update

    def during(update):
        take(update)
        if "deferred" not in out:
            thread = threading.Thread(target=act)
            thread.start()
            thread.join(60)

    ps.metrics.update = during
    wait, B.CLOSE_WAIT_S = B.CLOSE_WAIT_S, 0.2
    try:
        out["job"] = J.run_job(cluster, dict(id="busy", epochs=1, opts=dict(
            mesh_shape={"tp": 2}, static_parallelism=True,
            validate_every=0)))
    finally:
        ps.metrics.__dict__.pop("update", None)
        B.CLOSE_WAIT_S = wait
    out["after"] = len(B._pending_closes)  # sent at the job's end
    return out


def _recording_follower():
    """Make ``run_follower``'s ``ServingFollower`` record itself; returns
    the list they go into."""
    import kubeml_tpu_torch.serving.batcher as B

    made = []

    class Recorded(B.ServingFollower):
        def __init__(self):
            super().__init__()
            self.inits = 0
            made.append(self)

        def handle(self, cmd):
            self.inits += cmd.get("cmd") == "serve_init"
            super().handle(cmd)

    B.ServingFollower = Recorded
    return made


def cluster_serving(rank: int, spec: dict) -> dict:
    """Step 2 (see the module docstring)."""
    from kubeml_tpu_torch.api.config import Config
    from kubeml_tpu_torch.cluster import LocalCluster
    from kubeml_tpu_torch.engine.follower import run_follower
    from kubeml_tpu_torch.ps.parameter_server import ParameterServer
    from kubeml_tpu_torch.serving.quant import quantize_final_checkpoint
    from kubeml_tpu_torch.storage.checkpoint import CheckpointStore

    import torch_job_ranks as J

    root = Path(spec["root"])
    res = {}
    if rank != 0:
        made = _recording_follower()
        res["followed"] = [run_follower(config=Config(data_root=root))
                           for _ in range(2)]
        # (serve_init seen, shards left) of each run
        res["shards"] = [(f.inits, len(f.shards)) for f in made]
        return res

    def one_rank(**cfg):
        # the same dense engine on one rank
        return ParameterServer(config=Config(data_root=root,
                                             serving_paged=False, **cfg),
                               device="cpu")

    cfg = Config(data_root=root, serving_mesh="tp=2", serving_slots=2,
                 serving_chunk_steps=4)
    cluster = LocalCluster(config=cfg, device="cpu", serve_http=False)
    cluster.start(recover=False)
    try:
        for key, axes, fn in (("job", {"tp": 2}, "lmfn"),
                              ("ppjob_train", {"pp": 2}, "ppfn")):
            res[key] = J.run_job(cluster, dict(
                id="tpjob" if fn == "lmfn" else "ppjob", epochs=1, opts=dict(
                    mesh_shape=axes, sharded_checkpoints=True, fn=fn,
                    static_parallelism=True, validate_every=0)))
        store = CheckpointStore(config=cfg)
        res["int8_form"] = quantize_final_checkpoint(
            "tpjob", store, cluster.ps.registry)
        res["source"] = cluster.ps._serving_source("tpjob")[0]
        ref = one_rank(serving_slots=2, serving_chunk_steps=4)
        for job in ("tpjob", "ppjob"):
            res[job] = [_generate(cluster.ps, job, r)["tokens"]
                        for r in spec["requests"]]
            res[f"{job}_one_rank"] = [_generate(ref, job, r)["tokens"]
                                      for r in spec["requests"]]
            dec = cluster.ps._decoders[job][0]
            res[f"{job}_mesh"] = (None if dec.mesh is None
                                  else dict(dec.mesh.shape))
            res[f"{job}_cache_k"] = tuple(dec.cache.layers[0]["k"].shape)
        res["linjob_one_rank"] = _answer(ref, "linjob", spec["requests"][0])
        ref.close()
        res["busy"] = busy_ranks(cluster, spec["requests"])
    finally:
        cluster.stop()
    qcfg = Config(data_root=root, serving_mesh="tp=2",
                  serving_quantize="int8", int8_matmul=True,
                  serving_slots=2, serving_chunk_steps=4)
    cluster = LocalCluster(config=qcfg, device="cpu", serve_http=False)
    cluster.start(recover=False)
    try:
        ref = one_rank(serving_quantize="int8", int8_matmul=True,
                       serving_slots=2, serving_chunk_steps=4)
        res["int8"] = [_generate(cluster.ps, "tpjob", r)["tokens"]
                       for r in spec["requests"]]
        res["int8_one_rank"] = [_generate(ref, "tpjob", r)["tokens"]
                                for r in spec["requests"]]
        ref.close()
        dec = cluster.ps._decoders["tpjob"][0]
        res["int8_mesh"] = None if dec.mesh is None else dict(dec.mesh.shape)
        res["int8_blocks"] = _blocks(dec.module, ("block_0.mlp_in.kernel",
                                                  "block_0.mlp_out.kernel"))
    finally:
        cluster.stop()
    return res


def serving_rank(rank: int, out: str, spec: dict) -> None:
    """Both steps of the module docstring, in order."""
    assert D.init_distributed(device="cpu")
    res = {tag: decoder_case(rank, case, spec["ids"])
           for tag, case in spec["cases"].items()}
    res["cluster"] = cluster_serving(rank, spec["cluster"])
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
