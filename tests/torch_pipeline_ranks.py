"""Rank functions for the pipeline's multi-rank tests
(``tests/test_torch_pipeline.py``, ``tests/test_torch_gpt_pipeline.py``).

Spawned by ``kubeml_tpu_torch.parallel.distributed.spawn`` (gloo, one
thread a rank, a ``FileStore`` under a temporary directory), so this
module imports torch and the port only, never JAX. A rank writes what the
test checks to ``{out}/rank{r}.pt``; ``torch_dist_ranks.run`` reads them
back.
"""

from __future__ import annotations

import hashlib

import torch

from kubeml_tpu_torch.interop.from_flax import gather_tree, shard_tree
from kubeml_tpu_torch.models.layers import load_tree
from kubeml_tpu_torch.parallel import distributed as D
from kubeml_tpu_torch.parallel.mesh import local_block, make_mesh
from torch_dist_ranks import _save


def lm_rank(rank: int, out: str, spec) -> None:
    """World 4: ``PipelinedLM`` at each ``spec["lm"]`` mesh (its logits,
    this rank's ``[B/dp]`` rows) and three ``PipelineTrainer`` steps at
    ``spec["trainer"]``'s; ``PipelinedCausalLM`` (learned and rope
    positions) at ``spec["causal"]``'s mesh."""
    from kubeml_tpu_torch.models.gpt_pipeline import PipelinedCausalLM
    from kubeml_tpu_torch.parallel import pipeline as P

    assert D.init_distributed(device="cpu")
    ids = torch.from_numpy(spec["ids"])
    res = {}
    for tag, axes, cfg, weights in spec["lm"]:
        mesh = make_mesh(**axes)
        m = P.PipelinedLM(mesh, device="cpu", **cfg)
        load_tree(m, shard_tree(weights, mesh, spec_of=P.partition_spec))
        with torch.no_grad():
            logits = m(local_block(mesh, ids, ("dp",)))
        res[tag] = dict(logits=logits.numpy(), coord=mesh.coord,
                        shape=mesh.shape,
                        stage=tuple(m.stages.layer_0.query.kernel.shape))
    axes, cfg, weights, batches, lr = spec["trainer"]
    mesh = make_mesh(**axes)
    m = P.PipelinedLM(mesh, device="cpu", **cfg)
    load_tree(m, shard_tree(weights, mesh, spec_of=P.partition_spec))
    tr = P.PipelineTrainer(m, lr=lr)
    tr.init(batches[0])
    res["trainer"] = [float(tr.train_step(b)) for b in batches]
    axes, cfgs, weights = spec["causal"]
    mesh = make_mesh(**axes)
    for pos, cfg in cfgs.items():
        m = PipelinedCausalLM(mesh=mesh, device="cpu", **cfg)
        load_tree(m, shard_tree(weights[pos], mesh))
        with torch.no_grad():
            logits = m(local_block(mesh, ids, ("dp",)))
        res[f"causal-{pos}"] = dict(logits=logits.numpy(), coord=mesh.coord,
                                    shape=mesh.shape)
    _save(out, rank, res)


def replicated_digest(module) -> str:
    """sha256 over this rank's leaves that are replicated over ``pp``
    (every leaf but the stage stack), in name order."""
    h = hashlib.sha256()
    for name, p in module.named_parameters():
        if not name.startswith("stages."):
            h.update(p.detach().reshape(-1).view(torch.uint8).numpy()
                     .tobytes())
    return h.hexdigest()


def trainer_rank(rank: int, out: str, spec) -> None:
    """World 8: ``PipelinedCausalLM`` trained by ``SPMDTrainer`` (f32)
    over each mesh of ``spec["meshes"]`` from the carried weights: the
    step losses, the first step's gradients gathered whole (rank 0), the
    eval metrics after the last step, the digest of the leaves replicated
    over ``pp`` and the local stage stack's shape."""
    from kubeml_tpu_torch.models.gpt_pipeline import PipelinedCausalLM
    from kubeml_tpu_torch.parallel.trainer import SPMDTrainer

    assert D.init_distributed(device="cpu")
    res = {}
    for tag, axes in spec["meshes"]:
        mesh = make_mesh(**axes)
        m = PipelinedCausalLM(mesh=mesh, device="cpu", **spec["cfg"])
        load_tree(m, shard_tree(spec["weights"], mesh))
        tr = SPMDTrainer(m, mesh, precision="f32")
        tr.init(spec["batches"][0])
        losses, grads = [], None
        for i, b in enumerate(spec["batches"]):
            losses.append(float(tr.train_step(b)))
            if i == 0:
                grads = gather_tree({n: p.grad for n, p in
                                     m.named_parameters()}, mesh)
        res[tag] = dict(
            losses=losses, coord=mesh.coord,
            grads=({n: g.numpy() for n, g in grads.items()} if rank == 0
                   else None),
            eval=tr.eval_metrics(spec["batches"][0]),
            digest=replicated_digest(m),
            stage=tuple(m.stages.layer_0.attn.query.kernel.shape))
    _save(out, rank, res)
