"""Rank functions for the port's MoE tests over ranks
(``tests/test_torch_moe_ep.py``, ``tests/test_torch_moe_ep_steps.py``).

Each runs in a process that ``kubeml_tpu_torch.parallel.distributed.spawn``
starts (gloo, one thread, a ``FileStore`` under a temporary directory), so
this module imports torch and the port only, never JAX. A rank writes what
the test checks to ``{out}/rank{r}.pt`` (``torch_dist_ranks.run`` reads
them back).
"""

from __future__ import annotations

import torch

from kubeml_tpu_torch.parallel import distributed as D
from kubeml_tpu_torch.parallel.mesh import local_block, make_mesh
from torch_dist_ranks import _save


def router_noise(module, scale: float):
    """Set every MoE layer's router noise scale (0: a training step is the
    deterministic forward, dropout being 0, which JAX's ``train=False``
    computes); returns ``module``."""
    from kubeml_tpu_torch.parallel.moe import moe_layers

    for m in moe_layers(module):
        m.router_noise = scale
    return module


def model_rank(rank: int, out: str, spec) -> None:
    """World 8. For each ``spec["meshes"]`` case ``(tag, axes, sp_impl)``:
    the MoE LM carried from ``spec["weights"]`` onto the mesh, its logits
    of this rank's ``P("dp", "sp")`` block of ``spec["ids"]`` (train=False),
    then one f32 ``SPMDTrainer`` step with the router noise off: the loss
    (aux included), the overflow, the shard shapes and the gradients
    gathered over ep and tp. Then, on ranks 0 and 1 of the world, each
    ``spec["trap"]`` case ``(tag, axes)``: a ``MoEMlp`` over that world-2
    mesh on this rank's block of ``spec["trap_x"]``, its output, aux loss
    and overflow."""
    from kubeml_tpu_torch.interop.from_flax import gather_tree, shard_tree
    from kubeml_tpu_torch.models.gpt import CausalTransformer
    from kubeml_tpu_torch.models.layers import load_tree
    from kubeml_tpu_torch.parallel.moe import MoEMlp
    from kubeml_tpu_torch.parallel.trainer import SPMDTrainer

    assert D.init_distributed(device="cpu")
    ids = torch.from_numpy(spec["ids"])
    res = {}
    for tag, axes, impl in spec["meshes"]:
        mesh = make_mesh(**axes)
        model = load_tree(CausalTransformer(mesh=mesh, sp_impl=impl,
                                            device="cpu", **spec["cfg"]),
                          shard_tree(spec["weights"], mesh))
        with torch.no_grad():
            logits = model(local_block(mesh, ids)).numpy()
        router_noise(model, 0.0)
        tr = SPMDTrainer(model, mesh, precision="f32")
        tr.init(spec["ids"])
        loss = float(tr.train_step(spec["ids"]))
        grads = gather_tree({n: p.grad for n, p in model.named_parameters()},
                            mesh)
        res[tag] = dict(
            coord=mesh.coord, shape=mesh.shape, logits=logits, loss=loss,
            overflow=float(tr.last_moe_overflow),
            shards={n: tuple(p.shape) for n, p in model.named_parameters()},
            grads={n: g.numpy() for n, g in grads.items()})
    for tag, axes in spec["trap"]:
        mesh = make_mesh(axes, ranks=[0, 1])
        if not mesh.member:
            continue
        mlp = MoEMlp(**spec["trap_cfg"], mesh=mesh)
        with torch.no_grad():
            for name, value in spec["trap_weights"].items():
                getattr(mlp, name).copy_(torch.from_numpy(value))
            y = mlp(local_block(mesh, torch.from_numpy(spec["trap_x"])))
        res[tag] = dict(coord=mesh.coord, shape=mesh.shape, out=y.numpy(),
                        aux=float(mlp.last_aux),
                        overflow=float(mlp.last_overflow))
    _save(out, rank, res)


def steps_rank(rank: int, out: str, spec) -> None:
    """World 2. For each ``spec["meshes"]`` case ``(tag, axes, sp_impl)``:
    the MoE LM from ``spec["seed"]`` (router noise ``spec["noise"]``) trained
    ``len(spec["rngs"])`` f32 steps by ``SPMDTrainer`` on ``spec["batch"]``,
    step i's rng ``spec["rngs"][i]``: each step's loss and overflow, and
    after the ep=2 steps the trained model's greedy decode over the ranks
    beside one rank's decode of the same weights, gathered."""
    from kubeml_tpu_torch.interop.from_flax import gather_tree
    from kubeml_tpu_torch.models.generation import generate
    from kubeml_tpu_torch.models.gpt import CausalTransformer
    from kubeml_tpu_torch.models.layers import load_tree
    from kubeml_tpu_torch.parallel.trainer import SPMDTrainer

    assert D.init_distributed(device="cpu")
    res = {}
    for tag, axes, impl in spec["meshes"]:
        mesh = make_mesh(**axes)
        model = router_noise(CausalTransformer(
            mesh=mesh, sp_impl=impl, seed=spec["seed"], device="cpu",
            **spec["cfg"]), spec["noise"])
        tr = SPMDTrainer(model, mesh, precision="f32")
        tr.init(spec["batch"])
        losses, over = [], []
        for r in spec["rngs"]:
            losses.append(float(tr.train_step(spec["batch"], rng=r)))
            over.append(float(tr.last_moe_overflow))
        res[tag] = dict(losses=losses, overflow=over)
        if tag == "ep=2":
            prompt = torch.tensor([[1, 2, 3, 4]])
            res["decode"] = generate(model, prompt, max_new_tokens=6
                                     ).tokens.tolist()
            whole = load_tree(
                CausalTransformer(seed=spec["seed"], device="cpu",
                                  **spec["cfg"]),
                gather_tree(dict(model.named_parameters()), mesh))
            res["decode_one_rank"] = generate(whole, prompt,
                                              max_new_tokens=6
                                              ).tokens.tolist()
    _save(out, rank, res)
