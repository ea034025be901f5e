"""Rank functions for the port's multi-rank tests (``tests/test_torch_mesh_
dist.py``, ``test_torch_ring_ulysses.py``, ``test_torch_spmd_mesh.py``,
``test_torch_dist_cuda.py``).

Each runs in a process that ``kubeml_tpu_torch.parallel.distributed.spawn``
starts (gloo, one thread, a ``FileStore`` under a temporary directory), so
this module imports torch and the port only, never JAX: the spawned ranks
import it to find their function. A rank writes what the test checks to
``{out}/rank{r}.pt``; :func:`run` reads them back in the test process.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.distributed as dist

from kubeml_tpu_torch.parallel import distributed as D
from kubeml_tpu_torch.parallel.mesh import local_block, make_mesh

WORLD_TIMEOUT_S = 120.0


def run(fn, world: int, *args) -> list:
    """Spawn ``world`` ranks of ``fn(rank, out, *args)`` and return each
    rank's saved result, by rank."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="kubeml_ranks_") as out:
        D.spawn(fn, world, args=(out, *args), timeout_s=WORLD_TIMEOUT_S)
        return [torch.load(os.path.join(out, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _save(out: str, rank: int, result) -> None:
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


def assemble(parts, key: str, axes=("dp", "sp")) -> np.ndarray:
    """The global array of per-rank blocks ``part[key]`` sharded as
    ``P(*axes)`` (every rank's block at its mesh coordinates)."""
    first = parts[0][key]
    shape = list(first.shape)
    for dim, ax in enumerate(axes):
        shape[dim] *= parts[0]["shape"].get(ax, 1)
    full = np.zeros(shape, dtype=np.asarray(first).dtype)
    for part in parts:
        block = np.asarray(part[key])
        idx = tuple(slice(part["coord"].get(ax, 0) * block.shape[d],
                          (part["coord"].get(ax, 0) + 1) * block.shape[d])
                    for d, ax in enumerate(axes))
        full[idx] = block
    return full


# --- the mesh and the host channel --------------------------------------

def mesh_rank(rank: int, out: str) -> None:
    """World 8: the dp=2, sp=2, tp=2 mesh's coordinates and groups, and
    DistContext's broadcast, put/get and barrier."""
    assert D.init_distributed(device="cpu")
    mesh = make_mesh(dp=2, sp=2, tp=2)
    groups = {ax: dist.get_process_group_ranks(mesh.group(ax))
              for ax in ("dp", "sp", "tp")}
    replicas = dist.get_process_group_ranks(mesh.group("dp", "sp"))
    ctx = D.get_dist_context()
    got = ctx.broadcast_obj({"from": rank, "list": [1, 2]})
    flags = ctx.broadcast_flags(stop=rank == 0, parallelism=10 + rank)
    ctx.put(f"ack/{rank}", str(rank * rank))
    acks = [ctx.get(f"ack/{r}", timeout_s=30) for r in range(8)]
    ctx.barrier("once")
    ctx.barrier("once")  # a reused tag is a new barrier
    missing = ctx.get("never-set", timeout_s=0.2)
    _save(out, rank, dict(
        coord=mesh.coord, groups=groups, replicas=replicas,
        broadcast=got, flags=flags, acks=acks, missing=missing,
        device=str(mesh.device), backend=dist.get_backend(),
        slices=D.num_slices(), batch_slice=D.local_batch_slice(16),
        global_shape=D.global_mesh(sp=2, tp=2).shape))


# --- ring and Ulysses ----------------------------------------------------

def _count_flash(calls):
    """Route Ulysses' local attention through the flash autograd Function
    (its plain versions on the CPU, the card's structure) and count the
    forward and backward calls."""
    from kubeml_tpu_torch.ops import attention
    from kubeml_tpu_torch.ops import flash_attention as fa
    from kubeml_tpu_torch.parallel import ulysses

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    fa.flash_attention_fwd_ref = counting("fwd", fa.flash_attention_fwd_ref)
    fa.flash_attention_bwd_ref = counting("bwd", fa.flash_attention_bwd_ref)
    ulysses.dot_product_attention = functools.partial(
        attention.dot_product_attention, impl="cuda")


def attention_rank(rank: int, out: str, cases) -> None:
    """World 4: ring and Ulysses on ``sp=4`` and on ``dp=2, sp=2`` (rows
    over dp), each case's output and input gradients of ``sum(out * w)``
    as this rank's blocks; the indivisible-heads error."""
    from kubeml_tpu_torch.parallel.ring import ring_attention
    from kubeml_tpu_torch.parallel.ulysses import ulysses_attention

    assert D.init_distributed(device="cpu")
    meshes = {4: make_mesh(sp=4), 2: make_mesh(dp=2, sp=2)}
    calls = {"fwd": 0, "bwd": 0}
    _count_flash(calls)
    res = {}
    for tag, (impl, sp, causal, arrays) in cases.items():
        mesh = meshes[sp]
        q, k, v, w, valid = (
            None if a is None else local_block(mesh, torch.from_numpy(a))
            for a in arrays)
        q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
        fn = ring_attention if impl == "ring" else ulysses_attention
        before = dict(calls)
        o = fn(q, k, v, mesh, "sp", causal=causal, kv_valid=valid)
        (o * w).sum().backward()
        res[tag] = dict(out=o.detach().numpy(), dq=q.grad.numpy(),
                        dk=k.grad.numpy(), dv=v.grad.numpy(),
                        coord=mesh.coord, shape=mesh.shape,
                        flash={n: calls[n] - before[n] for n in calls})
    x = torch.zeros(2, 4, 3, 8)
    try:
        ulysses_attention(x, x, x, meshes[2])
        res["indivisible"] = None
    except ValueError as e:
        res["indivisible"] = str(e)
    _save(out, rank, res)


# --- the tensor- and sequence-parallel GPT and SPMDTrainer ---------------

def gpt_rank(rank: int, out: str, spec) -> None:
    """World 8 on ``dp=2, sp=2, tp=2``: logits of the carried models,
    three ``SPMDTrainer`` steps (losses, the first step's gradients and the
    final parameters, gathered over tp), the chunked loss under tp, an
    input transform, the shard shapes; then one step on ``dp=8``."""
    from kubeml_tpu_torch.interop.from_flax import gather_tree, shard_tree
    from kubeml_tpu_torch.models.gpt import CausalTransformer
    from kubeml_tpu_torch.models.layers import load_tree
    from kubeml_tpu_torch.parallel.trainer import SPMDTrainer

    assert D.init_distributed(device="cpu")
    mesh = make_mesh(dp=2, sp=2, tp=2)
    res = dict(coord=mesh.coord, shape=mesh.shape)

    def model(cfg, flat, m=mesh):
        return load_tree(CausalTransformer(mesh=m, device="cpu", **cfg),
                         shard_tree(flat, m))

    ids = torch.from_numpy(spec["ids"])
    for tag, cfg in spec["logits"].items():
        res[tag] = model(cfg, spec["logit_weights"])(
            local_block(mesh, ids)).detach().numpy()

    def trainer(m, **kw):
        tr = SPMDTrainer(m, m.mesh, precision="f32", **kw)
        tr.init(spec["batches"][0])
        return tr

    tm = model(spec["train_cfg"], spec["train_weights"])
    res["shards"] = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    tr = trainer(tm)
    res["losses"] = [float(tr.train_step(spec["batches"][0]))]
    res["grads"] = {n: g.numpy() for n, g in gather_tree(
        {n: p.grad for n, p in tm.named_parameters()}, mesh).items()}
    res["losses"] += [float(tr.train_step(b)) for b in spec["batches"][1:]]
    res["eval"] = tr.eval_metrics(spec["batches"][0])
    res["final"] = {n: t.numpy() for n, t in gather_tree(
        dict(tm.named_parameters()), mesh).items()}

    chunked = trainer(model(spec["train_cfg"], spec["train_weights"]),
                      logits_chunk=5)
    res["chunked_eval"] = chunked.eval_metrics(spec["batches"][0])
    res["chunked_loss"] = float(chunked.train_step(spec["batches"][0]))

    pads = trainer(model(spec["train_cfg"], spec["train_weights"]),
                   input_transform=lambda x: torch.where(x > 0, 1, 0))
    res["transform_eval"] = pads.eval_loss(spec["batches"][0])

    dp8 = make_mesh(dp=8)
    tm8 = model(spec["train_cfg"], spec["train_weights"], dp8)
    res["dp8_loss"] = float(trainer(tm8).train_step(spec["batches"][0]))

    # decode under sp is refused (JAX's message); decode over dp runs,
    # for a dense and a MoE model, with one rank's logits
    from kubeml_tpu_torch.models.generation import init_cache

    def decode(m):
        with torch.no_grad():
            return m(ids[:1], decode=True, cache=init_cache(m, 1))

    refusals = {}
    try:
        tm(local_block(mesh, ids), decode=True)
        refusals["decode_sp"] = None
    except (ValueError, NotImplementedError) as e:
        refusals["decode_sp"] = f"{type(e).__name__}: {e}"
    moe = dict(spec["train_cfg"], moe_every=2, num_experts=2, device="cpu")
    # tm8 took a step: its whole weights (dp cuts nothing) on one rank
    whole = {n: p.detach() for n, p in tm8.named_parameters()}
    refusals["decode"] = float((decode(tm8) - decode(model(
        spec["train_cfg"], whole, None))).abs().max())
    refusals["moe_decode"] = float((decode(CausalTransformer(
        mesh=dp8, **moe)) - decode(CausalTransformer(**moe))).abs().max())
    res["refusals"] = refusals
    _save(out, rank, res)


def planted_rank(rank: int, out: str, spec) -> None:
    """World 2, ``chip_smoke.py``'s 17b check at a tiny width: for each
    (mesh axes, sp_impl, fault) the losses of three bf16 steps, the first
    step's gradient norms by leaf (``chip_smoke.grad_norms``) and the
    digest of the whole parameters after the last step. A fault replaces
    ``SPMDTrainer._reduce_grads``: ``"tp_double"`` sums the gradients of
    the tp-replicated leaves over tp once more, ``"no_reduce"`` drops the
    dp x sp all-reduce; None keeps it."""
    import chip_smoke as cs
    from kubeml_tpu_torch.models.gpt import CausalTransformer
    from kubeml_tpu_torch.parallel.collectives import all_reduce_
    from kubeml_tpu_torch.parallel.trainer import SPMDTrainer

    assert D.init_distributed(device="cpu")
    reduce = SPMDTrainer._reduce_grads

    def tp_double(tr):
        reduce(tr)
        specs = tr.module.partition_specs()
        for n, p in tr.module.named_parameters():
            if "tp" not in specs[n]:
                all_reduce_(p.grad, tr.ranks, "tp")

    faults = {None: reduce, "tp_double": tp_double,
              "no_reduce": lambda tr: None}
    res = {}
    for axes, impl, fault in spec["cases"]:
        SPMDTrainer._reduce_grads = faults[fault]
        mesh = make_mesh(**axes)
        tr = SPMDTrainer(CausalTransformer(mesh=mesh, sp_impl=impl, seed=0,
                                           device="cpu", **spec["model"]),
                         mesh, precision="bf16")
        tr.init(spec["tokens"])
        losses = [float(tr.train_step(spec["tokens"]))]
        norms = cs.grad_norms(tr)
        losses += [float(tr.train_step(spec["tokens"]))
                   for _ in range(cs.MR_STEPS - 1)]
        res[(tuple(axes.items()), impl, fault)] = dict(
            losses=losses, norms=norms, digest=cs.whole_digest(tr))
    SPMDTrainer._reduce_grads = reduce
    _save(out, rank, res)


# --- on the card ---------------------------------------------------------

def cuda_ulysses_rank(rank: int, out: str, dtype_name: str) -> None:
    """World 2 sharing one card over gloo: Ulysses over ``sp=2`` through
    the flash kernels (the parent built them; a rank only loads them),
    output and dQ/dK/dV gathered; rank 0 also runs the plain version on
    the whole input."""
    from kubeml_tpu_torch.ops import kernels
    from kubeml_tpu_torch.ops.attention import dot_product_attention
    from kubeml_tpu_torch.ops.flash_attention import flash_attention as fa
    from kubeml_tpu_torch.parallel.collectives import all_gather
    from kubeml_tpu_torch.parallel.ulysses import ulysses_attention

    assert D.init_distributed(backend="gloo", device="cuda")
    kernels.library(build=False)
    mesh = make_mesh(sp=2)
    dtype = getattr(torch, dtype_name)
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 256, 4, 64, generator=g).to(dtype).cuda()
                   for _ in range(4))
    valid = torch.ones(2, 256, device="cuda")
    valid[1, 200:] = 0
    ql, kl, vl = (local_block(mesh, t).clone().requires_grad_()
                  for t in (q, k, v))
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    o = ulysses_attention(ql, kl, vl, mesh, causal=True,
                          kv_valid=local_block(mesh, valid))
    o.backward(local_block(mesh, do))
    launches = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    got = [all_gather(t.detach(), mesh, "sp", 1)
           for t in (o, ql.grad, kl.grad, vl.grad)]
    res = dict(launches=launches, device=str(mesh.device))
    if rank == 0:
        qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
        r = dot_product_attention(qr, kr, vr, causal=True, kv_valid=valid,
                                  impl="plain")
        r.backward(do)
        res["err"] = max(
            (a.float() - b.float()).abs().max().item()
            / max(1.0, b.float().abs().max().item())
            for a, b in zip(got, (r, qr.grad, kr.grad, vr.grad)))
    _save(out, rank, res)


def nccl_rank(rank: int, out: str) -> None:
    """Two NCCL ranks on a host with one card: init raises."""
    D.init_distributed(backend="nccl", device="cuda")
