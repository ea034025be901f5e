"""Collectives over a mesh axis that autograd differentiates.

The JAX package writes its collectives as ``jax.lax`` primitives inside
``shard_map`` and lets JAX transpose them. Here each is a
``torch.autograd.Function`` over the process group of a mesh axis
(``Mesh.group``), with the transpose written out:

==========================  ==================  ========================
function                    forward             backward
==========================  ==================  ========================
:func:`psum`                all-reduce (sum)    identity
:func:`copy_to`             identity            all-reduce (sum)
:func:`all_gather`          gather along a dim  this rank's slice
:func:`all_to_all`          tiled all-to-all    the inverse all-to-all
:func:`ppermute`            to ``(i+1) % n``    to ``(i-1) % n``
==========================  ==================  ========================

:func:`psum` and :func:`copy_to` are Megatron's g and f: a
column-parallel layer's input enters through ``copy_to`` (every rank's
partial input gradient is summed), a row-parallel layer's partial
outputs are summed by ``psum`` (the sum's gradient is already whole on
every rank). ``all_gather``'s backward takes this rank's slice of the
output gradient, which is right where the gathered value feeds a
computation replicated over the group, as it does in every caller (the
tp embedding and logits): each rank then holds the same whole gradient.

Every rank of a group must call the same collectives in the same order,
in the forward and, through autograd, in the backward. Over an axis of
size 1 every function is the identity and communicates nothing.

gloo takes CPU tensors for every operation, CUDA tensors only for some,
which differ between releases; so under gloo a CUDA tensor goes through
host memory for every operation (one copy out, one back), and the
compute stays on the card. NCCL takes the device tensors as they
are. Booleans travel as uint8. Each operation, staging included, runs
inside a ``kubeml::<op>`` profiler span, which a ``torch.profiler``
window reads as the collectives' share of a step; under gloo the card's
queue is drained before the span opens, so the span holds no compute.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist
from torch.profiler import record_function

Axes = Union[str, Sequence[str]]


def _axes(axis: Axes) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _ctx(mesh, axis: Axes):
    """(group, size, this rank's index in it) for a mesh axis or axes."""
    if mesh is None:
        return None, 1, 0
    axes = _axes(axis)
    group = mesh.group(*axes)
    if group is None:
        return None, 1, 0
    return group, dist.get_world_size(group), dist.get_group_rank(
        group, mesh.rank)


class _Wire:
    """A tensor as the backend takes it: contiguous, uint8 for bool, on
    the host under gloo; :meth:`back` undoes the staging."""

    def __init__(self, t: torch.Tensor):
        self.device, self.dtype = t.device, t.dtype
        self.host = (t.is_cuda and dist.get_backend() == "gloo")
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        self.t = (t.cpu() if self.host else t).contiguous()

    def empty(self, shape=None) -> torch.Tensor:
        return torch.empty(self.t.shape if shape is None else shape,
                           dtype=self.t.dtype, device=self.t.device)

    def back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, self.dtype)


def _span(name: str, t: torch.Tensor):
    """The profiler span of one collective on ``t``. Under gloo the
    staging's ``.cpu()`` would wait inside the span for the work queued
    before it; the queue is drained first, so the span holds the
    collective and its copies only (the wait is the same either way)."""
    if t.is_cuda and dist.get_backend() == "gloo":
        torch.cuda.synchronize(t.device)
    return record_function(name)


def _all_reduce(t: torch.Tensor, group,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    with _span("kubeml::all_reduce", t):
        w = _Wire(t)
        out = w.t.clone()
        dist.all_reduce(out, op=op, group=group)
        return w.back(out)


def all_reduce_(t: torch.Tensor, mesh, axis: Axes,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` over the axes in place (``op``, a sum by default),
    outside autograd (gradients, counts, maxima); returns ``t``."""
    group, n, _ = _ctx(mesh, axis)
    if n > 1:
        t.copy_(_all_reduce(t, group, op))
    return t


def _all_gather(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    with _span("kubeml::all_gather", t):
        w = _Wire(t)
        outs = [w.empty() for _ in range(n)]
        dist.all_gather(outs, w.t, group=group)
        return w.back(torch.cat(outs, dim=dim))


def _all_to_all(t: torch.Tensor, group, n: int, split: int,
                concat: int) -> torch.Tensor:
    """Tiled all-to-all: cut ``split`` into ``n`` parts, part ``j`` to the
    group's rank ``j``, the parts received concatenated along ``concat``
    in source order (``jax.lax.all_to_all(..., tiled=True)``)."""
    split %= t.dim()
    concat %= t.dim()
    size = t.shape[split]
    if size % n:
        raise ValueError(f"all_to_all: dim {split} of {tuple(t.shape)} does "
                         f"not divide over {n} ranks")
    # [n, size / n, ...rest]: the parts along the leading dim
    parts = t.movedim(split, 0).reshape(n, size // n, *[
        s for i, s in enumerate(t.shape) if i != split])
    with _span("kubeml::all_to_all", parts):
        w = _Wire(parts)
        out = w.empty()
        dist.all_to_all_single(out, w.t, group=group)
        out = w.back(out)
    out = out.movedim(1, split + 1)  # [n, *t.shape with split/n]
    out = out.movedim(0, concat)  # the source parts before concat
    shape = list(out.shape)
    shape[concat:concat + 2] = [shape[concat] * shape[concat + 1]]
    return out.reshape(shape)


def _ppermute(t: torch.Tensor, group, n: int, me: int,
              shift: int) -> torch.Tensor:
    """Send ``t`` to the group's rank ``(me + shift) % n``, receive from
    ``(me - shift) % n``."""
    with _span("kubeml::ppermute", t):
        w = _Wire(t)
        out = w.empty()
        to = dist.get_global_rank(group, (me + shift) % n)
        frm = dist.get_global_rank(group, (me - shift) % n)
        ops = [dist.P2POp(dist.isend, w.t, to, group),
               dist.P2POp(dist.irecv, out, frm, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return w.back(out)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me, dim):
        ctx.dim, ctx.me, ctx.part = dim, me, x.shape[dim]
        return _all_gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.me * ctx.part, ctx.part), None, None, \
            None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split, concat):
        ctx.args = group, n, split, concat
        return _all_to_all(x, group, n, split, concat)

    @staticmethod
    def backward(ctx, g):
        group, n, split, concat = ctx.args
        return _all_to_all(g, group, n, concat, split), None, None, None, \
            None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me, shift):
        ctx.args = group, n, me, shift
        return _ppermute(x, group, n, me, shift)

    @staticmethod
    def backward(ctx, g):
        group, n, me, shift = ctx.args
        return _ppermute(g, group, n, me, -shift), None, None, None, None


def psum(x: torch.Tensor, mesh, axis: Axes) -> torch.Tensor:
    """Sum over the axes (``jax.lax.psum``); the gradient passes as it is."""
    group, n, _ = _ctx(mesh, axis)
    return x if n == 1 else _Psum.apply(x, group)


def copy_to(x: torch.Tensor, mesh, axis: Axes) -> torch.Tensor:
    """The identity whose gradient is summed over the axes (Megatron's f,
    the conjugate of :func:`psum`)."""
    group, n, _ = _ctx(mesh, axis)
    return x if n == 1 else _CopyTo.apply(x, group)


def all_gather(x: torch.Tensor, mesh, axis: Axes, dim: int
               ) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in coordinate order,
    the first of several axes major (``jax.lax.all_gather(...,
    tiled=True)``)."""
    group, n, me = _ctx(mesh, axis)
    return x if n == 1 else _AllGather.apply(x, group, n, me, dim % x.dim())


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``."""
    group, n, _ = _ctx(mesh, axis)
    return x if n == 1 else _AllToAll.apply(x, group, n, split_dim,
                                            concat_dim)


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int = 1
             ) -> torch.Tensor:
    """Rotate ``x`` along the axis: rank ``i`` sends to ``(i + shift) % n``
    (``jax.lax.ppermute`` with that permutation)."""
    group, n, me = _ctx(mesh, axis)
    return x if n == 1 else _PPermute.apply(x, group, n, me, shift)

