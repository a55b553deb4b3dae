"""Collectives over one mesh axis (the port's counterpart of the XLA
collectives the reference's ``shard_map`` bodies call — ``psum``, ``pmax``,
``pmin``, ``all_gather``, ``ppermute`` — and of the ones GSPMD inserts
around a sharded trunk: all-gathers, reduce-scatters and broadcasts), and
the autograd functions that carry gradients across them.

An :class:`Axis` is one axis of a :class:`repro_torch.launch.mesh.Mesh`:
its process group, its size and this rank's index along it. A size-1 axis
has no group and every collective over it is the identity, so a mesh of
one rank runs the same code as a single device.

**The one-card design.** NCCL refuses two ranks on one card, so ranks that
share a card run under ``gloo``. ``gloo`` takes CUDA tensors for
all_reduce, all_gather, reduce_scatter and broadcast and stages them
through the host itself (probed on the H100 and on the CPU, PERF.md);
send / recv hands its tcp transport the device pointer and fails, so
:func:`ppermute` copies to the host explicitly, runs there and copies
back — part of the design, not a fallback: the route is fixed by (backend,
op), never chosen on an error. Every byte a ``gloo`` collective moves for
a CUDA tensor crosses the host either way, and :data:`HOST_BYTES` counts
them per op (payload in plus result out).

**Gradients.** :func:`copy_to` is ``f``: identity forward, all-reduce of
the gradient backward — where a replicated tensor enters a shard-local
computation, so each rank's gradient gets the other shards' terms.
:func:`reduce_from` is ``g``: all-reduce forward, identity backward — where
shard partials combine into a replicated value; the upstream gradient is
already the same on every rank, so each partial's gradient is that
gradient (a differentiable all-reduce would give ``size`` times it).
:func:`all_reduce` is the sum both ways: a partial whose consumers are
shard-local (the gated norm's sum of squares over a split width).

Leaves stored split over an axis are put together by
:func:`all_gather_dim`, an all-gather along one dim whose backward
reduce-scatters the gradient (each rank's use is a partial: shard-local
consumers, or the data ranks' own batches — FSDP).

:func:`reduce_scatter` runs ``dist.reduce_scatter`` over chunks of one dim
(gloo has it on CPU and on CUDA tensors, so the route is the collective
itself, never an all-reduce and a slice). :func:`broadcast`
and :func:`broadcast_object` hand every rank the axis' first rank's value:
how a host decision that rank 0 makes (a clock read, a fitted router)
reaches the others.

**Virtual axes and the cost model.** An axis whose backend is ``"meta"``
(:func:`repro_torch.launch.mesh.make_production_mesh`) has no process
group: every op on it returns a meta tensor of the result's shape (an
all-gather ``size`` times its input, a reduce-scatter ``1/size``) and
moves nothing. It takes meta tensors only and raises on any other, so a
virtual axis never stands in for a real one. Every op over an axis of
more than one rank, real or virtual, reports its operand bytes by kind
and axis to the active cost recorder (:mod:`repro_torch.cost_hook`),
with the reference's operand rule (``hlo_analysis.py``): an all-gather's
operand is its result / group, a reduce-scatter's its result × group,
every other collective's the same shape as its result.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import cost_hook

__all__ = ["Axis", "HOST_BYTES", "reset_host_bytes",
           "psum", "pmax", "pmin", "all_gather", "ppermute", "copy_to",
           "reduce_from", "all_reduce", "reduce_scatter", "all_gather_dim",
           "all_gather_dim_replicated",
           "broadcast", "broadcast_object"]

# {op: bytes} a gloo collective moved across the host for CUDA tensors
HOST_BYTES: dict[str, int] = {}


def reset_host_bytes() -> None:
    HOST_BYTES.clear()


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as seen from this rank. ``group`` is None for a
    size-1 axis; ``ranks`` are the global ranks along the axis in axis
    order."""

    name: str
    size: int
    index: int
    ranks: tuple[int, ...]
    group: Any = None
    backend: str = "gloo"

    @classmethod
    def trivial(cls, name: str) -> "Axis":
        """A size-1 axis: every collective is the identity."""
        return cls(name, 1, 0, (0,), None, "gloo")

    @classmethod
    def virtual(cls, name: str, size: int, index: int = 0) -> "Axis":
        """An axis of ``size`` ranks without a process group (backend
        ``"meta"``): its collectives return meta results of the right
        shape and record their bytes."""
        return cls(name, size, index, tuple(range(size)), None, "meta")

    @property
    def is_virtual(self) -> bool:
        return self.backend == "meta"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _via_host(axis: Axis, op: str, t: torch.Tensor,
              out_bytes: int | None = None) -> bool:
    """Whether ``op`` on ``t`` crosses the host (gloo on a CUDA tensor);
    if so, counts ``t``'s bytes in and ``out_bytes`` (default: as many)
    out."""
    if axis.backend != "gloo" or t.device.type != "cuda":
        return False
    n = _nbytes(t) + (_nbytes(t) if out_bytes is None else out_bytes)
    HOST_BYTES[op] = HOST_BYTES.get(op, 0) + n
    return True


@contextlib.contextmanager
def _collective(kind: str, axis: Axis, x: torch.Tensor):
    """Around one collective on ``x`` (its operand): refuse a non-meta
    tensor on a virtual axis; report the operand bytes to the active cost
    recorder and hold back its per-op counting of the op's own tensor
    work (a collective is charged as its traffic alone)."""
    if axis.is_virtual and not x.is_meta:
        raise ValueError(f"virtual axis {axis.name!r} got a tensor on "
                         f"{x.device}: a virtual mesh traces meta tensors "
                         "only")
    with cost_hook.collective(kind, axis.name, _nbytes(x)):
        yield


def _all_reduce(x: torch.Tensor, axis: Axis, op) -> torch.Tensor:
    if axis.size == 1:
        return x
    with _collective("all-reduce", axis, x):
        if axis.is_virtual:
            return torch.empty_like(x)
        out = x.detach().clone().contiguous()
        _via_host(axis, "all_reduce", out)
        dist.all_reduce(out, op=op, group=axis.group)
        return out


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum over the axis (not differentiable: see :func:`reduce_from`)."""
    return _all_reduce(x, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _all_reduce(x, axis, dist.ReduceOp.MAX)


def pmin(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _all_reduce(x, axis, dist.ReduceOp.MIN)


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` in axis order."""
    if axis.size == 1:
        return x.detach()[None]
    with _collective("all-gather", axis, x):
        if axis.is_virtual:
            return x.new_empty((axis.size,) + tuple(x.shape))
        src = x.detach().contiguous()
        _via_host(axis, "all_gather", src)
        outs = [torch.empty_like(src) for _ in range(axis.size)]
        dist.all_gather(outs, src, group=axis.group)
        return torch.stack(outs)


def ppermute(x: torch.Tensor, axis: Axis, shift: int = 1) -> torch.Tensor:
    """Ring shift: rank i sends ``x`` to rank (i + shift) % size and
    returns what rank (i - shift) % size sent (``lax.ppermute`` with the
    pairs ``[(i, (i + shift) % size)]``)."""
    if axis.size == 1 or shift % axis.size == 0:
        return x.detach().clone()
    with _collective("collective-permute", axis, x):
        if axis.is_virtual:
            return torch.empty_like(x)
        src = x.detach().contiguous()
        dst = axis.ranks[(axis.index + shift) % axis.size]
        frm = axis.ranks[(axis.index - shift) % axis.size]
        staged = _via_host(axis, "ppermute", src)
        send = src.cpu() if staged else src
        recv = torch.empty_like(send)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, group=axis.group),
            dist.P2POp(dist.irecv, recv, frm, group=axis.group)])
        for r in reqs:
            r.wait()
        return recv.to(x.device) if staged else recv


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``f``: identity forward, the gradient summed over the axis
    backward."""
    if axis.size == 1:
        return x
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``g``: the sum over the axis forward, the gradient passed through
    unchanged backward."""
    if axis.size == 1:
        return x
    return _ReduceFrom.apply(x, axis)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.axis), None


def all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum over the axis forward AND backward: for a partial whose
    consumers are shard-local, so each rank's gradient is a partial too."""
    if axis.size == 1:
        return x
    return _AllReduce.apply(x, axis)


def reduce_scatter(x: torch.Tensor, axis: Axis, dim: int = 0
                   ) -> torch.Tensor:
    """The sum over the axis of ``x``, this rank's block of ``dim`` (which
    ``axis.size`` must divide). Not differentiable."""
    if axis.size == 1:
        return x
    n = x.shape[dim] // axis.size
    with _collective("reduce-scatter", axis, x):
        if axis.is_virtual:
            shape = list(x.shape)
            shape[dim] = n
            return x.new_empty(shape)
        src = x.detach().movedim(dim, 0).contiguous()
        _via_host(axis, "reduce_scatter", src, _nbytes(src) // axis.size)
        out = torch.empty((n,) + src.shape[1:], dtype=src.dtype,
                          device=src.device)
        dist.reduce_scatter(out, list(src.split(n)), group=axis.group)
        return out.movedim(0, dim)


def _gather_cat(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in axis order."""
    return torch.cat(all_gather(x, axis).unbind(0), dim=dim)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, dtype):
        ctx.axis, ctx.dim, ctx.in_dtype = axis, dim, x.dtype
        return _gather_cat(x if dtype is None else x.to(dtype), axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g.to(ctx.in_dtype), ctx.axis, ctx.dim), None,
                None, None)


def all_gather_dim(x: torch.Tensor, axis: Axis, dim: int,
                   dtype: torch.dtype | None = None) -> torch.Tensor:
    """Every rank's block joined along ``dim`` (cast to ``dtype`` first, so
    the gather moves the compute dtype); backward: the gradient summed
    over the axis, this rank's block of it, in ``x``'s dtype (a
    reduce-scatter: each rank's use is a partial)."""
    if axis.size == 1:
        return x if dtype is None else x.to(dtype)
    return _GatherDim.apply(x, axis, dim, dtype)


class _GatherRep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, dtype):
        ctx.axis, ctx.dim, ctx.in_dtype = axis, dim, x.dtype
        ctx.n = x.shape[dim]
        return _gather_cat(x if dtype is None else x.to(dtype), axis, dim)

    @staticmethod
    def backward(ctx, g):
        blk = g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n)
        return blk.to(ctx.in_dtype).contiguous(), None, None, None


def all_gather_dim_replicated(x: torch.Tensor, axis: Axis, dim: int,
                              dtype: torch.dtype | None = None
                              ) -> torch.Tensor:
    """Every rank's block joined along ``dim``, for a use that every rank
    of the axis repeats on the same inputs (a block computed whole on
    each rank): the gradient is then the same on every rank, and its
    backward keeps this rank's block of it, with no communication."""
    if axis.size == 1:
        return x if dtype is None else x.to(dtype)
    return _GatherRep.apply(x, axis, dim, dtype)


def broadcast(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The axis' first rank's ``x`` on every rank (same shape and dtype on
    all). Not differentiable."""
    if axis.size == 1:
        return x
    with _collective("broadcast", axis, x):
        if axis.is_virtual:
            return torch.empty_like(x)
        out = x.detach().clone().contiguous()
        _via_host(axis, "broadcast", out)
        dist.broadcast(out, src=axis.ranks[0], group=axis.group)
        return out


def broadcast_object(obj: Any, axis: Axis) -> Any:
    """The axis' first rank's ``obj`` (picklable) on every rank (on a
    virtual axis: ``obj``, the first rank's own)."""
    if axis.size == 1 or axis.is_virtual:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=axis.ranks[0], group=axis.group)
    return box[0]
