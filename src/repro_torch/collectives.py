"""Collectives over one mesh axis (the port's counterpart of the XLA
collectives the reference's ``shard_map`` bodies call: ``psum``, ``pmax``,
``pmin``, ``all_gather``, ``ppermute``), and Megatron's f / g pair that
carries gradients across them.

An :class:`Axis` is one axis of a :class:`repro_torch.launch.mesh.Mesh`:
its process group, its size and this rank's index along it. A size-1 axis
has no group and every collective over it is the identity, so a mesh of
one rank runs the same code as a single device.

**The one-card design.** NCCL refuses two ranks on one card, so ranks that
share a card run under ``gloo``. ``gloo`` takes CUDA tensors for some ops
and stages them through the host itself; for the others this module copies
to the host explicitly, runs the op there and copies back — part of the
design, not a fallback: the route is fixed by (backend, op), never chosen
on an error. Every byte a ``gloo`` collective moves for a CUDA tensor
crosses the host either way, and :data:`HOST_BYTES` counts them per op
(payload in plus result out).

**Gradients.** :func:`copy_to` is ``f``: identity forward, all-reduce of
the gradient backward — where a replicated tensor enters a shard-local
computation, so each rank's gradient gets the other shards' terms.
:func:`reduce_from` is ``g``: all-reduce forward, identity backward — where
shard partials combine into a replicated value; the upstream gradient is
already the same on every rank, so each partial's gradient is that
gradient (a differentiable all-reduce would give ``size`` times it).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

__all__ = ["Axis", "HOST_BYTES", "GLOO_CUDA_NATIVE", "reset_host_bytes",
           "psum", "pmax", "pmin", "all_gather", "ppermute", "copy_to",
           "reduce_from"]

# ops gloo runs on CUDA tensors itself, staging them through host memory
# inside the process group (on the H100: all_reduce, broadcast, all_gather
# and all_to_all; send / recv hands gloo's tcp transport the device pointer
# and fails, PERF.md); every other op is staged explicitly here
GLOO_CUDA_NATIVE = frozenset({"all_reduce", "all_gather"})

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


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _staged(axis: Axis, op: str, t: torch.Tensor) -> bool:
    """Whether ``op`` on ``t`` runs on a host copy (gloo without a CUDA
    route for it); counts the bytes either way for gloo + CUDA."""
    if axis.backend != "gloo" or t.device.type != "cuda":
        return False
    HOST_BYTES[op] = HOST_BYTES.get(op, 0) + 2 * _nbytes(t)
    return op not in GLOO_CUDA_NATIVE


def _all_reduce(x: torch.Tensor, axis: Axis, op) -> torch.Tensor:
    if axis.size == 1:
        return x
    out = x.detach().clone().contiguous()
    if _staged(axis, "all_reduce", out):
        host = out.cpu()
        dist.all_reduce(host, op=op, group=axis.group)
        return host.to(x.device)
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
    src = x.detach().contiguous()
    if _staged(axis, "all_gather", src):
        host = src.cpu()
        outs = [torch.empty_like(host) for _ in range(axis.size)]
        dist.all_gather(outs, host, group=axis.group)
        return torch.stack(outs).to(x.device)
    outs = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(outs, src, group=axis.group)
    return torch.stack(outs)


def ppermute(x: torch.Tensor, axis: Axis, shift: int = 1) -> torch.Tensor:
    """Ring shift: rank i sends ``x`` to rank (i + shift) % size and
    returns what rank (i - shift) % size sent (``lax.ppermute`` with the
    pairs ``[(i, (i + shift) % size)]``)."""
    if axis.size == 1 or shift % axis.size == 0:
        return x.detach().clone()
    src = x.detach().contiguous()
    dst = axis.ranks[(axis.index + shift) % axis.size]
    frm = axis.ranks[(axis.index - shift) % axis.size]
    staged = _staged(axis, "ppermute", src)
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
