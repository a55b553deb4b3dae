"""Cost model of one step: flops by dtype, HBM bytes, collective bytes and
live memory, recorded by running the step once (counterpart of
``repro/launch/hlo_analysis.py``'s job).

The reference parses XLA's optimized HLO because ``cost_analysis()`` counts
a ``while`` body (every ``lax.scan``) once, whatever its trip count. Eager
PyTorch has no HLO and no loop to unroll: every loop iteration runs, so
every op is seen as many times as it executes and the trip counts come for
free. :class:`CostMode` is a ``TorchDispatchMode`` that sees each aten op
as it runs — on meta tensors (the dry run: shapes, no storage, nothing
computed) or on the card — and records:

* **flops** by dtype: matmul, bmm, addmm, convolution and SDPA through
  ``torch.utils.flop_counter``'s formulas (the reference counts ``dot``
  and ``convolution`` only, so elementwise work adds none here either),
  and each hand-written kernel's own count
  (:mod:`repro_torch.kernels.cost`), charged by its op in
  :mod:`repro_torch.kernels.ops`: a ctypes launch is invisible to a
  dispatch mode;
* **HBM bytes**: operand plus result bytes of every op, since each eager
  op is a kernel boundary (the reference's fusion boundaries); views and
  allocations move nothing; a gather reads what it returns (2 × its
  result), a scatter 2 × its update, as in the reference; a kernel its
  count, a collective 2 × its operand;
* **collective bytes** by kind and by (kind, axis), from
  :mod:`repro_torch.collectives`, which reports every collective, real or
  on a virtual axis, with the reference's operand rule;
* **live bytes** of the tensors the step creates, and their high-water
  mark (``weakref.finalize`` on each fresh output; meta tensors take
  weakrefs).

A data-dependent op on a meta tensor (``.item()``, ``torch.nonzero``, …)
raises :class:`DataDependentOp`, naming it: nothing guesses a value.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import cost_hook
from repro_torch.kernels import cost as kcost

__all__ = ["CostRecord", "CostMode", "DataDependentOp", "trace", "to_meta"]

aten = torch.ops.aten

# ops whose result depends on tensor values the meta device does not have
_DATA_DEPENDENT = {
    aten._local_scalar_dense, aten.nonzero, aten.masked_select,
    aten._unique, aten._unique2, aten.unique_dim, aten.unique_consecutive,
    aten.is_nonzero, aten.equal,
}
# reads only what it returns (plus its indices)
_GATHERS = {aten.embedding, aten.index_select, aten.index, aten.gather,
            aten.take_along_dim}
# writes (and reads) only its update: (op packet, index of the update arg)
_SCATTERS = {aten.index_put_: 2, aten.index_put: 2, aten.index_add_: 3,
             aten.index_add: 3, aten.scatter_add_: 3, aten.scatter_add: 3,
             aten.scatter_: 3, aten.scatter: 3}
# no traffic: allocations and metadata
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.detach, aten.lift_fresh,
         aten.alias, aten.resize_, aten.set_}


class DataDependentOp(RuntimeError):
    """A traced op needs a tensor value the meta device does not hold."""


def _peak_dtype(dtype: torch.dtype) -> str:
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "fp32"


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nb(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class CostRecord:
    """Per-device counts of one traced step; the field names of the
    reference's ``HloCost`` where the concept carries over."""

    flops: float = 0.0
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    coll_counts: dict = dataclasses.field(default_factory=dict)
    # kernel name -> {"charges": calls charged, "bytes", "flops"}
    kernels: dict = dataclasses.field(default_factory=dict)
    op_count: int = 0  # aten ops counted (kernels and collectives apart)
    live_bytes: int = 0
    peak_bytes: int = 0  # high-water mark of live_bytes
    # per-site detail: (kind, axis) -> (bytes, count) and op -> bytes
    coll_sites: dict = dataclasses.field(default_factory=dict)
    hbm_sites: dict = dataclasses.field(default_factory=dict)

    @property
    def coll_by_axis(self) -> dict:
        """(kind, axis) -> collective bytes."""
        return {key: b for key, (b, _) in self.coll_sites.items()}

    def top_collectives(self, n: int = 10) -> list:
        """The largest collective sites: (axis, kind, bytes, count)."""
        rows = [(ax, kind, b, c) for (kind, ax), (b, c)
                in self.coll_sites.items()]
        return sorted(rows, key=lambda s: -s[2])[:n]

    def top_hbm(self, n: int = 10) -> list:
        return sorted(self.hbm_sites.items(), key=lambda kv: -kv[1])[:n]

    def _hbm(self, site: str, b: float) -> None:
        self.hbm_bytes += b
        self.hbm_sites[site] = self.hbm_sites.get(site, 0.0) + b

    def _flops(self, dtype: str, f: float) -> None:
        self.flops += f
        self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0.0) + f


class CostMode(TorchDispatchMode):
    """Records a :class:`CostRecord` (``.cost``) of every op run inside
    it, and is the active recorder of kernel and collective counts
    (:mod:`repro_torch.cost_hook`)."""

    def __init__(self):
        super().__init__()
        self.cost = CostRecord()
        self.suspended = 0
        self._rec = None

    def __enter__(self):
        self._rec = cost_hook.recording(self)
        self._rec.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._rec.__exit__(*exc)

    # ---------------------------------------------------- reported counts
    def kernel(self, name: str, c: kcost.Cost) -> None:
        k = self.cost.kernels.setdefault(
            name, {"charges": 0, "bytes": 0.0, "flops": 0.0})
        k["charges"] += 1
        k["bytes"] += c.bytes
        k["flops"] += c.flops
        self.cost._flops(c.dtype, c.flops)
        self.cost._hbm("kernel:" + name, c.bytes)

    def collective(self, kind: str, axis: str, nbytes: int) -> None:
        c = self.cost
        c.coll_bytes += nbytes
        c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0.0) + nbytes
        c.coll_counts[kind] = c.coll_counts.get(kind, 0) + 1
        key = (kind, axis)
        b, n = c.coll_sites.get(key, (0.0, 0))
        c.coll_sites[key] = (b + nbytes, n + 1)
        c._hbm("collective", 2 * nbytes)  # read + write

    # ---------------------------------------------------------- live memory
    def _free(self, nb: int) -> None:
        self.cost.live_bytes -= nb

    def _track(self, func, out) -> None:
        rets = func._schema.returns
        if any(r.alias_info is not None for r in rets):
            return  # a view or an in-place result: no new storage
        for t in _tensors(out):
            nb = _nb(t)
            if not nb:
                continue
            c = self.cost
            c.live_bytes += nb
            c.peak_bytes = max(c.peak_bytes, c.live_bytes)
            weakref.finalize(t, self._free, nb)

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet in _DATA_DEPENDENT and any(
                t.is_meta for t in _tensors((args, kwargs))):
            raise DataDependentOp(
                f"data-dependent op {func.name()} on a meta tensor: the "
                "trace cannot know its value")
        out = func(*args, **kwargs)
        self._track(func, out)
        if self.suspended or func.namespace != "aten":
            return out
        self._count(func, packet, args, kwargs, out)
        return out

    def _count(self, func, packet, args, kwargs, out) -> None:
        c = self.cost
        if packet in flop_registry:
            first = next(_tensors(args), None)
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            c._flops(_peak_dtype(first.dtype if first is not None
                                 else torch.float32), float(f))
        if packet in _FREE:
            return
        rets = func._schema.returns
        if rets and all(r.alias_info is not None and not r.alias_info.is_write
                        for r in rets):
            return  # a view
        c.op_count += 1
        site = packet.__name__
        rb = sum(_nb(t) for t in _tensors(out))
        if packet in _GATHERS:
            c._hbm(site, 2 * rb)
            return
        if packet in _SCATTERS:
            i = _SCATTERS[packet]
            upd = args[i] if len(args) > i else None
            ub = _nb(upd) if isinstance(upd, torch.Tensor) else rb
            c._hbm(site, 2 * ub)
            return
        ob = sum(_nb(t) for t in _tensors((args, kwargs)))
        c._hbm(site, ob + rb)


def trace(fn, *args, **kwargs) -> tuple[object, CostRecord]:
    """``fn(*args, **kwargs)`` under a fresh :class:`CostMode` -> (its
    result, the record)."""
    with CostMode() as mode:
        out = fn(*args, **kwargs)
    return out, mode.cost


def to_meta(x):
    """``x`` with every tensor replaced by an empty meta tensor of its shape
    and dtype: dicts, lists, tuples and named tuples mapped, an index
    (``config`` + ``state``) rebuilt around its meta state — how a step's
    inputs on the card become the inputs of its meta trace."""
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if isinstance(x, dict):
        return {k: to_meta(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_meta(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_meta(v) for v in x)
    if hasattr(x, "config") and hasattr(x, "state"):
        return type(x)(x.config, to_meta(x.state))
    return x
