"""The ``("data", "model")`` mesh on ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``), the placement of the leaves the port shards, and
the helpers that start and join ranks.

Rank layout is the reference's ``devs[:dp*tp].reshape(dp, tp)``: rank =
``data * tp + model``. Each rank holds one process group per axis: the
``model`` group is the ``tp`` ranks of its data row, the ``data`` group the
``dp`` ranks of its model column.

What is sharded: every leaf is stored as the reference's
:func:`param_spec` places it (``"model"`` / ``("data",)`` entries, 2-D
where the reference is 2-D; a dim either does not divide stays
replicated):

* ``embed`` and ``out_embed``: rows over ``model`` — the vocab-parallel
  input lookup (:mod:`repro_torch.models.model`) and the distributed head
  (:mod:`repro_torch.models.head`) over a
  :class:`repro_torch.core.mips.ShardedIndex`;
* the trunk's matrices Megatron-style: ``wq wk wv w1 w3 wx wz
  w_gate_branch w_in wdt wb wc w_a w_i`` column-parallel, ``wo w2 w_out``
  row-parallel over ``model``, each matrix's other dim over ``data``
  (FSDP: all-gathered per layer on use, the gradient reduce-scattered);
  the MoE experts' expert dim over ``model`` ("ep", their ``d_in`` over
  ``data``) or their FFN hidden ("tp"), the router's ``d_in`` over
  ``data``;
* norms, conv taps and the per-head / per-channel vectors replicated;
* the batch over ``data``.

How each block computes the single-device function on that storage
(Megatron split where the split falls on whole heads, channels or gate
blocks, else a gather over ``model`` on use) is in
:mod:`repro_torch.models.tp` and the blocks. :func:`cache_shardings` is
the reference's placement of the serving caches, which
:func:`repro_torch.models.transformer.init_cache` allocates.

:func:`make_production_mesh` is the reference's production mesh as rank 0
sees it, without ranks: its axes are virtual (backend ``"meta"``, no
process group, :mod:`repro_torch.collectives`), so a step traced on meta
tensors over it runs rank 0's share of the work and records every
collective it would issue (the cost model's dry run,
:mod:`repro_torch.launch.dryrun`).

Backend and device are explicit (:func:`init_rank`): the caller names the
backend (``gloo`` or ``nccl``) and the device (``cuda:<rank % cards>``
unless the CPU is asked for); nothing switches by itself. NCCL with more
ranks than cards is refused. Every group carries a timeout, so a rank that
waits on a collective its peers never issue fails instead of hanging.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
import traceback
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.collectives import Axis

__all__ = ["Mesh", "MOE_SHARDING", "DEFAULT_TIMEOUT_S", "make_train_mesh",
           "make_production_mesh", "make_virtual_mesh",
           "fsdp_axes", "param_spec", "spec_dims", "moe_mode", "shard_dim",
           "map_with_path", "local_slice",
           "local_shape", "shard_params", "cache_shardings", "data_rows",
           "data_shardings", "stacked_data_shardings", "init_rank",
           "run_ranks", "file_init_method"]

DEFAULT_TIMEOUT_S = 120.0

# MoE expert placement: "ep" shards the expert dim over "model" when it
# divides; otherwise (or with "tp") the expert FFN hidden is split. The one
# switch for both the storage layout (param_spec) and the compute split
# (models.moe.forward_dist), read through moe_mode
MOE_SHARDING = "ep"


@dataclasses.dataclass
class Mesh:
    """This rank's view of a ``(dp, tp)`` mesh."""

    dp: int
    tp: int
    rank: int
    data: Axis
    model: Axis
    world: Axis
    name: str = ""

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.dp, "model": self.tp}

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("data", "model")

    @property
    def coords(self) -> tuple[int, int]:
        """(data, model) index of this rank."""
        return self.data.index, self.model.index

    def axis(self, name: str) -> Axis:
        return {"data": self.data, "model": self.model,
                "world": self.world}[name]


def _timeout(timeout_s: float | None) -> datetime.timedelta:
    return datetime.timedelta(
        seconds=DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s)


def make_train_mesh(dp: int = 1, tp: int = 1, *,
                    timeout_s: float | None = None) -> Mesh:
    """The ``(dp, tp)`` mesh over the initialised process group, whose
    world size must be ``dp * tp`` (the reference checks the device count).
    Every rank must call this, in the same order as its other group
    creations. Without an initialised group, only ``(1, 1)`` is accepted:
    a mesh of one rank whose collectives are all the identity."""
    n = dp * tp
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh ({dp},{tp}) needs positive axis sizes")
    if not (dist.is_available() and dist.is_initialized()):
        if n != 1:
            raise ValueError(f"mesh ({dp},{tp}) needs {n} ranks: initialise "
                             "torch.distributed first (launch.mesh.init_rank)")
        return Mesh(1, 1, 0, Axis.trivial("data"), Axis.trivial("model"),
                    Axis.trivial("world"))
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh ({dp},{tp}) needs {n} ranks, the process "
                         f"group has {world}")
    rank = dist.get_rank()
    backend = dist.get_backend()
    d_idx, m_idx = divmod(rank, tp)
    to = _timeout(timeout_s)

    def axis(name: str, ranks: list[int], index: int, group) -> Axis:
        if len(ranks) == 1:
            return Axis(name, 1, 0, tuple(ranks), None, backend)
        return Axis(name, len(ranks), index, tuple(ranks), group, backend)

    # every rank creates every group, in one order (new_group is collective)
    model_ax = data_ax = None
    for d in range(dp):
        ranks = [d * tp + m for m in range(tp)]
        g = dist.new_group(ranks, timeout=to) if tp > 1 else None
        if d == d_idx:
            model_ax = axis("model", ranks, m_idx, g)
    for m in range(tp):
        ranks = [d * tp + m for d in range(dp)]
        g = dist.new_group(ranks, timeout=to) if dp > 1 else None
        if m == m_idx:
            data_ax = axis("data", ranks, d_idx, g)
    world_ax = axis("world", list(range(n)), rank, dist.group.WORLD)
    return Mesh(dp, tp, rank, data_ax, model_ax, world_ax)


def make_production_mesh(multi_pod: bool = False) -> Mesh:
    """Rank 0's view of the reference's production mesh, virtual (no
    process group; meta tensors only): 16 x 16 ``("data", "model")``
    ("16x16"), or with ``multi_pod`` 2 x 16 x 16 with ``pod x data`` folded
    into one data axis of 32 ("2x16x16": the reference's FSDP axes are
    ``("pod", "data")``, which shard as one axis of their product)."""
    if multi_pod:
        return make_virtual_mesh(32, 16, "2x16x16")
    return make_virtual_mesh(16, 16)


def make_virtual_mesh(dp: int, tp: int, name: str = "") -> Mesh:
    """Rank 0's view of a ``(dp, tp)`` mesh with virtual axes (no process
    group, meta tensors only; :mod:`repro_torch.collectives`)."""
    return Mesh(dp, tp, 0, Axis.virtual("data", dp), Axis.virtual("model", tp),
                Axis.virtual("world", dp * tp), name or f"{dp}x{tp}")


def fsdp_axes(mesh: Mesh) -> tuple[str, ...]:
    """The reference's FSDP axes (``("pod", "data")`` among the mesh's
    axes): ``("data",)`` — the port's mesh has no pod axis. They carry the
    batch and the FSDP dim of every large weight."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _spec_entry(axes: tuple[str, ...]):
    """A spec entry for ``axes``, normalised as ``PartitionSpec`` does: a
    one-axis tuple is its axis; no axes, None."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _size(mesh: Mesh, axes) -> int:
    n = 1
    for a in axes if isinstance(axes, tuple) else (axes,):
        n *= mesh.shape[a]
    return n


def _dim_ok(dim: int, size: int) -> bool:
    return dim % size == 0 and dim >= size


def _ok(dim: int, mesh: Mesh, axes) -> bool:
    return _dim_ok(dim, _size(mesh, axes))


def moe_mode(cfg, tp: int) -> str:
    """Expert placement over ``tp`` model ranks: "ep" when the expert dim
    divides (and :data:`MOE_SHARDING` asks for it), else "tp"."""
    if MOE_SHARDING == "ep" and _dim_ok(cfg.n_experts, tp):
        return "ep"
    return "tp"


_TP_OUT = frozenset({"wq", "wk", "wv", "w1", "w3", "wx", "wz",
                     "w_gate_branch", "w_in", "wdt", "wb", "wc", "w_a",
                     "w_i"})
_TP_IN = frozenset({"wo", "w2", "w_out"})


def param_spec(path_keys: list[str], shape: tuple[int, ...], mesh: Mesh,
               cfg) -> tuple:
    """Placement of one parameter (its GLOBAL shape) over the mesh: the
    reference's rule, entry for entry as its ``PartitionSpec`` holds them
    (``"model"``, ``"data"`` — the FSDP axes, a one-axis tuple written as
    its axis —, or None per dim). Stacked layer leaves carry a leading
    layer dim, never sharded; leaves of at most 2 dims (norms, biases,
    per-head vectors) and conv taps replicate."""
    fa = _spec_entry(fsdp_axes(mesh))
    name = path_keys[-1]
    if name in ("embed", "out_embed"):
        return ("model", None)
    if len(shape) <= 2 or name == "conv":
        return (None,) * len(shape)
    lead = (None,) * (len(shape) - 2)
    d_in, d_out = shape[-2], shape[-1]
    fsdp_in = fa if fa and _ok(d_in, mesh, fa) else None
    if (MOE_SHARDING == "ep" and name in ("w1", "w2", "w3")
            and len(shape) == 4 and _ok(shape[1], mesh, "model")):
        return (None, "model", fsdp_in, None)
    if name in _TP_OUT:
        return lead + (fsdp_in,
                       "model" if _ok(d_out, mesh, "model") else None)
    if name in _TP_IN:
        return lead + ("model" if _ok(d_in, mesh, "model") else None,
                       fa if fa and _ok(d_out, mesh, fa) else None)
    if name == "router":
        return lead + (fsdp_in, None)
    return (None,) * len(shape)


def spec_dims(spec: tuple) -> dict[str, int]:
    """{axis: dim} of the axes a spec shards (``"model"``, ``"data"``)."""
    out = {}
    for i, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                out[a] = i
    return out


def shard_dim(spec: tuple) -> int | None:
    """The dim a spec puts on "model", or None."""
    return spec_dims(spec).get("model")


def map_with_path(fn, tree, path=()):
    """``tree`` (dicts and lists of tensors, Nones kept) with each leaf
    replaced by ``fn(path, leaf)``; ``path``: the str keys down to it."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(path, tree)


def local_slice(t: torch.Tensor, dim: int | None, size: int, index: int
                ) -> torch.Tensor:
    """This rank's contiguous block of ``t`` along ``dim`` (a copy)."""
    if dim is None or size == 1:
        return t
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n).clone().contiguous()


def local_shape(shape, spec: tuple, mesh: Mesh,
                axes: tuple[str, ...] = ("model", "data")) -> tuple:
    """The block of a ``shape`` leaf placed by ``spec`` that one rank
    holds, over the mesh axes named in ``axes``."""
    out = list(shape)
    for a, d in spec_dims(spec).items():
        if a in axes:
            out[d] //= mesh.shape[a]
    return tuple(out)


def shard_params(params: dict, mesh: Mesh, cfg) -> dict:
    """Full params -> this rank's params: every leaf cut to this rank's
    block along each dim :func:`param_spec` places on "model" or "data"
    (copied, so the full tensor can be freed); replicated leaves as
    given."""
    idx = {"model": mesh.model.index, "data": mesh.data.index}

    def one(path, t):
        spec = param_spec(list(path), tuple(t.shape), mesh, cfg)
        for a, d in spec_dims(spec).items():
            t = local_slice(t, d, mesh.shape[a], idx[a])
        return t

    return map_with_path(one, params)


def cache_shardings(cache: list, mesh: Mesh, cfg, paged: bool = False
                    ) -> list:
    """Placement of the serving cache's leaves (GLOBAL shapes, the
    structure of :func:`repro_torch.models.transformer.init_cache`): the
    reference's rule, entry for entry — batch (axis 1) over the FSDP axes
    when it divides (not the paged pool's block axis), the KV ring's and
    the pool's KV heads over "model", else (the dense ring only) its
    positions over "model" when they divide, the SSM and RG-LRU
    ``state``'s heads / width over "model". ``cfg`` is the reference's
    argument, unread there as here."""
    fa = _spec_entry(fsdp_axes(mesh))

    def one(path, leaf):
        shape, name = tuple(leaf.shape), path[-1]
        spec = [None] * len(shape)
        pool_leaf = paged and name in ("k", "v") and len(shape) == 5
        if len(shape) >= 2 and not pool_leaf and fa and _ok(shape[1], mesh,
                                                            fa):
            spec[1] = fa
        if name in ("k", "v") and len(shape) == 5:
            if _ok(shape[3], mesh, "model"):
                spec[3] = "model"
            elif not pool_leaf and _ok(shape[2], mesh, "model"):
                spec[2] = "model"
        elif name == "state" and len(shape) >= 3:
            if _ok(shape[2], mesh, "model"):
                spec[2] = "model"
        return tuple(spec)

    return map_with_path(one, cache)


def data_rows(n: int, mesh: Mesh) -> tuple[int, int]:
    """(start, stop) of the global-batch rows this rank holds: a block of
    ``n / dp`` rows when ``dp`` divides ``n``, else all of them (the
    reference's ``_dim_ok``: replicated)."""
    dp = mesh.dp
    if not _dim_ok(n, dp):
        return 0, n
    b = n // dp
    return mesh.data.index * b, (mesh.data.index + 1) * b


def data_shardings(batch: dict, mesh: Mesh) -> dict:
    """This rank's slice of a global batch ``{name: (GB, ...)}`` (scalars
    replicated)."""
    out = {}
    for k, x in batch.items():
        if x.ndim == 0:
            out[k] = x
            continue
        a, b = data_rows(x.shape[0], mesh)
        out[k] = x[a:b]
    return out


def stacked_data_shardings(batches: dict, mesh: Mesh) -> dict:
    """The same for fused-window batches ``(T, GB, ...)``: axis 1 is the
    global batch."""
    out = {}
    for k, x in batches.items():
        if x.ndim <= 1:
            out[k] = x
            continue
        a, b = data_rows(x.shape[1], mesh)
        out[k] = x[:, a:b]
    return out


# ------------------------------------------------------------------ ranks
def init_rank(rank: int, world: int, init_method: str, *, backend: str,
              device: str | None = None,
              timeout_s: float | None = None) -> torch.device:
    """Join the process group as ``rank`` of ``world`` and return the
    device this rank runs on: ``cuda:<rank % cards>`` unless ``device``
    names one (e.g. "cpu"). ``backend`` is required and never changes by
    itself; NCCL with more ranks than cards is refused."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r} (gloo | nccl)")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run the ranks on the CPU")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        dev = torch.device(device)
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if dev.type != "cuda" or world > cards:
            raise ValueError(
                f"nccl needs one card per rank: {world} ranks, {cards} "
                "cards (ranks that share a card run under gloo)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=_timeout(timeout_s))
    return dev


def _entry(fn: Callable, rank: int, args: tuple) -> None:
    try:
        fn(rank, *args)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: tuple = (), *,
              timeout_s: float | None = None) -> None:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes and wait for
    all of them (at most ``timeout_s``, if given: a deadlock fails the
    ranks at their groups' timeout anyway). A rank that fails, or the
    deadline, kills the others and raises: no run outlives its caller.
    ``fn`` must be importable (a module-level function) and joins the
    group itself (:func:`init_rank`)."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    failed = None
    try:
        while True:
            codes = [p.exitcode for p in procs]
            bad = [(r, c) for r, c in enumerate(codes)
                   if c is not None and c != 0]
            if bad:
                failed = f"rank {bad[0][0]} exited with code {bad[0][1]}"
                break
            if all(c == 0 for c in codes):
                return
            if deadline is not None and time.monotonic() > deadline:
                failed = f"ranks did not finish within {timeout_s:.0f} s"
                break
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(5)
    raise RuntimeError(failed)


def file_init_method(directory: str) -> str:
    """A ``file://`` rendezvous in ``directory`` (no port to collide)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"dist_init_{os.getpid()}_{time.time_ns()}")
    return "file://" + os.path.abspath(path)

