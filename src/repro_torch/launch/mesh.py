"""The ``("data", "model")`` mesh on ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``), the placement of the leaves the port shards, and
the helpers that start and join ranks.

Rank layout is the reference's ``devs[:dp*tp].reshape(dp, tp)``: rank =
``data * tp + model``. Each rank holds one process group per axis: the
``model`` group is the ``tp`` ranks of its data row, the ``data`` group the
``dp`` ranks of its model column.

What is sharded. The reference lays every large weight out 2-D through
GSPMD, which moves work without changing the function. The port shards
what the reference shards explicitly inside ``shard_map``:

* the output embedding's rows over ``model`` — the distributed head
  (:mod:`repro_torch.models.head`) and its
  :class:`repro_torch.core.mips.ShardedIndex`;
* the MoE experts over ``model`` (:func:`repro_torch.models.moe
  .forward_dist`): the expert dim when ``E % tp == 0`` ("ep"), else the
  expert FFN hidden ("tp");
* the batch over ``data``.

The rest of the trunk is replicated over ``model`` (Megatron-style TP and
FSDP of the trunk weights are not in the port). :func:`param_spec` is the
reference's rule for these leaves, as data.

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
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.collectives import Axis

__all__ = ["Mesh", "MOE_SHARDING", "DEFAULT_TIMEOUT_S", "make_train_mesh",
           "fsdp_axes", "param_spec", "moe_mode", "shard_dim", "local_slice",
           "shard_params", "data_rows", "data_shardings",
           "stacked_data_shardings", "init_rank", "run_ranks",
           "file_init_method"]

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


def fsdp_axes(mesh: Mesh) -> tuple[str, ...]:
    """The batch axes of the mesh (the reference's FSDP axes): ``data``."""
    return ("data",)


def _dim_ok(dim: int, size: int) -> bool:
    return dim % size == 0 and dim >= size


def moe_mode(cfg, tp: int) -> str:
    """Expert placement over ``tp`` model ranks: "ep" when the expert dim
    divides (and :data:`MOE_SHARDING` asks for it), else "tp"."""
    if MOE_SHARDING == "ep" and _dim_ok(cfg.n_experts, tp):
        return "ep"
    return "tp"


def param_spec(path_keys: list[str], shape: tuple[int, ...], mesh: Mesh,
               cfg) -> tuple:
    """Placement of one parameter over the mesh, as the reference's
    ``PartitionSpec`` entries (a tuple: "model" or None per dim), for the
    leaves the port shards; every other leaf is replicated (all None).

    * ``out_embed`` (V, d): rows over "model";
    * MoE experts (L, E, in, out): the expert dim over "model" in "ep";
      in "tp" the FFN hidden: ``w1`` / ``w3``'s out dim, ``w2``'s in dim.
    """
    name = path_keys[-1]
    rep = (None,) * len(shape)
    if name == "out_embed" and len(shape) == 2:
        return ("model", None)
    if (name in ("w1", "w2", "w3") and len(shape) == 4
            and "mlp" in path_keys and getattr(cfg, "is_moe", False)):
        tp = mesh.shape["model"]
        if moe_mode(cfg, tp) == "ep":
            return (None, "model", None, None)
        dim = 2 if name == "w2" else 3
        if not _dim_ok(shape[dim], tp):
            return rep
        return tuple("model" if i == dim else None for i in range(4))
    return rep


def shard_dim(spec: tuple) -> int | None:
    """The dim a spec puts on "model", or None."""
    return spec.index("model") if "model" in spec else None


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (str(i),))
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


def shard_params(params: dict, mesh: Mesh, cfg) -> dict:
    """Full params -> this rank's params: every leaf that
    :func:`param_spec` places on "model" cut to this rank's block (copied,
    so the full tensor can be freed), the rest as given."""
    tp, m = mesh.tp, mesh.model.index

    def one(path, t):
        return local_slice(t, shard_dim(param_spec(list(path), tuple(t.shape),
                                                   mesh, cfg)), tp, m)

    return _map_with_path(one, params)


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

