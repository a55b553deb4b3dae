"""Carry weights and index state across from the JAX package.

The port's parameters and index states keep the reference's structure, so
conversion is a structural copy of numpy arrays (what ``jax.device_get``
returns) into tensors: the converted objects compute the same function as
their JAX source. This module imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.mips.exact import ExactConfig, ExactIndex
from repro_torch.core.mips.ivf import IVFConfig, IVFIndex, IVFState
from repro_torch.core.mips.lsh import LSHConfig, LSHIndex, LSHState
from repro_torch.core.mips.pq import IVFPQIndex, PQConfig, PQState
from repro_torch.core.mips.sharded import ShardedIndex
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig

__all__ = ["tree_from_numpy", "params_from_jax", "opt_state_from_jax",
           "ivf_state_from_jax", "pq_state_from_jax", "lsh_state_from_jax",
           "shard_params_from_jax", "sharded_index_from_jax"]


def tree_from_numpy(tree: Any, device=None) -> Any:
    """dicts / lists / tuples of numpy arrays -> the same structure of
    tensors on ``device`` (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_from_jax(np_tree: dict, cfg: ArchConfig, device=None) -> dict:
    """The JAX param pytree of ``cfg`` (``transformer.init_params``'s
    structure, as numpy arrays) -> the port's params. The block groups and
    each group's stacked layer count must be :func:`transformer
    .block_groups`' and ``embed`` present unless the frontend is the audio
    stub, or ``ValueError``."""
    params = tree_from_numpy(np_tree, device)
    vp, d = cfg.vocab_padded, cfg.d_model
    want_embed = cfg.frontend != "audio_stub"
    embed = params.get("embed")
    if (embed is not None) != want_embed or (
            embed is not None and tuple(embed.shape) != (vp, d)):
        raise ValueError(
            f"param tree does not match {cfg.name}: embed "
            f"{None if embed is None else tuple(embed.shape)}, expected "
            f"{(vp, d) if want_embed else None}")
    groups = transformer.block_groups(cfg)
    if len(params["blocks"]) != len(groups):
        raise ValueError(f"{len(params['blocks'])} block groups, config has "
                         f"{len(groups)}")
    for g, (stack, (pattern, count)) in enumerate(zip(params["blocks"],
                                                      groups)):
        if sorted(stack) != sorted(str(j) for j in range(len(pattern))):
            raise ValueError(f"block group {g} holds layers {sorted(stack)}, "
                             f"config pattern {pattern}")
        for j in stack:
            n = stack[j]["norm1"].shape[0]
            if n != count:
                raise ValueError(f"block group {g} layer {j}: {n} stacked "
                                 f"layers, config has {count}")
    return params


def opt_state_from_jax(np_opt: dict, cfg: ArchConfig, device=None) -> dict:
    """The JAX AdamW state (``repro.optim.adamw.init``'s ``{"m", "v",
    "step"}``, as numpy arrays) -> the port's (:mod:`repro_torch.optim
    .adamw`): fp32 moments in the params' structure, an int32 step."""
    return {"m": params_from_jax(np_opt["m"], cfg, device),
            "v": params_from_jax(np_opt["v"], cfg, device),
            "step": torch.tensor(int(np.asarray(np_opt["step"])),
                                 dtype=torch.int32, device=device)}


def ivf_state_from_jax(np_state, device=None) -> IVFState:
    """A JAX ``IVFState`` (NamedTuple of numpy arrays, same field order) ->
    the port's :class:`IVFState`."""
    return IVFState(*(torch.from_numpy(np.array(x, copy=True)).to(device)
                      for x in np_state))


def pq_state_from_jax(np_state, db: torch.Tensor) -> PQState:
    """A JAX ``PQState`` (NamedTuple of numpy arrays, same field order) ->
    the port's :class:`PQState` on ``db``'s device. Every field is
    converted except ``db``: the state takes the caller's ``db`` tensor
    itself, as an index built over it would, so the re-rank rows stay the
    caller's (no copy)."""
    fields = [torch.from_numpy(np.array(x, copy=True)).to(db.device)
              for x in tuple(np_state)[:-1]]
    return PQState(*fields, db=db)


def lsh_state_from_jax(np_leaves, device=None) -> LSHState:
    """A JAX ``LSHIndex``'s leaves (``(proj, table_ids, db_aug, counts)``,
    its pytree children, as numpy arrays) -> the port's :class:`LSHState`;
    ``LSHIndex(config, state)`` serves it."""
    return LSHState(*(torch.from_numpy(np.array(x, copy=True)).to(device)
                      for x in np_leaves))


def shard_params_from_jax(np_tree: dict, cfg: ArchConfig, mesh,
                          device=None) -> dict:
    """The reference's full params (numpy) -> THIS rank's params on
    ``mesh``: :func:`params_from_jax`, then every leaf cut to this rank's
    block along each dim its spec places on ``model`` or ``data`` — 2-D
    blocks for the trunk's matrices
    (:func:`repro_torch.launch.mesh.shard_params`)."""
    from repro_torch.launch.mesh import shard_params

    return shard_params(params_from_jax(np_tree, cfg, device), mesh, cfg)


def sharded_index_from_jax(np_state, config, mesh, n_local: int, *,
                           axis: str = "model", device=None,
                           db_loc: torch.Tensor | None = None
                           ) -> ShardedIndex:
    """A reference ``ShardedIndex``'s stacked state (its ``state``: the
    backend's pytree children, every leaf with a leading shard axis, as
    numpy) -> this rank's shard as a port :class:`ShardedIndex` under the
    port's backend ``config``. Each backend's leaves go through its
    ``*_state_from_jax``; an IVF-PQ shard takes ``db_loc`` (this rank's
    rows) as its re-rank table, or a copy of the reference's slice."""
    s = mesh.axis(axis).index

    def pick(leaves):
        return tuple(np.asarray(x)[s] for x in leaves)

    if isinstance(config, IVFConfig):
        local = IVFIndex(config, ivf_state_from_jax(pick(np_state[0]), device))
    elif isinstance(config, PQConfig):
        st = pick(np_state[0])
        db = (db_loc if db_loc is not None
              else torch.from_numpy(np.array(st[-1], copy=True)).to(device))
        local = IVFPQIndex(config, pq_state_from_jax(st, db))
    elif isinstance(config, LSHConfig):
        local = LSHIndex(config, lsh_state_from_jax(pick(np_state), device))
    elif isinstance(config, ExactConfig):
        local = ExactIndex(config, torch.from_numpy(
            np.array(pick(np_state)[0], copy=True)).to(device))
    else:
        raise TypeError(f"no sharded conversion for {type(config).__name__}")
    return ShardedIndex(config, mesh, axis, n_local, local)
