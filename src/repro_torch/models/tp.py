"""How the trunk's blocks compute on leaves stored as
:func:`repro_torch.launch.mesh.param_spec` places them (no counterpart
file: the reference leaves this to GSPMD).

A block reads its leaves after the per-layer FSDP gather over ``data``
(:func:`fsdp_gather`, inside the layer's checkpoint), so a leaf arrives
split over ``model`` at most. The block then computes Megatron-style,
its route a pure function of (config, mesh): its input enters through
``copy_to``; column-split leaves give this rank its heads, channels or
gate blocks and row-split ones a partial output summed by
``reduce_from``; where the reference's split does not fall on whole
heads (the SSM's B / C projections, the RG-LRU gate blocks' columns, KV
projections whose heads do not divide ``tp``) the leaf is gathered over
``model`` (:func:`whole`, a reduce-scatter backward; a leaf the spec
keeps whole enters through ``copy_to`` instead); replicated
per-head / per-channel leaves enter through ``copy_to`` and are sliced
(:func:`local`). Where the split would cut a head or gate block in the
compute (query heads, or RG-LRU gate blocks, that ``tp`` does not
divide: starcoder2's 24 heads, paligemma's 8, Griffin's 8 gate blocks at
tp 16), the block is computed whole on every rank of ``model``
(:func:`replicated`: its leaves gathered, no ``copy_to`` on the way in,
no sum on the way out): redundant work, the same function.
"""
from __future__ import annotations

import torch

from repro_torch import collectives as coll
from repro_torch.launch import mesh as mesh_lib

__all__ = ["model_axis", "model_dim", "whole", "replicated", "local",
           "fsdp_gather"]


def model_axis(mesh) -> coll.Axis | None:
    """The mesh's model axis, or None on one device or a tp-1 mesh."""
    return None if mesh is None or mesh.tp == 1 else mesh.model


def model_dim(spec: tuple | None, mesh) -> int | None:
    """The dim of a per-layer leaf that its spec (``spec``, the layer dim
    dropped; None off a mesh) splits over "model", or None (also on a
    tp-1 mesh)."""
    if model_axis(mesh) is None:
        return None
    return mesh_lib.shard_dim(spec)


def whole(w: torch.Tensor, spec: tuple | None, mesh, *,
          dtype: torch.dtype | None = None) -> torch.Tensor:
    """The whole per-layer leaf for a use that is shard-local on this rank
    (``spec``: its per-layer spec). Split over "model", it is gathered (in
    ``dtype``), the gradient reduce-scattered; stored whole, it enters
    through ``copy_to``, so every replica's gradient sums every rank's
    part. Off a model axis, ``w`` itself."""
    ax = model_axis(mesh)
    if ax is None:
        return w
    d = mesh_lib.shard_dim(spec)
    if d is None:
        return coll.copy_to(w, ax)
    return coll.all_gather_dim(w, ax, d, dtype=dtype)


def replicated(w: torch.Tensor, spec: tuple | None, mesh, *,
               dtype: torch.dtype | None = None) -> torch.Tensor:
    """The whole per-layer leaf for a block that every rank of ``model``
    computes whole on the same input: split over "model", it is gathered
    and its gradient — the same whole gradient on every rank — cut back
    to this rank's block; stored whole, it is used as it is (each replica
    computes its own gradient in full). Off a model axis, ``w`` itself."""
    ax = model_axis(mesh)
    d = None if ax is None else mesh_lib.shard_dim(spec)
    if d is None:
        return w if dtype is None else w.to(dtype)
    return coll.all_gather_dim_replicated(w, ax, d, dtype=dtype)


def local(t: torch.Tensor, ax: coll.Axis, dim: int, start: int, n: int
          ) -> torch.Tensor:
    """Rows ``[start, start + n)`` along ``dim`` of a leaf replicated over
    ``ax`` that this rank uses alone: it enters through ``copy_to``, so
    every rank's gradient is the whole one."""
    return coll.copy_to(t, ax).narrow(dim, start, n)


def fsdp_gather(tree: dict, specs: dict, mesh, dtype: torch.dtype,
                cast: frozenset) -> dict:
    """One layer's leaves with every dim their spec puts on "data"
    gathered (the leaves named in ``cast`` in ``dtype``, so the gather
    moves the compute dtype); the gradient is reduce-scattered back in the
    leaf's own dtype. The identity on one data rank."""
    if mesh is None or mesh.dp == 1:
        return tree

    def one(t, spec, name):
        if isinstance(t, dict):
            return {k: one(v, spec[k], k) for k, v in t.items()}
        d = mesh_lib.spec_dims(spec).get("data")
        if d is None:
            return t
        return coll.all_gather_dim(t, mesh.data, d,
                                   dtype=dtype if name in cast else None)

    return one(tree, specs, None)
