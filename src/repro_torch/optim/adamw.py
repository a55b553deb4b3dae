"""AdamW with global-norm clipping and a warmup + cosine schedule
(counterpart of ``repro/optim/adamw.py``), in plain torch ops whose
arithmetic is the reference's line for line.

Mixed-precision contract (``repro_torch/precision.py``): this optimizer owns
the float32 MASTER state. ``init`` allocates fp32 moments; ``update``
upcasts incoming gradients to fp32 before they touch the moments, computes
the whole update in fp32 and writes parameters back in their stored dtype.
:func:`check_master_params` is the trainer's startup guard that no
parameter was initialized or restored in a compute dtype.

Where the reference returns new arrays, ``update`` writes the parameters
and moments IN PLACE (it returns the same objects): at full width a copy
of either is gigabytes. Its scalars (step, learning rate, bias
corrections, clip scale) stay 0-d device tensors, so an update never
waits for the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["OptConfig", "init", "update", "schedule", "global_norm",
           "check_master_params", "tree_leaves", "tree_map"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """Tensor leaves of nested dicts / lists in the reference's order (dict
    keys sorted, as ``jax.tree.leaves`` orders them); None is an empty
    subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: Any) -> Any:
    """``fn`` on every tensor leaf, keeping the structure (None stays);
    leaves are visited in :func:`tree_leaves`' order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def check_master_params(params: Any) -> None:
    """Raise if any float parameter is stored below fp32 precision: low
    precision copies are made at use inside the layers, never in storage."""
    bad = [tuple(p.shape) for p in tree_leaves(params)
           if p.is_floating_point() and torch.finfo(p.dtype).bits < 32]
    if bad:
        raise ValueError(
            f"non-fp32 master params (precision policy casts at use, never "
            f"in storage): shapes {bad[:5]}{'...' if len(bad) > 5 else ''}")


def init(params: Any) -> dict:
    """fp32 zero moments shaped like ``params`` and an int32 step counter,
    on the parameters' device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a 0-d tensor): linear warmup, then cosine
    down to ``min_lr_frac · lr``; fp32, as the reference computes it."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(grads: Any, state: dict, params: Any, cfg: OptConfig
           ) -> tuple[Any, dict, dict]:
    """One AdamW step -> (params, state, {"grad_norm", "lr"}); ``params``
    and the moments are updated in place (see the module doc)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        mh = m / b1c
        vh = v / b2c
        step_ = mh / (torch.sqrt(vh) + cfg.eps)
        if p.dim() >= 2:  # decay matrices only (norms / scales exempt)
            step_ = step_ + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * step_).to(p.dtype))
    return (params, {"m": state["m"], "v": state["v"], "step": step},
            {"grad_norm": gnorm, "lr": lr})
