"""The assigned (architecture x input-shape) cells and their meta-tensor
stand-ins (counterpart of ``repro/launch/specs.py``): shapes and dtypes,
no storage.

Shapes (from the assignment):
  train_4k    : seq 4096,   global_batch 256  -> train_step
  prefill_32k : seq 32768,  global_batch 32   -> prefill_step (encode for
                encoder-only archs)
  decode_32k  : seq 32768,  global_batch 128  -> serve_step (1 new token,
                KV cache of 32768)
  long_500k   : seq 524288, global_batch 1    -> serve_step; only for
                sub-quadratic archs (SWA / SSM / RG-LRU)

Skips: encoder-only archs have no decode; pure full-attention archs skip
long_500k.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import precision
from repro_torch.models.config import ArchConfig

__all__ = ["SHAPES", "Cell", "cells_for", "all_cells", "batch_specs",
           "skip_reason", "COMPUTE_DTYPE"]

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# the default policy's trunk dtype (the reference's COMPUTE_DTYPE)
COMPUTE_DTYPE = precision.BF16.compute_dtype


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str

    @property
    def kind(self) -> str:
        return SHAPES[self.shape]["kind"]

    @property
    def seq(self) -> int:
        return SHAPES[self.shape]["seq"]

    @property
    def batch(self) -> int:
        return SHAPES[self.shape]["batch"]


def skip_reason(cfg: ArchConfig, shape: str) -> str | None:
    kind = SHAPES[shape]["kind"]
    if kind == "decode" and not cfg.has_decode:
        return "encoder-only: no autoregressive decode step"
    if shape == "long_500k" and not cfg.sub_quadratic:
        return "pure full attention: 500k context excluded per assignment"
    return None


def cells_for(cfg: ArchConfig) -> list[Cell]:
    return [
        Cell(cfg.name, s) for s in SHAPES if skip_reason(cfg, s) is None
    ]


def all_cells() -> list[Cell]:
    from repro_torch.configs import ARCHS, get

    out = []
    for a in ARCHS:
        out.extend(cells_for(get(a)))
    return out


def _i32(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _emb(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=COMPUTE_DTYPE, device="meta")


def batch_specs(cfg: ArchConfig, shape: str) -> dict[str, Any]:
    """Meta tensors for the *data* arguments of the cell's step fn (the
    global batch)."""
    info = SHAPES[shape]
    b, l = info["batch"], info["seq"]
    kind = info["kind"]

    if kind in ("train", "prefill"):
        if cfg.frontend == "audio_stub":
            batch = {"frames": _emb(b, l, cfg.d_model), "labels": _i32(b, l)}
        elif cfg.frontend == "vision_stub":
            lt = l - cfg.n_prefix_tokens
            batch = {
                "patches": _emb(b, cfg.n_prefix_tokens, cfg.d_model),
                "tokens": _i32(b, lt),
                "labels": _i32(b, lt),
            }
        else:
            batch = {"tokens": _i32(b, l), "labels": _i32(b, l)}
        return {"batch": batch}

    # decode: one new token against a seq-long cache
    return {"ids": _i32(b), "pos": _i32(b)}
