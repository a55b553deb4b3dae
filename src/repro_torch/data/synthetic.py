"""Deterministic, seekable synthetic data pipeline (the port's own copy of
``repro/data/synthetic.py``: numpy only, batches byte-identical to the
reference's).

Every step's batch is a pure function of ``(seed, step)`` via a counter-based
RNG, so the iterator state is a single integer — checkpoint/restore and
elastic restarts (different data-parallel size) are trivially exact, and a
restarted job reproduces the identical token stream.

Token streams are Zipfian (real vocab usage is heavy-tailed — this matters
for the paper's method: a spread-out tail is exactly the regime where
top-k-only truncation fails, §5 of the paper).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np

from repro_torch.models.config import ArchConfig

__all__ = ["DataConfig", "SyntheticStream", "make_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq: int
    seed: int = 0
    zipf_a: float = 1.2  # Zipf exponent for token marginals


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence((seed, step)))


def _zipf_tokens(rng, shape, vocab: int, a: float) -> np.ndarray:
    # inverse-CDF Zipf over [0, vocab) (np.random.zipf is unbounded)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks**-a
    p /= p.sum()
    cdf = np.cumsum(p)
    u = rng.random(shape)
    toks = np.searchsorted(cdf, u).astype(np.int32)
    # shuffle rank->token map deterministically so "frequent" ids spread out
    perm = np.random.default_rng(1234).permutation(vocab).astype(np.int32)
    return perm[toks]


def make_batch(cfg: ArchConfig, dcfg: DataConfig, step: int) -> dict[str, Any]:
    rng = _rng(dcfg.seed, step)
    b, l = dcfg.batch, dcfg.seq
    if cfg.frontend == "audio_stub":
        return {
            "frames": rng.standard_normal((b, l, cfg.d_model), np.float32),
            "labels": _zipf_tokens(rng, (b, l), cfg.vocab, dcfg.zipf_a),
        }
    if cfg.frontend == "vision_stub":
        lt = l - cfg.n_prefix_tokens
        stream = _zipf_tokens(rng, (b, lt + 1), cfg.vocab, dcfg.zipf_a)
        return {
            "patches": rng.standard_normal(
                (b, cfg.n_prefix_tokens, cfg.d_model), np.float32
            ),
            "tokens": stream[:, :-1],
            "labels": stream[:, 1:],
        }
    stream = _zipf_tokens(rng, (b, l + 1), cfg.vocab, dcfg.zipf_a)
    return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}


class SyntheticStream:
    """Stateful iterator facade over make_batch; state = step counter."""

    def __init__(self, cfg: ArchConfig, dcfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.dcfg = dcfg
        self.step = start_step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch = make_batch(self.cfg, self.dcfg, self.step)
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"step": self.step, "seed": self.dcfg.seed}

    def restore(self, state: dict) -> None:
        if state["seed"] != self.dcfg.seed:
            raise ValueError(f"data seed mismatch on restore: checkpoint "
                             f"{state['seed']}, stream {self.dcfg.seed}")
        self.step = int(state["step"])
