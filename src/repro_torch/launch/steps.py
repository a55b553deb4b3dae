"""Serving step functions (counterpart of ``repro/launch/steps.py``, dense
layout): per-slot sample keys, the slot-state transition, the decode
window and batched prefill admission.

Where the reference scans a decode window inside one jitted dispatch, the
port loops over it in Python; the per-slot state stays on the device and
the host reads it only through the emitted tokens.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Model

__all__ = ["slot_keys", "make_decode_loop_step", "make_prefill_into_cache_step"]


def slot_keys(seed: int, rids: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Per-slot sample keys: (B, 3) int64 rows (seed, request id, position)
    for the counter-based generator (:mod:`repro_torch.core.rng`).

    Keying on (request id, position) — not on a step counter or a slot — is
    what lets a decode window of any length, the batched prefill and any
    batch composition draw identical samples for the same request."""
    rids = rids.long()
    return torch.stack([torch.full_like(rids, seed), rids, pos.long()], dim=-1)


def _advance(state: dict, nxt: torch.Tensor, eos_id: int, max_seq: int
             ) -> tuple[dict, torch.Tensor]:
    """Slot-state transition for one decoded token.

    ``state`` is the engine's device-resident per-slot record: ids (B,)
    last token, pos (B,) its position, active (B,) bool, budget (B,)
    remaining new tokens, rid (B,) request id. Returns (state', emitted),
    emitted marking the slots that produced a token this step. Inactive
    slots are frozen (ids/pos don't move); their trunk still runs and
    rewrites their own ring slot, which admission replaces wholesale."""
    active = state["active"]
    ids = torch.where(active, nxt, state["ids"])
    pos = torch.where(active, state["pos"] + 1, state["pos"])
    budget = torch.where(active, state["budget"] - 1, state["budget"])
    eos_hit = (ids == eos_id) if eos_id >= 0 else torch.zeros_like(active)
    done = active & (eos_hit | (budget <= 0) | (pos + 1 > max_seq - 1))
    return dict(state, ids=ids, pos=pos, budget=budget,
                active=active & ~done), active


def make_decode_loop_step(model: Model, window: int, eos_id: int,
                          max_seq: int):
    """``decode_loop(params, cache, state, seed, index=None) -> (cache,
    state, tokens (T,B), ok (T,B), emitted (T,B))``: ``window`` decode steps
    with per-slot active masks and on-device EOS / length-budget checks."""

    def decode_loop(params, cache, state, seed: int, index=None):
        toks, oks, emitted = [], [], []
        for _ in range(window):
            keys = slot_keys(seed, state["rid"], state["pos"])
            nxt, ok, cache = model.decode_step(params, cache, state["ids"],
                                               state["pos"], index, keys=keys)
            state, em = _advance(state, nxt, eos_id, max_seq)
            toks.append(state["ids"])
            oks.append(ok)
            emitted.append(em)
        return (cache, state, torch.stack(toks), torch.stack(oks),
                torch.stack(emitted))

    return decode_loop


def make_prefill_into_cache_step(model: Model, max_seq: int, eos_id: int,
                                 max_new_tokens: int):
    """``prefill_admit(params, cache, state, tokens (Bn,Lp), lengths, slots,
    rids, seed, index=None) -> (cache, state, first_ids, ok)``.

    Writes each admitted prompt's KV ring straight into its slot, samples
    the first output token and commits the slot records on the device.
    Rows with slot >= B are admission padding: their writes are dropped."""

    def prefill_admit(params, cache, state, tokens, lengths, slots, rids,
                      seed: int, index=None):
        lengths = lengths.long()
        keys = slot_keys(seed, rids, lengths - 1)
        nxt, ok, cache = model.prefill_into_cache(
            params, cache, tokens, lengths, slots, keys, max_seq, index)
        budget = torch.full_like(lengths, max_new_tokens - 1)
        eos_hit = (nxt == eos_id) if eos_id >= 0 else torch.zeros_like(ok)
        alive = ~(eos_hit | (budget <= 0) | (lengths + 1 > max_seq - 1))
        b = state["ids"].shape[0]
        keep = torch.nonzero(slots < b)[:, 0]
        sel = slots[keep].long()
        new = {name: t.clone() for name, t in state.items()}
        for name, val in (("ids", nxt), ("pos", lengths), ("active", alive),
                          ("budget", budget), ("rid", rids)):
            new[name][sel] = val[keep].to(new[name].dtype)
        return cache, new, nxt, ok

    return prefill_admit
