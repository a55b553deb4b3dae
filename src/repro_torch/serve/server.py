"""Pipelined batched-decode engine: continuous batching over the amortized
sampler (counterpart of ``repro/serve/server.py``; dense KV layout, fifo
admission, pipelined engine).

Serving is the paper's sweet spot: the output embedding (the MIPS database)
is frozen, every decoded token issues a fresh query, and the head index is
built once at server start — pure amortization.

* **Batched prefill** — admitted prompts are right-padded to a chunk bucket
  and run through ``Model.prefill_into_cache`` at once, writing each
  prompt's KV ring into its slot and sampling the first output token.
* **Decode windows** — ``decode_window`` tokens per window with per-slot
  active masks and EOS / length-budget checks on the device.
* **Async host pipeline** — one window stays in flight: the host enqueues
  window t+1 before reading window t's tokens back, so bookkeeping
  overlaps device work. Slot state lives on the device; the host mirrors
  it from the emitted tokens.
* **Admission control** — prompts longer than ``max_seq - max_new_tokens``
  are truncated (newest tokens kept) or rejected.

Sample keys derive from (request id, position)
(:func:`repro_torch.launch.steps.slot_keys`), so a request's tokens do not
depend on the decode window, the slot it lands in, or its batch-mates.

Not in the port yet: the paged block pool, the slo scheduler, strict
re-sampling, the probe router, the adaptive probe and the reference
single-step engine.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import warnings

import numpy as np
import torch

from repro_torch.core import mips
from repro_torch.launch import steps as steps_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import Model

__all__ = ["ServeConfig", "Server", "RequestResult"]


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 8
    max_seq: int = 512
    max_new_tokens: int = 64
    eos_id: int = -1  # -1: never stops early (synthetic workloads)
    seed: int = 0
    decode_window: int = 8  # tokens decoded per window
    prefill_chunk: int = 32  # prompt-length bucket granularity
    overlength: str = "truncate"  # truncate (keep newest) | reject

    @property
    def prompt_cap(self) -> int:
        """Longest admissible prompt: leaves room for max_new_tokens."""
        return self.max_seq - self.max_new_tokens


@dataclasses.dataclass
class RequestResult:
    request_id: int
    tokens: list
    ok_rate: float
    latency_s: float
    ttft_s: float = 0.0  # host-observed time to first token (from enqueue)
    itl_ms: float = 0.0  # host-observed mean inter-token latency
    queue_time_s: float = 0.0  # enqueue -> prefill enqueue
    prompt_len: int = 0  # admitted (possibly truncated) prompt length
    status: str = "ok"  # ok | rejected


def _bucket(n: int, chunk: int) -> int:
    """Prompt-length bucket: a multiple of ``chunk``."""
    return -(-n // chunk) * chunk


class Server:
    """Serve ``params`` of ``cfg`` on ``device`` (CUDA unless named).

    ``index`` (optional) is a prebuilt head index to serve with instead of
    building one: two servers handed the same index probe identical tables
    (an IVF build on CUDA accumulates centroids with atomics, so two builds
    may differ in their last bits)."""

    def __init__(self, cfg: ArchConfig, params: dict, scfg: ServeConfig, *,
                 precision_policy=None, device=None, index=None):
        if scfg.overlength not in ("truncate", "reject"):
            raise ValueError(f"unknown overlength policy {scfg.overlength!r}")
        if scfg.decode_window < 1 or scfg.prefill_chunk < 1:
            raise ValueError("decode_window and prefill_chunk must be >= 1")
        if scfg.max_new_tokens >= scfg.max_seq:
            raise ValueError(
                f"max_new_tokens={scfg.max_new_tokens} leaves no room for "
                f"any prompt inside max_seq={scfg.max_seq}")
        self.cfg = cfg
        self.scfg = scfg
        self.model = Model(cfg, precision_policy, device=device)
        self.device = self.model.device
        self.params = params
        # trunk weights in the compute dtype once, not per step
        self.run_params = self.model.compute_params(params)
        self.decode_fn = steps_lib.make_decode_loop_step(
            self.model, scfg.decode_window, scfg.eos_id, scfg.max_seq)
        self.prefill_fn = steps_lib.make_prefill_into_cache_step(
            self.model, scfg.max_seq, scfg.eos_id, scfg.max_new_tokens)
        self.cache = self.model.init_cache(scfg.batch_slots, scfg.max_seq)
        self._runs = 0
        self.stats = {
            "steps": 0, "tokens": 0, "ok": 0, "fallbacks": 0,
            "prefill_dispatches": 0, "decode_dispatches": 0,
            "prefill_tokens": 0, "rejected": 0,
            "prefill_s": 0.0, "decode_s": 0.0,
            "probe_width_hist": {},
            "queue_depth": 0, "queue_depth_peak": 0,
            "slot_occupancy": 0, "slot_occupancy_peak": 0,
            "block_util_peak": 0.0, "block_stalls": 0,
            "cache_bytes": sum(t.numel() * t.element_size()
                               for g in self.cache for t in g["0"].values()),
        }
        # head MIPS index: built once over the frozen output embedding
        self.index = (index if index is not None
                      else self.model.make_head_index(params))
        self.stats["index_bytes"] = (self.index.memory_bytes()
                                     if self.index is not None else 0)
        # coverage contract (DESIGN.md §3); the two shortfalls have their
        # own remedies
        dropped, short = mips.index_spill_parts(self.index)
        self.stats["index_spill"] = dropped + short
        if dropped:
            warnings.warn(f"head index dropped {dropped} rows — raise "
                          "overflow_frac")
        if short:
            warnings.warn(f"head index re-rank pool short {short} slots — "
                          "lower PQConfig.rerank or raise n_probe")

    # ------------------------------------------------------------- admission
    def _validate(self, rid: int, prompt, results: list) -> list | None:
        """Admission control: returns the admitted (possibly truncated)
        prompt, or None after recording a rejected result."""
        s = self.scfg
        prompt = [int(x) for x in prompt]
        if not prompt or (len(prompt) > s.prompt_cap
                          and s.overlength == "reject"):
            results.append(RequestResult(
                request_id=rid, tokens=[], ok_rate=0.0, latency_s=0.0,
                prompt_len=len(prompt), status="rejected"))
            self.stats["rejected"] += 1
            return None
        return prompt[-s.prompt_cap:]

    def _finalize(self, req: dict, results: list) -> None:
        now = time.perf_counter()
        n = len(req["out"])
        itl = 0.0
        if n > 1 and req["t_first"] is not None:
            itl = (req["t_last"] - req["t_first"]) / (n - 1) * 1e3
        results.append(RequestResult(
            request_id=req["rid"], tokens=req["out"],
            ok_rate=req["ok"] / max(n, 1), latency_s=now - req["t_enq"],
            ttft_s=(req["t_first"] or now) - req["t_enq"], itl_ms=itl,
            queue_time_s=max(0.0, (req["t_admit"] or now) - req["t_enq"]),
            prompt_len=len(req["prompt"]),
        ))

    def _mirror_done(self, req: dict) -> bool:
        """Host mirror of the device's done rule (steps._advance)."""
        s = self.scfg
        n = len(req["out"])
        if n >= s.max_new_tokens:
            return True
        if s.eos_id >= 0 and req["out"] and req["out"][-1] == s.eos_id:
            return True
        return len(req["prompt"]) + n > s.max_seq - 1

    def _gauges(self, n_queued: int, slot_req: list) -> None:
        occ = sum(r is not None for r in slot_req)
        st = self.stats
        st["queue_depth"] = n_queued
        st["queue_depth_peak"] = max(st["queue_depth_peak"], n_queued)
        st["slot_occupancy"] = occ
        st["slot_occupancy_peak"] = max(st["slot_occupancy_peak"], occ)

    # ---------------------------------------------------------------- run
    def run(self, prompts: list[list[int]]) -> list[RequestResult]:
        """Decode all prompts with continuous batching; one RequestResult
        per prompt (rejected ones flagged), in request order."""
        s = self.scfg
        dev = self.device
        nslots = s.batch_slots
        results: list[RequestResult] = []
        t_start = time.perf_counter()
        seed = s.seed + (self._runs << 32)  # a fresh stream per run
        self._runs += 1
        reqs: dict[int, dict] = {}
        waiting: collections.deque = collections.deque()
        for rid, prompt in enumerate(prompts):
            p = self._validate(rid, prompt, results)
            if p is None:
                continue
            reqs[rid] = {"rid": rid, "prompt": p, "out": [], "ok": 0,
                         "t_enq": t_start, "t_admit": None, "t_first": None,
                         "t_last": None}
            waiting.append(rid)

        state = {
            "ids": torch.zeros((nslots,), dtype=torch.int64, device=dev),
            "pos": torch.zeros((nslots,), dtype=torch.int64, device=dev),
            "active": torch.zeros((nslots,), dtype=torch.bool, device=dev),
            "budget": torch.zeros((nslots,), dtype=torch.int64, device=dev),
            "rid": torch.full((nslots,), -1, dtype=torch.int64, device=dev),
        }
        cache = self.cache
        slot_req: list[int | None] = [None] * nslots
        free = list(range(nslots))
        # FIFO of results not yet read back; one entry stays in flight so
        # host bookkeeping overlaps device work
        pending: collections.deque = collections.deque()

        def retire(req, slot) -> None:
            self._finalize(req, results)
            slot_req[slot] = None
            free.append(slot)

        def emit(req, tok: int, ok: bool, now: float) -> bool:
            req["out"].append(tok)
            req["ok"] += ok
            if req["t_first"] is None:
                req["t_first"] = now
            req["t_last"] = now
            self.stats["tokens"] += 1
            self.stats["ok"] += ok
            return self._mirror_done(req)

        def process(entry) -> None:
            kind, arrs, info = entry
            t0 = time.perf_counter()
            arrs = [a.cpu().numpy() for a in arrs]
            self.stats[f"{kind}_s"] += time.perf_counter() - t0
            now = time.perf_counter()
            if kind == "prefill":
                nxt, ok = arrs
                for row, (rid, slot) in enumerate(info):
                    if emit(reqs[rid], int(nxt[row]), bool(ok[row]), now):
                        retire(reqs[rid], slot)
                return
            toks, oks, emitted = arrs
            for t in range(toks.shape[0]):
                for slot in range(nslots):
                    rid = info[slot]
                    if not emitted[t, slot] or rid is None:
                        continue
                    if emit(reqs[rid], int(toks[t, slot]), bool(oks[t, slot]),
                            now):
                        retire(reqs[rid], slot)

        while len(results) < len(prompts):
            self._gauges(len(waiting), slot_req)
            # 1) admission: every free slot takes the next waiting request;
            # one batched prefill per admission round
            if waiting and free:
                free.sort()
                batch = []
                while waiting and free:
                    batch.append((waiting.popleft(), free.pop(0)))
                t_admit = time.perf_counter()
                lp = _bucket(max(len(reqs[r]["prompt"]) for r, _ in batch),
                             s.prefill_chunk)
                # always nslots rows: the prefill's shapes (and so its
                # kernels and their per-row arithmetic) never depend on how
                # many requests an admission round happens to take
                tokens = np.zeros((nslots, lp), np.int64)
                lengths = np.ones((nslots,), np.int64)
                slots = np.full((nslots,), nslots, np.int64)  # pad rows
                rids = np.full((nslots,), -1, np.int64)
                for row, (rid, slot) in enumerate(batch):
                    p = reqs[rid]["prompt"]
                    tokens[row, : len(p)] = p
                    lengths[row] = len(p)
                    slots[row] = slot
                    rids[row] = rid
                    slot_req[slot] = rid
                    reqs[rid]["t_admit"] = t_admit
                cache, state, nxt, ok = self.prefill_fn(
                    self.run_params, cache, state,
                    torch.from_numpy(tokens).to(dev),
                    torch.from_numpy(lengths).to(dev),
                    torch.from_numpy(slots).to(dev),
                    torch.from_numpy(rids).to(dev), seed, self.index)
                pending.append(("prefill", (nxt, ok), batch))
                self.stats["prefill_dispatches"] += 1
                self.stats["steps"] += 1
                self.stats["prefill_tokens"] += int(lengths[:len(batch)].sum())
                self._gauges(len(waiting), slot_req)
            # 2) one decode window over the slots the host believes live
            live = any(r is not None for r in slot_req)
            if live:
                cache, state, toks, oks, emitted = self.decode_fn(
                    self.run_params, cache, state, seed, self.index)
                pending.append(("decode", (toks, oks, emitted),
                                list(slot_req)))
                self.stats["decode_dispatches"] += 1
                self.stats["steps"] += 1
            # 3) read back all but the newest entry (double buffering)
            while len(pending) > 1 or (pending and not live and not waiting):
                process(pending.popleft())

        while pending:
            process(pending.popleft())
        self._gauges(0, slot_req)
        self.cache = cache
        self.stats["wall_s"] = time.perf_counter() - t_start
        return sorted(results, key=lambda r: r.request_id)
