"""Pipelined batched-decode engine: continuous batching over the amortized
sampler (counterpart of ``repro/serve/server.py``).

Serving is the paper's sweet spot: the output embedding (the MIPS database)
is frozen, every decoded token issues a fresh query, and the head index is
built once at server start — pure amortization (``refresh_index`` swaps it
after a params push).

Engine (``ServeConfig.engine="pipelined"``, the default):

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
depend on the decode window, the slot it lands in, its batch-mates, the
cache layout or the schedule — and equal those of the single-step
reference loop (``engine="reference"``), which teacher-forces prompts one
token per step and is kept as the comparator.

``strict=True`` re-samples certificate-failed tokens exactly
(:func:`repro_torch.core.amortized_head.head_sample`: the dense fallback is
computed for every step's rows and selected on the device, no host sync).

**Paged block cache** (``ServeConfig.block_len > 0``): the KV lives in a
shared ``(n_blocks + 1, block_len, ...)`` pool
(:func:`repro_torch.models.attention.init_pool`) and each slot walks a page
table committed at admission, so slot count decouples from worst-case
sequence length. Admission allocates a request's whole-lifetime blocks up
front (:mod:`repro_torch.serve.paging`: exhaustion is an admission stall,
never a mid-decode one) and frees them when it finishes. The scheduler
(:mod:`repro_torch.serve.scheduler`, ``ServeConfig.sched``) orders the
admission queue (fifo, or slo by TTFT deadline) and the slo one picks the
decode window per dispatch from the ITL EWMA.

``Server.run`` also accepts open-loop ``arrivals`` (per-request enqueue
offsets, seconds): requests become admissible once their arrival passes.

**TP serving** (``Server(mesh=)``): every rank of the mesh runs this
engine on the same requests in lockstep — each holds its blocks of the
trunk and of the embeddings, its KV heads and recurrent-state share
(:mod:`repro_torch.models.transformer`), and its shard of a
:class:`repro_torch.core.mips.ShardedIndex` — and the distributed head
(:mod:`repro_torch.models.head`) gives every rank the same tokens. The
reference is one SPMD host; here each rank runs its own host loop, so a
decision read off a clock or fitted from data is made once, on rank 0,
and broadcast before the step that uses it: the run's clock origin and,
each round, rank 0's clock reading and ITL EWMA (from which every rank
makes the same arrival, admission-order and slo-window decisions), and
the probe router's fitted weights (fitted on rank 0's shard). Every other
decision is made on replicated values. Strict re-sampling is refused on a
TP mesh, as in the reference. Rank 0 reports.
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
from repro_torch.models.transformer import ring_len
from repro_torch.serve import paging, scheduler as sched_lib

__all__ = ["ServeConfig", "Server", "RequestResult"]


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 8
    max_seq: int = 512
    max_new_tokens: int = 64
    eos_id: int = -1  # -1: never stops early (synthetic workloads)
    seed: int = 0
    strict: bool = False  # exact re-sample when ok=False
    engine: str = "pipelined"  # pipelined | reference (single-step loop)
    decode_window: int = 8  # tokens decoded per window (pipelined)
    prefill_chunk: int = 32  # prompt-length bucket granularity (pipelined)
    overlength: str = "truncate"  # truncate (keep newest) | reject
    probe_router: str = ""  # adaptive probe's learned stage router:
    #   "" disabled | "fit" train at startup on embedding-derived queries |
    #   a path to a router .npz (repro_torch.models.router.save_router)
    block_len: int = 0  # >0: paged KV pool with this block size (positions);
    #   0: dense slot-reserved rings
    n_blocks: int = 0  # paged pool size; 0 = auto (batch_slots * pages per
    #   slot — the dense layout's KV coverage)
    sched: str = "fifo"  # admission scheduler: fifo | slo (serve/scheduler)
    ttft_slo_s: float = 0.5  # slo scheduler: per-request TTFT target

    @property
    def prompt_cap(self) -> int:
        """Longest admissible prompt: leaves room for max_new_tokens."""
        return self.max_seq - self.max_new_tokens

    @property
    def paged(self) -> bool:
        return self.block_len > 0


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
    """Prompt-length bucket: a multiple of ``chunk``, then coarsened as the
    reference does, so that the trunk's tiling holds on the padded length
    (the SSM's chunk of 128 must divide it past 128 positions)."""
    out = -(-n // chunk) * chunk
    if out <= 128:
        return out
    if out <= 512:
        return -(-out // 128) * 128
    return -(-out // 512) * 512


class Server:
    """Serve ``params`` of ``cfg`` on ``device`` (CUDA unless named).

    ``index`` (optional) is a prebuilt head index to serve with instead of
    building one: two servers handed the same index probe identical tables
    (an IVF build on CUDA accumulates centroids with atomics, so two builds
    may differ in their last bits)."""

    def __init__(self, cfg: ArchConfig, params: dict, scfg: ServeConfig, *,
                 precision_policy=None, device=None, index=None, mesh=None):
        if scfg.engine not in ("pipelined", "reference"):
            raise ValueError(f"unknown engine {scfg.engine!r}")
        if scfg.overlength not in ("truncate", "reject"):
            raise ValueError(f"unknown overlength policy {scfg.overlength!r}")
        if scfg.decode_window < 1 or scfg.prefill_chunk < 1:
            raise ValueError("decode_window and prefill_chunk must be >= 1")
        if scfg.max_new_tokens >= scfg.max_seq:
            raise ValueError(
                f"max_new_tokens={scfg.max_new_tokens} leaves no room for "
                f"any prompt inside max_seq={scfg.max_seq}")
        if scfg.sched not in ("fifo", "slo"):
            raise ValueError(f"unknown scheduler {scfg.sched!r} (fifo | slo)")
        if mesh is not None and scfg.strict:
            raise NotImplementedError(
                "strict exact-fallback is not wired through the "
                "distributed head; serve with strict=False on a TP mesh")
        self.mesh = mesh
        self.cfg = cfg
        self.scfg = scfg
        self.model = Model(cfg, precision_policy, device=device, mesh=mesh)
        self.device = self.model.device
        self.params = params
        # trunk weights in the compute dtype once, not per step
        self.run_params = self.model.compute_params(params)

        # ---- paged block pool geometry (None on the dense layout)
        self.spec: paging.PagedSpec | None = None
        self.alloc: paging.BlockAllocator | None = None
        layout = None
        if scfg.paged:
            if scfg.engine != "pipelined":
                raise ValueError(
                    "paged cache layout requires engine='pipelined' (the "
                    "reference loop is the dense comparator)")
            n_pages = paging.PagedSpec.from_arch(
                cfg, scfg.max_seq, scfg.block_len, 1).n_pages
            self.spec = paging.PagedSpec.from_arch(
                cfg, scfg.max_seq, scfg.block_len,
                scfg.n_blocks or scfg.batch_slots * n_pages)
            layout = self.spec.layout
            # the maximal admissible request must fit the pool outright, or
            # it could never be admitted (a permanent stall)
            need_max = self.spec.pages_needed(scfg.prompt_cap,
                                              scfg.max_new_tokens)
            if need_max > self.spec.n_blocks:
                raise ValueError(
                    f"n_blocks={self.spec.n_blocks} cannot hold a maximal "
                    f"request (prompt_cap={scfg.prompt_cap} + "
                    f"max_new_tokens={scfg.max_new_tokens} needs {need_max} "
                    f"blocks of {scfg.block_len})")
            # every position a request can write (< max_seq) lands on a page
            # < n_pages: block exhaustion is an admission stall, never an
            # out-of-range page
            assert (scfg.prompt_cap + scfg.max_new_tokens <= scfg.max_seq
                    and self.spec.n_pages * scfg.block_len
                    == ring_len(cfg, scfg.max_seq)), (
                "page table does not cover the admissible position range")
            self.alloc = paging.BlockAllocator(self.spec)
        self.sched = sched_lib.make_scheduler(scfg.sched, scfg.ttft_slo_s)
        # window variants the slo scheduler may pick per dispatch (fifo only
        # ever uses the configured one)
        self._windows = sorted({1, max(1, scfg.decode_window // 4),
                                scfg.decode_window})
        if scfg.sched == "fifo":
            self._windows = [scfg.decode_window]
        self._itl_ms = 0.0  # EWMA per-token decode wall time (slo feedback)
        self._decode_fns: dict = {}  # the other windows' steps, made on use
        self.decode_fn = self._make_decode_fn(scfg.decode_window)
        self.prefill_fn = steps_lib.make_prefill_into_cache_step(
            self.model, scfg.max_seq, scfg.eos_id, scfg.max_new_tokens,
            strict=scfg.strict, paged=scfg.paged)
        self.ref_step_fn = steps_lib.make_reference_serve_step(
            self.model, strict=scfg.strict)
        self.cache = self.model.init_cache(scfg.batch_slots, scfg.max_seq,
                                           paged=layout)
        self._runs = 0
        self.stats = {
            "steps": 0, "tokens": 0, "ok": 0, "fallbacks": 0,
            "prefill_dispatches": 0, "decode_dispatches": 0,
            "prefill_tokens": 0, "rejected": 0,
            "prefill_s": 0.0, "decode_s": 0.0,
            # adaptive probe: emitted tokens per effective probe width
            # {width: count}; empty on fixed-width serving
            "probe_width_hist": {},
            # continuous-batching gauges (last seen + peak): admission queue
            # depth, live-slot occupancy, block-pool utilization, and
            # admission stalls caused by an empty block free list
            "queue_depth": 0, "queue_depth_peak": 0,
            "slot_occupancy": 0, "slot_occupancy_peak": 0,
            "block_util": 0.0, "block_util_peak": 0.0,
            "block_stalls": 0,
            # device bytes of the serving cache (pool or rings)
            "cache_bytes": sum(t.numel() * t.element_size()
                               for g in self.cache for layer in g.values()
                               for t in layer.values()),
        }
        # head MIPS index: built once over the frozen output embedding
        self.index = (index if index is not None
                      else self.model.make_head_index(params))
        self._index_health(where="build")
        self.router = self._make_router()

    def _make_decode_fn(self, window: int):
        s = self.scfg
        return steps_lib.make_decode_loop_step(
            self.model, window, s.eos_id, s.max_seq, strict=s.strict,
            paged=s.paged)

    def _decode_fn(self, window: int):
        """The decode-window step for ``window`` tokens: the configured
        window's is ``self.decode_fn``, the slo scheduler's others are made
        on first use."""
        if window == self.scfg.decode_window:
            return self.decode_fn
        if window not in self._decode_fns:
            self._decode_fns[window] = self._make_decode_fn(window)
        return self._decode_fns[window]

    def _index_health(self, where: str) -> None:
        """``stats`` carries the index's device footprint and its coverage
        shortfall; the two shortfall kinds warn with their own remedies."""
        dropped, short = mips.index_spill_parts(self.index)
        self.stats["index_spill"] = dropped + short
        self.stats["index_bytes"] = (self.index.memory_bytes()
                                     if self.index is not None else 0)
        if dropped:  # coverage contract (DESIGN.md §3) violated
            warnings.warn(f"head index {where} dropped {dropped} rows — "
                          "raise overflow_frac (IVF) or bucket_cap (LSH)")
        if short:
            hc = self.model.head_cfg
            knob = (f"at effective probe width <= {hc.n_probe_max} "
                    "(adaptive; see stats['probe_width_hist']) — lower "
                    "PQConfig.rerank or raise n_probe_max"
                    if hc.adaptive_probe
                    else "— lower PQConfig.rerank or raise n_probe")
            warnings.warn(f"head index {where}: re-rank pool short {short} "
                          f"slots {knob}")

    @property
    def _ranks(self) -> int:
        return 1 if self.mesh is None else self.mesh.world.size

    def _agree(self, value):
        """Rank 0's ``value`` on every rank (a host decision's input read
        off rank 0's clock); the value itself on one rank."""
        if self._ranks == 1:
            return value
        from repro_torch import collectives as coll

        return coll.broadcast_object(value, self.mesh.world)

    def _make_router(self):
        """The adaptive probe's stage router per ``scfg.probe_router`` (""
        disabled / "fit" a supervised fit at start-up / an .npz path). The
        fit takes queries from the embedding rows the index serves (scaled
        like low-temperature serving hiddens), labels each with its first
        certificate-passing stage and trains the tiny MLP, on the device.
        On a multi-rank mesh rank 0 fits on its own shard (the router each
        shard's probe uses, at the shard's k) and broadcasts the weights."""
        spec = self.scfg.probe_router
        hc = self.model.head_cfg
        if not spec:
            return None
        if not hc.adaptive_probe or self.index is None:
            warnings.warn("probe_router set but the adaptive probe is off "
                          "(head_adaptive_probe) — router ignored")
            return None
        from repro_torch.models import router as router_lib

        if spec != "fit":
            return router_lib.load_router(spec, device=self.device)
        router = None
        if self._ranks == 1 or self.mesh.rank == 0:
            index, k = self.index, hc.k
            if isinstance(index, mips.ShardedIndex):
                from repro_torch.models import head as dist_head

                index = index.local
                k = dist_head.shard_geometry(hc, self.cfg.vocab_padded,
                                             self.mesh.tp)[1]
            emb = self.model.head_index_db(self.params)
            stride = max(1, emb.shape[0] // 512)
            qs = emb[::stride][:512].float()
            qs = qs / torch.clamp(torch.linalg.norm(qs, dim=1, keepdim=True),
                                  min=1e-6) * 8.0  # peaked score profiles
            router = router_lib.train_router(index, qs, k, c=hc.c,
                                             seed=self.scfg.seed)
        if self._ranks > 1:
            router = router_lib.broadcast_router(router, self.mesh.world,
                                                 device=self.device)
        return router

    def _bin_widths(self, widths: np.ndarray, mask: np.ndarray | None) -> None:
        """Add emitted tokens' effective probe widths to
        ``stats["probe_width_hist"]`` (-1: a fixed-width path)."""
        sel = widths >= 0
        if mask is not None:
            sel &= mask
        w = widths[sel]
        if w.size == 0:
            return
        hist = self.stats["probe_width_hist"]
        vals, counts = np.unique(w, return_counts=True)
        for v, n in zip(vals.tolist(), counts.tolist()):
            hist[int(v)] = hist.get(int(v), 0) + int(n)

    def refresh_index(self, params=None) -> None:
        """Swap in a refreshed head index (e.g. after a params push): a
        warm-started rebuild over the (new) embedding that keeps every
        state tensor's shape."""
        if params is not None:
            self.params = params
            self.run_params = self.model.compute_params(params)
        if self.index is None:
            self.index = self.model.make_head_index(self.params)
        else:
            self.index = self.index.refresh(
                self.model.head_index_db(self.params))
        self._index_health(where="refresh")

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

    def _intake(self, prompts, results: list, t_start: float,
                arrivals=None, priorities=None):
        """Validate and register every prompt. ``arrivals`` (enqueue offsets
        from the run's start, seconds) and ``priorities`` (lower = more
        urgent) default to 0. Returns (arrival-ordered [(t_enq, rid)], rid
        -> request record); rejected prompts land in ``results``."""
        due: list[tuple[float, int]] = []
        reqs: dict[int, dict] = {}
        for rid, prompt in enumerate(prompts):
            p = self._validate(rid, prompt, results)
            if p is None:
                continue
            t_enq = t_start + (float(arrivals[rid]) if arrivals is not None
                               else 0.0)
            reqs[rid] = {
                "rid": rid, "prompt": p, "out": [], "ok": 0, "fed": 0,
                "t_enq": t_enq, "t_admit": None, "t_first": None,
                "t_last": None,
                "priority": (int(priorities[rid]) if priorities is not None
                             else 0),
                "blocks": [],
                "pages_needed": (
                    self.spec.pages_needed(len(p), self.scfg.max_new_tokens)
                    if self.spec is not None else 0),
            }
            due.append((t_enq, rid))
        due.sort()
        return due, reqs

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
        if self.alloc is not None and req["blocks"]:
            self.alloc.free(req["blocks"])
            req["blocks"] = []

    def _mirror_done(self, req: dict) -> bool:
        """Host mirror of the device's done rule (steps._advance)."""
        s = self.scfg
        n = len(req["out"])
        if n >= s.max_new_tokens:
            return True
        if s.eos_id >= 0 and req["out"] and req["out"][-1] == s.eos_id:
            return True
        return len(req["prompt"]) + n > s.max_seq - 1

    def _emit(self, req: dict, tok: int, ok: bool, now: float) -> bool:
        """Record one emitted token; True when the request is done."""
        req["out"].append(tok)
        req["ok"] += ok
        if req["t_first"] is None:
            req["t_first"] = now
        req["t_last"] = now
        self.stats["tokens"] += 1
        self.stats["ok"] += ok
        if self.scfg.strict and not ok:
            self.stats["fallbacks"] += 1
        return self._mirror_done(req)

    def _gauges(self, n_queued: int, slot_req: list) -> None:
        occ = sum(r is not None for r in slot_req)
        st = self.stats
        st["queue_depth"] = n_queued
        st["queue_depth_peak"] = max(st["queue_depth_peak"], n_queued)
        st["slot_occupancy"] = occ
        st["slot_occupancy_peak"] = max(st["slot_occupancy_peak"], occ)
        if self.alloc is not None:
            st["block_util"] = self.alloc.utilization
            st["block_util_peak"] = max(st["block_util_peak"],
                                        st["block_util"])

    # ---------------------------------------------------------------- run
    def run(self, prompts: list[list[int]], *, arrivals=None,
            priorities=None) -> list[RequestResult]:
        """Decode all prompts with continuous batching; one RequestResult
        per prompt (rejected ones flagged), in request order.

        ``arrivals``: optional per-request enqueue offsets (seconds from the
        run's start): a request becomes admissible once its arrival passes,
        and its queue time and TTFT count from it. ``priorities``: optional
        per-request priority (lower = more urgent; the slo scheduler).
        On a multi-rank mesh the arrival clock is rank 0's."""
        seed = self.scfg.seed + (self._runs << 32)  # a fresh stream per run
        self._runs += 1
        if self.scfg.engine == "reference":
            if arrivals is not None or priorities is not None:
                raise ValueError("arrivals/priorities need the pipelined "
                                 "engine")
            return self._run_reference(prompts, seed)
        return self._run_engine(prompts, seed, arrivals, priorities)

    # ------------------------------------------------------- pipelined engine
    def _run_engine(self, prompts, seed: int, arrivals=None,
                    priorities=None) -> list[RequestResult]:
        s = self.scfg
        dev = self.device
        nslots = s.batch_slots
        results: list[RequestResult] = []
        # decisions that read the clock (arrivals, the slo order and
        # window) take rank 0's reading on a multi-rank mesh
        clocked = self._ranks > 1 and (arrivals is not None
                                       or s.sched != "fifo")
        t_start = time.perf_counter()
        if clocked:
            t_start = self._agree(t_start)
        due, reqs = self._intake(prompts, results, t_start, arrivals,
                                 priorities)
        due = collections.deque(due)  # arrival-sorted (t_enq, rid)
        waiting: list[int] = []  # arrived, not yet admitted

        def zeros(dtype=torch.int64):
            return torch.zeros((nslots,), dtype=dtype, device=dev)

        state = {"ids": zeros(), "pos": zeros(),
                 "active": zeros(torch.bool), "budget": zeros(),
                 "rid": torch.full((nslots,), -1, dtype=torch.int64,
                                   device=dev)}
        if self.spec is not None:
            state["pages"] = torch.full((nslots, self.spec.n_pages),
                                        self.spec.sentinel,
                                        dtype=torch.int64, device=dev)
        cache = self.cache
        slot_req: list[int | None] = [None] * nslots
        free = list(range(nslots))
        # FIFO of results not yet read back; one entry stays in flight so
        # host bookkeeping overlaps device work
        pending: collections.deque = collections.deque()

        def retire(req, slot) -> None:
            # the device froze the slot in the same window (done is computed
            # on the device), so any window in flight drops its KV writes
            # (write_mask): its blocks are free for the next admission
            self._finalize(req, results)
            slot_req[slot] = None
            free.append(slot)

        def process(entry) -> None:
            kind, arrs, info = entry[:3]
            t0 = time.perf_counter()
            arrs = [a.cpu().numpy() for a in arrs]
            self.stats[f"{kind}_s"] += time.perf_counter() - t0
            now = time.perf_counter()
            if kind == "prefill":
                nxt, ok = arrs
                for row, (rid, slot) in enumerate(info):
                    if self._emit(reqs[rid], int(nxt[row]), bool(ok[row]),
                                  now):
                        retire(reqs[rid], slot)
                return
            toks, oks, emitted, widths = arrs
            window, t_issue = entry[3:]
            # per-token wall EWMA: the slo scheduler's window-cost estimate
            # (it includes the pipeline's overlap: a steady, slightly
            # pessimistic signal)
            dt_ms = (now - t_issue) * 1e3 / window
            self._itl_ms = (dt_ms if self._itl_ms == 0.0
                            else 0.7 * self._itl_ms + 0.3 * dt_ms)
            self._bin_widths(widths, emitted)
            for t in range(toks.shape[0]):
                for slot in range(nslots):
                    rid = info[slot]
                    if not emitted[t, slot] or rid is None:
                        continue
                    if self._emit(reqs[rid], int(toks[t, slot]),
                                  bool(oks[t, slot]), now):
                        retire(reqs[rid], slot)

        while len(results) < len(prompts):
            now, itl_ms = time.perf_counter(), self._itl_ms
            if clocked:
                now, itl_ms = self._agree((now, itl_ms))
            # 0) open-loop arrivals become admissible as their time passes
            while due and due[0][0] <= now:
                waiting.append(due.popleft()[1])
            self._gauges(len(waiting) + len(due), slot_req)
            # 1) admission: free slots (and, paged, blocks) take waiting
            # requests in the scheduler's order; one batched prefill a round
            if waiting and free:
                free.sort()
                batch, rows = [], []
                for rid in self.sched.order(waiting, reqs, now):
                    if not free:
                        break
                    req = reqs[rid]
                    if self.alloc is not None:
                        if not self.alloc.can_alloc(req["pages_needed"]):
                            self.stats["block_stalls"] += 1
                            if self.sched.skip_blocked:
                                continue  # smaller requests may still fit
                            break  # fifo: strict head-of-line order
                        req["blocks"] = self.alloc.alloc(req["pages_needed"])
                        rows.append(paging.page_row(self.spec, req["blocks"]))
                    batch.append((rid, free.pop(0)))
                if batch:
                    t_admit = time.perf_counter()
                    lp = _bucket(max(len(reqs[r]["prompt"]) for r, _ in batch),
                                 s.prefill_chunk)
                    # always nslots rows: the prefill's shapes (and so its
                    # kernels and their per-row arithmetic) never depend on
                    # how many requests an admission round takes
                    tokens = np.zeros((nslots, lp), np.int64)
                    lengths = np.ones((nslots,), np.int64)
                    slots = np.full((nslots,), nslots, np.int64)  # pad rows
                    rids = np.full((nslots,), -1, np.int64)
                    for row, (rid, slot) in enumerate(batch):
                        waiting.remove(rid)
                        p = reqs[rid]["prompt"]
                        tokens[row, : len(p)] = p
                        lengths[row] = len(p)
                        slots[row] = slot
                        rids[row] = rid
                        slot_req[slot] = rid
                        reqs[rid]["t_admit"] = t_admit
                    pages = None
                    if self.spec is not None:
                        pg = np.full((nslots, self.spec.n_pages),
                                     self.spec.sentinel, np.int64)
                        pg[: len(rows)] = rows
                        pages = torch.from_numpy(pg).to(dev)
                    cache, state, nxt, ok = self.prefill_fn(
                        self.run_params, cache, state,
                        torch.from_numpy(tokens).to(dev),
                        torch.from_numpy(lengths).to(dev),
                        torch.from_numpy(slots).to(dev),
                        torch.from_numpy(rids).to(dev), seed, self.index,
                        pages)
                    pending.append(("prefill", (nxt, ok), batch))
                    self.stats["prefill_dispatches"] += 1
                    self.stats["steps"] += 1
                    self.stats["prefill_tokens"] += int(
                        lengths[:len(batch)].sum())
                    # occupancy / block gauges peak right after admission
                    self._gauges(len(waiting) + len(due), slot_req)
            # 2) one decode window over the slots the host believes live,
            # its length picked by the scheduler (slo: shrinks under TTFT
            # pressure)
            live = any(r is not None for r in slot_req)
            if live:
                window = self.sched.pick_window(waiting, reqs, now, itl_ms,
                                                self._windows)
                t_issue = time.perf_counter()
                cache, state, toks, oks, emitted, widths = self._decode_fn(
                    window)(self.run_params, cache, state, seed, self.index,
                            self.router)
                pending.append(("decode", (toks, oks, emitted, widths),
                                list(slot_req), window, t_issue))
                self.stats["decode_dispatches"] += 1
                self.stats["steps"] += 1
            # 3) read back all but the newest entry (double buffering)
            while len(pending) > 1 or (pending and not live):
                process(pending.popleft())
            if not live and not waiting and not pending and due:
                # idle until the next open-loop arrival
                time.sleep(max(0.0, min(due[0][0] - time.perf_counter(),
                                        0.05)))

        while pending:
            process(pending.popleft())
        self._gauges(0, slot_req)  # drained, slots retired
        self.cache = cache
        self.stats["wall_s"] = time.perf_counter() - t_start
        return sorted(results, key=lambda r: r.request_id)

    # -------------------------------------------------- reference single-step
    def _run_reference(self, prompts, seed: int) -> list[RequestResult]:
        """Teacher-forced single-step loop: one step per token, prompts fed
        through the decode path. The engine's comparator (the same key
        derivation, so the same samples). An admitted slot's cache is
        zeroed, so recurrent state (SSM, RG-LRU, conv tails) never carries
        over from the slot's previous request."""
        s = self.scfg
        dev = self.device
        nslots = s.batch_slots
        results: list[RequestResult] = []
        t_start = time.perf_counter()
        due, reqs = self._intake(prompts, results, t_start)
        queue = collections.deque(rid for _, rid in due)
        active: list[int | None] = [None] * nslots
        ids_h = np.zeros((nslots,), np.int64)
        pos_h = np.zeros((nslots,), np.int64)
        rids_h = np.full((nslots,), -1, np.int64)
        cache = self.cache

        def admit(slot) -> None:
            if not queue:
                return
            rid = queue.popleft()
            reqs[rid]["t_admit"] = time.perf_counter()
            active[slot] = rid
            rids_h[slot] = rid
            pos_h[slot] = 0
            ids_h[slot] = 0
            for group in cache:  # leaves (layers, B, ...): batch is axis 1
                for layer in group.values():
                    for t in layer.values():
                        t[:, slot] = 0

        for i in range(nslots):
            admit(i)
        while any(a is not None for a in active):
            for i, rid in enumerate(active):
                if rid is None:
                    continue
                req = reqs[rid]
                ids_h[i] = (req["prompt"][req["fed"]]
                            if req["fed"] < len(req["prompt"])
                            else req["out"][-1])
            nxt, ok, cache, pos, width = self.ref_step_fn(
                self.run_params, cache, torch.from_numpy(ids_h).to(dev),
                torch.from_numpy(pos_h).to(dev),
                torch.from_numpy(rids_h).to(dev), seed, self.index,
                self.router)
            nxt_h, ok_h = nxt.cpu().numpy(), ok.cpu().numpy()
            pos_h = pos.cpu().numpy().copy()  # the device's value
            self._bin_widths(width.cpu().numpy(),
                             np.asarray([a is not None for a in active]))
            self.stats["steps"] += 1
            now = time.perf_counter()
            for i, rid in enumerate(active):
                if rid is None:
                    pos_h[i] -= 1  # idle slot: frozen (as the engine's)
                    continue
                req = reqs[rid]
                if req["fed"] < len(req["prompt"]):
                    req["fed"] += 1
                    if req["fed"] < len(req["prompt"]):
                        continue  # mid-prompt: the sample is discarded
                    # the last prompt token's sample is the first output
                if self._emit(req, int(nxt_h[i]), bool(ok_h[i]), now):
                    self._finalize(req, results)
                    active[i] = None
                    rids_h[i] = -1
                    admit(i)
        self.cache = cache
        self.stats["wall_s"] = time.perf_counter() - t_start
        return sorted(results, key=lambda r: r.request_id)
