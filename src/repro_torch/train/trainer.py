"""Training loop (counterpart of ``repro/train/trainer.py``): fused
multi-step windows, deterministic resume, preemption handling, a straggler
watchdog, staleness-aware head-index refresh and async checkpoints, on one
device.

The step function is :func:`repro_torch.launch.steps.make_train_loop_step`:
windows of up to ``fuse_steps`` optimizer steps run back to back on the
device-resident ``{params, opt}`` state (updated in place). The host reads
metrics only at *flush points* — every ``log_every`` steps, checkpoint and
index-refresh boundaries, preemption and run end. Window boundaries are
clamped so checkpoints and periodic refreshes land exactly on their steps;
each step's randomness is keyed by its GLOBAL step index, so the run is
invariant to how it is chunked into windows.

Index refresh during learning (DESIGN.md §7): the output embedding — the
head index's database — drifts every optimizer step. The trainer snapshots
the embedding rows at every (re)build, tracks the relative L2 drift against
that snapshot, and refreshes the index (``refresh``, warm-started Lloyd on
the device) every ``index_refresh_every`` steps and/or when the drift
exceeds ``index_drift_threshold``. The index is built over the snapshot,
not the live rows, which the optimizer updates in place: an IVF-PQ index
keeps its rows for the exact re-rank. The refresh is synchronous: it runs
at a window boundary, and the index is frozen within a window.

Fault tolerance: every state element (params, optimizer, data cursor;
randomness is a function of (seed, step)) lives in the checkpoint, so a
restart trains exactly as the uninterrupted run would. The head index is a
function of the embedding rows it was last built over and of its
quantizers, so the checkpoint carries them (``index``: the drift snapshot,
the centroids and, for IVF-PQ, the codebooks; LSH needs the snapshot
alone, its projections being the config's) and a restore re-packs the
rows around them: the resumed run probes the very index the uninterrupted
one did. (The reference rebuilds the index cold on restore instead, so
there a resume counts as a refresh.) SIGTERM
or a ``PREEMPT`` file in the workdir saves and exits cleanly. Per-step wall
time at flush granularity feeds an EMA; windows slower than
``straggler_factor`` times it are counted and logged.

Not in the port yet: the async double-buffered refresh, DP×TP meshes,
sharded checkpoints and the adaptive-probe router.

Diagnostics go through the ``repro_torch.train`` logger as ``[trainer] ...``
lines, the reference's text.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import signal
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import mips
from repro_torch.data.synthetic import DataConfig, SyntheticStream
from repro_torch.launch import steps as steps_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import Model
from repro_torch.optim import adamw

__all__ = ["RunConfig", "Trainer"]

_LOG = logging.getLogger("repro_torch.train")


class _TrainerFormatter(logging.Formatter):
    """``[trainer] <msg>`` at INFO, ``[trainer] WARNING: <msg>`` above."""

    def format(self, record: logging.LogRecord) -> str:
        lvl = (f"{record.levelname}: "
               if record.levelno >= logging.WARNING else "")
        return f"[trainer] {lvl}{record.getMessage()}"


def _log(msg: str, level: int = logging.INFO) -> None:
    if _LOG.level == logging.NOTSET:
        _LOG.setLevel(logging.INFO)
    if not _LOG.handlers and not logging.getLogger().handlers:
        h = logging.StreamHandler()
        h.setFormatter(_TrainerFormatter())
        _LOG.addHandler(h)
    _LOG.log(level, msg)


@dataclasses.dataclass
class RunConfig:
    num_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    keep_ckpts: int = 3
    seed: int = 0  # weights, data stream and head draws
    batch: int = 8
    seq: int = 256
    fuse_steps: int = 1  # T: optimizer steps per window between host syncs
    straggler_factor: float = 3.0
    index_refresh_every: int = 0  # R > 0: refresh the head index every R steps
    index_drift_threshold: float = 0.0  # > 0: refresh when rel. L2 drift exceeds
    train: steps_lib.TrainConfig = dataclasses.field(
        default_factory=steps_lib.TrainConfig)


class Trainer:
    """Drives training of ``cfg`` in ``workdir`` on ``device`` (CUDA unless
    the caller names another; raises without CUDA and without a device)."""

    def __init__(self, cfg: ArchConfig, run: RunConfig, workdir: str,
                 device=None):
        self.cfg = cfg
        self.run = run
        self.workdir = workdir
        self.model = Model(cfg, precision_policy=run.train.precision,
                           device=device)
        self.device = self.model.device
        self.data = SyntheticStream(
            cfg, DataConfig(batch=run.batch, seq=run.seq, seed=run.seed))
        self.ckpt = CheckpointManager(workdir, keep=run.keep_ckpts)
        self.step_fn = steps_lib.make_train_loop_step(self.model, run.train)
        self._preempted = False
        self.straggler_count = 0
        self.metrics_log: list[dict] = []
        self.head_index = None  # the head's MIPS index (None: exact path)
        self.index_refreshes = 0
        self._index_snapshot = None  # embedding rows at the last (re)build
        # un-synced windows: (first step, n steps, stacked metrics)
        self._pending: list[tuple[int, int, dict]] = []
        self._flush_t0 = 0.0
        self._ema = None  # per-step wall EMA (flush granularity)

    # ------------------------------------------------------------- state
    def init_state(self) -> dict:
        params = self.model.init(self.run.seed)
        return {"params": params, "opt": adamw.init(params),
                "meta": {"step": 0, "data": self.data.state()}}

    def maybe_restore(self) -> dict:
        """The latest complete checkpoint in the workdir, else a fresh
        state."""
        if self.ckpt.latest_step() is None:
            return self.init_state()
        state, meta, _ = self.ckpt.restore(device=self.device)
        if self.model.head_uses_index and "index" not in state:
            raise ValueError("checkpoint has no head-index state")
        self.data.restore(meta["data"])
        state["meta"] = meta
        _log(f"resumed from step {meta['step']}")
        return state

    # --------------------------------------------------------- preemption
    def _install_signals(self) -> None:
        def handler(signum, frame):
            self._preempted = True

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not on the main thread (tests)

    def _preempt_requested(self) -> bool:
        return self._preempted or os.path.exists(
            os.path.join(self.workdir, "PREEMPT"))

    # ------------------------------------------------------- index refresh
    def _head_emb(self, params) -> torch.Tensor:
        return self.model.head_index_db(params)

    def _init_head_index(self, params, saved: dict | None = None) -> None:
        """Build the head index over a copy of the live rows, or — on resume
        — re-pack the saved snapshot around the saved centroids (and
        codebooks) without a Lloyd step. An LSH index is rebuilt from the
        snapshot alone: its projections come from the config's seed, so the
        same rows hash into the same tables."""
        if not self.model.head_uses_index:
            self.head_index = None  # exact path: no index, no snapshot
            return
        if saved is None:
            snap = self._head_emb(params).clone()
            self.head_index = self.model.make_head_index(params, db=snap)
        else:
            snap = saved["db"]
            kw = ({"init_cent": saved["centroids"], "iters": 0}
                  if "centroids" in saved else {})
            if "codebooks" in saved:
                kw.update(init_codebooks=saved["codebooks"], pq_iters=0)
            self.head_index = self.model.make_head_index(params, db=snap,
                                                         **kw)
        # one copy doing double duty: the drift snapshot, and the rows the
        # index is built over — the optimizer updates the live rows in
        # place, and an IVF-PQ index re-ranks against the rows it was given
        self._index_snapshot = snap

    def _drift(self, params) -> float:
        emb = self._head_emb(params)
        snap = self._index_snapshot
        return float(torch.linalg.norm(emb - snap)
                     / (torch.linalg.norm(snap) + 1e-30))

    def _maybe_refresh_index(self, params, done: int) -> float:
        """Refresh the head index on schedule or on embedding drift, in
        place at this boundary. Returns the measured relative drift (0.0
        when not measured)."""
        run = self.run
        drift = (self._drift(params) if run.index_drift_threshold > 0
                 else 0.0)
        due = (run.index_refresh_every > 0
               and done % run.index_refresh_every == 0)
        tripped = (run.index_drift_threshold > 0
                   and drift > run.index_drift_threshold)
        if not (due or tripped):
            return drift
        snap = self._head_emb(params).clone()
        self.head_index = self.head_index.refresh(snap)
        self._index_snapshot = snap
        self.index_refreshes += 1
        dropped, short = mips.index_spill_parts(self.head_index)
        if dropped:
            _log(f"index refresh at step {done} dropped {dropped} rows "
                 f"(overflow buffer or LSH buckets full) — raise "
                 f"overflow_frac (IVF) or bucket_cap (LSH)", logging.WARNING)
        if short:
            _log(f"re-rank pool short {short} slots — lower PQConfig.rerank "
                 f"or raise n_probe", logging.WARNING)
        if tripped:
            _log(f"index refresh at step {done}: drift {drift:.4f} > "
                 f"{run.index_drift_threshold}")
        return drift

    # --------------------------------------------------------- fused loop
    def _next_boundary(self, step: int) -> int:
        """First step > ``step`` a window must not cross: run end,
        checkpoint steps and periodic index-refresh steps."""
        run = self.run
        nxt = run.num_steps
        schedules = [run.ckpt_every]
        if self.head_index is not None and run.index_refresh_every > 0:
            schedules.append(run.index_refresh_every)
        for every in schedules:
            if every and every > 0:
                nxt = min(nxt, (step // every + 1) * every)
        return max(nxt, step + 1)

    def _stack_batches(self, t: int) -> dict:
        bs = [next(self.data) for _ in range(t)]
        return {k: torch.from_numpy(np.stack([b[k] for b in bs])).to(
            self.device) for k in bs[0]}

    def _flush(self, log: bool = True) -> dict:
        """Read every pending window's metrics on the host (one wait for
        the device), run the straggler watchdog, emit log lines."""
        if not self._pending:
            return dict(self.metrics_log[-1]) if self.metrics_log else {}
        host = [(s0, t, {k: v.float().cpu().numpy() for k, v in m.items()})
                for s0, t, m in self._pending]  # waits for the device
        now = time.perf_counter()
        n = sum(t for _, t, _ in self._pending)
        dt = (now - self._flush_t0) / max(n, 1)  # per-step wall this window
        self._flush_t0 = now
        if self._ema is None:
            self._ema = dt
        else:
            if dt > self.run.straggler_factor * self._ema:
                self.straggler_count += 1
                s0, t, _ = self._pending[-1]
                _log(f"straggler window ending at step {s0 + t - 1}: "
                     f"{dt:.3f}s/step vs ema {self._ema:.3f}s/step")
            self._ema = 0.9 * self._ema + 0.1 * dt
        note = ""
        if self.head_index is not None:
            note = (f" index={self.head_index.memory_bytes() / 1e6:.1f}MB "
                    f"spill={mips.index_spill(self.head_index)}")
        for s0, t, metrics in host:
            for i in range(t):
                entry = {k: float(v[i]) for k, v in metrics.items()}
                entry["step"] = s0 + i
                entry["dt"] = dt
                self.metrics_log.append(entry)
                if (log and self.run.log_every > 0
                        and (s0 + i) % self.run.log_every == 0):
                    _log(f"step {s0 + i} loss={entry['loss']:.4f} "
                         f"({dt * 1e3:.0f}ms/step){note}")
        self._pending = []
        return dict(self.metrics_log[-1])

    def _save(self, done: int, dev: dict) -> None:
        state = {"params": dev["params"], "opt": dev["opt"],
                 "meta": {"step": done, "data": self.data.state()}}
        if self.head_index is not None:
            st = self.head_index.state
            state["index"] = {"db": self._index_snapshot}
            if hasattr(st, "centroids"):  # IVF, IVF-PQ (LSH: the rows alone)
                state["index"]["centroids"] = st.centroids
            if hasattr(st, "codebooks"):  # IVF-PQ
                state["index"]["codebooks"] = st.codebooks
        self.ckpt.save_async(done, state)

    # --------------------------------------------------------------- run
    def train(self) -> dict:
        self._install_signals()
        run = self.run
        state = self.maybe_restore()
        adamw.check_master_params(state["params"])
        self._init_head_index(state["params"], state.get("index"))
        dev = {"params": state["params"], "opt": state["opt"]}
        step = int(state["meta"]["step"])
        del state
        last: dict = {}
        self._flush_t0 = time.perf_counter()
        while step < run.num_steps:
            t = min(max(run.fuse_steps, 1), self._next_boundary(step) - step)
            batches = self._stack_batches(t)
            dev, metrics = self.step_fn(dev, batches, range(step, step + t),
                                        run.seed, self.head_index)
            self._pending.append((step, t, metrics))
            step += t
            done = step
            log_due = run.log_every > 0 and any(
                s % run.log_every == 0
                for s0, n, _ in self._pending for s in range(s0, s0 + n))
            refresh_due = self.head_index is not None and (
                (run.index_refresh_every > 0
                 and done % run.index_refresh_every == 0)
                or run.index_drift_threshold > 0)
            ckpt_due = (run.ckpt_every > 0 and done % run.ckpt_every == 0
                        ) or done == run.num_steps
            preempt = self._preempt_requested()
            if not (log_due or refresh_due or ckpt_due or preempt):
                continue
            last = self._flush()
            if refresh_due:
                drift = self._maybe_refresh_index(dev["params"], done)
                self.metrics_log[-1]["index_drift"] = drift
                self.metrics_log[-1]["index_refreshes"] = self.index_refreshes
                last = dict(self.metrics_log[-1])
            if ckpt_due:
                self._save(done, dev)
            if preempt:
                _log(f"preemption at step {done}; checkpointing")
                if not ckpt_due:
                    self._save(done, dev)
                self.ckpt.wait()
                return {**last, "status": "preempted", "step": done}
            # boundary work above is not step time: restart the clock
            self._flush_t0 = time.perf_counter()
        last = self._flush()
        self.ckpt.wait()
        return {**last, "status": "done", "step": run.num_steps}
