"""Training loop (counterpart of ``repro/train/trainer.py``): fused
multi-step windows, deterministic resume, preemption handling, a straggler
watchdog, staleness-aware head-index refresh (synchronous, or async
double-buffered), async checkpoints (sharded on a mesh) and the adaptive
probe's telemetry and router fit, on one device or a DP×TP mesh.

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
keeps its rows for the exact re-rank. The synchronous refresh runs at a
window boundary, and the index is frozen within a window. With
``async_refresh`` the rebuild runs on a side thread and stream
(:class:`repro_torch.train.refresh.AsyncIndexRefresher`) while the loop
steps against the stale index, and swaps in at the first window boundary
after the kick (the reference's schedule: one rebuild in flight, no kick at
the run's last boundary, a preemption abandons it).

On a mesh (``Trainer(mesh=)``, :mod:`repro_torch.launch.mesh`) every rank
runs this loop in lockstep over its data slice of the same global stream;
the head index is a :class:`repro_torch.core.mips.ShardedIndex`, the drift
is the global one (a sum over the model axis), the preemption flag is
agreed by all ranks before anyone acts on it, checkpoints are sharded
(:func:`repro_torch.checkpoint.manager.save_sharded`) and only rank 0
logs.

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

Diagnostics go through the ``repro_torch.train`` logger as ``[trainer] ...``
lines, the reference's text.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import signal
import time
import weakref

import numpy as np
import torch

from repro_torch import collectives as coll
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import mips
from repro_torch.data.synthetic import DataConfig, SyntheticStream
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.train.refresh import AsyncIndexRefresher

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
    async_refresh: bool = False  # double-buffered refresh: rebuild on a side
    #   thread while stepping against the stale index; swap at the next
    #   window boundary
    sharded_ckpt: bool | None = None  # sharded checkpoint layout (None:
    #   sharded iff the mesh has more than one rank)
    fit_probe_router: bool = False  # adaptive probe: fit the stage router on
    #   the probe traces at every index refresh, saved to workdir/router.npz
    train: steps_lib.TrainConfig = dataclasses.field(
        default_factory=steps_lib.TrainConfig)


class Trainer:
    """Drives training of ``cfg`` in ``workdir`` on ``device`` (CUDA unless
    the caller names another; raises without CUDA and without a device),
    on ``mesh`` if given (every rank constructs its own Trainer)."""

    def __init__(self, cfg: ArchConfig, run: RunConfig, workdir: str,
                 device=None, mesh=None):
        self.cfg = cfg
        self.run = run
        self.workdir = workdir
        self.mesh = mesh
        self.model = Model(cfg, precision_policy=run.train.precision,
                           device=device, mesh=mesh)
        self.device = self.model.device
        self.data = SyntheticStream(
            cfg, DataConfig(batch=run.batch, seq=run.seq, seed=run.seed))
        self.ckpt = CheckpointManager(workdir, keep=run.keep_ckpts,
                                      sharded=run.sharded_ckpt, mesh=mesh,
                                      layout=self._layout)
        self.step_fn = steps_lib.make_train_loop_step(self.model, run.train)
        self._preempted = False
        self.straggler_count = 0
        self.metrics_log: list[dict] = []
        self.head_index = None  # the head's MIPS index (None: exact path)
        self.state: dict | None = None  # {params, opt} after train()
        self.index_refreshes = 0
        self.index_swaps = 0  # async path: completed kick -> swap pairs
        # async refresh: {kick, swap, stale_steps, drift_served} per swap
        self.refresh_events: list[dict] = []
        self._refresher = AsyncIndexRefresher() if run.async_refresh else None
        # adaptive probe: {effective width: queries} of the refresh-boundary
        # probe traces (empty on fixed-width heads)
        self.probe_width_hist: dict[int, int] = {}
        self._index_snapshot = None  # embedding rows at the last (re)build
        # un-synced windows: (first step, n steps, stacked metrics)
        self._pending: list[tuple[int, int, dict]] = []
        self._flush_t0 = 0.0
        self._ema = None  # per-step wall EMA (flush granularity)

    # ------------------------------------------------------------- state
    def _say(self, msg: str, level: int = logging.INFO) -> None:
        """Log on rank 0 only (every rank runs the same loop)."""
        if self.mesh is None or self.mesh.rank == 0:
            _log(msg, level)

    def _layout(self, path: tuple, t: torch.Tensor) -> tuple:
        """Placement of a checkpoint leaf over the mesh (see
        :mod:`repro_torch.checkpoint.manager`): the params' and their Adam
        moments' by :func:`repro_torch.launch.mesh.param_spec`, the head
        index's rows by model shard and its quantizers per shard."""
        if self.mesh is None:
            return ("rep", None)
        if path[0] == "index":
            return ("dim", 0) if path[1] == "db" else ("stack", None)
        if path[0] == "params":
            keys = path[1:]
        elif path[0] == "opt" and path[1] in ("m", "v"):
            keys = path[2:]
        else:
            return ("rep", None)
        dim = mesh_lib.shard_dim(mesh_lib.param_spec(
            list(keys), tuple(t.shape), self.mesh, self.cfg))
        return ("rep", None) if dim is None else ("dim", dim)

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
        self._say(f"resumed from step {meta['step']}")
        return state

    # --------------------------------------------------------- preemption
    def _install_signals(self) -> None:
        # the handler outlives train(): hold the trainer weakly, or the
        # process keeps its whole training state alive
        ref = weakref.ref(self)

        def handler(signum, frame):
            tr = ref()
            if tr is not None:
                tr._preempted = True

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not on the main thread (tests)

    def _preempt_requested(self) -> bool:
        """The preemption flag; on a mesh, raised on every rank if any rank
        saw it (ranks must agree before one of them checkpoints and
        leaves)."""
        flag = self._preempted or os.path.exists(
            os.path.join(self.workdir, "PREEMPT"))
        if self.mesh is None or self.mesh.world.size == 1:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        return bool(coll.pmax(t, self.mesh.world)[0])

    # ------------------------------------------------------- index refresh
    def _head_emb(self, params) -> torch.Tensor:
        return self.model.head_index_db(params)

    def _init_head_index(self, params, saved: dict | None = None) -> None:
        """Build the head index over a copy of the live rows, or — on resume
        — re-pack the saved snapshot around the saved centroids (and
        codebooks) without a Lloyd step. An LSH index is rebuilt from the
        snapshot alone: its projections come from the config's seed, so the
        same rows hash into the same tables. A sharded checkpoint restored
        on another model width keeps the rows but not the per-shard
        centroids: the index is then built afresh over the saved rows."""
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
        """Relative L2 drift of the head rows since the last (re)build —
        over the whole table on a mesh (the same value on every rank)."""
        emb = self._head_emb(params)
        snap = self._index_snapshot
        sq = torch.stack([torch.sum((emb - snap).float() ** 2),
                          torch.sum(snap.float() ** 2)])
        if self.mesh is not None:
            sq = coll.psum(sq, self.mesh.model)
        return float(torch.sqrt(sq[0]) / (torch.sqrt(sq[1]) + 1e-30))

    def _report_index_health(self, done: int) -> None:
        """Coverage warnings after a (re)build (every rank takes part: a
        sharded index sums its shards' counts)."""
        dropped, short = mips.index_spill_parts(self.head_index)
        if dropped:
            self._say(f"index refresh at step {done} dropped {dropped} rows "
                      f"(overflow buffer or LSH buckets full) — raise "
                      f"overflow_frac (IVF) or bucket_cap (LSH)",
                      logging.WARNING)
        if short:
            hc = self.model.head_cfg
            knob = (f"at effective probe width <= {hc.n_probe_max} "
                    f"(adaptive; hist {self.probe_width_hist}) — lower "
                    f"PQConfig.rerank or raise n_probe_max"
                    if hc.adaptive_probe
                    else "— lower PQConfig.rerank or raise n_probe")
            self._say(f"re-rank pool short {short} slots {knob}",
                      logging.WARNING)

    def _maybe_refresh_index(self, params, done: int) -> float:
        """Refresh the head index on schedule or on embedding drift: in
        place at this boundary, or (async) kick the rebuild and keep
        stepping against the stale index until the next boundary's swap.
        One rebuild in flight: while busy, the drift trigger stays armed
        and is re-checked after the swap. Returns the measured relative
        drift (0.0 when not measured)."""
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
        if self._refresher is not None:
            if not self._refresher.in_flight and done < run.num_steps:
                self._refresher.kick(self.head_index, snap, snap, done)
                self._say(f"async index refresh kicked at step {done} "
                          f"(drift {drift:.4f}); serving the stale buffer "
                          f"until the next chunk boundary")
            return drift
        self.head_index = self.head_index.refresh(snap)
        self._index_snapshot = snap
        self.index_refreshes += 1
        self._report_index_health(done)
        if tripped:
            self._say(f"index refresh at step {done}: drift {drift:.4f} > "
                      f"{run.index_drift_threshold}")
        self._probe_trace(params, done)
        return drift

    def _swap_index(self, params, done: int) -> None:
        """The double-buffer swap at the first window boundary after the
        kick; the stale index served ``done - kick`` steps, and its drift
        against the current rows is reported."""
        new_index, snap, kicked = self._refresher.swap()
        drift_served = self._drift(params)
        self.head_index = new_index
        self._index_snapshot = snap
        self.index_refreshes += 1
        self.index_swaps += 1
        self.refresh_events.append({"kick": kicked, "swap": done,
                                    "stale_steps": done - kicked,
                                    "drift_served": drift_served})
        self._report_index_health(done)
        self._say(f"async index swap at step {done}: kicked at {kicked}, "
                  f"served {done - kicked} steps stale, "
                  f"drift_served={drift_served:.4f}")
        self._probe_trace(params, done)

    def _probe_trace(self, params, done: int) -> None:
        """Adaptive-probe telemetry and router fit at a refresh boundary:
        the staged probe over a deterministic sample of the embedding rows
        (scaled like low-temperature serving hiddens) feeds
        ``probe_width_hist``; with ``run.fit_probe_router`` the stage
        router is fitted on the trace and saved to ``workdir/router.npz``
        for the server. A sharded index keeps its per-shard widths on the
        device, as in the reference: no trace."""
        hc = self.model.head_cfg
        if (not hc.adaptive_probe or self.head_index is None
                or not hasattr(self.head_index, "topk_adaptive")
                or isinstance(self.head_index, mips.ShardedIndex)):
            return
        emb = self._head_emb(params)
        stride = max(1, emb.shape[0] // 256)
        qs = emb[::stride][:256].float()
        qs = qs / torch.clamp(torch.linalg.norm(qs, dim=1, keepdim=True),
                              min=1e-6) * 8.0
        atk = self.head_index.topk_adaptive(qs, hc.k, c=hc.c)
        w = atk.width.cpu().numpy()
        vals, counts = np.unique(w, return_counts=True)
        for v, n in zip(vals.tolist(), counts.tolist()):
            self.probe_width_hist[int(v)] = (
                self.probe_width_hist.get(int(v), 0) + int(n))
        self._say(f"adaptive probe at step {done}: avg effective n_probe "
                  f"{w.mean():.2f} (ceiling {hc.n_probe_max}), certified "
                  f"{float(atk.certified.float().mean()):.2f}, width hist "
                  f"{self.probe_width_hist}")
        if self.run.fit_probe_router:
            from repro_torch.models import router as router_lib

            r = router_lib.train_router(self.head_index, qs, hc.k, c=hc.c,
                                        seed=self.run.seed)
            path = os.path.join(self.workdir, "router.npz")
            router_lib.save_router(path, r)
            self._say(f"probe router fitted on {qs.shape[0]} traces -> "
                      f"{path}")

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
        """The next ``t`` global batches, stacked; on a mesh, this data
        rank's rows of them (every rank reads the same stream)."""
        bs = [next(self.data) for _ in range(t)]
        batches = {k: torch.from_numpy(np.stack([b[k] for b in bs]))
                   for k in bs[0]}
        if self.mesh is not None:
            batches = mesh_lib.stacked_data_shardings(batches, self.mesh)
        return {k: v.to(self.device) for k, v in batches.items()}

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
                self._say(f"straggler window ending at step {s0 + t - 1}: "
                          f"{dt:.3f}s/step vs ema {self._ema:.3f}s/step")
            self._ema = 0.9 * self._ema + 0.1 * dt
        will_log = log and self.run.log_every > 0 and any(
            (s0 + i) % self.run.log_every == 0
            for s0, t, _ in self._pending for i in range(t))
        note = ""
        if will_log and self.head_index is not None:
            note = (f" index={self.head_index.memory_bytes() / 1e6:.1f}MB "
                    f"spill={mips.index_spill(self.head_index)}")
            if self.refresh_events:  # async refresh: staleness accounting
                ev = self.refresh_events[-1]
                note += (f" stale_steps={ev['stale_steps']} "
                         f"drift_served={ev['drift_served']:.4f}")
        for s0, t, metrics in host:
            for i in range(t):
                entry = {k: float(v[i]) for k, v in metrics.items()}
                entry["step"] = s0 + i
                entry["dt"] = dt
                self.metrics_log.append(entry)
                if (log and self.run.log_every > 0
                        and (s0 + i) % self.run.log_every == 0):
                    self._say(f"step {s0 + i} loss={entry['loss']:.4f} "
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
            swap_due = self._refresher is not None and self._refresher.in_flight
            flush_due = log_due or refresh_due or ckpt_due or preempt
            if not (flush_due or swap_due):
                continue
            swapped = False
            if swap_due and preempt:
                # mid-rebuild preemption: drop the in-flight index; the
                # resume rebuilds it from the checkpoint
                self._refresher.abandon()
            elif swap_due:
                t0 = time.perf_counter()
                self._swap_index(dev["params"], done)
                self._flush_t0 += time.perf_counter() - t0  # boundary cost
                swapped = True
            if not flush_due:
                continue
            last = self._flush()
            if swapped:
                ev = self.refresh_events[-1]
                self.metrics_log[-1]["index_stale_steps"] = ev["stale_steps"]
                self.metrics_log[-1]["index_drift_served"] = ev["drift_served"]
                last = dict(self.metrics_log[-1])
            if refresh_due:
                drift = self._maybe_refresh_index(dev["params"], done)
                self.metrics_log[-1]["index_drift"] = drift
                self.metrics_log[-1]["index_refreshes"] = self.index_refreshes
                last = dict(self.metrics_log[-1])
            if ckpt_due:
                self._save(done, dev)
            if preempt:
                self._say(f"preemption at step {done}; checkpointing")
                if not ckpt_due:
                    self._save(done, dev)
                self.ckpt.wait()
                self.state = dev
                return {**last, "status": "preempted", "step": done}
            # boundary work above is not step time: restart the clock
            self._flush_t0 = time.perf_counter()
        last = self._flush()
        if self._refresher is not None:
            self._refresher.abandon()  # drained at run end
        self.ckpt.wait()
        self.state = dev
        return {**last, "status": "done", "step": run.num_steps}
