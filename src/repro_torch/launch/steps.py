"""Step functions (counterpart of ``repro/launch/steps.py``): the train
step with fp32 gradient accumulation, the fused multi-step train loop,
per-slot sample keys, the slot-state transition, the decode window and
batched prefill admission (dense or paged KV layout, optionally strict),
the single-step serving steps the reference engine runs, and the encoder's
step.

Where the reference scans a decode window or a train window inside one
jitted dispatch, the port loops over it in Python; state stays on the
device and the host reads it only where it needs a value.

On a mesh (the model's ``mesh``), each rank steps on its data slice: the
head's draws are keyed by the GLOBAL token index, the gradients are summed
over the ``data`` axis and divided by ``dp`` (the mean over the global
batch that GSPMD computes), the metrics are averaged the same way, and the
clipping norm is the whole model's (:func:`mesh_norm`); the decode and
prefill steps run the distributed head through the model.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import collectives as coll
from repro_torch.models.model import Model
from repro_torch.optim import adamw

__all__ = ["TrainConfig", "token_keys", "make_train_step", "data_mean",
           "mesh_norm",
           "make_train_loop_step", "slot_keys", "make_serve_step",
           "make_decode_loop_step", "make_prefill_into_cache_step",
           "make_reference_serve_step", "make_prefill_step",
           "make_encode_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: adamw.OptConfig = dataclasses.field(default_factory=adamw.OptConfig)
    accum: int = 1  # microbatch gradient-accumulation factor
    precision: str = "bf16"  # model precision policy (repro_torch/precision.py):
    #   "bf16" (default) or "f32" (the numerics reference). Master params,
    #   gradient accumulators and estimator partials are fp32 either way.
    compress_grads: bool = False  # declared as in the reference, which
    #   reads it nowhere; repro_torch.optim.compress holds the int8 ring


def _split_batch(batch: dict, accum: int) -> dict:
    """(GB, ...) -> (accum, GB/accum, ...) per leaf."""
    return {k: x.reshape((accum, x.shape[0] // accum) + x.shape[1:])
            for k, x in batch.items()}


def token_keys(seed: int, step: int, start: int, count: int,
               device=None) -> torch.Tensor:
    """(count, 3) int64 generator keys (seed, step, token) for the label
    positions ``start .. start+count`` of a step's global batch (row-major
    over (batch, position)). Keying a token's head draws by its global
    step and position makes them independent of how the run is chunked
    into windows, of the microbatch split and of the head's token chunk:
    what keeps a fused T-window bitwise T single steps and ``accum`` equal
    to a host loop of microbatches."""
    tok = torch.arange(start, start + count, device=device)
    return torch.stack([torch.full_like(tok, seed), torch.full_like(tok, step),
                        tok], dim=-1)


def make_train_step(model: Model, tcfg: TrainConfig):
    """Returns ``train_step(params, opt_state, batch, key, index=None, *,
    draws=None) -> (params, opt_state, metrics)``.

    ``key`` is the (seed, global step) pair the step's randomness derives
    from (:func:`token_keys`); ``draws`` ((GB·L, l), row-major over the
    global batch) injects the head's tail draws instead. ``index`` is the
    head's MIPS index; gradients do not flow into it (the head uses it for
    the top-k probe only). ``params`` and the moments are updated in place.

    Gradient accumulation (``tcfg.accum > 1``) runs ``accum`` microbatches
    and sums their gradients in fp32 (``Policy.grad_accum_dtype``) whatever
    the compute policy, then applies the optimizer ONCE on the mean.

    On a mesh, ``batch`` is this data rank's slice and ``draws`` its rows;
    the gradients are averaged over the data axis before the update
    (:func:`data_mean`)."""
    mesh = model.mesh

    def grads_of(params, mb, keys, draws, index):
        diff = adamw.tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
        loss, metrics = model.loss_fn(diff, mb, index, keys=keys,
                                      draws=draws)
        grads = torch.autograd.grad(loss, adamw.tree_leaves(diff))
        it = iter(grads)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                adamw.tree_map(lambda _: next(it), diff))

    def train_step(params, opt_state, batch, key, index=None, *, draws=None):
        seed, step = key
        n_tok = batch["labels"].numel()
        dev = batch["labels"].device
        # this rank's first token in the global batch (row-major)
        tok0 = 0 if mesh is None else mesh.data.index * n_tok
        if tcfg.accum == 1:
            keys = token_keys(seed, step, tok0, n_tok, dev)
            loss, metrics, grads = grads_of(params, batch, keys, draws, index)
        else:
            mbs = _split_batch(batch, tcfg.accum)
            mb_tok = n_tok // tcfg.accum
            grads = adamw.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            ms = []
            for i in range(tcfg.accum):
                mb = {k: v[i] for k, v in mbs.items()}
                keys = token_keys(seed, step, tok0 + i * mb_tok, mb_tok, dev)
                d_i = (None if draws is None
                       else draws[i * mb_tok:(i + 1) * mb_tok])
                l_i, m_i, g_i = grads_of(params, mb, keys, d_i, index)
                # fp32 accumulators: bf16 sums would be order-dependent at
                # the magnitudes the optimizer cares about
                for a, b in zip(adamw.tree_leaves(grads),
                                adamw.tree_leaves(g_i)):
                    a.add_(b.float())
                loss = loss + l_i.float()
                ms.append(m_i)
            grads = adamw.tree_map(lambda g: g / tcfg.accum, grads)
            loss = loss / tcfg.accum
            # per-microbatch aux metrics (nll / aux / log_z): their mean
            metrics = {k: torch.stack([m[k] for m in ms]).float().mean(0)
                       for k in ms[0]}
        gnorm = None
        if mesh is not None:
            if mesh.dp > 1:
                grads = data_mean(grads, mesh)
                vals = data_mean([loss] + [metrics[k] for k in metrics],
                                 mesh)
                loss = vals[0]
                metrics = dict(zip(metrics, vals[1:]))
            gnorm = mesh_norm(grads, mesh, model.cfg)
        params, opt_state, opt_metrics = adamw.update(grads, opt_state,
                                                      params, tcfg.opt,
                                                      gnorm=gnorm)
        return params, opt_state, dict(metrics, **opt_metrics, loss=loss)

    return train_step


def data_mean(tree, mesh):
    """The mean over the mesh's data axis of every tensor of ``tree`` (a
    params-like dict or a list), in ONE all-reduce of their flattened
    fp32 concatenation; same structure back."""
    flat = adamw.tree_leaves(tree) if isinstance(tree, dict) else list(tree)
    buf = torch.cat([t.detach().float().reshape(-1) for t in flat])
    buf = coll.psum(buf, mesh.data) / mesh.dp
    out, o = [], 0
    for t in flat:
        out.append(buf[o:o + t.numel()].view(t.shape).to(t.dtype))
        o += t.numel()
    if isinstance(tree, dict):
        it = iter(out)
        return adamw.tree_map(lambda _: next(it), tree)
    return out


def _sorted_leaves(tree, path=()):
    """(path, leaf) in :func:`repro_torch.optim.adamw.tree_leaves`' order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _sorted_leaves(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def mesh_norm(grads: dict, mesh, cfg) -> torch.Tensor:
    """The global gradient norm over the whole (sharded) model: the squares
    of the replicated leaves once, plus those of the model-sharded leaves
    summed over the model axis — the same on every rank, so every replica
    clips alike."""
    from repro_torch.launch import mesh as mesh_lib

    dev = next(iter(adamw.tree_leaves(grads))).device
    rep = torch.zeros((), dtype=torch.float32, device=dev)
    shard = torch.zeros((), dtype=torch.float32, device=dev)
    for path, g in _sorted_leaves(grads):
        sq = torch.sum(torch.square(g.float()))
        spec = mesh_lib.param_spec(list(path), tuple(g.shape), mesh, cfg)
        if mesh_lib.shard_dim(spec) is None:
            rep = rep + sq
        else:
            shard = shard + sq
    return torch.sqrt(rep + coll.psum(shard, mesh.model))


def make_train_loop_step(model: Model, tcfg: TrainConfig):
    """Fused multi-step training: ``loop_step(state, batches, steps, seed,
    index=None, *, draws=None) -> (state, metrics)``.

    Runs ``T = len(steps)`` full optimizer steps back to back on the
    device-resident ``{"params", "opt"}`` state (updated in place), step i
    on ``batches`` leaves ``[i]`` with randomness keyed by the GLOBAL step
    ``steps[i]`` — the same derivation a single step uses, so a T-window is
    bitwise T single steps, whatever the trainer's chunking. ``index`` is
    held fixed across the window (refreshes land on window boundaries).
    Per-step metrics come back stacked to (T,) device tensors; the host
    reads them when it flushes."""
    step_fn = make_train_step(model, tcfg)

    def loop_step(state, batches, steps, seed: int, index=None, *,
                  draws=None):
        ms = []
        for i, step in enumerate(steps):
            mb = {k: v[i] for k, v in batches.items()}
            params, opt, metrics = step_fn(
                state["params"], state["opt"], mb, (seed, int(step)), index,
                draws=None if draws is None else draws[i])
            state = {"params": params, "opt": opt}
            ms.append(metrics)
        return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return loop_step


def make_serve_step(model: Model):
    """``serve_step(params, cache, ids, pos, keys, index=None) -> (next_ids,
    ok, cache, pos + 1)``: one decode step with explicit per-slot keys."""

    def serve_step(params, cache, ids, pos, keys, index=None):
        nxt, ok, cache, _ = model.decode_step(params, cache, ids, pos, index,
                                              keys=keys)
        return nxt, ok, cache, pos + 1

    return serve_step


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
                          max_seq: int, strict: bool = False,
                          paged: bool = False):
    """``decode_loop(params, cache, state, seed, index=None, router=None) ->
    (cache, state, tokens (T,B), ok (T,B), emitted (T,B), widths (T,B))``:
    ``window`` decode steps with per-slot active masks and on-device EOS /
    length-budget checks.

    ``widths`` is each token's effective probe width under the head's
    adaptive probe (-1 on fixed-width paths); ``router`` goes to each step's
    head. ``strict`` re-samples certificate-failed live tokens exactly.
    ``paged`` reads the slot page tables from ``state["pages"]`` ((B,
    n_pages) physical-block ids, sentinel for unallocated) and passes each
    slot's ``active`` flag as the KV ``write_mask``: a retired slot's blocks
    may already belong to another request, so its writes go to the sink."""

    def decode_loop(params, cache, state, seed: int, index=None,
                    router=None):
        toks, oks, emitted, widths = [], [], [], []
        for _ in range(window):
            keys = slot_keys(seed, state["rid"], state["pos"])
            nxt, ok, cache, width = model.decode_step(
                params, cache, state["ids"], state["pos"], index, keys=keys,
                strict=strict, strict_live=state["active"], router=router,
                pages=state["pages"] if paged else None,
                write_mask=state["active"] if paged else None)
            state, em = _advance(state, nxt, eos_id, max_seq)
            toks.append(state["ids"])
            oks.append(ok)
            emitted.append(em)
            widths.append(width)
        return (cache, state, torch.stack(toks), torch.stack(oks),
                torch.stack(emitted), torch.stack(widths))

    return decode_loop


def make_prefill_into_cache_step(model: Model, max_seq: int, eos_id: int,
                                 max_new_tokens: int, strict: bool = False,
                                 paged: bool = False):
    """``prefill_admit(params, cache, state, tokens (Bn,Lp), lengths, slots,
    rids, seed, index=None, pages=None) -> (cache, state, first_ids, ok)``.

    Writes each admitted prompt's KV ring straight into its slot, samples
    the first output token and commits the slot records on the device.
    Rows with slot >= B are admission padding: their writes are dropped.
    ``paged``: ``pages`` ((Bn, n_pages) physical blocks per admitted row,
    sentinel-filled for pad rows) routes the rings into the shared pool and
    is committed into ``state["pages"]`` at each row's slot, where the
    decode loop walks it."""

    def prefill_admit(params, cache, state, tokens, lengths, slots, rids,
                      seed: int, index=None, pages=None):
        lengths = lengths.long()
        keys = slot_keys(seed, rids, lengths - 1)
        nxt, ok, cache = model.prefill_into_cache(
            params, cache, tokens, lengths, slots, keys, max_seq, index,
            strict=strict, strict_live=rids >= 0,  # pad rows sample garbage
            pages=pages if paged else None)
        budget = torch.full_like(lengths, max_new_tokens - 1)
        eos_hit = (nxt == eos_id) if eos_id >= 0 else torch.zeros_like(ok)
        alive = ~(eos_hit | (budget <= 0) | (lengths + 1 > max_seq - 1))
        b = state["ids"].shape[0]
        keep = torch.nonzero(slots < b)[:, 0]
        sel = slots[keep].long()
        new = {name: t.clone() for name, t in state.items()}
        vals = [("ids", nxt), ("pos", lengths), ("active", alive),
                ("budget", budget), ("rid", rids)]
        if paged:
            vals.append(("pages", pages))
        for name, val in vals:
            new[name][sel] = val[keep].to(new[name].dtype)
        return cache, new, nxt, ok

    return prefill_admit


def make_reference_serve_step(model: Model, strict: bool = False):
    """Single-token serve step with the engine's key derivation:
    ``serve_step(params, cache, ids, pos, rids, seed, index=None,
    router=None) -> (next_ids, ok, cache, pos + 1, width)``. The
    teacher-forced comparator the engine is held against (same samples,
    one step per token)."""

    def serve_step(params, cache, ids, pos, rids, seed: int, index=None,
                   router=None, pages=None, write_mask=None):
        keys = slot_keys(seed, rids, pos)
        nxt, ok, cache, width = model.decode_step(
            params, cache, ids, pos, index, keys=keys, strict=strict,
            router=router, pages=pages, write_mask=write_mask)
        return nxt, ok, cache, pos + 1, width

    return serve_step


def make_prefill_step(model: Model, max_seq: int):
    """``prefill_step(params, batch, keys, index=None) -> (next_ids, ok,
    pos, cache)``: :meth:`repro_torch.models.model.Model.prefill`."""

    def prefill_step(params, batch, keys, index=None):
        return model.prefill(params, batch, keys, max_seq, index)

    return prefill_step


def make_encode_step(model: Model):
    """Encoder-only archs: ``encode_step(params, batch) -> logits (B, L,
    vocab)`` (:meth:`repro_torch.models.model.Model.encode`)."""

    def encode_step(params, batch):
        return model.encode(params, batch)

    return encode_step
