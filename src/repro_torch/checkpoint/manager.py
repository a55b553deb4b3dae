"""Fault-tolerant checkpointing, single process (counterpart of
``repro/checkpoint/manager.py``): atomic, async, keep-N.

Layout: ``<dir>/ckpt_<step>/{state.pt, manifest.json}``. A save writes into
a ``.tmp`` directory — the tensors with ``torch.save`` first, the manifest
LAST — and publishes it with an atomic ``os.replace``, so a crash mid-save
never corrupts the latest checkpoint. A checkpoint counts only if its
manifest parses, says ``complete`` and names the byte size its tensor file
has: a missing, unfinished or corrupt manifest, or a truncated tensor
file, is skipped. Restore reads with ``torch.load(weights_only=True)``, so
loading runs no pickled code, and every leaf comes back bit-identical in
its dtype (bf16 included).

``state`` is nested dicts / lists of tensors plus a ``meta`` entry of plain
JSON values (step, data cursor).

**Sharded layout** (:func:`save_sharded`, ``CheckpointManager(sharded=True)``,
the default on a mesh of more than one rank): every rank calls the save with
its own state, and each writes only the pieces it owns — the replicated
leaves from rank 0, the model-sharded leaves (the output embedding's rows,
the MoE experts, their Adam moments) and the per-shard head-index state
from the ranks of data row 0 — into ``shards_p<rank>.pt`` plus a
``shard_manifest_p<rank>.json``, in a ``.tmp.<tag>`` directory whose tag
this save alone uses: rank 0 removes what earlier, crashed attempts left and
draws the tag, which a broadcast hands every rank before any writes (see
:func:`_attempt_tag`), so a stale manifest or piece file is never merged.
Rank 0 waits for every writer's manifest, merges them into
``manifest.json`` (``"sharded": true``) and publishes the directory
atomically. Each leaf records its layout: ``rep`` (replicated),
``dim`` (this rank's block along one dim of the global array) or ``stack``
(one entry per model shard, e.g. a shard's IVF centroids). Restore is
mesh-elastic: a rank assembles its block of each ``dim`` leaf for its own
mesh (pieces that match exactly are read directly, memory-mapped), so a
restore on another ``dp`` — or ``tp`` — gives the same tensors; ``stack``
leaves need the same number of model shards and are dropped otherwise.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import uuid
from typing import Any, Callable

import torch

__all__ = ["save", "save_sharded", "latest_step", "restore",
           "CheckpointManager"]

_SEP = "||"
_SHARD_WAIT_S = 600.0  # rank 0's wait for the other writers' manifests

_TENSORS = "state.pt"
_MANIFEST = "manifest.json"
_TMP_RE = r"\.tmp(\..*)?"  # a save's unpublished directory: .tmp[.<tag>]


def _to_host(tree: Any) -> Any:
    """A host copy of every tensor of ``tree`` — a COPY even for CPU
    tensors: the trainer updates its parameters in place while the writer
    thread is still writing this snapshot."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _ckpt_dir(workdir: str, step: int) -> str:
    return os.path.join(workdir, f"ckpt_{step:08d}")


def save(workdir: str, step: int, state: dict, keep: int = 3) -> str:
    """Synchronous atomic save of ``state`` (tensors + a ``meta`` dict).
    The caller's dict is not mutated. Keeps the newest ``keep``."""
    os.makedirs(workdir, exist_ok=True)
    final = _ckpt_dir(workdir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    tensors = dict(state)
    meta = tensors.pop("meta", {})
    path = os.path.join(tmp, _TENSORS)
    torch.save(tensors, path)
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump({"step": step, "meta": meta, "bytes": os.path.getsize(path),
                   "complete": True}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(workdir, keep)
    return final


def _gc(workdir: str, keep: int) -> None:
    steps = sorted(_list_steps(workdir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_ckpt_dir(workdir, s), ignore_errors=True)


def _manifest(workdir: str, step: int) -> dict | None:
    """The manifest of a complete, intact checkpoint, else None."""
    d = _ckpt_dir(workdir, step)
    try:
        with open(os.path.join(d, _MANIFEST)) as f:
            mf = json.load(f)
        if not (mf.get("complete") and mf.get("step") == step):
            return None
        if mf.get("sharded"):
            files = {p["process"]: p["bytes"] for p in mf["files"]}
            if all(os.path.getsize(os.path.join(d, _shard_file(r))) == b
                   for r, b in files.items()):
                return mf
        elif (os.path.getsize(os.path.join(d, _TENSORS))
              == mf.get("bytes")):
            return mf
    except (OSError, ValueError):
        pass
    return None  # partial / corrupt checkpoint: skipped


def _list_steps(workdir: str) -> list[int]:
    if not os.path.isdir(workdir):
        return []
    out = []
    for name in os.listdir(workdir):
        m = re.fullmatch(r"ckpt_(\d+)", name)
        if m and _manifest(workdir, int(m.group(1))) is not None:
            out.append(int(m.group(1)))
    return out


def latest_step(workdir: str) -> int | None:
    steps = _list_steps(workdir)
    return max(steps) if steps else None


def _check_like(got: Any, want: Any, path: str = "") -> None:
    """Raise unless ``got`` has ``want``'s structure, shapes and dtypes."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"checkpoint structure differs at {path or '/'}")
        for k in want:
            _check_like(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise ValueError(f"checkpoint structure differs at {path}")
        for i, (g, w) in enumerate(zip(got, want)):
            _check_like(g, w, f"{path}/{i}")
    elif isinstance(want, torch.Tensor):
        if (not isinstance(got, torch.Tensor) or got.shape != want.shape
                or got.dtype != want.dtype):
            raise ValueError(f"checkpoint leaf {path} does not match")


def restore(workdir: str, target: dict | None = None, step: int | None = None,
            device=None, *, mesh=None) -> tuple[dict, dict, int]:
    """Load a checkpoint (the latest complete one unless ``step`` is given)
    onto ``device`` -> (state, meta, step). With ``target`` (a state of the
    expected structure; its ``meta`` entry is ignored) the loaded tensors
    are checked against its structure, shapes and dtypes. A sharded
    checkpoint restores this rank's slices for ``mesh`` (None: one rank,
    whole tensors)."""
    if step is None:
        step = latest_step(workdir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {workdir}")
    mf = _manifest(workdir, step)
    if mf is None:
        raise FileNotFoundError(f"checkpoint {step} in {workdir} is "
                                "incomplete or corrupt")
    if mf.get("sharded"):
        state = _restore_sharded(_ckpt_dir(workdir, step), mf, mesh, device)
        return state, mf.get("meta", {}), step
    state = torch.load(os.path.join(_ckpt_dir(workdir, step), _TENSORS),
                       map_location=device, weights_only=True)
    if target is not None:
        _check_like(state, {k: v for k, v in target.items() if k != "meta"})
    return state, mf.get("meta", {}), step


# ----------------------------------------------------------- sharded layout
def _shard_file(rank: int) -> str:
    return f"shards_p{rank:05d}.pt"


def _shard_manifest(rank: int) -> str:
    return f"shard_manifest_p{rank:05d}.json"


def _skeleton(tree: Any, path: tuple = ()) -> Any:
    """The tree's structure as JSON: dicts and lists kept, each tensor
    replaced by its key (the path joined by ``||``)."""
    if isinstance(tree, dict):
        return {k: _skeleton(v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v, path + (str(i),)) for i, v in enumerate(tree)]
    if tree is None:
        return None
    return _SEP.join(path)


def _flat(tree: Any, path: tuple = ()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


_DROP = object()  # a leaf the restoring mesh cannot take (stack, other mp)


def _fill(skel: Any, leaves: dict) -> Any:
    if isinstance(skel, dict):
        out = {k: _fill(v, leaves) for k, v in skel.items()}
        return {k: v for k, v in out.items() if v is not _DROP}
    if isinstance(skel, list):
        return [_fill(v, leaves) for v in skel]
    if skel is None:
        return None
    return leaves.get(skel, _DROP)


def _snapshot_shards(state: dict, mesh, layout: Callable) -> dict:
    """Host half of the sharded save: this rank's pieces (copies) and
    their records. ``layout(path, tensor) -> ("rep", None) | ("dim", d) |
    ("stack", None)``."""
    rank = mesh.rank if mesh is not None else 0
    tp = mesh.tp if mesh is not None else 1
    m = mesh.model.index if mesh is not None else 0
    data_row0 = mesh is None or mesh.data.index == 0
    tensors = {k: v for k, v in state.items() if k != "meta"}
    pieces, records = {}, {}
    for path, t in _flat(tensors):
        key = _SEP.join(path)
        kind, dim = layout(path, t)
        shape = list(t.shape)
        if kind == "rep":
            if rank != 0:
                continue
            index = [[0, n] for n in shape]
        elif kind == "dim":
            if not data_row0:
                continue
            shape[dim] *= tp
            index = [[0, n] for n in shape]
            index[dim] = [m * t.shape[dim], (m + 1) * t.shape[dim]]
        else:  # stack
            if not data_row0:
                continue
            shape = [tp] + shape
            index = [[m, m + 1]] + [[0, n] for n in t.shape]
            t = t[None]
        pieces[key] = t.detach().to("cpu", copy=True)
        records[key] = {"shape": shape, "dtype": str(t.dtype)[6:],
                        "layout": [kind, dim], "index": index}
    return {"rank": rank, "writers": list(range(tp)) if rank == 0 else None,
            "pieces": pieces, "records": records,
            "skeleton": _skeleton(tensors) if rank == 0 else None,
            "meta": state.get("meta", {})}


def _attempt_tag(workdir: str, mesh, stale: str) -> str:
    """A name for the ``.tmp`` directories of a sharded save that every rank
    shares and no earlier attempt used. Rank 0 first removes the entries of
    ``workdir`` that match ``stale`` (what a crashed save left), then draws
    the tag and broadcasts it; every rank must call this, and the broadcast
    is the barrier: no rank writes before the stale directories are gone."""
    obj = [None]
    if mesh is None or mesh.rank == 0:
        if os.path.isdir(workdir):
            for name in os.listdir(workdir):
                if re.fullmatch(stale, name):
                    shutil.rmtree(os.path.join(workdir, name),
                                  ignore_errors=True)
        obj = [uuid.uuid4().hex]
    if mesh is not None and mesh.world.size > 1:
        import torch.distributed as dist

        dist.broadcast_object_list(obj, src=mesh.world.ranks[0],
                                   group=mesh.world.group)
    return obj[0]


def _write_shards(workdir: str, step: int, snap: dict, keep: int,
                  tag: str) -> str:
    """Disk half: this rank's pieces and shard manifest into the save's
    ``.tmp.<tag>`` directory; rank 0 then waits for every writer's
    manifest of this tag, merges them and publishes."""
    final = _ckpt_dir(workdir, step)
    tmp = f"{final}.tmp.{tag}"
    os.makedirs(tmp, exist_ok=True)
    rank = snap["rank"]
    path = os.path.join(tmp, _shard_file(rank))
    torch.save(snap["pieces"], path)
    mf_tmp = os.path.join(tmp, _shard_manifest(rank) + ".part")
    with open(mf_tmp, "w") as f:
        json.dump({"step": step, "tag": tag, "process": rank,
                   "leaves": snap["records"],
                   "bytes": os.path.getsize(path)}, f)
    os.replace(mf_tmp, os.path.join(tmp, _shard_manifest(rank)))
    if rank != 0:
        return final
    deadline = time.monotonic() + _SHARD_WAIT_S
    parts = {}
    for r in snap["writers"]:
        mpath = os.path.join(tmp, _shard_manifest(r))
        while True:
            try:
                with open(mpath) as f:
                    mf = json.load(f)
                if mf.get("step") == step and mf.get("tag") == tag:
                    parts[r] = mf
                    break
            except (OSError, ValueError):
                pass
            if time.monotonic() > deadline:
                raise TimeoutError(f"sharded save step {step}: rank {r}'s "
                                   "shard manifest never appeared")
            time.sleep(0.01)
    leaves: dict[str, dict] = {}
    for r, mf in sorted(parts.items()):
        for key, rec in mf["leaves"].items():
            dst = leaves.setdefault(key, {"shape": rec["shape"],
                                          "dtype": rec["dtype"],
                                          "layout": rec["layout"],
                                          "pieces": []})
            dst["pieces"].append({"process": r, "index": rec["index"]})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump({"step": step, "meta": snap["meta"], "sharded": True,
                   "files": [{"process": r, "bytes": mf["bytes"]}
                             for r, mf in sorted(parts.items())],
                   "skeleton": snap["skeleton"], "leaves": leaves,
                   "complete": True}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(workdir, keep)
    return final


def save_sharded(workdir: str, step: int, state: dict, mesh,
                 layout: Callable, keep: int = 3) -> str:
    """Synchronous sharded save: every rank of ``mesh`` calls it with the
    same step and its own ``state``; ``layout(path, tensor)`` places each
    leaf (see the module doc). Returns the checkpoint directory once
    rank 0 has published it (other ranks return after their own write)."""
    stale = re.escape(os.path.basename(_ckpt_dir(workdir, step))) + _TMP_RE
    tag = _attempt_tag(workdir, mesh, stale)
    return _write_shards(workdir, step, _snapshot_shards(state, mesh, layout),
                         keep, tag)


def _restore_sharded(d: str, mf: dict, mesh, device) -> dict:
    tp = mesh.tp if mesh is not None else 1
    m = mesh.model.index if mesh is not None else 0
    files: dict[int, dict] = {}

    def piece(p: dict, key: str) -> torch.Tensor:
        r = p["process"]
        if r not in files:
            files[r] = torch.load(os.path.join(d, _shard_file(r)),
                                  map_location="cpu", weights_only=True,
                                  mmap=True)
        return files[r][key]

    out = {}
    for key, rec in mf["leaves"].items():
        kind, dim = rec["layout"]
        shape = rec["shape"]
        if kind == "stack":
            if shape[0] != tp:
                continue  # per-shard state of another model width
            want = [[m, m + 1]] + [[0, n] for n in shape[1:]]
        elif kind == "dim":
            n = shape[dim] // tp
            want = [[0, s] for s in shape]
            want[dim] = [m * n, (m + 1) * n]
        else:
            want = [[0, s] for s in shape]
        hit = next((p for p in rec["pieces"] if p["index"] == want), None)
        if hit is not None:
            t = piece(hit, key)
        else:
            full = torch.empty(shape, dtype=getattr(torch, rec["dtype"]))
            for p in rec["pieces"]:
                full[tuple(slice(a, b) for a, b in p["index"])] = piece(p,
                                                                        key)
            t = full[tuple(slice(a, b) for a, b in want)]
        if kind == "stack":
            t = t[0]
        out[key] = t.to(device, copy=True).contiguous()
    return _fill(mf["skeleton"], out)


class CheckpointManager:
    """Async wrapper: snapshot to host in the caller's thread, write in a
    background thread; writes stay ordered behind one another.

    ``sharded`` (default: True on a mesh of more than one rank) selects the
    sharded layout, with ``layout(path, tensor)`` placing each leaf; a
    multi-rank mesh always checkpoints sharded (no rank holds the whole
    state). A sharded manager is made on every rank at once: it removes
    the unpublished directories earlier attempts left in ``workdir`` and
    agrees on the tag of its own (:func:`_attempt_tag`); its n-th save
    writes into ``ckpt_<step>.tmp.<tag>.<n>``."""

    def __init__(self, workdir: str, keep: int = 3, sharded: bool | None = None,
                 mesh=None, layout: Callable | None = None):
        multi = mesh is not None and mesh.dp * mesh.tp > 1
        if sharded is None:
            sharded = multi
        if multi and not sharded:
            raise ValueError("a multi-rank mesh checkpoints in the sharded "
                             "layout (sharded=True)")
        self.workdir = workdir
        self.keep = keep
        self.sharded = bool(sharded)
        self.mesh = mesh
        self.layout = layout or (lambda path, t: ("rep", None))
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._tag = (_attempt_tag(workdir, mesh, r"ckpt_\d+" + _TMP_RE)
                     if self.sharded else None)
        self._saves = 0

    def wait(self) -> None:
        """Block until every pending write is on disk; re-raise the first
        writer error. Sharded on a multi-rank mesh, every rank then waits
        for the others (a barrier), so a checkpoint rank 0 publishes is
        visible to all before any of them goes on."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self.sharded and self.mesh is not None and self.mesh.world.size > 1:
                import torch.distributed as dist

                dist.barrier(group=self.mesh.world.group)
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def save_async(self, step: int, state: dict) -> None:
        """Snapshot ``state`` to host FIRST (a copy: the caller may update
        its tensors right after), then write it on a background thread."""
        if self.sharded:
            snap = _snapshot_shards(state, self.mesh, self.layout)
            self._saves += 1
            tag = f"{self._tag}.{self._saves}"

            def write():
                _write_shards(self.workdir, step, snap, self.keep, tag)
        else:
            host = dict(_to_host({k: v for k, v in state.items()
                                  if k != "meta"}),
                        meta=state.get("meta", {}))

            def write():
                save(self.workdir, step, host, keep=self.keep)
        prev = self._thread

        def run():
            if prev is not None:
                prev.join()  # one ordered stream of file operations
            try:
                write()
            except Exception as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def latest_step(self) -> int | None:
        return latest_step(self.workdir)

    def restore(self, target=None, step=None, device=None):
        return restore(self.workdir, target, step=step, device=device,
                       mesh=self.mesh)
