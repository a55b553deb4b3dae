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
JSON values (step, data cursor). Sharded multi-process checkpoints come
with the sharding slice.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import torch

__all__ = ["save", "latest_step", "restore", "CheckpointManager"]

_TENSORS = "state.pt"
_MANIFEST = "manifest.json"


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
        if (mf.get("complete") and mf.get("step") == step
                and os.path.getsize(os.path.join(d, _TENSORS))
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
            device=None) -> tuple[dict, dict, int]:
    """Load a checkpoint (the latest complete one unless ``step`` is given)
    onto ``device`` -> (state, meta, step). With ``target`` (a state of the
    expected structure; its ``meta`` entry is ignored) the loaded tensors
    are checked against its structure, shapes and dtypes."""
    if step is None:
        step = latest_step(workdir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {workdir}")
    mf = _manifest(workdir, step)
    if mf is None:
        raise FileNotFoundError(f"checkpoint {step} in {workdir} is "
                                "incomplete or corrupt")
    state = torch.load(os.path.join(_ckpt_dir(workdir, step), _TENSORS),
                       map_location=device, weights_only=True)
    if target is not None:
        _check_like(state, {k: v for k, v in target.items() if k != "meta"})
    return state, mf.get("meta", {}), step


class CheckpointManager:
    """Async wrapper: snapshot to host in the caller's thread, write in a
    background thread; writes stay ordered behind one another."""

    def __init__(self, workdir: str, keep: int = 3):
        self.workdir = workdir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def wait(self) -> None:
        """Block until every pending write is on disk; re-raise the first
        writer error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def save_async(self, step: int, state: dict) -> None:
        """Snapshot ``state`` to host FIRST (a copy: the caller may update
        its tensors right after), then write it on a background thread."""
        host = dict(_to_host({k: v for k, v in state.items() if k != "meta"}),
                    meta=state.get("meta", {}))
        prev = self._thread

        def run():
            if prev is not None:
                prev.join()  # one ordered stream of file operations
            try:
                save(self.workdir, step, host, keep=self.keep)
            except Exception as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def latest_step(self) -> int | None:
        return latest_step(self.workdir)

    def restore(self, target=None, step=None, device=None):
        return restore(self.workdir, target, step=step, device=device)
