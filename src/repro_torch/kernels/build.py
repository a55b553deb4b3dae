"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, which ``ctypes`` loads.
That takes seconds per source, where a build against PyTorch's C++ headers
takes minutes. Libraries land in ``build/kernels/`` at the repository root
(git-ignored), named by a hash of their sources and flags, so an edited
kernel is rebuilt and a built one is reused. All missing libraries are
compiled in parallel, one ``nvcc`` each, on first use.

Nothing here runs at import time: the CPU-only test suite imports every
module and never builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load", "build_dir", "ptxas_report",
           "bind", "ptr", "stream", "check"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("flash_decode", "ivf_gather_score", "pq_lut_score",
           "decode_fused", "fused_estimator")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/kernels`` under the repository root (``src/..``)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every library of ``names`` not built yet, all ``nvcc``
    processes started together. Raises with the compiler's output if any
    fails. Returns name -> library path."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = []
    for n, p in paths.items():
        if p.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs.append((n, p, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    errors = []
    for n, p, tmp, proc in procs:
        log, _ = proc.communicate()
        (out / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            errors.append(f"nvcc failed for {n}.cu:\n{log}")
        else:
            os.replace(tmp, p)  # atomic: concurrent builders never see half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def ptxas_report() -> str:
    """Register / shared-memory lines ``ptxas -v`` printed at the last
    build of each library (empty for libraries reused from disk)."""
    lines = []
    for n in SOURCES:
        log = build_dir() / f"{n}.log"
        if log.exists():
            lines += [f"{n}: {ln.strip()}" for ln in log.read_text().splitlines()
                      if "registers" in ln or "Compiling entry" in ln]
    return "\n".join(lines)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building all missing
    libraries first."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_all()[name]
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib


# ctypes argument kinds of the C launchers: a device pointer or the stream
# (void*), a 32-bit int, and the returned CUDA error code.
P = ctypes.c_void_p
I = ctypes.c_int


def bind(lib_name: str, fn_name: str, argtypes, restype=ctypes.c_int):
    """``lib.fn`` with its ctypes signature declared."""
    fn = getattr(load(lib_name), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def ptr(t) -> int | None:
    """Device pointer of a tensor (None -> NULL)."""
    return None if t is None else t.data_ptr()


def stream() -> int:
    """PyTorch's current CUDA stream, where every kernel launches."""
    import torch

    return torch.cuda.current_stream().cuda_stream


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (refused launch, bad
    attribute) — ``torch.cuda.synchronize`` would never report it."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
