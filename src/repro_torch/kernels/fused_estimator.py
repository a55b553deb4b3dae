"""fused_estimator: the stratified estimator of Algorithms 3 + 4 and its
backward, CUDA kernels for Hopper (``csrc/fused_estimator.cu``; counterpart
of ``repro/kernels/fused_estimator.py`` and of the backward of
``repro/core/estimators.py::_fused_logz``).

* :func:`fused_estimator` — per token, ``log_z = log Σ_j exp(y_j)`` and
  ``expv = Σ_j softmax_j · emb[ids_j]`` with ``y_j = emb[ids_j] · h +
  log_w_j``, by an online softmax over the candidate rows streamed by id.
* :func:`fused_estimator_bwd` — ``p = exp(y - log_z) · g`` and the dense
  ``d_emb[r] = Σ_{ids_tj = r} p_tj · h_t``, from the scores ``y`` the
  forward wrote (``return_y=True``), without float atomics: the flat
  candidate ids are sorted once (stably) and each row's segment is folded
  in order from d-slices of h held in shared memory, so the result is
  bitwise repeatable.

Their plain versions are ``ref.fused_estimator_ref`` and
``ref.fused_estimator_bwd_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["fused_estimator", "fused_estimator_bwd", "launches"]

launches = {"fused_estimator": 0, "fused_estimator_bwd": 0}

_MAX_D = 4096  # 32 float4 groups per lane in the forward's registers


def _check(name: str, emb, ids, h, log_w):
    """Validate the shared inputs; returns (emb, ids clamped i32, h f32,
    log_w f32), contiguous CUDA tensors."""
    for t in (emb, ids, h, log_w):
        if not t.is_cuda:
            raise ValueError(f"{name} kernel needs CUDA tensors")
    if emb.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: embedding rows must be float32 or "
                         f"bfloat16, got {emb.dtype}")
    if emb.dim() != 2 or ids.dim() != 2 or h.dim() != 2:
        raise ValueError(f"{name}: emb (n, d), ids (t, m), h (t, d) expected")
    n, d = emb.shape
    t, m = ids.shape
    if h.shape != (t, d) or log_w.shape != (t, m):
        raise ValueError(f"{name}: h {tuple(h.shape)} / log_w "
                         f"{tuple(log_w.shape)} do not fit ids {(t, m)}, "
                         f"d={d}")
    if d % 4 or d > _MAX_D or n == 0:
        raise ValueError(f"{name}: d={d} must be a multiple of 4 and at most "
                         f"{_MAX_D}, n={n} positive")
    if n * d >= 2 ** 31 or t * max(m, d) >= 2 ** 31:
        raise ValueError(f"{name}: sizes past 32-bit indexing")
    emb = emb.contiguous()
    if emb.data_ptr() % 16:
        raise ValueError(f"{name}: emb must be 16-byte aligned")
    # ids clamp to [0, n) as a gather would; the backward's row segments
    # are built from the same clamped ids
    ids = ids.clamp(0, n - 1).to(torch.int32).contiguous()
    return (emb, ids, h.float().contiguous(),
            log_w.float().contiguous())


def fused_estimator(emb: torch.Tensor, ids: torch.Tensor, h: torch.Tensor,
                    log_w: torch.Tensor, *, return_y: bool = False):
    """Launch the forward kernel: emb (n, d) f32/bf16, ids (t, m), h (t, d),
    log_w (t, m) -> (log_z (t,) f32, expv (t, d) f32), and with
    ``return_y`` also the scores y (t, m) f32 (-inf on dead slots), which
    :func:`fused_estimator_bwd` takes."""
    emb, ids, h, log_w = _check("fused_estimator", emb, ids, h, log_w)
    n, d = emb.shape
    t, m = ids.shape
    log_z = torch.empty((t,), dtype=torch.float32, device=h.device)
    expv = torch.empty((t, d), dtype=torch.float32, device=h.device)
    y = (torch.empty((t, m), dtype=torch.float32, device=h.device)
         if return_y else None)
    fn = build.bind("fused_estimator", "fused_estimator_launch",
                    [build.P] * 7 + [build.I] * 5 + [build.P])
    err = fn(build.ptr(emb), build.ptr(ids), build.ptr(h), build.ptr(log_w),
             build.ptr(log_z), build.ptr(expv), build.ptr(y), n, d, t, m,
             int(emb.dtype == torch.bfloat16), build.stream())
    build.check(err, "fused_estimator")
    launches["fused_estimator"] += 1
    return (log_z, expv, y) if return_y else (log_z, expv)


def fused_estimator_bwd(emb: torch.Tensor, ids: torch.Tensor,
                        h: torch.Tensor, log_w: torch.Tensor,
                        log_z: torch.Tensor, g: torch.Tensor, *,
                        y: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel -> (d_emb (n, d) f32, p (t, m) f32), the
    cotangents of emb and log_w for an upstream gradient ``g`` (t,) of
    log_z. The cotangent of h is ``g · expv`` (no kernel needed). ``y``
    is the forward's scores (``fused_estimator(..., return_y=True)``);
    without it one forward launch computes them. The kernel reads no row of
    emb: n comes from its shape."""
    emb, ids, h, log_w = _check("fused_estimator_bwd", emb, ids, h, log_w)
    n, d = emb.shape
    t, m = ids.shape
    if log_z.shape != (t,) or g.shape != (t,):
        raise ValueError("fused_estimator_bwd: log_z and g must be (t,)")
    if y is not None and y.shape != (t, m):
        raise ValueError(f"fused_estimator_bwd: y must be {(t, m)}")
    if not (log_z.is_cuda and g.is_cuda and (y is None or y.is_cuda)):
        raise ValueError("fused_estimator_bwd kernel needs CUDA tensors")
    if y is None:
        y = fused_estimator(emb, ids, h, log_w, return_y=True)[2]
    y = y.float().contiguous()
    if h.data_ptr() % 16:  # the kernel reads h's rows as float4 groups
        h = h.clone()
    log_z = log_z.float().contiguous()
    g = g.float().contiguous()
    # 16-bit keys where the ids fit: half the radix sort's passes
    kt = torch.int16 if n < 2 ** 15 - 1 else torch.int32
    sorted_ids, order = torch.sort(ids.reshape(-1).to(kt), stable=True)
    offsets = torch.searchsorted(
        sorted_ids, torch.arange(n + 1, dtype=kt, device=h.device),
        out_int32=True)
    d_emb = torch.empty((n, d), dtype=torch.float32, device=h.device)
    p = torch.empty((t, m), dtype=torch.float32, device=h.device)
    fn = build.bind("fused_estimator", "fused_estimator_bwd_launch",
                    [build.P] * 8 + [build.I] * 4 + [build.P])
    err = fn(build.ptr(order), build.ptr(offsets), build.ptr(h),
             build.ptr(y), build.ptr(log_z), build.ptr(g), build.ptr(d_emb),
             build.ptr(p), n, d, t, m, build.stream())
    build.check(err, "fused_estimator_bwd")
    launches["fused_estimator_bwd"] += 1
    return d_emb, p
