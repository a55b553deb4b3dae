"""fused_estimator: the stratified estimator of Algorithms 3 + 4 and its
backward, CUDA kernels for Hopper (``csrc/fused_estimator.cu``; counterpart
of ``repro/kernels/fused_estimator.py`` and of the backward of
``repro/core/estimators.py::_fused_logz``).

* :func:`fused_estimator` — per token, ``log_z = log Σ_j exp(y_j)`` and
  ``expv = Σ_j softmax_j · emb[ids_j]`` with ``y_j = emb[ids_j] · h +
  log_w_j``. One call enqueues one kernel family on the stream, its route
  chosen by :func:`route` from the shapes alone: where enough tokens share
  the launch, the rows named by at least ``POPULAR_USES`` live slots are
  scored and summed as two dense products on the tensor cores (TF32 in
  three passes); every other live slot streams its row, each token's slots
  split into contiguous ranges over the card, and the ranges' partials are
  merged in range order. No host sync: the call can be captured in a CUDA
  graph.
* :func:`fused_estimator_bwd` — ``p = exp(y - log_z) · g`` and the dense
  ``d_emb[r] = Σ_{ids_tj = r} p_tj · h_t``, from the scores ``y`` the
  forward wrote (``return_y=True``), without float atomics: the flat
  candidate ids are sorted once (stably) and each row's segment is folded
  in order from d-slices of h held in shared memory, so the result is
  bitwise repeatable.
* :func:`popular_rows` — the forward's plan alone (which rows go to the
  dense products, and their columns), for tests.

Their plain versions are ``ref.fused_estimator_ref``,
``ref.fused_estimator_bwd_ref`` and ``ref.popular_rows_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["fused_estimator", "fused_estimator_bwd", "popular_rows", "route",
           "launches", "symbols", "POPULAR_USES", "POPULAR_CAP"]

launches = {"fused_estimator": 0, "fused_estimator_bwd": 0}
# CUDA symbols by kernel (ops.kernel_symbols): (one a call, the others)
symbols = {
    "fused_estimator": (("fused_estimator_combine_kernel",),
                        ("fused_estimator_stream_kernel",
                         "fused_estimator_band_kernel",
                         "fused_estimator_count_kernel",
                         "fused_estimator_tile_kernel",
                         "fused_estimator_compact_kernel",
                         "fused_estimator_dense_score_kernel",
                         "fused_estimator_dense_weights_kernel",
                         "fused_estimator_dense_sum_kernel")),
    "fused_estimator_bwd": (("fused_estimator_bwd_spmm_kernel",), ()),
}

_MAX_D = 4096  # 32 float4 groups per lane in the forward's registers
_bound: dict = {}  # the forward's ctypes launchers, bound on first use
_plans: dict = {}  # (n, d, t, m) -> the forward's route and scratch size
# R: a row named by at least R live slots of a launch is read once, into the
# dense products; the .cu's kPopularUses, and why 32 its header says
POPULAR_USES = 32
POPULAR_CAP = 8192  # the most rows the dense products take (their grid)
# slot ranges a token: t x ranges blocks of the stream kernel fill the 132
# SMs twice over at the blocks an SM holds at once (its registers: 3 blocks
# up to d 256, 2 up to d 1,024, 1 beyond), a range at least 32 slots (a
# warp's batch of ids). More ranges add a block's fixed cost (h in, the
# warps' merge, a d-wide partial out) without more rows in flight.
_SMS = 132
_WAVES = 2
_MIN_RANGE = 32
# the band walk, where the plan runs: a token's slots sorted by the band of
# their row, bands of at most 16 MiB of fp32 rows (L2 holds 50 MB), at most
# 32 of them and 4,096 slots a token (the sorted list is in shared memory)
_BAND_BYTES = 16 << 20
_MAX_BANDS = 32
_BAND_SLOTS = 4096


def _resident_blocks(d: int) -> int:
    return 3 if d <= 256 else 2 if d <= 1024 else 1


def route(n: int, d: int, t: int, m: int) -> dict:
    """The forward's route for an (n, d) table, t tokens and m slots a
    token, from the shapes alone (so a meta trace can name it): whether the
    popular-row plan runs (``popular``), its column ``cap`` (a multiple of
    64: at most ``POPULAR_CAP``, n, or t·m / R rows can reach R), and the
    slot ``ranges`` each token's slots are cut into, or the row ``bands``
    they are walked by (the band walk, where the plan runs and m <= 4,096:
    ranges 1; else bands 0). The plan runs where
    t >= 2R tokens share the launch and its t·m slots are at least the
    table's n rows: its passes over the n row counts then cost no more
    than the slots' own ids (at the paper's tables, 1.3–2 M rows against
    0.3–0.4 M slots, they would not)."""
    cap = min(POPULAR_CAP, n, t * m // POPULAR_USES) // 64 * 64
    popular = t >= 2 * POPULAR_USES and t * m >= n and cap > 0
    target = _SMS * _resident_blocks(d) * _WAVES
    ranges = max(1, min(-(-target // max(t, 1)), -(-m // _MIN_RANGE)))
    bands = 0
    if popular and m <= _BAND_SLOTS:
        bands = max(1, min(_MAX_BANDS, -(-4 * n * d // _BAND_BYTES)))
        ranges = 1
    return {"popular": popular, "cap": cap if popular else 0,
            "ranges": ranges, "bands": bands}


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
    """Launch the forward kernels: emb (n, d) f32/bf16, ids (t, m), h (t, d),
    log_w (t, m) -> (log_z (t,) f32, expv (t, d) f32), and with
    ``return_y`` also the scores y (t, m) f32 (-inf on dead slots), which
    :func:`fused_estimator_bwd` takes. The route (:func:`route`) does not
    depend on ``return_y``: log_z and expv are the same bits either way."""
    emb, ids, h, log_w = _check("fused_estimator", emb, ids, h, log_w)
    if h.data_ptr() % 16:  # the dense product reads h's rows as float4s
        h = h.clone()
    n, d = emb.shape
    t, m = ids.shape
    ranges, bands, cap, scratch = _shape_plan(n, d, t, m)
    dev = h.device
    log_z = torch.empty((t,), dtype=torch.float32, device=dev)
    expv = torch.empty((t, d), dtype=torch.float32, device=dev)
    y = (torch.empty((t, m), dtype=torch.float32, device=dev)
         if return_y else None)
    work = torch.empty((scratch,), dtype=torch.uint8, device=dev)
    err = _fn("fused_estimator_launch", [build.P] * 8 + [build.I] * 8
              + [build.P])(
        build.ptr(emb), build.ptr(ids), build.ptr(h), build.ptr(log_w),
        build.ptr(log_z), build.ptr(expv), build.ptr(y), work.data_ptr(), n,
        d, t, m, int(emb.dtype == torch.bfloat16), ranges, bands, cap,
        build.stream())
    del work  # freed to the caching allocator: later work on this stream
    # waits for the call (the dense chain joins it before the combine)
    build.check(err, "fused_estimator")
    launches["fused_estimator"] += 1
    return (log_z, expv, y) if return_y else (log_z, expv)


def _fn(name: str, argtypes, restype=ctypes.c_int):
    """The launcher ``name`` of the library, bound on first use."""
    fn = _bound.get(name)
    if fn is None:
        fn = _bound[name] = build.bind("fused_estimator", name, argtypes,
                                       restype)
    return fn


def _shape_plan(n: int, d: int, t: int, m: int) -> tuple[int, int, int, int]:
    """(ranges, bands, cap, scratch bytes) of the forward at these shapes,
    cap 0 without the plan; computed once a shape. The scratch is one
    allocation that the launcher carves (its layout is in the .cu)."""
    key = (n, d, t, m)
    got = _plans.get(key)
    if got is None:
        r = route(n, d, t, m)
        scratch = _fn("fused_estimator_workspace", [build.I] * 5,
                      ctypes.c_size_t)(n, d, t, r["ranges"], r["cap"])
        got = _plans[key] = (r["ranges"], r["bands"], r["cap"], scratch)
    return got


def popular_rows(ids: torch.Tensor, log_w: torch.Tensor, n: int, *,
                 cap: int = POPULAR_CAP
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward's plan alone: ids (t, m) in [0, n), log_w (t, m)
    -> (colmap (n,) i32: each row's column in U or -1; rows (n_u,) i32: U's
    rows in row order; n_u (1,) i32), U being the rows named by at least
    ``POPULAR_USES`` live slots, the first ``cap`` of them. Reads n_u back
    (a sync); not on any path, and counted nowhere."""
    if not (ids.is_cuda and log_w.is_cuda):
        raise ValueError("popular_rows kernel needs CUDA tensors")
    t, m = ids.shape
    ids = ids.clamp(0, n - 1).to(torch.int32).contiguous()
    log_w = log_w.float().contiguous()
    colmap, tiles, rows, n_u = (
        torch.empty((k,), dtype=torch.int32, device=ids.device)
        for k in (n, -(-n // 2048), cap, 1))
    err = _fn("fused_estimator_plan_launch", [build.P] * 6 + [build.I] * 4
              + [build.P])(
        build.ptr(ids), build.ptr(log_w), build.ptr(colmap), build.ptr(tiles),
        build.ptr(rows), build.ptr(n_u), n, t, m, cap, build.stream())
    build.check(err, "fused_estimator plan")
    return colmap, rows[:int(n_u.item())], n_u


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
