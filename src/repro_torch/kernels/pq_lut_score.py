"""pq_lut_score: the IVF-PQ LUT screen of the probed clusters, a CUDA kernel
for Hopper (``csrc/pq_lut_score.cu``; counterpart of
``repro/kernels/pq_lut_score.py``).

Scores every member of each query's probed clusters by its uint8 codes:
``scores[b, j, c] = Σ_m lut[b, m, member_codes[probe[b, j], c, m]]``, added
in subspace order from 0.0. The plain version is
:func:`repro_torch.kernels.ref.pq_lut_score_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["pq_lut_score", "launches", "check_codes"]

launches = {"pq_lut_score": 0}  # kernel launches; reset by ops.reset_launch_counts

_SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may use


def check_codes(member_codes, probe, lut, name: str):
    """Validate the PQ code tables, probe and LUTs a kernel takes; returns
    them as contiguous u8 / i32 / f32 CUDA tensors."""
    for t in (member_codes, probe, lut):
        if not t.is_cuda:
            raise ValueError(f"{name} kernel needs CUDA tensors")
    if member_codes.dim() != 3 or member_codes.dtype != torch.uint8:
        raise ValueError(f"{name}: member_codes must be (n_c, cap, m_sub) "
                         f"uint8, got {tuple(member_codes.shape)} "
                         f"{member_codes.dtype}")
    m_sub = member_codes.shape[2]
    b = probe.shape[0]
    if probe.dim() != 2 or lut.dim() != 3 or lut.shape[:2] != (b, m_sub):
        raise ValueError(f"{name}: probe {tuple(probe.shape)} / lut "
                         f"{tuple(lut.shape)} do not fit m_sub={m_sub}")
    if not 0 < lut.shape[2] <= 256:
        raise ValueError(f"{name}: ksub={lut.shape[2]} must be in 1..256 "
                         "(uint8 codes)")
    if lut.dtype != torch.float32:
        raise ValueError(f"{name}: lut must be float32")
    if 4 * m_sub * lut.shape[2] > _SMEM_LIMIT:
        raise ValueError(f"{name}: a {m_sub} x {lut.shape[2]} LUT exceeds "
                         "one block's shared memory")
    member_codes = member_codes.contiguous()
    if member_codes.data_ptr() % 16:
        raise ValueError(f"{name}: member_codes must be 16-byte aligned")
    return (member_codes, probe.to(torch.int32).contiguous(),
            lut.contiguous())


def pq_lut_score(member_codes: torch.Tensor, probe: torch.Tensor,
                 lut: torch.Tensor) -> torch.Tensor:
    """Launch the kernel -> scores (b, n_probe, cap) f32."""
    member_codes, probe, lut = check_codes(member_codes, probe, lut,
                                           "pq_lut_score")
    n_c, cap, m_sub = member_codes.shape
    b, n_probe = probe.shape
    scores = torch.empty((b, n_probe, cap), dtype=torch.float32,
                         device=lut.device)
    fn = build.bind("pq_lut_score", "pq_lut_score_launch",
                    [build.P] * 4 + [build.I] * 6 + [build.P])
    err = fn(build.ptr(member_codes), build.ptr(probe), build.ptr(lut),
             build.ptr(scores), n_c, cap, m_sub, lut.shape[2], b, n_probe,
             build.stream())
    build.check(err, "pq_lut_score")
    launches["pq_lut_score"] += 1
    return scores
