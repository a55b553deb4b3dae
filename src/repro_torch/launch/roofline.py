"""Roofline terms of a traced step (counterpart of
``repro/launch/roofline.py``), on no hardware:

    compute    = Σ_dtype flops_per_device[dtype] / peak[dtype]
    memory     = hbm_bytes_per_device / HBM rate
    collective = collective_operand_bytes_per_device / link rate

The counts come from :mod:`repro_torch.launch.cost_model` (one run of the
step under ``CostMode``; per device, as the step runs rank 0's share on a
virtual mesh). The compute term sums each dtype's flops over that dtype's
peak, as the kernels' bounds in ``chip_smoke.py`` do.

Hardware constants: NVIDIA H100 SXM data sheet at 700 W, dense (no
sparsity): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 (the port
turns TF32 off, ``repro_torch/__init__.py``), 3.35 TB/s HBM3, NVLink 450
GB/s each way. The collective term takes the one NVLink rate, as the
reference takes one ICI link's: it is a lower bound wherever an axis
leaves a host of 8 cards, where the traffic crosses the slower
inter-host network instead.
"""
from __future__ import annotations

import dataclasses

__all__ = ["HW", "RooflineReport", "analyze"]

HW = dict(peak_flops={"bf16": 989e12, "fp32": 67e12}, hbm_bw=3.35e12,
          link_bw=450e9)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    flops_by_dtype: dict
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_detail: dict
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float  # 6·N(_active)·tokens (2· for inference), global
    useful_frac: float  # model_flops / (flops_per_device * n_devices)
    mem_stats: dict
    hbm_top: list  # top (op, bytes) HBM contributors
    coll_top: list  # top (axis, kind, bytes, count) collective sites

    def row(self) -> str:
        return (
            f"{self.arch:>18s} {self.shape:>11s} {self.mesh:>9s} "
            f"{self.t_compute*1e3:9.3f} {self.t_memory*1e3:9.3f} "
            f"{self.t_collective*1e3:9.3f}  {self.bottleneck:<10s} "
            f"{self.useful_frac*100:6.1f}%"
        )


def t_compute(flops_by_dtype: dict) -> float:
    """Seconds of the flops at each dtype's peak (an unknown dtype at the
    fp32 peak)."""
    peaks = HW["peak_flops"]
    return sum(f / peaks.get(dt, peaks["fp32"])
               for dt, f in flops_by_dtype.items())


def analyze(arch: str, shape: str, mesh_name: str, n_devices: int, cost,
            model_flops: float, mem_stats: dict | None = None
            ) -> RooflineReport:
    """The report of one traced step: ``cost`` is its
    :class:`repro_torch.launch.cost_model.CostRecord` (per device),
    ``mem_stats`` the dry run's memory figures."""
    t_c = t_compute(cost.flops_by_dtype)
    t_m = cost.hbm_bytes / HW["hbm_bw"]
    t_x = cost.coll_bytes / HW["link_bw"]
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    coll = {
        "total": cost.coll_bytes,
        "by_kind": dict(cost.coll_by_kind),
        "counts": dict(cost.coll_counts),
        "by_axis": {f"{k}@{a}": b for (k, a), b in cost.coll_by_axis.items()},
    }
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        flops_per_device=cost.flops,
        flops_by_dtype=dict(cost.flops_by_dtype),
        bytes_per_device=cost.hbm_bytes,
        coll_bytes_per_device=cost.coll_bytes,
        coll_detail=coll,
        t_compute=t_c,
        t_memory=t_m,
        t_collective=t_x,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_frac=((model_flops / (cost.flops * n_devices))
                     if cost.flops else 0.0),
        mem_stats=dict(mem_stats or {}),
        hbm_top=cost.top_hbm(8),
        coll_top=cost.top_collectives(8),
    )
