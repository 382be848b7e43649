"""Three-term roofline analysis of a counted step (port of
``repro.roofline.analysis``).

  compute    = FLOPs_per_chip / peak_FLOP/s
  memory     = bytes_per_chip / HBM_bw
  collective = collective_bytes_per_chip / link_bw

The counts come from ``roofline.op_count.op_cost_analysis`` (the port's
counterpart of the reference's HLO walk and of its
``collective_bytes_from_hlo``). The peaks are the H100's, from
``core/device.py`` (``GPU_H100``: bf16 and f32 FLOP/s, HBM bytes/s, NVLink
bytes/s) and its 80 GB of device memory.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.device import GPU_H100, HBM_BYTES
from repro_torch.models.config import ArchConfig


@dataclass(frozen=True)
class HW:
    peak_flops_bf16: float = GPU_H100.flops_bf16
    peak_flops_f32: float = GPU_H100.flops_f32
    hbm_bw: float = GPU_H100.hbm_bw
    ici_bw: float = GPU_H100.ici_bw
    hbm_bytes: int = HBM_BYTES[GPU_H100.kind]


def model_flops(cfg: ArchConfig, kind: str, global_batch: int,
                seq: int) -> float:
    """Reference useful FLOPs: 6·N_active·tokens (train) or
    2·N_active·tokens (inference)."""
    n = cfg.n_active_params()
    if kind == "train":
        tokens = global_batch * seq
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = global_batch * seq
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * global_batch * 1


def roofline_report(*, flops_per_chip: float, bytes_per_chip: float,
                    collective_per_chip: dict[str, float], chips: int,
                    cfg: ArchConfig, kind: str, global_batch: int, seq: int,
                    dtype: str = "bfloat16", hw: HW = HW()) -> dict:
    peak = hw.peak_flops_bf16 if dtype == "bfloat16" else hw.peak_flops_f32
    t_compute = flops_per_chip / peak
    t_memory = bytes_per_chip / hw.hbm_bw
    t_collective = collective_per_chip.get("total", 0.0) / hw.ici_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, kind, global_batch, seq)
    hlo_flops_global = flops_per_chip * chips
    useful = mf / hlo_flops_global if hlo_flops_global else 0.0
    bound = max(t_compute, t_memory, t_collective)
    # roofline fraction: useful model FLOPs per chip over what the dominant
    # term's time would allow at peak compute
    ideal_s = (mf / chips) / peak
    frac = ideal_s / bound if bound > 0 else 0.0
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops": mf,
        "hlo_flops_per_chip": flops_per_chip,
        "hlo_bytes_per_chip": bytes_per_chip,
        "collective_bytes_per_chip": collective_per_chip,
        "useful_flops_ratio": useful,
        "roofline_fraction": frac,
        "step_time_bound_s": bound,
    }
