"""Workload descriptors — what a kernel configuration *does* to the hardware.

A copy of ``repro.core.workload``. A KernelBuilder may provide
``workload(config, problem, dtype)`` returning a :class:`Workload`. Each of
the port's kernels registers one for the H100 (flops, compulsory HBM
traffic, a block's shared memory as ``vmem_bytes``, blocks launched as
``grid``), which ``repro_torch.prof`` joins with a launch's measured time;
the TPU-shaped fields (``mxu_tile``, lanes, ``reuse``) stay at their
defaults. The analytical cost model that turns (Workload, DeviceSpec) into
a simulated kernel time is not ported yet (see ROADMAP.md), so the port's
kernels time themselves on the card instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Workload:
    """Per-launch hardware demand for one kernel configuration."""

    flops: float                 # useful floating-point ops for the launch
    hbm_bytes: float             # HBM bytes moved (incl. halo / re-fetch waste)
    vmem_bytes: int              # per-program VMEM working set (all buffers)
    grid: int                    # number of grid programs
    # Effective matmul tile (m, n, k) for MXU-alignment efficiency;
    # None for VPU-only (elementwise / stencil) kernels.
    mxu_tile: tuple[int, int, int] | None = None
    # Innermost contiguous extent in elements (lane dimension utilization).
    lane_extent: int = 128
    # Second-minor extent (sublane utilization, 8 for f32 / 16 for bf16).
    sublane_extent: int = 8
    unroll_ways: int = 1         # instruction-level parallelism factor
    reuse: float = 1.0           # >1.0 == extra HBM traffic (halo waste etc.)
    buffers: int = 2             # multiple-buffering depth (1 = no overlap)
    valid: bool = True           # False: config infeasible for this problem
    notes: dict = field(default_factory=dict)

    def scaled(self, **kw) -> "Workload":
        d = self.__dict__ | kw
        return Workload(**d)
