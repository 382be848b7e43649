"""Analytical cost model — a kernel time from a workload, with no launch.

Port of ``repro.tuner.costmodel``, term for term. The model prices one
kernel launch described by a :class:`~repro_torch.core.workload.Workload`
on a :class:`~repro_torch.core.device.DeviceSpec`:

  t_compute    = flops / (peak · mxu_eff · ilp_eff)
  t_memory     = hbm_bytes · reuse / (bw · stream_eff)
  t            = max(t_compute, t_memory)        (double-buffered overlap)
                 or t_compute + t_memory          (buffers == 1)
  t           += grid · program_overhead          (per-program fixed cost)
  infeasible if the per-program working set exceeds spill_grace × the
  device's ``vmem_bytes`` (a block's shared memory on the H100).

Efficiencies: matmul-unit tiles pad to ``DeviceSpec.matmul_granule``
(16 on the H100's tensor cores); vector work runs at the peak over
``vector_ratio`` with lane/sublane alignment; unrolling buys
instruction-level parallelism up to ``pipeline_depth``; streaming
efficiency grows with the contiguous extent of each transfer up to 512 B.

A deterministic, config-hashed multiplicative noise term (σ ≈ 5 %) makes
the landscape rugged but reproducible; for the same workload, device kind,
dtype and key it gives the reference's number bit for bit.

In the port the model is the screening objective of the online tuner
(``repro_torch.online``) and the offline ``objective="costmodel"``: it
ranks candidates before any of them is launched, and the card's CUDA-event
times decide. Its inputs on the H100 are the kernels' workload hooks: the
stencils' ``reuse`` is their launch plan's staged-to-computed ratio, matmul
and flash attention give their tiles (``kernels/*.py``). ``FittedCostModel``
and ``fit_from_dataset`` wait for ``tunebench`` (ROADMAP.md).
"""

from __future__ import annotations

import hashlib
import math
import struct
from dataclasses import dataclass

from repro_torch.core.device import DeviceSpec
from repro_torch.core.workload import Workload

INFEASIBLE = float("inf")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _align_eff(dim: int, granule: int) -> float:
    if dim <= 0:
        return 1e-6
    return dim / _round_up(dim, granule)


def _hash_noise(key: str, sigma: float) -> float:
    """Deterministic lognormal-ish multiplicative noise from a string key."""
    h = hashlib.sha256(key.encode()).digest()
    # two uniform floats from the hash -> one gaussian via Box-Muller
    u1 = (struct.unpack("<Q", h[:8])[0] / 2**64) or 1e-12
    u2 = struct.unpack("<Q", h[8:16])[0] / 2**64
    z = math.sqrt(-2.0 * math.log(u1)) * math.cos(2 * math.pi * u2)
    return math.exp(sigma * z)


@dataclass(frozen=True)
class CostModel:
    """Analytical objective for one device.

    ``time(workload, dtype)`` returns modelled seconds for one launch
    (``INFEASIBLE`` when the working set blows past the spill grace),
    combining roofline compute/memory terms, alignment and ILP
    efficiencies, per-program overhead, and a deterministic config-hashed
    noise term (see the module docstring for the formulas).

    Example::

        m = CostModel(get_device("gpu-h100"), noise_sigma=0)
        t = m.time(builder.make_workload(cfg, (512,) * 3, "float32"),
                   "float32")
    """

    device: DeviceSpec
    noise_sigma: float = 0.05
    pipeline_depth: int = 4      # stages hidden by full unrolling

    def peak_flops(self, dtype: str) -> float:
        if dtype in ("bfloat16", "float16"):
            return self.device.flops_bf16
        return self.device.flops_f32

    # Up to 4x overflow of the per-program capacity degrades (the TPU
    # analogue of register spilling); beyond that the config is
    # uncompilable.
    spill_grace: float = 4.0
    spill_slope: float = 3.0

    def time(self, w: Workload, dtype: str, noise_key: str = "") -> float:
        """Modelled seconds for one launch; INFEASIBLE when the working
        set exceeds spill_grace x the device's per-program capacity."""
        if not w.valid:
            return INFEASIBLE
        overflow = w.vmem_bytes / self.device.vmem_bytes - 1.0
        if overflow > self.spill_grace - 1.0:
            return INFEASIBLE
        peak = self.peak_flops(dtype)

        # --- compute term ---
        if w.mxu_tile is not None:
            # matmul-unit tiles pad to the device's granule (128 on the
            # TPU systolic array, 16 on GPU tensor cores)
            g = self.device.matmul_granule
            m, n, k = w.mxu_tile
            eff = (_align_eff(m, g) * _align_eff(n, g)
                   * _align_eff(k, g))
            eff = max(eff, 0.02)
        else:
            # vector work: (8, 128) native tile
            eff = _align_eff(w.lane_extent, 128) * _align_eff(
                w.sublane_extent, 8)
            # the vector unit peaks below the matmul unit (per device)
            peak = peak / self.device.vector_ratio
        ilp = min(1.0, (0.55 + 0.45 * min(w.unroll_ways, self.pipeline_depth)
                        / self.pipeline_depth))
        t_compute = w.flops / (peak * eff * ilp)

        # --- memory term ---
        dtype_bytes = 2 if dtype in ("bfloat16", "float16") else 4
        contig = w.lane_extent * dtype_bytes
        stream_eff = min(1.0, contig / 512.0) ** 0.5
        stream_eff = max(stream_eff, 0.05)
        t_memory = (w.hbm_bytes * max(w.reuse, 1e-6)
                    / (self.device.hbm_bw * stream_eff))

        if w.buffers >= 2:
            t = max(t_compute, t_memory)
            # imperfect overlap: the loser still costs a fraction
            t += 0.08 * min(t_compute, t_memory)
        else:
            t = t_compute + t_memory
        t += w.grid * self.device.program_overhead
        if overflow > 0:
            t *= 1.0 + self.spill_slope * overflow

        if self.noise_sigma > 0 and noise_key:
            t *= _hash_noise(f"{self.device.kind}|{noise_key}",
                             self.noise_sigma)
        return t


def kernel_time(workload: Workload, device: DeviceSpec, dtype: str,
                noise_key: str = "") -> float:
    """One-shot convenience: modelled seconds for one launch on ``device``
    (a fresh default :class:`CostModel` each call).

    Example::

        t = kernel_time(builder.make_workload(cfg, problem, "float32"),
                        get_device("gpu-h100"), "float32")
    """
    return CostModel(device).time(workload, dtype, noise_key)
