"""Device capability model: how performance moves between device families.

Cross-vendor auto-tuning studies (Lurati et al., "Bringing Auto-tuning to
HIP"; the paper's own A4000/A100 portability tables) show tuned configs
transfer with a quality loss that tracks how *similar* the two devices
are along a handful of capability axes: compute throughput, memory
bandwidth, on-chip memory capacity, launch overhead. :class:`DeviceModel`
reduces a (source, target) device pair to exactly those ratios
(:func:`repro_torch.core.device.capability_vector`), which the transfer
predictor uses two ways:

* **calibration** — scale a source-grounded score prediction to the
  target's balance point (compute-bound work moves with the FLOP/s
  ratio, streaming work with the bandwidth ratio);
* **similarity** — a scalar in (0, 1] that decays with the norm of the
  log capability ratios, feeding the confidence gate: predicting
  tpu-v5e -> tpu-v4 is credible, predicting tpu -> cpu is not.

Port of ``repro.transfer.model``, with one repair. The port's ``gpu-h100``
spec holds ``program_overhead`` at 0.0 (no per-block overhead was measured
on the card), and the reference's formula takes ``log2(0)`` onto the H100
and divides by 0 from it. An axis that is 0 on either side was not
measured, so :meth:`DeviceModel.ratios` leaves it out and the RMS runs over
the axes that remain (:meth:`DeviceModel.unmeasured_axes` names the ones
left out). For every pair without such an axis the numbers are the
reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.device import (CAPABILITY_AXES, DeviceSpec,
                                     capability_vector, get_device)

__all__ = ["BACKEND_MISMATCH_PENALTY", "ESTIMATED_SIMILARITY_CAP",
           "DeviceModel"]

#: Similarity multiplier when source and target use different lowering
#: backends (tpu vs gpu vs cpu). Capability ratios cannot see an
#: instruction-set change — a GPU with TPU-like peaks still runs a
#: Triton lowering with a different tiling granule, scheduling model,
#: and memory hierarchy — so cross-backend predictions carry a flat
#: penalty on top of the ratio-derived similarity. The paper's pair
#: (A4000 -> A100) transfers *within* a backend; across backends the
#: confidence must reflect that the evidence is one abstraction weaker.
BACKEND_MISMATCH_PENALTY = 0.5

#: Similarity ceiling when either spec is ``estimated`` (unknown
#: hardware whose peaks were cloned from a backend baseline). The cap
#: is chosen so the best possible confidence — sqrt(cap) x 1.0 ≈ 0.22 —
#: stays below ``TRANSFER_MIN_CONFIDENCE`` (0.30): a prediction scaled
#: through guessed capability ratios must never be *served*, only
#: surfaced for verification.
ESTIMATED_SIMILARITY_CAP = 0.05


@dataclass(frozen=True)
class DeviceModel:
    """Capability ratios between a tuned *source* device and an untuned
    *target* device.

    All quantities derive from the two specs' capability vectors; the
    model is symmetric up to inversion and completely deterministic.

    Example::

        m = DeviceModel.between("gpu-a100", "gpu-h100")
        m.similarity()          # ~0.02: the vmem and f32 axes disagree
        m.compute_ratio("bfloat16"), m.bandwidth_ratio()
    """

    source: DeviceSpec
    target: DeviceSpec

    @staticmethod
    def between(source_kind: str, target_kind: str) -> "DeviceModel":
        """Build a model from two device kind strings (table lookup or
        prefix-derived spec for unknown real hardware)."""
        return DeviceModel(get_device(source_kind), get_device(target_kind))

    # -- ratios (target / source: >1 means the target is stronger) ------------

    def unmeasured_axes(self) -> tuple[str, ...]:
        """Capability axes that are 0 on either side (not measured for
        that part), in ``CAPABILITY_AXES`` order; :meth:`ratios` and
        :meth:`similarity` leave them out."""
        src = capability_vector(self.source)
        tgt = capability_vector(self.target)
        return tuple(axis for axis, s, t in zip(CAPABILITY_AXES, src, tgt)
                     if s == 0 or t == 0)

    def ratios(self) -> dict[str, float]:
        """Per-axis target/source capability ratios, keyed by
        ``CAPABILITY_AXES``, without the :meth:`unmeasured_axes`."""
        src = capability_vector(self.source)
        tgt = capability_vector(self.target)
        return {axis: t / s for axis, s, t in
                zip(CAPABILITY_AXES, src, tgt) if s != 0 and t != 0}

    def compute_ratio(self, dtype: str) -> float:
        """FLOP/s ratio at ``dtype`` precision (compute-bound scaling)."""
        if dtype in ("bfloat16", "float16"):
            return self.target.flops_bf16 / self.source.flops_bf16
        return self.target.flops_f32 / self.source.flops_f32

    def bandwidth_ratio(self) -> float:
        """HBM bandwidth ratio (memory-bound scaling)."""
        return self.target.hbm_bw / self.source.hbm_bw

    def vmem_ratio(self) -> float:
        """On-chip memory ratio — the *feasibility* axis: configs sized
        for a larger VMEM overflow a smaller one."""
        return self.target.vmem_bytes / self.source.vmem_bytes

    def blend_ratio(self, dtype: str) -> float:
        """Capability-only time-scaling guess when no workload model is
        available: the geometric mean of the compute and bandwidth
        scalings (a kernel is somewhere between compute- and
        memory-bound; without its workload we cannot know where)."""
        return 1.0 / math.sqrt(self.compute_ratio(dtype)
                               * self.bandwidth_ratio())

    # -- similarity --------------------------------------------------------

    def backend_penalty(self) -> float:
        """1.0 when source and target share a lowering backend,
        :data:`BACKEND_MISMATCH_PENALTY` otherwise. Exposed separately
        so the predictor can record it in a result's components — the
        regression surface for "no cross-backend record is ever served
        without the penalty applied"."""
        if self.source.backend == self.target.backend:
            return 1.0
        return BACKEND_MISMATCH_PENALTY

    def estimated(self) -> bool:
        """True when either endpoint's peaks are guesses (see
        ``DeviceSpec.estimated``)."""
        return bool(self.source.estimated or self.target.estimated)

    def similarity(self) -> float:
        """Capability similarity in (0, 1]: ``exp(-rms(log2 ratios))``,
        times :meth:`backend_penalty` for cross-backend pairs, capped at
        :data:`ESTIMATED_SIMILARITY_CAP` when either spec is estimated.

        1.0 for identical specs; ~0.5 for the shipped tpu-v5e/tpu-v4
        pair (sibling accelerators, 1.4-2x apart per axis); ~0.2 for
        tpu-v5e -> gpu-a100 (comparable peaks, different backend);
        effectively 0 for tpu -> cpu (orders of magnitude apart
        everywhere, and a different backend on top). The RMS over axes
        keeps the scale independent of how many capability axes exist.
        The estimated cap floors the resulting confidence below the
        serving gate — ratios against guessed peaks are not evidence.
        Axes not measured on one side (:meth:`unmeasured_axes`) do not
        enter the RMS.
        """
        logs = [math.log2(r) for r in self.ratios().values()]
        rms = math.sqrt(sum(x * x for x in logs) / len(logs))
        sim = math.exp(-rms) * self.backend_penalty()
        if self.estimated():
            sim = min(sim, ESTIMATED_SIMILARITY_CAP)
        return sim
