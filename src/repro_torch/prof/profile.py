"""KernelProfile — the versioned join of a measured launch and its roofline.

A profile answers *why* a launch is fast or slow, not just how long it
took: it pairs the measured (or simulated) latency with the
roofline-derived counters the workload hook and device capability vector
already know — FLOPs, HBM bytes, collective bytes, arithmetic intensity,
VMEM pressure — and classifies the launch as compute-, memory-, or
collective-bound by comparing the three roofline time terms
(:func:`classify_bottleneck`). ``roofline_fraction`` says how much of
the roofline bound the launch achieved (1.0 = running at the roof);
``drift`` compares the latency against the wisdom-recorded baseline for
the scenario, so a serving host notices when a tuned config stops
delivering its tuned latency.

Like wisdom files and datasets, the JSON form is versioned
(``PROFILE_VERSION``) and documents from a newer schema are refused
loudly (:class:`ProfileVersionError`). This module is import-leaf
(``repro_torch.core.device`` only), so the tuner can import it without
cycles.

A copy of ``repro.prof.profile``: :func:`profile_from_workload` and
:class:`KernelProfile` are the reference's, so the same workload numbers
and peaks give byte-identical profile JSON in both packages. The peak is
picked by the launch's dtype: a bfloat16 launch is held to the tensor-core
peak even where its kernel computes in float32 on the CUDA cores (the
stencils); those kernels are bound by bytes, so their roofline fraction is
the same either way.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.core.device import DeviceSpec

#: Current schema version for serialized profiles. v1: the initial
#: roofline-counter layout below.
PROFILE_VERSION = 1

#: Latency-vs-baseline ratio at which a profile reports drift: a launch
#: taking 1.5x its wisdom-recorded score is no longer serving its tuned
#: latency (compile regressions, contention, stale wisdom).
DRIFT_THRESHOLD = 1.5

#: Bottleneck classes, in tie-break preference order (ties go to the
#: earlier class, matching ``roofline.analysis.roofline_report``).
BOTTLENECKS = ("compute", "memory", "collective")

#: Numeric feature columns a profile contributes to the tuner surrogate,
#: in order (see :func:`profile_feature_vector`). Deliberately excludes
#: the measured latency and anything derived from it — features must be
#: computable *before* a config runs, or the surrogate is just reading
#: the answer off the measurement.
PROFILE_FEATURES = ("log_compute_us", "log_memory_us", "log_collective_us",
                    "log_arithmetic_intensity", "vmem_fraction", "log_grid")


class ProfileVersionError(ValueError):
    """A serialized profile declares a schema version this build cannot
    handle. Raised for documents from the *future* (version >
    ``PROFILE_VERSION``): silently misreading roofline counters would
    poison every report and surrogate fit built on them, so loading
    refuses loudly instead.

    Example::

        try:
            profiles = load_profiles("fleet-host.prof.json")
        except ProfileVersionError:
            ...   # newer build wrote it; upgrade before reading
    """


def classify_bottleneck(compute_us: float, memory_us: float,
                        collective_us: float = 0.0) -> str:
    """Which roofline term dominates: ``"compute"``, ``"memory"``, or
    ``"collective"``. Ties resolve to the earlier class in
    :data:`BOTTLENECKS`, so classification is deterministic.

    Example::

        classify_bottleneck(120.0, 80.0)     # -> "compute"
        classify_bottleneck(10.0, 45.0, 5.0) # -> "memory"
    """
    terms = dict(zip(BOTTLENECKS, (float(compute_us), float(memory_us),
                                   float(collective_us))))
    return max(BOTTLENECKS, key=lambda k: (terms[k], ))


def _r(x: float) -> float:
    return round(float(x), 6)


@dataclass
class KernelProfile:
    """One profiled launch: measured latency joined with its roofline.

    ``compute_us``/``memory_us``/``collective_us`` are the per-launch
    roofline time terms (FLOPs over peak, HBM bytes over bandwidth,
    collective bytes over link bandwidth); ``bottleneck`` names the
    dominant one; ``roofline_fraction`` is the bound over the measured
    latency (how close to the roof the launch came);
    ``achieved_flops_frac``/``achieved_bw_frac`` are the fractions of
    peak compute / bandwidth actually sustained. ``baseline_us`` is the
    wisdom-recorded score for the scenario when one exists, and
    ``drift`` the latency/baseline ratio (``has_drift()`` applies
    :data:`DRIFT_THRESHOLD`).

    Example::

        p = profile_from_workload(w, device, "float32", latency_us=412.7)
        p.bottleneck          # "compute" for a well-blocked matmul
        p.roofline_fraction   # 0.83 -> 17% left on the table
    """

    kernel: str
    device_kind: str
    problem_size: tuple[int, ...]
    dtype: str
    config: dict = field(default_factory=dict)
    tier: str = ""
    latency_us: float = 0.0
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    vmem_bytes: int = 0
    grid: int = 0
    arithmetic_intensity: float = 0.0
    vmem_fraction: float = 0.0
    compute_us: float = 0.0
    memory_us: float = 0.0
    collective_us: float = 0.0
    bottleneck: str = "compute"
    roofline_fraction: float = 0.0
    achieved_flops_frac: float = 0.0
    achieved_bw_frac: float = 0.0
    baseline_us: float | None = None
    drift: float | None = None
    #: True when the device's peaks are guesses cloned from a backend
    #: baseline (``DeviceSpec.estimated``): every roofline fraction and
    #: bottleneck class below is then relative to *assumed* roofs and
    #: reports must say so.
    estimated: bool = False

    def scenario_key(self) -> tuple:
        return (self.device_kind, self.problem_size, self.dtype)

    def has_drift(self, threshold: float = DRIFT_THRESHOLD) -> bool:
        """Whether the measured latency drifted past ``threshold`` times
        the wisdom-recorded baseline (False when no baseline exists).

        Example::

            if profile.has_drift():
                alert(profile.kernel, profile.drift)
        """
        return self.drift is not None and self.drift >= threshold

    def to_json(self) -> dict:
        """Versioned, JSON-safe, deterministically rounded document."""
        out = {
            "version": PROFILE_VERSION,
            "kernel": self.kernel,
            "device_kind": self.device_kind,
            "problem_size": [int(d) for d in self.problem_size],
            "dtype": self.dtype,
            "config": dict(self.config),
            "tier": self.tier,
            "latency_us": _r(self.latency_us),
            "flops": _r(self.flops),
            "hbm_bytes": _r(self.hbm_bytes),
            "collective_bytes": _r(self.collective_bytes),
            "vmem_bytes": int(self.vmem_bytes),
            "grid": int(self.grid),
            "arithmetic_intensity": _r(self.arithmetic_intensity),
            "vmem_fraction": _r(self.vmem_fraction),
            "compute_us": _r(self.compute_us),
            "memory_us": _r(self.memory_us),
            "collective_us": _r(self.collective_us),
            "bottleneck": self.bottleneck,
            "roofline_fraction": _r(self.roofline_fraction),
            "achieved_flops_frac": _r(self.achieved_flops_frac),
            "achieved_bw_frac": _r(self.achieved_bw_frac),
        }
        if self.baseline_us is not None:
            out["baseline_us"] = _r(self.baseline_us)
        if self.drift is not None:
            out["drift"] = _r(self.drift)
        if self.estimated:
            out["estimated"] = True
        return out

    @staticmethod
    def from_json(d: dict, source: str = "<memory>") -> "KernelProfile":
        """Inverse of :meth:`to_json`; refuses future schema versions.

        Example::

            p = KernelProfile.from_json(json.load(open("x.prof.json")))
        """
        try:
            version = int(d.get("version", 1))
        except (TypeError, ValueError):
            raise ProfileVersionError(
                f"profile {source} declares non-integer version "
                f"{d.get('version')!r}") from None
        if version > PROFILE_VERSION:
            raise ProfileVersionError(
                f"profile {source} has version {version}, but this build "
                f"understands at most {PROFILE_VERSION}")
        baseline = d.get("baseline_us")
        drift = d.get("drift")
        return KernelProfile(
            kernel=str(d["kernel"]),
            device_kind=str(d["device_kind"]),
            problem_size=tuple(int(x) for x in d["problem_size"]),
            dtype=str(d["dtype"]),
            config=dict(d.get("config", {})),
            tier=str(d.get("tier", "")),
            latency_us=float(d.get("latency_us", 0.0)),
            flops=float(d.get("flops", 0.0)),
            hbm_bytes=float(d.get("hbm_bytes", 0.0)),
            collective_bytes=float(d.get("collective_bytes", 0.0)),
            vmem_bytes=int(d.get("vmem_bytes", 0)),
            grid=int(d.get("grid", 0)),
            arithmetic_intensity=float(d.get("arithmetic_intensity", 0.0)),
            vmem_fraction=float(d.get("vmem_fraction", 0.0)),
            compute_us=float(d.get("compute_us", 0.0)),
            memory_us=float(d.get("memory_us", 0.0)),
            collective_us=float(d.get("collective_us", 0.0)),
            bottleneck=str(d.get("bottleneck", "compute")),
            roofline_fraction=float(d.get("roofline_fraction", 0.0)),
            achieved_flops_frac=float(d.get("achieved_flops_frac", 0.0)),
            achieved_bw_frac=float(d.get("achieved_bw_frac", 0.0)),
            baseline_us=None if baseline is None else float(baseline),
            drift=None if drift is None else float(drift),
            estimated=bool(d.get("estimated", False)),
        )


def profile_from_workload(w, device: DeviceSpec, dtype: str,
                          latency_us: float, *, kernel: str = "",
                          problem_size: tuple[int, ...] = (),
                          config: dict | None = None, tier: str = "",
                          collective_bytes: float = 0.0,
                          baseline_us: float | None = None
                          ) -> KernelProfile:
    """Join one launch's measured latency with its roofline counters.

    ``w`` is the kernel's :class:`~repro_torch.core.workload.Workload` for the
    launched config (the same object the analytical cost model consumes,
    so profiling adds no second hardware model); ``device`` supplies the
    peaks from its capability vector. Pure and deterministic — same
    inputs, same profile.

    Example::

        w = builder.make_workload(config, (256, 256, 256), "float32")
        p = profile_from_workload(w, get_device("tpu-v5e"), "float32",
                                  latency_us=412.7, kernel="matmul")
    """
    peak = (device.flops_bf16 if dtype in ("bfloat16", "float16")
            else device.flops_f32)
    compute_us = float(w.flops) / peak * 1e6
    memory_us = float(w.hbm_bytes) / device.hbm_bw * 1e6
    collective_us = float(collective_bytes) / device.ici_bw * 1e6
    bound_us = max(compute_us, memory_us, collective_us)
    lat = float(latency_us)
    ai = float(w.flops) / max(float(w.hbm_bytes), 1.0)
    vmem_frac = float(w.vmem_bytes) / max(float(device.vmem_bytes), 1.0)
    drift = (lat / baseline_us
             if baseline_us is not None and baseline_us > 0 else None)
    return KernelProfile(
        kernel=kernel, device_kind=device.kind,
        problem_size=tuple(int(d) for d in problem_size),
        dtype=dtype, config=dict(config or {}), tier=tier,
        latency_us=_r(lat),
        flops=_r(w.flops), hbm_bytes=_r(w.hbm_bytes),
        collective_bytes=_r(collective_bytes),
        vmem_bytes=int(w.vmem_bytes), grid=int(w.grid),
        arithmetic_intensity=_r(ai), vmem_fraction=_r(vmem_frac),
        compute_us=_r(compute_us), memory_us=_r(memory_us),
        collective_us=_r(collective_us),
        bottleneck=classify_bottleneck(compute_us, memory_us,
                                       collective_us),
        roofline_fraction=_r(bound_us / lat if lat > 0 else 0.0),
        achieved_flops_frac=_r(compute_us / lat if lat > 0 else 0.0),
        achieved_bw_frac=_r(memory_us / lat if lat > 0 else 0.0),
        baseline_us=None if baseline_us is None else _r(baseline_us),
        drift=None if drift is None else _r(drift),
        estimated=bool(device.estimated),
    )


def profile_fields(profile: KernelProfile) -> dict:
    """The compact per-config dict a tuning dataset stores with each
    evaluation: the pre-measurement roofline counters plus the
    bottleneck class — everything the surrogate's feature columns need,
    nothing the entry already records (config, score).

    Example::

        ds.add(config, r.score_us, "ok")           # via EvalResult.info:
        r.info["profile"] = profile_fields(p)      # evaluators do this
    """
    return {
        "flops": _r(profile.flops),
        "hbm_bytes": _r(profile.hbm_bytes),
        "collective_bytes": _r(profile.collective_bytes),
        "vmem_bytes": int(profile.vmem_bytes),
        "grid": int(profile.grid),
        "arithmetic_intensity": _r(profile.arithmetic_intensity),
        "vmem_fraction": _r(profile.vmem_fraction),
        "compute_us": _r(profile.compute_us),
        "memory_us": _r(profile.memory_us),
        "collective_us": _r(profile.collective_us),
        "bottleneck": profile.bottleneck,
    }


def profile_feature_vector(fields: dict) -> list[float]:
    """Numeric surrogate feature columns from a profile-fields dict, in
    :data:`PROFILE_FEATURES` order. Log-compresses the time terms and
    intensities (they span orders of magnitude across a config space)
    and tolerates missing keys (zeros), so a dataset mixing profiled
    and unprofiled entries still fits.

    Example::

        x = profile_feature_vector(entry.profile)   # len == 6
    """
    def lg(key: str) -> float:
        try:
            return math.log1p(max(float(fields.get(key, 0.0)), 0.0))
        except (TypeError, ValueError):
            return 0.0

    try:
        vmem_frac = float(fields.get("vmem_fraction", 0.0))
    except (TypeError, ValueError):
        vmem_frac = 0.0
    return [lg("compute_us"), lg("memory_us"), lg("collective_us"),
            lg("arithmetic_intensity"), vmem_frac, lg("grid")]
