"""The runtime profiler: sampled on the launch path, always-on in tuning.

A :class:`Profiler` collects :class:`~repro_torch.prof.profile.KernelProfile`
records and fans each one out to the telemetry the rest of the stack
already reads: ``prof.*`` metric series on the process registry (which
the fleet metrics bus ships and ``aggregate_fleet_metrics`` merges, so
bottleneck attribution aggregates fleet-wide for free) and Chrome
counter ("C") events on the process tracer (Perfetto renders
roofline-fraction / arithmetic-intensity tracks next to the launch
spans). Drift against the wisdom-recorded baseline raises a
``prof.drift`` counter plus an instant trace marker.

Sampling keeps it launch-path-safe: :meth:`Profiler.due` is one dict
increment + one modulo, and the expensive part (the workload hook) runs
only on sampled launches. The profiler never times anything: it takes
the latency the launch path already measured (``WisdomKernel``'s CUDA
events), so it adds no synchronisation and no second clock. Tuner
evaluations profile every config instead, because there the measurement
*is* the workload.

``KERNEL_LAUNCHER_PROF=1`` (or ``=N`` for a sample period) attaches a
process-wide profiler to every :class:`~repro_torch.core.WisdomKernel` at
construction, mirroring ``KERNEL_LAUNCHER_OBS``. Port of
``repro.prof.profiler``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch

from repro_torch.core.builder import KernelBuilder, dtype_name
from repro_torch.core.device import (DeviceSpec, current_device_kind,
                                     get_device)
from repro_torch.core.param import Config
from repro_torch.obs import runtime as obs
from repro_torch.obs.metrics import UNIT_BUCKETS

from .profile import (DRIFT_THRESHOLD, PROFILE_VERSION, KernelProfile,
                      profile_from_workload)

PROF_ENV = "KERNEL_LAUNCHER_PROF"

#: Default sampling period on the serving launch path: profile one
#: launch in 16, so the amortized workload-hook cost stays small.
DEFAULT_SAMPLE_EVERY = 16

#: Bound on in-memory retained profiles (oldest dropped first): a
#: long-lived serving process must not grow without limit. Telemetry
#: (metrics/trace) still sees every sampled launch.
MAX_PROFILES = 4096

_process_profiler: "Profiler | None" = None


def prof_requested() -> int:
    """Sampling period requested via ``KERNEL_LAUNCHER_PROF`` (0 = off).

    ``1``/``true``/``on``/``yes`` select :data:`DEFAULT_SAMPLE_EVERY`;
    an integer > 1 is used as the period directly (``...PROF=4`` →
    profile every 4th launch).

    Example::

        os.environ["KERNEL_LAUNCHER_PROF"] = "8"
        prof_requested()    # -> 8
    """
    raw = os.environ.get(PROF_ENV, "").strip().lower()
    if raw in ("", "0", "false", "off", "no"):
        return 0
    if raw in ("1", "true", "on", "yes"):
        return DEFAULT_SAMPLE_EVERY
    try:
        n = int(raw)
    except ValueError:
        return DEFAULT_SAMPLE_EVERY
    return max(1, n)


def process_profiler() -> "Profiler | None":
    """The ambient per-process profiler (created on first request when
    ``KERNEL_LAUNCHER_PROF`` is set, else None). One shared instance so
    every kernel's samples land in one place, like the obs registry.

    Example::

        pr = process_profiler()
        if pr is not None:
            print(len(pr.profiles), "profiles so far")
    """
    global _process_profiler
    if _process_profiler is None:
        every = prof_requested()
        if every:
            _process_profiler = Profiler(sample_every=every)
    return _process_profiler


def reset_process_profiler() -> None:
    """Drop the ambient per-process profiler so the environment is
    re-read on the next :func:`process_profiler` call — test isolation,
    mirroring ``obs.disable()``.

    Example::

        os.environ["KERNEL_LAUNCHER_PROF"] = "4"
        reset_process_profiler()
        process_profiler().sample_every   # -> 4
    """
    global _process_profiler
    _process_profiler = None


class Profiler:
    """Collects profiles and fans them out to metrics + trace.

    ``sample_every=N`` profiles every Nth launch per kernel (1 = every
    launch, the tuner setting). The profiler itself never times anything
    — callers hand it the latency they already measured, so attaching it
    adds no second clock to the hot path.

    Example::

        pr = Profiler(sample_every=4)
        kernel.attach_profiler(pr)
        ...
        for p in pr.profiles:
            print(p.kernel, p.bottleneck, p.roofline_fraction)
    """

    def __init__(self, sample_every: int = DEFAULT_SAMPLE_EVERY,
                 drift_threshold: float = DRIFT_THRESHOLD,
                 max_profiles: int = MAX_PROFILES) -> None:
        self.sample_every = max(1, int(sample_every))
        self.drift_threshold = float(drift_threshold)
        self.max_profiles = int(max_profiles)
        self.profiles: list[KernelProfile] = []
        self.dropped = 0
        self.drift_events = 0
        self._counts: dict[str, int] = {}

    def due(self, key: str) -> bool:
        """Hot-path sampling decision for launch stream ``key`` (one
        dict increment, one modulo). The first launch of every key is
        sampled, then every ``sample_every``-th after it.

        Example::

            if profiler.due("matmul"):
                ...   # compute the workload, profile this launch
        """
        n = self._counts.get(key, 0)
        self._counts[key] = n + 1
        return n % self.sample_every == 0

    def profile_launch(self, builder: KernelBuilder, config: Config,
                       problem: tuple[int, ...], dtype: str,
                       device: DeviceSpec | str, latency_us: float,
                       tier: str = "",
                       baseline_us: float | None = None
                       ) -> KernelProfile | None:
        """Profile one launch through the kernel's workload hook and
        record it. Returns None (and records nothing) for kernels with
        no workload hook or configs whose workload is invalid — the
        profiler never turns a served launch into an error.

        Example::

            p = pr.profile_launch(builder, cfg, (256, 256, 256),
                                  "float32", "tpu-v5e", latency_us=412.7,
                                  tier="exact", baseline_us=400.0)
        """
        if builder._workload is None:
            return None
        dev = get_device(device) if isinstance(device, str) else device
        try:
            w = builder.make_workload(config, problem, dtype)
        except Exception:  # noqa: BLE001 — profiling must not break serving
            return None
        if not getattr(w, "valid", True):
            return None
        p = profile_from_workload(
            w, dev, dtype, latency_us, kernel=builder.name,
            problem_size=problem, config=config, tier=tier,
            baseline_us=baseline_us)
        self.record(p)
        return p

    def record(self, profile: KernelProfile) -> None:
        """Retain ``profile`` (bounded by ``max_profiles``) and emit its
        telemetry: ``prof.launches{kernel,bottleneck}``,
        ``prof.roofline_fraction{kernel}``, a Chrome counter event, and
        — past ``drift_threshold`` — ``prof.drift{kernel}`` plus an
        instant trace marker.

        Example::

            pr.record(profile_from_workload(w, dev, "float32", 412.7))
        """
        self.profiles.append(profile)
        if len(self.profiles) > self.max_profiles:
            del self.profiles[:len(self.profiles) - self.max_profiles]
            self.dropped += 1
        drifted = profile.has_drift(self.drift_threshold)
        if drifted:
            self.drift_events += 1
        m = obs.metrics()
        if m is not None:
            m.counter("prof.launches", kernel=profile.kernel,
                      bottleneck=profile.bottleneck).inc()
            m.histogram("prof.roofline_fraction", UNIT_BUCKETS,
                        kernel=profile.kernel).observe(
                            min(profile.roofline_fraction, 1.0))
            if drifted:
                m.counter("prof.drift", kernel=profile.kernel).inc()
        tr = obs.tracer()
        if tr is not None:
            tr.counter(f"prof.{profile.kernel}", cat="prof",
                       roofline_fraction=profile.roofline_fraction,
                       arithmetic_intensity=profile.arithmetic_intensity,
                       achieved_flops_frac=profile.achieved_flops_frac,
                       achieved_bw_frac=profile.achieved_bw_frac)
            if drifted:
                tr.instant("prof.drift", cat="prof",
                           kernel=profile.kernel,
                           drift=profile.drift,
                           latency_us=profile.latency_us,
                           baseline_us=profile.baseline_us)


class StepProfiler:
    """Decode-step profiling for :class:`~repro_torch.serve.ServeEngine`.

    A decode step has no per-kernel workload hook, but its roofline is
    well known: every step streams the full parameter set from HBM
    (``hbm_bytes ≈ param bytes``) and does ``2 · params · slots`` FLOPs
    — small-batch decode is memory-bound, and the profile says by how
    much. The engine calls :meth:`due` each step and hands the sampled
    step's measured latency to :meth:`on_step`; the first sampled step
    becomes the drift baseline for the rest of the run.

    Example::

        pr = Profiler()
        eng = ServeEngine(model, params, profiler=StepProfiler(pr))
        eng.run()
        [p for p in pr.profiles if p.kernel == "serve.decode"]
    """

    def __init__(self, profiler: Profiler,
                 sample_every: int | None = None,
                 device: DeviceSpec | str | None = None) -> None:
        self.profiler = profiler
        self.sample_every = max(1, int(sample_every
                                       if sample_every is not None
                                       else profiler.sample_every))
        self._device = device
        self._baseline_us: float | None = None

    def bind(self, params, n_slots: int, max_seq: int) -> None:
        """One-time (at engine construction): derive the decode-step
        roofline counters from the parameter tree (nested dicts and lists
        of tensors), and the device kind from where the parameters live."""
        leaves = _tensor_leaves(params)
        self.param_bytes = float(sum(x.numel() * x.element_size()
                                     for x in leaves))
        self.param_count = float(sum(x.numel() for x in leaves))
        self.n_slots = int(n_slots)
        self.max_seq = int(max_seq)
        self.dtype = (dtype_name(leaves[0].dtype) if leaves else "float32")
        self._kind = current_device_kind(leaves[0].device if leaves
                                         else "cpu")

    def due(self, step: int) -> bool:
        """Whether to time + profile this decode step."""
        return step % self.sample_every == 0

    def on_step(self, latency_us: float) -> KernelProfile | None:
        """Record one sampled decode step as a profile."""
        if not hasattr(self, "param_bytes"):
            return None
        dev = self._device or self._kind
        dev = get_device(dev) if isinstance(dev, str) else dev
        from repro_torch.core.workload import Workload
        w = Workload(flops=2.0 * self.param_count * self.n_slots,
                     hbm_bytes=self.param_bytes,
                     vmem_bytes=0, grid=1)
        p = profile_from_workload(
            w, dev, self.dtype, latency_us, kernel="serve.decode",
            problem_size=(self.n_slots, self.max_seq),
            tier="serve", baseline_us=self._baseline_us)
        if self._baseline_us is None:
            self._baseline_us = p.latency_us
        self.profiler.record(p)
        return p


def _tensor_leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensor_leaves(v)]
    return []


def summarize(profiles: list[KernelProfile]) -> dict:
    """Deterministic aggregation for reports: per-kernel launch counts,
    bottleneck distribution, mean roofline fraction / arithmetic
    intensity, and drift counts, keyed and ordered by kernel name.

    Example::

        s = summarize(pr.profiles)
        s["matmul"]["bottleneck"]       # {"compute": 12, "memory": 3}
    """
    by_kernel: dict[str, list[KernelProfile]] = {}
    for p in profiles:
        by_kernel.setdefault(p.kernel, []).append(p)
    out: dict[str, dict] = {}
    for kernel in sorted(by_kernel):
        ps = by_kernel[kernel]
        bn: dict[str, int] = {}
        for p in ps:
            bn[p.bottleneck] = bn.get(p.bottleneck, 0) + 1
        n = len(ps)
        out[kernel] = {
            "launches": n,
            "bottleneck": {k: bn[k] for k in sorted(bn)},
            "dominant": max(sorted(bn), key=lambda k: bn[k]),
            "mean_roofline_fraction": round(
                sum(p.roofline_fraction for p in ps) / n, 6),
            "mean_arithmetic_intensity": round(
                sum(p.arithmetic_intensity for p in ps) / n, 6),
            "mean_latency_us": round(
                sum(p.latency_us for p in ps) / n, 6),
            "drifted": sum(1 for p in ps if p.has_drift()),
            "estimated": sum(1 for p in ps if p.estimated),
        }
    return out


def save_profiles(path: Path | str,
                  profiles: list[KernelProfile]) -> Path:
    """Write a versioned, byte-deterministic profile document.

    Example::

        save_profiles("run.prof.json", pr.profiles)
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = {"version": PROFILE_VERSION,
           "profiles": [p.to_json() for p in profiles]}
    path.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    return path


def load_profiles(path: Path | str) -> list[KernelProfile]:
    """Read a profile document written by :func:`save_profiles`
    (per-profile version checks included).

    Example::

        profiles = load_profiles("run.prof.json")
    """
    path = Path(path)
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "profiles" not in doc:
        raise ValueError(f"{path} is not a profile document")
    return [KernelProfile.from_json(d, source=str(path))
            for d in doc["profiles"]]
