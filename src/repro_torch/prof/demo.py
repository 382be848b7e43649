"""End-to-end profiler demo.

Enables observability, attaches a :class:`~repro_torch.prof.Profiler` to
real :class:`~repro_torch.core.WisdomKernel` launches (matmul + the
advec_u stencil) on ``device`` — the card by default, ``"cpu"`` for the
plain versions — injects one artificially slow launch so drift detection
fires, and writes every artifact the profiler can produce: the profile
document, a Chrome trace with counter events, a metrics snapshot, and the
report: the launch profiles, then the attribution report over recorded
tuning spaces (read only). Port of ``repro.prof.demo``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from repro_torch.obs import runtime as obs
from repro_torch.obs.metrics import save_snapshot
from repro_torch.obs.trace import validate_trace

from .profiler import Profiler, save_profiles
from .report import render_attribution, render_profiles


def run_demo(out_dir: str | Path = "prof-demo",
             device: str | torch.device = "cuda",
             dataset_glob: str = "benchmarks/datasets/*.space.json"
             ) -> dict:
    """Run the instrumented profiler demo; returns artifact paths plus
    the rendered report text.

    Example::

        art = run_demo("/tmp/prof-demo", device="cpu")
        print(art["report"])
    """
    import glob as _glob

    from repro_torch.core.device import current_device_kind, resolve_device
    from repro_torch.core.registry import get_kernel
    from repro_torch.core.wisdom_kernel import WisdomKernel
    from repro_torch.kernels.ops import pack_scalars
    from repro_torch.tunebench.dataset import SpaceDataset

    dev = resolve_device(device)
    kind = current_device_kind(dev)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    registry, tracer = obs.enable()
    profiler = Profiler(sample_every=2)
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    mm = WisdomKernel(get_kernel("matmul"), wisdom_dir=out / "wisdom",
                      device_kind=kind)
    mm.attach_profiler(profiler)
    a, b = rand(64, 64), rand(64, 64)
    for _ in range(6):
        mm(a, b)

    adv = WisdomKernel(get_kernel("advec_u"), wisdom_dir=out / "wisdom",
                       device_kind=kind)
    adv.attach_profiler(profiler)
    u, v, w = rand(32, 32, 32), rand(32, 32, 32), rand(32, 32, 32)
    for _ in range(4):
        adv(u, v, w, pack_scalars(1.0, 1.0, 1.0, dev))

    # Drift injection: replay the slowest sampled matmul launch at 10x
    # its latency against the fastest as baseline — the drift path
    # (metric + instant event) must light up in the artifacts.
    samples = [p for p in profiler.profiles if p.kernel == "matmul"]
    if samples:
        base = min(p.latency_us for p in samples)
        slow = samples[-1]
        profiler.record(type(slow)(**{
            **slow.__dict__, "latency_us": base * 10,
            "baseline_us": base, "drift": 10.0}))

    prof_path = save_profiles(out / "profiles.prof.json",
                              profiler.profiles)
    trace_path = tracer.save(out / "trace.json")
    errors = validate_trace(tracer.to_chrome())
    if errors:
        raise AssertionError(f"demo trace invalid: {errors[:3]}")
    snap_path = save_snapshot(registry.snapshot(), out / "snapshot.json")

    datasets = [SpaceDataset.load(p)
                for p in sorted(_glob.glob(dataset_glob))]
    report = (render_profiles(profiler.profiles)
              + "\n" + render_attribution(datasets))
    report_path = out / "report.txt"
    report_path.write_text(report)
    return {
        "profiles": str(prof_path),
        "trace": str(trace_path),
        "snapshot": str(snap_path),
        "report_path": str(report_path),
        "report": report,
        "n_profiles": len(profiler.profiles),
        "drift_events": profiler.drift_events,
    }
