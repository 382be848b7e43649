"""Instrumented end-to-end demo: launches through every selection tier.

``run_demo`` enables observability, drives a ``WisdomKernel`` through a
scripted mix of selection tiers (exact hits, a served cross-device
transfer, scenario-distance fallbacks, cold default launches) on
``device`` (the card by default; ``"cpu"`` runs the plain versions), and
writes every artifact the ``python -m repro_torch.obs`` CLI knows how to
read:

* ``snapshot.json``        — this process's metric snapshot;
* ``fleet-snapshot.json``  — the same snapshot (the bus-aggregated one
  needs the fleet layer);
* ``trace.json``           — the Chrome trace (open in Perfetto);
* ``report.txt``           — the rendered wisdom-health report.

The launch mix is fixed, so the demo exercises every report section:
hit rates below 1.0, a transfer-confidence distribution, and a
non-empty top-missing-scenarios list. Port of ``repro.obs.demo``; its
local-fleet half needs ``repro.fleet``, which is not ported yet
(ROADMAP.md queue 1 item 13), so ``fleet=True`` raises.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from . import runtime
from .metrics import save_snapshot
from .report import render_report


def _seed_wisdom(wisdom_dir: Path, device_kind: str) -> None:
    from repro_torch.core.device import get_device
    from repro_torch.core.registry import get_kernel
    from repro_torch.core.wisdom import Wisdom, WisdomRecord, make_provenance
    family = get_device(device_kind).family
    default = get_kernel("matmul").default_config()
    w = Wisdom("matmul")
    w.add(WisdomRecord(
        device_kind=device_kind, device_family=family,
        problem_size=(64, 64, 64), dtype="float32",
        config=default | {"block_m": 64, "block_n": 64},
        score_us=104.2,
        provenance=make_provenance(strategy="exhaustive", evals=64,
                                   objective="wallclock")))
    # A cross-device prediction, as the transfer layer records one: the
    # provenance fields select() reads (source, confidence).
    w.add(WisdomRecord(
        device_kind=device_kind, device_family=family,
        problem_size=(128, 128, 128), dtype="float32",
        config=default | {"split_k": 2},
        score_us=96.0,
        provenance={"source": "transfer", "source_device": "gpu-a100",
                    "source_entries": 32, "confidence": 0.72,
                    "predicted_us": 96.0}))
    w.save(wisdom_dir)


def _mm(n: int, device: torch.device, dtype=torch.float32):
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    return a.to(device=device, dtype=dtype), b.to(device=device, dtype=dtype)


def run_demo(out_dir: Path | str, fleet: bool = False,
             device: str | torch.device = "cuda") -> dict:
    """Run the instrumented demo; returns {artifact: path} plus the
    rendered report text under ``"report"``.

    Example::

        art = run_demo("obs-demo", device="cpu")
        print(art["report"])
    """
    from repro_torch.core.device import current_device_kind, resolve_device
    from repro_torch.core.registry import get_kernel
    from repro_torch.core.wisdom_kernel import WisdomKernel

    if fleet:
        raise NotImplementedError(
            "the demo's local-fleet half needs repro.fleet, which is not "
            "ported yet (ROADMAP.md queue 1 item 13)")
    dev = resolve_device(device)
    kind = current_device_kind(dev)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    runtime.disable()                       # fresh registry + tracer
    reg, tracer = runtime.enable()

    wisdom_dir = out / "wisdom"
    _seed_wisdom(wisdom_dir, kind)
    builder = get_kernel("matmul")

    k = WisdomKernel(builder, wisdom_dir=wisdom_dir, device_kind=kind)
    for _ in range(3):                      # tier: exact
        k(*_mm(64, dev))
    for _ in range(2):                      # tier: transfer (confidence 0.72)
        k(*_mm(128, dev))
    for _ in range(2):                      # tier: transfer again — the
        k(*_mm(32, dev))                    # prediction outranks device+dtype
    for _ in range(2):                      # tier: device (bf16 untuned)
        k(*_mm(64, dev, torch.bfloat16))

    cold = WisdomKernel(builder, wisdom_dir=out / "wisdom-empty",
                        device_kind=kind)
    for _ in range(3):                      # tier: default (empty wisdom)
        cold(*_mm(48, dev))

    snap = reg.snapshot()
    artifacts = {
        "snapshot": str(save_snapshot(snap, out / "snapshot.json")),
        "fleet_snapshot": str(save_snapshot(snap,
                                            out / "fleet-snapshot.json")),
        "trace": str(tracer.save(out / "trace.json")),
    }
    report = render_report(snap)
    (out / "report.txt").write_text(report)
    artifacts["report_path"] = str(out / "report.txt")
    artifacts["report"] = report
    return artifacts
