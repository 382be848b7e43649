"""Bottleneck-attribution report — rendering profiles into decisions.

Two deterministic text renderers:

* :func:`render_attribution` reads recorded tuning-space datasets (whose
  entries the always-on tuner profiling stamped with roofline counters)
  and classifies each *scenario* by the bottleneck of its best —
  servable — config, alongside the space-wide bottleneck distribution
  and the profile-guided-surrogate comparison. This is the
  ``python -m repro_torch.prof report`` body and the CI byte-determinism
  artifact.
* :func:`render_profiles` summarizes saved :class:`KernelProfile`
  documents (a serving host's sampled launches) — per-kernel bottleneck
  mix, achieved roofline fraction, and drift counts.

Both are pure functions of their inputs: same documents, same bytes.
Port of ``repro.prof.report``: the same text, byte for byte.
"""

from __future__ import annotations

from repro_torch.core.device import get_device

from .guided import rerank_gate, surrogate_rerank
from .profile import KernelProfile
from .profiler import summarize


def _section(lines: list[str], title: str) -> None:
    if lines and lines[-1] != "":
        lines.append("")
    lines.append(title)
    lines.append("-" * len(title))


def classify_dataset(dataset) -> dict:
    """Scenario-level bottleneck attribution for one recorded space.

    The scenario's class is its *best config's* bottleneck — that is the
    config wisdom will serve, so its limiting resource is what an
    operator would provision for. The space-wide distribution is
    reported too (a space can be mostly memory-bound yet have a
    compute-bound optimum: the serving-scale matmul space is exactly
    that).

    Example::

        c = classify_dataset(SpaceDataset.load("matmul....space.json"))
        c["bottleneck"], c["distribution"]   # "compute", {"compute": 16,
                                             #  "memory": 240}
    """
    best = dataset.best()
    dist: dict[str, int] = {}
    intensities = []
    for e in dataset.feasible():
        prof = getattr(e, "profile", None) or {}
        b = prof.get("bottleneck")
        if b:
            dist[b] = dist.get(b, 0) + 1
        if "arithmetic_intensity" in prof:
            intensities.append(float(prof["arithmetic_intensity"]))
    bprof = (getattr(best, "profile", None) or {}) if best else {}
    bound_us = max(float(bprof.get("compute_us", 0.0)),
                   float(bprof.get("memory_us", 0.0)),
                   float(bprof.get("collective_us", 0.0)))
    return {
        "dataset": dataset.name(),
        "kernel": dataset.kernel,
        "scenario": dataset.scenario_key(),
        # Unknown hardware gets baseline-cloned peaks: every roofline
        # number below is then relative to *assumed* roofs.
        "estimated": bool(get_device(dataset.device_kind).estimated),
        "bottleneck": bprof.get("bottleneck", "unprofiled"),
        "best_us": round(best.score_us, 6) if best else None,
        "best_arithmetic_intensity": bprof.get("arithmetic_intensity"),
        "best_roofline_fraction": (round(bound_us / best.score_us, 6)
                                   if best and best.score_us > 0 else None),
        "distribution": {k: dist[k] for k in sorted(dist)},
        "mean_arithmetic_intensity": (
            round(sum(intensities) / len(intensities), 6)
            if intensities else None),
    }


def render_attribution(datasets, rerank: bool = True) -> str:
    """The recorded-space bottleneck report as text (see module
    docstring). ``rerank=False`` skips the surrogate comparison (for
    datasets too small to fit).

    Example::

        print(render_attribution([SpaceDataset.load(p)
                                  for p in sorted(glob("*.space.json"))]))
    """
    datasets = sorted(datasets, key=lambda d: d.name())
    lines: list[str] = []
    _section(lines, "Bottleneck attribution (best config per scenario)")
    if not datasets:
        lines.append("no recorded spaces given")
    for ds in datasets:
        c = classify_dataset(ds)
        dist = " ".join(f"{k}={v}" for k, v in c["distribution"].items())
        ai = c["best_arithmetic_intensity"]
        rf = c["best_roofline_fraction"]
        lines.append(
            f"{c['kernel']} {c['scenario']}: {c['bottleneck']}-bound "
            f"best={c['best_us']:.3f}us "
            f"AI={ai if ai is not None else '?'} "
            f"roofline-frac={f'{rf:.3f}' if rf is not None else '?'} "
            f"[space: {dist or 'unprofiled'}]"
            + (" (estimated peaks)" if c["estimated"] else ""))

    if rerank:
        _section(lines,
                 "Profile-guided surrogate (fraction of optimum @ budget)")
        for ds in datasets:
            try:
                r = surrogate_rerank(ds)
            except ValueError as e:
                lines.append(f"{ds.name()}: skipped ({e})")
                continue
            for row in r["surrogates"]:
                at = " ".join(f"@{b}={row['fraction_at'][str(b)]:.4f}"
                              for b in r["budgets"])
                lines.append(f"{ds.name()} {row['surrogate']:>7}: {at} "
                             f"fit-quality={row['fit_quality']:.3f}")
            problems = rerank_gate(r)
            lines.append(f"{ds.name()}    gate: "
                         f"{'PASS' if not problems else '; '.join(problems)}")
    return "\n".join(lines) + "\n"


def render_profiles(profiles: list[KernelProfile]) -> str:
    """Summarize saved launch profiles as text (per-kernel bottleneck
    mix, mean roofline fraction, drift count).

    Example::

        print(render_profiles(load_profiles("run.prof.json")))
    """
    lines: list[str] = []
    _section(lines, "Launch profiles (per kernel)")
    s = summarize(profiles)
    if not s:
        lines.append("no profiles recorded")
    for kernel, row in s.items():
        dist = " ".join(f"{k}={v}" for k, v in row["bottleneck"].items())
        lines.append(
            f"{kernel}: launches={row['launches']} "
            f"dominant={row['dominant']} [{dist}] "
            f"mean-roofline-frac={row['mean_roofline_fraction']:.3f} "
            f"mean-latency={row['mean_latency_us']:.3f}us "
            f"drifted={row['drifted']}"
            + (f" [estimated peaks: {row['estimated']}/{row['launches']}]"
               if row.get("estimated") else ""))
    return "\n".join(lines) + "\n"
