"""Bottleneck-attribution report — rendering profiles into decisions.

:func:`render_profiles` summarizes saved :class:`KernelProfile` documents
(a serving host's sampled launches) — per-kernel bottleneck mix, achieved
roofline fraction, and drift counts. It is a pure function of its input:
same documents, same bytes. Port of ``repro.prof.report``.

The reference's other renderer reads recorded tuning-space datasets and
the profile-guided surrogate, which need ``repro.tunebench`` (ROADMAP.md
queue 1 item 13) and the fitted cost model (item 5); until those are
ported :func:`classify_dataset` and :func:`render_attribution` raise.
"""

from __future__ import annotations

from .profile import KernelProfile
from .profiler import summarize


def _section(lines: list[str], title: str) -> None:
    if lines and lines[-1] != "":
        lines.append("")
    lines.append(title)
    lines.append("-" * len(title))


def classify_dataset(dataset) -> dict:
    """Scenario-level bottleneck attribution for one recorded space: not
    ported yet, recorded spaces need ``repro.tunebench``."""
    raise NotImplementedError(
        "classify_dataset reads recorded tuning spaces, which need "
        "repro.tunebench: not ported yet (ROADMAP.md queue 1 item 13)")


def render_attribution(datasets, rerank: bool = True) -> str:
    """The recorded-space bottleneck report: not ported yet, it needs
    recorded spaces and the fitted cost model."""
    raise NotImplementedError(
        "render_attribution reads recorded tuning spaces (repro.tunebench, "
        "ROADMAP.md queue 1 item 13) and the fitted cost model (item 5), "
        "neither ported yet")


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
