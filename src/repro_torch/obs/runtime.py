"""The observability on/off switch and process-wide default instances.

Instrument sites all follow one pattern::

    from repro_torch import obs
    m = obs.metrics()
    if m is not None:
        m.counter("launch.count", kernel=name).inc()

When observability is disabled (the default) ``metrics()``/``tracer()``
return ``None`` — the per-event cost is one module-global read plus one
``is not None`` branch, so instrumentation can sit directly on the launch
hot path. A copy of ``repro.obs.runtime``.

Enable explicitly with :func:`enable` (returns the registry + tracer so
callers can snapshot/save them) or ambiently with
``KERNEL_LAUNCHER_OBS=1`` in the environment, which enables at import
time — the zero-code-change way to get telemetry out of an existing
deployment.
"""

from __future__ import annotations

import os

from .metrics import MetricsRegistry
from .trace import Tracer

OBS_ENV = "KERNEL_LAUNCHER_OBS"

_metrics: MetricsRegistry | None = None
_tracer: Tracer | None = None


def obs_requested() -> bool:
    """KERNEL_LAUNCHER_OBS=1 enables metrics + tracing at import time."""
    return os.environ.get(OBS_ENV, "").lower() in ("1", "true", "on", "yes")


def enable(registry: MetricsRegistry | None = None,
           tracer: Tracer | None = None,
           trace: bool = True) -> tuple[MetricsRegistry, Tracer | None]:
    """Turn observability on for this process.

    Installs (or accepts) a :class:`MetricsRegistry` and, unless
    ``trace=False``, a :class:`Tracer`, and returns both — idempotent:
    enabling twice keeps the already-installed instances so counters
    never reset mid-run.
    """
    global _metrics, _tracer
    if _metrics is None:
        _metrics = registry if registry is not None else MetricsRegistry()
    if trace and _tracer is None:
        _tracer = tracer if tracer is not None else Tracer()
    return _metrics, _tracer


def disable() -> None:
    """Turn observability off (instrument sites see ``None`` again)."""
    global _metrics, _tracer
    _metrics = None
    _tracer = None


def enabled() -> bool:
    return _metrics is not None


def metrics() -> MetricsRegistry | None:
    """The process registry, or None when observability is disabled —
    THE hot-path check: one global read, one branch."""
    return _metrics


def tracer() -> Tracer | None:
    """The process tracer, or None when disabled (or metrics-only)."""
    return _tracer


if obs_requested():            # pragma: no cover — env-dependent
    enable()
