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

Spans at the program's layer boundaries use :func:`span`, which has two
sinks: the process :class:`Tracer` (when tracing is on) and an active
``torch.profiler`` session, where the span is a ``record_function`` range
named ``repro_torch.<name>`` in the same trace as the kernels it
launches. With neither on, it costs two flag reads.
"""

from __future__ import annotations

import os

import torch.autograd.profiler as _autograd_profiler

from .metrics import MetricsRegistry
from .trace import Tracer

OBS_ENV = "KERNEL_LAUNCHER_OBS"
#: The prefix of every span's profiler range, which keeps the program's
#: ranges apart from a caller's and from ``aten::*``.
PROFILER_PREFIX = "repro_torch."

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


class _Span:
    """A span with at least one sink on: a profiler range, a tracer
    event, or both. ``args``, which the site may add to before the span
    ends, go to the tracer's event."""

    __slots__ = ("name", "cat", "args", "_tracer", "_range", "_t0")

    def __init__(self, name: str, cat: str, tracer: Tracer | None,
                 profiled: bool):
        self.name, self.cat, self.args = name, cat, {}
        self._tracer = tracer
        self._range = (_autograd_profiler.record_function(
            PROFILER_PREFIX + name) if profiled else None)

    @property
    def recording(self) -> bool:
        """Whether the tracer records this span, so its args are read."""
        return self._tracer is not None

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        if self._tracer is not None:
            self._t0 = self._tracer.now_us()
        return self

    def __exit__(self, *exc) -> bool:
        # a step that raised is no finished span: its args are unfilled
        if self._tracer is not None and exc[0] is None:
            self._tracer.complete(self.name, self.cat, self._t0,
                                  **self.args)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class _NoSpan:
    """The span when neither sink is on: one shared object that does
    nothing."""

    __slots__ = ()
    recording = False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


def span(name: str, cat: str = "repro", device=None):
    """A context manager around one step of the program, on the calling
    thread: ``with obs.span("select", "kernel"): ...``.

    Under an active ``torch.profiler`` session it is the range
    ``repro_torch.<name>``, so the kernels launched inside it join it by
    correlation id; with the tracer on it is a complete ``name`` event
    with the span's ``args``, its real start and its host duration. With
    neither on, or for work on the ``meta`` ``device`` (shapes only, as
    the dry-run), it returns :data:`NO_SPAN` and enters nothing."""
    tr = _tracer
    profiled = _autograd_profiler._is_profiler_enabled
    if tr is None and not profiled:
        return NO_SPAN
    if getattr(device, "type", device) == "meta":
        return NO_SPAN
    return _Span(name, cat, tr, profiled)


def spans_on(device=None) -> bool:
    """Whether :func:`span` records on ``device``: a profiler session or
    the tracer is on, and the work is not on ``meta``. Sites that keep a
    counter only while spans are on ask this."""
    if _tracer is None and not _autograd_profiler._is_profiler_enabled:
        return False
    return getattr(device, "type", device) != "meta"


if obs_requested():            # pragma: no cover — env-dependent
    enable()
