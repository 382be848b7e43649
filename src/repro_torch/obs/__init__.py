"""Observability: process metrics, span tracing, and wisdom health.

The port of ``repro.obs``: pure Python, copied with the imports rewritten,
so a snapshot, a trace and a report are the same bytes in both packages.

Zero-dependency telemetry substrate for every loop in the system —
serving, online tuning, fleet orchestration, sync, transfer — built from
two primitives and a report:

* :mod:`.metrics` — a process-wide :class:`MetricsRegistry` of counters,
  gauges, and fixed-bucket histograms whose snapshots are byte-
  deterministic JSON, mergeable across workers;
* :mod:`.trace`   — a span :class:`Tracer` exporting Chrome
  ``trace_event`` JSON (open in chrome://tracing or Perfetto);
* :mod:`.runtime` — the on/off switch: disabled (default) costs one
  global read + branch per instrument site, enabled via
  :func:`enable` or ``KERNEL_LAUNCHER_OBS=1``;
* :mod:`.report`  — the wisdom-health report (hit rates, tier breakdown,
  transfer confidence, top missing scenarios) rendered deterministically
  from a snapshot or a saved trace;
* ``python -m repro_torch.obs`` — snapshot / report / trace CLI
  (:mod:`.cli`, demo run included).

Fleet-wide aggregation over the control bus lives in
``repro_torch.fleet.health``; ``report --bus DIR`` renders it.
"""

from .metrics import (COUNT_BUCKETS, DEFAULT_BUCKETS_US, SNAPSHOT_VERSION,
                      UNIT_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry, load_snapshot, merge_snapshots,
                      parse_series, save_snapshot, series_key,
                      snapshot_bytes)
from .report import (ScenarioHealth, fleet_report, render_report,
                     scenario_health, snapshot_from_trace)
from .runtime import (OBS_ENV, disable, enable, enabled, metrics,
                      obs_requested, tracer)
from .trace import (REQUIRED_EVENT_KEYS, Tracer, load_trace,
                    validate_trace)

__all__ = [
    "COUNT_BUCKETS", "DEFAULT_BUCKETS_US", "SNAPSHOT_VERSION",
    "UNIT_BUCKETS", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "load_snapshot", "merge_snapshots", "parse_series", "save_snapshot",
    "series_key", "snapshot_bytes",
    "ScenarioHealth", "fleet_report", "render_report", "scenario_health",
    "snapshot_from_trace",
    "OBS_ENV", "disable", "enable", "enabled", "metrics", "obs_requested",
    "tracer",
    "REQUIRED_EVENT_KEYS", "Tracer", "load_trace", "validate_trace",
]
