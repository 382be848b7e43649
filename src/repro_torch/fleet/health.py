"""Fleet-wide health: metric snapshots on the control bus.

Every process that has observability enabled (``repro_torch.obs``) holds a
local :class:`~repro_torch.obs.metrics.MetricsRegistry`. This module moves
those registries' snapshots through the same control bus the
orchestrator already uses — one more channel (``metrics``) in the
reserved ``fleet--`` namespace — so any host can assemble a fleet-wide
view without a second telemetry system:

* workers/serving hosts call :func:`publish_metrics` (or hook a
  :class:`MetricsPublisher` into their loop) to put their snapshot on
  the bus under their worker id;
* the coordinator (or an operator shell) calls
  :func:`aggregate_fleet_metrics` to merge every published snapshot —
  counters sum, gauges max, histogram buckets sum — and
  :func:`fleet_health` to render the wisdom-health report over it.

Snapshots are plain JSON documents, so the directory transport stores
them as ordinary ``fleet--metrics--<worker>`` files an operator can cat.
"""

from __future__ import annotations

from repro_torch.obs import runtime as obs
from repro_torch.obs.metrics import MetricsRegistry, merge_snapshots
from repro_torch.obs.report import render_report

from .bus import ControlBus

#: Control-bus channel metric snapshots ride on (see ``bus.CHANNELS``).
METRICS_CHANNEL = "metrics"


def publish_metrics(bus: ControlBus, worker_id: str,
                    registry: MetricsRegistry | None = None) -> dict:
    """Publish one process's metric snapshot under its worker id.

    Uses the process-wide enabled registry when none is passed; raises
    ``RuntimeError`` when observability is disabled and there is nothing
    to snapshot (callers who may run disabled should guard on
    :func:`repro_torch.obs.enabled` or use :class:`MetricsPublisher`, whose
    tick is a no-op in that case). Returns the published snapshot.

    Example::

        enable()
        ...                                   # serve / tune / work
        publish_metrics(bus, "host-1")
    """
    reg = registry if registry is not None else obs.metrics()
    if reg is None:
        raise RuntimeError(
            "observability is disabled and no registry was given; "
            "call repro_torch.obs.enable() or pass registry=")
    snap = reg.snapshot()
    bus.publish(METRICS_CHANNEL, worker_id, snap)
    return snap


def fleet_snapshots(bus: ControlBus) -> dict[str, dict]:
    """Every published metric snapshot, keyed by worker id (sorted).

    The raw per-host view behind :func:`aggregate_fleet_metrics` —
    useful when a report should single out one host instead of merging.

    Example::

        for worker, snap in fleet_snapshots(bus).items():
            print(worker, snap["counters"].get("launch.count", 0))
    """
    out: dict[str, dict] = {}
    for name in bus.names(METRICS_CHANNEL):
        doc = bus.fetch(METRICS_CHANNEL, name)
        if doc is not None:
            out[name] = doc
    return out


def aggregate_fleet_metrics(bus: ControlBus) -> dict:
    """Merge every published snapshot into one fleet-wide snapshot.

    Counters and histogram buckets sum across hosts, gauges keep the
    max (see :func:`repro_torch.obs.merge_snapshots`); the result has the
    same shape as a single-process snapshot, so every report and tool
    that reads snapshots works on it unchanged.

    Example::

        snap = aggregate_fleet_metrics(bus)
        save_snapshot(snap, "fleet-metrics.json")
    """
    return merge_snapshots(list(fleet_snapshots(bus).values()))


def fleet_health(bus: ControlBus, top: int = 10) -> str:
    """Render the wisdom-health report over the whole fleet's metrics.

    Deterministic text (a pure function of the published snapshots):
    per-scenario hit rates, tier breakdown, transfer-confidence
    distribution, and the top missing scenarios across every host that
    published — the coordinator's one-call answer to "how healthy is
    the fleet's wisdom right now?".

    Example::

        print(fleet_health(bus))
    """
    return render_report(aggregate_fleet_metrics(bus), top=top)


class MetricsPublisher:
    """Loop hook that republishes this process's snapshot every
    ``interval`` ticks (first tick included, so a short-lived worker
    still shows up on the bus). ``tick()`` is cheap and safe to call
    from serving or tuning loops: when observability is disabled it
    does nothing.

    Example::

        pub = MetricsPublisher(bus, "host-1", interval=256)
        while serving:
            step()
            pub.tick()
    """

    def __init__(self, bus: ControlBus, worker_id: str,
                 interval: int = 64,
                 registry: MetricsRegistry | None = None):
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        self.bus = bus
        self.worker_id = worker_id
        self.interval = interval
        self.registry = registry
        self.publishes = 0
        self._ticks = 0

    def tick(self) -> bool:
        """Publish when due; returns True if a publish happened."""
        due = self._ticks % self.interval == 0
        self._ticks += 1
        reg = self.registry if self.registry is not None else obs.metrics()
        if not due or reg is None:
            return False
        self.bus.publish(METRICS_CHANNEL, self.worker_id, reg.snapshot())
        self.publishes += 1
        return True
