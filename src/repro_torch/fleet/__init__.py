"""Fleet tuning orchestrator: demand-driven, sharded, resumable jobs.

Port of ``repro.fleet``: the same control documents, job ids and
assembled wisdom (provenance carries ``torch_version`` where the
reference's carries ``jax_version``); shard winners pass the correctness
gate on the card.

Beyond-paper subsystem (connects online demand tracking with wisdom
distribution). The paper's workflow tunes one machine at a
time; at fleet scale the search itself must be distributed. This package
is the engine that decides *what to tune next, where, and survives
interruption*:

* :mod:`.bus`         — control channels (demand/job/lease/state/result)
  over the existing wisdom sync transports, plus injectable clocks;
* :mod:`.demand`      — aggregate worker ``ScenarioTracker`` snapshots,
  rank scenarios by miss-count x cost-model predicted speedup; aggregate
  serving hosts' observed latencies (the transfer verification signal);
* :mod:`.jobs`        — :class:`TuningJob` specs, deterministic config-
  space shards, crash-safe lease claim/heartbeat/expiry;
* :mod:`.worker`      — :class:`FleetWorker`: claim a shard, tune it with
  checkpointed (warm-startable) strategy sessions, publish the result;
* :mod:`.coordinator` — :class:`Coordinator`: plan jobs from demand,
  assemble shard winners into ``fleet``-provenance wisdom through the
  merge engine, re-enqueue scenarios whose demand regresses;
* :mod:`.local`       — :func:`run_local_fleet`: N in-process workers
  over a ``MemoryTransport``, the deterministic reference harness;
* :mod:`.health`      — per-host metric snapshots on the ``metrics``
  channel, merged into fleet-wide wisdom health (repro_torch.obs);
* :mod:`.cli`         — ``python -m repro_torch.fleet``
  (plan / coordinate / work / status / demo).
"""

from .bus import CHANNELS, Clock, ControlBus, ManualClock, WallClock
from .coordinator import (MIN_MISSES, TRANSFER_VERIFY_TOLERANCE, Coordinator,
                          CoordinatorReport)
from .demand import (DemandEntry, ScenarioPriority, aggregate_demand,
                     aggregate_latency, predicted_speedup, prioritize,
                     publish_demand, publish_latency, seed_demand)
from .health import (METRICS_CHANNEL, MetricsPublisher,
                     aggregate_fleet_metrics, fleet_health, fleet_snapshots,
                     publish_metrics)
from .jobs import (LEASE_TTL_S, Lease, LeaseLost, TuningJob, claim_shard,
                   fetch_lease, heartbeat, job_id_for, lease_name, list_jobs,
                   release)
from .local import DEMO_DEMAND, FleetRunReport, run_local_fleet
from .worker import FleetWorker, WorkerCrash

__all__ = [
    "CHANNELS", "Clock", "ControlBus", "ManualClock", "WallClock",
    "MIN_MISSES", "TRANSFER_VERIFY_TOLERANCE", "Coordinator",
    "CoordinatorReport",
    "DemandEntry", "ScenarioPriority", "aggregate_demand",
    "aggregate_latency", "predicted_speedup", "prioritize",
    "publish_demand", "publish_latency", "seed_demand",
    "METRICS_CHANNEL", "MetricsPublisher", "aggregate_fleet_metrics",
    "fleet_health", "fleet_snapshots", "publish_metrics",
    "LEASE_TTL_S", "Lease", "LeaseLost", "TuningJob", "claim_shard",
    "fetch_lease", "heartbeat", "job_id_for", "lease_name", "list_jobs",
    "release",
    "DEMO_DEMAND", "FleetRunReport", "run_local_fleet",
    "FleetWorker", "WorkerCrash",
]
