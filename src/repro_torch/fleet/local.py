"""Single-process fleet harness: N workers, one MemoryTransport.

Port of ``repro.fleet.local``. ``run_local_fleet`` spins a coordinator plus N in-process workers over an
in-memory transport and a logical clock, stepping them round-robin until
the demand table is drained. Deterministic by construction — no threads,
no wall clock — which makes it the reference for the orchestration
semantics (the e2e test asserts byte-identical wisdom for 1 worker vs 3
workers with a forced crash) and the engine behind ``python -m
repro_torch.fleet demo`` and ``chip_smoke.py`` phase 10.

A worker "step" claims and fully runs one shard; the round-robin order is
fixed, so the only scheduling freedom — which worker gets which shard —
is exercised while the *result* stays provably schedule-independent.
The coordinator's correctness gate runs on ``device`` (the card unless the
caller asks for the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.distrib.store import CONTROL_PREFIX, WisdomStore
from repro_torch.distrib.sync import MemoryTransport, Transport
from repro_torch.online.tracker import ScenarioKey

from .bus import ControlBus, ManualClock
from .coordinator import Coordinator
from .demand import seed_demand
from .jobs import (LEASE_TTL_S, Lease, fetch_lease, lease_name, list_jobs)
from .worker import FleetWorker, WorkerCrash

#: Demand used when the caller provides none — the reference's quickstart
#: problems, on the card this port serves.
DEMO_DEMAND: list[tuple[str, ScenarioKey, int]] = [
    ("matmul", ("gpu-h100", (256, 256, 256), "float32"), 5),
    ("matmul", ("gpu-h100", (512, 512, 512), "bfloat16"), 3),
]


@dataclass
class FleetRunReport:
    """What one local fleet run did, for assertions and CSV rows.

    Collects per-worker shard/eval tallies, final lease states, every
    assembled wisdom document, and the coordinator's status — enough to
    assert the orchestration invariants (disjoint shards, single-claim
    leases, byte-identical wisdom) without re-reading the transport.

    Example::

        report = run_local_fleet(n_workers=3)
        assert report.jobs_assembled
        assert all(l.claims == 1 for l in report.leases.values())
    """
    transport: Transport = None
    n_workers: int = 0
    steps: int = 0
    crashes: int = 0
    jobs_planned: list[str] = field(default_factory=list)
    jobs_assembled: list[str] = field(default_factory=list)
    shards_by_worker: dict[str, list[str]] = field(default_factory=dict)
    evals_by_worker: dict[str, int] = field(default_factory=dict)
    leases: dict[str, Lease] = field(default_factory=dict)
    wisdom_docs: dict[str, dict] = field(default_factory=dict)
    status: dict = field(default_factory=dict)

    @property
    def total_evals(self) -> int:
        return sum(self.evals_by_worker.values())

    @property
    def makespan_evals(self) -> int:
        """Critical-path length: evaluations run by the busiest worker.
        The simulated-parallelism analogue of wall time (every worker in
        the real fleet runs concurrently)."""
        return max(self.evals_by_worker.values(), default=0)

    def claims(self) -> dict[str, int]:
        return {name: lease.claims for name, lease in self.leases.items()}


def run_local_fleet(n_workers: int = 3,
                    demand: list[tuple[str, ScenarioKey, int]] | None = None,
                    transport: Transport | None = None, *,
                    store: WisdomStore | None = None,
                    n_shards: int = 4, strategy: str = "exhaustive",
                    max_evals_per_shard: int = 10_000, seed: int = 0,
                    min_misses: int = 3, checkpoint_every: int = 8,
                    crash_worker: str | None = None,
                    crash_after_evals: int | None = None,
                    ttl_s: float = LEASE_TTL_S,
                    max_steps: int = 10_000,
                    device: str | torch.device = "cuda") -> FleetRunReport:
    """Drain ``demand`` with ``n_workers`` in-process workers.

    ``crash_worker``/``crash_after_evals`` kill one worker mid-shard; the
    run still completes (lease expiry + warm-start reclaim) as long as at
    least one worker survives.

    Example::

        report = run_local_fleet(n_workers=3, crash_worker="w1",
                                 crash_after_evals=13, device="cpu")
        assert report.crashes == 1 and report.jobs_assembled
    """
    transport = transport if transport is not None else MemoryTransport()
    bus = ControlBus(transport)
    clock = ManualClock()
    seed_demand(bus, "seed", demand if demand is not None else DEMO_DEMAND)

    coordinator = Coordinator(bus, store=store,
                              n_shards=n_shards, strategy=strategy,
                              max_evals_per_shard=max_evals_per_shard,
                              min_misses=min_misses, seed=seed,
                              device=device)
    workers = [
        FleetWorker(bus, f"w{i}", clock=clock, ttl_s=ttl_s,
                    checkpoint_every=checkpoint_every,
                    crash_after_evals=(crash_after_evals
                                       if f"w{i}" == crash_worker else None))
        for i in range(n_workers)]
    alive = {w.worker_id for w in workers}

    report = FleetRunReport(transport=transport, n_workers=n_workers)
    report.jobs_planned = [j.job_id for j in coordinator.plan()]

    advanced_while_idle = False
    while report.steps < max_steps:
        progressed = False
        for w in workers:
            if w.worker_id not in alive:
                continue
            try:
                done = w.run_once()
            except WorkerCrash:
                # the dead worker's lease now has to age out before the
                # shard is claimable again
                alive.discard(w.worker_id)
                report.crashes += 1
                clock.advance(ttl_s + 1.0)
                progressed = True
                continue
            if done is not None:
                report.steps += 1
                progressed = True
        round_report = coordinator.tick()
        report.jobs_assembled.extend(round_report.assembled)
        report.jobs_planned.extend(round_report.planned
                                   + round_report.requeued)
        if progressed:
            advanced_while_idle = False
            continue
        if not alive:
            break
        if advanced_while_idle:
            break               # idle across a full TTL: nothing left
        clock.advance(ttl_s + 1.0)
        advanced_while_idle = True

    for w in workers:
        report.shards_by_worker[w.worker_id] = list(w.shards_done)
        report.evals_by_worker[w.worker_id] = w.evals_run
    for job in list_jobs(bus):
        for shard_id in job.shard_ids():
            lease = fetch_lease(bus, job.job_id, shard_id)
            if lease is not None:
                report.leases[lease_name(job.job_id, shard_id)] = lease
    report.wisdom_docs = {
        name: transport.fetch(name)
        for name in transport.list_kernels()
        if not name.startswith(CONTROL_PREFIX)}
    report.status = coordinator.status()
    return report
