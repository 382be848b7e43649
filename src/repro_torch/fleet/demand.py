"""Fleet demand: aggregate per-worker wisdom misses, rank what to tune.

Workers publish their :class:`~repro_torch.online.ScenarioTracker` snapshots
(canonical string keys, so the records survive JSON transport without
tuple/list drift) on the ``demand`` channel. The coordinator merges them
into one fleet-wide table and ranks scenarios by

    priority = misses x predicted_speedup

where ``predicted_speedup`` is a cheap cost-model probe: the score of the
config the fleet would select *today* (through the §4.5 heuristic against
current fleet wisdom) divided by the best of a few seeded random probes.
A scenario nobody misses never gets tuned; a heavily-missed scenario the
cost model thinks is already near-optimal ranks below a moderately-missed
one with 3x headroom.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from repro_torch.core.device import get_device
from repro_torch.core.registry import get_kernel
from repro_torch.core.wisdom import Wisdom
from repro_torch.distrib.sync import Transport, transport_wisdom
from repro_torch.online.tracker import (ScenarioKey, ScenarioTracker,
                                        format_key, parse_key)
from repro_torch.tuner.runner import CostModelEvaluator

from .bus import ControlBus

#: Probes drawn per scenario for the speedup estimate. Small on purpose:
#: this runs in the coordinator's planning loop over every hot scenario.
SPEEDUP_PROBES = 16


@dataclass
class DemandEntry:
    """Fleet-wide demand for one (kernel, scenario).

    The sum of every worker's wisdom-miss counters for the scenario,
    plus how many workers reported it — the raw material
    :func:`prioritize` ranks. Produced by :func:`aggregate_demand`.

    Example::

        entries = aggregate_demand(bus)
        hot = [e for e in entries if e.misses >= MIN_MISSES]
    """

    kernel: str
    key: ScenarioKey
    misses: int = 0
    launches: int = 0
    workers: int = 0          # how many workers reported it

    @property
    def key_str(self) -> str:
        return format_key(self.key)


@dataclass
class ScenarioPriority:
    """A demand entry with its cost-model headroom estimate attached.

    ``priority = misses x speedup``: traffic volume times how much the
    cost model thinks tuning could still win over what selection
    returns today. Produced by :func:`predicted_speedup` /
    :func:`prioritize`; consumed by the coordinator's planner.

    Example::

        for p in prioritize(entries, transport):
            print(p.entry.kernel, p.speedup, p.priority)
    """

    entry: DemandEntry
    current_score_us: float
    probe_score_us: float
    speedup: float            # current / best-probe (>= 1.0 when feasible)

    @property
    def priority(self) -> float:
        return self.entry.misses * self.speedup


def publish_demand(bus: ControlBus, worker_id: str,
                   trackers: dict[str, ScenarioTracker]) -> None:
    """Publish one worker's demand snapshot ({kernel_name: tracker}).

    Cumulative-counter semantics: each publish *replaces* the worker's
    previous snapshot (tracker counters only grow), so re-publishing is
    idempotent and the aggregate never double-counts a launch.

    Example::

        publish_demand(bus, "host-1", {"matmul": kernel.tracker})
    """
    bus.publish("demand", worker_id, {
        "worker": worker_id,
        "kernels": {name: tracker.snapshot()
                    for name, tracker in sorted(trackers.items())},
    })


def seed_demand(bus: ControlBus, worker_id: str,
                entries: list[tuple[str, ScenarioKey, int]]) -> None:
    """Publish a synthetic demand snapshot — (kernel, key, misses) triples.

    Test/benchmark/CLI convenience standing in for real trackers: builds
    throwaway ``ScenarioTracker``s with the requested miss counts and
    publishes them like a real worker would.

    Example::

        seed_demand(bus, "seed",
                    [("matmul", ("gpu-h100", (256, 256, 256), "float32"), 5)])
    """
    trackers: dict[str, ScenarioTracker] = {}
    for kernel, key, misses in entries:
        t = trackers.setdefault(kernel, ScenarioTracker())
        t.observe(*key, tier="default", weight=misses)
    publish_demand(bus, worker_id, trackers)


def publish_latency(bus: ControlBus, worker_id: str,
                    observations: dict[str, dict[str, float]]) -> None:
    """Publish one serving host's observed per-scenario latencies.

    ``observations`` maps kernel name -> {canonical scenario key ->
    best observed latency in us}. Replace-style like demand snapshots
    (re-publishing is idempotent); the coordinator compares these against
    the ``predicted_us`` of transferred wisdom records and enqueues
    verification tuning for scenarios whose predictions regressed
    (see ``Coordinator.check_transfers``).

    Example::

        publish_latency(bus, "host-1",
                        {"matmul": {format_key(key): 512.3}})
    """
    bus.publish("latency", worker_id, {
        "worker": worker_id,
        "kernels": {k: {key: float(us) for key, us in sorted(v.items())}
                    for k, v in sorted(observations.items())},
    })


def aggregate_latency(bus: ControlBus) -> dict[tuple[str, str], float]:
    """Fleet-wide best observed latency per (kernel, scenario key).

    The *minimum* over workers: latency observations verify a transferred
    record's optimistic prediction, and the best-case observation is the
    fairest comparison (stragglers and noisy hosts must not trigger
    spurious verification jobs).

    Example::

        observed = aggregate_latency(bus)
        us = observed.get(("matmul", format_key(key)))
    """
    table: dict[tuple[str, str], float] = {}
    for doc in bus.docs("latency"):
        for kernel, scenarios in doc.get("kernels", {}).items():
            for key, us in scenarios.items():
                k = (kernel, key)
                us = float(us)
                if k not in table or us < table[k]:
                    table[k] = us
    return table


def aggregate_demand(bus: ControlBus) -> list[DemandEntry]:
    """Merge every worker's snapshot into one fleet-wide demand table.

    Sums misses/launches per (kernel, scenario) across all published
    snapshots and counts the reporting workers; deterministically
    ordered by (kernel, key) so every coordinator sees the same table.

    Example::

        entries = aggregate_demand(ControlBus(transport))
    """
    table: dict[tuple[str, str], DemandEntry] = {}
    for doc in bus.docs("demand"):
        for kernel, stats in doc.get("kernels", {}).items():
            for s in stats:
                k = (kernel, s["key"])
                entry = table.get(k)
                if entry is None:
                    entry = table[k] = DemandEntry(kernel,
                                                   parse_key(s["key"]))
                entry.misses += int(s.get("misses", 0))
                entry.launches += int(s.get("launches", 0))
                entry.workers += 1
    return [table[k] for k in sorted(table)]


def _probe_rng(kernel: str, key: ScenarioKey, seed: int
               ) -> np.random.Generator:
    h = hashlib.sha256(f"{seed}|{kernel}|{format_key(key)}".encode())
    return np.random.default_rng(int.from_bytes(h.digest()[:8], "little"))


def predicted_speedup(kernel: str, key: ScenarioKey, wisdom: Wisdom,
                      n_probes: int = SPEEDUP_PROBES,
                      seed: int = 0) -> ScenarioPriority | None:
    """Estimate tuning headroom for one scenario under the cost model.

    Returns None when the kernel is unknown on this host (a worker
    elsewhere may still tune it; the coordinator just cannot rank it).

    Example::

        pri = predicted_speedup("matmul",
                                ("gpu-h100", (256, 256, 256), "float32"),
                                store.load("matmul"))
        if pri is not None and pri.speedup > 1.5: ...
    """
    try:
        builder = get_kernel(kernel)
    except KeyError:
        return None
    device_kind, problem, dtype = key
    evaluator = CostModelEvaluator(builder, problem, dtype,
                                   get_device(device_kind), verify="none")
    current, _tier = wisdom.select(device_kind, problem, dtype,
                                   builder.default_config())
    cur = evaluator(current).score_us
    rng = _probe_rng(kernel, key, seed)
    best = cur
    for cfg in builder.space.sample(rng, n_probes):
        best = min(best, evaluator(cfg).score_us)
    if not np.isfinite(best):
        # nothing feasible at all — no measurable headroom
        return ScenarioPriority(DemandEntry(kernel, key), cur, best, 1.0)
    speedup = (cur / best) if np.isfinite(cur) else float(n_probes)
    return ScenarioPriority(DemandEntry(kernel, key), cur, best,
                            max(speedup, 1.0))


def prioritize(entries: list[DemandEntry], transport: Transport,
               n_probes: int = SPEEDUP_PROBES,
               seed: int = 0) -> list[ScenarioPriority]:
    """Rank demand entries by miss-count x predicted speedup.

    Runs :func:`predicted_speedup` for each entry against the
    transport's current wisdom and sorts descending by priority (ties
    broken by (kernel, key) so every coordinator agrees). Entries whose
    kernel is unknown on this host are dropped — a coordinator cannot
    rank what it cannot score.

    Example::

        ranked = prioritize(aggregate_demand(bus), bus.transport)
        jobs = coordinator.plan(ranked=ranked)
    """
    out: list[ScenarioPriority] = []
    for entry in entries:
        est = predicted_speedup(entry.kernel, entry.key,
                                transport_wisdom(transport, entry.kernel),
                                n_probes=n_probes, seed=seed)
        if est is None:
            continue
        est.entry = entry
        out.append(est)
    out.sort(key=lambda p: (-p.priority, p.entry.kernel, p.entry.key_str))
    return out
