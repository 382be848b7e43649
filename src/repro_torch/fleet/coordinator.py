"""Fleet coordinator: demand -> jobs -> assembled fleet wisdom.

Port of ``repro.fleet.coordinator``. The coordinator closes the
orchestration loop:

  plan      aggregate worker demand snapshots, rank scenarios by
            miss-count x predicted speedup, publish a sharded
            :class:`~repro_torch.fleet.jobs.TuningJob` per hot scenario that
            has no finished job at the current demand level;
  assemble  once every shard of a job has a result, pick the winner with
            the *same* deterministic comparator the merge engine uses,
            build a ``fleet``-provenance :class:`WisdomRecord`, and
            fetch-merge-publish it into the transport's wisdom (and an
            optional local store) — the fleet copy only ever improves;
  re-check  demand keeps flowing; a scenario whose misses grew past the
            level its last job was planned at (wisdom regressed, or the
            record stopped matching) is re-enqueued as round N+1.

Everything is deterministic: job identity hashes the scenario, shard
membership hashes configs, winners tie-break through
:func:`~repro_torch.distrib.merge.better_record`, and fleet provenance carries
no timestamps — the same demand assembles to byte-identical wisdom on
any coordinator.

The correctness gate runs on ``device``, the card by default: a shard
winner is launched there and held to the plain version, so the
hand-written kernel is what gets checked. Without a card the coordinator
raises unless the caller asks for the CPU, where the gate holds the plain
version to itself.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core.device import get_device, resolve_device
from repro_torch.core.wisdom import (Wisdom, WisdomRecord,
                                     make_fleet_provenance)
from repro_torch.distrib.merge import better_record, merge_wisdom
from repro_torch.distrib.store import CONTROL_PREFIX, WisdomStore
from repro_torch.distrib.sync import transport_wisdom
from repro_torch.obs import runtime as obs_runtime
from repro_torch.online.tracker import format_key
from repro_torch.sandbox.gate import OracleGate

from .bus import ControlBus
from .demand import (aggregate_demand, aggregate_latency, prioritize,
                     seed_demand)
from .jobs import TuningJob, job_id_for, lease_name, list_jobs

#: Misses below this never become a job (the fleet analogue of the online
#: tracker's activation threshold).
MIN_MISSES = 3

#: Observed serve latency above predicted_us x this triggers a
#: verification job for a transferred record. Above the cost model's
#: ~5% measurement noise but tight enough that a genuinely wrong
#: prediction (a config that does not suit the target device) trips it.
TRANSFER_VERIFY_TOLERANCE = 1.2

#: Synthetic demand-snapshot worker id used for verification enqueues.
VERIFY_WORKER = "transfer-verify"


@dataclass
class CoordinatorReport:
    """What one coordination round did (job ids per outcome).

    ``idle`` is the loop's convergence signal: nothing planned,
    assembled, or requeued this round means demand is fully answered.

    Example::

        report = coordinator.tick()
        if report.idle:
            break
    """

    planned: list[str] = field(default_factory=list)    # job ids
    assembled: list[str] = field(default_factory=list)  # job ids
    requeued: list[str] = field(default_factory=list)   # job ids (new round)
    skipped: int = 0                                    # below-threshold
    #: Scenario keys whose transferred records regressed against their
    #: prediction this round and were re-seeded into demand (the jobs
    #: they become show up in ``planned``).
    verify: list[str] = field(default_factory=list)

    @property
    def idle(self) -> bool:
        return not (self.planned or self.assembled or self.requeued)


class Coordinator:
    """Plans jobs from demand and assembles shard results into wisdom.

    Any host can run one (job identity is deterministic, so concurrent
    planners collide into the same jobs instead of duplicating work);
    ``tick()`` is the whole loop — assemble finished jobs, then re-plan
    from fresh demand.

    Example::

        coord = Coordinator(ControlBus(transport), n_shards=4)
        while not coord.tick().idle:
            pass
    """

    def __init__(self, bus: ControlBus, store: WisdomStore | None = None,
                 n_shards: int = 4, max_evals_per_shard: int = 200,
                 strategy: str = "exhaustive", min_misses: int = MIN_MISSES,
                 speedup_probes: int = 16, seed: int = 0, oracle="auto",
                 device: str | torch.device = "cuda"):
        self.bus = bus
        self.store = store
        self.n_shards = n_shards
        self.max_evals_per_shard = max_evals_per_shard
        self.strategy = strategy
        self.min_misses = min_misses
        self.speedup_probes = speedup_probes
        self.seed = seed
        #: Correctness gate on shard winners: a winner that fails its
        #: reference check never enters fleet wisdom — assembly falls
        #: back to the next-best shard result instead. ``"auto"`` = an
        #: :class:`OracleGate` on ``device`` (the card unless the caller
        #: asks for the CPU; no silent fallback); None disables gating.
        self.oracle = (OracleGate(device=resolve_device(device))
                       if oracle == "auto" else oracle)
        #: Coordination rounds run so far; with no wall clock anywhere in
        #: the coordinator, assembled-wisdom age is expressed in rounds.
        self.rounds = 0
        self._last_assembled_round: int | None = None

    # -- planning --------------------------------------------------------------

    def decide(self, entry) -> tuple[str, int, bool] | None:
        """What planning would do for one demand entry, from the cheap
        control documents alone: (job_id, round, is_requeue), or None
        when the entry needs no new job (satisfied, or round in flight).
        """
        round_ = 0
        requeue = False
        while True:
            job_id = job_id_for(entry.kernel, entry.key, round_)
            done = self.bus.fetch("done", job_id)
            if done is None:
                break
            if entry.misses <= int(done.get("misses_at_plan", 0)):
                # demand has not moved since this round finished:
                # wisdom already answers it, nothing to re-tune
                return None
            round_ += 1             # regression: demand outgrew the result
            requeue = True
        if self.bus.fetch("job", job_id) is not None:
            return None             # this round is already in flight
        return job_id, round_, requeue

    def plan(self, report: CoordinatorReport | None = None,
             ranked: list | None = None) -> list[TuningJob]:
        """Turn current fleet demand into published jobs (idempotent: a
        scenario with a live or demand-current finished job is skipped).
        ``ranked`` lets a caller that already ran :func:`prioritize`
        (e.g. to print the ranking) pass it in instead of re-probing."""
        report = report if report is not None else CoordinatorReport()
        if ranked is None:
            # Filter before ranking: the speedup probe costs ~n_probes
            # cost-model evaluations per scenario, and trackers publish
            # *every* scenario they ever saw — in steady state almost all
            # are below threshold or already answered by a finished job.
            actionable = []
            for entry in aggregate_demand(self.bus):
                if entry.misses < self.min_misses:
                    report.skipped += 1
                elif self.decide(entry) is not None:
                    actionable.append(entry)
            ranked = prioritize(actionable, self.bus.transport,
                                n_probes=self.speedup_probes,
                                seed=self.seed) if actionable else []
        jobs: list[TuningJob] = []
        order = len(list_jobs(self.bus))
        for pri in ranked:
            entry = pri.entry
            if entry.misses < self.min_misses:
                report.skipped += 1
                continue
            decision = self.decide(entry)
            if decision is None:
                continue            # satisfied, or round already in flight
            job_id, round_, requeue = decision
            job = TuningJob(
                job_id=job_id, kernel=entry.kernel,
                device_kind=entry.key[0], problem=tuple(entry.key[1]),
                dtype=entry.key[2], strategy=self.strategy,
                n_shards=self.n_shards,
                max_evals_per_shard=self.max_evals_per_shard,
                seed=self.seed, round_=round_, misses=entry.misses,
                order=order)
            order += 1
            self.bus.publish("job", job.job_id, job.to_json())
            jobs.append(job)
            (report.requeued if requeue else report.planned).append(job_id)
        return jobs

    # -- assembly --------------------------------------------------------------

    def assemble(self, report: CoordinatorReport | None = None
                 ) -> list[WisdomRecord]:
        """Fold every fully-tuned job's shard winners into fleet wisdom."""
        report = report if report is not None else CoordinatorReport()
        records: list[WisdomRecord] = []
        for job in list_jobs(self.bus):
            if self.bus.fetch("done", job.job_id) is not None:
                continue
            results = []
            for shard_id in job.shard_ids():
                doc = self.bus.fetch("result",
                                     lease_name(job.job_id, shard_id))
                if doc is None:
                    break
                results.append(doc)
            if len(results) < job.n_shards:
                continue            # still tuning
            record, rejected = self._assemble_job(job, results)
            done = {"job": job.job_id, "misses_at_plan": job.misses,
                    "round": job.round_}
            if record is None:
                done["state"] = "no-winner"
            else:
                done["state"] = "assembled"
                done["score_us"] = record.score_us
                done["config"] = dict(record.config)
                records.append(record)
            if rejected:
                done["rejected"] = rejected
            self.bus.publish("done", job.job_id, done)
            report.assembled.append(job.job_id)
        return records

    def _assemble_job(self, job: TuningJob, results: list[dict]
                      ) -> tuple[WisdomRecord | None, list[dict]]:
        total_evals = sum(int(r.get("evals", 0)) for r in results)
        dev = get_device(job.device_kind)
        provenance = make_fleet_provenance(
            strategy=job.strategy, evals=total_evals,
            objective="costmodel", job_id=job.job_id,
            n_shards=job.n_shards, round_=job.round_)
        candidates: list[WisdomRecord] = []
        for r in results:
            if r.get("best_config") is None:
                continue
            candidates.append(WisdomRecord(
                device_kind=dev.kind, device_family=dev.family,
                problem_size=tuple(job.problem), dtype=job.dtype,
                config=dict(r["best_config"]),
                score_us=float(r["best_score_us"]),
                provenance=dict(provenance)))
        # Walk shard winners best-first through the correctness gate: a
        # shard whose "winner" computes the wrong answer (crashed tuner,
        # cost-model blind spot) is recorded in the done doc and the
        # next-best shard result takes its place.
        winner: WisdomRecord | None = None
        rejected: list[dict] = []
        while candidates:
            best_i = 0
            for i in range(1, len(candidates)):
                if better_record(candidates[best_i],
                                 candidates[i]) is candidates[i]:
                    best_i = i
            cand = candidates.pop(best_i)
            if self.oracle is None:
                winner = cand
                break
            verdict = self.oracle.check_record(job.kernel, cand)
            if self.oracle.allows(verdict):
                stamped = self.oracle.stamp(cand.provenance, job.kernel,
                                            verdict)
                winner = (cand if stamped == cand.provenance else
                          WisdomRecord(
                              device_kind=cand.device_kind,
                              device_family=cand.device_family,
                              problem_size=cand.problem_size,
                              dtype=cand.dtype, config=dict(cand.config),
                              score_us=cand.score_us, provenance=stamped))
                break
            rejected.append({"config": dict(cand.config),
                             "score_us": cand.score_us,
                             "verdict": verdict.to_json()})
        if winner is None:
            # every shard came back infeasible, or the oracle vetoed all
            return None, rejected
        # Shard winners flow through the merge engine into fleet wisdom:
        # fetch-merge-publish, so a better record already on the transport
        # (another job round, an online promotion) survives.
        merged = merge_wisdom(Wisdom(job.kernel, [winner]),
                              transport_wisdom(self.bus.transport,
                                               job.kernel))
        self.bus.transport.publish(job.kernel, merged.to_doc())
        if self.store is not None:
            self.store.save(merge_wisdom(self.store.load(job.kernel),
                                         merged))
        return winner, rejected

    # -- transfer verification -------------------------------------------------

    def check_transfers(self, report: CoordinatorReport | None = None
                        ) -> list[str]:
        """Enqueue verification tuning for regressed transferred records.

        Compares each transferred record on the transport (provenance
        ``predicted_us``) against the fleet's best observed serve latency
        for its scenario (``latency`` channel). An observation worse than
        prediction x ``TRANSFER_VERIFY_TOLERANCE`` means the prediction
        is not holding on real traffic: the scenario is re-seeded into
        demand under the ``transfer-verify`` worker id, so the very next
        ``plan()`` turns it into an ordinary tuning job — and the
        assembled *measured* record beats the transferred one in every
        merge, completing predict -> verify -> promote.

        Example::

            publish_latency(bus, "host-1", {"matmul": {key_str: 712.0}})
            coordinator.tick()        # runs check_transfers + plan
        """
        report = report if report is not None else CoordinatorReport()
        observed = aggregate_latency(self.bus)
        if not observed:
            return []
        # Only kernels somebody actually observed: latency docs persist
        # across ticks, and fetching + migrating every kernel's wisdom on
        # every tick would make the daemon loop O(kernels x records) I/O.
        watched = sorted({kernel for kernel, _key in observed})
        published = set(self.bus.transport.list_kernels())
        regressed: list[tuple[str, tuple, int]] = []
        for name in watched:
            if name.startswith(CONTROL_PREFIX) or name not in published:
                continue
            for rec in transport_wisdom(self.bus.transport, name).records:
                if not rec.is_transferred():
                    continue
                key = (rec.device_kind, rec.problem_size, rec.dtype)
                obs = observed.get((name, format_key(key)))
                if obs is None:
                    continue
                try:
                    predicted = float(rec.provenance.get("predicted_us",
                                                         rec.score_us))
                except (TypeError, ValueError):
                    predicted = rec.score_us
                if obs > predicted * TRANSFER_VERIFY_TOLERANCE:
                    regressed.append((name, key, self.min_misses))
        keys = [format_key(k) for _, k, _ in regressed]
        if regressed:
            seed_demand(self.bus, VERIFY_WORKER, regressed)
            report.verify.extend(keys)
        return keys

    # -- the loop --------------------------------------------------------------

    def tick(self) -> CoordinatorReport:
        """One coordination round: assemble finished jobs, check
        transferred-wisdom predictions against observed latency, then
        re-check demand (hot or regressed scenarios get (re-)enqueued)."""
        report = CoordinatorReport()
        self.assemble(report)
        self.check_transfers(report)
        self.plan(report)
        self.rounds += 1
        if report.assembled:
            self._last_assembled_round = self.rounds
        m = obs_runtime.metrics()
        if m is not None:
            for event, ids in (("planned", report.planned),
                               ("assembled", report.assembled),
                               ("requeued", report.requeued),
                               ("verify", report.verify)):
                if ids:
                    m.counter("fleet.jobs", event=event).inc(len(ids))
            m.gauge("fleet.rounds").set(self.rounds)
            # Rounds since fleet wisdom last changed: fresh wisdom is
            # age 0; "never assembled anything" reads as age == rounds.
            age = (self.rounds - self._last_assembled_round
                   if self._last_assembled_round is not None
                   else self.rounds)
            m.gauge("fleet.assembled_age_rounds").set(age)
        return report

    # -- introspection ---------------------------------------------------------

    def fleet_health(self, top: int = 10) -> str:
        """The wisdom-health report over every snapshot workers have
        published on the ``metrics`` channel (see
        :mod:`repro_torch.fleet.health`). Example:
        ``print(coord.fleet_health())`` after a few ticks shows fleet-wide
        hit rates and missing scenarios."""
        from .health import fleet_health
        return fleet_health(self.bus, top=top)

    def status(self) -> dict:
        demand = aggregate_demand(self.bus)
        jobs = list_jobs(self.bus)
        done = {d["job"]: d for d in self.bus.docs("done")}
        shard_results = len(self.bus.names("result"))
        return {
            "demand_entries": len(demand),
            "demand_misses": sum(e.misses for e in demand),
            "jobs": len(jobs),
            "jobs_done": len(done),
            "jobs_open": len([j for j in jobs if j.job_id not in done]),
            "shard_results": shard_results,
            "scenarios": [
                {"kernel": e.kernel, "key": format_key(e.key),
                 "misses": e.misses, "workers": e.workers}
                for e in demand],
        }
