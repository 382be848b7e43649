"""Fleet worker: claim a shard lease, tune it, checkpoint, publish.

Port of ``repro.fleet.worker``. One :meth:`FleetWorker.run_once` call
claims the highest-priority open shard, tunes that shard of the job's
config space (against the cost model by default, or whatever evaluator
``evaluator_factory`` gives, such as a wall-clock one on the card), and
publishes the shard result. Long shards are crash-safe:

  * every ``checkpoint_every`` live evaluations the worker publishes its
    evaluation log on the ``state`` channel and heartbeats its lease;
  * if the worker dies, the lease expires and another worker re-claims;
    the recorded evaluations warm-start the strategy
    (:mod:`repro_torch.tuner.strategies` replays them), so the retry continues
    from the checkpoint instead of re-measuring the prefix — and, same
    seed, proposes exactly the configs the dead worker would have.

Configs outside the shard are rejected before they reach the evaluator,
so shards stay disjoint even for strategies whose proposals are not
drawn from the shard space (annealing starts at the space default).

With a :class:`~repro_torch.tunebench.DatasetStore` attached (``datasets=``),
a worker additionally warm-starts each shard from the scenario's
*recorded tuning-space dataset*: entries that fall inside the shard are
replayed instead of re-measured (the same history plumbing crash
recovery uses), so a fleet that has tuned a scenario before never pays
for the same evaluation twice.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.device import get_device
from repro_torch.core.param import Config
from repro_torch.core.registry import get_kernel
from repro_torch.obs import runtime as obs
from repro_torch.sandbox.evaluator import SandboxedEvaluator, SandboxSettings
from repro_torch.tuner.costmodel import INFEASIBLE
from repro_torch.tuner.runner import CostModelEvaluator, EvalResult
from repro_torch.tuner.strategies import (STRATEGIES, Evaluation, TuningResult,
                                          evaluation_from_json,
                                          evaluation_to_json)

from .bus import Clock, ControlBus, WallClock
from .jobs import (LEASE_TTL_S, Lease, LeaseLost, TuningJob, claim_shard,
                   heartbeat, lease_name, list_jobs, release)


class WorkerCrash(RuntimeError):
    """Injected mid-shard failure (tests / chaos drills).

    Raised by a worker constructed with ``crash_after_evals=N`` once its
    next shard has run N live evaluations — *after* checkpointing them,
    so the crash loses no measured work. The crash/reclaim e2e tests use
    it to prove byte-identical assembly across worker deaths.

    Example::

        run_local_fleet(n_workers=3, crash_worker="w1",
                        crash_after_evals=13)   # raises + reclaims inside
    """


class FleetWorker:
    """Claims and runs one shard at a time from the control bus.

    The work loop is ``run_once`` (claim the highest-priority open
    shard, tune it, publish) or ``drain`` (repeat until nothing is
    claimable). Crash safety comes from lease heartbeats plus
    checkpointed evaluation logs; ``datasets`` adds recorded-space
    warm starts on top.

    Example::

        bus = ControlBus(DirectoryTransport("/mnt/shared/wisdom"))
        worker = FleetWorker(bus, worker_id="host-3",
                             datasets=DatasetStore("datasets"))
        worker.drain()
    """

    def __init__(self, bus: ControlBus, worker_id: str,
                 clock: Clock | None = None, ttl_s: float = LEASE_TTL_S,
                 checkpoint_every: int = 8,
                 crash_after_evals: int | None = None,
                 datasets=None, evaluator_factory=None,
                 sandbox: SandboxSettings | None = None):
        self.bus = bus
        self.worker_id = worker_id
        self.clock = clock or WallClock()
        self.ttl_s = ttl_s
        self.checkpoint_every = checkpoint_every
        #: When set, raise WorkerCrash after this many live evaluations in
        #: the next shard (one-shot — consumed by the crash).
        self.crash_after_evals = crash_after_evals
        #: Optional repro_torch.tunebench DatasetStore: recorded spaces
        #: warm-start shard sessions (replayed, never re-measured).
        self.datasets = datasets
        #: Optional ``(builder, job) -> Evaluate`` override; default is a
        #: CostModelEvaluator for the job's scenario. A timed evaluator on
        #: the card comes in here, and fault-injection tests swap in
        #: misbehaving evaluators.
        self.evaluator_factory = evaluator_factory
        #: Crash-isolation settings for shard evaluations. Default is
        #: the inline sandbox (verdict classification without a child
        #: process — the cost model cannot hang); pass spawn
        #: SandboxSettings when the evaluator itself might hang or take
        #: the worker process down. Never fork: a forked child of a
        #: process that holds a CUDA context cannot use the card.
        self.sandbox = sandbox if sandbox is not None else SandboxSettings(
            method="inline")
        self.shards_done: list[str] = []
        self.evals_run = 0

    # -- the work loop ---------------------------------------------------------

    def run_once(self) -> str | None:
        """Claim and finish one open shard; returns its ``job--shard``
        name, or None when no shard is claimable right now."""
        for job in list_jobs(self.bus):
            if self.bus.fetch("done", job.job_id) is not None:
                continue                # assembled: no open shards left
            try:
                get_kernel(job.kernel)
            except KeyError:
                # Heterogeneous fleet: this host does not have the job's
                # kernel. Skip BEFORE claiming — crashing with the lease
                # held would stall the shard a full TTL per restart.
                continue
            for shard_id in job.shard_ids():
                if self.bus.fetch("result",
                                  lease_name(job.job_id, shard_id)):
                    continue            # already finished by someone
                lease = claim_shard(self.bus, job, shard_id,
                                    self.worker_id, self.clock, self.ttl_s)
                if lease is None:
                    continue
                tr = obs.tracer()
                try:
                    if tr is not None:
                        with tr.span("fleet.shard", cat="fleet",
                                     job=job.job_id, shard=shard_id,
                                     worker=self.worker_id):
                            self._run_shard(job, shard_id, lease)
                    else:
                        self._run_shard(job, shard_id, lease)
                except LeaseLost:
                    continue            # reclaimed under us: theirs now
                name = lease_name(job.job_id, shard_id)
                self.shards_done.append(name)
                m = obs.metrics()
                if m is not None:
                    m.counter("fleet.shards_done",
                              worker=self.worker_id).inc()
                return name
        return None

    def drain(self, max_shards: int | None = None) -> int:
        """Run shards until none are claimable; returns how many ran."""
        n = 0
        while max_shards is None or n < max_shards:
            if self.run_once() is None:
                break
            n += 1
        return n

    # -- one shard -------------------------------------------------------------

    def _run_shard(self, job: TuningJob, shard_id: str,
                   lease: Lease) -> None:
        name = lease_name(job.job_id, shard_id)
        builder = get_kernel(job.kernel)
        index = job.shard_index(shard_id)
        space = builder.space.shard(index, job.n_shards)
        if self.evaluator_factory is not None:
            base = self.evaluator_factory(builder, job)
        else:
            base = CostModelEvaluator(builder, job.problem, job.dtype,
                                      get_device(job.device_kind),
                                      verify="none")
        # Every shard evaluation runs through the sandbox: a candidate
        # that hangs/crashes/raises becomes an infeasible result with a
        # ``sandbox:<verdict>`` error — checkpointed like any other
        # evaluation — instead of killing the worker (and stalling the
        # shard a full lease TTL).
        evaluator = SandboxedEvaluator(base, self.sandbox)
        # Resume: a previous (crashed) holder's checkpointed evaluations.
        state = self.bus.fetch("state", name)
        history = [evaluation_from_json(e)
                   for e in (state or {}).get("evaluations", [])]
        log: list[Evaluation] = list(history)
        # Warm start: the scenario's recorded tuning-space dataset, if
        # this worker has one. Only entries *inside* the shard are
        # eligible (off-shard replays would leak measurements across the
        # disjoint shard partition); checkpointed evaluations win on
        # collision (they are this job's own lineage). Dataset history is
        # replayed by the session but not re-published in checkpoints —
        # every peer can read the same dataset itself.
        if self.datasets is not None:
            dataset = self.datasets.load_for(job.kernel, job.device_kind,
                                             job.problem, job.dtype)
            if dataset is not None:
                from repro_torch.tunebench import history_from_dataset
                seen = {space.freeze(e.config) for e in history}
                prior = [e for e in history_from_dataset(dataset, space)
                         if space.freeze(e.config) not in seen]
                history = prior + history
        live = 0

        def checkpoint() -> None:
            # Ownership check (heartbeat raises LeaseLost) BEFORE the
            # state write: a stalled worker whose shard was reclaimed must
            # not clobber the new owner's checkpoints.
            heartbeat(self.bus, lease, self.clock, self.ttl_s)
            self.bus.publish("state", name, {
                "job": job.job_id, "shard": shard_id,
                "worker": self.worker_id,
                "evaluations": [evaluation_to_json(e) for e in log]})

        def evaluate(config: Config) -> EvalResult:
            nonlocal live
            if not space.is_valid(config):
                # outside this shard (or restricted): never measured, so
                # shard result sets stay disjoint across the job
                return EvalResult(INFEASIBLE, False, error="off-shard")
            r = evaluator(config)
            log.append(Evaluation(config=dict(config), score_us=r.score_us,
                                  feasible=r.feasible, wall_s=0.0,
                                  error=r.error))
            live += 1
            self.evals_run += 1
            m = obs.metrics()
            if m is not None:
                m.counter("fleet.shard_evals",
                          worker=self.worker_id).inc()
            if (self.crash_after_evals is not None
                    and live >= self.crash_after_evals):
                self.crash_after_evals = None
                checkpoint()        # the crash loses nothing measured
                raise WorkerCrash(f"{self.worker_id} crashed in {name}")
            if live % self.checkpoint_every == 0:
                checkpoint()
            return r

        result = self._run_strategy(job, shard_id, space, evaluate, history)
        # Ownership check BEFORE the result write (raises LeaseLost). The
        # claim-race safety argument in jobs.claim_shard assumes duplicate
        # shard runs publish identical bytes; dataset warm-starts are
        # per-worker, so a stalled holder's un-warm-started session may
        # have found a *different* (equally valid) result and must not
        # clobber the reclaiming owner's published one.
        heartbeat(self.bus, lease, self.clock, self.ttl_s)
        self._publish_result(job, shard_id, name, result)
        release(self.bus, lease)

    def _run_strategy(self, job: TuningJob, shard_id: str, space, evaluate,
                      history: list[Evaluation]) -> TuningResult:
        if job.strategy not in STRATEGIES:
            raise ValueError(f"job {job.job_id}: unknown strategy "
                             f"{job.strategy!r}; have {sorted(STRATEGIES)}")
        if job.strategy == "exhaustive":
            return STRATEGIES["exhaustive"](space, evaluate,
                                            limit=job.max_evals_per_shard,
                                            history=history)
        rng = np.random.default_rng(job.shard_seed(shard_id))
        return STRATEGIES[job.strategy](space, evaluate,
                                        max_evals=job.max_evals_per_shard,
                                        rng=rng, time_budget_s=None,
                                        history=history)

    def _publish_result(self, job: TuningJob, shard_id: str, name: str,
                        result: TuningResult) -> None:
        self.bus.publish("result", name, {
            "job": job.job_id, "shard": shard_id, "worker": self.worker_id,
            "strategy": result.strategy,
            "evals": len(result.evaluations),
            "feasible_evals": len(result.feasible_evaluations),
            "best_config": result.best_config,
            "best_score_us": (result.best_score_us
                              if result.best_config is not None else None),
        })
