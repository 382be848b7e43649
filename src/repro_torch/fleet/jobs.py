"""Tuning jobs, shard partitioning, and crash-safe shard leases.

A :class:`TuningJob` is one prioritized (kernel, device, problem, dtype)
scenario turned into work: its config space is deterministically
partitioned into ``n_shards`` disjoint shards
(:meth:`~repro_torch.core.param.ConfigSpace.shard`), each tuned independently
under its own eval budget. The shard set depends only on the job spec —
never on how many workers happen to exist — so the assembled result is
identical whether one worker drains every shard or twenty race for them.

Shards are claimed through *lease* documents on the control bus:

  * a lease is live until ``expires_at`` (heartbeats extend it);
  * claiming is write-then-verify: publish a claim carrying a unique
    nonce, read it back, and only the claimant whose nonce survived the
    last-writer-wins race owns the shard — the same discipline the
    atomic-rename directory transport makes safe for wisdom files;
  * a crashed worker stops heartbeating, its lease expires, and the next
    worker re-claims (``claims`` counts hand-offs); the dead worker's
    checkpointed evaluations (``state`` channel) warm-start the retry.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from repro_torch.obs import runtime as obs
from repro_torch.online.tracker import ScenarioKey, format_key, parse_key

from .bus import Clock, ControlBus

#: Default lease time-to-live. Workers heartbeat at every checkpoint, so
#: this only bounds how long a crashed worker's shard stays stuck.
LEASE_TTL_S = 60.0


def _lease_event(event: str, worker: str) -> None:
    m = obs.metrics()
    if m is not None:
        m.counter("fleet.lease", event=event, worker=worker).inc()


@dataclass
class TuningJob:
    """One scenario's worth of sharded tuning work.

    The published spec every worker reads: which kernel/scenario to
    tune, with what strategy and per-shard budget, split into
    ``n_shards`` deterministic config-space shards. The shard set is a
    pure function of this spec (never of the worker population), which
    is what makes assembled results schedule-independent.

    Example::

        job = TuningJob(job_id=job_id_for("matmul", key), kernel="matmul",
                        device_kind="gpu-h100", problem=(256, 256, 256),
                        dtype="float32", n_shards=4)
        bus.publish("job", job.job_id, job.to_json())
    """
    job_id: str
    kernel: str
    device_kind: str
    problem: tuple[int, ...]
    dtype: str
    strategy: str = "exhaustive"
    n_shards: int = 4
    max_evals_per_shard: int = 200
    seed: int = 0
    round_: int = 0
    misses: int = 0            # fleet demand when the job was planned
    order: int = 0             # coordinator priority rank (workers obey)

    def scenario_key(self) -> ScenarioKey:
        return (self.device_kind, tuple(self.problem), self.dtype)

    def shard_ids(self) -> list[str]:
        return [f"s{i:03d}" for i in range(self.n_shards)]

    def shard_index(self, shard_id: str) -> int:
        return int(shard_id[1:])

    def shard_seed(self, shard_id: str) -> int:
        h = hashlib.sha256(
            f"{self.seed}|{self.job_id}|{shard_id}".encode()).digest()
        return int.from_bytes(h[:8], "little")

    def to_json(self) -> dict:
        return {
            "job_id": self.job_id, "kernel": self.kernel,
            "scenario": format_key(self.scenario_key()),
            "strategy": self.strategy, "n_shards": self.n_shards,
            "max_evals_per_shard": self.max_evals_per_shard,
            "seed": self.seed, "round": self.round_,
            "misses": self.misses, "order": self.order,
        }

    @staticmethod
    def from_json(d: dict) -> "TuningJob":
        device_kind, problem, dtype = parse_key(d["scenario"])
        return TuningJob(
            job_id=d["job_id"], kernel=d["kernel"],
            device_kind=device_kind, problem=problem, dtype=dtype,
            strategy=d.get("strategy", "exhaustive"),
            n_shards=int(d.get("n_shards", 4)),
            max_evals_per_shard=int(d.get("max_evals_per_shard", 200)),
            seed=int(d.get("seed", 0)), round_=int(d.get("round", 0)),
            misses=int(d.get("misses", 0)), order=int(d.get("order", 0)))


def job_id_for(kernel: str, key: ScenarioKey, round_: int = 0) -> str:
    """Deterministic job identity: same scenario + round -> same id on
    every coordinator, so concurrent planners collide into one job
    instead of duplicating work.

    Example::

        job_id_for("matmul", ("gpu-h100", (256, 256, 256), "float32"))
        # -> 'j-<10 hex chars>-r0'
    """
    h = hashlib.sha256(f"{kernel}|{format_key(key)}".encode())
    return f"j-{h.hexdigest()[:10]}-r{round_}"


def list_jobs(bus: ControlBus) -> list[TuningJob]:
    """All published jobs, in coordinator priority order.

    Workers iterate this to find claimable shards (highest-priority
    first); the ``order`` field pins the coordinator's ranking so every
    worker walks jobs in the same sequence.

    Example::

        for job in list_jobs(bus):
            for shard_id in job.shard_ids():
                ...
    """
    jobs = [TuningJob.from_json(d) for d in bus.docs("job")]
    jobs.sort(key=lambda j: (j.order, j.job_id))
    return jobs


# ------------------------------- leases -------------------------------------

def lease_name(job_id: str, shard_id: str) -> str:
    """Canonical ``job--shard`` document name: the shared key under
    which one shard's lease, checkpointed state, and result live on
    their respective channels. Example:
    ``bus.fetch("result", lease_name(job.job_id, "s002"))``."""
    return f"{job_id}--{shard_id}"


@dataclass
class Lease:
    """Ownership claim on one shard (a document on the ``lease`` channel).

    Carries the claimant's identity plus a per-claim ``nonce`` — the
    write-then-verify token that resolves claim races — and
    ``expires_at``, after which a non-heartbeating holder is presumed
    dead and the shard is reclaimable. ``claims`` counts hand-offs
    across crashes.

    Example::

        lease = claim_shard(bus, job, "s000", "w1", clock)
        heartbeat(bus, lease, clock)     # extend while tuning
        release(bus, lease)              # mark done
    """

    job_id: str
    shard_id: str
    worker: str
    nonce: str
    claims: int
    expires_at: float
    state: str = "claimed"     # claimed | done

    def to_json(self) -> dict:
        return {"job": self.job_id, "shard": self.shard_id,
                "worker": self.worker, "nonce": self.nonce,
                "claims": self.claims, "expires_at": self.expires_at,
                "state": self.state}

    @staticmethod
    def from_json(d: dict) -> "Lease":
        return Lease(job_id=d["job"], shard_id=d["shard"],
                     worker=d["worker"], nonce=d["nonce"],
                     claims=int(d.get("claims", 1)),
                     expires_at=float(d.get("expires_at", 0.0)),
                     state=d.get("state", "claimed"))


class LeaseLost(RuntimeError):
    """The shard's lease no longer carries our nonce: it expired and was
    reclaimed (or lost the initial claim race). The holder must abandon
    the shard — the new owner resumes from the last checkpoint.

    Raised by :func:`heartbeat` and :func:`release`; workers catch it
    around the whole shard run (for example
    ``try: ... except LeaseLost: continue``) and move on to the next
    claimable shard.
    """


def fetch_lease(bus: ControlBus, job_id: str, shard_id: str) -> Lease | None:
    """Read one shard's current lease document, or None when the shard
    has never been claimed. Read-only — status displays and claim
    checks use it. Example: ``fetch_lease(bus, job.job_id, "s001")``."""
    doc = bus.fetch("lease", lease_name(job_id, shard_id))
    return Lease.from_json(doc) if doc is not None else None


def _verify_owned(bus: ControlBus, lease: Lease) -> None:
    cur = fetch_lease(bus, lease.job_id, lease.shard_id)
    if cur is None or cur.nonce != lease.nonce:
        _lease_event("lost", lease.worker)
        raise LeaseLost(
            f"{lease.worker} no longer holds "
            f"{lease_name(lease.job_id, lease.shard_id)} "
            f"(now: {cur.nonce if cur else 'gone'})")


def claim_shard(bus: ControlBus, job: TuningJob, shard_id: str,
                worker_id: str, clock: Clock,
                ttl_s: float = LEASE_TTL_S) -> Lease | None:
    """Try to claim one shard. Returns the owned lease, or None when the
    shard is done, live under another worker, or lost to a racing claim.

    The write-then-verify read-back rejects the *observable* race, but
    two claimants interleaving fetch/publish/fetch can both pass it (the
    transport has no exclusive-create). That is wasted work, never
    corruption: :func:`heartbeat` re-verifies ownership at every
    checkpoint, so the overwritten claimant aborts at its next
    checkpoint, and shard results are deterministic and assembly
    idempotent, so even a duplicated shard publishes identical bytes.

    Example::

        lease = claim_shard(bus, job, "s000", "w1", WallClock())
        if lease is not None:
            ...   # we own the shard until lease.expires_at
    """
    cur = fetch_lease(bus, job.job_id, shard_id)
    now = clock.now()
    if cur is not None and (cur.state == "done" or cur.expires_at > now):
        return None
    claims = (cur.claims if cur else 0) + 1
    lease = Lease(job_id=job.job_id, shard_id=shard_id, worker=worker_id,
                  nonce=f"{worker_id}.{claims}", claims=claims,
                  expires_at=now + ttl_s)
    bus.publish("lease", lease_name(job.job_id, shard_id), lease.to_json())
    check = fetch_lease(bus, job.job_id, shard_id)
    if check is not None and check.nonce == lease.nonce \
            and check.worker == worker_id:
        _lease_event("reclaim" if claims > 1 else "acquire", worker_id)
        return check
    _lease_event("race_lost", worker_id)
    return None                 # lost the last-writer-wins race


def heartbeat(bus: ControlBus, lease: Lease, clock: Clock,
              ttl_s: float = LEASE_TTL_S) -> Lease:
    """Extend a held lease's expiry (call at every checkpoint).

    Verifies ownership first and raises :class:`LeaseLost` if the lease
    was reclaimed meanwhile — a stalled worker must never steal back a
    shard another worker is already tuning (that would both duplicate
    work and corrupt the ``claims`` hand-off count).

    Example::

        heartbeat(bus, lease, clock)     # at every checkpoint
    """
    _verify_owned(bus, lease)
    lease.expires_at = clock.now() + ttl_s
    bus.publish("lease", lease_name(lease.job_id, lease.shard_id),
                lease.to_json())
    _lease_event("heartbeat", lease.worker)
    return lease


def release(bus: ControlBus, lease: Lease) -> None:
    """Mark a shard finished; a done lease is never reclaimed.

    Raises :class:`LeaseLost` when the lease was reclaimed meanwhile
    (the new owner, not us, gets to finish the shard). Call only after
    the shard's result document is published, so a "done" lease always
    has a result behind it.

    Example::

        bus.publish("result", name, result_doc)
        release(bus, lease)
    """
    _verify_owned(bus, lease)
    lease.state = "done"
    bus.publish("lease", lease_name(lease.job_id, lease.shard_id),
                lease.to_json())
    _lease_event("release", lease.worker)
