"""``python -m repro_torch.fleet`` — operate the fleet tuning orchestrator.

Port of ``repro.fleet.cli``.
The rendezvous point is a shared wisdom directory (the same one
``python -m repro_torch.wisdom`` manages and serving hosts PullSync from);
control documents live beside the wisdom files under the reserved
``fleet--`` namespace. Subcommands:

  plan        aggregate demand, rank scenarios, publish tuning jobs
              (``--dry-run`` prints the plan without publishing)
  coordinate  run coordination rounds: assemble finished jobs into fleet
              wisdom, then re-plan from fresh demand
  work        run a worker loop: claim shard leases, tune, checkpoint
  status      one-screen summary of demand / jobs / leases / results
  demo        run the in-process reference fleet (run_local_fleet) —
              the zero-setup way to watch the whole loop

A real deployment runs ``work`` on every tuning host, ``coordinate`` on
one (any) host, and whatever serves traffic keeps publishing demand.

``coordinate`` and ``demo`` hold shard winners to the plain version on
``--device``, the card by default; without one they raise unless given
``--device cpu``. ``--dir`` defaults to the port's own wisdom directory
(``$KERNEL_LAUNCHER_WISDOM_DIR`` or ``./wisdom-torch``).
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.core.wisdom import default_wisdom_dir
from repro_torch.distrib.sync import DirectoryTransport

from .bus import ControlBus
from .coordinator import MIN_MISSES, Coordinator
from .demand import aggregate_demand, prioritize
from .health import MetricsPublisher, fleet_snapshots
from .jobs import LEASE_TTL_S, fetch_lease, lease_name, list_jobs
from .local import run_local_fleet
from .worker import FleetWorker


def _bus(args) -> ControlBus:
    if args.dir is None:
        args.dir = str(default_wisdom_dir())
    return ControlBus(DirectoryTransport(args.dir))


def _coordinator(args, bus: ControlBus, gate: bool) -> Coordinator:
    """The CLI's coordinator; ``gate`` for the commands that assemble
    (planning alone never checks a winner, so it needs no device)."""
    kw = {"device": args.device} if gate else {"oracle": None}
    return Coordinator(bus, n_shards=args.shards,
                       max_evals_per_shard=args.evals_per_shard,
                       strategy=args.strategy, min_misses=args.min_misses,
                       seed=args.seed, **kw)


def _cmd_plan(args) -> int:
    bus = _bus(args)
    coord = _coordinator(args, bus, gate=False)
    # Filter before ranking, like Coordinator.plan: the speedup probe
    # costs ~16 cost-model evals per scenario, and in steady state most
    # published scenarios are below threshold or already answered.
    entries = aggregate_demand(bus)
    actionable = [e for e in entries
                  if e.misses >= args.min_misses
                  and coord.decide(e) is not None]
    ranked = prioritize(actionable, bus.transport, seed=args.seed)
    if not entries:
        print("no demand published")
        return 0
    for p in ranked:
        e = p.entry
        print(f"{e.kernel} {e.key_str}: misses={e.misses} "
              f"workers={e.workers} speedup~{p.speedup:.2f}x "
              f"priority={p.priority:.1f}")
    if len(entries) > len(actionable):
        print(f"({len(entries) - len(actionable)} scenario(s) below "
              f"threshold or already answered)")
    if args.dry_run:
        print("(dry run: no jobs published)")
        return 0
    jobs = coord.plan(ranked=ranked)
    for job in jobs:
        print(f"planned {job.job_id}: {job.kernel} "
              f"{job.n_shards} shard(s) x {job.max_evals_per_shard} evals "
              f"({job.strategy})")
    print(f"{len(jobs)} job(s) published")
    return 0


def _cmd_coordinate(args) -> int:
    bus = _bus(args)
    coord = _coordinator(args, bus, gate=True)
    for i in range(args.rounds):
        report = coord.tick()
        print(f"round {i}: assembled={len(report.assembled)} "
              f"planned={len(report.planned)} "
              f"requeued={len(report.requeued)} "
              f"verify={len(report.verify)}")
        if report.idle:
            break
    print(json.dumps(coord.status(), indent=2))
    return 0


def _cmd_work(args) -> int:
    bus = _bus(args)
    datasets = None
    if args.dataset_dir is not None:
        from repro_torch.tunebench import DatasetStore
        datasets = DatasetStore(args.dataset_dir)
    worker = FleetWorker(bus, args.worker_id, ttl_s=args.ttl,
                         checkpoint_every=args.checkpoint_every,
                         datasets=datasets)
    # One-shot drain exits once nothing is claimable *right now*. With
    # --poll the worker keeps watching while any shard still lacks a
    # result, so a peer's crashed shard is reclaimed when its lease
    # expires — without it, crash recovery needs a supervisor restarting
    # this command. (Assembly is the coordinator's job: a worker must not
    # wait on it, or the two one-shot commands would deadlock.)
    def unfinished_shards() -> bool:
        return any(
            bus.fetch("result", lease_name(j.job_id, s)) is None
            for j in list_jobs(bus)
            if bus.fetch("done", j.job_id) is None
            for s in j.shard_ids())

    # When observability is enabled (KERNEL_LAUNCHER_OBS=1 or
    # repro_torch.obs.enable()), every drain publishes this worker's metrics
    # snapshot onto the control bus so any host can render fleet-wide
    # health with ``python -m repro_torch.obs report --bus DIR``. A no-op
    # while disabled.
    publisher = MetricsPublisher(bus, args.worker_id, interval=1)
    n = worker.drain(max_shards=args.max_shards)
    publisher.tick()
    while args.poll is not None:
        if args.max_shards is not None and n >= args.max_shards:
            break
        if not unfinished_shards():
            break
        time.sleep(args.poll)
        n += worker.drain(max_shards=(None if args.max_shards is None
                                      else args.max_shards - n))
        publisher.tick()
    print(f"{args.worker_id}: finished {n} shard(s), "
          f"{worker.evals_run} evaluation(s)")
    for name in worker.shards_done:
        print(f"  {name}")
    return 0


def _cmd_status(args) -> int:
    bus = _bus(args)
    status = Coordinator(bus, oracle=None).status()
    print(f"{args.dir}: {status['demand_entries']} demand entr(ies), "
          f"{status['demand_misses']} miss(es), {status['jobs']} job(s) "
          f"({status['jobs_open']} open), "
          f"{status['shard_results']} shard result(s)")
    for s in status["scenarios"]:
        print(f"  demand {s['kernel']} {s['key']}: misses={s['misses']} "
              f"from {s['workers']} worker(s)")
    for job in list_jobs(bus):
        states = []
        for shard_id in job.shard_ids():
            if bus.fetch("result", lease_name(job.job_id, shard_id)):
                states.append("done")
                continue
            lease = fetch_lease(bus, job.job_id, shard_id)
            states.append(f"leased:{lease.worker}" if lease else "open")
        done = bus.fetch("done", job.job_id)
        tail = (f" -> {done['state']}" if done else "")
        print(f"  job {job.job_id} {job.kernel} "
              f"[{' '.join(states)}]{tail}")
    snaps = fleet_snapshots(bus)
    if snaps:
        print(f"  {len(snaps)} metrics snapshot(s) on the bus from "
              f"{', '.join(sorted(snaps))} "
              f"(render: python -m repro_torch.obs report --bus {args.dir})")
    return 0


def _cmd_demo(args) -> int:
    report = run_local_fleet(n_workers=args.workers,
                             n_shards=args.shards,
                             strategy=args.strategy,
                             max_evals_per_shard=args.evals_per_shard,
                             min_misses=args.min_misses, seed=args.seed,
                             device=args.device)
    print(f"{report.n_workers} worker(s): {report.steps} shard(s) run, "
          f"{report.total_evals} evaluation(s) "
          f"(busiest worker {report.makespan_evals})")
    for worker, shards in sorted(report.shards_by_worker.items()):
        print(f"  {worker}: {len(shards)} shard(s), "
              f"{report.evals_by_worker[worker]} eval(s)")
    for kernel, doc in sorted(report.wisdom_docs.items()):
        for rec in doc.get("records", []):
            print(f"  wisdom {kernel}: {rec['score_us']:.2f}us "
                  f"config={rec['config']}")
    return 0


def _add_tuning_args(p) -> None:
    p.add_argument("--shards", type=int, default=4,
                   help="shards per job (fixed per job, not per worker)")
    p.add_argument("--evals-per-shard", type=int, default=200)
    p.add_argument("--strategy", default="exhaustive",
                   choices=("exhaustive", "random", "bayes", "anneal"))
    p.add_argument("--min-misses", type=int, default=MIN_MISSES)
    p.add_argument("--seed", type=int, default=0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet",
        description="Fleet tuning orchestrator: demand-driven, sharded, "
                    "resumable tuning jobs over a shared wisdom directory.")
    sub = ap.add_subparsers(dest="command", required=True)

    def add_dir(p):
        p.add_argument("--dir", default=None,
                       help="shared wisdom/control directory (default: "
                            "$KERNEL_LAUNCHER_WISDOM_DIR or "
                            "./wisdom-torch)")

    def add_device(p):
        p.add_argument("--device", default="cuda",
                       help="torch device the correctness gate checks "
                            "shard winners on (default cuda; cpu holds the "
                            "plain versions to themselves)")

    p = sub.add_parser("plan", help="rank demand and publish tuning jobs")
    add_dir(p)
    _add_tuning_args(p)
    p.add_argument("--dry-run", action="store_true",
                   help="print the scenario plan without publishing jobs")
    p.set_defaults(fn=_cmd_plan)

    p = sub.add_parser("coordinate",
                       help="assemble finished jobs, re-plan from demand")
    add_dir(p)
    _add_tuning_args(p)
    add_device(p)
    p.add_argument("--rounds", type=int, default=1)
    p.set_defaults(fn=_cmd_coordinate)

    p = sub.add_parser("work", help="claim and tune open shards")
    add_dir(p)
    p.add_argument("--worker-id", required=True,
                   help="stable identity for leases (e.g. the hostname)")
    p.add_argument("--max-shards", type=int, default=None)
    p.add_argument("--ttl", type=float, default=LEASE_TTL_S)
    p.add_argument("--checkpoint-every", type=int, default=8)
    p.add_argument("--dataset-dir", default=None, metavar="DIR",
                   help="recorded tuning-space datasets "
                        "(repro_torch.tunebench): shard sessions replay "
                        "matching recorded evaluations instead of "
                        "re-measuring them")
    p.add_argument("--poll", type=float, default=None, metavar="SECONDS",
                   help="keep polling for claimable shards (incl. expired "
                        "leases of crashed peers) until no unfinished "
                        "shard remains; default is a one-shot drain")
    p.set_defaults(fn=_cmd_work)

    p = sub.add_parser("status", help="summarize demand/jobs/leases")
    add_dir(p)
    p.set_defaults(fn=_cmd_status)

    p = sub.add_parser("demo",
                       help="run the in-process reference fleet "
                            "(MemoryTransport, deterministic)")
    p.add_argument("--workers", type=int, default=3)
    _add_tuning_args(p)
    add_device(p)
    p.set_defaults(fn=_cmd_demo)

    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
