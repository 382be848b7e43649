"""The port's fleet tuning orchestrator (``repro_torch.fleet``) against the
JAX package's ``repro.fleet``: demand, sharding, leases, workers, the
coordinator and its correctness gate, the local harness, the CLI, fleet
health and the transfer verification loop.

Counterparts of ``tests/test_fleet.py`` plus the fleet cases of
``tests/test_obs.py`` and ``tests/test_transfer.py``. Each case runs both
packages on the same inputs, with the synthetic kernel registered in both
registries, and holds the port's control documents, job ids, shard
assignments, evaluation counts and assembled wisdom to the reference's.
Fleet provenance carries the framework version, so wisdom is compared with
``jax_version`` mapped to ``torch_version``; inside the port, 1 worker and
3 workers with a crash assemble the same bytes. The port's coordinator
gates on the card unless asked for the CPU, as every case here does.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core.registry as ref_registry
import repro.distrib as ref_distrib
import repro.fleet as ref_fleet
import repro.obs as ref_obs
import repro.online as ref_online
from repro.core import wisdom as ref_wisdom
from repro.core.builder import KernelBuilder as RefKernelBuilder
from repro.core.param import ConfigSpace as RefConfigSpace
from repro.core.workload import Workload as RefWorkload
from repro.fleet.cli import main as ref_fleet_cli

import repro_torch.core.registry as port_registry
import repro_torch.distrib as port_distrib
import repro_torch.fleet as port_fleet
import repro_torch.obs as port_obs
import repro_torch.online as port_online
from repro_torch.core import wisdom as port_wisdom
from repro_torch.core.builder import KernelBuilder
from repro_torch.core.param import ConfigSpace
from repro_torch.core.workload import Workload
from repro_torch.fleet.cli import main as port_fleet_cli

torch.set_num_threads(1)

KERNEL = "fleettestk"
SCENARIO_A = ("tpu-v5e", (128, 128), "float32")
SCENARIO_B = ("tpu-v5e", (512, 256), "float32")


def _make_test_kernel(builder_cls, workload_cls):
    """The reference test's synthetic kernel, declared in either package."""
    b = builder_cls(KERNEL, source="tests/test_torch_fleet.py")
    b.tune("bx", (8, 16, 32, 64), default=8)
    b.tune("by", (8, 16, 32, 64), default=8)
    b.restriction("bx * by <= 2048")

    @b.workload
    def _wl(config, problem, dtype):
        n = 1
        for d in problem:
            n *= int(d)
        tile = config["bx"] * config["by"]
        return workload_cls(flops=2.0 * n,
                            hbm_bytes=4.0 * n * (1 + 64 / tile),
                            vmem_bytes=tile * 4, grid=max(n // tile, 1),
                            lane_extent=config["bx"],
                            sublane_extent=min(config["by"], 8))

    return b


BUILDER = _make_test_kernel(KernelBuilder, Workload)
REF_BUILDER = _make_test_kernel(RefKernelBuilder, RefWorkload)
N_VALID = sum(1 for _ in BUILDER.space.enumerate())

#: One package's side of every case. ``kw`` is what its coordinator and
#: local harness need on a host without a card.
REF = SimpleNamespace(tag="ref", fleet=ref_fleet, distrib=ref_distrib,
                      online=ref_online, wisdom=ref_wisdom, obs=ref_obs,
                      registry=ref_registry, builder=REF_BUILDER,
                      cli=ref_fleet_cli, kw={})
PORT = SimpleNamespace(tag="port", fleet=port_fleet, distrib=port_distrib,
                       online=port_online, wisdom=port_wisdom, obs=port_obs,
                       registry=port_registry, builder=BUILDER,
                       cli=port_fleet_cli, kw={"device": "cpu"})
PKGS = (REF, PORT)


@pytest.fixture(autouse=True)
def _registered_kernel():
    """The synthetic kernel in both registries for the test, removed after
    it; observability off in both packages."""
    for pkg in PKGS:
        pkg.registry.register(pkg.builder)
        pkg.obs.runtime.disable()
    yield
    for pkg in PKGS:
        pkg.registry.unregister(KERNEL)
        pkg.obs.runtime.disable()


def coordinator(pkg, bus, **kw):
    return pkg.fleet.Coordinator(bus, **kw, **pkg.kw)


def local_fleet(pkg, **kw):
    return pkg.fleet.run_local_fleet(**kw, **pkg.kw)


def mapped(obj):
    """A wisdom document with the reference's version key mapped to the
    port's (``jax_version`` -> ``torch_version``, the port's value)."""
    if isinstance(obj, dict):
        return {("torch_version" if k == "jax_version" else k):
                (torch.__version__ if k in ("jax_version", "torch_version")
                 else mapped(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [mapped(x) for x in obj]
    return obj


def both(case):
    return {pkg.tag: case(pkg) for pkg in PKGS}


def _job(pkg, n_shards=2, max_evals=100, round_=0):
    return pkg.fleet.TuningJob(
        job_id=pkg.fleet.job_id_for(KERNEL, SCENARIO_A, round_),
        kernel=KERNEL, device_kind=SCENARIO_A[0], problem=SCENARIO_A[1],
        dtype=SCENARIO_A[2], n_shards=n_shards,
        max_evals_per_shard=max_evals, round_=round_)


# ------------------------------ scenario keys --------------------------------

def test_scenario_key_round_trips_canonically():
    for pkg in PKGS:
        key = ("gpu-h100", (256, 128, 8), "bfloat16")
        s = pkg.online.format_key(key)
        assert s == "gpu-h100|256x128x8|bfloat16"
        assert pkg.online.parse_key(s) == key
        assert pkg.online.parse_key(pkg.online.format_key(
            ("cpu", (), "float32"))) == ("cpu", (), "float32")
        with pytest.raises(ValueError):
            pkg.online.format_key(("bad|device", (1,), "float32"))
        with pytest.raises(ValueError):
            pkg.online.parse_key("only|two")


def test_scenario_stats_survive_json_transport():
    def case(pkg):
        t = pkg.online.ScenarioTracker()
        t.observe(*SCENARIO_A, tier="default", weight=4)
        t.observe(*SCENARIO_A, tier="device")
        snap = json.loads(json.dumps(t.snapshot()))
        st = pkg.online.ScenarioStats.from_json(snap[0])
        assert st.key == pkg.online.ScenarioTracker.key(*SCENARIO_A)
        assert isinstance(st.key[1], tuple)
        assert st.misses == 5 and st.launches == 2
        assert st.tiers == {"default": 1, "device": 1}
        return snap

    out = both(case)
    assert out["port"] == out["ref"]


# --------------------------------- demand ------------------------------------

def test_demand_aggregates_across_workers():
    def case(pkg):
        bus = pkg.fleet.ControlBus(pkg.distrib.MemoryTransport())
        pkg.fleet.seed_demand(bus, "w0", [(KERNEL, SCENARIO_A, 5)])
        pkg.fleet.seed_demand(bus, "w1", [(KERNEL, SCENARIO_A, 2),
                                          (KERNEL, SCENARIO_B, 7)])
        # republishing w0 replaces its snapshot, never double-counts
        pkg.fleet.seed_demand(bus, "w0", [(KERNEL, SCENARIO_A, 5)])
        table = {e.key: e for e in pkg.fleet.aggregate_demand(bus)}
        assert table[SCENARIO_A].misses == 7
        assert table[SCENARIO_A].workers == 2
        assert table[SCENARIO_B].misses == 7
        assert table[SCENARIO_B].workers == 1
        return ([dataclasses.astuple(e) for e in table.values()],
                bus.transport.docs)

    out = both(case)
    assert out["port"] == out["ref"]


def test_prioritize_orders_by_misses_times_speedup():
    def case(pkg):
        transport = pkg.distrib.MemoryTransport()
        bus = pkg.fleet.ControlBus(transport)
        pkg.fleet.seed_demand(bus, "w0", [(KERNEL, SCENARIO_A, 3),
                                          (KERNEL, SCENARIO_B, 3)])
        ranked = pkg.fleet.prioritize(pkg.fleet.aggregate_demand(bus),
                                      transport)
        assert len(ranked) == 2
        for p in ranked:
            assert p.speedup >= 1.0
            assert p.priority == pytest.approx(p.entry.misses * p.speedup)
        assert ranked[0].priority >= ranked[1].priority
        # unknown kernels cannot be ranked here and are skipped
        pkg.fleet.seed_demand(bus, "w1", [("no-such-kernel", SCENARIO_A, 9)])
        assert len(pkg.fleet.prioritize(pkg.fleet.aggregate_demand(bus),
                                        transport)) == 2
        return [(p.entry.key, p.current_score_us, p.probe_score_us,
                 p.speedup) for p in ranked]

    out = both(case)
    assert [r[0] for r in out["port"]] == [r[0] for r in out["ref"]]
    assert np.allclose([r[1:] for r in out["port"]],
                       [r[1:] for r in out["ref"]], rtol=1e-12, atol=0)


# -------------------------------- sharding -----------------------------------

def test_space_shard_partitions_exactly():
    space, ref_space = BUILDER.space, REF_BUILDER.space
    full = {space.freeze(c) for c in space.enumerate()}
    n = 3
    for i in range(n):
        sub, ref_sub = space.shard(i, n), ref_space.shard(i, n)
        assert ([sub.freeze(c) for c in sub.enumerate()]
                == [ref_sub.freeze(c) for c in ref_sub.enumerate()])
    seen = [c for i in range(n) for c in
            (space.shard(i, n).freeze(c)
             for c in space.shard(i, n).enumerate())]
    assert len(seen) == len(set(seen)) and set(seen) == full
    assert {space.freeze(c) for c in space.shard(0, 1).enumerate()} == full
    with pytest.raises(ValueError):
        space.shard(3, 3)


def test_config_hash_is_process_stable():
    hashes = []
    for cls in (ConfigSpace, RefConfigSpace):
        space = cls()
        space.tune("a", (1, 2, 3))
        space.tune("b", ("x", "y"))
        assert space.config_hash({"a": 2, "b": "y"}) == \
            space.config_hash({"b": "y", "a": 2})
        hashes.append([space.config_hash({"a": a, "b": b})
                       for a in (1, 2, 3) for b in ("x", "y")])
    assert hashes[0] == hashes[1]


# --------------------------------- leases ------------------------------------

def test_lease_claim_conflict_expiry_reclaim():
    def case(pkg):
        f = pkg.fleet
        bus = f.ControlBus(pkg.distrib.MemoryTransport())
        clock = f.ManualClock()
        job = _job(pkg)
        lease = f.claim_shard(bus, job, "s000", "w0", clock, ttl_s=30.0)
        assert lease.worker == "w0" and lease.claims == 1
        assert f.claim_shard(bus, job, "s000", "w1", clock, ttl_s=30.0) \
            is None
        clock.advance(31.0)
        lease2 = f.claim_shard(bus, job, "s000", "w1", clock, ttl_s=30.0)
        assert lease2.worker == "w1" and lease2.claims == 2
        f.release(bus, lease2)
        clock.advance(100.0)
        assert f.claim_shard(bus, job, "s000", "w2", clock, ttl_s=30.0) \
            is None
        assert f.fetch_lease(bus, job.job_id, "s000").state == "done"
        return bus.transport.docs

    out = both(case)
    assert out["port"] == out["ref"]


def test_lease_claimable_exactly_at_expiry_boundary():
    """``expires_at == now`` is expired: the boundary instant belongs to
    the reclaimer, and the stale holder finds out at its heartbeat."""
    def case(pkg):
        f = pkg.fleet
        bus = f.ControlBus(pkg.distrib.MemoryTransport())
        clock = f.ManualClock()
        job = _job(pkg)
        stale = f.claim_shard(bus, job, "s000", "w0", clock, ttl_s=30.0)
        clock.advance(30.0)
        assert clock.now() == stale.expires_at
        fresh = f.claim_shard(bus, job, "s000", "w1", clock, ttl_s=30.0)
        assert fresh is not None and fresh.claims == 2
        with pytest.raises(f.LeaseLost):
            f.heartbeat(bus, stale, clock, ttl_s=30.0)
        return bus.transport.docs

    out = both(case)
    assert out["port"] == out["ref"]


def test_heartbeat_at_exact_expiry_renews_unclaimed_lease():
    def case(pkg):
        f = pkg.fleet
        bus = f.ControlBus(pkg.distrib.MemoryTransport())
        clock = f.ManualClock()
        job = _job(pkg)
        lease = f.claim_shard(bus, job, "s000", "w0", clock, ttl_s=30.0)
        clock.advance(30.0)
        renewed = f.heartbeat(bus, lease, clock, ttl_s=30.0)
        assert renewed.expires_at == clock.now() + 30.0
        assert renewed.claims == 1
        assert f.claim_shard(bus, job, "s000", "w1", clock, ttl_s=30.0) \
            is None
        return bus.transport.docs

    out = both(case)
    assert out["port"] == out["ref"]


def test_reclaim_racing_same_tick_heartbeat_leaves_one_owner():
    def case(pkg):
        f = pkg.fleet
        job = _job(pkg)
        # ordering A: the stale holder heartbeats first, reclaim bounces
        bus = f.ControlBus(pkg.distrib.MemoryTransport())
        clock = f.ManualClock()
        holder = f.claim_shard(bus, job, "s000", "w0", clock, ttl_s=30.0)
        clock.advance(30.0)
        f.heartbeat(bus, holder, clock, ttl_s=30.0)
        assert f.claim_shard(bus, job, "s000", "w1", clock, ttl_s=30.0) \
            is None
        assert f.fetch_lease(bus, job.job_id, "s000").worker == "w0"
        # ordering B: the reclaimer publishes first, the heartbeat refuses
        bus_b = f.ControlBus(pkg.distrib.MemoryTransport())
        clock = f.ManualClock()
        holder = f.claim_shard(bus_b, job, "s000", "w0", clock, ttl_s=30.0)
        clock.advance(30.0)
        assert f.claim_shard(bus_b, job, "s000", "w1", clock,
                             ttl_s=30.0) is not None
        with pytest.raises(f.LeaseLost):
            f.heartbeat(bus_b, holder, clock, ttl_s=30.0)
        cur = f.fetch_lease(bus_b, job.job_id, "s000")
        assert cur.worker == "w1" and cur.claims == 2
        return bus.transport.docs, bus_b.transport.docs

    out = both(case)
    assert out["port"] == out["ref"]


def test_stalled_worker_cannot_steal_back_reclaimed_lease():
    def case(pkg):
        f = pkg.fleet
        bus = f.ControlBus(pkg.distrib.MemoryTransport())
        clock = f.ManualClock()
        job = _job(pkg)
        stale = f.claim_shard(bus, job, "s000", "w0", clock, ttl_s=30.0)
        clock.advance(31.0)
        fresh = f.claim_shard(bus, job, "s000", "w1", clock, ttl_s=30.0)
        assert fresh.claims == 2
        with pytest.raises(f.LeaseLost):
            f.heartbeat(bus, stale, clock, ttl_s=30.0)
        with pytest.raises(f.LeaseLost):
            f.release(bus, stale)
        cur = f.fetch_lease(bus, job.job_id, "s000")
        assert cur.worker == "w1" and cur.claims == 2
        assert cur.state != "done"
        f.heartbeat(bus, fresh, clock, ttl_s=30.0)
        return bus.transport.docs

    out = both(case)
    assert out["port"] == out["ref"]


def test_lease_lifecycle_metrics():
    def case(pkg):
        f = pkg.fleet
        reg, _ = pkg.obs.runtime.enable()
        bus = f.ControlBus(pkg.distrib.MemoryTransport())
        clock = f.ManualClock()
        lease = f.claim_shard(bus, _job(pkg), "s000", "w1", clock)
        f.heartbeat(bus, lease, clock)
        assert f.claim_shard(bus, _job(pkg), "s000", "w2", clock) is None
        clock.advance(120.0)
        stolen = f.claim_shard(bus, _job(pkg), "s000", "w2", clock)
        assert stolen.claims == 2
        f.release(bus, stolen)
        with pytest.raises(f.LeaseLost):
            f.heartbeat(bus, lease, clock)
        counters = reg.snapshot()["counters"]
        pkg.obs.runtime.disable()
        return counters

    out = both(case)
    assert out["port"] == out["ref"]
    assert out["port"] == {
        f"fleet.lease{{event={e},worker={w}}}": 1 for e, w in (
            ("acquire", "w1"), ("heartbeat", "w1"), ("reclaim", "w2"),
            ("release", "w2"), ("lost", "w1"))}


def test_job_round_trips_and_id_deterministic():
    def case(pkg):
        job = _job(pkg, n_shards=5, max_evals=42, round_=2)
        again = pkg.fleet.TuningJob.from_json(
            json.loads(json.dumps(job.to_json())))
        assert again == job
        ids = [pkg.fleet.job_id_for(KERNEL, SCENARIO_A, r) for r in (0, 1)]
        assert ids[0] != ids[1]
        assert job.shard_seed("s000") != job.shard_seed("s001")
        return (job.to_json(), ids,
                [job.shard_seed(s) for s in job.shard_ids()])

    out = both(case)
    assert out["port"] == out["ref"]


# ----------------------------- worker + coordinator --------------------------

def test_single_worker_drains_job_and_assembles_wisdom():
    def case(pkg):
        f = pkg.fleet
        transport = pkg.distrib.MemoryTransport()
        bus = f.ControlBus(transport)
        f.seed_demand(bus, "svc", [(KERNEL, SCENARIO_A, 5)])
        coord = coordinator(pkg, bus, n_shards=2, max_evals_per_shard=100)
        jobs = coord.plan()
        assert len(jobs) == 1
        worker = f.FleetWorker(bus, "w0", clock=f.ManualClock())
        assert worker.drain() == 2
        assert worker.evals_run == N_VALID
        rec, = coord.assemble()
        assert rec.provenance["source"] == "fleet"
        assert rec.provenance["evaluations"] == N_VALID
        assert rec.provenance["job"] == jobs[0].job_id
        assert "date" not in rec.provenance
        assert len(transport.fetch(KERNEL)["records"]) == 1
        assert coord.tick().idle
        return mapped(transport.docs), coord.status()

    out = both(case)
    assert out["port"] == out["ref"]


def test_acceptance_crash_reclaim_byte_identical_wisdom():
    """3 workers with a forced crash vs 1 worker, in the port; and the
    port's run is the reference's."""
    demand = [(KERNEL, SCENARIO_A, 5), (KERNEL, SCENARIO_B, 4)]
    kw = dict(demand=demand, n_shards=4, strategy="exhaustive",
              checkpoint_every=2, seed=0)
    r3 = local_fleet(PORT, n_workers=3, crash_worker="w0",
                     crash_after_evals=3, **kw)
    r1 = local_fleet(PORT, n_workers=1, **kw)
    ref3 = local_fleet(REF, n_workers=3, crash_worker="w0",
                       crash_after_evals=3, **kw)

    assert len(r3.jobs_assembled) == 2 and r3.status["jobs_open"] == 0
    assert r3.crashes == 1
    claims = r3.claims()
    assert sorted(claims.values()) == [1] * 7 + [2]
    crashed = [n for n, c in claims.items() if c == 2][0]
    assert r3.leases[crashed].state == "done"
    assert r3.leases[crashed].worker != "w0"
    assert r3.total_evals == r1.total_evals == 2 * N_VALID
    assert json.dumps(r3.wisdom_docs, sort_keys=True) \
        == json.dumps(r1.wisdom_docs, sort_keys=True)
    # the fleet optimum is a plain single-space exhaustive tune's
    from repro_torch.core import get_device
    from repro_torch.tuner import CostModelEvaluator, tune_exhaustive
    ev = CostModelEvaluator(BUILDER, SCENARIO_A[1], SCENARIO_A[2],
                            get_device(SCENARIO_A[0]), verify="none")
    offline = tune_exhaustive(BUILDER.space, ev)
    rec, = [r for r in r3.wisdom_docs[KERNEL]["records"]
            if tuple(r["problem_size"]) == SCENARIO_A[1]]
    assert rec["config"] == offline.best_config
    assert rec["score_us"] == pytest.approx(offline.best_score_us)
    # and it is the reference's run
    assert r3.claims() == ref3.claims()
    assert r3.shards_by_worker == ref3.shards_by_worker
    assert r3.evals_by_worker == ref3.evals_by_worker
    assert mapped(r3.wisdom_docs) == mapped(ref3.wisdom_docs)


@pytest.fixture()
def reference_matmul_in_the_port():
    """The reference's ``matmul`` space and TPU workload model, registered
    as the port's ``matmul`` for one test (the port's own builder is
    Hopper-native, with other axes): both packages then search the same
    space under the same cost model. Its gate hooks are the port's plain
    matmul, so the gate's verdict and stamp are the reference's."""
    from repro.core.registry import get_kernel as ref_get_kernel
    from repro_torch.kernels.ref import matmul_ref
    own = port_registry.get_kernel("matmul")
    ref_b = ref_get_kernel("matmul")
    b = KernelBuilder("matmul", source="tests/test_torch_fleet.py")
    for name, p in ref_b.space.params.items():
        b.tune(name, p.values, default=p.default)
    b.workload(lambda config, problem, dtype: Workload(
        **dataclasses.asdict(ref_b.make_workload(config, problem, dtype))))
    b.probe(own._probe)
    b.build(lambda config, problem, meta: matmul_ref)
    b.reference(matmul_ref)
    port_registry.unregister("matmul")
    port_registry.register(b)
    yield b
    port_registry.unregister("matmul")
    port_registry.register(own)


def test_local_fleet_on_the_references_demo_demand_is_the_references(
        reference_matmul_in_the_port):
    """``run_local_fleet`` with the reference's ``DEMO_DEMAND``, 3 workers
    and ``w1`` crashing after 13 evaluations: the same job ids, shards by
    worker, evaluation counts, leases, configs and scores."""
    from repro.fleet.local import DEMO_DEMAND
    kw = dict(n_workers=3, demand=DEMO_DEMAND, crash_worker="w1",
              crash_after_evals=13)
    ref, port = local_fleet(REF, **kw), local_fleet(PORT, **kw)
    assert port.jobs_planned == ref.jobs_planned
    assert port.jobs_assembled == ref.jobs_assembled
    assert port.shards_by_worker == ref.shards_by_worker
    assert port.evals_by_worker == ref.evals_by_worker
    assert port.claims() == ref.claims()
    assert sorted(port.claims().values()) == [1] * 7 + [2]
    assert port.status == ref.status
    assert mapped(port.wisdom_docs) == mapped(ref.wisdom_docs)
    recs = port.wisdom_docs["matmul"]["records"]
    assert [r["provenance"]["verified"]["ref"] for r in recs] == \
        ["matmul.reference"] * 2
    # the port's own demand names the card, with the same problems
    assert [(k, key[1:], m) for k, key, m in port_fleet.DEMO_DEMAND] == \
        [(k, key[1:], m) for k, key, m in DEMO_DEMAND]
    assert {key[0] for _, key, _ in port_fleet.DEMO_DEMAND} == {"gpu-h100"}


def test_worker_skips_jobs_for_unknown_kernels_without_claiming():
    for pkg in PKGS:
        f = pkg.fleet
        bus = f.ControlBus(pkg.distrib.MemoryTransport())
        job = f.TuningJob(
            job_id=f.job_id_for("elsewhere-kernel", SCENARIO_A, 0),
            kernel="elsewhere-kernel", device_kind=SCENARIO_A[0],
            problem=SCENARIO_A[1], dtype=SCENARIO_A[2], n_shards=2)
        bus.publish("job", job.job_id, job.to_json())
        assert f.FleetWorker(bus, "w0", clock=f.ManualClock()).run_once() \
            is None
        assert bus.names("lease") == []


def test_coordinator_reenqueues_regressed_scenario():
    def case(pkg):
        f = pkg.fleet
        report = local_fleet(pkg, n_workers=2,
                             demand=[(KERNEL, SCENARIO_A, 5)], n_shards=2)
        assert report.jobs_assembled == [f.job_id_for(KERNEL, SCENARIO_A,
                                                      0)]
        bus = f.ControlBus(report.transport)
        coord = coordinator(pkg, bus, n_shards=2)
        assert coord.plan() == []
        f.seed_demand(bus, "late-worker", [(KERNEL, SCENARIO_A, 4)])
        jobs = coord.plan()
        assert [j.job_id for j in jobs] == [f.job_id_for(KERNEL, SCENARIO_A,
                                                         1)]
        assert jobs[0].round_ == 1
        return jobs[0].to_json()

    out = both(case)
    assert out["port"] == out["ref"]


def test_random_strategy_fleet_matches_across_worker_counts():
    """Non-exhaustive shards are schedule-independent too: the shard seed
    comes from the job, never the worker."""
    kw = dict(demand=[(KERNEL, SCENARIO_A, 5)], n_shards=3,
              strategy="random", max_evals_per_shard=6, seed=0)
    r1 = local_fleet(PORT, n_workers=1, **kw)
    r2 = local_fleet(PORT, n_workers=2, **kw)
    assert json.dumps(r1.wisdom_docs, sort_keys=True) \
        == json.dumps(r2.wisdom_docs, sort_keys=True)
    assert mapped(r2.wisdom_docs) == \
        mapped(local_fleet(REF, n_workers=2, **kw).wisdom_docs)


def test_coordinator_gates_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """No silent CPU gate: without a card, ``Coordinator()``, the local
    harness and the CLI's ``coordinate``/``demo`` raise unless given the
    CPU; on the card the gate checks there."""
    bus = port_fleet.ControlBus(port_distrib.MemoryTransport())
    if torch.cuda.is_available():
        assert port_fleet.Coordinator(bus).oracle.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_fleet.Coordinator(bus)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_fleet.run_local_fleet(n_workers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_fleet_cli(["coordinate", "--dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_fleet_cli(["demo", "--workers", "1"])
    assert port_fleet.Coordinator(bus, device="cpu").oracle.device == \
        torch.device("cpu")
    # planning and status never check a winner, so they need no device
    port_fleet.seed_demand(port_fleet.ControlBus(
        port_distrib.DirectoryTransport(tmp_path)), "h", [
            (KERNEL, SCENARIO_A, 5)])
    assert port_fleet_cli(["plan", "--dir", str(tmp_path)]) == 0
    assert port_fleet_cli(["status", "--dir", str(tmp_path)]) == 0


# ------------------------- transports + wisdom isolation ---------------------

def test_control_docs_invisible_to_wisdom_layer(tmp_path):
    def case(pkg):
        d = tmp_path / pkg.tag
        shared = pkg.distrib.DirectoryTransport(d / "shared")
        bus = pkg.fleet.ControlBus(shared)
        pkg.fleet.seed_demand(bus, "w0", [(KERNEL, SCENARIO_A, 5)])
        bus.publish("job", "j-test-r0", _job(pkg).to_json())
        assert any(n.startswith(pkg.distrib.CONTROL_PREFIX)
                   for n in shared.list_kernels())
        assert pkg.distrib.WisdomStore(d / "shared").kernels() == []
        local = pkg.distrib.WisdomStore(d / "local")
        pkg.distrib.PullSync(local, shared, interval=1).pull()
        assert local.kernels() == []
        assert pkg.distrib.WisdomStore(d / "shared").validate() == []
        return {p.name: p.read_bytes()
                for p in sorted((d / "shared").iterdir())}

    out = both(case)
    assert out["port"] == out["ref"]


def test_directory_transport_fleet_run_matches_memory(tmp_path):
    kw = dict(n_workers=2, demand=[(KERNEL, SCENARIO_A, 5)], n_shards=2)
    r_mem = local_fleet(PORT, **kw)
    r_dir = local_fleet(PORT, transport=port_distrib.DirectoryTransport(
        tmp_path / "shared"), **kw)
    assert json.dumps(r_mem.wisdom_docs, sort_keys=True) \
        == json.dumps(r_dir.wisdom_docs, sort_keys=True)
    assert not list((tmp_path / "shared").glob("*.tmp"))


# ----------------------------------- CLI -------------------------------------

def test_fleet_cli_plan_work_status(tmp_path, capsys):
    def case(pkg):
        d = str(tmp_path / pkg.tag)
        dev = ["--device", "cpu"] if pkg is PORT else []
        bus = pkg.fleet.ControlBus(pkg.distrib.DirectoryTransport(d))
        pkg.fleet.seed_demand(bus, "host-a", [(KERNEL, SCENARIO_A, 5)])
        outs = []

        def run(*argv):
            assert pkg.cli(list(argv)) == 0
            outs.append(capsys.readouterr().out.replace(d, "D"))
            return outs[-1]

        out = run("plan", "--dir", d, "--dry-run")
        assert "dry run" in out and KERNEL in out
        assert bus.names("job") == []
        run("plan", "--dir", d, "--shards", "2", "--evals-per-shard", "100")
        assert len(bus.names("job")) == 1
        # --poll exits once every shard has a result, before assembly
        assert "finished 2 shard(s)" in run(
            "work", "--dir", d, "--worker-id", "host-a", "--poll", "0.01")
        run("coordinate", "--dir", d, "--shards", "2",
            "--evals-per-shard", "100", *dev)
        out = run("status", "--dir", d)
        assert "assembled" in out and "misses=5" in out
        assert pkg.distrib.WisdomStore(d).kernels() == [KERNEL]
        assert "finished 0 shard(s)" in run(
            "work", "--dir", d, "--worker-id", "host-b", "--poll", "0.01")
        return [o.replace("python -m repro_torch.", "python -m repro.")
                for o in outs], mapped(json.loads(
                    (tmp_path / pkg.tag / f"{KERNEL}.wisdom.json")
                    .read_text()))

    out = both(case)
    assert out["port"] == out["ref"]


def test_fleet_cli_status_empty_dir(tmp_path, capsys):
    assert port_fleet_cli(["status", "--dir", str(tmp_path / "nothing")]) \
        == 0
    assert "0 demand" in capsys.readouterr().out


def test_fleet_cli_demo_on_the_host(capsys):
    assert port_fleet_cli(["demo", "--workers", "2", "--device", "cpu",
                           "--evals-per-shard", "8"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("2 worker(s): 8 shard(s) run")
    assert out.count("  wisdom matmul: ") == 2


def test_tune_cli_dedups_captures_and_dry_runs(tmp_path, capsys,
                                               wisdom_dir):
    from repro_torch.core.capture import write_capture
    from repro_torch.tuner.tune import main as tune_cli

    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    cap_dir = tmp_path / "caps"
    p = write_capture("matmul", (64, 64, 64), "float32", [a, b],
                      out_dir=cap_dir)
    shutil.copy(p, cap_dir / "copy-of-same.capture.json")
    glob_arg = str(cap_dir / "*.capture.json")
    base = ["--captures", glob_arg, "--device", "cpu"]

    assert tune_cli(base + ["--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "would tune matmul 64x64x64 float32" in out
    assert "+1 duplicate(s)" in out
    assert "1 scenario(s) from 2 capture(s), 1 duplicate(s) skipped" in out
    assert not (wisdom_dir / "matmul.wisdom.json").exists()

    assert tune_cli(base + ["--strategy", "random", "--budget-evals", "4",
                            "--objective", "costmodel"]) == 0
    out = capsys.readouterr().out
    assert out.count("best=") == 1
    assert "skipped (same scenario" in out
    assert len(port_distrib.WisdomStore(wisdom_dir).load("matmul")
               .records) == 1


# ------------------------ sandboxed shard evaluation -------------------------

def _raising_evaluator(pkg, bad_config):
    eval_result = (ref_fleet.worker.EvalResult if pkg is REF
                   else port_fleet.worker.EvalResult)

    class _RaisingEvaluator:
        """Counts every config it sees; raises on exactly one of them."""

        def __init__(self):
            self.calls = []

        def __call__(self, config):
            self.calls.append(dict(config))
            if {k: config[k] for k in bad_config} == bad_config:
                raise RuntimeError("injected mid-config evaluator crash")
            return eval_result(float(config["bx"] * config["by"]), True)

    return _RaisingEvaluator()


def test_crashed_shard_resumes_without_rerunning_checkpointed_configs():
    """A shard whose evaluator crashed mid-config is re-claimed and re-runs
    only what the checkpoint does not cover — not even the config that
    crashed, whose sandbox verdict is in the checkpointed log."""
    bad = {"bx": 8, "by": 32}

    def case(pkg):
        f = pkg.fleet
        bus = f.ControlBus(pkg.distrib.MemoryTransport())
        clock = f.ManualClock()
        job = _job(pkg, n_shards=1)
        bus.publish("job", job.job_id, job.to_json())
        ev0 = _raising_evaluator(pkg, bad)
        w0 = f.FleetWorker(bus, "w0", clock=clock, ttl_s=30.0,
                           checkpoint_every=1, crash_after_evals=5,
                           evaluator_factory=lambda builder, job_: ev0)
        with pytest.raises(f.WorkerCrash):
            w0.run_once()
        assert len(ev0.calls) == 5 and bad in ev0.calls
        name = f.lease_name(job.job_id, "s000")
        evals = bus.fetch("state", name)["evaluations"]
        crashed, = [e for e in evals if e["config"] == bad]
        assert crashed["feasible"] is False
        assert crashed["error"].startswith("sandbox:crash")
        assert "injected mid-config evaluator crash" in crashed["error"]
        clock.advance(31.0)
        ev1 = _raising_evaluator(pkg, bad)
        w1 = f.FleetWorker(bus, "w1", clock=clock, ttl_s=30.0,
                           evaluator_factory=lambda builder, job_: ev1)
        assert w1.run_once() == name
        assert len(ev1.calls) == N_VALID - 5 and bad not in ev1.calls
        result = bus.fetch("result", name)
        assert result["worker"] == "w1" and result["evals"] == N_VALID
        assert result["feasible_evals"] == N_VALID - 1
        assert result["best_config"] == {"bx": 8, "by": 8}
        return result, [e["config"] for e in evals], ev1.calls

    out = both(case)
    assert out["port"] == out["ref"]


# ------------------------------- fleet health --------------------------------

def test_fleet_health_aggregates_bus_snapshots():
    def case(pkg):
        from_pkg = pkg.obs
        bus = pkg.fleet.ControlBus(pkg.distrib.MemoryTransport())
        r1, r2 = from_pkg.MetricsRegistry(), from_pkg.MetricsRegistry()
        sc = "tpu-v5e|8x8|float32"
        r1.counter("select.tier", kernel="m", scenario=sc,
                   tier="exact").inc(3)
        r2.counter("select.tier", kernel="m", scenario=sc,
                   tier="default").inc(1)
        health = pkg.fleet.health
        health.publish_metrics(bus, "host-1", r1)
        health.publish_metrics(bus, "host-2", r2)
        assert sorted(health.fleet_snapshots(bus)) == ["host-1", "host-2"]
        merged = health.aggregate_fleet_metrics(bus)
        assert merged["counters"][
            f"select.tier{{kernel=m,scenario={sc},tier=exact}}"] == 3
        text = health.fleet_health(bus)
        assert f"m {sc}: hit-rate=0.75 launches=4" in text
        with pytest.raises(RuntimeError, match="disabled"):
            health.publish_metrics(bus, "host-3")
        pub = health.MetricsPublisher(bus, "host-3", interval=2,
                                      registry=r1)
        assert [pub.tick() for _ in range(4)] == [True, False, True, False]
        assert pub.publishes == 2
        assert health.MetricsPublisher(bus, "h", registry=None).tick() \
            is False
        fleet_text = coordinator(pkg, bus).fleet_health()
        assert fleet_text == health.fleet_health(bus) != text
        return merged, text, fleet_text

    out = both(case)
    assert out["port"] == out["ref"]


# ------------------------- predict -> verify -> promote ----------------------

def _transferred(pkg, score):
    return pkg.wisdom.WisdomRecord(
        device_kind="tpu-v4", device_family="tpu-v4",
        problem_size=SCENARIO_A[1], dtype="float32",
        config={"bx": 64, "by": 32}, score_us=score,
        provenance={"source": "transfer", "source_device": "tpu-v5e",
                    "source_entries": 15, "confidence": 0.9,
                    "predicted_us": score, "predictor": "ridge+capability",
                    "round": 0})


def test_coordinator_enqueues_verification_for_regressed_transfer():
    key = ("tpu-v4", SCENARIO_A[1], "float32")

    def case(pkg):
        transport = pkg.distrib.MemoryTransport()
        bus = pkg.fleet.ControlBus(transport)
        transport.publish(KERNEL, pkg.wisdom.Wisdom(
            KERNEL, [_transferred(pkg, 50.0)]).to_doc())
        coord = coordinator(pkg, bus, n_shards=2, min_misses=2)
        pkg.fleet.publish_latency(
            bus, "h1", {KERNEL: {pkg.online.format_key(key): 55.0}})
        report = coord.tick()
        assert report.verify == [] and report.planned == []
        pkg.fleet.publish_latency(
            bus, "h1", {KERNEL: {pkg.online.format_key(key): 90.0}})
        report = coord.tick()
        assert report.verify == [pkg.online.format_key(key)]
        assert len(report.planned) == 1
        return dataclasses.asdict(report), transport.docs

    out = both(case)
    assert out["port"] == out["ref"]


def test_verify_loop_promotes_measured_record_end_to_end():
    key = ("tpu-v4", SCENARIO_A[1], "float32")

    def case(pkg):
        f = pkg.fleet
        transport = pkg.distrib.MemoryTransport()
        bus = f.ControlBus(transport)
        transport.publish(KERNEL, pkg.wisdom.Wisdom(
            KERNEL, [_transferred(pkg, 1.0)]).to_doc())
        coord = coordinator(pkg, bus, n_shards=2, min_misses=2,
                            max_evals_per_shard=50)
        f.publish_latency(bus, "h1",
                          {KERNEL: {pkg.online.format_key(key): 900.0}})
        assert len(coord.tick().planned) == 1
        f.FleetWorker(bus, "w0", clock=f.ManualClock()).drain()
        assert len(coord.tick().assembled) == 1
        mine, = [pkg.wisdom.WisdomRecord.from_json(r)
                 for r in transport.fetch(KERNEL)["records"]]
        assert not mine.is_transferred()
        assert mine.provenance.get("source") == "fleet"
        assert any(e.get("source") == "transfer" for e in mine.lineage)
        assert coord.tick().verify == []
        return mapped(transport.fetch(KERNEL))

    out = both(case)
    assert out["port"] == out["ref"]
