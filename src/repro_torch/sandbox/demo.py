"""End-to-end sandbox/oracle smoke: inject faults, count bad promotions.

Port of ``repro.sandbox.demo``; ``run_demo`` is the engine behind
``python -m repro_torch.sandbox check --demo``. It runs its legs on one
device (the card unless the caller asks for the CPU):

1. **sandbox verdicts** — a
   :class:`~repro_torch.sandbox.faults.FaultyEvaluator` runs in a spawned
   child per fault mode, all modes at once; a hang must time out (without
   killing this process), a raise be a crash, an allocation bomb an oom
   (host memory under ``RLIMIT_AS`` on the CPU, the card's under a
   device-memory fraction), a SIGSEGV a crash with a signal exit cause.
   On the card each child holds a CUDA context when its fault happens;
2. **oracle verdicts** — the registered faulty kernel's honest config
   passes the :class:`~repro_torch.sandbox.gate.OracleGate` on the device
   and its ``wrong`` config (fast but incorrect output) is a
   ``numerics-mismatch``;
3. **online promotion** — the wrong config is offered as the winner to
   the online :class:`~repro_torch.online.promotion.PromotionPipeline` and
   must be rejected; the honest config must promote with ``verified``
   provenance;
4. **fleet** — the wrong config wins a shard (and the cross-shard
   comparison); the fleet coordinator must fall back to the honest shard
   winner, with ``verified`` provenance, and record the rejection;
5. **transfer** — the wrong config ranks first among a transfer's
   predictions (gpu-a100 onto this device's kind) and
   ``TransferResult.record(gate=...)`` must fall through to the honest
   runner-up, with ``verified`` provenance.

The report names the legs that ran, and ``bad_promotions`` counts a wrong
config that became wisdom on any of them.
"""

from __future__ import annotations

import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.registry import register, unregister
from repro_torch.core.wisdom import Wisdom
from repro_torch.core.wisdom_kernel import WisdomKernel
from repro_torch.distrib.sync import MemoryTransport, transport_wisdom
from repro_torch.fleet.bus import ControlBus
from repro_torch.fleet.coordinator import Coordinator
from repro_torch.fleet.jobs import TuningJob, job_id_for, lease_name
from repro_torch.online.promotion import PromotionPipeline
from repro_torch.transfer import TransferPrediction, TransferResult

from .evaluator import SandboxedEvaluator, SandboxSettings
from .faults import FAULT_PARAM, FaultyEvaluator, make_faulty_kernel
from .gate import OracleGate, clear_verdict_cache
from .verdict import (STATUS_CRASH, STATUS_NUMERICS, STATUS_OK, STATUS_OOM,
                      STATUS_TIMEOUT)

#: Fault mode -> verdict status the spawned sandbox must produce for it.
EXPECTED_VERDICTS = {
    "none": STATUS_OK,
    "raise": STATUS_CRASH,
    "segv": STATUS_CRASH,
    "oom": STATUS_OOM,
    "hang": STATUS_TIMEOUT,
}

#: Legs of the reference's demo that wait for their layers (none left).
UNPORTED_LEGS = ()
#: The device kind the transfer leg's predictions come from.
TRANSFER_SOURCE = "gpu-a100"

#: Share of the card's memory a CUDA child may allocate in the sandbox leg.
DEVICE_MEMORY_FRACTION = 0.02

_PROBLEM = (8, 8)
_DTYPE = "float32"
_WRONG = {"scale": 1, FAULT_PARAM: "wrong"}
_HONEST = {"scale": 1, FAULT_PARAM: "none"}


def _verdict_summary(v) -> dict:
    """Deterministic slice of a verdict for the report (no wall times)."""
    out = {"status": v.status}
    if v.exit_cause:
        out["exit_cause"] = v.exit_cause
    if v.max_err is not None:
        out["mismatch"] = True
    return out


def run_fault_modes(modes, settings_of, device: str | None = None,
                    hang_s: float = 3600.0) -> dict:
    """Each fault mode through its own spawned
    :class:`SandboxedEvaluator`, all children at once (each pays for its
    interpreter and imports, so in parallel they cost about one).
    ``settings_of(mode)`` gives a mode's settings. Returns ``{mode:
    (EvalResult, SandboxVerdict)}``."""
    def one(mode):
        ev = SandboxedEvaluator(FaultyEvaluator(hang_s=hang_s, device=device),
                                settings_of(mode))
        result = ev({"scale": 1, FAULT_PARAM: mode})
        return mode, (result, ev.verdicts[-1][1])

    modes = list(modes)
    with ThreadPoolExecutor(max_workers=len(modes)) as pool:
        return dict(pool.map(one, modes))


def _sandbox_section(device: torch.device, timeout_s: float,
                     headroom_bytes: int) -> tuple[dict, list]:
    """Fault-injected evaluator through the spawned sandbox, per mode."""
    problems: list[str] = []
    if device.type == "cuda":
        settings = SandboxSettings(
            timeout_s=timeout_s,
            device_memory_fraction=DEVICE_MEMORY_FRACTION)
    else:
        settings = SandboxSettings(timeout_s=timeout_s,
                                   memory_bytes=headroom_bytes)
    runs = run_fault_modes(
        EXPECTED_VERDICTS, lambda mode: settings,
        device=str(device) if device.type == "cuda" else None)
    section: dict = {}
    for mode, want in EXPECTED_VERDICTS.items():
        result, verdict = runs[mode]
        section[mode] = _verdict_summary(verdict)
        if verdict.status != want:
            problems.append(f"sandbox: fault={mode} produced verdict "
                            f"{verdict.status!r}, wanted {want!r}")
        if mode == "none" and not result.feasible:
            problems.append("sandbox: healthy config came back infeasible")
        if mode != "none" and result.feasible:
            problems.append(f"sandbox: fault={mode} came back feasible")
    return section, problems


def _oracle_section(builder, gate: OracleGate) -> tuple[dict, list]:
    problems: list[str] = []
    honest = gate.check(builder, _HONEST, _PROBLEM, _DTYPE)
    wrong = gate.check(builder, _WRONG, _PROBLEM, _DTYPE)
    if honest.status != STATUS_OK:
        problems.append(f"oracle: honest config verdict {honest.status!r} "
                        f"({honest.detail})")
    if wrong.status != STATUS_NUMERICS:
        problems.append(f"oracle: wrong config verdict {wrong.status!r}, "
                        f"wanted {STATUS_NUMERICS!r}")
    return ({"honest": _verdict_summary(honest),
             "wrong": _verdict_summary(wrong)}, problems)


def _online_path(builder, gate: OracleGate, device_kind: str,
                 wisdom_dir: Path) -> tuple[dict, list, int]:
    """Wrong config wins the bracket; the pipeline must veto it, then
    promote the honest runner-up with verified provenance."""
    problems: list[str] = []
    kernel = WisdomKernel(builder, wisdom_dir=wisdom_dir,
                          device_kind=device_kind)
    pipeline = PromotionPipeline(kernel, wisdom_dir=wisdom_dir,
                                 oracle=gate)
    vetoed = pipeline.promote(device_kind, _PROBLEM, _DTYPE, _WRONG,
                              score_us=50.5, incumbent_score_us=200.0,
                              n_measurements=3, evals=16,
                              objective="costmodel")
    promoted = pipeline.promote(device_kind, _PROBLEM, _DTYPE, _HONEST,
                                score_us=101.0, incumbent_score_us=200.0,
                                n_measurements=3, evals=16,
                                objective="costmodel")
    if vetoed is not None:
        problems.append("online: wrong config was promoted")
    if not pipeline.rejections:
        problems.append("online: veto was not recorded as a rejection")
    if promoted is None:
        problems.append("online: honest config failed to promote")
    elif promoted.record.provenance.get("verified") is None:
        problems.append("online: promoted record lacks verified provenance")
    bad = sum(1 for rec in Wisdom.load(builder.name, wisdom_dir).records
              if rec.config.get(FAULT_PARAM) != "none")
    if bad:
        problems.append(f"online: {bad} wrong record(s) in the wisdom file")
    return ({"rejections": len(pipeline.rejections),
             "promotions": len(pipeline.promotions),
             "rejected_status": (pipeline.rejections[0].verdict.status
                                 if pipeline.rejections else None)},
            problems, bad)


def _fleet_path(builder, gate: OracleGate, device_kind: str
                ) -> tuple[dict, list, int]:
    """Wrong config wins a shard (and the cross-shard comparison); the
    coordinator must fall back to the honest shard winner."""
    problems: list[str] = []
    bus = ControlBus(MemoryTransport())
    coord = Coordinator(bus, n_shards=2, oracle=gate)
    key = (device_kind, _PROBLEM, _DTYPE)
    job = TuningJob(job_id=job_id_for(builder.name, key),
                    kernel=builder.name, device_kind=device_kind,
                    problem=_PROBLEM, dtype=_DTYPE, n_shards=2,
                    misses=5)
    bus.publish("job", job.job_id, job.to_json())
    shard_results = [
        {"job": job.job_id, "shard": "s000", "worker": "demo-w0",
         "strategy": "exhaustive", "evals": 8, "feasible_evals": 8,
         "best_config": dict(_WRONG), "best_score_us": 50.5},
        {"job": job.job_id, "shard": "s001", "worker": "demo-w1",
         "strategy": "exhaustive", "evals": 8, "feasible_evals": 8,
         "best_config": dict(_HONEST), "best_score_us": 101.0},
    ]
    for doc in shard_results:
        bus.publish("result", lease_name(job.job_id, doc["shard"]), doc)
    records = coord.assemble()
    done = bus.fetch("done", job.job_id)
    if len(records) != 1:
        problems.append(f"fleet: assembled {len(records)} records, wanted 1")
    elif records[0].config.get(FAULT_PARAM) != "none":
        problems.append("fleet: assembled record is the wrong config")
    elif records[0].provenance.get("verified") is None:
        problems.append("fleet: assembled record lacks verified provenance")
    rejected = (done or {}).get("rejected", [])
    if len(rejected) != 1:
        problems.append(f"fleet: done doc records {len(rejected)} "
                        f"rejections, wanted 1")
    bad = sum(1 for rec in transport_wisdom(bus.transport,
                                            builder.name).records
              if rec.config.get(FAULT_PARAM) != "none")
    if bad:
        problems.append(f"fleet: {bad} wrong record(s) in fleet wisdom")
    return ({"assembled": len(records), "rejected": len(rejected),
             "done_state": (done or {}).get("state")},
            problems, bad)


def _transfer_path(builder, gate: OracleGate, device_kind: str
                   ) -> tuple[dict, list, int]:
    """Wrong config ranks first among predictions; ``record(gate=...)``
    must fall through to the honest runner-up."""
    problems: list[str] = []
    predictions = [
        TransferPrediction(config=dict(_WRONG), source_us=50.5,
                           smoothed_us=50.5, rank_us=50.5,
                           predicted_us=50.5),
        TransferPrediction(config=dict(_HONEST), source_us=101.0,
                           smoothed_us=101.0, rank_us=101.0,
                           predicted_us=101.0),
    ]
    result = TransferResult(
        kernel=builder.name, source_device=TRANSFER_SOURCE,
        target_device=device_kind, problem_size=_PROBLEM, dtype=_DTYPE,
        predictions=predictions, confidence=0.9,
        components={"entries": 2, "calibration": "workload"})
    try:
        record = result.record(gate=gate)
    except ValueError as e:
        problems.append(f"transfer: every prediction was vetoed ({e})")
        return {"recorded": None}, problems, 0
    bad = 0
    if record.config.get(FAULT_PARAM) != "none":
        bad = 1
        problems.append("transfer: recorded the wrong config")
    if record.provenance.get("verified") is None:
        problems.append("transfer: record lacks verified provenance")
    return ({"recorded": record.config.get(FAULT_PARAM),
             "score_us": record.score_us}, problems, bad)


def run_demo(timeout_s: float = 5.0,
             memory_mb: int | None = None,
             out_dir: Path | str | None = None,
             device: str | torch.device = "cuda") -> dict:
    """Run the injected-fault gauntlet on ``device``; return the report.

    ``report["pass"]`` is True iff every fault produced its expected
    verdict and ``report["bad_promotions"] == 0`` — no injected
    wrong-output config became wisdom on a leg that ran. ``timeout_s`` is
    each spawned child's payload ceiling (its start does not count);
    ``memory_mb`` the host-memory headroom of a CPU child.

    Example::

        report = run_demo(device="cpu")
        assert report["pass"], report["problems"]
    """
    dev = resolve_device(device)
    device_kind = "gpu-h100" if dev.type == "cuda" else "cpu"
    builder = make_faulty_kernel(hang_s=3600.0)
    register(builder)
    clear_verdict_cache()
    problems: list[str] = []
    bad_promotions = 0
    try:
        headroom = (memory_mb * 2**20 if memory_mb is not None
                    else 256 * 2**20)
        sandbox_report, p = _sandbox_section(dev, timeout_s, headroom)
        problems += p

        gate = OracleGate(device=dev)
        oracle_report, p = _oracle_section(builder, gate)
        problems += p

        if out_dir is not None:
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            online_report, p, bad = _online_path(builder, gate, device_kind,
                                                 Path(out_dir))
        else:
            with tempfile.TemporaryDirectory() as tmp:
                online_report, p, bad = _online_path(builder, gate,
                                                     device_kind, Path(tmp))
        problems += p
        bad_promotions += bad

        fleet_report, p, bad = _fleet_path(builder, gate, device_kind)
        problems += p
        bad_promotions += bad

        transfer_report, p, bad = _transfer_path(builder, gate, device_kind)
        problems += p
        bad_promotions += bad
    finally:
        unregister(builder.name)
        clear_verdict_cache()

    return {
        "kernel": builder.name,
        "device": str(dev),
        "timeout_s": timeout_s,
        "legs": ["sandbox", "oracle", "online", "fleet", "transfer"],
        "legs_not_ported": list(UNPORTED_LEGS),
        "sandbox": sandbox_report,
        "oracle": oracle_report,
        "paths": {"online": online_report, "fleet": fleet_report,
                  "transfer": transfer_report},
        "bad_promotions": bad_promotions,
        "problems": problems,
        "pass": not problems and bad_promotions == 0,
    }
