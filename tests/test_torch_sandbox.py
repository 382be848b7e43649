"""The port's sandbox and correctness gate (``repro_torch.sandbox``) on the
host, against the JAX package's ``repro.sandbox``.

Each fault mode maps to the reference's verdict status, in a spawned child
here where the reference forks (a CUDA context does not survive ``fork``),
and inline where inline can contain the fault. The verdict JSON round trip
is the reference's byte for byte; the gate vetoes the faulty kernel's
``wrong`` config in both packages, and its cache key names the device. The
spawned children import torch (seconds each), so the tests start them all
at once. The same checks with CUDA in the child run on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phases 8 and 9).
``SandboxedEvaluator(record_to=...)`` records what the reference's does,
the verdict with it.
"""

from __future__ import annotations

import functools
import json

import pytest
import torch

from repro.core.registry import register as ref_register
from repro.core.registry import unregister as ref_unregister
from repro.sandbox import FaultyEvaluator as RefFaultyEvaluator
from repro.sandbox import OracleGate as RefOracleGate
from repro.sandbox import SandboxedEvaluator as RefSandboxedEvaluator
from repro.sandbox import SandboxSettings as RefSandboxSettings
from repro.sandbox import SandboxVerdict as RefVerdict
from repro.sandbox import clear_verdict_cache as ref_clear_cache
from repro.sandbox import make_faulty_kernel as ref_faulty
from repro.sandbox import memory_ceiling as ref_memory_ceiling
from repro.sandbox import sandboxed_call as ref_sandboxed_call
from repro.tunebench import SpaceDataset as RefSpaceDataset

from repro_torch.core import Wisdom, WisdomKernel, get_kernel
from repro_torch.core.registry import all_kernels, register, unregister
from repro_torch.online.promotion import PromotionPipeline
from repro_torch.sandbox import (FAULT_PARAM, CorrectnessOracle,
                                 FaultyEvaluator, KernelTrial, OracleGate,
                                 SandboxedEvaluator, SandboxSettings,
                                 SandboxVerdict, clear_verdict_cache,
                                 make_faulty_kernel, sandboxed_call)
from repro_torch.sandbox import cli, gate as gate_module
from repro_torch.sandbox.demo import (EXPECTED_VERDICTS, UNPORTED_LEGS,
                                      run_demo)
from repro_torch.tunebench import SpaceDataset

torch.set_num_threads(1)

WRONG = {"scale": 1, FAULT_PARAM: "wrong"}
HONEST = {"scale": 1, FAULT_PARAM: "none"}
PROBLEM = (8, 8)
DTYPE = "float32"
#: A spawned child's payload ceiling (its start, torch's import, does not
#: count); the hang child's is short, since reaching it is the check.
CHILD_TIMEOUT_S = 60.0
HANG_TIMEOUT_S = 2.0


@pytest.fixture()
def faulty():
    b = make_faulty_kernel(hang_s=3600.0)
    register(b)
    clear_verdict_cache()
    yield b
    unregister(b.name)
    clear_verdict_cache()


def _settings(mode: str) -> SandboxSettings:
    return SandboxSettings(
        timeout_s=HANG_TIMEOUT_S if mode == "hang" else CHILD_TIMEOUT_S,
        memory_bytes=128 * 2**20)


def _fault_dataset(cls, space):
    """An empty recorded space of the faulty kernel's scenario."""
    return cls("faulty", space, PROBLEM, DTYPE, "cpu", objective="wallclock")


@pytest.fixture(scope="module")
def spawned():
    """Every fault mode, one kernel trial and one oracle check, each in its
    own spawned child, all at once: ``{name: (EvalResult or None,
    SandboxVerdict)}``."""
    from concurrent.futures import ThreadPoolExecutor

    def one(name):
        if name == "oracle":
            b = get_kernel("advec_u")
            oracle = CorrectnessOracle(
                b, b.make_probe_args((8, 8, 16), "float32"),
                settings=SandboxSettings(timeout_s=CHILD_TIMEOUT_S))
            return name, (None, oracle.check(b.default_config()))
        if name == "recorded":
            ds = _fault_dataset(SpaceDataset, make_faulty_kernel().space)
            ev = SandboxedEvaluator(FaultyEvaluator(hang_s=3600.0),
                                    _settings("raise"), record_to=ds)
            ev({"scale": 1, FAULT_PARAM: "raise"})
            return name, (ds, ev.verdicts[-1][1])
        if name == "trial":
            ev = SandboxedEvaluator(
                KernelTrial("advec_u", (8, 8, 16), "float32", device="cpu",
                            repeats=1),
                SandboxSettings(timeout_s=CHILD_TIMEOUT_S))
            result = ev(get_kernel("advec_u").default_config())
        else:
            ev = SandboxedEvaluator(FaultyEvaluator(hang_s=3600.0),
                                    _settings(name))
            result = ev({"scale": 1, FAULT_PARAM: name})
        return name, (result, ev.verdicts[-1][1])

    names = [*EXPECTED_VERDICTS, "trial", "oracle", "recorded"]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(pool.map(one, names))


# ------------------------------------------------------------ the sandbox

@pytest.mark.parametrize("mode", list(EXPECTED_VERDICTS))
def test_fault_modes_map_to_the_references_statuses(spawned, mode):
    """Spawned here, forked in the reference: the same status, and a
    signal exit cause for a segfault, a killed one for a hang."""
    result, verdict = spawned[mode]
    ref = RefSandboxedEvaluator(
        RefFaultyEvaluator(hang_s=3600.0),
        RefSandboxSettings(timeout_s=1.0 if mode == "hang" else 30.0,
                           memory_bytes=ref_memory_ceiling(128 * 2**20)))
    ref_result = ref({"scale": 1, FAULT_PARAM: mode})
    want = ref.verdicts[-1][1].status
    assert verdict.status == want == EXPECTED_VERDICTS[mode]
    assert result.info["sandbox"] == ref_result.info["sandbox"] == want
    assert result.feasible == ref_result.feasible == (mode == "none")
    if mode == "none":
        assert result.score_us == pytest.approx(ref_result.score_us)
    else:
        assert result.error.startswith(f"sandbox:{want}")
    if mode == "segv":
        assert verdict.exit_cause == "signal:11"
        assert "Fatal Python error" in verdict.stderr
    if mode == "hang":
        assert verdict.exit_cause == "killed:timeout"
        assert verdict.wall_s < HANG_TIMEOUT_S + 20
    if mode == "raise":
        assert "injected evaluator fault" in verdict.detail
        assert "Traceback" in verdict.stderr


def test_spawned_kernel_trial_builds_and_times_in_the_child(spawned):
    result, verdict = spawned["trial"]
    assert verdict.ok and verdict.exit_cause == "exit:0"
    assert result.feasible and result.verified is True
    assert 0 < result.score_us < float("inf")


def test_spawned_crash_is_recorded_with_its_verdict(spawned):
    """record_to= records a spawned child's crash as an infeasible entry
    carrying the verdict, as the reference's forked child's is."""
    ds, verdict = spawned["recorded"]
    entry = ds.lookup({"scale": 1, FAULT_PARAM: "raise"})
    assert verdict.status == "crash" and len(ds) == 1
    assert (entry.status, entry.verdict) == ("infeasible", "crash")
    assert entry.error.startswith("sandbox:crash:")
    ref_ds = _fault_dataset(RefSpaceDataset, ref_faulty().space)
    RefSandboxedEvaluator(RefFaultyEvaluator(),
                          RefSandboxSettings(timeout_s=30.0),
                          record_to=ref_ds)({"scale": 1, FAULT_PARAM: "raise"})
    ref_entry = ref_ds.lookup({"scale": 1, FAULT_PARAM: "raise"})
    assert (entry.status, entry.verdict, entry.score_us) == (
        ref_entry.status, ref_entry.verdict, ref_entry.score_us)


@pytest.mark.parametrize("mode", ["none", "raise", "wrong"])
def test_inline_record_to_matches_the_reference(mode):
    """Inline, each recorded entry is the reference's: its status, verdict
    and error, and an ok verdict is not stored."""
    cfg = {"scale": 1, FAULT_PARAM: mode}
    ds = _fault_dataset(SpaceDataset, make_faulty_kernel().space)
    SandboxedEvaluator(FaultyEvaluator(), SandboxSettings(method="inline"),
                       record_to=ds)(cfg)
    ref_ds = _fault_dataset(RefSpaceDataset, ref_faulty().space)
    RefSandboxedEvaluator(RefFaultyEvaluator(),
                          RefSandboxSettings(method="inline"),
                          record_to=ref_ds)(cfg)
    got, want = ds.lookup(cfg).to_json(), ref_ds.lookup(cfg).to_json()
    assert set(got) == set(want)
    for key in ("config", "status", "error", "verdict"):
        assert got.get(key) == want.get(key)
    assert list(ds.evaluations) == list(ref_ds.evaluations)


def test_spawned_oracle_check_rebuilds_the_probe_in_the_child(spawned):
    _, verdict = spawned["oracle"]
    assert verdict.ok and verdict.exit_cause == "exit:0"
    assert verdict.max_err == 0.0 and verdict.rtol == 1e-5


@pytest.mark.parametrize("mode", ["none", "raise", "wrong"])
def test_inline_fault_modes_match_the_references(mode):
    """The modes inline can contain: the same statuses as the
    reference's inline sandbox."""
    got, out = sandboxed_call(functools.partial(
        FaultyEvaluator(), {"scale": 1, FAULT_PARAM: mode}),
        SandboxSettings(method="inline"))
    want, ref_out = ref_sandboxed_call(functools.partial(
        RefFaultyEvaluator(), {"scale": 1, FAULT_PARAM: mode}),
        RefSandboxSettings(method="inline"))
    assert (got.status, got.exit_cause, got.detail) == (
        want.status, want.exit_cause, want.detail)
    assert (out is None) == (ref_out is None)


def test_inline_maps_memory_errors_to_oom():
    def hungry():
        raise MemoryError

    got, _ = sandboxed_call(hungry, SandboxSettings(method="inline"))
    want, _ = ref_sandboxed_call(hungry, RefSandboxSettings(method="inline"))
    assert got.status == want.status == "oom"


def test_spawn_refuses_a_closure():
    with pytest.raises(TypeError, match="picklable"):
        sandboxed_call(lambda: 1, SandboxSettings())


def test_settings_keep_host_and_device_ceilings_apart():
    with pytest.raises(ValueError, match="device_memory_fraction"):
        SandboxSettings(memory_bytes=1 << 20, device_memory_fraction=0.1)
    with pytest.raises(ValueError, match="method"):
        SandboxSettings(method="fork")


@pytest.mark.parametrize("fields", [
    {"status": "numerics-mismatch", "detail": "allclose failed",
     "exit_cause": "inline", "wall_s": 0.25, "max_err": 0.3, "rtol": 1e-5,
     "atol": 1e-5},
    {"status": "crash", "detail": "RuntimeError: x", "exit_cause":
     "signal:11", "stderr": "Fatal Python error", "wall_s": 1.000125},
    {"status": "ok"},
])
def test_verdict_json_round_trip_is_the_references(fields):
    v, rv = SandboxVerdict(**fields), RefVerdict(**fields)
    doc = json.dumps(v.to_json(), sort_keys=True)
    assert doc == json.dumps(rv.to_json(), sort_keys=True)
    back = SandboxVerdict.from_json(json.loads(doc))
    assert back == v and back.ok == (v.status == "ok")
    assert json.dumps(back.to_json(), sort_keys=True) == json.dumps(
        RefVerdict.from_json(json.loads(doc)).to_json(), sort_keys=True)
    with pytest.raises(ValueError):
        SandboxVerdict("not-a-status")


# --------------------------------------------------------------- the gate

def test_gate_vetoes_the_wrong_config_in_both_packages(faulty):
    rb = ref_faulty(hang_s=3600.0)
    ref_register(rb)
    ref_clear_cache()
    try:
        want = {m: RefOracleGate().check(rb, cfg, PROBLEM, DTYPE).status
                for m, cfg in (("none", HONEST), ("wrong", WRONG))}
    finally:
        ref_unregister(rb.name)
        ref_clear_cache()
    gate = OracleGate()
    got = {m: gate.check(faulty, cfg, PROBLEM, DTYPE).status
           for m, cfg in (("none", HONEST), ("wrong", WRONG))}
    assert got == want == {"none": "ok", "wrong": "numerics-mismatch"}
    assert not gate.allows(gate.checks[-1][2])


def test_gate_cache_key_names_the_device(faulty):
    gate = OracleGate()
    verdict = gate.check(faulty, HONEST, PROBLEM, DTYPE)
    assert verdict.ok
    keys = [k for k in gate_module._VERDICT_CACHE if k[0] == faulty.name]
    assert keys and all(k[-1] == "cpu" for k in keys)
    # another gate answers from the cache, with no oracle of its own
    other = OracleGate(device="cpu")
    assert other.check(faulty, HONEST, PROBLEM, DTYPE) is verdict
    assert other._oracles == {}
    stamped = gate.stamp({"strategy": "online"}, faulty.name, verdict)
    assert stamped["verified"] == {"rtol": 1e-5, "atol": 1e-5,
                                   "ref": f"{faulty.name}.reference"}


def test_oracle_classifies_and_caches(faulty):
    oracle = CorrectnessOracle(faulty, faulty.make_probe_args(PROBLEM,
                                                              DTYPE))
    good = oracle.check(HONEST)
    assert good.ok and good.max_err == 0.0 and good.rtol == 1e-5
    wrong = oracle.check(WRONG)
    assert wrong.status == "numerics-mismatch" and wrong.max_err > 0
    assert oracle.check(WRONG) is wrong
    crashed = oracle.check({"scale": 1, FAULT_PARAM: "raise"})
    assert crashed.status == "crash" and "injected" in crashed.detail


def test_gate_unverifiable_policy():
    gate = OracleGate()
    verdict = gate.check("no-such-kernel", {}, (4,), DTYPE)
    assert verdict.status == "unverifiable" and gate.allows(verdict)
    assert not OracleGate(on_unverifiable="reject").allows(verdict)
    with pytest.raises(ValueError):
        OracleGate(on_unverifiable="maybe")
    assert "verified" not in gate.stamp({}, "k", verdict)


def test_registry_unregister_and_probe_hooks():
    b = make_faulty_kernel("faulty_probe_check")
    register(b)
    assert "faulty_probe_check" in all_kernels() and b.has_probe()
    unregister("faulty_probe_check")
    unregister("faulty_probe_check")        # absent: a no-op
    assert "faulty_probe_check" not in all_kernels()
    assert get_kernel("advec_u").has_probe()


def test_online_promotion_rejects_wrong_winner(faulty, tmp_path):
    kernel = WisdomKernel(faulty, wisdom_dir=tmp_path, device_kind="cpu")
    pipeline = PromotionPipeline(kernel, wisdom_dir=tmp_path)
    assert pipeline.promote("cpu", PROBLEM, DTYPE, WRONG, score_us=50.5,
                            incumbent_score_us=200.0, n_measurements=3,
                            evals=16, objective="costmodel") is None
    rejection, = pipeline.rejections
    assert rejection.verdict.status == "numerics-mismatch"
    assert rejection.config == WRONG
    assert Wisdom.load(faulty.name, tmp_path).records == []
    promoted = pipeline.promote("cpu", PROBLEM, DTYPE, HONEST,
                                score_us=101.0, incumbent_score_us=200.0,
                                n_measurements=3, evals=16,
                                objective="costmodel")
    assert promoted.record.oracle_verified()["ref"] == \
        f"{faulty.name}.reference"
    assert [r.config[FAULT_PARAM] for r in Wisdom.load(
        faulty.name, tmp_path).records] == ["none"]


# ------------------------------------------------------ the demo, the CLI

def test_demo_gauntlet_passes_on_the_host():
    report = run_demo(timeout_s=5.0, device="cpu")
    assert report["problems"] == [] and report["pass"] is True
    assert report["bad_promotions"] == 0
    assert report["legs"] == ["sandbox", "oracle", "online", "fleet",
                              "transfer"]
    assert report["legs_not_ported"] == []
    assert report["sandbox"]["hang"]["status"] == "timeout"
    assert report["sandbox"]["segv"]["exit_cause"].startswith("signal:")
    assert report["oracle"]["wrong"]["status"] == "numerics-mismatch"
    assert report["paths"]["online"]["rejected_status"] == \
        "numerics-mismatch"
    # the transfer leg fell through the wrong top prediction to the honest
    # runner-up, as the reference's does
    assert report["paths"]["transfer"] == {"recorded": "none",
                                           "score_us": 101.0}
    assert report["paths"]["fleet"] == {"assembled": 1, "rejected": 1,
                                        "done_state": "assembled"}


def test_fleet_path_is_the_references(faulty):
    """The fleet leg: the wrong config wins a shard and the cross-shard
    comparison; the coordinator's gate vetoes it and assembles the honest
    shard winner, in both packages alike."""
    from repro.sandbox.demo import _fleet_path as ref_fleet_path
    from repro_torch.sandbox.demo import _fleet_path
    rb = ref_faulty(hang_s=3600.0)
    ref_register(rb)
    ref_clear_cache()
    try:
        want = ref_fleet_path(rb, RefOracleGate())
    finally:
        ref_unregister(rb.name)
        ref_clear_cache()
    got = _fleet_path(faulty, OracleGate(device="cpu"), "cpu")
    assert got == want == ({"assembled": 1, "rejected": 1,
                            "done_state": "assembled"}, [], 0)


@pytest.mark.parametrize("leg", ["transfer"])
def test_demo_legs_that_wait_for_their_layers_raise(leg, faulty):
    """No leg waits for its layer any more (``UNPORTED_LEGS`` is empty);
    the transfer leg's records go through the gate on the host, which
    vetoes the wrong top prediction."""
    assert leg not in UNPORTED_LEGS == ()
    from repro_torch.sandbox.demo import _transfer_path
    report, problems, bad = _transfer_path(faulty, OracleGate(), "cpu")
    assert (report, problems, bad) == (
        {"recorded": "none", "score_us": 101.0}, [], 0)


def test_cli_check_runs_on_the_requested_device(capsys, tmp_path):
    out = tmp_path / "verdict.json"
    assert cli.main(["check", "--kernel", "advec_u", "--problem", "8,8,16",
                     "--device", "cpu", "--set", "body=tile",
                     "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["verdict"]["status"] == "ok" and doc["device"] == "cpu"
    assert doc["config"]["body"] == "tile"
    assert "on cpu: ok" in capsys.readouterr().out
    if not torch.cuda.is_available():     # the card is the default
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["check", "--kernel", "advec_u"])
