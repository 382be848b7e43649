"""The port's online autotuning (``repro_torch.online``) on CPU tensors,
against the JAX package's ``repro.online``.

Parity: the tracker's accounting and snapshot, ``OverheadBudget.from_env``,
and the trial scheduler's screened configs and bracket winner on one toy
space (same evaluator, same seed) are the reference's exactly; a promoted
record's JSON is the reference's outside the host fields of its provenance.
The rest are the port's versions of ``tests/test_online.py``: with an
empty wisdom dir and the cost-model objective on ``gpu-h100``, traffic on
CPU tensors (the plain version runs) converges to the port's own
exhaustive optimum, promotes an ``online`` record through the gate,
prewarms it, and ticks from ``ServeEngine``. On the card the same loop runs
with the wall-clock objective (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phase 8).
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

import repro.online as ro
from repro.core.param import ConfigSpace as RefConfigSpace
from repro.online.promotion import PromotionPipeline as RefPipeline
from repro.sandbox import make_faulty_kernel as ref_faulty
from repro.tuner.runner import EvalResult as RefEvalResult

import repro_torch.online as po
from repro_torch.core import (ConfigSpace, KernelBuilder, Wisdom,
                              WisdomKernel, Workload, args_meta, get_device,
                              get_kernel)
from repro_torch.core.scenario import HIT_TIERS, MISS_TIERS, SELECT_TIERS
from repro_torch.online import (OnlineTuner, OverheadBudget,
                                ScenarioTracker, TrialScheduler,
                                enable_online_tuning)
from repro_torch.online.promotion import PromotionPipeline
from repro_torch.sandbox import make_faulty_kernel
from repro_torch.tuner import CostModelEvaluator, EvalResult, tune_exhaustive

torch.set_num_threads(1)

PROBLEM = (256, 256, 256)
DTYPE = "float32"
DEVICE = "gpu-h100"


def _mm_args():
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.standard_normal((256, 256))
                                  .astype(np.float32)) for _ in range(2))


def _kernel(wisdom_dir, **kw):
    k = WisdomKernel(get_kernel("matmul"), wisdom_dir=wisdom_dir,
                     device_kind=DEVICE)
    svc = enable_online_tuning(k, objective="costmodel", seed=0, **kw)
    return k, svc


def _evaluator():
    return CostModelEvaluator(get_kernel("matmul"), PROBLEM, DTYPE,
                              get_device(DEVICE), verify="none")


def _promote_within(k, svc, n=300):
    a, b = _mm_args()
    for i in range(n):
        k(a, b)
        if svc.promotions():
            return i + 1
    return None


# ------------------------------------------------------------- parity

def _tier_stream(seed: int, n: int):
    rng = np.random.default_rng(seed)
    problems = [(64, 64, 64), (256, 256, 256), (512, 512, 1024)]
    for _ in range(n):
        yield (problems[int(rng.integers(len(problems)))],
               str(rng.choice(["float32", "bfloat16"])),
               str(rng.choice(list(SELECT_TIERS) + ["forced", "trial"])),
               int(rng.integers(1, 4)))


def test_tracker_matches_the_reference():
    port, ref = ScenarioTracker(3), ro.ScenarioTracker(3)
    for problem, dtype, tier, weight in _tier_stream(0, 400):
        a = port.observe(DEVICE, problem, dtype, tier, weight=weight)
        b = ref.observe(DEVICE, problem, dtype, tier, weight=weight)
        assert a.to_json() == b.to_json()
        assert port.is_hot(DEVICE, problem, dtype) == ref.is_hot(
            DEVICE, problem, dtype)
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())
    assert [s.to_json() for s in port.hot_scenarios()] == \
        [s.to_json() for s in ref.hot_scenarios()]
    assert MISS_TIERS == ro.MISS_TIERS and HIT_TIERS == ro.tracker.HIT_TIERS


@pytest.mark.parametrize("env", [{}, {"BUDGET_MS": "5", "SCREENS": "3"},
                                 {"BUDGET_MS": "0.25"}, {"SCREENS": "x"}])
def test_budget_from_env_matches_the_reference(monkeypatch, env):
    for name in ("BUDGET_MS", "SCREENS"):
        monkeypatch.delenv(f"KERNEL_LAUNCHER_ONLINE_{name}", raising=False)
    for name, value in env.items():
        monkeypatch.setenv(f"KERNEL_LAUNCHER_ONLINE_{name}", value)
    try:
        want = ro.OverheadBudget.from_env()
    except ValueError as e:
        with pytest.raises(ValueError, match="SCREENS"):
            OverheadBudget.from_env()
        assert "SCREENS" in str(e)
        return
    got = OverheadBudget.from_env()
    assert (got.per_launch_s, got.screens_per_launch) == (
        want.per_launch_s, want.screens_per_launch)


def _toy_spaces(big: bool):
    """One toy space in both packages: 216 configs (enumerated and
    shuffled) or 7776 (sampled), with a restriction."""
    spaces = []
    for cls in (ConfigSpace, RefConfigSpace):
        s = cls()
        s.tune("a", (1, 2, 4, 8, 16, 32), 4)
        s.tune("b", (1, 2, 3, 4, 5, 6), 2)
        s.tune("c", ("x", "y", "z", "u", "v", "w"), "x")
        if big:
            s.tune("d", (0, 1, 2, 3, 4, 5), 0)
            s.tune("e", (7, 8, 9, 10, 11, 12), 7)
        s.restrict("a * b <= 96")
        spaces.append(s)
    return spaces


def _toy_score(config) -> float:
    """Deterministic, rugged: the same number for both packages."""
    h = sum((i + 3) * (len(str(v)) * 7 + (v if isinstance(v, int)
                                            else ord(v)))
            for i, (_, v) in enumerate(sorted(config.items())))
    return 10.0 + (h * 2654435761 % 1000) / 10.0


@pytest.mark.parametrize("big", [False, True], ids=["enumerated", "sampled"])
def test_scheduler_matches_the_reference(big):
    """Same space, evaluator and seed: the same screened configs in the
    same order, the same bracket and the same winner under the same live
    measurements."""
    port_space, ref_space = _toy_spaces(big)
    port = TrialScheduler(port_space,
                          lambda c: EvalResult(_toy_score(c), True),
                          np.random.default_rng(7), pool_size=48,
                          bracket_size=6)
    ref = ro.TrialScheduler(ref_space,
                            lambda c: RefEvalResult(_toy_score(c), True),
                            np.random.default_rng(7), pool_size=48,
                            bracket_size=6)

    class _Timer:
        def __init__(self, n):
            self.n = n

        def take(self):
            self.n -= 1
            return self.n >= 0

    while not (port.screening_done() and ref.screening_done()):
        assert port.screen(_Timer(5)) == ref.screen(_Timer(5))
    assert [e.config for e in port.session.evals] == \
        [e.config for e in ref.session.evals]
    assert port.best_screened() == ref.best_screened()
    meas = np.random.default_rng(3)
    for _ in range(200):
        a, b = port.next_trial(), ref.next_trial()
        assert a == b
        if a is None:
            break
        score = _toy_score(a) * meas.uniform(0.9, 1.1)
        port.report_trial(a, score)
        ref.report_trial(b, score)
    assert port.winner() is not None and port.winner() == ref.winner()


#: Provenance keys that name the host, the date and the framework.
HOST_FIELDS = ("date", "host", "user", "platform", "torch_version",
               "cuda_version", "jax_version")


def test_promoted_record_json_matches_the_reference(tmp_path):
    port_b, ref_b = make_faulty_kernel(), ref_faulty()
    port_k = WisdomKernel(port_b, wisdom_dir=tmp_path / "port",
                          device_kind="tpu-v5e")
    from repro.core.wisdom_kernel import WisdomKernel as RefWisdomKernel
    ref_k = RefWisdomKernel(ref_b, wisdom_dir=tmp_path / "ref",
                            device_kind="tpu-v5e", backend="reference")
    docs = []
    for pipe in (PromotionPipeline(port_k, wisdom_dir=tmp_path / "port"),
                 RefPipeline(ref_k, wisdom_dir=tmp_path / "ref")):
        promo = pipe.promote("tpu-v5e", (8, 8), "float32",
                             {"scale": 2, "fault": "none"}, score_us=80.0,
                             incumbent_score_us=120.0, n_measurements=4,
                             evals=20, objective="wallclock")
        doc = promo.record.to_json()
        for key in HOST_FIELDS:
            doc["provenance"].pop(key, None)
        docs.append(json.dumps(doc, sort_keys=True))
    assert docs[0] == docs[1]
    assert '"verified"' in docs[0] and '"online": true' in docs[0]


# ----------------------------------------------- the loop on CPU tensors

def test_online_convergence_within_300_launches(wisdom_dir):
    """Empty wisdom + traffic -> within 5% of the port's exhaustive cost
    model optimum in <= 300 launches; non-trial launches run the
    incumbent."""
    k, svc = _kernel(wisdom_dir)
    default_cfg = k.builder.default_config()
    promoted_at = _promote_within(k, svc)
    assert promoted_at is not None, "no promotion within 300 launches"
    a, b = _mm_args()
    for _ in range(5):
        k(a, b)
    assert all(s.tier == "exact" for s in k.stats[-5:])
    for s in k.stats[:promoted_at - 1]:
        if s.tier != "trial":
            assert s.tier == "default" and s.config == default_cfg
    off = tune_exhaustive(k.builder.space, _evaluator())
    cfg, tier = k.select_config(PROBLEM, DTYPE)
    assert tier == "exact"
    assert _evaluator()(cfg).score_us <= off.best_score_us * 1.05


def test_promotion_writes_online_record(wisdom_dir):
    k, svc = _kernel(wisdom_dir)
    assert _promote_within(k, svc) is not None
    rec, = Wisdom.load("matmul", wisdom_dir).records
    assert (rec.device_kind, rec.device_family) == (
        DEVICE, get_device(DEVICE).family)
    assert rec.problem_size == PROBLEM and rec.dtype == DTYPE
    assert np.isfinite(rec.score_us) and k.builder.space.is_valid(rec.config)
    prov = rec.provenance
    assert (prov["strategy"], prov["online"], prov["objective"]) == (
        "online", True, "costmodel")
    assert prov["evaluations"] > 0 and prov["live_measurements"] >= 1
    # the gate checked the launch's own device: these are CPU tensors
    assert rec.oracle_verified() == {"rtol": 1e-5, "atol": 1e-5,
                                     "ref": "matmul.reference"}
    assert svc.pipeline.oracle.checks[-1][2].ok


def test_promoted_variant_is_prewarmed(wisdom_dir):
    k, svc = _kernel(wisdom_dir)
    assert _promote_within(k, svc) is not None
    k(*_mm_args())
    assert k.stats[-1].tier == "exact"
    assert k.stats[-1].cached and k.stats[-1].compile_s == 0.0


def test_epsilon_zero_never_trials(wisdom_dir):
    k, svc = _kernel(wisdom_dir, epsilon=0.0)
    a, b = _mm_args()
    for _ in range(60):
        k(a, b)
    assert all(s.tier != "trial" for s in k.stats)
    assert svc.meter.trials == 0 and not svc.promotions()


def test_budget_caps_screens_per_launch(wisdom_dir):
    budget = OverheadBudget(per_launch_s=10.0, screens_per_launch=2)
    k, svc = _kernel(wisdom_dir, budget=budget)
    a, b = _mm_args()
    for _ in range(40):
        k(a, b)
    assert 0 < svc.meter.screens <= budget.screens_per_launch * 40


def test_tick_advances_screening_without_launches(wisdom_dir):
    k, svc = _kernel(wisdom_dir, epsilon=0.0)
    a, b = _mm_args()
    for _ in range(4):                   # past the activation threshold
        k(a, b)
    state = svc.state(PROBLEM, DTYPE)
    before = state.scheduler.screens
    while not state.scheduler.screening_done():
        assert svc.tick() > 0
    assert state.scheduler.screens > before


def test_selection_reported_outside_a_launch_is_resolved_by_tick(
        wisdom_dir):
    """A selection reported through ``observe_traced`` makes its scenario
    hot at once; under the cost model ``tick`` resolves its bracket and
    promotes without a launch, and the next selection is exact."""
    k, svc = _kernel(wisdom_dir)
    meta = args_meta(*_mm_args())
    svc.observe_traced(PROBLEM, DTYPE, meta, k.builder.default_config(),
                       "default")
    state = svc.state(PROBLEM, DTYPE)
    assert state is not None and state.traced and svc.meter.trials == 0
    for _ in range(500):
        svc.tick()
        if svc.promotions():
            break
    assert svc.promotions(), "tick() never resolved the scenario"
    assert Wisdom.load("matmul", wisdom_dir).records[0].provenance[
        "strategy"] == "online"
    assert k.select_config(PROBLEM, DTYPE)[1] == "exact"


def test_dead_bracket_finishes_scenario(wisdom_dir):
    """Nothing feasible under the cost model (every workload invalid) ->
    the scenario finishes without promotion instead of spending budget
    forever."""
    b = KernelBuilder("dead-space-kernel")
    b.tune("x", (1, 2))
    b.build(lambda config, problem, meta: (lambda v: v))
    b.reference(lambda v: v)
    b.workload(lambda config, problem, dtype: Workload(0, 0, 0, 0,
                                                        valid=False))
    k = WisdomKernel(b, wisdom_dir=wisdom_dir, device_kind=DEVICE)
    svc = enable_online_tuning(k, objective="costmodel", seed=0)
    v = torch.ones(4)
    for _ in range(10):
        k(v)
    state = svc.state((4,), DTYPE)
    assert state is not None and state.finished
    assert not svc.promotions()
    assert any(kind == "no-candidates" for kind, _, _ in svc.events)


def test_incumbent_baseline_resets_when_selection_flips(wisdom_dir):
    k, svc = _kernel(wisdom_dir, epsilon=0.0)
    a, b = _mm_args()
    for _ in range(10):
        k(a, b)
    state = svc.state(PROBLEM, DTYPE)
    assert len(state.incumbent_runs) > 0
    state.incumbent_score_us = 123.0
    flipped = dict(state.incumbent_config)
    flipped["block_m"] = 64 if flipped["block_m"] != 64 else 128
    state.set_incumbent(k.builder.space, flipped)
    assert len(state.incumbent_runs) == 0
    assert state.incumbent_score_us is None
    for _ in range(5):
        k(a, b)
    assert state.incumbent_runs.maxlen is not None


def test_env_auto_attach(monkeypatch, wisdom_dir):
    monkeypatch.setenv("KERNEL_LAUNCHER_ONLINE", "1")
    k = WisdomKernel(get_kernel("matmul"), wisdom_dir=wisdom_dir,
                     device_kind=DEVICE)
    assert isinstance(k.online, OnlineTuner)
    assert k.online.objective == "costmodel"
    monkeypatch.setenv("KERNEL_LAUNCHER_ONLINE_EPSILON", "0.5")
    assert OnlineTuner(k).epsilon == 0.5
    monkeypatch.setenv("KERNEL_LAUNCHER_ONLINE", "0")
    k2 = WisdomKernel(get_kernel("matmul"), wisdom_dir=wisdom_dir,
                      device_kind=DEVICE)
    assert k2.online is None
    assert po.online_requested() is False


def test_wallclock_trial_scores_are_launch_times_without_compile(
        wisdom_dir, monkeypatch):
    """Under the wall-clock objective a trial's score is its launch's
    ``launch_s``: the build of a config not yet compiled (here a 0.3 s
    build) goes into ``compile_s``, and that first, cold launch of the
    variant is not scored at all; the variant's next trial is."""
    builder = get_kernel("matmul")
    real_make = builder.make

    def slow_make(config, meta):
        time.sleep(0.3)
        return real_make(config, meta)

    monkeypatch.setattr(builder, "make", slow_make)
    k = WisdomKernel(builder, wisdom_dir=wisdom_dir, device_kind=DEVICE)
    svc = enable_online_tuning(k, objective="wallclock", seed=0,
                               epsilon=1.0, pool_size=8, bracket_size=2)
    reported = []
    real_report = TrialScheduler.report_trial

    def spy(self, config, score_us):
        reported.append((dict(config), score_us))
        return real_report(self, config, score_us)

    monkeypatch.setattr(TrialScheduler, "report_trial", spy)
    a, b = (x[:32, :32].contiguous() for x in _mm_args())
    for _ in range(30):
        k(a, b)
    trials = [s for s in k.stats if s.tier == "trial"]
    first = trials[0]
    assert not first.cached and first.compile_s >= 0.3
    assert first.launch_s < 0.3
    scored = [s for s in trials if s.cached]
    assert reported and len(reported) == len(scored)
    assert reported[0] == (scored[0].config,
                           pytest.approx(scored[0].launch_s * 1e6))
    state = svc.state((32, 32, 32), DTYPE)
    assert state.cold_trials == sum(not s.cached for s in trials) > 0
    # a cold incumbent launch is no baseline either
    k2 = WisdomKernel(get_kernel("matmul"), wisdom_dir=wisdom_dir / "k2",
                      device_kind=DEVICE)
    svc2 = enable_online_tuning(k2, objective="wallclock", epsilon=0.0)
    for _ in range(3):
        k2(a, b)
    runs = svc2.state((32, 32, 32), DTYPE).incumbent_runs
    n = len(runs)
    cfg = k2.stats[-1].config
    svc2.after_launch((32, 32, 32), DTYPE, cfg, "default", 1.0, cold=True)
    assert len(runs) == n
    svc2.after_launch((32, 32, 32), DTYPE, cfg, "default", 1e-3)
    assert len(runs) == n + 1 and runs[-1] == pytest.approx(1e3)


def test_serve_engine_ticks_online_each_decode_step():
    from repro_torch.serve.engine import Request, ServeEngine

    class _FakeTuner:
        def __init__(self):
            self.ticks = 0

        def tick(self):
            self.ticks += 1
            return 0

    class TinyLM:
        device = torch.device("cpu")

        def init_cache(self, n_slots, max_seq):
            return {"pos": torch.zeros((), dtype=torch.int32)}

        def decode_step(self, params, cache, tok):
            return torch.zeros((tok.shape[0], 1, 8)), cache

    svc = _FakeTuner()
    eng = ServeEngine(TinyLM(), params={}, n_slots=2, max_seq=32,
                      online=svc)
    assert eng.submit(Request(0, np.array([1, 2], np.int32),
                              max_new_tokens=3))
    eng.run()
    assert eng.steps_run > 0 and svc.ticks == eng.steps_run


def test_example_promotes_on_the_host(capsys, tmp_path):
    from repro_torch.examples import online_serving
    out = online_serving.main(["--device", "cpu", "--size", "64",
                               "--wisdom-dir", str(tmp_path)])
    assert out["service"].promotions()
    assert out["kernel"].stats[-1].tier == "exact"
    assert out["kernel"].stats[-1].compile_s == 0.0
    assert "promoted after" in capsys.readouterr().out
    if not torch.cuda.is_available():     # the card is the default
        with pytest.raises(RuntimeError, match="--device cpu"):
            online_serving.main([])
