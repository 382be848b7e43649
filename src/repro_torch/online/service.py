"""Online autotuning service — the facade wired into ``WisdomKernel``.

Port of ``repro.online.service``. Beyond-paper (closes the loop the paper
leaves open between §4.2 capture and §4.5 selection). The offline flow
(capture -> tune out-of-band -> ship wisdom) cannot cover scenarios nobody
anticipated; they run on fuzzy-matched or default configs forever.
``OnlineTuner`` closes that gap with live traffic:

  launch -> tracker observes the selection tier (miss = tiers 2-5)
         -> hot scenario gets a TrialScheduler (cost-model screening +
            a successive-halving bracket)
         -> epsilon fraction of launches run a bracket candidate ("trial")
         -> bracket winner beats incumbent with confidence
         -> PromotionPipeline gates it on the card, prewarms it, writes an
            ``online`` WisdomRecord and hot-swaps

Two objectives score the trials: ``"costmodel"`` (the analytical model's
number, deterministic) and ``"wallclock"`` (the trial launch's own
CUDA-event time, ``LaunchStats.launch_s``: the launch alone, without the
nvcc build or the load a first use of a config pays; the first launch of
a variant is not scored at all, since the card loads its module then).
Non-trial launches
always run the current incumbent, and all background work is bounded by
the per-launch :class:`OverheadBudget`. Everything is seeded, so a fixed
traffic sequence converges identically run to run under the cost model.

Enable per kernel with :func:`enable_online_tuning`, or globally with
``KERNEL_LAUNCHER_ONLINE=1`` (auto-attached at ``WisdomKernel``
construction). The port launches eagerly only, so
:meth:`OnlineTuner.observe_traced` has no caller among its launches; a
host that selects configs outside a launch (as the reference's jitted
models do) reports them there, and :meth:`OnlineTuner.tick` does their
work. Single-threaded by design: calls happen on the launching thread.
"""

from __future__ import annotations

import hashlib
import os
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np

from repro_torch.core.builder import ArgsMeta
from repro_torch.core.device import get_device
from repro_torch.core.param import Config
from repro_torch.core.wisdom_kernel import online_requested  # noqa: F401
from repro_torch.obs import runtime as obs
from repro_torch.tuner.runner import CostModelEvaluator

from .budget import BudgetTimer, OverheadBudget, OverheadMeter
from .promotion import Promotion, PromotionPipeline
from .scheduler import TrialScheduler
from .tracker import MISS_TIERS, ScenarioKey, ScenarioTracker, format_key

ONLINE_ENV = "KERNEL_LAUNCHER_ONLINE"
ONLINE_EPSILON_ENV = "KERNEL_LAUNCHER_ONLINE_EPSILON"

DEFAULT_EPSILON = 0.25

#: Wall-clock incumbent timings kept per scenario (rolling window — the
#: incumbent baseline should track recent behaviour, and an observe-only
#: scenario must not accumulate unbounded state in a long-running server).
INCUMBENT_WINDOW = 64


def _scenario_seed(seed: int, kernel: str, key: ScenarioKey) -> int:
    h = hashlib.sha256(f"{seed}|{kernel}|{key}".encode()).digest()
    return int.from_bytes(h[:8], "little")


@dataclass
class _ScenarioState:
    key: ScenarioKey
    scheduler: TrialScheduler
    evaluator: CostModelEvaluator
    rng: np.random.Generator
    meta: ArgsMeta
    incumbent_config: Config
    incumbent_score_us: float | None = None
    incumbent_runs: deque = field(
        default_factory=lambda: deque(maxlen=INCUMBENT_WINDOW))
    pending_trial: Config | None = None
    promotion: Promotion | None = None
    finished: bool = False        # bracket resolved (promoted or kept)
    traced: bool = False          # demand observed only at trace time
    cold_trials: int = 0          # wall-clock trials not scored: cold

    def set_incumbent(self, space, config: Config) -> None:
        """Track the incumbent identity; if selection flipped to a
        different config (e.g. another scenario's promotion changed this
        scenario's fuzzy match), the old baseline timings/score belong to
        the old config and must be discarded."""
        if space.freeze(config) != space.freeze(self.incumbent_config):
            self.incumbent_config = dict(config)
            self.incumbent_runs.clear()
            self.incumbent_score_us = None

    def incumbent_us(self, objective: str) -> float | None:
        if objective == "wallclock":
            if not self.incumbent_runs:
                return None
            return float(np.mean(self.incumbent_runs))
        if self.incumbent_score_us is None:
            r = self.evaluator(self.incumbent_config)
            self.incumbent_score_us = r.score_us
        return self.incumbent_score_us


class OnlineTuner:
    """Traffic-driven tuning for one :class:`WisdomKernel`."""

    def __init__(self, kernel, objective: str = "costmodel",
                 epsilon: float | None = None, seed: int = 0,
                 budget: OverheadBudget | None = None,
                 activation_threshold: int = 3,
                 pool_size: int = 128, bracket_size: int = 8,
                 margin: float = 0.02, min_measurements: int = 1,
                 wisdom_dir: Path | str | None = None,
                 broadcast=None, oracle="auto"):
        if objective not in ("costmodel", "wallclock"):
            raise ValueError(f"unknown objective {objective!r}")
        self.kernel = kernel
        self.objective = objective
        if epsilon is None:
            try:
                epsilon = float(os.environ.get(ONLINE_EPSILON_ENV,
                                               DEFAULT_EPSILON))
            except ValueError as e:
                raise ValueError(
                    f"bad {ONLINE_EPSILON_ENV}: {e}") from None
        self.epsilon = epsilon
        self.seed = seed
        self.budget = budget or OverheadBudget.from_env()
        self.pool_size = pool_size
        self.bracket_size = bracket_size
        self.tracker = ScenarioTracker(activation_threshold)
        self.pipeline = PromotionPipeline(kernel, wisdom_dir=wisdom_dir,
                                          margin=margin,
                                          min_measurements=min_measurements,
                                          broadcast=broadcast,
                                          oracle=oracle)
        self.meter = OverheadMeter()
        self.events: list[tuple[str, ScenarioKey, Any]] = []
        self._states: dict[ScenarioKey, _ScenarioState] = {}

    # -- WisdomKernel hooks ----------------------------------------------------

    def before_launch(self, problem: tuple[int, ...], dtype: str,
                      meta: ArgsMeta, config: Config,
                      tier: str) -> Config | None:
        """Observe a selection; return a candidate config to divert this
        launch into a trial, or None to launch the incumbent untouched."""
        self.meter.begin()
        try:
            st = self.tracker.observe(self.kernel.device_kind, problem,
                                      dtype, tier)
            state = self._states.get(st.key)
            if state is None:
                if not self.tracker.is_hot(*st.key):
                    return None
                state = self._activate(st.key, meta, config)
            if state.finished:
                return None
            state.traced = False          # scenario has eager traffic now
            state.set_incumbent(self.kernel.builder.space, config)
            cand = state.scheduler.next_trial()
            if cand is None:
                return None
            if state.rng.random() >= self.epsilon:
                return None
            state.pending_trial = cand
            st.trials += 1
            m = obs.metrics()
            if m is not None:
                m.counter("online.trials",
                          kernel=self.kernel.builder.name).inc()
            return cand
        finally:
            self.meter.end()

    def after_launch(self, problem: tuple[int, ...], dtype: str,
                     config: Config, tier: str, launch_s: float,
                     cold: bool = False) -> None:
        """Account the finished launch, then spend this launch's overhead
        budget on background tuning work.

        ``cold`` marks the first launch of a variant in this kernel (the
        one that built and loaded it). Under the wall-clock objective its
        time is not a measurement: CUDA loads a library's module lazily,
        at its first launch, which the launch's events then include (a
        first launch 3-40x slower at 512^3 on the H100, PERF.md §6). A
        cold trial is repeated, and a cold incumbent launch not kept."""
        self.meter.begin()
        key = self.tracker.key(self.kernel.device_kind, problem, dtype)
        state = self._states.get(key)
        screens = 0
        trial = tier == "trial"
        unmeasured = cold and self.objective == "wallclock"
        if state is not None and not state.finished:
            if trial and unmeasured:
                state.cold_trials += 1
                state.pending_trial = None
            elif trial:
                score = self._trial_score(state, config, launch_s)
                state.scheduler.report_trial(config, score)
                state.pending_trial = None
            elif tier != "forced" and not unmeasured:
                state.incumbent_runs.append(launch_s * 1e6)
            timer = BudgetTimer(self.budget)
            screens = state.scheduler.screen(timer)
            self._maybe_promote(state)
        before_s = self.meter.overhead_s
        self.meter.end(screens=screens, trial=trial, launch=True)
        self._observe_spend(self.meter.overhead_s - before_s, screens)

    def observe_traced(self, problem: tuple[int, ...], dtype: str,
                       meta: ArgsMeta, config: Config, tier: str) -> None:
        """Record a selection made outside a launch (in the reference, a
        trace-time one inside an outer jit; the port's launches are all
        eager and call :meth:`before_launch` instead). One such selection
        stands for a whole execution stream, so a miss makes the scenario
        hot immediately; its tuning work then runs through :meth:`tick`
        (the host's decode loop sponsors it), not through launch hooks."""
        st = self.tracker.observe(self.kernel.device_kind, problem, dtype,
                                  tier,
                                  weight=self.tracker.activation_threshold)
        state = self._states.get(st.key)
        if state is None and tier in MISS_TIERS:
            state = self._activate(st.key, meta, config)
            state.traced = True
        elif state is not None and not state.finished:
            state.set_incumbent(self.kernel.builder.space, config)

    # -- background work without launches -------------------------------------

    def tick(self) -> int:
        """Advance screening/promotion for every active scenario under one
        launch's worth of budget — for hosts (serving decode loop, train
        warmup) that want tuning progress between kernel launches.

        Scenarios whose demand was observed only through
        :meth:`observe_traced` can never receive live trial measurements;
        under the deterministic cost-model objective their bracket is
        resolved here instead, with evaluator scores — exactly what a live
        trial would have reported. (Under the wall-clock objective such
        scenarios stop at screening: there is nothing to measure.) A
        promotion then lands in the wisdom file for the next selection."""
        self.meter.begin()
        screens = 0
        timer = BudgetTimer(self.budget)
        for state in self._states.values():
            if state.finished:
                continue
            screens += state.scheduler.screen(timer)
            if state.traced and self.objective == "costmodel":
                while timer.take():
                    cand = state.scheduler.next_trial()
                    if cand is None:
                        break
                    state.scheduler.report_trial(
                        cand, state.evaluator(cand).score_us)
                    screens += 1
            self._maybe_promote(state)
        before_s = self.meter.overhead_s
        self.meter.end(screens=screens)
        self._observe_spend(self.meter.overhead_s - before_s, screens)
        return screens

    # -- internals -------------------------------------------------------------

    def _observe_spend(self, spent_s: float, screens: int) -> None:
        """Report this slice of background-tuning budget to telemetry."""
        m = obs.metrics()
        if m is None:
            return
        name = self.kernel.builder.name
        m.counter("online.overhead_us", kernel=name).inc(spent_s * 1e6)
        if screens:
            m.counter("online.screens", kernel=name).inc(screens)

    def _activate(self, key: ScenarioKey, meta: ArgsMeta,
                  incumbent: Config) -> _ScenarioState:
        device_kind, problem, dtype = key
        rng = np.random.default_rng(
            _scenario_seed(self.seed, self.kernel.builder.name, key))
        evaluator = CostModelEvaluator(self.kernel.builder, problem, dtype,
                                       get_device(device_kind),
                                       verify="none")
        state = _ScenarioState(
            key=key,
            scheduler=TrialScheduler(self.kernel.builder.space, evaluator,
                                     rng, pool_size=self.pool_size,
                                     bracket_size=self.bracket_size),
            evaluator=evaluator, rng=rng, meta=meta,
            incumbent_config=dict(incumbent))
        self._states[key] = state
        self.events.append(("activate", key, dict(incumbent)))
        return state

    def _trial_score(self, state: _ScenarioState, config: Config,
                     launch_s: float) -> float:
        if self.objective == "wallclock":
            return launch_s * 1e6
        return state.evaluator(config).score_us

    def _promotion_outcome(self, state: _ScenarioState,
                           outcome: str) -> None:
        m = obs.metrics()
        if m is not None:
            m.counter("online.promotions",
                      kernel=self.kernel.builder.name,
                      outcome=outcome).inc()
        tr = obs.tracer()
        if tr is not None:
            tr.instant("online." + outcome, cat="online",
                       kernel=self.kernel.builder.name,
                       scenario=format_key(state.key))

    def _maybe_promote(self, state: _ScenarioState) -> None:
        if state.scheduler.bracket_dead:
            # screening found nothing feasible: stop spending on this
            # scenario, the incumbent is all there is
            state.finished = True
            self.events.append(("no-candidates", state.key,
                                dict(state.incumbent_config)))
            self._promotion_outcome(state, "no-candidates")
            return
        won = state.scheduler.winner()
        if won is None:
            return
        config, score_us, n_meas = won
        incumbent_us = state.incumbent_us(self.objective)
        if incumbent_us is None:
            return          # wallclock objective, incumbent not yet timed
        device_kind, problem, dtype = state.key
        rejections_before = len(self.pipeline.rejections)
        promo = self.pipeline.promote(
            device_kind, problem, dtype, config, score_us, incumbent_us,
            n_measurements=n_meas, evals=state.scheduler.screens + n_meas,
            objective=self.objective,
            meta=None if state.traced else state.meta)
        state.finished = True
        if promo is not None:
            state.promotion = promo
            self.events.append(("promote", state.key, promo))
            self._promotion_outcome(state, "promoted")
        elif len(self.pipeline.rejections) > rejections_before:
            # the winner beat the incumbent but failed the correctness
            # oracle — the incumbent keeps serving, and the veto is an
            # event of its own so dashboards can tell it from "not faster"
            rej = self.pipeline.rejections[-1]
            self.events.append(("oracle-reject", state.key, rej))
            self._promotion_outcome(state, "rejected")
        else:
            self.events.append(("keep-incumbent", state.key,
                                dict(state.incumbent_config)))
            self._promotion_outcome(state, "kept")

    # -- introspection ---------------------------------------------------------

    def state(self, problem: tuple[int, ...],
              dtype: str) -> _ScenarioState | None:
        return self._states.get(
            self.tracker.key(self.kernel.device_kind, problem, dtype))

    def promotions(self) -> list[Promotion]:
        return list(self.pipeline.promotions)

    def status(self) -> dict:
        return {
            "kernel": self.kernel.builder.name,
            "objective": self.objective,
            "epsilon": self.epsilon,
            "scenarios": len(self.tracker),
            "active": sum(1 for s in self._states.values()
                          if not s.finished),
            "promotions": len(self.pipeline.promotions),
            "broadcasts": self.pipeline.broadcasts,
            "launches": self.meter.launches,
            "trials": self.meter.trials,
            "screens": self.meter.screens,
            "overhead_per_launch_s": self.meter.overhead_per_launch_s,
        }


def enable_online_tuning(kernel, **kwargs) -> OnlineTuner:
    """Construct an :class:`OnlineTuner` for ``kernel`` and attach it."""
    tuner = OnlineTuner(kernel, **kwargs)
    kernel.attach_online(tuner)
    return tuner
