"""Strategy benchmarking harness: fraction-of-optimum curves + thresholds.

The methodology follows the auto-tuning benchmarking literature
(Schoonhoven et al., "Benchmarking optimization algorithms for
auto-tuning GPU kernels"; Tørring et al., "Towards a Benchmarking Suite
for Kernel Tuners"): run every strategy against the *same recorded
search space* (:class:`~repro_torch.tunebench.simulate.SimulatedRunner`), and
report, per evaluation budget, the fraction of the space's known optimum
the strategy's best-so-far has reached:

    fraction(b) = optimum_score / best_score_after_b_evaluations

1.0 means the optimum was found; curves are monotone nondecreasing in
the budget. Everything is seeded and replayed, so a report is a pure
function of (datasets, strategies, budget, seeds) — byte-identical
across runs — and per-strategy *thresholds* on the final fraction turn
the comparison into a regression gate a CI job can fail on.

See ``docs/strategy-benchmarking.md`` for how to read the curves and how
to add a recorded space.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.tuner.strategies import STRATEGIES, TuningResult

from .dataset import SpaceDataset
from .simulate import SimulatedRunner

#: Report schema version (bump on structural changes).
#: v2: per-strategy ``wasted_evals`` + ``verdicts`` (sandbox-verdict
#: replay — budget burned re-proposing known-fatal configs).
REPORT_VERSION = 2

#: Default evaluation budget per simulated session.
DEFAULT_BUDGET = 64

#: Seeds averaged per strategy (each seed is one independent session).
DEFAULT_SEEDS = (0, 1, 2)

#: Regression gates on the mean final fraction-of-optimum. Set with
#: margin below the values the shipped recorded spaces produce today
#: (the reference's ``benchmarks/strategy_bench.py``); a strategy change
#: that drops below its gate made the tuner *worse* and should fail CI,
#: not silently ship worse wisdom. Exhaustive enumerates a lexicographic prefix, so at
#: partial budget it is a coverage baseline, not a competitor — its gate
#: only catches enumeration-order regressions.
DEFAULT_THRESHOLDS = {
    "random": 0.80,
    "bayes": 0.90,
    "anneal": 0.80,
    "exhaustive": 0.25,
}


@dataclass
class StrategyOutcome:
    """One strategy's aggregated performance on one dataset."""
    strategy: str
    threshold: float
    mean_curve: list[float]           # fraction-of-optimum per budget step
    final_fraction: float             # mean over seeds at full budget
    per_seed_final: list[float]
    per_seed_best_us: list[float]
    passed: bool = field(default=False)
    #: Evaluations spent re-proposing configs whose recorded sandbox
    #: verdict already said they fail fatally (summed over seeds). Live,
    #: each one costs a timeout or a child-process death — lower is
    #: better, and a strategy that won't learn from crashes shows up
    #: here even when its fraction-of-optimum looks fine.
    wasted_evals: int = 0
    #: Replayed sandbox verdicts by status, summed over seeds.
    verdicts: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"strategy": self.strategy, "threshold": self.threshold,
                "mean_curve": self.mean_curve,
                "final_fraction": self.final_fraction,
                "per_seed_final": self.per_seed_final,
                "per_seed_best_us": self.per_seed_best_us,
                "wasted_evals": self.wasted_evals,
                "verdicts": {k: self.verdicts[k]
                             for k in sorted(self.verdicts)},
                "pass": self.passed}


def run_on_dataset(dataset: SpaceDataset, strategy: str,
                   budget: int = DEFAULT_BUDGET,
                   seed: int = 0,
                   runner: SimulatedRunner | None = None) -> TuningResult:
    """One simulated tuning session: ``strategy`` over the recorded space.

    Wall-clock budgets are disabled (simulation must not depend on host
    speed); the evaluation budget is the only binding constraint.
    ``runner`` lets a caller supply the :class:`SimulatedRunner` so it
    can read the replay counters (hits, verdicts, wasted evals) after
    the session.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"have {sorted(STRATEGIES)}")
    sim = runner if runner is not None else SimulatedRunner(dataset)
    space = dataset.space()
    if strategy == "exhaustive":
        return STRATEGIES["exhaustive"](space, sim, limit=budget)
    return STRATEGIES[strategy](space, sim, max_evals=budget,
                                rng=np.random.default_rng(seed),
                                time_budget_s=None)


def fraction_curve(dataset: SpaceDataset, result: TuningResult,
                   budget: int) -> list[float]:
    """Fraction-of-optimum after each evaluation, padded to ``budget``.

    Entry ``i`` is ``optimum / best_so_far`` after ``i + 1`` evaluations
    (0.0 while nothing feasible has been seen). Sessions that exhaust the
    space early are padded with their final value — stopping early with
    the optimum in hand is not a regression.
    """
    optimum = dataset.best()
    opt = optimum.score_us if optimum is not None else math.inf
    curve: list[float] = []
    best = math.inf
    for e in result.evaluations[:budget]:
        if e.feasible and e.score_us < best:
            best = e.score_us
        curve.append(0.0 if not math.isfinite(best) else opt / best)
    last = curve[-1] if curve else 0.0
    curve.extend([last] * (budget - len(curve)))
    return [round(f, 6) for f in curve]


def compare(datasets: Sequence[SpaceDataset],
            strategies: Sequence[str] | None = None,
            budget: int = DEFAULT_BUDGET,
            seeds: Sequence[int] = DEFAULT_SEEDS,
            thresholds: dict[str, float] | None = None) -> dict:
    """Benchmark every strategy against every recorded space.

    Returns the machine-readable report (JSON-serializable, stable key
    order, no timestamps): per dataset, per strategy, the mean
    fraction-of-optimum curve, the final fraction, and whether it cleared
    its threshold; a top-level ``"pass"`` ands them all. Deterministic:
    the same inputs produce a byte-identical document.
    """
    strategies = list(strategies if strategies is not None
                      else sorted(STRATEGIES))
    gates = dict(DEFAULT_THRESHOLDS)
    gates.update(thresholds or {})
    out_datasets = []
    all_pass = True
    for ds in datasets:
        optimum = ds.best()
        outcomes = []
        for name in strategies:
            curves, finals, bests = [], [], []
            wasted = 0
            verdicts: dict[str, int] = {}
            # Exhaustive enumeration ignores the seed: one session is the
            # whole sample (replicating it would both waste simulation
            # time and dress a constant up as per-seed statistics).
            strategy_seeds = (list(seeds)[:1] if name == "exhaustive"
                              else seeds)
            for seed in strategy_seeds:
                sim = SimulatedRunner(ds)
                result = run_on_dataset(ds, name, budget=budget, seed=seed,
                                        runner=sim)
                curve = fraction_curve(ds, result, budget)
                curves.append(curve)
                finals.append(curve[-1] if curve else 0.0)
                bests.append(round(result.best_score_us, 6)
                             if result.best_config is not None else None)
                wasted += sim.wasted_evals
                for v, n in sim.verdicts.items():
                    verdicts[v] = verdicts.get(v, 0) + n
            mean_curve = [round(float(np.mean(col)), 6)
                          for col in zip(*curves)] if curves else []
            final = round(float(np.mean(finals)), 6) if finals else 0.0
            threshold = float(gates.get(name, 0.0))
            outcome = StrategyOutcome(
                strategy=name, threshold=threshold, mean_curve=mean_curve,
                final_fraction=final, per_seed_final=finals,
                per_seed_best_us=bests, passed=final >= threshold,
                wasted_evals=wasted, verdicts=verdicts)
            all_pass = all_pass and outcome.passed
            outcomes.append(outcome)
        out_datasets.append({
            "dataset": ds.name(),
            "kernel": ds.kernel,
            "scenario": ds.scenario_key(),
            "objective": ds.objective,
            "entries": len(ds),
            "feasible": len(ds.feasible()),
            "optimum_us": (round(optimum.score_us, 6)
                           if optimum is not None else None),
            "strategies": [o.to_json() for o in outcomes],
        })
    return {
        "version": REPORT_VERSION,
        "budget": int(budget),
        "seeds": [int(s) for s in seeds],
        "strategies": strategies,
        "pass": all_pass,
        "datasets": out_datasets,
    }


def report_to_text(report: dict) -> str:
    """Human-readable rendering of a :func:`compare` report: one block
    per dataset with each strategy's final fraction, threshold verdict,
    and curve marks at 25/50/100% of the budget (what the ``compare``
    and ``report`` CLI subcommands print)."""
    lines = [f"strategy benchmark report (budget={report['budget']} evals, "
             f"seeds={report['seeds']})"]
    for ds in report["datasets"]:
        lines.append(f"\n{ds['dataset']}  "
                     f"[{ds['feasible']}/{ds['entries']} feasible, "
                     f"optimum {ds['optimum_us']}us]")
        for s in ds["strategies"]:
            curve = s["mean_curve"]
            marks = [curve[max(0, min(len(curve) - 1,
                                      int(q * len(curve)) - 1))]
                     if curve else 0.0 for q in (0.25, 0.5, 1.0)]
            status = "ok  " if s["pass"] else "FAIL"
            wasted = s.get("wasted_evals", 0)
            lines.append(
                f"  {status} {s['strategy']:<10} "
                f"final={s['final_fraction']:.4f} "
                f"(threshold {s['threshold']:.2f})  "
                f"curve@25/50/100%: "
                + "/".join(f"{m:.3f}" for m in marks)
                + (f"  wasted={wasted}" if wasted else ""))
    lines.append(f"\noverall: {'PASS' if report['pass'] else 'FAIL'}")
    return "\n".join(lines)


def dump_report(report: dict) -> str:
    """Canonical byte form of a report (what ``--out`` writes): sorted
    keys, two-space indent, trailing newline. Byte-identical for equal
    reports, which ``chip_smoke.py`` phase 9 checks on the card's
    recordings."""
    return json.dumps(report, indent=2, sort_keys=True) + "\n"
