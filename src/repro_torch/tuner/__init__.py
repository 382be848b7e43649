"""Offline tuner (paper §4.3), port of ``repro.tuner``: strategies, the
wall-clock evaluator on the card, the analytical cost model and its
evaluator, the surrogate fitted from a recorded space, capture replay and
the CLI."""

from .costmodel import (INFEASIBLE, CostModel, FittedCostModel,
                        fit_from_dataset, kernel_time)
from .runner import (CostModelEvaluator, EvalResult, VerifyOutcome,
                     WallClockEvaluator, verify_config, verify_outcome)
from .strategies import (STRATEGIES, Evaluation, TuningResult,
                         evaluation_from_json, evaluation_to_json,
                         tune_anneal, tune_bayes, tune_exhaustive,
                         tune_random)
from .tune import plan_captures, tune_capture, tune_kernel

__all__ = [
    "INFEASIBLE", "CostModel", "FittedCostModel", "fit_from_dataset",
    "kernel_time",
    "CostModelEvaluator", "EvalResult", "VerifyOutcome", "WallClockEvaluator",
    "verify_config", "verify_outcome",
    "STRATEGIES", "Evaluation", "TuningResult", "evaluation_from_json",
    "evaluation_to_json", "tune_anneal", "tune_bayes", "tune_exhaustive",
    "tune_random",
    "plan_captures", "tune_capture", "tune_kernel",
]
