"""Offline tuner (paper §4.3), port of ``repro.tuner``: strategies, the
wall-clock evaluator on the card, capture replay and the CLI."""

from .runner import (EvalResult, VerifyOutcome, WallClockEvaluator,
                     verify_outcome)
from .strategies import (STRATEGIES, Evaluation, TuningResult, tune_anneal,
                         tune_bayes, tune_exhaustive, tune_random)
from .tune import plan_captures, tune_capture, tune_kernel

__all__ = [
    "EvalResult", "VerifyOutcome", "WallClockEvaluator", "verify_outcome",
    "STRATEGIES", "Evaluation", "TuningResult", "tune_anneal", "tune_bayes",
    "tune_exhaustive", "tune_random",
    "plan_captures", "tune_capture", "tune_kernel",
]
