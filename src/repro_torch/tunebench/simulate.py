"""Simulated tuning: replay a recorded space instead of measuring.

A :class:`SimulatedRunner` is a drop-in ``Evaluate`` callable (the same
shape the tuner's evaluators have) whose answers come from a
:class:`~repro_torch.tunebench.dataset.SpaceDataset` lookup instead of the
cost model or the card. Every strategy in
:mod:`repro_torch.tuner.strategies` runs against it unchanged,
deterministically and in microseconds per evaluation — which is what makes
strategy comparison (:mod:`repro_torch.tunebench.harness`) and tuner
regression tests possible on machines with no accelerator at all. Port of
``repro.tunebench.simulate``.
"""

from __future__ import annotations

from repro_torch.core.param import Config
from repro_torch.tuner.costmodel import INFEASIBLE
from repro_torch.tuner.runner import EvalResult

from .dataset import SpaceDataset


class DatasetMiss(KeyError):
    """A strategy proposed a config the dataset has no record for and the
    runner was constructed with ``on_miss="error"``."""


class SimulatedRunner:
    """Replay recorded evaluations; never touches hardware.

    ``on_miss`` decides what an unrecorded config means:

    * ``"infeasible"`` (default) — treat it as infeasible. Exhaustively
      recorded datasets only miss on restricted configs, so this matches
      what live tuning would have seen.
    * ``"error"`` — raise :class:`DatasetMiss`. Use when the dataset is
      expected to be complete and a miss means the space drifted out from
      under the recording.

    Example::

        ds = SpaceDataset.load("matmul.space.json")
        sim = SimulatedRunner(ds)
        res = tune_bayes(ds.space(), sim, max_evals=64,
                         rng=np.random.default_rng(0), time_budget_s=None)
    """

    def __init__(self, dataset: SpaceDataset, on_miss: str = "infeasible"):
        if on_miss not in ("infeasible", "error"):
            raise ValueError(f"unknown on_miss policy {on_miss!r}")
        self.dataset = dataset
        self.on_miss = on_miss
        self.calls = 0
        self.hits = 0
        self.misses = 0
        #: Replayed sandbox verdicts, counted by status (entries recorded
        #: with a ``verdict`` — crashed/hung/oom/wrong configs).
        self.verdicts: dict[str, int] = {}
        #: Evaluations spent re-proposing a config whose recorded verdict
        #: already said it fails fatally. Live, each of these would cost a
        #: full sandbox timeout or a child-process death — a strategy
        #: that keeps walking into them wastes real tuning budget.
        self.wasted_evals = 0
        self._seen_fatal: set[str] = set()

    def __call__(self, config: Config) -> EvalResult:
        self.calls += 1
        entry = self.dataset.lookup(config)
        if entry is None:
            self.misses += 1
            if self.on_miss == "error":
                raise DatasetMiss(
                    f"config {config} not in dataset "
                    f"{self.dataset.name()} ({len(self.dataset)} entries)")
            return EvalResult(INFEASIBLE, False, error="not in dataset")
        self.hits += 1
        if not entry.feasible:
            if entry.verdict:
                # Replay the sandbox verdict the way a live
                # SandboxedEvaluator would report it, and charge repeat
                # proposals of a known-fatal config as wasted budget.
                self.verdicts[entry.verdict] = (
                    self.verdicts.get(entry.verdict, 0) + 1)
                key = self.dataset.key_for(config)
                if key in self._seen_fatal:
                    self.wasted_evals += 1
                self._seen_fatal.add(key)
                error = entry.error or f"sandbox:{entry.verdict}"
                if not error.startswith("sandbox:"):
                    error = f"sandbox:{entry.verdict}: {error}"
                return EvalResult(INFEASIBLE, False, error=error,
                                  info={"sandbox": entry.verdict})
            return EvalResult(INFEASIBLE, False, error=entry.error)
        return EvalResult(entry.score_us, True)
