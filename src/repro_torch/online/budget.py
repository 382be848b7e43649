"""Per-launch overhead budget for the online autotuning service.

A copy of ``repro.online.budget``. Beyond-paper (the paper's §4.3 tuning
runs out-of-band with a 15-minute budget; online work rides the serving
path, so the budget is per launch and three orders of magnitude smaller).
Online tuning must never turn a serving hot path into a tuning session: all
background work the service does on behalf of one launch (cost-model
screening, bracket bookkeeping, promotion checks) is bounded by a *hard*
wall-clock budget per launch plus a deterministic cap on the number of
cost-model screenings. The wall-clock bound is the safety net on slow hosts;
the screening cap is what makes convergence tests reproducible (a pure time
budget would admit a host-speed-dependent amount of work).

Env vars:

  KERNEL_LAUNCHER_ONLINE_BUDGET_MS   per-launch overhead budget in
                                     milliseconds (default 2.0)
  KERNEL_LAUNCHER_ONLINE_SCREENS     max cost-model screenings charged to
                                     one launch (default 8)
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

ONLINE_BUDGET_MS_ENV = "KERNEL_LAUNCHER_ONLINE_BUDGET_MS"
ONLINE_SCREENS_ENV = "KERNEL_LAUNCHER_ONLINE_SCREENS"

DEFAULT_BUDGET_MS = 2.0
DEFAULT_SCREENS_PER_LAUNCH = 8


@dataclass(frozen=True)
class OverheadBudget:
    """Static budget policy: how much overhead one launch may sponsor."""

    per_launch_s: float = DEFAULT_BUDGET_MS * 1e-3
    screens_per_launch: int = DEFAULT_SCREENS_PER_LAUNCH

    @staticmethod
    def from_env() -> "OverheadBudget":
        try:
            ms = float(os.environ.get(ONLINE_BUDGET_MS_ENV,
                                      DEFAULT_BUDGET_MS))
        except ValueError as e:
            raise ValueError(f"bad {ONLINE_BUDGET_MS_ENV}: {e}") from None
        try:
            screens = int(os.environ.get(ONLINE_SCREENS_ENV,
                                         DEFAULT_SCREENS_PER_LAUNCH))
        except ValueError as e:
            raise ValueError(f"bad {ONLINE_SCREENS_ENV}: {e}") from None
        return OverheadBudget(per_launch_s=ms * 1e-3,
                              screens_per_launch=screens)


class BudgetTimer:
    """One launch's slice of background work: a deadline + an op counter.

    ``take()`` consumes one screening slot; it returns False as soon as
    either the wall-clock deadline or the op cap is reached, after which the
    caller must stop doing work for this launch.
    """

    def __init__(self, budget: OverheadBudget):
        self._deadline = time.perf_counter() + budget.per_launch_s
        self._ops_left = budget.screens_per_launch
        self.ops_taken = 0

    def take(self) -> bool:
        if self._ops_left <= 0 or time.perf_counter() >= self._deadline:
            return False
        self._ops_left -= 1
        self.ops_taken += 1
        return True


@dataclass
class OverheadMeter:
    """Running totals of what the online service actually spent."""

    launches: int = 0
    trials: int = 0
    screens: int = 0
    overhead_s: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def begin(self) -> None:
        self._t0 = time.perf_counter()

    def end(self, screens: int = 0, trial: bool = False,
            launch: bool = False) -> None:
        self.overhead_s += time.perf_counter() - self._t0
        self.launches += int(launch)
        self.screens += screens
        self.trials += int(trial)

    @property
    def overhead_per_launch_s(self) -> float:
        return self.overhead_s / self.launches if self.launches else 0.0
