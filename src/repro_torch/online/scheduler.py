"""Trial scheduler: budgeted candidate search for one hot scenario.

A copy of ``repro.online.scheduler``. Beyond-paper (the online analogue
of the §4.3 search strategies). Two channels, matching the
``CostModelEvaluator`` / ``WallClockEvaluator`` split in the offline tuner:

* **Screening** (background, charged to the per-launch overhead budget):
  candidate configurations stream out of the ``ConfigSpace`` — a shuffled
  exhaustive enumeration when the space is small, seeded rejection sampling
  otherwise — and are scored with the analytical cost model through a
  ``tuner.strategies._Session`` (same dedup / best-so-far / exhaustion
  bookkeeping the offline strategies use). A few screenings run per launch,
  never more than the budget allows.

* **Live trials** (epsilon-greedy, a small fraction of real launches): the
  top screened candidates enter a successive-halving bracket. Each trial
  launch executes one bracket member's config instead of the incumbent and
  reports a measurement back; when every surviving member has its rung's
  quota of measurements, the worse half is eliminated and the quota doubles.
  The last survivor is the promotion candidate.

With the deterministic cost-model objective one measurement per member is
enough and the bracket degenerates to top-1 selection; with wall-clock
measurements the halving structure is what gives noisy candidates a fair,
budget-bounded comparison (successive halving per Schoonhoven et al.'s
budget-constrained search comparison; dynamic-tuning shape per Petrovič et
al.'s KTT).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from repro_torch.core.param import Config, ConfigSpace
from repro_torch.tuner.strategies import Evaluate, _Session

from .budget import BudgetTimer

#: Enumerate-and-shuffle (full coverage) below this many raw configs;
#: sample above it.
ENUMERATE_LIMIT = 1024


@dataclass
class _Member:
    config: Config
    key: tuple
    screen_score_us: float
    measurements: list[float] = field(default_factory=list)

    def mean(self) -> float:
        if not self.measurements:
            return self.screen_score_us
        return float(np.mean(self.measurements))


class _Bracket:
    """Successive halving over an ordered candidate list."""

    def __init__(self, members: list[_Member], eta: int = 2, r0: int = 1):
        self.members = members
        self.eta = max(eta, 2)
        self.rung = 0
        self.r0 = max(r0, 1)

    @property
    def quota(self) -> int:
        """Total measurements each survivor needs at the current rung."""
        return self.r0 * self.eta ** self.rung

    @property
    def done(self) -> bool:
        return (len(self.members) == 1
                and len(self.members[0].measurements) >= self.quota)

    def next_trial(self) -> _Member | None:
        if self.done:
            return None
        for m in self.members:
            if len(m.measurements) < self.quota:
                return m
        return None

    def report(self, key: tuple, score_us: float) -> None:
        for m in self.members:
            if m.key == key and len(m.measurements) < self.quota:
                m.measurements.append(score_us)
                break
        self._maybe_advance()

    def _maybe_advance(self) -> None:
        if len(self.members) <= 1:
            return
        if any(len(m.measurements) < self.quota for m in self.members):
            return
        keep = max(1, math.ceil(len(self.members) / self.eta))
        self.members.sort(key=lambda m: (m.mean(), m.screen_score_us))
        self.members = self.members[:keep]
        self.rung += 1

    def winner(self) -> _Member | None:
        return self.members[0] if self.done else None


class TrialScheduler:
    """Candidate search for one scenario, driven in budgeted increments."""

    def __init__(self, space: ConfigSpace, evaluate: Evaluate,
                 rng: np.random.Generator, pool_size: int = 128,
                 bracket_size: int = 8, eta: int = 2, r0: int = 1):
        self.space = space
        self.rng = rng
        self.pool_size = pool_size
        self.bracket_size = bracket_size
        self.eta = eta
        self.r0 = r0
        self.session = _Session(space, evaluate, max_evals=pool_size,
                                time_budget_s=None)
        self._stream = self._candidate_stream()
        self._stream_done = False
        self._bracket: _Bracket | None = None

    # -- screening channel ---------------------------------------------------

    def _candidate_stream(self) -> Iterator[Config]:
        yield self.space.default_config()
        if self.space.cardinality() <= ENUMERATE_LIMIT:
            cfgs = list(self.space.enumerate())
            self.rng.shuffle(cfgs)
            yield from cfgs
        else:
            while True:
                yield self.space.sample(self.rng, 1)[0]

    def screen(self, timer: BudgetTimer) -> int:
        """Run cost-model screenings until the timer or the pool runs out.
        Returns the number of evaluations performed."""
        done = 0
        while not self.screening_done() and timer.take():
            cfg = next(self._stream, None)
            if cfg is None:
                self._stream_done = True
                break
            self.session.run(cfg)
            done += 1
        if self.screening_done() and self._bracket is None:
            self._build_bracket()
        return done

    def screening_done(self) -> bool:
        return self._stream_done or self.session.exhausted()

    def _build_bracket(self) -> None:
        feasible = sorted(self.session.feasible(),
                          key=lambda e: e.score_us)[:self.bracket_size]
        members = [_Member(config=dict(e.config),
                           key=self.space.freeze(e.config),
                           screen_score_us=e.score_us)
                   for e in feasible]
        self._bracket = _Bracket(members, eta=self.eta, r0=self.r0)

    # -- live-trial channel --------------------------------------------------

    def next_trial(self) -> Config | None:
        """Config the next trial launch should run, or None if no live
        measurement is currently needed."""
        if self._bracket is None:
            return None
        m = self._bracket.next_trial()
        return dict(m.config) if m is not None else None

    def report_trial(self, config: Config, score_us: float) -> None:
        if self._bracket is not None:
            self._bracket.report(self.space.freeze(config), score_us)

    def winner(self) -> tuple[Config, float, int] | None:
        """(config, mean score, n live measurements) of the last survivor."""
        if self._bracket is None:
            return None
        m = self._bracket.winner()
        if m is None:
            return None
        return dict(m.config), m.mean(), len(m.measurements)

    @property
    def bracket_dead(self) -> bool:
        """Screening finished but produced no feasible candidates — there
        is nothing to trial and never will be."""
        return self._bracket is not None and not self._bracket.members

    # -- introspection -------------------------------------------------------

    @property
    def screens(self) -> int:
        return len(self.session.evals)

    def best_screened(self) -> tuple[Config, float] | None:
        if self.session.best is None:
            return None
        return dict(self.session.best.config), self.session.best.score_us
