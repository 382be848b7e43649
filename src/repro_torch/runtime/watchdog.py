"""Straggler / hang detection (port of ``repro.runtime.watchdog``, the
same pure-Python bookkeeping).

At thousand-node scale, slow hosts dominate step time. The watchdog keeps a
rolling window of step durations (optionally per worker), flags steps beyond
a deadline of ``p50 x tolerance`` as straggles, flags workers whose straggle
*rate* exceeds a threshold as suspect (candidates for backup-worker
replacement), and declares a hang when a step exceeds ``hang_factor x p50``
— the restart driver then recovers from the last checkpoint.

Pure bookkeeping (injected clocks in tests), so the policy is unit-testable
without real failures.
"""

from __future__ import annotations

import statistics
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field


@dataclass
class StragglerReport:
    step: int
    worker: int
    duration_s: float
    deadline_s: float
    kind: str            # "straggle" | "hang"


@dataclass
class StepWatchdog:
    window: int = 50
    tolerance: float = 1.5       # straggle if > p50 * tolerance
    hang_factor: float = 10.0    # hang if > p50 * hang_factor
    suspect_rate: float = 0.3    # worker suspect if >30% recent straggles
    min_samples: int = 5

    _durations: deque = field(default_factory=lambda: deque(maxlen=200))
    _per_worker: dict = field(
        default_factory=lambda: defaultdict(lambda: deque(maxlen=50)))
    reports: list = field(default_factory=list)

    def p50(self) -> float | None:
        if len(self._durations) < self.min_samples:
            return None
        return statistics.median(self._durations)

    def deadline(self) -> float | None:
        p = self.p50()
        return None if p is None else p * self.tolerance

    def record(self, step: int, duration_s: float,
               worker: int = 0) -> StragglerReport | None:
        """Record a completed step; returns a report if it straggled."""
        p = self.p50()
        self._durations.append(duration_s)
        report = None
        if p is not None:
            if duration_s > p * self.hang_factor:
                report = StragglerReport(step, worker, duration_s,
                                         p * self.hang_factor, "hang")
            elif duration_s > p * self.tolerance:
                report = StragglerReport(step, worker, duration_s,
                                         p * self.tolerance, "straggle")
        self._per_worker[worker].append(1 if report else 0)
        if report:
            self.reports.append(report)
        return report

    def suspects(self) -> list[int]:
        """Workers whose recent straggle rate exceeds the threshold."""
        out = []
        for w, hist in self._per_worker.items():
            if len(hist) >= self.min_samples \
                    and sum(hist) / len(hist) > self.suspect_rate:
                out.append(w)
        return sorted(out)

    def is_hang(self, elapsed_s: float) -> bool:
        """Live check for an in-flight step (call while waiting)."""
        p = self.p50()
        return p is not None and elapsed_s > p * self.hang_factor
