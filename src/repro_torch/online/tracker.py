"""Scenario tracker: turn live launch telemetry into tuning demand.

Port of ``repro.online.tracker``. Beyond-paper (consumes the §4.5
selection tiers; the paper has no runtime feedback loop). Every
``WisdomKernel`` launch reports its scenario (device kind,
problem size, dtype) and the §4.5 selection tier it resolved to. Tiers below
"exact" mean the wisdom file had no record tuned for this exact scenario —
the launch ran on a fuzzy-matched or default configuration. The tracker
accumulates those misses per scenario and flags a scenario *hot* once its
miss count crosses the activation threshold, which is the signal for the
trial scheduler to start spending budget on it.

Traffic-driven by construction: a scenario nobody launches never gets
tuned, and the busiest untuned scenario becomes hot first.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Canonical scenario-key and tier vocabulary. Defined once in
# core/scenario.py (shared with Wisdom.select and the observability
# report); re-exported here as in the reference.
from repro_torch.core.scenario import (HIT_TIERS, MISS_TIERS,  # noqa: F401
                                 SELECT_TIERS, ScenarioKey, format_key,
                                 parse_key)


@dataclass
class ScenarioStats:
    key: ScenarioKey
    launches: int = 0          # observed non-traced launches
    misses: int = 0            # launches that fell through to tiers 2-5
    trials: int = 0            # launches diverted to candidate configs
    last_tier: str = ""
    tiers: dict[str, int] = field(default_factory=dict)

    @property
    def device_kind(self) -> str:
        return self.key[0]

    @property
    def problem(self) -> tuple[int, ...]:
        return self.key[1]

    @property
    def dtype(self) -> str:
        return self.key[2]

    def to_json(self) -> dict:
        return {"key": format_key(self.key), "launches": self.launches,
                "misses": self.misses, "trials": self.trials,
                "last_tier": self.last_tier, "tiers": dict(self.tiers)}

    @staticmethod
    def from_json(d: dict) -> "ScenarioStats":
        return ScenarioStats(key=parse_key(d["key"]),
                             launches=int(d.get("launches", 0)),
                             misses=int(d.get("misses", 0)),
                             trials=int(d.get("trials", 0)),
                             last_tier=str(d.get("last_tier", "")),
                             tiers={str(k): int(v)
                                    for k, v in d.get("tiers", {}).items()})


class ScenarioTracker:
    """Per-scenario launch/miss accounting with an activation threshold."""

    def __init__(self, activation_threshold: int = 3):
        self.activation_threshold = activation_threshold
        self._stats: dict[ScenarioKey, ScenarioStats] = {}

    @staticmethod
    def key(device_kind: str, problem: tuple[int, ...],
            dtype: str) -> ScenarioKey:
        return (device_kind, tuple(int(x) for x in problem), str(dtype))

    def observe(self, device_kind: str, problem: tuple[int, ...], dtype: str,
                tier: str, weight: int = 1) -> ScenarioStats:
        """Record one selection. ``weight`` scales the demand: a trace-time
        selection stands for a whole compiled execution stream, not one
        launch, so traced observations pass ``weight=activation_threshold``
        to make the scenario hot immediately."""
        k = self.key(device_kind, problem, dtype)
        st = self._stats.get(k)
        if st is None:
            st = self._stats[k] = ScenarioStats(key=k)
        st.launches += 1
        st.last_tier = tier
        st.tiers[tier] = st.tiers.get(tier, 0) + 1
        if tier in MISS_TIERS:
            st.misses += weight
        return st

    def is_hot(self, device_kind: str, problem: tuple[int, ...],
               dtype: str) -> bool:
        st = self._stats.get(self.key(device_kind, problem, dtype))
        return st is not None and st.misses >= self.activation_threshold

    def stats(self, device_kind: str, problem: tuple[int, ...],
              dtype: str) -> ScenarioStats | None:
        return self._stats.get(self.key(device_kind, problem, dtype))

    def hot_scenarios(self) -> list[ScenarioStats]:
        """Hot scenarios, busiest first (tuning priority order)."""
        hot = [s for s in self._stats.values()
               if s.misses >= self.activation_threshold]
        return sorted(hot, key=lambda s: -s.misses)

    def all_scenarios(self) -> list[ScenarioStats]:
        return list(self._stats.values())

    def snapshot(self) -> list[dict]:
        """JSON-safe demand snapshot, canonically keyed and ordered — what
        a fleet worker publishes through a sync transport."""
        return [self._stats[k].to_json()
                for k in sorted(self._stats, key=format_key)]

    def __len__(self) -> int:
        return len(self._stats)
