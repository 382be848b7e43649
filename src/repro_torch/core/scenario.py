"""Scenario keys and the canonical §4.5 selection-tier vocabulary.

A *scenario* is the (device kind, problem size, dtype) triple the paper's
selection heuristic matches wisdom records against. This module is the
single source of truth for

* the canonical string form of a scenario key (``format_key`` /
  ``parse_key``) — the representation that survives JSON transport and
  keys every metric, demand record, and dataset file; and
* the selection-tier names ``Wisdom.select`` can return, partitioned into
  *hits* and *misses* (previously duplicated between ``core/wisdom.py``
  string literals and ``online/tracker.py`` constants).

A copy of ``repro.core.scenario``. Everything here is import-leaf: no
other module is imported, so the
observability layer, the online tracker, and the wisdom heuristic can all
share one vocabulary without cycles.
"""

from __future__ import annotations

ScenarioKey = tuple[str, tuple[int, ...], str]   # (device_kind, problem, dtype)

#: Separator for the canonical string form of a ScenarioKey. Device kinds
#: and dtypes never contain it (enforced by ``format_key``).
_KEY_SEP = "|"

#: The §4.5 selection tiers, best first — exactly the order
#: ``Wisdom.select`` tries them. "exact" is a measured record for the
#: scenario; "transfer" a confidence-gated cross-device prediction;
#: the fuzzy tiers relax device/size/dtype matching step by step;
#: "default" is the empty-wisdom fallback.
SELECT_TIERS = ("exact", "transfer", "device+dtype", "device",
                "family+dtype", "family", "any+dtype", "any", "default")

#: Tiers a launch can report beyond selection: the caller forced a config,
#: or the online tuner diverted the launch to a candidate.
LAUNCH_TIERS = SELECT_TIERS + ("forced", "trial")

#: Selection tiers that count as wisdom misses (paper §4.5 tiers 2-5: any
#: fuzzy device/size/dtype match, and the empty-wisdom default). The
#: "transfer" tier counts too: a transferred record serves traffic well,
#: but it is a *prediction* — demand must keep flowing so the fleet
#: verification loop eventually replaces it with a measurement.
MISS_TIERS = frozenset(t for t in SELECT_TIERS if t != "exact")

#: Tiers that are *not* tuning demand: an exact record already exists, the
#: caller forced a config, or the launch was an online trial itself.
HIT_TIERS = frozenset({"exact", "forced", "trial"})


def format_key(key: ScenarioKey) -> str:
    """Canonical, round-trippable string form of a scenario key.

    ``("tpu-v5e", (256, 256), "float32")`` -> ``"tpu-v5e|256x256|float32"``.
    The tuple form does not survive JSON (tuples come back as lists, and
    dict keys cannot be tuples at all), so everything that moves demand
    records across a transport keys them by this string instead.
    """
    device_kind, problem, dtype = key
    device_kind, dtype = str(device_kind), str(dtype)
    for part in (device_kind, dtype):
        if _KEY_SEP in part:
            raise ValueError(f"scenario component {part!r} contains "
                             f"{_KEY_SEP!r}")
    dims = "x".join(str(int(d)) for d in problem)
    return _KEY_SEP.join((device_kind, dims, dtype))


def parse_key(s: str) -> ScenarioKey:
    """Inverse of :func:`format_key` (hashable tuples, ints restored)."""
    parts = s.split(_KEY_SEP)
    if len(parts) != 3:
        raise ValueError(f"malformed scenario key {s!r}")
    device_kind, dims, dtype = parts
    problem = tuple(int(d) for d in dims.split("x")) if dims else ()
    return (device_kind, problem, dtype)
