"""Process-wide metrics: counters, gauges, and fixed-bucket histograms.

A copy of ``repro.obs.metrics``: same series keys, same bucket bounds, same
snapshot bytes, so snapshots from both packages merge and compare.

Zero-dependency by design (stdlib only) so every layer — the launch hot
path included — can report into one :class:`MetricsRegistry` without
pulling anything new into the import graph. Three properties matter more
here than feature count:

* **Determinism.** A snapshot is a plain JSON object with sorted series
  keys, and histogram bucket boundaries are *fixed at declaration* (never
  derived from observed data), so two processes fed the same observations
  serialize byte-identical snapshots — the property the fleet health
  aggregation and the CI report gate rely on.
* **Mergeability.** Snapshots from many workers combine with
  :func:`merge_snapshots` (counters and histogram buckets sum, gauges
  keep the max) into one fleet-wide snapshot of the same shape.
* **Cheapness.** Instrument sites hold a handle (``registry.counter(...)``)
  and call ``inc``/``observe`` on it; the disabled path never reaches this
  module at all (see ``repro_torch.obs.runtime``).

Series identity is ``name{label=value,...}`` with labels sorted — the
Prometheus convention, chosen so snapshots grep well and reports can
parse series back into (name, labels) with :func:`parse_series`.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

#: Snapshot schema version (bump on incompatible format changes).
SNAPSHOT_VERSION = 1

#: Default histogram boundaries for microsecond latencies: a 1-2-5
#: geometric ladder from 1us to 1s. Fixed literals — never computed —
#: so bucket placement is identical in every process.
DEFAULT_BUCKETS_US = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1_000.0, 2_000.0, 5_000.0, 10_000.0, 20_000.0, 50_000.0,
    100_000.0, 200_000.0, 500_000.0, 1_000_000.0,
)

#: Boundaries for quantities in [0, 1] (ratios, confidences).
UNIT_BUCKETS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)

#: Boundaries for small cardinalities (cohort sizes, queue depths).
COUNT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)

_FORBIDDEN = set("{}=,\n")


def _check_part(kind: str, value: str) -> str:
    if not value or _FORBIDDEN & set(value):
        raise ValueError(f"{kind} {value!r} is empty or contains one of "
                         f"{''.join(sorted(_FORBIDDEN - {chr(10)}))!r}")
    return value


def series_key(name: str, labels: dict[str, str]) -> str:
    """Canonical series identity: ``name{k=v,...}`` with labels sorted.

    The one string form every snapshot keys series by; label values are
    arbitrary strings minus structural characters (``{}=,``).
    """
    _check_part("metric name", name)
    if not labels:
        return name
    parts = ",".join(f"{_check_part('label', k)}={_check_part('value', str(v))}"
                     for k, v in sorted(labels.items()))
    return f"{name}{{{parts}}}"


def parse_series(key: str) -> tuple[str, dict[str, str]]:
    """Inverse of :func:`series_key`: ``"a{k=v}"`` -> ``("a", {"k": "v"})``."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    if not rest.endswith("}"):
        raise ValueError(f"malformed series key {key!r}")
    body = rest[:-1]
    labels: dict[str, str] = {}
    for part in body.split(","):
        if part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


class Counter:
    """A monotonically increasing value (floats allowed: budget spend in
    seconds is a counter too)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """A point-in-time value (queue depth, shard progress, age)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Fixed-boundary histogram: ``bounds[i]`` is the inclusive upper edge
    of bucket ``i``; one implicit +Inf bucket catches the rest. Boundaries
    are part of the series identity — snapshots embed them, so any reader
    can re-bucket-check without access to the declaring code."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple[float, ...] = DEFAULT_BUCKETS_US):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(f"histogram bounds must be non-empty and "
                             f"ascending, got {bounds!r}")
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for i, b in enumerate(self.bounds):      # noqa: B007 — tiny tuples
            if v <= b:
                break
        else:
            i = len(self.bounds)
        self.counts[i] += 1
        self.sum += v
        self.count += 1

    def to_json(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "sum": round(self.sum, 6), "count": self.count}


class MetricsRegistry:
    """All of one process's metric series, snapshottable as plain JSON.

    ``counter``/``gauge``/``histogram`` get-or-create a series by (name,
    labels); instrument sites may call them per event (one dict build +
    lookup) or hold the returned handle. Creation is locked; increments
    on the handles are plain attribute updates (single-writer per series
    in this codebase — launches, ticks, and fleet steps all happen on the
    calling thread).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str, **labels: str) -> Counter:
        key = series_key(name, labels)
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter())
        return c

    def gauge(self, name: str, **labels: str) -> Gauge:
        key = series_key(name, labels)
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge())
        return g

    def histogram(self, name: str,
                  bounds: tuple[float, ...] = DEFAULT_BUCKETS_US,
                  **labels: str) -> Histogram:
        key = series_key(name, labels)
        h = self._histograms.get(key)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(key, Histogram(bounds))
        elif h.bounds != tuple(float(b) for b in bounds):
            raise ValueError(
                f"histogram {key} re-declared with different bounds")
        return h

    def snapshot(self) -> dict:
        """JSON-safe, deterministically ordered view of every series."""
        return {
            "version": SNAPSHOT_VERSION,
            "counters": {k: round(self._counters[k].value, 6)
                         for k in sorted(self._counters)},
            "gauges": {k: round(self._gauges[k].value, 6)
                       for k in sorted(self._gauges)},
            "histograms": {k: self._histograms[k].to_json()
                           for k in sorted(self._histograms)},
        }

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def __len__(self) -> int:
        return (len(self._counters) + len(self._gauges)
                + len(self._histograms))


def snapshot_bytes(snap: dict) -> bytes:
    """The canonical serialization — what :func:`save_snapshot` writes and
    the byte-determinism tests compare."""
    return (json.dumps(snap, indent=2, sort_keys=True) + "\n").encode()


def save_snapshot(snap: dict, path: Path | str) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(snapshot_bytes(snap))
    return path


def load_snapshot(path: Path | str) -> dict:
    with open(path) as f:
        snap = json.load(f)
    if not isinstance(snap, dict) or "counters" not in snap:
        raise ValueError(f"{path} is not a metrics snapshot")
    version = int(snap.get("version", 0))
    if version > SNAPSHOT_VERSION:
        raise ValueError(f"snapshot {path} has version {version}; this "
                         f"build understands at most {SNAPSHOT_VERSION}")
    return snap


def merge_snapshots(snaps: list[dict]) -> dict:
    """Combine worker snapshots into one fleet-wide snapshot.

    Counters and histogram buckets *sum* (they are rates of events that
    all really happened); gauges keep the *max* (point-in-time values from
    different hosts cannot meaningfully add — max surfaces the worst
    queue depth / oldest age, which is what a health view wants).
    Histograms with mismatched bounds for the same series refuse loudly.
    """
    out = {"version": SNAPSHOT_VERSION, "counters": {}, "gauges": {},
           "histograms": {}}
    for snap in snaps:
        for k, v in snap.get("counters", {}).items():
            out["counters"][k] = round(out["counters"].get(k, 0.0) + v, 6)
        for k, v in snap.get("gauges", {}).items():
            cur = out["gauges"].get(k)
            out["gauges"][k] = v if cur is None else max(cur, v)
        for k, h in snap.get("histograms", {}).items():
            cur = out["histograms"].get(k)
            if cur is None:
                out["histograms"][k] = {"bounds": list(h["bounds"]),
                                        "counts": list(h["counts"]),
                                        "sum": h["sum"],
                                        "count": h["count"]}
                continue
            if cur["bounds"] != list(h["bounds"]):
                raise ValueError(f"histogram {k}: bucket bounds differ "
                                 f"across snapshots")
            cur["counts"] = [a + b for a, b in zip(cur["counts"],
                                                   h["counts"])]
            cur["sum"] = round(cur["sum"] + h["sum"], 6)
            cur["count"] += h["count"]
    for section in ("counters", "gauges", "histograms"):
        out[section] = {k: out[section][k] for k in sorted(out[section])}
    return out
