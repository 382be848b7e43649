"""The profiler window of a ``--trace 1`` run and the reduction of its trace.

The window runs under ``torch.profiler`` (host and device activity) inside
one ``klbench.window`` range; the benchmark's own ranges (``klbench.*``)
mark each call into the program. The exported Chrome trace is read back
into a :class:`TraceView`, which the per-layer metric readers
(``klbench/metrics/``) query. A kernel belongs to a range when the host
call that launched it (its runtime or driver launch event, joined by
correlation id) lies inside the range on the range's thread: matched by
correlation, never by the kernel's name.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "klbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class Event:
    name: str
    ts: float        # microseconds
    dur: float
    tid: object = None
    corr: int | None = None

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclass
class TraceView:
    device: list = field(default_factory=list)      # device operations
    kernels_by_corr: dict = field(default_factory=dict)
    launches: list = field(default_factory=list)    # sorted by ts
    ranges: dict = field(default_factory=lambda: defaultdict(list))
    host: list = field(default_factory=list)        # sorted by ts
    window: Event | None = None

    @classmethod
    def from_events(cls, events: list[dict]) -> "TraceView":
        v = cls()
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ev = Event(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0)),
                       e.get("tid"), (e.get("args") or {}).get("correlation"))
            if cat in DEVICE_CATS:
                v.device.append(ev)
                if cat == "kernel" and ev.corr is not None:
                    v.kernels_by_corr.setdefault(ev.corr, []).append(ev)
                continue
            if cat in LAUNCH_CATS and ev.corr is not None:
                v.launches.append(ev)
            if cat == "user_annotation":
                if ev.name == WINDOW:
                    v.window = ev
                    continue
                v.ranges[ev.name].append(ev)
            if cat in HOST_CATS:
                v.host.append(ev)
        v.launches.sort(key=lambda e: e.ts)
        v.host.sort(key=lambda e: e.ts)
        v.device.sort(key=lambda e: e.ts)
        return v.index()

    # -- the window --------------------------------------------------------

    @property
    def window_s(self) -> float:
        return self.window.dur / 1e6 if self.window else 0.0

    def _in_window(self):
        w0, w1 = self.window.ts, self.window.end
        for e in self.device:
            a, b = max(e.ts, w0), min(e.end, w1)
            if b > a:
                yield a, b, e

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals in the window."""
        merged: list[list[float]] = []
        for a, b, _ in self._in_window():
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> list[tuple[float, float]]:
        if self.window is None:
            return []
        gaps, t = [], self.window.ts
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.window.end > t:
            gaps.append((t, self.window.end))
        return gaps

    # -- ranges and their kernels ------------------------------------------

    def kernels_in(self, r: Event) -> list[Event]:
        """Kernels launched from inside range ``r``, on its thread."""
        i = bisect.bisect_left(self._launch_ts, r.ts)
        out = []
        for e in self.launches[i:]:
            if e.ts > r.end:
                break
            if e.tid == r.tid:
                out.extend(self.kernels_by_corr.get(e.corr, ()))
        return out

    def index(self) -> "TraceView":
        """Build the lookup tables; call once the events are all in."""
        self._launch_ts = [e.ts for e in self.launches]
        self._host_ts = [e.ts for e in self.host]
        return self

    def host_at(self, t: float) -> str:
        """The innermost host operation in progress at time ``t``."""
        i = bisect.bisect_right(self._host_ts, t)
        for e in reversed(self.host[max(0, i - 2000):i]):
            if e.end >= t:
                return e.name
        return "python (no operation)"

    # -- the breakdown -----------------------------------------------------

    def breakdown(self, top: int = 10) -> dict:
        by_op: dict[str, float] = defaultdict(float)
        for a, b, e in self._in_window():
            by_op[e.name[:160]] += (b - a) / 1e6
        by_host: dict[str, float] = defaultdict(float)
        for a, b in self.idle_gaps():
            by_host[self.host_at((a + b) / 2)] += (b - a) / 1e6
        rank = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}


def load(path: str) -> TraceView:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return TraceView.from_events(events)


class Profiled:
    """``with Profiled() as p: ...`` runs the block under the profiler
    inside the ``klbench.window`` range; ``p.view`` is its trace."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._range = record_function(WINDOW)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json", prefix="klbench-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self.view = load(path)
        finally:
            os.unlink(path)
        return False
