"""Span tracing exporting Chrome ``trace_event`` JSON (Perfetto-viewable).

A copy of ``repro.obs.trace``: the same events under the same clock give
the same trace bytes in both packages.

A :class:`Tracer` records *complete* events (``"ph": "X"`` — begin time +
duration, the compact form), *instant* events (``"ph": "i"``), and
*counter* events (``"ph": "C"`` — named numeric series Perfetto renders
as stacked track charts; the profiler exports roofline counters this
way), tagged with the subsystem as the category. ``to_chrome()`` emits
the standard ``{"traceEvents": [...]}`` wrapper that chrome://tracing and
https://ui.perfetto.dev open directly, so a serving incident can be read
as a timeline: selection, compile, launch, sync ticks, fleet steps.

Time is injected (``clock``) the same way the fleet's lease layer injects
it: production uses ``time.perf_counter``, tests drive a manual clock so
exported traces are byte-deterministic. Thread ids are mapped to small
dense ints in first-seen order for the same reason.

The disabled path never reaches this module — ``repro_torch.obs.runtime`` hands
instrument sites ``None`` instead of a tracer.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable

#: Keys every Chrome trace event must carry (the schema the validity
#: tests and ``validate_trace`` enforce).
REQUIRED_EVENT_KEYS = ("name", "cat", "ph", "ts", "pid", "tid")


class Tracer:
    """Collects span/instant events for one process.

    Example::

        tracer = Tracer()
        with tracer.span("launch", cat="kernel", kernel="matmul"):
            ...
        tracer.save("trace.json")     # open in Perfetto
    """

    def __init__(self, clock: Callable[[], float] | None = None,
                 pid: int = 1):
        self._clock = clock or time.perf_counter
        self._epoch = self._clock()
        self.pid = int(pid)
        self.events: list[dict] = []
        self._tids: dict[int, int] = {}

    def now_us(self) -> float:
        """The tracer's clock: microseconds since it was made."""
        return round((self._clock() - self._epoch) * 1e6, 3)

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids)
        return tid

    @contextmanager
    def span(self, name: str, cat: str = "repro", **args):
        """Record one complete event around the enclosed work. ``args``
        become the event's ``args`` dict (JSON-safe values only)."""
        t0 = self.now_us()
        try:
            yield self
        finally:
            self.complete(name, cat, t0, **args)

    def complete(self, name: str, cat: str, t0: float, **args) -> None:
        """Record one complete event that began at ``t0`` (a reading of
        :meth:`now_us`) and ends now, on the calling thread."""
        t1 = self.now_us()
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": t0, "dur": round(t1 - t0, 3),
            "pid": self.pid, "tid": self._tid(),
            "args": {k: v for k, v in sorted(args.items())},
        })

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        """Record a zero-duration marker (promotions, sync failures)."""
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self.now_us(), "pid": self.pid, "tid": self._tid(),
            "args": {k: v for k, v in sorted(args.items())},
        })

    def counter(self, name: str, cat: str = "repro", **values) -> None:
        """Record a counter sample (``"ph": "C"``): one or more named
        numeric series at the current time. Perfetto plots each counter
        name as a track; the kernel profiler exports achieved-fraction /
        arithmetic-intensity samples this way. Non-numeric values raise
        — counter tracks are charts, not metadata."""
        args = {}
        for k, v in sorted(values.items()):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"counter series {k!r} has non-numeric "
                                 f"value {v!r}")
            args[k] = v
        if not args:
            raise ValueError("counter event needs at least one series")
        self.events.append({
            "name": name, "cat": cat, "ph": "C",
            "ts": self.now_us(), "pid": self.pid, "tid": self._tid(),
            "args": args,
        })

    def to_chrome(self) -> dict:
        """The standard Chrome ``trace_event`` JSON object."""
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def save(self, path: Path | str) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_chrome(), indent=2,
                                   sort_keys=True) + "\n")
        return path

    def clear(self) -> None:
        self.events.clear()

    def __len__(self) -> int:
        return len(self.events)


def load_trace(path: Path | str) -> dict:
    """Read a saved Chrome trace, refusing files that are not one."""
    with open(path) as f:
        doc = json.load(f)
    errors = validate_trace(doc)
    if errors:
        raise ValueError(f"{path} is not a valid Chrome trace: "
                         f"{errors[0]} ({len(errors)} problem(s))")
    return doc


def validate_trace(doc) -> list[str]:
    """Schema check for Chrome ``trace_event`` JSON: the wrapper shape,
    required per-event keys, numeric timestamps, non-negative span
    durations, and numeric counter ("C") series. Returns a list of
    problems (empty = valid)."""
    errors: list[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["top level must be an object with a traceEvents list"]
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        for k in REQUIRED_EVENT_KEYS:
            if k not in ev:
                errors.append(f"event {i}: missing key {k!r}")
        for k in ("ts", "dur"):
            if k in ev and not isinstance(ev[k], (int, float)):
                errors.append(f"event {i}: {k} is not numeric")
        if ev.get("ph") == "X":
            if "dur" not in ev:
                errors.append(f"event {i}: complete event without dur")
            elif isinstance(ev["dur"], (int, float)) and ev["dur"] < 0:
                errors.append(f"event {i}: negative duration")
        if ev.get("ph") == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                errors.append(f"event {i}: counter event without series "
                              f"(args must be a non-empty object)")
            else:
                for k, v in args.items():
                    if isinstance(v, bool) or not isinstance(
                            v, (int, float)):
                        errors.append(f"event {i}: counter series {k!r} "
                                      f"is not numeric")
    return errors
