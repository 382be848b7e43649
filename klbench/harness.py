"""One run of one cell: set-up, the measured window, the per-layer readers,
the check against the plain reference, and the result line.

A cell's loop (``klbench/loops/<traffic["loop"]>.py``) owns what is
particular to it; this module owns the order every run keeps:

1. the loop's set-up (inputs and weights from the seed, the program's
   state, every shape warmed up), then ``setup_s``;
2. the window: the loop's step, back to back, for ``--seconds`` (under the
   profiler with ``--trace 1``, for at most :data:`TRACE_SECONDS`);
3. the peak device memory, then the program's state freed;
4. the loop's comparison with the reference.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

KLBENCH = Path(__file__).resolve().parent
#: The longest traced window: a profiler trace of a longer one takes more
#: time to write and read than the run may spend.
TRACE_SECONDS = 5.0


@dataclass
class Check:
    """One number compared with its limit; ``ok`` when within it."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        # a NaN reading is never within its limit
        return self.value == self.value and self.value <= self.limit


@dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float = field(default_factory=time.perf_counter)

    def mark(self, label: str) -> None:
        """Print the seconds since the process started at a set-up step."""
        print(f"klbench: set-up {label} at {time.perf_counter() - self.t0:.2f}"
              f" s", file=sys.stderr)


@dataclass
class Window:
    steps: int
    work: float
    elapsed_s: float
    view: object = None


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop_module(traffic: dict):
    return importlib.import_module(f"klbench.loops.{traffic['loop']}")


def metric_readers(bench: dict, cell: str) -> dict:
    """name -> (reader, unit) for every per-layer metric that lists this
    cell under its ``workloads``, which every per-layer metric has."""
    out = {}
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise KeyError(f"per-layer metric {m['name']!r} lists no "
                           f"workloads")
        if cell in m["workloads"]:
            mod = load_module(KLBENCH / "metrics" / f"{m['name']}.py",
                              f"klbench_metric_{m['name']}")
            out[m["name"]] = (mod.read, m["unit"])
    return out


def make_run(root: Path, cell: str, seed: int, seconds: float, trace: bool,
             device, t0: float) -> Run:
    bench = benchmark(root)
    w = cell_entry(bench, cell)
    cfg = load_json(root / config_entry(bench, w["config"])["file"])
    traffic = load_json(KLBENCH / "traffic" / f"{w['traffic']}.json")
    limits = load_json(KLBENCH / "workloads" / f"{cell}.json")["limits"]
    return Run(cell, cfg, traffic, limits, seed, seconds, trace,
               torch.device(device), t0)


def annotation(annotate: bool, name: str):
    """The benchmark's profiler range ``name`` around a call into the
    program in a traced window; nothing otherwise."""
    if not annotate:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(loop, run: Run) -> Window:
    """The loop's steps back to back until ``run.seconds`` have passed
    (``TRACE_SECONDS`` at most under the profiler), then a synchronize: the
    window ends when its last step's work is done."""
    from klbench.trace import Profiled
    seconds = min(run.seconds, TRACE_SECONDS) if run.trace else run.seconds
    prof = Profiled() if run.trace else contextlib.nullcontext()
    steps, work = 0, 0.0
    with prof:
        sync(run.device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            work += loop.step(steps, run.trace)
            steps += 1
        sync(run.device)
        elapsed = time.perf_counter() - t0
    return Window(steps, work, elapsed, getattr(prof, "view", None))


def release(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def print_tiers() -> None:
    """The selection tier of every launch of the program's kernels, from
    their ``tier_counts`` (standard error, before the checks)."""
    ops = sys.modules.get("repro_torch.kernels.ops")
    for k in getattr(ops, "_ALL_KERNELS", ()):
        if k.tier_counts:
            print(f"klbench: tiers {k.builder.name} {k.tier_counts}",
                  file=sys.stderr)


def measure(run: Run, readers: dict, guard=None):
    """Set-up, the window and the release of the program's state; returns
    the loop, which still holds what its check compares, and the result
    without the check's numbers (see ``run.py``)."""
    loop = loop_module(run.traffic).Loop(run)
    run.mark("torch imported")
    loop.setup()
    sync(run.device)
    run.mark("done")
    if guard is not None:
        guard()
    setup_s = time.perf_counter() - run.t0
    win = run_window(loop, run)
    cuda = run.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    result: dict = {"correct": False, "attempted": 0, "failed": 0,
                    "metrics": {}}
    if run.trace:
        view = win.view
        ctx = loop.context(win)
        for name, (read, unit) in readers.items():
            value = read(view, ctx)
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": unit}
        device = {"busy_s": view.busy_s, "window_s": view.window_s}
        result["breakdown"] = view.breakdown()
    else:
        result["metrics"] = {name: {"value": v, "unit": u} for name, (v, u)
                             in loop.metrics(win).items()}
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
        device = {}
    result["attempted"], result["failed"] = loop.finish(win)
    print_tiers()
    loop.release()
    release(run.device)
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak), **device}
    return loop, result


def execute(run: Run, readers: dict, guard=None) -> dict:
    """One run of ``run``'s cell: :func:`measure`, then the loop's
    comparison with the reference; returns the result (see ``run.py``)."""
    loop, result = measure(run, readers, guard)
    t_ref = time.perf_counter()
    checks = loop.check()
    print(f"klbench: the reference took {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    failed = result["failed"]
    result["failed"] = failed + sum(not c.ok for c in checks)
    result["correct"] = failed == 0 and all(c.ok for c in checks)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result
