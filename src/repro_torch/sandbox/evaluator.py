"""Subprocess-isolated evaluation: run a candidate, survive anything.

Port of ``repro.sandbox.evaluator``. ``sandboxed_call`` runs a callable in a
*spawned* child process with a wall-clock timeout and a memory ceiling, and
maps whatever happens — a clean return, an exception, a hang, an allocation
bomb, a segfault, a lost CUDA context — onto a
:class:`~repro_torch.sandbox.verdict.SandboxVerdict` instead of propagating
the failure into the caller. ``SandboxedEvaluator`` wraps any tuner
evaluator with that protection, so a tuning session can walk a space full
of crashing configs and record them as infeasible.

Where the reference forks, the port spawns: a CUDA context does not survive
``fork``, so a forked child of a process that has used the card cannot use
it. A spawned child starts a fresh interpreter, so the payload crosses as a
picklable callable — a top-level function, a ``functools.partial`` of one,
or an object of plain fields such as :class:`KernelTrial` (kernel name,
problem, dtype, seed), never a closure — and the child imports what it
needs (torch takes seconds). A kernel the child builds comes from
``kernels/_build.py``'s on-disk cache when the parent built it before.

The memory ceiling depends on what the child touches. CUDA reserves large
virtual ranges, so an address-space cap (``RLIMIT_AS``) would break it:
``memory_bytes`` caps the address space of a child that never touches
CUDA, at its own size when the payload starts plus that headroom, and
``device_memory_fraction`` caps a CUDA child's share of the card's memory
(``torch.cuda.set_per_process_memory_fraction``), where an allocation bomb
ends in a CUDA out-of-memory error that maps to ``oom``. The ``inline``
method skips process isolation (exceptions are still mapped to verdicts):
the right choice where the evaluator cannot hang or crash the process,
like the cost model.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.obs import runtime as obs
from repro_torch.tuner.costmodel import INFEASIBLE
from repro_torch.tuner.runner import EvalResult

from .verdict import (STATUS_CRASH, STATUS_OK, STATUS_OOM, STATUS_TIMEOUT,
                      SandboxVerdict)

#: Histogram bounds (seconds) for sandbox wall-clock metrics.
SECONDS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0,
                   120.0, 300.0)

#: Captured child stderr is truncated to this many characters.
STDERR_LIMIT = 4096

DEFAULT_TIMEOUT_S = 30.0
#: Seconds a spawned child may take to start (interpreter, imports, memory
#: caps, a CUDA context) before its payload's ceiling starts counting.
START_TIMEOUT_S = 300.0

METHODS = ("spawn", "inline")


@dataclass(frozen=True)
class SandboxSettings:
    """Isolation knobs for one sandbox.

    ``timeout_s`` is the payload's wall-clock ceiling, counted from the
    moment a spawned child reports that it has started (its interpreter,
    imports, memory caps and any CUDA context up: seconds, and no part of
    what the candidate costs; ``START_TIMEOUT_S`` bounds that); the child
    is killed past it. ``memory_bytes`` is the address-space headroom
    (``RLIMIT_AS``) of a child that never touches CUDA;
    ``device_memory_fraction`` the share of the card's memory a CUDA child
    may allocate. At most one of the two applies. ``method`` is
    ``"spawn"`` (a real child process: survives hangs, segfaults,
    allocation bombs and lost CUDA contexts) or ``"inline"`` (same
    process; exceptions still become verdicts, but hangs and hard crashes
    are not contained).

    Example::

        settings = SandboxSettings(timeout_s=60.0,
                                   device_memory_fraction=0.05)
    """

    timeout_s: float = DEFAULT_TIMEOUT_S
    memory_bytes: int | None = None
    method: str = "spawn"
    device_memory_fraction: float | None = None

    def __post_init__(self) -> None:
        if self.method not in METHODS:
            raise ValueError(f"unknown sandbox method {self.method!r}; "
                             f"use one of {METHODS}")
        if self.memory_bytes is not None and \
                self.device_memory_fraction is not None:
            raise ValueError("memory_bytes caps a child that never touches "
                             "CUDA; a CUDA child takes device_memory_fraction"
                             " alone")


def memory_ceiling(extra_bytes: int = 512 * 2**20) -> int:
    """This process's address-space size plus ``extra_bytes``.

    ``RLIMIT_AS`` caps *virtual* address space, and a child that has
    imported torch already holds a good deal of it, so an absolute cap
    would make every allocation fail. The spawned child calls this on
    itself when its payload starts: "allocate about ``extra_bytes`` more
    than now" is the ceiling an allocation-bomb check wants.

    Example::

        resource.setrlimit(resource.RLIMIT_AS,
                           (memory_ceiling(256 * 2**20),) * 2)
    """
    current = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmSize:"):
                    current = int(line.split()[1]) * 1024
                    break
    except (OSError, ValueError, IndexError):  # pragma: no cover
        pass
    return current + int(extra_bytes)


def _device_oom(e: BaseException) -> bool:
    """Whether ``e`` is torch's CUDA out-of-memory error."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(e, torch.cuda.OutOfMemoryError)


def _child_main(fn: Callable[[], Any], conn, stderr_path: str,
                memory_bytes: int | None,
                device_memory_fraction: float | None) -> None:
    fd = os.open(stderr_path, os.O_WRONLY | os.O_APPEND)
    os.dup2(fd, 2)
    os.close(fd)
    try:
        # A segfaulting child dumps its traceback into the captured log.
        import faulthandler
        faulthandler.enable(2)
    except Exception:  # pragma: no cover — faulthandler is optional
        pass
    try:
        if device_memory_fraction is not None:
            import torch
            torch.cuda.set_per_process_memory_fraction(
                device_memory_fraction)
        elif memory_bytes is not None:
            import resource
            limit = memory_ceiling(memory_bytes)
            resource.setrlimit(resource.RLIMIT_AS, (limit, limit))
        conn.send(("started", None))
        out = fn()
        conn.send(("ok", out))
    except MemoryError:
        conn.send(("oom", "MemoryError: allocation exceeded the sandbox "
                          "memory ceiling"))
    except BaseException as e:  # noqa: BLE001 — the whole point
        detail = f"{type(e).__name__}: {e}"
        traceback.print_exc()       # lands in the captured stderr file
        conn.send(("oom" if _device_oom(e) else "crash", detail))
    finally:
        conn.close()


def _read_stderr(path: str) -> str:
    try:
        with open(path, "r", errors="replace") as f:
            return f.read(STDERR_LIMIT)
    except OSError:  # pragma: no cover
        return ""


def _receive(conn, timeout_s: float) -> tuple:
    """The child's next ``(tag, payload)``; ``("timeout", None)`` when none
    came within ``timeout_s``, ``(None, None)`` when the child died
    without one."""
    if not conn.poll(timeout_s):
        return "timeout", None
    try:
        return conn.recv()
    except (EOFError, OSError):
        return None, None


def _inline(fn: Callable[[], Any]) -> tuple[SandboxVerdict, Any]:
    t0 = time.perf_counter()
    try:
        out = fn()
        return (SandboxVerdict(STATUS_OK, exit_cause="inline",
                               wall_s=time.perf_counter() - t0), out)
    except MemoryError:
        return (SandboxVerdict(
            STATUS_OOM, detail="MemoryError",
            exit_cause="exception:MemoryError",
            wall_s=time.perf_counter() - t0), None)
    except Exception as e:  # noqa: BLE001 — map, never propagate
        name = type(e).__name__
        return (SandboxVerdict(
            STATUS_OOM if _device_oom(e) else STATUS_CRASH,
            detail=f"{name}: {e}", exit_cause=f"exception:{name}",
            stderr=traceback.format_exc()[-STDERR_LIMIT:],
            wall_s=time.perf_counter() - t0), None)


def sandboxed_call(fn: Callable[[], Any],
                   settings: SandboxSettings | None = None
                   ) -> tuple[SandboxVerdict, Any]:
    """Run ``fn`` under ``settings``; return ``(verdict, payload)``.

    ``payload`` is ``fn``'s return value when the verdict is ``ok`` and
    None otherwise. With ``method="spawn"`` both ``fn`` and its return
    value cross a pipe, so both must be picklable (``fn`` a top-level
    function or a ``functools.partial`` of one; a closure raises
    ``TypeError`` here); with ``method="inline"`` anything goes (and only
    exceptions — not hangs or signals — are contained).

    Example::

        verdict, result = sandboxed_call(
            functools.partial(KernelTrial("advec_u", (64,) * 3,
                                          "float32"), config),
            SandboxSettings(timeout_s=60, device_memory_fraction=0.05))
        if verdict.status == "timeout":
            ...
    """
    settings = settings if settings is not None else SandboxSettings()
    if settings.method == "inline":
        return _inline(fn)
    try:
        pickle.dumps(fn)
    except Exception as e:  # noqa: BLE001 — pickling raises many types
        raise TypeError(
            f"a spawned sandbox child needs a picklable callable (a "
            f"top-level function or a functools.partial of one), got "
            f"{fn!r}: {type(e).__name__}: {e}") from None

    ctx = multiprocessing.get_context("spawn")
    parent_conn, child_conn = ctx.Pipe(duplex=False)
    with tempfile.NamedTemporaryFile(prefix="sandbox-stderr-",
                                     suffix=".log") as errf:
        proc = ctx.Process(target=_child_main,
                           args=(fn, child_conn, errf.name,
                                 settings.memory_bytes,
                                 settings.device_memory_fraction),
                           daemon=True)
        t0 = time.perf_counter()
        proc.start()
        child_conn.close()
        tag, payload = _receive(parent_conn, START_TIMEOUT_S)
        started = tag == "started"
        if started:
            tag, payload = _receive(parent_conn, settings.timeout_s)
        if tag == "timeout":
            proc.kill()
            proc.join(10.0)
            parent_conn.close()
            return (SandboxVerdict(
                STATUS_TIMEOUT,
                detail=(f"exceeded {settings.timeout_s:g}s wall-clock "
                        f"ceiling" if started else
                        f"did not start within {START_TIMEOUT_S:g}s"),
                exit_cause="killed:timeout", stderr=_read_stderr(errf.name),
                wall_s=time.perf_counter() - t0), None)
        # Reported (or died): let it exit, so its exit code says how.
        proc.join(30.0)
        if proc.is_alive():
            proc.kill()
            proc.join(10.0)
        wall_s = time.perf_counter() - t0
        parent_conn.close()
        stderr = _read_stderr(errf.name)
        code = proc.exitcode
        cause = (f"signal:{-code}" if code is not None and code < 0
                 else f"exit:{code}")
        if tag == "ok":
            return (SandboxVerdict(STATUS_OK, exit_cause=cause,
                                   stderr=stderr, wall_s=wall_s), payload)
        if tag == "oom":
            return (SandboxVerdict(STATUS_OOM, detail=str(payload),
                                   exit_cause=cause, stderr=stderr,
                                   wall_s=wall_s), None)
        if tag == "crash":
            return (SandboxVerdict(STATUS_CRASH, detail=str(payload),
                                   exit_cause=cause, stderr=stderr,
                                   wall_s=wall_s), None)
        # Died before reporting: a signal (segfault, abort) — or the OS
        # OOM-killer, which the memory ceiling makes attributable.
        if settings.memory_bytes is not None and code == -9:
            return (SandboxVerdict(
                STATUS_OOM, detail="killed under the sandbox memory "
                                   "ceiling", exit_cause=cause,
                stderr=stderr, wall_s=wall_s), None)
        return (SandboxVerdict(
            STATUS_CRASH,
            detail=f"child died without reporting ({cause})",
            exit_cause=cause, stderr=stderr, wall_s=wall_s), None)


@dataclass(frozen=True)
class KernelTrial:
    """A registered kernel's scenario in plain, picklable fields: the
    evaluator a spawned child can rebuild.

    Called with a config, it looks the kernel up by name, makes its probe
    arguments for (``problem``, ``dtype``) on ``device``, and runs the
    port's :class:`~repro_torch.tuner.runner.WallClockEvaluator` on them:
    the nvcc build (or the on-disk library), the check against the plain
    version, then ``repeats`` timed launches. ``seed`` seeds the child's
    torch and numpy generators.

    Example::

        ev = SandboxedEvaluator(KernelTrial("advec_u", (512,) * 3,
                                            "float32"),
                                SandboxSettings(timeout_s=120,
                                                device_memory_fraction=0.1))
        r = ev(config)      # the card's time, or an infeasible verdict
    """

    kernel: str
    problem: tuple
    dtype: str
    seed: int = 0
    device: str = "cuda"
    repeats: int = 3

    def __call__(self, config) -> EvalResult:
        import numpy as np
        import torch

        from repro_torch.core.registry import get_kernel
        from repro_torch.tuner.runner import WallClockEvaluator

        torch.manual_seed(self.seed)
        np.random.seed(self.seed)
        builder = get_kernel(self.kernel)
        args = builder.make_probe_args(tuple(self.problem), self.dtype)
        return WallClockEvaluator(builder, args, device=self.device,
                                  repeats=self.repeats)(config)


def _evaluate(evaluator, config) -> tuple:
    """The spawned child's payload for :class:`SandboxedEvaluator`: the
    evaluator's result, reduced to picklable fields (``info`` can hold
    workloads and tensors)."""
    r = evaluator(config)
    return (r.score_us, r.feasible, r.verified, r.error)


class SandboxedEvaluator:
    """Crash-isolation wrapper around any tuner evaluator.

    A drop-in ``Evaluate`` callable: delegates each config to the wrapped
    evaluator under :func:`sandboxed_call` and returns a normal
    :class:`~repro_torch.tuner.runner.EvalResult`. Healthy configs pass
    through; a hang, crash, OOM or raise becomes an *infeasible* result
    whose ``error`` is ``"sandbox:<status>: ..."`` and whose
    ``info["sandbox"]`` carries the verdict status. Under ``spawn`` the
    evaluator crosses to the child by pickle, so it must be an object of
    plain fields (:class:`KernelTrial`,
    :class:`~repro_torch.sandbox.faults.FaultyEvaluator`). Per-config
    verdicts are kept on :attr:`verdicts` for reporting. With
    ``record_to`` (a :class:`~repro_torch.tunebench.SpaceDataset`) every
    result is recorded in this process, an infeasible one with its
    verdict, so a replayed space remembers which configs kill workers.

    Example::

        ev = SandboxedEvaluator(KernelTrial("matmul", (512, 512, 1024),
                                            "float32"),
                                SandboxSettings(timeout_s=60,
                                                device_memory_fraction=0.1))
        r = ev(config)          # never raises, never hangs forever
        if not r.feasible and r.info.get("sandbox") == "timeout":
            ...
    """

    def __init__(self, evaluator: Callable[..., EvalResult],
                 settings: SandboxSettings | None = None,
                 record_to=None) -> None:
        self.evaluator = evaluator
        self.settings = settings if settings is not None else SandboxSettings()
        #: Optional dataset recorder (``record(config, EvalResult)``): the
        #: parent records every result, the verdict with it.
        self.record_to = record_to
        #: Verdicts in evaluation order: ``(config, SandboxVerdict)``.
        self.verdicts: list[tuple[dict, SandboxVerdict]] = []

    def _observe(self, verdict: SandboxVerdict) -> None:
        m = obs.metrics()
        if m is not None:
            m.counter("sandbox.verdict", status=verdict.status).inc()
            if verdict.status == STATUS_TIMEOUT:
                m.histogram("sandbox.timeout_s",
                            bounds=SECONDS_BUCKETS).observe(verdict.wall_s)
        tr = obs.tracer()
        if tr is not None and verdict.status != STATUS_OK:
            tr.instant("sandbox." + verdict.status, cat="sandbox",
                       detail=verdict.detail[:200])

    def __call__(self, config) -> EvalResult:
        result = self._evaluate(config)
        if self.record_to is not None:
            self.record_to.record(config, result)
        return result

    def _evaluate(self, config) -> EvalResult:
        import functools

        run = functools.partial(_evaluate, self.evaluator, dict(config))
        tr = obs.tracer()
        if tr is not None:
            with tr.span("sandbox.eval", cat="sandbox",
                         method=self.settings.method):
                verdict, payload = sandboxed_call(run, self.settings)
        else:
            verdict, payload = sandboxed_call(run, self.settings)
        self.verdicts.append((dict(config), verdict))
        self._observe(verdict)
        if verdict.ok:
            score_us, feasible, verified, error = payload
            return EvalResult(score_us, feasible, verified=verified,
                              error=error,
                              info={"sandbox": STATUS_OK,
                                    "wall_s": verdict.wall_s})
        return EvalResult(
            INFEASIBLE, False,
            error=f"sandbox:{verdict.status}: {verdict.detail}",
            info={"sandbox": verdict.status, "wall_s": verdict.wall_s,
                  "exit_cause": verdict.exit_cause})
