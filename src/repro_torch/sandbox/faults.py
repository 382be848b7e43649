"""Fault injection: evaluators and kernels that misbehave on demand.

Port of ``repro.sandbox.faults``. The sandbox's tests, its demo and the
card's smoke run need candidates that hang, raise, segfault, allocate
without bound, or silently compute the wrong answer — per config,
deterministically. Two injection sites:

* :class:`FaultyEvaluator` — a picklable ``Evaluate`` callable whose
  behaviour is driven by the config's ``fault`` value; with
  ``device="cuda"`` it opens a CUDA context first, so the fault happens in
  a process that holds one (and an allocation bomb fills the card's
  memory instead of the host's). Exercises
  :class:`~repro_torch.sandbox.evaluator.SandboxedEvaluator` with no
  kernel machinery.
* :func:`make_faulty_kernel` — a registrable
  :class:`~repro_torch.core.builder.KernelBuilder` whose *built kernel*
  misbehaves the same way, with an honest plain version and probe; it
  runs on the tensors' device, the card's included. This is what proves
  the :class:`~repro_torch.sandbox.gate.OracleGate` rejects wrong-output
  winners in the promotion path: the cost model scores the ``wrong``
  variant as the *fastest* config, so an ungated path would promote it.

:func:`device_assert` is a payload of its own: a device-side assertion,
after which the process's CUDA context is lost.
"""

from __future__ import annotations

import os
import signal
import time

import numpy as np
import torch

from repro_torch.core.builder import KernelBuilder, probe_array
from repro_torch.core.workload import Workload
from repro_torch.tuner.runner import EvalResult

#: The tunable that injects faults. ``none`` behaves; everything else is
#: one of the sandbox's failure modes.
FAULT_PARAM = "fault"
FAULT_MODES = ("none", "wrong", "hang", "raise", "oom", "segv")

#: Cost-model speed multiplier per fault mode. ``wrong`` is the FASTEST
#: config on purpose: an ungated promotion path would pick it.
_COST_FACTOR = {"none": 1.0, "wrong": 0.5, "hang": 0.8, "raise": 0.85,
                "oom": 0.9, "segv": 0.95}

#: Bytes a device allocation bomb takes at a time.
_DEVICE_CHUNK = 256 * 2**20


def _misbehave(mode: str, hang_s: float, device: str | None = None) -> None:
    """Perform the injected fault (never returns for hang/segv). With a
    CUDA ``device`` the allocation bomb fills the card's memory."""
    if mode == "hang":
        time.sleep(hang_s)
    elif mode == "raise":
        raise RuntimeError("injected evaluator fault")
    elif mode == "oom":
        hoard = []
        if device is not None and torch.device(device).type == "cuda":
            while True:    # stopped by the device-memory fraction
                hoard.append(torch.empty(_DEVICE_CHUNK, dtype=torch.uint8,
                                         device=device))
        while True:        # allocation bomb: stopped by RLIMIT_AS
            hoard.append(np.ones((1024, 1024), np.float64))
    elif mode == "segv":
        os.kill(os.getpid(), signal.SIGSEGV)


class FaultyEvaluator:
    """An ``Evaluate`` callable that fails the way the config says.

    ``config["fault"]`` selects the behaviour: ``none`` returns a
    deterministic feasible score, ``hang`` sleeps ``hang_s`` seconds,
    ``raise`` raises, ``oom`` allocates without bound, ``segv`` delivers
    SIGSEGV to its own process, and ``wrong`` returns a feasible score
    (wrong *output* only matters to the oracle, which runs kernels, not
    evaluators). With ``device`` set, every call first allocates on that
    device, so a CUDA context is live when the fault happens.

    Example::

        ev = SandboxedEvaluator(FaultyEvaluator(device="cuda"),
                                SandboxSettings(timeout_s=60,
                                                device_memory_fraction=0.02))
        ev({"fault": "oom", "scale": 1})    # -> infeasible, sandbox:oom
    """

    def __init__(self, base_score_us: float = 100.0,
                 hang_s: float = 3600.0, device: str | None = None) -> None:
        self.base_score_us = base_score_us
        self.hang_s = hang_s
        self.device = device
        self.calls = 0

    def __call__(self, config) -> EvalResult:
        self.calls += 1
        if self.device is not None:
            torch.ones(1, device=self.device).sum().item()
        mode = str(config.get(FAULT_PARAM, "none"))
        _misbehave(mode, self.hang_s, self.device)
        scale = int(config.get("scale", 1))
        return EvalResult(self.base_score_us * _COST_FACTOR.get(mode, 1.0)
                          * (1.0 + 0.01 * scale), True)


def device_assert(device: str = "cuda") -> None:
    """Trip a device-side assertion (an index past the end of a CUDA
    tensor): the CUDA error is sticky, so the calling process's context is
    lost and the call raises. A payload for a spawned child only.

    Example::

        lost, _ = sandboxed_call(functools.partial(device_assert, "cuda"),
                                 SandboxSettings(timeout_s=120.0))
        assert lost.status == "crash"
    """
    x = torch.zeros(4, device=device)
    x[torch.tensor([1 << 20], device=device)] = 1.0
    torch.cuda.synchronize(device)


def make_faulty_kernel(name: str = "faulty_mul2",
                       hang_s: float = 3600.0) -> KernelBuilder:
    """A tunable kernel whose built variant misbehaves per config.

    The honest computation is ``y = 2 * x`` on the tensor's device (plain
    version, probe and workload included: a fully oracle-checkable
    kernel). The ``fault`` tunable corrupts it: ``wrong`` returns a
    plausibly-scaled but incorrect output, ``hang``/``raise``/``oom``/
    ``segv`` do exactly that *when the built kernel executes* — inside the
    oracle's check. Register it with :func:`repro_torch.core.register`
    (and unregister after).

    Example::

        builder = make_faulty_kernel()
        register(builder)
        try:
            verdict = OracleGate().check(builder, {"fault": "wrong",
                                                   "scale": 1},
                                         (64, 64), "float32",
                                         device="cuda")
            assert verdict.status == "numerics-mismatch"
        finally:
            unregister(builder.name)
    """
    b = KernelBuilder(name, source="repro_torch.sandbox.faults")
    b.tune("scale", (1, 2, 4), default=1)
    b.tune(FAULT_PARAM, FAULT_MODES, default="none")

    @b.problem_size
    def _problem(x):
        return tuple(int(d) for d in x.shape)

    @b.build
    def _build(config, problem, meta):
        mode = str(config[FAULT_PARAM])
        device = str(meta[0].device)

        def run(x):
            _misbehave(mode, hang_s, device)
            out = x.to(torch.float64) * 2.0
            if mode == "wrong":
                # well past any dtype tolerance, but not absurd
                out = out * 1.05 + 0.1
            return out.to(x.dtype)

        return run

    @b.reference
    def _reference(x):
        return (x.to(torch.float64) * 2.0).to(x.dtype)

    @b.probe
    def _probe(problem, dtype):
        rng = np.random.default_rng(0)
        return (probe_array(rng, problem, dtype),)

    @b.workload
    def _workload(config, problem, dtype):
        n = 1
        for d in problem:
            n *= int(d)
        factor = _COST_FACTOR.get(str(config[FAULT_PARAM]), 1.0)
        scale = int(config["scale"])
        return Workload(
            flops=float(n), hbm_bytes=8.0 * n * factor * (1 + 0.01 * scale),
            vmem_bytes=4096, grid=1,
            notes={"fault": config[FAULT_PARAM]})

    return b
