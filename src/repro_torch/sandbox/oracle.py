"""CorrectnessOracle: does a surviving candidate compute the right thing?

Port of ``repro.sandbox.oracle``. The sandbox proves a config *runs*; the
oracle proves it runs *correctly*. Each check builds the config, launches
it on concrete probe arguments and compares its output with the kernel's
plain PyTorch version on the same tensors via
:func:`repro_torch.tuner.runner.verify_config`, with the reference's
dtype-aware rtol/atol. The device of the arguments decides what is
checked: on CUDA tensors the hand-written kernel, on CPU tensors the plain
version (against itself), so a kernel bound to the card is checked with
its arguments on the card (:class:`~repro_torch.sandbox.gate.OracleGate`
moves them there). Verdicts are cached per config (the check is
deterministic); by default the check runs in-process, and with spawn
settings in a child that rebuilds the kernel's probe arguments, so a
kernel that kills its process cannot take the oracle down.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from repro_torch.core.builder import KernelBuilder
from repro_torch.core.param import Config
from repro_torch.obs import runtime as obs
from repro_torch.tuner.runner import VerifyOutcome, verify_config

from .evaluator import SandboxSettings, sandboxed_call
from .verdict import (STATUS_CRASH, STATUS_NUMERICS, STATUS_OK,
                      SandboxVerdict)

#: Histogram bounds for oracle max-abs-error observations (log-spaced).
ERROR_BUCKETS = (1e-8, 1e-6, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)


def _outcome_to_verdict(out: VerifyOutcome,
                        base: SandboxVerdict) -> SandboxVerdict:
    if out.ok:
        status, detail = STATUS_OK, ""
    elif out.kind == "build":
        status, detail = STATUS_CRASH, out.error
    else:                           # "structure" or "numerics"
        status, detail = STATUS_NUMERICS, out.error
    return SandboxVerdict(
        status, detail=detail, exit_cause=base.exit_cause,
        stderr=base.stderr, wall_s=base.wall_s,
        max_err=out.max_err, rtol=out.rtol, atol=out.atol)


def check_probe(kernel: str, config: Config, problem: tuple, dtype: str,
                device: str) -> VerifyOutcome:
    """:func:`verify_config` of a registered kernel on its probe arguments
    for (``problem``, ``dtype``) on ``device``: the payload of a spawned
    oracle check (plain, picklable arguments)."""
    from repro_torch.core.registry import get_kernel
    builder = get_kernel(kernel)
    args = [a.to(device) for a in builder.make_probe_args(problem, dtype)]
    return verify_config(builder, config, args)


class CorrectnessOracle:
    """Plain-version output validation for one (builder, args) scenario.

    ``check(config)`` returns a :class:`SandboxVerdict`: ``ok`` (with
    ``max_err``/``rtol``/``atol`` filled in), ``numerics-mismatch``,
    ``crash`` (the config would not build or launch), or — with spawn
    ``settings`` — ``timeout``/``oom`` if the check itself had to be
    killed. Verdicts are cached by frozen config. ``args`` are checked on
    their own device; under spawn the child checks the kernel's probe
    arguments for the same scenario on that device (:func:`check_probe`).

    Example::

        args = [a.cuda() for a in builder.make_probe_args((256,) * 3,
                                                          "float32")]
        verdict = CorrectnessOracle(builder, args).check(config)
        assert verdict.ok, verdict.detail
    """

    def __init__(self, builder: KernelBuilder,
                 args: Sequence[torch.Tensor],
                 settings: SandboxSettings | None = None) -> None:
        self.builder = builder
        self.args = list(args)
        #: None = verify in-process; pass spawn settings to also contain
        #: hard crashes.
        self.settings = settings
        self.verdicts: dict[tuple, SandboxVerdict] = {}

    def _observe(self, verdict: SandboxVerdict) -> None:
        m = obs.metrics()
        if m is not None:
            m.counter("oracle.checks", kernel=self.builder.name,
                      status=verdict.status).inc()
            if verdict.max_err is not None:
                m.histogram("oracle.max_err", bounds=ERROR_BUCKETS,
                            kernel=self.builder.name
                            ).observe(verdict.max_err)
        tr = obs.tracer()
        if tr is not None and not verdict.ok:
            tr.instant("oracle." + verdict.status, cat="sandbox",
                       kernel=self.builder.name,
                       detail=verdict.detail[:200])

    def check(self, config: Config) -> SandboxVerdict:
        """The cached verdict for ``config`` (computing it on miss)."""
        key = self.builder.space.freeze(config)
        hit = self.verdicts.get(key)
        if hit is not None:
            return hit
        settings = (self.settings if self.settings is not None
                    else SandboxSettings(method="inline"))
        if settings.method == "inline":
            def run() -> VerifyOutcome:
                return verify_config(self.builder, config, self.args)
        else:
            run = functools.partial(
                check_probe, self.builder.name, dict(config),
                self.builder.get_problem_size(*self.args),
                self.builder.get_dtype(*self.args), str(self.args[0].device))
        base, outcome = sandboxed_call(run, settings)
        if base.ok:
            verdict = _outcome_to_verdict(outcome, base)
        else:
            verdict = base          # timeout / crash / oom of the check
        self.verdicts[key] = verdict
        self._observe(verdict)
        return verdict
