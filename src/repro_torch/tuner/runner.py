"""Evaluators: config -> (score, validity) — the tuner's measurement step.

Port of ``repro.tuner.runner``. ``WallClockEvaluator`` builds each config
with nvcc and times its launches on the card with CUDA events, after
verifying the output against the kernel's plain PyTorch version on the same
inputs (the paper's "output verification" option in Kernel Tuner). On CPU
tensors it times the plain version with the host clock, which exercises the
loop but measures nothing about a kernel.

``CostModelEvaluator`` scores a config with the analytical
:class:`~repro_torch.tuner.costmodel.CostModel` from the kernel's workload
hook, without launching it; with ``verify_args`` each distinct config is
also run once on those tensors and held to the plain version
(:func:`verify_config`). It is the online tuner's screening objective.

Both evaluators also take ``record_to``: any object with a
``record(config, EvalResult)`` method, in practice a
:class:`~repro_torch.tunebench.SpaceDataset`, receives every evaluation
(feasible or not) as it happens, so any tuning session becomes a recorded
search space that can be replayed later without the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.builder import KernelBuilder, args_meta
from repro_torch.core.device import (DeviceSpec, current_device_kind,
                                     get_device)
from repro_torch.core.param import Config
from repro_torch.kernels._build import KernelBuildError, KernelLaunchError
from repro_torch.prof.profile import profile_fields, profile_from_workload

from .costmodel import INFEASIBLE, CostModel

VERIFY_BYTES_LIMIT = 64 * 2**20  # skip in-loop verification beyond this

#: Bytes written between timed repeats to evict the card's 50 MB L2, so no
#: repeat finds its inputs cached by the one before (the whole quickstart
#: matmul working set would fit).
L2_FLUSH_BYTES = 64 * 2**20


@dataclass
class EvalResult:
    """Outcome of evaluating one configuration.

    ``score_us`` is the objective value in microseconds (lower is
    better; ``inf`` when infeasible), ``feasible`` says whether the
    config can run at all (restrictions, failed verification, build and
    launch errors all make it False — ``error`` says which), and
    ``verified`` records output verification (None = not checked).

    Example::

        r = evaluator({"block_m": 64, "block_n": 64, ...})
        if r.feasible:
            print(f"{r.score_us:.1f}us")
    """

    score_us: float
    feasible: bool
    verified: bool | None = None   # None = not checked
    error: str = ""
    info: dict = field(default_factory=dict)


def _tolerances(dtype: str) -> tuple[float, float]:
    if dtype in ("bfloat16",):
        return 2e-2, 2e-2
    if dtype in ("float16",):
        return 1e-2, 1e-2
    return 1e-5, 1e-5


@dataclass
class VerifyOutcome:
    """Structured result of one comparison with the plain version.

    ``kind`` classifies a failure: ``""`` (passed), ``"build"`` (the
    config could not be built or launched: :func:`verify_config`),
    ``"structure"`` (output count or shape mismatch) or ``"numerics"``
    (``allclose`` failed). ``max_err`` is the largest absolute deviation
    over all outputs; ``rtol``/``atol`` are the dtype-aware tolerances
    used, the absolute one scaled by the largest reference magnitude (at
    least 1).

    Example::

        out = verify_outcome(got, want, "float32")
        assert out.ok, out.error
    """

    ok: bool
    kind: str = ""
    error: str = ""
    max_err: float | None = None
    rtol: float | None = None
    atol: float | None = None


def _leaves(x) -> list[torch.Tensor]:
    return list(x) if isinstance(x, (tuple, list)) else [x]


def verify_outcome(got, want, dtype: str) -> VerifyOutcome:
    """Compare a kernel's output(s) with the plain version's, in float64,
    with the reference's dtype-aware tolerances (``_tolerances``)."""
    rtol, atol = _tolerances(dtype)
    got_l, want_l = _leaves(got), _leaves(want)
    if len(got_l) != len(want_l):
        return VerifyOutcome(False, kind="structure", rtol=rtol, atol=atol,
                             error="output structure mismatch")
    max_err = 0.0
    for g, w in zip(got_l, want_l):
        if g.shape != w.shape:
            return VerifyOutcome(
                False, kind="structure", rtol=rtol, atol=atol,
                error=f"shape mismatch {tuple(g.shape)} vs {tuple(w.shape)}")
        g64 = g.to(torch.float64)
        w64 = w.to(device=g.device, dtype=torch.float64)
        if g64.numel():
            max_err = max(max_err, float((g64 - w64).abs().max()))
        scale = max(1.0, float(w64.abs().max()) if w64.numel() else 1.0)
        if not torch.allclose(g64, w64, rtol=rtol, atol=atol * scale):
            return VerifyOutcome(
                False, kind="numerics", max_err=max_err, rtol=rtol,
                atol=atol, error=f"allclose failed, max abs err {max_err:.3e}")
    return VerifyOutcome(True, max_err=max_err, rtol=rtol, atol=atol)


def verify_config(builder: KernelBuilder, config: Config,
                  args: Sequence[torch.Tensor]) -> VerifyOutcome:
    """Build ``config``, run it on ``args`` and hold its output to the
    plain version's on the same tensors (:func:`verify_outcome`).

    On CUDA tensors this launches the hand-written kernel; on CPU tensors
    the built callable is the plain version itself, so the check compares
    it with itself. A build or launch failure of any kind is the
    config's verdict (kind ``"build"``), as in the reference.

    Example::

        out = verify_config(get_kernel("matmul"), config, [a, b])
        assert out.ok, out.error
    """
    meta = args_meta(*args)
    dtype = builder.get_dtype(*meta)
    rtol, atol = _tolerances(dtype)
    try:
        got = builder.make(config, meta)(*args)
        if meta[0].device.type == "cuda":
            torch.cuda.synchronize(meta[0].device)
    except Exception as e:  # noqa: BLE001 — any build/run failure = invalid
        return VerifyOutcome(False, kind="build", rtol=rtol, atol=atol,
                             error=f"build/run failed: "
                                   f"{type(e).__name__}: {e}")
    return verify_outcome(got, builder.make_reference()(*args), dtype)


def _recorded(record_to, config: Config, result: EvalResult) -> EvalResult:
    """Hand ``result`` to the evaluator's dataset recorder, if any."""
    if record_to is not None:
        record_to.record(config, result)
    return result


class CostModelEvaluator:
    """Score a config with the analytical cost model, launching nothing.

    The kernel's ``workload`` hook, priced by
    :class:`~repro_torch.tuner.costmodel.CostModel` for ``device`` (a
    :class:`DeviceSpec` or a kind), keyed by config, problem and dtype for
    the model's deterministic noise. With ``verify_args`` each distinct
    config is also checked once against the plain version on those
    tensors (:func:`verify_config`; ``verify="auto"`` skips it above
    64 MiB of arguments, ``"full"`` never does, ``"none"`` always does).
    Every feasible result carries its workload and roofline profile in
    ``info``.

    Example::

        ev = CostModelEvaluator(get_kernel("advec_u"), (512, 512, 512),
                                "float32", "gpu-h100", verify="none")
        score = ev(builder.default_config()).score_us
    """

    def __init__(self, builder: KernelBuilder, problem: tuple[int, ...],
                 dtype: str, device: DeviceSpec | str,
                 verify_args: Sequence[torch.Tensor] | None = None,
                 verify: str = "auto", record_to=None) -> None:
        self.builder = builder
        self.problem = tuple(problem)
        self.dtype = dtype
        self.device = get_device(device) if isinstance(device, str) else device
        self.model = CostModel(self.device)
        self.verify_args = verify_args
        self.verify = verify
        #: Optional dataset recorder: ``record(config, EvalResult)`` is
        #: called for every evaluation (see repro_torch.tunebench).
        self.record_to = record_to
        self._verified_cache: dict[tuple, VerifyOutcome] = {}

    def _should_verify(self) -> bool:
        if self.verify == "none" or self.verify_args is None:
            return False
        if self.verify == "full":
            return True
        nbytes = sum(a.numel() * a.element_size() for a in self.verify_args)
        return nbytes <= VERIFY_BYTES_LIMIT

    def __call__(self, config: Config) -> EvalResult:
        return _recorded(self.record_to, config, self._evaluate(config))

    def _evaluate(self, config: Config) -> EvalResult:
        if not self.builder.space.is_valid(config):
            return EvalResult(INFEASIBLE, False, error="restricted")
        w = self.builder.make_workload(config, self.problem, self.dtype)
        key = "|".join(f"{k}={config[k]}" for k in sorted(config))
        key += f"|{self.problem}|{self.dtype}"
        t = self.model.time(w, self.dtype, noise_key=key)
        if not np.isfinite(t):
            return EvalResult(INFEASIBLE, False, error="vmem overflow",
                              info={"vmem_bytes": w.vmem_bytes})
        verified: bool | None = None
        if self._should_verify():
            fkey = self.builder.space.freeze(config)
            if fkey not in self._verified_cache:
                self._verified_cache[fkey] = verify_config(
                    self.builder, config, self.verify_args)
            out = self._verified_cache[fkey]
            verified = out.ok
            if not out.ok:
                return EvalResult(INFEASIBLE, False, verified=False,
                                  error=out.error)
        # Always-on profiling: the workload is already in hand, so joining
        # it with the score costs one pure function call.
        p = profile_from_workload(
            w, self.device, self.dtype, t * 1e6,
            kernel=self.builder.name, problem_size=self.problem,
            config=config)
        return EvalResult(t * 1e6, True, verified=verified,
                          info={"workload": w,
                                "profile": profile_fields(p)})


class WallClockEvaluator:
    """Measure a config's launch time on ``device``.

    For each config: build it (nvcc), run it once and verify the output
    against the plain version (computed once per evaluator, on the same
    device), run ``warmup`` more launches, then ``repeats`` timed launches,
    each after an L2 flush, timed with CUDA events on the current stream.
    The score is the best repeat, in microseconds. Build and launch
    errors make a config infeasible, with nvcc's or CUDA's message in
    ``error``; nothing else is caught. Every feasible result carries its
    roofline profile (``info["profile"]``, from the kernel's workload hook
    and the score) when the kernel has a hook.

    Example::

        cap = load_capture("captures/matmul-512x512x1024-float32.capture.json")
        ev = WallClockEvaluator(get_kernel(cap.kernel_name), cap.args)
        result = ev(config)     # EvalResult with measured score_us
    """

    def __init__(self, builder: KernelBuilder, args: Sequence[torch.Tensor],
                 device: str | torch.device = "cuda", repeats: int = 5,
                 warmup: int = 1, verify: bool = True,
                 record_to=None) -> None:
        self.builder = builder
        self.device = torch.device(device)
        self.args = [torch.as_tensor(a).to(self.device) for a in args]
        self.meta = args_meta(*self.args)
        self.dtype = builder.get_dtype(*self.meta)
        self.repeats = repeats
        self.warmup = warmup
        self.verify = verify
        #: Optional dataset recorder: ``record(config, EvalResult)`` is
        #: called for every evaluation (see repro_torch.tunebench).
        self.record_to = record_to
        self._want = None
        self._flush = (torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                                   device=self.device)
                       if self.device.type == "cuda" else None)

    def _time_once(self, fn) -> float:
        """Seconds of one launch of ``fn``, after an L2 flush on the card."""
        if self._flush is None:
            t0 = time.perf_counter()
            fn(*self.args)
            return time.perf_counter() - t0
        self._flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*self.args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    def __call__(self, config: Config) -> EvalResult:
        return _recorded(self.record_to, config, self._evaluate(config))

    def _evaluate(self, config: Config) -> EvalResult:
        if not self.builder.space.is_valid(config):
            return EvalResult(INFEASIBLE, False, error="restricted")
        try:
            fn = self.builder.make(config, self.meta)
            got = fn(*self.args)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        except (KernelBuildError, KernelLaunchError) as e:
            return EvalResult(INFEASIBLE, False,
                              error=f"{type(e).__name__}: {e}")
        verified = None
        if self.verify:
            if self._want is None:
                self._want = self.builder.make_reference()(*self.args)
            out = verify_outcome(got, self._want, self.dtype)
            if not out.ok:
                return EvalResult(INFEASIBLE, False, verified=False,
                                  error=out.error)
            verified = True
        del got
        for _ in range(self.warmup):
            fn(*self.args)
        times = [self._time_once(fn) for _ in range(self.repeats)]
        score_us = min(times) * 1e6
        info: dict = {"times_us": [t * 1e6 for t in times]}
        if self.builder._workload is not None:
            # Always-on profiling: joining the workload with the score is
            # one pure function call.
            problem = self.builder.get_problem_size(*self.meta)
            w = self.builder.make_workload(config, problem, self.dtype)
            p = profile_from_workload(
                w, get_device(current_device_kind(self.device)), self.dtype,
                score_us, kernel=self.builder.name, problem_size=problem,
                config=config)
            info["profile"] = profile_fields(p)
        return EvalResult(score_us, True, verified=verified, info=info)
