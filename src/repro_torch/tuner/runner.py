"""Evaluators: config -> (score, validity) — the tuner's measurement step.

Port of ``repro.tuner.runner``. ``WallClockEvaluator`` builds each config
with nvcc and times its launches on the card with CUDA events, after
verifying the output against the kernel's plain PyTorch version on the same
inputs (the paper's "output verification" option in Kernel Tuner). On CPU
tensors it times the plain version with the host clock, which exercises the
loop but measures nothing about a kernel.

The reference's ``CostModelEvaluator`` and ``tuner/costmodel.py`` are not
ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Sequence

import torch

from repro_torch.core.builder import KernelBuilder, args_meta
from repro_torch.core.device import current_device_kind, get_device
from repro_torch.core.param import Config
from repro_torch.kernels._build import KernelBuildError, KernelLaunchError
from repro_torch.prof.profile import profile_fields, profile_from_workload

INFEASIBLE = float("inf")

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

    ``kind`` classifies a failure: ``""`` (passed), ``"structure"``
    (output count or shape mismatch) or ``"numerics"`` (``allclose``
    failed). ``max_err`` is the largest absolute deviation over all
    outputs; ``rtol``/``atol`` are the dtype-aware tolerances used, the
    absolute one scaled by the largest reference magnitude (at least 1).

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
                 warmup: int = 1, verify: bool = True) -> None:
        self.builder = builder
        self.device = torch.device(device)
        self.args = [torch.as_tensor(a).to(self.device) for a in args]
        self.meta = args_meta(*self.args)
        self.dtype = builder.get_dtype(*self.meta)
        self.repeats = repeats
        self.warmup = warmup
        self.verify = verify
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
