"""WisdomKernel — runtime kernel selection + runtime compilation (paper §4.5).

The port of ``repro.core.wisdom_kernel``. Calling a ``WisdomKernel`` with
kernel arguments (a) derives the problem size from the arguments, (b)
optionally *captures* the launch, (c) selects the best known configuration
from the wisdom file via the fuzzy-match heuristic, and (d) compiles the
chosen configuration just in time (nvcc, for CUDA tensors), caching it for
later launches of the same scenario.

The tensors' device decides the path: CUDA tensors launch the hand-written
kernel, CPU tensors run its plain PyTorch version. There is no backend
switch. A wisdom record whose config this port's space refuses (a TPU
record, say) is never a candidate: such records are dropped when the wisdom
file is read, so selection falls through to the next tier, or to the
kernel's default config.

An online tuner (:class:`repro_torch.online.OnlineTuner`) may be attached
(explicitly via ``attach_online`` or
``repro_torch.online.enable_online_tuning``, or automatically when
``KERNEL_LAUNCHER_ONLINE=1``): every launch then reports its selection
tier, a small epsilon fraction of launches runs a candidate config instead
of the incumbent (tier "trial"), and confident winners that pass the
correctness gate are promoted into the wisdom file live, prewarmed so the
swap launch compiles nothing.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import torch

from repro_torch.obs import runtime as obs
from repro_torch.obs.metrics import UNIT_BUCKETS

from .builder import ArgsMeta, KernelBuilder, args_meta
from .capture import capture_requested, write_capture
from .compile_cache import CompileCache, LaunchStats
from .device import current_device_kind
from .param import Config
from .scenario import format_key
from .wisdom import Wisdom


def online_requested() -> bool:
    """KERNEL_LAUNCHER_ONLINE=1 auto-attaches an online tuner per kernel."""
    return os.environ.get("KERNEL_LAUNCHER_ONLINE", "").lower() in (
        "1", "true", "on", "yes")


class WisdomKernel:
    def __init__(self, builder: KernelBuilder,
                 wisdom_dir: Path | str | None = None,
                 device_kind: str | None = None) -> None:
        self.builder = builder
        self.wisdom_dir = wisdom_dir
        self._device_kind = device_kind
        self._wisdom: Wisdom | None = None
        self._wisdom_read_s = 0.0
        self._selection_cache: dict[tuple, tuple[Config, str]] = {}
        self.compile_cache = CompileCache()
        self.stats: list[LaunchStats] = []
        #: Records of the wisdom file that this port cannot launch.
        self.foreign_records = 0
        #: §4.5 match tier of every launch, tallied so callers can read
        #: selection quality without observability enabled; ``last_tier``
        #: is the most recent launch's tier.
        self.tier_counts: dict[str, int] = {}
        self.last_tier: str | None = None
        self.online = None
        if online_requested():
            from repro_torch.online import OnlineTuner  # deferred: a cycle
            self.online = OnlineTuner(self, wisdom_dir=wisdom_dir)
        #: Sampled launch profiler (see ``repro_torch.prof``) — None unless
        #: attached explicitly or via KERNEL_LAUNCHER_PROF; the per-launch
        #: cost of the disabled site is one attribute check.
        from repro_torch.prof.profiler import process_profiler  # deferred
        self.profiler = process_profiler()
        self._profile_baselines: dict[tuple, float | None] = {}

    # -- pieces ---------------------------------------------------------------

    @property
    def device_kind(self) -> str:
        return self._device_kind or current_device_kind()

    def _launchable(self, config: Config) -> bool:
        space = self.builder.space
        return set(config) == set(space.names) and space.is_valid(config)

    def _load_wisdom(self) -> Wisdom:
        if self._wisdom is None:
            t0 = time.perf_counter()
            w = Wisdom.load(self.builder.name, self.wisdom_dir)
            ok = [r for r in w.records if self._launchable(r.config)]
            self.foreign_records = len(w.records) - len(ok)
            self._wisdom = Wisdom(w.kernel_name, ok)
            self._wisdom_read_s = time.perf_counter() - t0
        return self._wisdom

    def invalidate(self) -> None:
        """Drop cached wisdom + selections (e.g. after re-tuning)."""
        self._wisdom = None
        self._selection_cache.clear()
        self.compile_cache.clear()

    def refresh_wisdom(self) -> None:
        """Re-read wisdom and re-run selection, keeping compiled variants:
        the hot-swap path of an online promotion (the promoted variant is
        prewarmed; the old ones stay valid for forced use)."""
        self._wisdom = None
        self._selection_cache.clear()

    def attach_online(self, tuner) -> None:
        """Attach an online tuning service (see ``repro_torch.online``)."""
        self.online = tuner

    def prewarm(self, meta: ArgsMeta, config: Config) -> bool:
        """Build and cache ``config`` for the scenario of ``meta`` (the
        nvcc build and the load, for CUDA tensors) ahead of any launch.
        Returns True if a build happened here."""
        key = self._variant_key(meta[0].device,
                                self.builder.get_problem_size(*meta),
                                self.builder.get_dtype(*meta), config)
        _, _, cached = self.compile_cache.get_or_compile(
            key, lambda: self.builder.make(config, meta))
        return not cached

    def _variant_key(self, device, problem: tuple[int, ...], dtype: str,
                     config: Config) -> tuple:
        """The compile cache's key of ``config`` for one scenario on
        ``device``."""
        return (self.device_kind, str(device), problem, dtype,
                self.builder.space.freeze(config))

    def attach_profiler(self, profiler) -> None:
        """Attach a :class:`repro_torch.prof.Profiler`: every Nth launch
        gets a roofline profile (bottleneck class, achieved fraction of
        peak, drift vs the wisdom-recorded baseline)."""
        self.profiler = profiler

    def select_config(self, problem: tuple[int, ...], dtype: str
                      ) -> tuple[Config, str]:
        key = (self.device_kind, problem, dtype)
        if key in self._selection_cache:
            return self._selection_cache[key]
        wisdom = self._load_wisdom()
        rec, tier = wisdom.select_record(self.device_kind, problem, dtype)
        cfg = (dict(rec.config) if rec is not None
               else self.builder.default_config())
        # Exact-tier wisdom scores are this scenario's drift baseline:
        # the latency the config was tuned at. Fuzzy/transferred
        # matches came from a different scenario, so no baseline.
        self._profile_baselines[key] = (
            float(rec.score_us) if rec is not None and tier == "exact"
            and rec.score_us > 0 else None)
        m = obs.metrics()
        if m is not None and rec is not None and rec.is_transferred():
            m.histogram("select.transfer_confidence", UNIT_BUCKETS,
                        kernel=self.builder.name).observe(
                            rec.transfer_confidence())
        self._selection_cache[key] = (cfg, tier)
        return cfg, tier

    def _observe_selection(self, problem: tuple[int, ...], dtype: str,
                           tier: str) -> None:
        """Always-on tier tally + (when enabled) per-scenario metrics."""
        self.tier_counts[tier] = self.tier_counts.get(tier, 0) + 1
        self.last_tier = tier
        m = obs.metrics()
        if m is not None:
            m.counter("select.tier", kernel=self.builder.name,
                      scenario=format_key((self.device_kind, problem,
                                           dtype)),
                      tier=tier).inc()

    # -- launch ---------------------------------------------------------------

    def __call__(self, *args, config: Config | None = None):
        meta = args_meta(*args)
        problem = self.builder.get_problem_size(*meta)
        dtype = self.builder.get_dtype(*meta)
        device = meta[0].device

        if capture_requested(self.builder.name):
            write_capture(self.builder.name, problem, dtype, args,
                          extra_meta={"device_kind": self.device_kind,
                                      "source": self.builder.source})

        t_sel0 = time.perf_counter()
        if config is None:
            config, tier = self.select_config(problem, dtype)
        else:
            tier = "forced"
        online = self.online
        if online is not None and tier != "forced":
            trial = online.before_launch(problem, dtype, meta, config, tier)
            if trial is not None:
                config, tier = dict(trial), "trial"
        select_s = time.perf_counter() - t_sel0
        self._observe_selection(problem, dtype, tier)

        fn, make_s, cached = self.compile_cache.get_or_compile(
            self._variant_key(device, problem, dtype, config),
            lambda: self.builder.make(config, meta))
        compile_s, load_s = make_s, 0.0
        lib = getattr(fn, "library", None)
        if not cached and lib is not None:
            compile_s, load_s = lib.compile_s, lib.load_s

        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            end.synchronize()
            launch_s = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            launch_s = time.perf_counter() - t0
        self.stats.append(LaunchStats(
            kernel=self.builder.name, cached=cached,
            wisdom_read_s=0.0 if cached else self._wisdom_read_s,
            select_s=select_s, compile_s=compile_s, load_s=load_s,
            launch_s=launch_s, tier=tier, config=dict(config)))
        m = obs.metrics()
        if m is not None:
            name = self.builder.name
            m.counter("launch.count", kernel=name).inc()
            m.counter("compile.cache", kernel=name,
                      outcome="hit" if cached else "miss").inc()
            m.histogram("select.latency_us",
                        kernel=name).observe(select_s * 1e6)
            m.histogram("launch.latency_us",
                        kernel=name).observe(launch_s * 1e6)
            if not cached:
                m.histogram("compile.latency_us", kernel=name).observe(
                    (compile_s + load_s) * 1e6)
        tr = obs.tracer()
        if tr is not None:
            # Record the finished launch as one complete event (the work
            # already happened; re-running it under a context manager
            # would distort the hot path). ts/dur reconstruct the span,
            # which covers selection, the nvcc build, the load and the
            # launch; the args keep the reference's keys, with the load
            # beside the build.
            t_end = tr._now_us()
            dur = round((select_s + compile_s + load_s + launch_s) * 1e6, 3)
            tr.events.append({
                "name": "launch", "cat": "kernel", "ph": "X",
                "ts": round(t_end - dur, 3), "dur": dur,
                "pid": tr.pid, "tid": tr._tid(),
                "args": {"kernel": self.builder.name, "tier": tier,
                         "scenario": format_key((self.device_kind,
                                                 problem, dtype)),
                         "cached": cached,
                         "compile_us": round(compile_s * 1e6, 3),
                         "load_us": round(load_s * 1e6, 3),
                         "launch_us": round(launch_s * 1e6, 3)}})
        profiler = self.profiler
        if profiler is not None and profiler.due(self.builder.name):
            profiler.profile_launch(
                self.builder, config, problem, dtype, self.device_kind,
                launch_s * 1e6, tier=tier,
                baseline_us=self._profile_baselines.get(
                    (self.device_kind, problem, dtype)))
        if online is not None:
            # the launch's own time: compile_s and load_s stay out of it;
            # a launch that built its variant is cold (the card loads the
            # library's module at its first launch)
            online.after_launch(problem, dtype, config, tier, launch_s,
                                cold=not cached)
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return (f"WisdomKernel({self.builder.name!r}, "
                f"device={self.device_kind!r})")
