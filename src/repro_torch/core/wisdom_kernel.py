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
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from .builder import KernelBuilder, args_meta
from .capture import capture_requested, write_capture
from .compile_cache import CompileCache, LaunchStats
from .device import current_device_kind
from .param import Config
from .wisdom import Wisdom


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
        self.tier_counts: dict[str, int] = {}
        self.last_tier: str | None = None

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

    def select_config(self, problem: tuple[int, ...], dtype: str
                      ) -> tuple[Config, str]:
        key = (self.device_kind, problem, dtype)
        if key in self._selection_cache:
            return self._selection_cache[key]
        wisdom = self._load_wisdom()
        rec, tier = wisdom.select_record(self.device_kind, problem, dtype)
        cfg = (dict(rec.config) if rec is not None
               else self.builder.default_config())
        self._selection_cache[key] = (cfg, tier)
        return cfg, tier

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
        select_s = time.perf_counter() - t_sel0
        self.tier_counts[tier] = self.tier_counts.get(tier, 0) + 1
        self.last_tier = tier

        key = (self.device_kind, str(device), problem, dtype,
               self.builder.space.freeze(config))
        fn, make_s, cached = self.compile_cache.get_or_compile(
            key, lambda: self.builder.make(config, meta))
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
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return (f"WisdomKernel({self.builder.name!r}, "
                f"device={self.device_kind!r})")
