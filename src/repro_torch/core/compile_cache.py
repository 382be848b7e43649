"""Compiled-kernel cache (paper §4.5 / Fig 5), port of
``repro.core.compile_cache``.

The paper caches NVRTC-compiled kernels per (kernel, problem size); the port
caches the launch callable of a ``.so`` that nvcc built for one config, per
(kernel, device, problem, dtype, config). Timings of the miss path are split
the way Fig 5 splits them:

* ``compile_s`` — the nvcc build (0 when the ``.so`` was already on disk);
* ``load_s`` — ``ctypes.CDLL`` of the ``.so``, the ``cuModuleLoad`` analogue;
* ``launch_s`` — the launch, timed with CUDA events on the current stream
  (host clock for the plain version on CPU tensors).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class LaunchStats:
    """Per-launch timing record (seconds)."""
    kernel: str
    cached: bool
    wisdom_read_s: float = 0.0
    select_s: float = 0.0
    compile_s: float = 0.0     # nvcc build ("NVRTC" analogue)
    load_s: float = 0.0        # ctypes.CDLL ("cuModuleLoad")
    launch_s: float = 0.0      # launch, CUDA events ("cuLaunchKernel")
    tier: str = ""
    config: dict = field(default_factory=dict)


class CompileCache:
    def __init__(self) -> None:
        self._cache: dict[Any, Callable] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key) -> Callable | None:
        with self._lock:
            fn = self._cache.get(key)
            if fn is not None:
                self.hits += 1
            return fn

    def put(self, key, fn: Callable) -> None:
        with self._lock:
            self._cache[key] = fn
            self.misses += 1

    def get_or_compile(self, key, compile_fn: Callable[[], Callable]
                       ) -> tuple[Callable, float, bool]:
        """Returns (callable, compile_seconds, was_cached)."""
        fn = self.get(key)
        if fn is not None:
            return fn, 0.0, True
        t0 = time.perf_counter()
        fn = compile_fn()
        dt = time.perf_counter() - t0
        self.put(key, fn)
        return fn, dt, False

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self.hits = 0
            self.misses = 0

    def __len__(self) -> int:
        return len(self._cache)
