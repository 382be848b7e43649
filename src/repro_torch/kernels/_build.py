"""Build and launch the hand-written CUDA kernels: the port's counterpart of
``repro.kernels._lowering``.

Kernel Launcher compiles each configuration at first use, with its tunables
compiled in as preprocessor defines, and caches the result. Here that is one
nvcc run per (source, defines):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -DNAME=VALUE ... -o <build>/<stem>-<hash>.so <source>

into a plain C shared library, loaded with ``ctypes``. The output lands in
``build/`` beside this file (listed in ``.gitignore``), named by a hash of the
source, the headers it includes, the defines and the flags, so a config is
compiled once per checkout. A failed build raises :class:`KernelBuildError`
with nvcc's stderr.

Every C entry point takes each pointer and the stream as ``void*``
(``ctypes.c_void_p``: an ``int`` argtype would cut a 64-bit pointer) and
returns the ``cudaError_t`` of ``cudaGetLastError()`` right after its launch;
a non-zero code raises :class:`KernelLaunchError`. Each :class:`CudaKernel`
counts its successful launches in ``launches``.

Nothing here runs nvcc or touches CUDA at import time: this module imports on
hosts without either.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass, replace
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared",
                           "-Xcompiler", "-fPIC")

#: dtype codes of the C entry points' first argument.
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

Defines = tuple[tuple[str, int], ...]


class KernelBuildError(RuntimeError):
    """nvcc refused a source or config; the message holds its stderr."""


class KernelLaunchError(RuntimeError):
    """A C launcher returned a non-zero ``cudaError_t``."""


def nvcc_path() -> str:
    """nvcc on ``PATH``, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _source_digest(source: str, defines: Defines) -> str:
    h = hashlib.sha256()
    for path in [CSRC / source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(repr(tuple(defines)).encode())
    h.update(repr(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(source: str, defines: Defines) -> Path:
    """Where the ``.so`` for (source, defines) is built."""
    stem = Path(source).stem
    return BUILD_DIR / f"{stem}-{_source_digest(source, defines)}.so"


def nvcc_command(source: str, defines: Defines, out: Path) -> list[str]:
    """The nvcc command line that builds ``source`` with ``defines``."""
    return [nvcc_path(), *NVCC_FLAGS,
            *(f"-D{name}={value}" for name, value in defines),
            "-o", str(out), str(CSRC / source)]


def _start(source: str, defines: Defines) -> tuple[Path, Path, subprocess.Popen]:
    out = library_path(source, defines)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    proc = subprocess.Popen(nvcc_command(source, defines, tmp),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return out, tmp, proc


def _finish(source: str, out: Path, tmp: Path,
            proc: subprocess.Popen) -> None:
    _, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n{err}")
    os.replace(tmp, out)


def build(source: str, defines: Defines) -> tuple[Path, float]:
    """Build (source, defines) unless its ``.so`` exists; returns the path
    and the seconds nvcc took (0.0 when the file was already there)."""
    out = library_path(source, defines)
    if out.exists():
        return out, 0.0
    t0 = time.perf_counter()
    out, tmp, proc = _start(source, defines)
    _finish(source, out, tmp, proc)
    return out, time.perf_counter() - t0


def build_many(specs) -> float:
    """Build several (source, defines) pairs with one nvcc each, twice as
    many at a time as the host has CPUs, the next started when the oldest
    running one ends. Returns the wall seconds; raises, after all have
    run, if any failed."""
    t0 = time.perf_counter()
    jobs = 2 * (os.cpu_count() or 4)
    todo = [(source, d) for source, d in
            dict.fromkeys((source, tuple(d)) for source, d in specs)
            if not library_path(source, d).exists()]
    running: list = []
    errors = []

    def finish_one() -> None:
        source, out, tmp, proc = running.pop(0)
        try:
            _finish(source, out, tmp, proc)
        except KernelBuildError as e:
            errors.append(str(e))

    for source, d in todo:
        if len(running) >= jobs:
            finish_one()
        running.append((source, *_start(source, d)))
    while running:
        finish_one()
    if errors:
        raise KernelBuildError("\n".join(errors))
    return time.perf_counter() - t0


@dataclass(frozen=True)
class Library:
    """One loaded ``.so`` and what it cost this process to get it."""

    cdll: ctypes.CDLL
    path: Path
    compile_s: float   # nvcc, 0.0 when already built
    load_s: float      # ctypes.CDLL, 0.0 when already loaded


_LOADED: dict[tuple[str, Defines], Library] = {}
_LOAD_LOCK = threading.Lock()


def load(source: str, defines: Defines) -> Library:
    """Build if needed and load (source, defines); cached per process."""
    key = (source, tuple(defines))
    with _LOAD_LOCK:
        lib = _LOADED.get(key)
        if lib is not None:
            return replace(lib, compile_s=0.0, load_s=0.0)
        path, compile_s = build(source, key[1])
        t0 = time.perf_counter()
        cdll = ctypes.CDLL(str(path))
        lib = Library(cdll, path, compile_s, time.perf_counter() - t0)
        _LOADED[key] = lib
        return lib


#: Every CUDA kernel of the port by name, for launch-count bookkeeping.
CUDA_KERNELS: dict[str, "CudaKernel"] = {}


class CudaKernel:
    """One C entry point in one source under ``csrc/``.

    ``argtypes`` are the ctypes types after the leading dtype code; use
    ``ctypes.c_void_p`` for every pointer and for the stream. ``launches``
    counts the launches that returned ``cudaSuccess``; ``body_launches``
    counts them by the ``body`` a caller names, where a source has more
    than one, and ``body_dtype_launches`` by (body, dtype).
    """

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: tuple) -> None:
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = (ctypes.c_int, *argtypes)
        self.launches = 0
        self.body_launches: dict[str, int] = {}
        self.body_dtype_launches: dict[tuple[str | None, str], int] = {}
        # defines -> (the loaded Library, its entry point with argtypes set)
        self._entry: dict[Defines, tuple[Library, ctypes._CFuncPtr]] = {}
        CUDA_KERNELS[name] = self

    def load(self, defines: Defines) -> Library:
        return load(self.source, defines)

    def entry(self, defines: Defines):
        """The C entry point of (source, defines), built and loaded if
        needed; looked up once per loaded library, so a launch costs the
        host a dict lookup instead of a locked load and a symbol lookup."""
        lib = _LOADED.get((self.source, defines))
        hit = self._entry.get(defines)
        if lib is not None and hit is not None and hit[0] is lib:
            return hit[1]
        self.load(defines)
        lib = _LOADED[(self.source, tuple(defines))]
        fn = getattr(lib.cdll, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._entry[defines] = (lib, fn)
        return fn

    def __call__(self, defines: Defines, dtype: str, *args,
                 body: str | None = None) -> None:
        err = self.entry(defines)(DTYPE_CODES[dtype], *args)
        if err != 0:
            raise KernelLaunchError(
                f"{self.name}: launch returned cudaError_t {err} "
                f"(defines {dict(defines)})")
        self.launches += 1
        if body is not None:
            self.body_launches[body] = self.body_launches.get(body, 0) + 1
        key = (body, dtype)
        self.body_dtype_launches[key] = self.body_dtype_launches.get(key,
                                                                     0) + 1


def reset_launch_counts() -> None:
    """Set every kernel's ``launches`` and its counts by body and dtype
    to 0."""
    for k in CUDA_KERNELS.values():
        k.launches = 0
        k.body_launches.clear()
        k.body_dtype_launches.clear()
