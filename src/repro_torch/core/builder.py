"""KernelBuilder — tunable kernel definitions (paper §4.1, Listing 3).

The port of ``repro.core.builder``. The builder holds, in one place:

  * the configuration space (``tune`` / ``restriction``),
  * the compilation specification (``build``: config + problem -> callable;
    for the port's kernels the callable launches a CUDA kernel compiled
    with the config's tunables as ``-D`` defines),
  * the launch geometry (``problem_size``: derived from the arguments),
  * the plain PyTorch version (``reference``), which verifies a kernel on
    the card and is what a launch on CPU tensors runs,
  * an optional hardware-demand model (``workload``).

Arguments are torch tensors; dtypes keep the reference's names
(``"float32"``, ``"bfloat16"``), so scenarios, wisdom and captures match.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from .param import Config, ConfigSpace
from .workload import Workload


class TensorMeta(NamedTuple):
    """Abstract view of one argument: shape, dtype name and device."""

    shape: tuple[int, ...]
    dtype: str
    device: torch.device


ArgsMeta = tuple  # tuple[TensorMeta, ...]


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the reference's dtype names."""
    return str(dtype).removeprefix("torch.")


def torch_dtype(name: str) -> torch.dtype:
    """Inverse of :func:`dtype_name`."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def probe_array(rng: np.random.Generator, shape: Sequence[int], dtype: str,
                scale: float = 1.0) -> torch.Tensor:
    """Deterministic random CPU tensor for a kernel's ``probe`` hook.

    Makes the same ``rng.standard_normal`` draws as the reference's
    ``probe_array`` and rounds the same way: float64 to float32, then to
    ``dtype`` (the reference casts through ``jnp.asarray``, which holds
    float64 draws as float32 first). Both packages therefore probe a
    scenario with bit-identical inputs.
    """
    x = rng.standard_normal(tuple(int(d) for d in shape)) * scale
    return torch.from_numpy(x).to(torch.float32).to(torch_dtype(dtype))


def args_meta(*args) -> ArgsMeta:
    """Abstract (shape, dtype, device) view of tensors or Python scalars."""
    out = []
    for a in args:
        if isinstance(a, TensorMeta):
            out.append(a)
        elif isinstance(a, torch.Tensor):
            out.append(TensorMeta(tuple(int(d) for d in a.shape),
                                  dtype_name(a.dtype), a.device))
        else:  # python scalar
            t = torch.as_tensor(a)
            out.append(TensorMeta((), dtype_name(t.dtype), t.device))
    return tuple(out)


class KernelBuilder:
    """Tunable kernel definition. See Listing 3 of the paper for the shape
    of the API this mirrors."""

    def __init__(self, name: str, source: str = "") -> None:
        self.name = name
        self.source = source            # human-readable origin (module path)
        self.space = ConfigSpace()
        self._build: Callable[[Config, tuple, ArgsMeta], Callable] | None = None
        self._reference: Callable | None = None
        self._problem_size: Callable[..., tuple[int, ...]] | None = None
        self._workload: Callable[[Config, tuple, str], Workload] | None = None
        self._probe: Callable[[tuple[int, ...], str], Sequence] | None = None
        self._fit: Callable[[Config, tuple, str], Config] | None = None

    # -- space construction (chainable, like the C++ API) --------------------

    def tune(self, name: str, values: Sequence, default=None) -> "KernelBuilder":
        self.space.tune(name, values, default)
        return self

    def restriction(self, expr) -> "KernelBuilder":
        self.space.restrict(expr)
        return self

    # -- registration decorators ---------------------------------------------

    def problem_size(self, fn: Callable[..., tuple[int, ...]]):
        """fn(*args_meta) -> problem-size vector (paper §4.4)."""
        self._problem_size = fn
        return fn

    def build(self, fn: Callable[..., Callable]):
        """fn(config, problem, meta) -> callable(*tensors). For CUDA
        arguments the hook compiles the config (the paper's NVRTC step)."""
        self._build = fn
        return fn

    def reference(self, fn: Callable):
        """Plain PyTorch version: the oracle, and the CPU execution path."""
        self._reference = fn
        return fn

    def workload(self, fn: Callable[[Config, tuple, str], Workload]):
        """fn(config, problem, dtype) -> Workload."""
        self._workload = fn
        return fn

    def probe(self, fn: Callable[[tuple[int, ...], str], Sequence]):
        """fn(problem, dtype) -> concrete CPU argument tensors for the
        scenario (use :func:`probe_array` with a fixed seed)."""
        self._probe = fn
        return fn

    def fit(self, fn: Callable[[Config, tuple, str], Config]):
        """fn(config, problem, dtype) -> the config a selected ``config``
        launches as on this scenario (a tile the device cannot hold at this
        problem gives way to one it can). Selection applies it; a forced
        config is launched as given."""
        self._fit = fn
        return fn

    # -- accessors ------------------------------------------------------------

    def get_problem_size(self, *args) -> tuple[int, ...]:
        meta = args_meta(*args)
        if self._problem_size is None:
            return tuple(int(d) for d in meta[0].shape)
        return tuple(int(x) for x in self._problem_size(*meta))

    def get_dtype(self, *args) -> str:
        return args_meta(*args)[0].dtype

    def make(self, config: Config, meta: ArgsMeta) -> Callable:
        if self._build is None:
            raise ValueError(f"kernel {self.name!r} has no build fn")
        self.space.check(config)
        problem = self.get_problem_size(*meta)
        return self._build(dict(config), problem, meta)

    def make_reference(self) -> Callable:
        if self._reference is None:
            raise ValueError(f"kernel {self.name!r} has no reference fn")
        return self._reference

    def make_workload(self, config: Config, problem: tuple[int, ...],
                      dtype: str) -> Workload:
        if self._workload is None:
            raise ValueError(f"kernel {self.name!r} has no workload fn")
        return self._workload(dict(config), tuple(problem), dtype)

    def has_probe(self) -> bool:
        """Whether this kernel can synthesize oracle-check arguments."""
        return self._probe is not None

    def make_probe_args(self, problem: tuple[int, ...],
                        dtype: str) -> list[torch.Tensor]:
        """Deterministic CPU argument tensors for (problem, dtype)."""
        if self._probe is None:
            raise ValueError(f"kernel {self.name!r} has no probe fn")
        return list(self._probe(tuple(int(x) for x in problem), str(dtype)))

    def default_config(self) -> Config:
        return self.space.default_config()

    def fit_config(self, config: Config, problem: tuple[int, ...],
                   dtype: str) -> Config:
        """The :meth:`fit` hook's config, or ``config`` without one."""
        if self._fit is None:
            return config
        return self._fit(dict(config), tuple(problem), dtype)

    def __repr__(self) -> str:  # pragma: no cover
        return f"KernelBuilder({self.name!r}, space={self.space!r})"
