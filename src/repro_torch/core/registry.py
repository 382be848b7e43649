"""Global kernel registry (port of ``repro.core.registry``).

Kernels register their builders at import time; the tuner CLI and the replay
machinery look kernels up by name (captures store only the kernel name).
"""

from __future__ import annotations

import importlib

from .builder import KernelBuilder

_REGISTRY: dict[str, KernelBuilder] = {}

# Modules that define built-in kernels, imported lazily.
_BUILTIN_KERNEL_MODULES = (
    "repro_torch.kernels.advec_u",
    "repro_torch.kernels.diff_uvw",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.matmul",
)


def register(builder: KernelBuilder) -> KernelBuilder:
    if builder.name in _REGISTRY:
        existing = _REGISTRY[builder.name]
        if existing is not builder and existing.source != builder.source:
            raise ValueError(f"kernel name collision: {builder.name!r}")
    _REGISTRY[builder.name] = builder
    return builder


def unregister(name: str) -> None:
    """Remove a kernel registration (no-op when absent), so a host that
    registers a synthetic kernel (``sandbox.faults``) leaves registry-wide
    iteration (``all_kernels``) clean afterwards."""
    _REGISTRY.pop(name, None)


def load_builtin_kernels() -> None:
    for mod in _BUILTIN_KERNEL_MODULES:
        importlib.import_module(mod)


def get_kernel(name: str) -> KernelBuilder:
    if name not in _REGISTRY:
        load_builtin_kernels()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown kernel {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_kernels() -> dict[str, KernelBuilder]:
    load_builtin_kernels()
    return dict(_REGISTRY)
