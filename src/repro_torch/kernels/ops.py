"""Public entry points for the port's kernels (port of ``repro.kernels.ops``).

Each op routes through a module-level :class:`WisdomKernel`, the runtime
selection + compilation layer (paper §4.5). The tensors' device decides what
runs: the wisdom-selected CUDA kernel for CUDA tensors, its plain PyTorch
version for CPU tensors. Attention belongs to the second port slice.
"""

from __future__ import annotations

import torch

from repro_torch.core import WisdomKernel

from . import advec_u as _advec_mod
from . import diff_uvw as _diff_mod
from . import matmul as _mm_mod

advec_u_kernel = WisdomKernel(_advec_mod.builder)
diff_uvw_kernel = WisdomKernel(_diff_mod.builder)
matmul_kernel = WisdomKernel(_mm_mod.builder)

_ALL_KERNELS = (advec_u_kernel, diff_uvw_kernel, matmul_kernel)


def reload_wisdom() -> None:
    """Invalidate cached wisdom on all ops (after re-tuning)."""
    for k in _ALL_KERNELS:
        k.invalidate()


def pack_scalars(dxi: float, dyi: float, dzi: float,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """The kernels' (1, 4) float32 scalar block [dxi, dyi, dzi, 0]."""
    return torch.tensor([[dxi, dyi, dzi, 0.0]], dtype=torch.float32,
                        device=device)


def advec_u(u, v, w, dxi: float, dyi: float, dzi: float):
    """Advection tendency of u (paper kernel 1)."""
    return advec_u_kernel(u, v, w, pack_scalars(dxi, dyi, dzi, u.device))


def diff_uvw(u, v, w, evisc, dxi: float, dyi: float, dzi: float):
    """Diffusion tendencies (ut, vt, wt) (paper kernel 2)."""
    return diff_uvw_kernel(u, v, w, evisc,
                           pack_scalars(dxi, dyi, dzi, u.device))


def matmul(a, b):
    return matmul_kernel(a, b)
