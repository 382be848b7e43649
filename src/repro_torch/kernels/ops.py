"""Public entry points for the port's kernels (port of ``repro.kernels.ops``).

Each op routes through a module-level :class:`WisdomKernel`, the runtime
selection + compilation layer (paper §4.5). The tensors' device decides what
runs: the wisdom-selected CUDA kernel for CUDA tensors, its plain PyTorch
version for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.core import WisdomKernel

from . import advec_u as _advec_mod
from . import diff_uvw as _diff_mod
from . import flash_attention as _fa_mod
from . import matmul as _mm_mod
from . import ref

advec_u_kernel = WisdomKernel(_advec_mod.builder)
diff_uvw_kernel = WisdomKernel(_diff_mod.builder)
matmul_kernel = WisdomKernel(_mm_mod.builder)
fa_causal_kernel = WisdomKernel(_fa_mod.causal_builder)
fa_full_kernel = WisdomKernel(_fa_mod.full_builder)

_ALL_KERNELS = (advec_u_kernel, diff_uvw_kernel, matmul_kernel,
                fa_causal_kernel, fa_full_kernel)


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


def flashable(q, k, *, window=None, softcap=None, scale=None,
              kv_offset: int = 0) -> bool:
    """Whether :func:`attention` sends a call to the flash kernel: the
    reference's predicate (``repro/kernels/ops.py:67-76``) without its two
    backend terms, since the tensors' device decides the path here."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    default_scale = scale is None or abs(scale - D ** -0.5) < 1e-12
    return (window is None and softcap is None and default_scale
            and kv_offset == 0 and Sq == Sk
            and Sq % 128 == 0 and D % 128 == 0)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              softcap: float | None = None, scale: float | None = None,
              kv_offset: int = 0):
    """Multi-head attention, q: (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D).

    Calls that meet :func:`flashable` and whose head dim the kernel takes
    (``flash_attention.HEAD_DIMS``) go to the flash kernel (its plain
    version for CPU tensors); the rest run the full-featured plain
    ``ref.attention_ref`` on the tensors' device, as the reference runs its
    oracle for them."""
    if q.shape[3] not in _fa_mod.HEAD_DIMS or not flashable(
            q, k, window=window, softcap=softcap, scale=scale,
            kv_offset=kv_offset):
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale,
                                 kv_offset=kv_offset)
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    qf = q.reshape(B * Hq, S, D).contiguous()
    kf = k.reshape(B * Hkv, S, D).contiguous()
    vf = v.reshape(B * Hkv, S, D).contiguous()
    kernel = fa_causal_kernel if causal else fa_full_kernel
    return kernel(qf, kf, vf).reshape(B, Hq, S, D)
