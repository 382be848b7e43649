"""Shared host-side machinery for the 3-D periodic stencil kernels (advec_u,
diff_uvw): the tuning axes, the defines they compile to, and the checks the
wrappers make before handing pointers to CUDA.

The reference's ``_stencil_common`` exists because TPU blocks cannot overlap:
it cuts each field into five refs (centre plus four ``HALO_BLK``-thick side
slabs) and requires blocks that divide the grid. CUDA blocks read overlapping
and wrapped neighbours directly, so none of that carries over. What does is
the paper's own CUDA tuning space (``repro/kernels/advec_u.py:5-11``): block
size X/Y/Z, the tile factor in z, the unravel permutation and the minimum
number of blocks per SM (``__launch_bounds__``).
"""

from __future__ import annotations

import torch

from repro_torch.core.builder import KernelBuilder

#: Unravel permutation -> (UNRAVEL_A, UNRAVEL_B, UNRAVEL_C): the tile axes
#: (0 = x, 1 = y, 2 = z) the linear block index walks, fastest first.
UNRAVEL = {p: tuple("xyz".index(c) for c in p)
           for p in ("xyz", "xzy", "yxz", "yzx", "zxy", "zyx")}

#: Threads an SM holds at once; ``threads * min_blocks_per_sm`` above it
#: asks ``__launch_bounds__`` for what the card cannot give.
MAX_THREADS_PER_SM = 2048


def add_stencil_space(builder: KernelBuilder) -> None:
    """The paper's CUDA axes, restricted to 32-1024 threads a block."""
    builder.tune("block_size_x", (16, 32, 64, 128, 256), default=32)
    builder.tune("block_size_y", (1, 2, 4, 8, 16), default=4)
    builder.tune("block_size_z", (1, 2, 4), default=1)
    builder.tune("tile_factor_z", (1, 2, 4, 8), default=2)
    builder.tune("unravel_permutation", tuple(UNRAVEL), default="xyz")
    builder.tune("min_blocks_per_sm", (1, 2, 4), default=1)
    builder.restriction(
        "32 <= block_size_x * block_size_y * block_size_z <= 1024")
    builder.restriction(
        f"block_size_x * block_size_y * block_size_z * min_blocks_per_sm"
        f" <= {MAX_THREADS_PER_SM}")


def stencil_defines(config) -> tuple[tuple[str, int], ...]:
    a, b, c = UNRAVEL[config["unravel_permutation"]]
    return (("BLOCK_SIZE_X", config["block_size_x"]),
            ("BLOCK_SIZE_Y", config["block_size_y"]),
            ("BLOCK_SIZE_Z", config["block_size_z"]),
            ("TILE_FACTOR_Z", config["tile_factor_z"]),
            ("UNRAVEL_A", a), ("UNRAVEL_B", b), ("UNRAVEL_C", c),
            ("MIN_BLOCKS_PER_SM", config["min_blocks_per_sm"]))


def check_fields(fields, scal: torch.Tensor) -> None:
    """Raise unless ``fields`` are contiguous (nz, ny, nx) tensors of one
    shape, dtype and device, and ``scal`` a (1, 4) float32 tensor beside
    them. Every axis must hold at least 3 cells (the periodic wrap reaches
    3 cells either way) and the grid fewer than 2**31 points."""
    f0 = fields[0]
    if f0.dim() != 3:
        raise ValueError(f"stencil fields are (nz, ny, nx), got {tuple(f0.shape)}")
    for f in fields:
        if f.shape != f0.shape or f.dtype != f0.dtype or f.device != f0.device:
            raise ValueError("stencil fields differ in shape, dtype or device")
        if not f.is_contiguous():
            raise ValueError("stencil fields must be contiguous")
    if f0.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stencil kernels take float32 or bfloat16, got {f0.dtype}")
    if min(f0.shape) < 3 or f0.numel() >= 2**31:
        raise ValueError(f"grid {tuple(f0.shape)} outside the kernels' range")
    if (tuple(scal.shape) != (1, 4) or scal.dtype != torch.float32
            or scal.device != f0.device or not scal.is_contiguous()):
        raise ValueError("scal must be a contiguous (1, 4) float32 tensor on "
                         "the fields' device")


def require_cuda(t: torch.Tensor, kernel: str) -> None:
    """The CUDA path only takes CUDA tensors; nothing else falls back."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: the kernel runs on CUDA tensors, got a "
                         f"{t.device.type} tensor")
