"""Shared host-side machinery for the 3-D periodic stencil kernels (advec_u,
diff_uvw): the tuning axes, the defines they compile to, the launch plan of
each body and the checks the wrappers make before handing pointers to CUDA.

The reference's ``_stencil_common`` exists because TPU blocks cannot overlap:
it cuts each field into five refs (centre plus four ``HALO_BLK``-thick side
slabs) and requires blocks that divide the grid. CUDA blocks read overlapping
and wrapped neighbours directly, so none of that carries over. What does is
the paper's own CUDA tuning space (``repro/kernels/advec_u.py:5-11``): block
size X/Y/Z, the tile factor in z, the unravel permutation and the minimum
number of blocks per SM (``__launch_bounds__``).

The space's ``body`` axis picks one of two CUDA bodies of each kernel
(advec_u, diff_uvw_fused, diff_uvw_single), compiled one per build
(``-DTILE``):

* ``"ldg"``: each thread walks ``tile_factor_z`` points of one (x, y) column
  and reads every neighbour through ``__ldg`` (``csrc/advec_u.cu``,
  ``csrc/diff_uvw.cu``);
* ``"tile"``: a 2-D block marches a strip of ``strip_z`` planes, staging
  each plane with its halo in shared memory by ``cp.async`` and keeping its
  columns' z neighbours in registers (``csrc/stencil_tile.cuh``).

Restrictions pin the axes a body does not read (``strip_z`` for ldg;
``block_size_z`` and ``tile_factor_z`` for tile), so no two valid configs
build the same kernel, and keep out tile configs whose shared memory the
card cannot give (:func:`plan`).
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import torch

from repro_torch.core.builder import KernelBuilder
from repro_torch.core.device import GPU_H100
from repro_torch.core.workload import Workload

#: Unravel permutation -> (UNRAVEL_A, UNRAVEL_B, UNRAVEL_C): the tile axes
#: (0 = x, 1 = y, 2 = z) the linear block index walks, fastest first.
UNRAVEL = {p: tuple("xyz".index(c) for c in p)
           for p in ("xyz", "xzy", "yxz", "yzx", "zxy", "zyx")}

#: Threads an SM holds at once; ``threads * min_blocks_per_sm`` above it
#: asks ``__launch_bounds__`` for what the card cannot give.
MAX_THREADS_PER_SM = 2048
#: Shared memory of an H100 SM, and what the card keeps of it for each
#: resident block beside the block's own.
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1024

BODIES = ("ldg", "tile")
#: Planes a tile block has in flight while it computes one
#: (``tile::AHEAD``).
TILE_AHEAD = 2
#: The value ``strip_z`` is pinned to where the body does not read it, and
#: ``block_size_z`` / ``tile_factor_z`` where the tile body does not.
STRIP_PIN = 64
BLOCK_Z_PIN, TILE_FACTOR_PIN = 1, 2

#: What the tile body of each kernel stages: its radius in z, and for each
#: field the (y, x) halo it stages (``tile::Stage<T, HY, HX>``).
TILE_STENCILS = {
    "advec_u": (3, ((3, 3), (1, 0), (0, 0))),      # u, v, w
    "diff_uvw_fused": (1, ((1, 1),) * 4),          # u, v, w, evisc
    "diff_uvw_single": (1, ((1, 1), (1, 1))),      # f, evisc
}


def add_stencil_space(builder: KernelBuilder, kernel_of: Callable,
                      body: str = "ldg", block=(32, 4), strip: int = STRIP_PIN,
                      min_blocks: int = 1) -> None:
    """The paper's CUDA axes, restricted to 32-1024 threads a block, and
    the body axis. ``kernel_of(config)`` is the CUDA kernel a config
    launches (its tile body's shared memory bounds the space); ``body``,
    ``block`` (x, y), ``strip`` and ``min_blocks`` are the defaults."""
    builder.tune("body", BODIES, default=body)
    builder.tune("block_size_x", (16, 32, 64, 128, 256), default=block[0])
    builder.tune("block_size_y", (1, 2, 4, 8, 16), default=block[1])
    builder.tune("block_size_z", (1, 2, 4), default=BLOCK_Z_PIN)
    builder.tune("tile_factor_z", (1, 2, 4, 8), default=TILE_FACTOR_PIN)
    # strips each measured grid prefers: 128 at most, 64 for K1 and 32 for
    # K2b at 256^3 bf16; 16 was the fastest of none (tools/stencil_sweep.py)
    builder.tune("strip_z", (32, 64, 128), default=strip)
    builder.tune("unravel_permutation", tuple(UNRAVEL), default="xyz")
    builder.tune("min_blocks_per_sm", (1, 2, 4), default=min_blocks)
    builder.restriction(
        "32 <= block_size_x * block_size_y * block_size_z <= 1024")
    builder.restriction(
        f"block_size_x * block_size_y * block_size_z * min_blocks_per_sm"
        f" <= {MAX_THREADS_PER_SM}")
    builder.restriction(f"body == 'tile' or strip_z == {STRIP_PIN}")
    # tile: 2-D blocks of at least 2 rows, and at most 1024 threads an SM
    # by launch bounds, so a thread may hold 64 registers, where the tile
    # kernels spill nothing (tools/stencil_ptxas.py builds each block
    # shape at that bound and says so)
    builder.restriction(
        f"body == 'ldg' or (block_size_z == {BLOCK_Z_PIN} and tile_factor_z"
        f" == {TILE_FACTOR_PIN} and block_size_y >= 2 and block_size_x *"
        f" block_size_y * min_blocks_per_sm <= 1024)")

    def tile_fits_card(config) -> bool:
        return config["body"] == "ldg" or not plan(
            kernel_of(config).name, config, (64, 64, 64), "float32").refusal

    builder.restriction(tile_fits_card)


def stencil_defines(config) -> tuple[tuple[str, int], ...]:
    """The -D defines of the build that runs ``config``: the ldg body's
    eight, TILE, and the tile body's STRIP_Z."""
    a, b, c = UNRAVEL[config["unravel_permutation"]]
    tile = config["body"] == "tile"
    return (("BLOCK_SIZE_X", config["block_size_x"]),
            ("BLOCK_SIZE_Y", config["block_size_y"]),
            ("BLOCK_SIZE_Z", config["block_size_z"]),
            ("TILE_FACTOR_Z", config["tile_factor_z"]),
            ("UNRAVEL_A", a), ("UNRAVEL_B", b), ("UNRAVEL_C", c),
            ("MIN_BLOCKS_PER_SM", config["min_blocks_per_sm"]),
            ("TILE", int(tile)),
            *((("STRIP_Z", config["strip_z"]),) if tile else ()))


# ------------------------------------------------------------------ plan

@dataclass(frozen=True)
class StencilPlan:
    """What one launch of a stencil config runs, computed in Python from
    the same rules and byte counts as the CUDA sources."""

    kernel: str                      # "advec_u", "diff_uvw_fused", ...
    body: str                        # "ldg" or "tile"
    dtype: str
    shape: tuple[int, int, int]      # (nz, ny, nx)
    block: tuple[int, int, int]      # threads (x, y, z)
    tile: tuple[int, int, int]       # points a block covers (x, y, z)
    grid: tuple[int, int, int]       # blocks along (x, y, z)
    staged_planes: int               # tile: planes a strip stages (0: ldg)
    ring: int                        # tile: buffers of each field's ring
    smem_bytes: int                  # dynamic shared memory of a block
    refusal: str                     # why the card refuses it, or ""

    def block_extent(self, bx: int, by: int, bz: int):
        """The [begin, end) ranges of (x, y, z) block (bx, by, bz) writes."""
        return tuple((b * t, min((b + 1) * t, n)) for b, t, n in
                     zip((bx, by, bz), self.tile, self.shape[::-1]))


def chunk(dtype: str) -> int:
    """Elements of one 16-byte copy."""
    return 16 // {"float32": 4, "bfloat16": 2}[dtype]


def stage_dims(halo: tuple[int, int], block_x: int, block_y: int,
               dtype: str) -> tuple[int, int, int]:
    """(rows, pitch, px) of one field's staged plane (``tile::Stage``):
    rows y0 - HY .. y0 + block_y + HY - 1, columns x0 - px .. x0 + block_x
    + px - 1, px one chunk where the stencil reaches across x."""
    hy, hx = halo
    px = chunk(dtype) if hx else 0
    return block_y + 2 * hy, block_x + 2 * px, px


def plan(kernel: str, config, shape, dtype: str) -> StencilPlan:
    """The launch plan of ``config`` for ``kernel`` on a (nz, ny, nx)
    grid in ``dtype``. Whether a tile launch copies by 16-byte chunks or
    element by element the CUDA launcher decides from nx and the fields'
    addresses (``tile::vectorizable``)."""
    nz, ny, nx = shape
    bx, by = config["block_size_x"], config["block_size_y"]
    if config["body"] == "ldg":
        bz = config["block_size_z"]
        tile = (bx, by, bz * config["tile_factor_z"])
        block = (bx, by, bz)
        staged = ring = smem = 0
        body = "ldg"
    else:
        radius, halos = TILE_STENCILS[kernel]
        tile = (bx, by, config["strip_z"])
        block = (bx, by, 1)
        ring = radius + 1 + TILE_AHEAD
        elem = 4 if dtype == "float32" else 2
        smem = ring * elem * sum(r * p for r, p, _ in
                                 (stage_dims(h, bx, by, dtype)
                                  for h in halos))
        staged = min(config["strip_z"], nz) + 2 * radius
        body = "tile"
    grid = tuple(-(-n // t) for n, t in zip((nx, ny, nz), tile))
    refusal = ""
    per_sm = config["min_blocks_per_sm"] * (smem + SMEM_RESERVED_PER_BLOCK)
    if smem > GPU_H100.smem_per_block:
        refusal = (f"{body} body needs {smem} bytes of shared memory, above "
                   f"the {GPU_H100.smem_per_block} a block may have")
    elif smem and per_sm > SMEM_PER_SM:
        refusal = (f"{config['min_blocks_per_sm']} blocks of {smem} bytes "
                   f"need {per_sm} bytes of an SM's {SMEM_PER_SM}")
    return StencilPlan(kernel, body, dtype, tuple(shape), block, tile, grid,
                       staged, ring, smem, refusal)


# -------------------------------------------------------------- workload

#: Bytes of the (1, 4) float32 ``scal`` block every stencil reads.
SCAL_BYTES = 16


def stencil_workload(kernel: str, config, problem, dtype: str,
                     flops_per_point: int, fields: int,
                     launches: int = 1) -> Workload:
    """The hardware demand of one call of ``launches`` launches of
    ``kernel`` (its :func:`plan`) in ``config``: ``flops_per_point`` over
    the grid, and the compulsory traffic — ``fields`` grid fields each
    read or written once, plus ``scal``.

    The reference's stencil workloads add halo and re-fetch factors
    (``reuse``, per-block slabs) because a TPU reuses only what sits in
    its VMEM. On the H100 the neighbour blocks' halos and the tiles' re-reads
    hit the 50 MB L2, so the floor the card can reach is the compulsory
    traffic; ``vmem_bytes`` is one block's shared memory and ``grid`` the
    blocks launched. Invalid where the launcher refuses the config or the
    grid (:func:`plan`'s refusal, :func:`check_fields`' range and dtypes).
    """
    if dtype not in ("float32", "bfloat16"):
        return Workload(0, 0, 0, 0, valid=False)
    p = plan(kernel, config, problem, dtype)
    pts = p.shape[0] * p.shape[1] * p.shape[2]
    elem = 4 if dtype == "float32" else 2
    return Workload(
        flops=float(flops_per_point * pts),
        hbm_bytes=float(fields * pts * elem + SCAL_BYTES),
        vmem_bytes=p.smem_bytes,
        grid=launches * p.grid[0] * p.grid[1] * p.grid[2],
        valid=not p.refusal and min(p.shape) >= 3 and pts < 2**31)


# ------------------------------------------------------------------ checks

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
