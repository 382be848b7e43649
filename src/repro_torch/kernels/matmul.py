"""C = A @ B as a CUDA kernel (``csrc/matmul.cu``) for the H100, with a
tunable tiling, software pipeline, split-K and grid order — the quickstart's
kernel. Port of ``repro.kernels.matmul``.

The problem is ``(m, n, k)`` for A ``(m, k)`` times B ``(k, n)``, as in the
reference. The reference clamps blocks to the problem because Pallas blocks
must tile it; the CUDA kernel masks its ragged edges instead, so every config
runs on every shape.

One source, two bodies, chosen by the launch's dtype and shape — never by
trying one and falling back (:func:`plan`):

* ``"simt"``: a pipelined, register-blocked SGEMM in IEEE f32 on the CUDA
  cores. It runs every float32 launch, with 16-byte copies of B when
  ``k % 4 == 0``, ``n % 4 == 0`` and both operands are 16-byte aligned
  (``VEC=1``), 4-byte ones otherwise; and every bfloat16 launch that TMA
  cannot take (reading bf16, summing in f32).
* ``"wgmma"``: TMA + ``wgmma`` on the tensor cores for bfloat16 when
  ``k % 8 == 0``, ``n % 8 == 0`` and both operands are 16-byte aligned:
  TMA's rule that global strides and addresses be multiples of 16 bytes.

The tuning space is Hopper's: ``block_m`` and ``block_n`` (64, 128) set the
output tile; ``block_k`` (8, 16, 32) is the simt body's k depth per stage —
the wgmma body always takes 64 (one 128-byte swizzle row of bf16), so
configs that differ only in ``block_k`` build the same bf16 library;
``stages`` (2, 3, 4) is the depth of the shared-memory ring; ``split_k``
(1, 2, 4) cuts k into block-aligned slices that write f32 partials to a
workspace (``split_k x m x n`` f32, allocated here) summed in a fixed order
by a second kernel; ``grid_order`` picks which tile axis walks
``blockIdx.x``. The space keeps out what the card would refuse in either
body (:func:`card_refusal`), from the byte counts the source uses.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import KernelBuilder, Workload, register
from repro_torch.core.builder import dtype_name, probe_array
from repro_torch.core.device import GPU_H100

from . import ref as _ref
from ._build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
kernel = CudaKernel("matmul", "matmul.cu", "matmul_launch",
                    (_P, _P, _P, _P, _I, _I, _I, _P))


def kernel_of(config) -> CudaKernel:
    """The CUDA kernel a launch in ``config`` runs."""
    return kernel

#: k a wgmma-body tile covers: 64 bf16, one 128-byte swizzle row.
WGMMA_TILE_K = 64
#: f32 accumulators a thread may hold: half of the 255 registers a thread
#: may have, the rest for fragments, addresses and the ring's bookkeeping.
MAX_ACC_REGISTERS = 128
#: Grid extent CUDA allows on the y axis (one tile axis) and the z axis
#: (the split).
_MAX_GRID_YZ = 65535
BODIES = ("simt", "wgmma")


def smem_bytes(config, body: str) -> int:
    """Dynamic shared memory of one block, as ``csrc/matmul.cu`` lays it
    out. simt: ``stages`` tiles of A^T (rows padded by 4 words) and B in
    f32. wgmma: 1024 bytes of alignment slack, ``stages`` bf16 tiles of
    A (block_m x 64) and B (64 x block_n), and two mbarriers a stage."""
    bm, bn, st = config["block_m"], config["block_n"], config["stages"]
    if body == "wgmma":
        return 1024 + st * (bm + bn) * WGMMA_TILE_K * 2 + 2 * st * 8
    return st * config["block_k"] * (bm + 4 + bn) * 4


def acc_registers(config, body: str) -> int:
    """f32 accumulators one thread holds: a (block_m / 16) x (block_n / 16)
    sub-tile (simt), or block_n / 2 of a warpgroup's 64 x block_n (wgmma)."""
    if body == "wgmma":
        return config["block_n"] // 2
    return (config["block_m"] // 16) * (config["block_n"] // 16)


def card_refusal(config, body: str) -> str:
    """Why the H100 would refuse ``config`` in ``body``, or ``""``."""
    smem = smem_bytes(config, body)
    if smem > GPU_H100.smem_per_block:
        return (f"{body} body needs {smem} bytes of shared memory, above "
                f"the {GPU_H100.smem_per_block} a block may have")
    acc = acc_registers(config, body)
    if acc > MAX_ACC_REGISTERS:
        return (f"{body} body holds {acc} accumulators a thread, above "
                f"{MAX_ACC_REGISTERS} of its 255 registers")
    return ""


def fits_card(config) -> bool:
    """The space's restriction: the card takes ``config`` in both bodies."""
    return not any(card_refusal(config, body) for body in BODIES)


builder = KernelBuilder("matmul", source="repro_torch.kernels.matmul")
builder.tune("block_m", (64, 128), default=128)
builder.tune("block_n", (64, 128), default=128)
builder.tune("block_k", (8, 16, 32), default=8)
builder.tune("stages", (2, 3, 4), default=2)
builder.tune("split_k", (1, 2, 4), default=1)
builder.tune("grid_order", ("mnk", "nmk"), default="mnk")
builder.restriction(fits_card)


def choose_body(dtype: str, n: int, k: int, aligned: bool) -> tuple[str, bool]:
    """(body, VEC) for a launch: the shape rule, stated once.

    bfloat16 with ``k % 8 == 0``, ``n % 8 == 0`` and 16-byte aligned
    operands runs the wgmma body (TMA needs 16-byte global strides and
    addresses); any other bfloat16 launch runs the simt body with plain
    loads. float32 runs the simt body, with 16-byte copies of B when
    ``k % 4 == 0``, ``n % 4 == 0`` and the operands are aligned."""
    if dtype == "bfloat16":
        if aligned and k % 8 == 0 and n % 8 == 0:
            return "wgmma", True
        return "simt", False
    return "simt", aligned and k % 4 == 0 and n % 4 == 0


def split_ranges(k: int, tile_k: int,
                 split: int) -> tuple[tuple[int, int], ...]:
    """The [begin, end) range of k each of ``split`` slices covers, as the
    kernel cuts it: whole tiles of ``tile_k``, ``ceil(tiles / split)`` a
    slice; trailing slices may be empty (begin == end)."""
    tiles = -(-k // tile_k)
    per = -(-tiles // split)
    return tuple((min(z * per * tile_k, k), min((z + 1) * per * tile_k, k))
                 for z in range(split))


@dataclass(frozen=True)
class LaunchPlan:
    """What one launch of ``config`` on (m, n, k) runs: computed in Python
    from the same rules and byte counts as ``csrc/matmul.cu``."""

    dtype: str                         # "float32" or "bfloat16"
    body: str                          # "simt" or "wgmma"
    vec: bool                          # the build's VEC define
    grid: tuple[int, int, int]         # (x, y, z = split_k)
    tile_k: int                        # k a tile covers in this body
    smem_bytes: int                    # dynamic shared memory of a block
    workspace_bytes: int               # f32 partials, 0 without split
    k_ranges: tuple[tuple[int, int], ...]
    refusal: str                       # why the card refuses it, or ""


def plan(config, m: int, n: int, k: int, dtype: str,
         aligned: bool = True) -> LaunchPlan:
    """The launch plan of ``config`` on problem (m, n, k) in ``dtype``;
    ``aligned`` says both operands start on 16-byte boundaries."""
    body, vec = choose_body(dtype, n, k, aligned)
    bm, bn, split = config["block_m"], config["block_n"], config["split_k"]
    tm, tn = -(-m // bm), -(-n // bn)
    xy = (tm, tn) if config["grid_order"] == "mnk" else (tn, tm)
    tile_k = WGMMA_TILE_K if body == "wgmma" else config["block_k"]
    return LaunchPlan(
        dtype=dtype, body=body, vec=vec, grid=(*xy, split), tile_k=tile_k,
        smem_bytes=smem_bytes(config, body),
        workspace_bytes=4 * split * m * n if split > 1 else 0,
        k_ranges=split_ranges(k, tile_k, split),
        refusal=card_refusal(config, body))


def defines(config, p: LaunchPlan) -> tuple[tuple[str, int], ...]:
    """The -D defines of the build that runs ``p``. The wgmma body's k
    depth is fixed, so its BLOCK_K is the tile's 64 whatever the config
    says."""
    return (("BLOCK_M", config["block_m"]), ("BLOCK_N", config["block_n"]),
            ("BLOCK_K", p.tile_k), ("STAGES", config["stages"]),
            ("SPLIT_K", config["split_k"]),
            ("GRID_MN", int(config["grid_order"] == "mnk")),
            ("BF16", int(p.dtype == "bfloat16")), ("VEC", int(p.vec)))


@builder.problem_size
def _problem(a, b):
    (m, k), (_, n) = a.shape, b.shape
    return (m, n, k)


def _check(config, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul needs (m, k) @ (k, n), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.device != b.device:
        raise ValueError("matmul operands differ in dtype or device")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"matmul takes float32 or bfloat16, got {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul operands must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    if out_of_range(config, m, n, k):
        raise ValueError(f"matmul problem {(m, n, k)} outside the kernel's "
                         f"range for {config}")


def out_of_range(config, m: int, n: int, k: int) -> bool:
    """Whether CUDA's grid limits or the kernel's 32-bit indices keep it
    from running ``config`` on (m, n, k)."""
    grid_y = (-(-n // config["block_n"]) if config["grid_order"] == "mnk"
              else -(-m // config["block_m"]))
    return (max(grid_y, config["split_k"]) > _MAX_GRID_YZ
            or max(m, n, k) >= 2**31 or min(m, n, k) < 1)


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def launch_plan(config, a: torch.Tensor, b: torch.Tensor) -> LaunchPlan:
    """The plan of ``config`` for these operands (their alignment too)."""
    return _launch_spec(tuple(config[name] for name in builder.space.names),
                        *a.shape, b.shape[1], dtype_name(a.dtype),
                        _aligned(a, b))[0]


@functools.lru_cache(maxsize=4096)
def _launch_spec(values: tuple, m: int, k: int, n: int, dtype: str,
                 aligned: bool) -> tuple[LaunchPlan, tuple]:
    """(plan, defines) of one launch, cached: at the quickstart's size a
    launch's host time is comparable to its kernel's."""
    config = dict(zip(builder.space.names, values))
    p = plan(config, m, n, k, dtype, aligned)
    return p, defines(config, p)


def launch(config, a, b) -> torch.Tensor:
    """A @ B: the CUDA kernel with ``config`` on CUDA tensors, the plain
    version on CPU tensors. A launch the card refuses (shared memory)
    raises :class:`~repro_torch.kernels._build.KernelLaunchError`."""
    _check(config, a, b)
    if a.device.type == "cpu":
        return _ref.matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul: the kernel runs on CUDA tensors, got a "
                         f"{a.device.type} tensor")
    (m, k), n = a.shape, b.shape[1]
    p, defs = _launch_spec(tuple(config[name] for name in builder.space.names),
                           m, k, n, dtype_name(a.dtype), _aligned(a, b))
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    ws = (torch.empty((config["split_k"], m, n), dtype=torch.float32,
                      device=a.device) if p.workspace_bytes else None)
    kernel(defs, p.dtype, a.data_ptr(), b.data_ptr(),
           c.data_ptr(), ws.data_ptr() if ws is not None else None, m, n, k,
           torch.cuda.current_stream(a.device).cuda_stream)
    return c


@builder.build
def _build(config, problem, meta):
    # nvcc: the JIT step, for the body this scenario's shape selects
    lib = (kernel.load(defines(config, plan(config, *problem, meta[0].dtype)))
           if meta[0].device.type == "cuda" else None)

    def run(a, b):
        return launch(config, a, b)

    run.library = lib
    return run


builder.reference(_ref.matmul_ref)


@builder.workload
def _workload(config, problem, dtype):
    """2mnk flops (the reference's count) and the compulsory traffic: A and
    B read once, C written once. The reference re-reads A per column block
    and B per row block, as a TPU does from its VMEM; on the H100 those
    re-reads hit the 50 MB L2, and split-K's f32 partials stay there too at
    the sizes it helps. ``vmem_bytes`` is a block's shared memory in the
    body the shape selects (16-byte aligned operands assumed, as
    ``torch.empty`` gives), ``grid`` the main kernel's blocks. Invalid
    where the launcher would refuse the config or the problem."""
    m, n, k = problem
    p = plan(config, m, n, k, dtype)
    b = 4 if dtype == "float32" else 2
    valid = (dtype in ("float32", "bfloat16") and not p.refusal
             and not out_of_range(config, m, n, k))
    return Workload(
        flops=2.0 * m * n * k, hbm_bytes=float((m * k + k * n + m * n) * b),
        vmem_bytes=p.smem_bytes, grid=p.grid[0] * p.grid[1] * p.grid[2],
        valid=valid)


@builder.probe
def _probe(problem, dtype):
    m, n, k = problem
    rng = np.random.default_rng(0)
    return (probe_array(rng, (m, k), dtype),
            probe_array(rng, (k, n), dtype))


register(builder)
