"""Flash attention (forward) as a CUDA kernel (``csrc/flash_attention.cu``)
for the H100, with a tunable (block_q, block_k, threads) tiling — the LM
stack's hot spot. Port of ``repro.kernels.flash_attention``.

Layout as in the reference: heads are flattened into the leading axis,
q: (B*Hq, S, D), k/v: (B*Hkv, S, D); the kernel maps query head bh to kv
row bh // (BH // BHkv), so grouped kv is never materialised. The problem is
``(BH, BHkv, S, D)``, so captures and wisdom keep the reference's format.

Two builders are registered (causal / full), as in the reference: causality
changes the problem's work, not just a value, so they tune and store
wisdom independently. One CUDA source serves both, with ``-DCAUSAL=0/1``,
and one launch counter (``kernel.launches``) counts both.

The tuning space is Hopper's, not the TPU's (``dim_semantics`` means
nothing here): query rows a block owns, key rows a shared-memory tile
holds, and threads a block. Each warp owns 16 or 32 query rows. The space
refuses configs that need more shared memory than a block may have
(227 KB, ``core/device.py``'s ``gpu-h100`` spec) in float32 at D = 128, and
two m16 tiles per warp with 128-key tiles, whose accumulators would not
fit in registers. The head dimension is compiled in (``-DHEAD_DIM``), so a
config is built once per D it meets; D is 128 or 256 (:data:`HEAD_DIMS`). On CPU tensors the plain version
(``ref.flash_attention_ref_factory``) runs; on CUDA tensors the kernel, or
an error.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import KernelBuilder, register
from repro_torch.core.builder import dtype_name, probe_array
from repro_torch.core.device import GPU_H100

from . import ref as _ref
from ._build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
kernel = CudaKernel("flash_attention", "flash_attention.cu",
                    "flash_attention_launch",
                    (_P, _P, _P, _P, _I, _I, _I, _I, _P))

#: Head dims the kernel takes, and the card's tests check: 128 (the LM
#: slice's) and 256. ``ops.flashable`` routes any multiple of 128, so a
#: larger one raises on the card rather than run untested.
HEAD_DIMS = (128, 256)
#: The head dim the space's shared-memory restriction is checked at.
SPACE_HEAD_DIM = 128
#: Grid extent CUDA allows on the y axis, where the flattened heads go.
_MAX_GRID_Y = 65535


def smem_bytes(config, head_dim: int, dtype: str) -> int:
    """Dynamic shared memory of one block: the Q tile and one K and one V
    tile, rows padded as ``csrc/flash_attention.cu`` pads them."""
    rows = config["block_q"] + 2 * config["block_k"]
    if dtype == "bfloat16":
        return rows * (head_dim + 8) * 2
    return rows * (head_dim + 1) * 4


def row_l2_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest relative L2 error of one output row (one query of one
    head): ``|got - want| / |want|`` over the head dim, in float64. A row
    that ``want`` leaves at 0 (fully masked) counts its error's norm."""
    g = got.to(torch.float64).reshape(-1, got.shape[-1])
    w = want.to(torch.float64).reshape(-1, want.shape[-1])
    den = w.norm(dim=-1)
    return float(((g - w).norm(dim=-1) / torch.where(den > 0, den, 1.0))
                 .max())


#: The largest :func:`row_l2_error` a kernel output may have against the
#: plain version, besides the tuner's allclose. The allclose scales its
#: atol by max|ref|, which causal rows near the start (a copy of one v row)
#: set far above the late rows' values, so it cannot see a fault confined
#: to late rows; this bound can. bfloat16: rounding P and the output to
#: 8-bit mantissas gives errors of a few 1e-3 a row.
ROW_L2_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def defines(config, causal: bool, head_dim: int) -> tuple[tuple[str, int], ...]:
    return (("BLOCK_Q", config["block_q"]), ("BLOCK_K", config["block_k"]),
            ("THREADS", config["threads"]), ("CAUSAL", int(causal)),
            ("HEAD_DIM", head_dim))


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q (BH, S, D) and k, v (BHkv, S, D) are contiguous
    float32 or bfloat16 tensors of one dtype and device, with BH a multiple
    of BHkv and D in :data:`HEAD_DIMS`."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash attention needs q (BH, S, D) and k, v "
                         f"(BHkv, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, d = q.shape
    bhkv = k.shape[0]
    if tuple(k.shape[1:]) != (s, d):
        raise ValueError(f"k/v rows {tuple(k.shape[1:])} differ from q's "
                         f"{(s, d)}")
    if len({q.dtype, k.dtype, v.dtype}) != 1 or \
            len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash attention operands differ in dtype or device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention operands must be contiguous")
    if bhkv < 1 or bh % bhkv or s < 1:
        raise ValueError(f"flash attention: BH={bh} is not a multiple of "
                         f"BHkv={bhkv}, or S={s} is empty")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention takes head dims {HEAD_DIMS}, "
                         f"got {d}")


def launch(config, q, k, v, *, causal: bool) -> torch.Tensor:
    """Attention over flattened heads: the CUDA kernel with ``config`` on
    CUDA tensors, the plain version on CPU tensors."""
    check_args(q, k, v)
    if q.device.type == "cpu":
        return _ref.flash_attention_ref_factory(causal)(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: the kernel runs on CUDA tensors, "
                         f"got a {q.device.type} tensor")
    bh, s, d = q.shape
    if bh > _MAX_GRID_Y or bh * s * d >= 2**31 or \
            any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"flash attention problem {(bh, k.shape[0], s, d)} "
                         f"outside the kernel's range, or an operand not "
                         f"16-byte aligned")
    o = torch.empty_like(q)
    kernel(defines(config, causal, d), dtype_name(q.dtype), q.data_ptr(),
           k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, k.shape[0], s, d,
           torch.cuda.current_stream(q.device).cuda_stream)
    return o


def _make_builder(causal: bool) -> KernelBuilder:
    name = "flash_attention_causal" if causal else "flash_attention_full"
    b = KernelBuilder(name, source="repro_torch.kernels.flash_attention")
    b.tune("block_q", (32, 64, 128, 256), default=64)
    b.tune("block_k", (32, 64, 128), default=64)
    b.tune("threads", (64, 128, 256), default=128)
    # 16 or 32 query rows per warp
    b.restriction("block_q * 32 in (16 * threads, 32 * threads)")
    # two m16 tiles per warp hold scores and output in registers only up
    # to 64-key tiles
    b.restriction("block_q * 32 == 16 * threads or block_k <= 64")
    b.restriction(f"(block_q + 2 * block_k) * {(SPACE_HEAD_DIM + 1) * 4}"
                  f" <= {GPU_H100.smem_per_block}")

    @b.problem_size
    def _problem(q, k, v):
        bh, s, d = q.shape
        return (int(bh), int(k.shape[0]), int(s), int(d))

    @b.build
    def _build(config, problem, meta):
        d = problem[3]
        if d not in HEAD_DIMS:
            raise ValueError(f"{name}: head dim {d} is not one of "
                             f"{HEAD_DIMS}")
        lib = (kernel.load(defines(config, causal, d))   # nvcc: the JIT step
               if meta[0].device.type == "cuda" else None)

        def run(q, k, v):
            return launch(config, q, k, v, causal=causal)

        run.library = lib
        return run

    b.reference(_ref.flash_attention_ref_factory(causal))

    @b.probe
    def _probe(problem, dtype):
        bh, bhkv, s, d = problem
        rng = np.random.default_rng(0)
        scale = 1.0 / (d ** 0.5)
        return (probe_array(rng, (bh, s, d), dtype, scale),
                probe_array(rng, (bhkv, s, d), dtype, scale),
                probe_array(rng, (bhkv, s, d), dtype, scale))

    register(b)
    return b


causal_builder = _make_builder(True)
full_builder = _make_builder(False)
