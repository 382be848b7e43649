"""Blocked matmul with a tunable (block_m, block_n, block_k) tiling and grid
order, as a CUDA kernel (``csrc/matmul.cu``) for the H100 — the quickstart's
kernel. Port of ``repro.kernels.matmul``.

The problem is ``(m, n, k)`` for A ``(m, k)`` times B ``(k, n)``, as in the
reference. The reference clamps blocks to the problem because Pallas blocks
must tile it; the CUDA kernel masks its ragged edges instead, so every config
runs on every shape and the config alone decides what is compiled.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import KernelBuilder, register
from repro_torch.core.builder import dtype_name, probe_array

from . import ref as _ref
from ._build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
kernel = CudaKernel("matmul", "matmul.cu", "matmul_launch",
                    (_P, _P, _P, _I, _I, _I, _P))

builder = KernelBuilder("matmul", source="repro_torch.kernels.matmul")
builder.tune("block_m", (32, 64, 128), default=64)
builder.tune("block_n", (32, 64, 128), default=64)
builder.tune("block_k", (8, 16, 32), default=16)
builder.tune("grid_order", ("mnk", "nmk"), default="mnk")

#: Grid extent CUDA allows on the y axis, where one tile axis goes.
_MAX_GRID_Y = 65535


@builder.problem_size
def _problem(a, b):
    (m, k), (_, n) = a.shape, b.shape
    return (m, n, k)


def _defines(config) -> tuple[tuple[str, int], ...]:
    return (("BLOCK_M", config["block_m"]), ("BLOCK_N", config["block_n"]),
            ("BLOCK_K", config["block_k"]),
            ("GRID_MN", int(config["grid_order"] == "mnk")))


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
    y_tiles = (-(-n // config["block_n"]) if config["grid_order"] == "mnk"
               else -(-m // config["block_m"]))
    if y_tiles > _MAX_GRID_Y or max(m, n, k) >= 2**31 or min(m, n, k) < 1:
        raise ValueError(f"matmul problem {(m, n, k)} outside the kernel's "
                         f"range for {config}")


def launch(config, a, b) -> torch.Tensor:
    """A @ B: the CUDA kernel with ``config`` on CUDA tensors, the plain
    version on CPU tensors."""
    _check(config, a, b)
    if a.device.type == "cpu":
        return _ref.matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul: the kernel runs on CUDA tensors, got a "
                         f"{a.device.type} tensor")
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    kernel(_defines(config), dtype_name(a.dtype), a.data_ptr(), b.data_ptr(),
           c.data_ptr(), m, n, k,
           torch.cuda.current_stream(a.device).cuda_stream)
    return c


@builder.build
def _build(config, problem, meta):
    lib = (kernel.load(_defines(config))   # nvcc: the JIT step
           if meta[0].device.type == "cuda" else None)

    def run(a, b):
        return launch(config, a, b)

    run.library = lib
    return run


builder.reference(_ref.matmul_ref)


@builder.probe
def _probe(problem, dtype):
    m, n, k = problem
    rng = np.random.default_rng(0)
    return (probe_array(rng, (m, k), dtype),
            probe_array(rng, (k, n), dtype))


register(builder)
