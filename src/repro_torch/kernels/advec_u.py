"""advec_u — the paper's first MicroHH kernel (§5.2): flux-form advection
with 5th-order interpolation on a periodic 3-D grid, as a tunable CUDA kernel
(``csrc/advec_u.cu``) for the H100. Port of ``repro.kernels.advec_u``.

The tuning space is the paper's CUDA one (see ``_stencil_common``), not the
reference's TPU space, with a body axis: ``ldg`` (a thread walks a few
points of its column, every neighbour read through ``__ldg``) and ``tile``
(the default: blocks of 64 x 4 threads, two an SM, march strips of 128
planes, staged in shared memory by ``cp.async``). On CPU tensors the kernel's plain PyTorch version
runs; on CUDA tensors the CUDA kernel, built for the config, or an error.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import KernelBuilder, register
from repro_torch.core.builder import dtype_name, probe_array

from . import ref as _ref
from ._build import CudaKernel
from ._stencil_common import (StencilPlan, add_stencil_space, check_fields,
                              require_cuda, stencil_defines, stencil_workload)
from ._stencil_common import plan as _plan

_P = ctypes.c_void_p
kernel = CudaKernel("advec_u", "advec_u.cu", "advec_u_launch",
                    (_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, _P))


def kernel_of(config) -> CudaKernel:
    """The CUDA kernel a launch in ``config`` runs."""
    return kernel

builder = KernelBuilder("advec_u", source="repro_torch.kernels.advec_u")
add_stencil_space(builder, kernel_of, body="tile", block=(64, 4), strip=128,
                  min_blocks=2)


def plan(config, shape, dtype: str) -> StencilPlan:
    """The launch plan of ``config`` on a (nz, ny, nx) grid in ``dtype``:
    body, grid, strip and shared memory, in pure Python."""
    return _plan("advec_u", config, shape, dtype)


@builder.problem_size
def _problem(u, v, w, scal):
    return tuple(int(d) for d in u.shape)


def launch(config, u, v, w, scal) -> torch.Tensor:
    """ut for (u, v, w): the CUDA kernel with ``config`` on CUDA tensors,
    the plain version on CPU tensors."""
    check_fields((u, v, w), scal)
    if u.device.type == "cpu":
        return _ref.advec_u_ref(u, v, w, scal)
    require_cuda(u, "advec_u")
    out = torch.empty_like(u)
    nz, ny, nx = u.shape
    kernel(stencil_defines(config), dtype_name(u.dtype),
           u.data_ptr(), v.data_ptr(), w.data_ptr(), scal.data_ptr(),
           out.data_ptr(), nz, ny, nx,
           torch.cuda.current_stream(u.device).cuda_stream,
           body=config["body"])
    return out


@builder.build
def _build(config, problem, meta):
    if meta[0].device.type == "cuda":
        lib = kernel.load(stencil_defines(config))   # nvcc: the JIT step
    else:
        lib = None

    def run(u, v, w, scal):
        return launch(config, u, v, w, scal)

    run.library = lib
    return run


builder.reference(_ref.advec_u_ref)


@builder.workload
def _workload(config, problem, dtype):
    """78 flops a point (the reference's count); u, v, w read once and ut
    written once (``stencil_workload`` says why no halo factor)."""
    return stencil_workload("advec_u", config, problem, dtype,
                            _ref.ADVEC_FLOPS_PER_POINT, fields=4)


@builder.probe
def _probe(problem, dtype):
    rng = np.random.default_rng(0)
    u, v, w = (probe_array(rng, problem, dtype) for _ in range(3))
    scal = torch.tensor([[1.1, 0.9, 1.3, 0.0]], dtype=torch.float32)
    return u, v, w, scal


register(builder)
