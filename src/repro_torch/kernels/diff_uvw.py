"""diff_uvw — the paper's second MicroHH kernel (§5.2): diffusion of (u, v, w)
with a variable eddy viscosity, halo-1 stencil, as tunable CUDA kernels
(``csrc/diff_uvw.cu``) for the H100. Port of ``repro.kernels.diff_uvw``.

``fuse_outputs`` stays an axis of the space: True launches the fused kernel
(inputs read once, three outputs), False the single-field kernel once per
field (evisc read three times). The body axis (see ``_stencil_common``)
reaches both kernels: ``ldg`` or ``tile``, whose fused body stages u, v, w
and evisc in one ring. On CPU tensors the plain PyTorch versions
run: ``diff_uvw_ref`` for the fused variant, ``diff_one_ref`` per field for
the single one.
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

_P, _I = ctypes.c_void_p, ctypes.c_int
fused_kernel = CudaKernel("diff_uvw_fused", "diff_uvw.cu", "diff_uvw_fused",
                          (_P,) * 8 + (_I, _I, _I, _P))
single_kernel = CudaKernel("diff_uvw_single", "diff_uvw.cu",
                           "diff_uvw_single", (_P,) * 4 + (_I, _I, _I, _P))


def kernel_of(config) -> CudaKernel:
    """The CUDA kernel a launch in ``config`` runs: the fused one once, or
    the single-field one three times."""
    return fused_kernel if config["fuse_outputs"] else single_kernel


builder = KernelBuilder("diff_uvw", source="repro_torch.kernels.diff_uvw")
add_stencil_space(builder, kernel_of)
builder.tune("fuse_outputs", (True, False), default=True)


def plan(config, shape, dtype: str) -> StencilPlan:
    """The launch plan of one of ``config``'s launches (the fused kernel's,
    or one of the single-field kernel's three) on a (nz, ny, nx) grid in
    ``dtype``, in pure Python."""
    return _plan(kernel_of(config).name, config, shape, dtype)


@builder.problem_size
def _problem(u, v, w, evisc, scal):
    return tuple(int(d) for d in u.shape)


def launch_fused(config, u, v, w, evisc, scal):
    """(ut, vt, wt) in one pass: the fused CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    check_fields((u, v, w, evisc), scal)
    if u.device.type == "cpu":
        return _ref.diff_uvw_ref(u, v, w, evisc, scal)
    require_cuda(u, "diff_uvw_fused")
    outs = tuple(torch.empty_like(u) for _ in range(3))
    nz, ny, nx = u.shape
    fused_kernel(stencil_defines(config), dtype_name(u.dtype),
                 u.data_ptr(), v.data_ptr(), w.data_ptr(), evisc.data_ptr(),
                 scal.data_ptr(), *(o.data_ptr() for o in outs), nz, ny, nx,
                 torch.cuda.current_stream(u.device).cuda_stream,
                 body=config["body"])
    return outs


def launch_single(config, f, evisc, scal):
    """One field's tendency: the single-field CUDA kernel on CUDA tensors,
    the plain version on CPU tensors."""
    check_fields((f, evisc), scal)
    if f.device.type == "cpu":
        return _ref.diff_one_ref(f, evisc, scal)
    require_cuda(f, "diff_uvw_single")
    out = torch.empty_like(f)
    nz, ny, nx = f.shape
    single_kernel(stencil_defines(config), dtype_name(f.dtype),
                  f.data_ptr(), evisc.data_ptr(), scal.data_ptr(),
                  out.data_ptr(), nz, ny, nx,
                  torch.cuda.current_stream(f.device).cuda_stream,
                  body=config["body"])
    return out


@builder.build
def _build(config, problem, meta):
    lib = (fused_kernel.load(stencil_defines(config))   # nvcc: the JIT step
           if meta[0].device.type == "cuda" else None)

    if config["fuse_outputs"]:
        def run(u, v, w, evisc, scal):
            return launch_fused(config, u, v, w, evisc, scal)
    else:
        def run(u, v, w, evisc, scal):
            check_fields((u, v, w, evisc), scal)
            return tuple(launch_single(config, f, evisc, scal)
                         for f in (u, v, w))

    run.library = lib
    return run


builder.reference(_ref.diff_uvw_ref)


@builder.workload
def _workload(config, problem, dtype):
    """27 flops a point a field (the reference's count) for three fields.
    Fused: u, v, w and evisc read once, three tendencies written once.
    Unfused, one call is three launches and nine fields: each reads its
    field and evisc and writes its tendency (``stencil_workload`` says why
    no halo factor)."""
    flops = 3 * _ref.DIFF_FLOPS_PER_POINT_PER_FIELD
    if config["fuse_outputs"]:
        return stencil_workload("diff_uvw_fused", config, problem, dtype,
                                flops, fields=7)
    return stencil_workload("diff_uvw_single", config, problem, dtype,
                            flops, fields=9, launches=3)


@builder.probe
def _probe(problem, dtype):
    rng = np.random.default_rng(0)
    u, v, w = (probe_array(rng, problem, dtype) for _ in range(3))
    # eddy viscosity is physically nonnegative
    evisc = probe_array(rng, problem, dtype).abs() + torch.tensor(
        0.1, dtype=u.dtype)
    scal = torch.tensor([[1.1, 0.9, 1.3, 0.0]], dtype=torch.float32)
    return u, v, w, evisc, scal


register(builder)
