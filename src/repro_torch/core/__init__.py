"""Kernel Launcher core in PyTorch — the port of ``repro.core``.

Public API (mirrors the C++ library's surface, paper §4):

    builder = KernelBuilder("vector_add")
    builder.tune("block_size", [128, 256, 512])
    @builder.problem_size
    def _(c, a, b, n): ...
    @builder.build
    def _(config, problem, meta): ...   # -> launch callable (nvcc build)
    kernel = WisdomKernel(builder)
    out = kernel(c, a, b, n)            # capture/select/compile/launch
"""

from .builder import (ArgsMeta, KernelBuilder, TensorMeta, args_meta,
                      dtype_name, torch_dtype)
from .capture import (Capture, capture_dir, capture_requested, list_captures,
                      load_capture, to_numpy, to_torch, write_capture,
                      CAPTURE_ENV)
from .compile_cache import CompileCache, LaunchStats
from .device import (DEVICES, DeviceSpec, current_device, current_device_kind,
                     get_device, resolve_device, GPU_H100, DEVICE_ENV)
from .param import Config, ConfigSpace, TunableParam
from .registry import all_kernels, get_kernel, load_builtin_kernels, register
from .wisdom import (Wisdom, WisdomIndex, WisdomRecord, WisdomVersionError,
                     WISDOM_VERSION, make_provenance, default_wisdom_dir,
                     merge_lineage, migrate_doc, doc_version)
from .wisdom_kernel import WisdomKernel
from .workload import Workload

__all__ = [
    "ArgsMeta", "KernelBuilder", "TensorMeta", "args_meta", "dtype_name",
    "torch_dtype",
    "Capture", "capture_dir", "capture_requested", "list_captures",
    "load_capture", "to_numpy", "to_torch", "write_capture", "CAPTURE_ENV",
    "CompileCache", "LaunchStats",
    "DEVICES", "DeviceSpec", "current_device", "current_device_kind",
    "get_device", "resolve_device", "GPU_H100", "DEVICE_ENV",
    "Config", "ConfigSpace", "TunableParam",
    "all_kernels", "get_kernel", "load_builtin_kernels", "register",
    "Wisdom", "WisdomIndex", "WisdomRecord", "WisdomVersionError",
    "WISDOM_VERSION",
    "make_provenance", "default_wisdom_dir", "merge_lineage", "migrate_doc",
    "doc_version",
    "WisdomKernel",
    "Workload",
]
