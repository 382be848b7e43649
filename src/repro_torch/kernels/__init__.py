"""Hand-written CUDA kernels for the H100 (advec_u, diff_uvw, matmul, flash
attention), each a KernelBuilder registered with the port's Kernel Launcher
core, with its plain PyTorch version in ``ref``; ``ops`` holds the public
entry points and ``_build`` compiles the sources under ``csrc/`` with nvcc.
"""

from . import ops, ref  # noqa: F401

__all__ = ["ops", "ref"]
