"""Kernel Launcher in PyTorch on the NVIDIA H100 — the port of ``repro``.

The port mirrors ``src/repro/`` module for module and imports neither JAX
nor ``repro``. Every kernel that ``repro`` wrote in Pallas for the TPU is a
hand-written CUDA kernel here (``kernels/csrc/``), built with nvcc for
``sm_90a`` at first use. A tensor's device decides the path: CUDA tensors
launch the kernel, CPU tensors run its plain PyTorch version. ``repro``
stays the frozen reference that the port's tests hold it to.
"""

__version__ = "0.1.0"
