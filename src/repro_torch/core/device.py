"""Device descriptors — the port of ``repro.core.device``.

Wisdom records are keyed by (device *kind*, device *family*), the paper's
(GPU, architecture) pair. The kind of the active card comes from
``torch.cuda.get_device_name()``; ``KERNEL_LAUNCHER_DEVICE`` still
overrides it. The TPU, A100/A4000 and CPU specs are the reference's own,
kept so that selection over a wisdom file gives the same families (and so
the same fallback tiers) in both packages.

What the port adds is a real ``gpu-h100`` spec in family ``gpu-hopper``,
with its peaks from NVIDIA's H100 SXM data sheet. The reference knows only
the A100 and the A4000, and turns an H100 into an ``estimated`` clone of
the A100. On Hopper the feasibility bound for one block is its shared
memory (227 KB) and the SM's registers, not the L2 size that the
reference's ``vmem_bytes`` models for GPUs; the H100 spec says so in
``smem_per_block`` and ``regs_per_sm``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

import torch

DEVICE_ENV = "KERNEL_LAUNCHER_DEVICE"

#: Device backends a spec can declare.
BACKENDS = ("tpu", "gpu", "cpu")


@dataclass(frozen=True)
class DeviceSpec:
    kind: str            # e.g. "gpu-h100"
    family: str          # e.g. "gpu-hopper"
    flops_bf16: float    # peak FLOP/s, bf16 on the MXU / tensor cores
    flops_f32: float     # peak FLOP/s, f32 (outside the tensor cores on GPUs)
    hbm_bw: float        # device-memory bytes/s
    vmem_bytes: int      # per-core VMEM (TPU) / on-chip capacity (GPU)
    ici_bw: float        # per-link interconnect bytes/s
    program_overhead: float  # seconds of fixed overhead per grid program
    num_cores: int = 1
    backend: str = "tpu"
    #: True when the peak numbers are guesses (unknown hardware cloned
    #: from a per-backend baseline), not a spec'd part.
    estimated: bool = False
    matmul_granule: int = 128
    vector_ratio: float = 8.0
    #: Shared memory one CUDA block may use, bytes (0: not a CUDA part).
    smem_per_block: int = 0
    #: 32-bit registers per SM (0: not a CUDA part).
    regs_per_sm: int = 0


TPU_V5E = DeviceSpec(
    kind="tpu-v5e", family="tpu-v5",
    flops_bf16=197e12, flops_f32=98.5e12,
    hbm_bw=819e9, vmem_bytes=16 * 2**20, ici_bw=50e9,
    program_overhead=1.2e-6,
)
TPU_V4 = DeviceSpec(
    kind="tpu-v4", family="tpu-v4",
    flops_bf16=275e12, flops_f32=137.5e12,
    hbm_bw=1228e9, vmem_bytes=32 * 2**20, ici_bw=100e9,
    program_overhead=1.0e-6,
)
TPU_V5P = DeviceSpec(
    kind="tpu-v5p", family="tpu-v5p",
    flops_bf16=459e12, flops_f32=229.5e12,
    hbm_bw=2765e9, vmem_bytes=64 * 2**20, ici_bw=200e9,
    program_overhead=1.0e-6,
)
TPU_V6E = DeviceSpec(
    kind="tpu-v6e", family="tpu-v6",
    flops_bf16=918e12, flops_f32=459e12,
    hbm_bw=1640e9, vmem_bytes=64 * 2**20, ici_bw=100e9,
    program_overhead=1.1e-6,
)
GPU_A100 = DeviceSpec(
    kind="gpu-a100", family="gpu-ampere",
    flops_bf16=312e12, flops_f32=156e12,
    hbm_bw=1555e9, vmem_bytes=40 * 2**20, ici_bw=600e9,
    program_overhead=2.2e-6,
    backend="gpu", matmul_granule=16, vector_ratio=8.0,
)
GPU_A4000 = DeviceSpec(
    kind="gpu-a4000", family="gpu-ampere",
    flops_bf16=76.7e12, flops_f32=38.3e12,
    hbm_bw=448e9, vmem_bytes=4 * 2**20, ici_bw=32e9,
    program_overhead=3.0e-6,
    backend="gpu", matmul_granule=16, vector_ratio=2.0,
)
# NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16 on the tensor cores,
# 67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s HBM3, 450 GB/s NVLink each
# way, 132 SMs with 227 KB of shared memory per block and 64 K registers
# per SM. Those peaks assume the full 700 W power limit. No per-program
# overhead was measured for this part; no ported module reads it yet.
GPU_H100 = DeviceSpec(
    kind="gpu-h100", family="gpu-hopper",
    flops_bf16=989e12, flops_f32=67e12,
    hbm_bw=3.35e12, vmem_bytes=232_448, ici_bw=450e9,
    program_overhead=0.0, num_cores=132,
    backend="gpu", matmul_granule=16, vector_ratio=989 / 67,
    smem_per_block=232_448, regs_per_sm=65_536,
)
CPU_HOST = DeviceSpec(
    kind="cpu", family="cpu",
    flops_bf16=5e11, flops_f32=5e11,
    hbm_bw=4e10, vmem_bytes=1 * 2**20, ici_bw=1e9,
    program_overhead=1e-7,
    backend="cpu",
)

DEVICES: dict[str, DeviceSpec] = {
    d.kind: d for d in (TPU_V5E, TPU_V4, TPU_V5P, TPU_V6E,
                        GPU_A100, GPU_A4000, GPU_H100, CPU_HOST)
}

_BACKEND_BASELINE: dict[str, DeviceSpec] = {
    "tpu": TPU_V5E, "gpu": GPU_A100, "cpu": CPU_HOST,
}


def infer_backend(kind: str) -> str:
    """Best-effort backend for a device kind string (prefix only)."""
    if kind.startswith("gpu"):
        return "gpu"
    if kind.startswith("cpu"):
        return "cpu"
    return "tpu"


def get_device(kind: str) -> DeviceSpec:
    """The spec for ``kind``; unknown kinds come back ``estimated``."""
    if kind in DEVICES:
        return DEVICES[kind]
    family = "-".join(kind.split("-")[:2]) if "-" in kind else kind
    return replace(_BACKEND_BASELINE[infer_backend(kind)],
                   kind=kind, family=family, estimated=True)


_TPU_KIND_TABLE: tuple[tuple[str, str], ...] = (
    ("v5e", "tpu-v5e"),
    ("v5 lite", "tpu-v5e"),
    ("v5lite", "tpu-v5e"),
    ("v5p", "tpu-v5p"),
    ("v5", "tpu-v5p"),
    ("v6e", "tpu-v6e"),
    ("v6 lite", "tpu-v6e"),
    ("v6lite", "tpu-v6e"),
    ("v4", "tpu-v4"),
)

_GPU_KIND_TABLE: tuple[tuple[str, str], ...] = (
    ("h100", "gpu-h100"),
    ("a100", "gpu-a100"),
    ("a4000", "gpu-a4000"),
)


def parse_device_kind(raw: str, platform: str = "") -> str:
    """Canonical device kind for a raw device name.

    ``raw`` is what ``torch.cuda.get_device_name()`` reports (e.g.
    "NVIDIA H100 80GB HBM3") or a TPU ``device_kind`` string; ``platform``
    ("tpu" / "gpu" / "cpu") disambiguates names that never mention their
    vendor. Unrecognized hardware slugs to a prefixed kind.
    """
    kind = raw.lower()
    if "tpu" in kind or platform == "tpu":
        for marker, canonical in _TPU_KIND_TABLE:
            if marker in kind:
                return canonical
        slug = kind.replace(" ", "-")
        return slug if slug.startswith("tpu") else f"tpu-{slug}"
    if platform == "gpu" or any(v in kind for v in ("nvidia", "amd",
                                                    "rocm", "cuda")):
        for marker, canonical in _GPU_KIND_TABLE:
            if marker in kind:
                return canonical
        slug = kind.replace(" ", "-")
        return slug if slug.startswith("gpu") else f"gpu-{slug}"
    return "cpu"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``"cuda"`` (every entry point's default) raises when there is no card:
    the port never falls back to the CPU on its own. Pass ``"cpu"`` to run
    the plain PyTorch versions, as the tests do.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run the "
            "plain PyTorch versions on the host")
    return dev


def current_device_kind(device: str | torch.device | None = None) -> str:
    """Active device kind: env override, else the card's (or "cpu").

    ``device`` is the torch device the caller's tensors live on; a CPU
    device is kind "cpu", so wisdom measured on the host never carries a
    GPU's name.
    """
    env = os.environ.get(DEVICE_ENV)
    if env:
        return env
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type == "cpu") or \
            not torch.cuda.is_available():
        return "cpu"
    index = dev.index if dev is not None and dev.index is not None else 0
    return parse_device_kind(torch.cuda.get_device_name(index), "gpu")


def current_device(device: str | torch.device | None = None) -> DeviceSpec:
    """The :class:`DeviceSpec` of :func:`current_device_kind`."""
    return get_device(current_device_kind(device))
