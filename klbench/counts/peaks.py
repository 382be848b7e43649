"""The published peaks of one NVIDIA H100 SXM (``peaks.json``), the same
numbers as the program's ``gpu-h100`` spec (``src/repro_torch/core/device.py``
lines 93-107)."""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path


@lru_cache(maxsize=1)
def peaks() -> dict:
    return json.loads((Path(__file__).with_name("peaks.json")).read_text())


def flops_peak(dtype: str) -> float:
    """FLOP/s of the tensor cores in bf16/fp16, of the CUDA cores in f32."""
    p = peaks()
    return p["bf16_flops"] if dtype in ("bfloat16", "float16") \
        else p["f32_flops"]


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card can take: the larger of operations over peak
    FLOP/s and bytes over peak bytes/s."""
    return max(flops / flops_peak(dtype), nbytes / peaks()["hbm_bytes_per_s"])
