"""Counts of the causal flash-attention kernel (K4).

Copied from its workload hook (``src/repro_torch/kernels/flash_attention.py``
lines 335-365, as it stood when the benchmark was written): two products of
D multiply-adds for each (query, key) pair the output needs, S(S+1)/2 pairs
a head when causal; q, k, v read once and o written once.
"""

from __future__ import annotations

ELEM_BYTES = {"float32": 4, "bfloat16": 2}


def causal_pairs(s: int) -> float:
    return s * (s + 1) / 2


def attention(bh: int, bhkv: int, s: int, d: int, dtype: str
              ) -> tuple[float, float]:
    """(flops, bytes) of one causal call over ``bh`` query heads of length
    ``s`` and head dim ``d``."""
    return (4.0 * bh * d * causal_pairs(s),
            float((2 * bh + 2 * bhkv) * s * d * ELEM_BYTES[dtype]))
