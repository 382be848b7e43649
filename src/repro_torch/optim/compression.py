"""Int8 gradient compression with error feedback (port of
``repro.optim.compression``), the trick for a slow cross-pod link.

Per-tensor symmetric int8 quantization; the quantization error is carried
in a residual ("error feedback") so the compression is unbiased over
time. ``runtime.crosspod`` applies it to parameter deltas.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.tree import leaves, tree_map, unflatten


@dataclass(frozen=True)
class CompressionState:
    """Error-feedback residuals, one per gradient leaf."""
    residual: dict

    @staticmethod
    def init(grads) -> "CompressionState":
        return CompressionState(tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads))


def compress_int8(g: torch.Tensor, residual: torch.Tensor | None = None):
    """-> (q int8, scale f32 scalar, new_residual)."""
    g32 = g.to(torch.float32)
    if residual is not None:
        g32 = g32 + residual
    scale = torch.max(torch.abs(g32)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    err = g32 - q.to(torch.float32) * scale
    return q, scale, err


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads, state: CompressionState | None):
    flat_g = leaves(grads)
    flat_r = (leaves(state.residual) if state is not None
              else [None] * len(flat_g))
    out = [compress_int8(g, r) for g, r in zip(flat_g, flat_r)]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]),
            CompressionState(unflatten(grads, [o[2] for o in out])))


def decompress_tree(qs, scales):
    return tree_map(decompress_int8, qs, scales)
