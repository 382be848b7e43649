"""Shared layer primitives: init, norms, rotary embeddings, MLPs (port of
``repro.models.common``).

Parameters are plain nested dicts of tensors. Every init function draws
from an explicit ``torch.Generator`` (``None`` on the ``meta`` device,
where nothing is drawn) onto an explicit device. The reference's
``constrain_batch`` pins sharding on a device mesh; the port runs on one
device and has no counterpart. ``chunked_ce_loss`` belongs to the training
slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.builder import torch_dtype

from .config import ArchConfig


def dt(cfg: ArchConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


def cdt(cfg: ArchConfig) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


# ---------------------------------------------------------------- init ----

def _normal(generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)


def dense_init(generator, shape, dtype, device, in_axis: int = -2
               ) -> torch.Tensor:
    """Variance-scaling (fan-in) normal init."""
    std = shape[in_axis] ** -0.5
    return _normal(generator, shape, device).mul_(std).to(dtype)


def embed_init(generator, shape, dtype, device) -> torch.Tensor:
    return _normal(generator, shape, device).to(dtype)


# ---------------------------------------------------------------- norms ----

def init_norm(cfg: ArchConfig, d: int, device) -> dict:
    p = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg.norm == "ln":
        p["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


def apply_norm(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """RMS norm or LayerNorm, computed in float32 and cast back."""
    x32 = x.to(torch.float32)
    if cfg.norm == "rms":
        var = (x32 * x32).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + 1e-6) * p["scale"]
    else:
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, correction=0)
        y = (x32 - mean) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    return y.to(x.dtype)


# --------------------------------------------------------------- rotary ----

def rope_freqs(d_rot: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32,
                                         device=device) / d_rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, rope_frac: float,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S) or (S,).

    Rotates the first ``rope_frac * D`` dims (partial rotary, stablelm) as
    interleaved pairs (x[2i], x[2i+1]), as the reference does, not the
    half-split layout; the tail stays unrotated."""
    d = x.shape[-1]
    d_rot = int(d * rope_frac)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    rot, keep = x[..., :d_rot], x[..., d_rot:]
    freqs = rope_freqs(d_rot, theta, x.device)              # (d_rot/2,)
    angles = positions[..., None].to(torch.float32) * freqs
    if x.dim() - positions.dim() == 3:                      # head axis present
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    r1, r2 = rot[..., ::2], rot[..., 1::2]
    o1 = r1 * cos - r2 * sin
    o2 = r2 * cos + r1 * sin
    rotated = torch.stack([o1, o2], dim=-1).reshape(rot.shape)
    return torch.cat([rotated.to(x.dtype), keep], dim=-1)


# ------------------------------------------------------------------ MLP ----

def init_mlp(generator, cfg: ArchConfig, d_in: int, d_ff: int,
             device) -> dict:
    dtype = dt(cfg)
    p = {"w_in": dense_init(generator, (d_in, d_ff), dtype, device),
         "w_out": dense_init(generator, (d_ff, d_in), dtype, device)}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init(generator, (d_in, d_ff), dtype, device)
    return p


def _act(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def apply_mlp(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w_in"].to(x.dtype)
    if cfg.gated_mlp:
        g = x @ p["w_gate"].to(x.dtype)
        h = _act(cfg, g) * h
    else:
        h = _act(cfg, h)
    return h @ p["w_out"].to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
