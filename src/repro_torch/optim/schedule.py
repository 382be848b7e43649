"""Learning-rate schedules (port of ``repro.optim.schedule``): functions
of the optimiser's step count, a 0-d int tensor, returning a 0-d float32
tensor on its device."""

from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    return lambda count: torch.tensor(lr, dtype=torch.float32,
                                      device=torch.as_tensor(count).device)


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    def fn(count):
        c = torch.as_tensor(count).to(torch.float32)
        warm = peak * c / max(warmup, 1)
        prog = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac)
                      * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(c < warmup, warm, cos)
    return fn
