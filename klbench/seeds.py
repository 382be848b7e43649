"""Every random input of a run comes from ``--seed`` through :func:`subseed`,
one stream per purpose, so that one input can change without moving the
others."""

from __future__ import annotations

import zlib

import numpy as np
import torch


def subseed(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose``, drawn from the run's ``seed``."""
    ss = np.random.SeedSequence(entropy=int(seed) % 2**64,
                                spawn_key=(zlib.crc32(purpose.encode()),))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, purpose: str, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for ``purpose``."""
    return torch.Generator(device=device).manual_seed(subseed(seed, purpose))


def rng(seed: int, purpose: str) -> np.random.Generator:
    """A host generator for ``purpose`` (orders and samples, never data)."""
    return np.random.default_rng(subseed(seed, purpose))
