"""Model zoo (port of ``repro.models``), dense family: ``build_model(cfg)``
returns a :class:`DecoderLM` on the card (or the device asked for)."""

import torch

from repro_torch.core.device import resolve_device

from .config import (ArchConfig, FULL_WINDOW, MLACfg, MambaCfg, MoECfg,
                     RWKVCfg)
from .transformer import DecoderLM


def build_model(cfg: ArchConfig, device: str | torch.device = "cuda"
                ) -> DecoderLM:
    """The decoder for ``cfg`` on ``device``. The default ``cuda`` raises
    without a card; pass ``cpu`` for the plain PyTorch versions, or
    ``meta`` for shapes only. Encoder-decoder configs are not ported yet
    (ROADMAP.md queue 1 item 9)."""
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: EncDecLM is not ported yet (ROADMAP.md queue 1 "
            f"item 9)")
    return DecoderLM(cfg, device=resolve_device(device))


__all__ = ["ArchConfig", "FULL_WINDOW", "MLACfg", "MambaCfg", "MoECfg",
           "RWKVCfg", "DecoderLM", "build_model"]
