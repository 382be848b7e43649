"""Model zoo (port of ``repro.models``): every architecture family of the
reference — the dense family, MoE (deepseek-moe), MoE with MLA
(deepseek-v2), vision with gated cross-attention (llama-3.2-vision),
mamba+attn (hymba), RWKV (rwkv6) and the encoder-decoder (whisper).
``build_model(cfg)`` returns a :class:`DecoderLM`, or an :class:`EncDecLM`
for an encoder-decoder config, on the card (or the device asked for)."""

import torch

from repro_torch.core.device import resolve_device

from .config import (ArchConfig, FULL_WINDOW, MLACfg, MambaCfg, MoECfg,
                     RWKVCfg, YarnCfg)
from .encdec import EncDecLM
from .transformer import DecoderLM


def build_model(cfg: ArchConfig, device: str | torch.device = "cuda",
                remat: bool = False) -> DecoderLM | EncDecLM:
    """The model for ``cfg`` on ``device``. The default ``cuda`` raises
    without a card; pass ``cpu`` for the plain PyTorch versions, or
    ``meta`` for shapes only. ``remat`` checkpoints each layer's
    activations in training."""
    cls = EncDecLM if cfg.enc_dec else DecoderLM
    return cls(cfg, device=resolve_device(device), remat=remat)


__all__ = ["ArchConfig", "FULL_WINDOW", "MLACfg", "MambaCfg", "MoECfg",
           "RWKVCfg", "YarnCfg", "DecoderLM", "EncDecLM", "build_model"]
