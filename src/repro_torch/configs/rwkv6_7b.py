"""rwkv6-7b [ssm] — Finch, data-dependent decay (arXiv:2404.05892). 32L
d_model=4096 (attention-free) d_ff=14336 vocab=65536; 64 wkv heads of 64.
Decode carries only (state, shift) — O(1) in context length."""

from repro_torch.models.config import ArchConfig, RWKVCfg

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,
    n_kv_heads=64,
    d_head=64,
    d_ff=14336,
    vocab=65536,
    mixer="rwkv",
    rwkv=RWKVCfg(decay_lora=64, head_dim=64),
    pos="none",
    supports_long_context=True,
)
