"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer
(arXiv:2411.13676). 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16. SWA(1024) with global-attention layers {0, 15, 31}; meta
tokens omitted (backbone only)."""

from repro_torch.models.config import ArchConfig, FULL_WINDOW, MambaCfg

_GLOBAL_LAYERS = (0, 15, 31)

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab=32001,
    mixer="mamba+attn",
    mamba=MambaCfg(d_state=16, expand=2, d_conv=4),
    windows=tuple(FULL_WINDOW if i in _GLOBAL_LAYERS else 1024
                  for i in range(32)),
    rope_theta=10000.0,
    supports_long_context=True,   # SWA + 3 global layers; B=1 500k decode ok
)
