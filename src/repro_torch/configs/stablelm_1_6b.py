"""stablelm-1.6b [dense] (hf:stabilityai/stablelm-2-1_6b). 24L d_model=2048
32H (kv=32) d_ff=5632 vocab=100352; LayerNorm and 25% partial rotary."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=5632,
    vocab=100352,
    norm="ln",
    rope_frac=0.25,
)
