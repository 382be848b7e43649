"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention
(arXiv:2401.16818). 24L d_model=2560 32H (GQA kv=8, d_head=80) d_ff=6912
vocab=32000, SWA(4096) all layers — the bounded window makes 500k-context
decode feasible (ring-sized effective cache)."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=80,
    d_ff=6912,
    vocab=32000,
    windows=(4096,) * 24,
    supports_long_context=True,
)
