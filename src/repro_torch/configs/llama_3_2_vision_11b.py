"""llama-3.2-vision-11b [vlm] — cross-attention image layers every 5th layer
(hf:meta-llama/Llama-3.2-11B-Vision). 40L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256. The vision frontend is a stub: ``input_specs``
provides precomputed patch embeddings (B, 576, d_model)."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=128256,
    cross_attn_period=5,          # 8 gated cross blocks + 32 self layers
    n_img_tokens=576,
    rope_theta=500000.0,
)
