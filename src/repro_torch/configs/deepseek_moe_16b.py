"""deepseek-moe-16b [moe] — fine-grained MoE (arXiv:2401.06066). 28L
d_model=2048 16H d_ff(dense layer 0)=10944 vocab=102400; 2 shared + 64
routed top-6 experts of d_expert=1408."""

from repro_torch.models.config import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=10944,                    # dense FFN width (layer 0)
    vocab=102400,
    moe=MoECfg(n_routed=64, top_k=6, d_expert=1408, n_shared=2,
               capacity_factor=1.25, chunk=256),
    dense_layers=(0,),
)
