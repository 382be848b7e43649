"""deepseek-v2-236b [moe] — MLA + fine-grained MoE (arXiv:2405.04434). 60L
d_model=5120 128H, MLA kv_lora=512 q_lora=1536 (d_nope=128, d_rope=64,
d_v=128); 2 shared + 160 routed top-6 experts of d_expert=1536; dense FFN
(12288) at layer 0; vocab=102400. Decode uses the absorbed-MLA cache."""

from repro_torch.models.config import ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=12288,                    # dense FFN width (layer 0)
    vocab=102400,
    mla=MLACfg(q_lora=1536, kv_lora=512, d_nope=128, d_rope=64, d_v=128),
    moe=MoECfg(n_routed=160, top_k=6, d_expert=1536, n_shared=2,
               capacity_factor=1.25, chunk=256),
    dense_layers=(0,),
)
