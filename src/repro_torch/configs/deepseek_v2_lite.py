"""deepseek-v2-lite [moe] — MLA + fine-grained MoE (arXiv:2405.04434;
https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json).
27L d_model=2048 16H; MLA with no query LoRA (``q_lora_rank`` null: one
``wq``), kv_lora=512, d_nope=128, d_rope=64, d_v=128; YaRN rope (factor
40 over 4096 original positions, beta_fast 32, beta_slow 1, mscale =
mscale_all_dim = 0.707, theta 1e4); dense SiLU-gated FFN (10944) at layer
0; 2 shared + 64 routed experts of 1408, top-6 by a float32 softmax router
(greedy, ``norm_topk_prob`` false, ``routed_scaling_factor`` 1), dropless;
RMS eps 1e-6; vocab 102400, head not tied. 15.7 B parameters."""

from repro_torch.models.config import ArchConfig, MLACfg, MoECfg, YarnCfg

CONFIG = ArchConfig(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=10944,                    # dense FFN width (layer 0)
    vocab=102400,
    rope_theta=10000.0,
    yarn=YarnCfg(factor=40.0, original_max_pos=4096, beta_fast=32.0,
                 beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707),
    max_seq=163840,
    mla=MLACfg(q_lora=None, kv_lora=512, d_nope=128, d_rope=64, d_v=128),
    moe=MoECfg(n_routed=64, top_k=6, d_expert=1408, n_shared=2,
               capacity_factor=None, norm_topk_prob=False, router_f32=True),
    dense_layers=(0,),
)
