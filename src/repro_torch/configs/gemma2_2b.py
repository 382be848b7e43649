"""gemma2-2b [dense] — local/global alternating attention with logit
softcaps (arXiv:2408.00118). 26L d_model=2304 8H (GQA kv=4, d_head=256)
d_ff=9216 vocab=256000; attn softcap 50, final softcap 30; pre+post
(sandwich) norms; tied embeddings; GeGLU."""

from repro_torch.models.config import ArchConfig, FULL_WINDOW

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=9216,
    vocab=256000,
    windows=tuple(4096 if i % 2 == 0 else FULL_WINDOW for i in range(26)),
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    tie_embeddings=True,
    act="gelu",
)
