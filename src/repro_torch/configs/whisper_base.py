"""whisper-base [audio] — enc-dec backbone (arXiv:2212.04356). 6+6L
d_model=512 8H d_ff=2048 vocab=51865; LayerNorm, GELU (non-gated MLP),
learned positions. The conv/mel frontend is a stub: ``input_specs`` provides
precomputed frame embeddings (B, 1500, 512). decode/prefill shapes stress
the backbone with synthetic 32k decoder contexts (noted in DESIGN.md)."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,                    # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_head=64,
    d_ff=2048,
    vocab=51865,
    norm="ln",
    act="gelu",
    gated_mlp=False,
    tie_embeddings=True,          # whisper ties decoder embed / head
    pos="learned",
    max_seq=40960,
    enc_dec=True,
    n_enc_layers=6,
    enc_seq=1500,
)
