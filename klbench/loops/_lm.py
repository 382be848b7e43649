"""What the decoder loops share: the program's model for a configuration
file, and the comparison numbers."""

from __future__ import annotations

import torch


def arch_config(c: dict):
    """The program's ``ArchConfig`` for the configuration file ``c``: every
    size from the file, the rest the dense family's defaults (RMS norm,
    SiLU-gated MLP, rotary positions, separate head, bf16)."""
    from repro_torch.models import ArchConfig
    return ArchConfig(
        name=c["name"], family="dense", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_head=c["head_dim"],
        d_ff=c["intermediate_size"], vocab=c["vocab_size"],
        qkv_bias=c["qkv_bias"], rope_theta=c["rope_theta"],
        tie_embeddings=c["tie_word_embeddings"],
        param_dtype=c["torch_dtype"], compute_dtype=c["torch_dtype"])


def rel_l2(out: torch.Tensor, ref: torch.Tensor) -> float:
    out = out.to(torch.float32)
    return float(torch.linalg.vector_norm(out - ref)
                 / torch.linalg.vector_norm(ref))


def row_rel_l2(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst row's relative L2 gap of (rows, n) tensors."""
    out = out.to(torch.float32)
    return float((torch.linalg.vector_norm(out - ref, dim=-1)
                  / torch.linalg.vector_norm(ref, dim=-1)).max())


def top_gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap, over rows, by which the reference's logit of the
    token ``out`` puts first lies below the reference's best."""
    pick = out.to(torch.float32).argmax(-1, keepdim=True)
    return float((ref.max(-1).values - ref.gather(-1, pick)[:, 0]).max())
