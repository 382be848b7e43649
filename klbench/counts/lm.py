"""Model flops of a dense decoder (GQA attention, gated MLP, separate head).

Two flops a multiply-add. Each token costs 2 x the parameters of its
matrix products (q, k, v, o and the three MLP matrices of every layer);
attention adds 4 x d_head flops a head for each causal (query, key) pair;
the embedding is a gather and counts 0. A prefill computes the head at the
last position of each sequence only; a training step at every position,
and its backward twice the forward (remat's recompute is not counted).

This is not ``roofline/analysis.py``'s ``model_flops``, which counts 6
flops a token for each embedding row.
"""

from __future__ import annotations

from .flash import causal_pairs


def layer_matmul_params(c: dict) -> int:
    d, ff = c["hidden_size"], c["intermediate_size"]
    hd = c["head_dim"]
    dq = c["num_attention_heads"] * hd
    dkv = c["num_key_value_heads"] * hd
    return d * dq + 2 * d * dkv + dq * d + 3 * d * ff


def attention_flops(c: dict, batch: int, seq: int) -> float:
    """All layers' attention flops over ``batch`` causal sequences."""
    return (c["num_hidden_layers"] * batch * c["num_attention_heads"]
            * 4.0 * c["head_dim"] * causal_pairs(seq))


def prefill_flops(c: dict, batch: int, seq: int) -> float:
    """One ``prefill`` of ``batch`` x ``seq`` tokens."""
    tokens = batch * seq
    mm = 2.0 * c["num_hidden_layers"] * layer_matmul_params(c) * tokens
    head = 2.0 * c["hidden_size"] * c["vocab_size"] * batch
    return mm + attention_flops(c, batch, seq) + head


def train_flops(c: dict, batch: int, seq: int) -> float:
    """One training step over ``batch`` x ``seq`` tokens: 3 x the forward,
    whose head runs at every position."""
    tokens = batch * seq
    mm = 2.0 * c["num_hidden_layers"] * layer_matmul_params(c) * tokens
    head = 2.0 * c["hidden_size"] * c["vocab_size"] * tokens
    return 3.0 * (mm + attention_flops(c, batch, seq) + head)
