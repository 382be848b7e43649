"""Counts of a DeepSeek-V2 prefill (MLA attention, DeepSeekMoE FFN), for
the ``deepseek-v2-lite`` configuration.

Two flops a multiply-add. Active flops a token: 2 x the parameters of the
matrix products it runs through (MLA's ``wq``, ``wkv_a``, ``wk_b``,
``wv_b``, ``wo``; layer 0's dense MLP; each MoE layer's router, its top-k
routed experts and its shared experts), plus attention; the embedding is a
gather and counts 0; the head runs at the last position of each sequence
only.

K4 at MLA's heads (q/k 192, v 128), copied from its workload hook
(``src/repro_torch/kernels/flash_attention.py``, ``_workload``, as it
stood when the benchmark was written): Q.K^T takes 192 and P.V 128
multiply-adds for each causal (query, key) pair, 2 x (192 + 128) flops; q
and k move 192 elements a row, v and o 128, each once, in bf16.

The routed experts of one MoE call: 3 products of d x d_expert for each of
the top-k (token, expert) pairs; the bytes are every expert's weights read
once, the pairs' gathered inputs read and their outputs written once, in
bf16.
"""

from __future__ import annotations

from .flash import causal_pairs

BF16 = 2


def _heads(c: dict) -> tuple[int, int, int]:
    return (c["num_attention_heads"],
            c["qk_nope_head_dim"] + c["qk_rope_head_dim"], c["v_head_dim"])


def mla_matmul_params(c: dict) -> int:
    d, lora = c["hidden_size"], c["kv_lora_rank"]
    h, dqk, dv = _heads(c)
    nope = c["qk_nope_head_dim"]
    return (d * h * dqk + d * (lora + c["qk_rope_head_dim"])
            + lora * h * nope + lora * h * dv + h * dv * d)


def ffn_matmul_params(c: dict, layer: int) -> int:
    """Active parameters of layer ``layer``'s FFN a token."""
    d = c["hidden_size"]
    if layer < c["first_k_dense_replace"]:
        return 3 * d * c["intermediate_size"]
    experts = c["num_experts_per_tok"] + c["n_shared_experts"]
    return d * c["n_routed_experts"] + experts * 3 * d * c[
        "moe_intermediate_size"]


def k4(bh: int, s: int, c: dict) -> tuple[float, float]:
    """(flops, bytes) of one causal K4 call over ``bh`` heads of MLA's
    (q/k, v) dims and length ``s`` (kv heads = query heads), bf16."""
    _, dqk, dv = _heads(c)
    return (2.0 * bh * (dqk + dv) * causal_pairs(s),
            float(2 * bh * s * (dqk + dv) * BF16))


def prefill_flops(c: dict, batch: int, seq: int) -> float:
    """Active flops of one ``prefill`` of ``batch`` x ``seq`` tokens."""
    tokens = batch * seq
    layers = c["num_hidden_layers"]
    mm = 2.0 * tokens * (layers * mla_matmul_params(c) + sum(
        ffn_matmul_params(c, i) for i in range(layers)))
    attn = layers * k4(batch * c["num_attention_heads"], seq, c)[0]
    head = 2.0 * c["hidden_size"] * c["vocab_size"] * batch
    return mm + attn + head


def experts(c: dict, tokens: int) -> tuple[float, float]:
    """(flops, bytes) of the routed experts of one MoE call over
    ``tokens`` tokens."""
    d, f, e = (c["hidden_size"], c["moe_intermediate_size"],
               c["n_routed_experts"])
    pairs = tokens * c["num_experts_per_tok"]
    return (2.0 * pairs * 3 * d * f,
            float((e * 3 * d * f + 2 * pairs * d) * BF16))
