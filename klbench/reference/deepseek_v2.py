"""DeepSeek-V2 written plainly: the model of the ``deepseek-v2-lite``
configuration, after the published ``modeling_deepseek.py``.

* Attention is MLA. With no query LoRA (``q_lora_rank`` null) one ``wq``
  gives each head 128 nope and 64 rope dims. ``wkv_a`` gives the 512-wide
  kv latent, RMS-normed (``kv_norm``), and one 64-dim rope key that all
  heads share; ``wk_b`` and ``wv_b`` expand the latent to each head's nope
  key and its 128-dim value.
* Rotary positions use YaRN (``DeepseekV2YarnRotaryEmbedding``): the
  correction range of ``beta_fast``/``beta_slow`` over the original
  context, a linear ramp between the interpolated and the plain
  frequencies, cos and sin times mscale(factor, mscale) / mscale(factor,
  mscale_all_dim), and the softmax scale (nope + rope)^-0.5 times
  mscale(factor, mscale_all_dim)^2.
* Causal softmax attention, one batch row and :data:`Q_BLOCK` query rows
  at a time, so that 16384 positions fit.
* Layers below ``first_k_dense_replace`` have a dense SiLU-gated FFN; the
  others the DeepSeekMoE FFN: a float32 softmax router, the greedy top-k,
  gates not renormalised (``norm_topk_prob`` false) and scaled by
  ``routed_scaling_factor``; each routed expert runs on exactly the
  tokens that chose it, nothing dropped; the shared experts are one
  SiLU-gated MLP of ``n_shared_experts x moe_intermediate_size``.
* Pre-norm RMS norm with ``rms_norm_eps``, a separate head.

Departures from the published model, all shared with the program: the
rotary dims are rotated as interleaved pairs and kept in that order (the
published model rotates the same pairs but writes them half-split, a fixed
permutation of q_pe and k_pe that leaves every score unchanged); the
weights are seeded random, not the published ones.

Everything computes in float32 with TF32 off; the parameters are read from
the seeded tree (``klbench.weights_mla_moe``, the program's layout) one
layer at a time. ``fp8=True`` rounds both operands of every matrix product
to float8 e4m3 first, the control one precision below bf16. ``renorm`` and
``plain_rope`` plant the faults the cell's checks must catch: top-k gates
renormalised to sum 1, and plain rope with the (nope + rope)^-0.5 scale.

This file imports no JAX and no kernel of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from klbench.reference.decoder import ieee_f32, mm

#: Query rows of one attention block.
Q_BLOCK = 1024


def rmsnorm(c: dict, x, scale):
    return (x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                            + c["rms_norm_eps"]) * scale)


def mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_inv_freq(c: dict, dim: int, device=None) -> torch.Tensor:
    """The rope dims' inverse frequencies: YaRN's blend of the plain and
    the interpolated ones (``DeepseekV2YarnRotaryEmbedding``)."""
    base, y = float(c["rope_theta"]), c["rope_scaling"]
    pos = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** pos
    inter = 1.0 / (y["factor"] * base ** pos)

    def corr(rot):
        return (dim * math.log(y["original_max_position_embeddings"]
                               / (rot * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(corr(y["beta_fast"])), 0)
    high = min(math.ceil(corr(y["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def softmax_scale(c: dict, plain_rope: bool = False) -> float:
    scale = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    y = c["rope_scaling"]
    if not plain_rope and y.get("mscale_all_dim"):
        scale *= mscale(y["factor"], y["mscale_all_dim"]) ** 2
    return scale


def rope(c: dict, x, plain: bool = False):
    """x: (B, S, ..., D) at positions 0..S-1, rotated over interleaved
    pairs (x[2i], x[2i+1]) at YaRN's frequencies (plain ones with
    ``plain``)."""
    S, D = x.shape[1], x.shape[-1]
    if plain:
        inv = 1.0 / float(c["rope_theta"]) ** (
            torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
        m = 1.0
    else:
        inv = yarn_inv_freq(c, D, x.device)
        y = c["rope_scaling"]
        m = mscale(y["factor"], y["mscale"]) / mscale(y["factor"],
                                                      y["mscale_all_dim"])
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    shape = (1, S) + (1,) * (x.dim() - 3) + (D // 2,)
    cos, sin = (torch.cos(ang) * m).view(shape), (torch.sin(ang) * m).view(
        shape)
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def attention(q, k, v, scale: float, fp8: bool):
    """Causal softmax attention of q, k (B, H, S, Dqk) and v (B, H, S,
    Dv), one batch row and ``Q_BLOCK`` query rows at a time."""
    B, H, S, _ = q.shape
    out = torch.empty(B, H, S, v.shape[-1], dtype=q.dtype, device=q.device)
    for b in range(B):
        for a in range(0, S, Q_BLOCK):
            e = min(a + Q_BLOCK, S)
            s = mm(q[b, :, a:e], k[b, :, :e].transpose(-1, -2), fp8) * scale
            mask = (torch.arange(a, e, device=q.device)[:, None]
                    < torch.arange(e, device=q.device)[None, :])
            p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
            out[b, :, a:e] = mm(p, v[b, :, :e], fp8)
    return out


def mla(c: dict, a: dict, h, fp8: bool, plain_rope: bool):
    """One MLA block on f32 parameters ``a``: (out, c_kv, k_pe)."""
    B, S, _ = h.shape
    H = c["num_attention_heads"]
    nope, rp = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    dv, lora = c["v_head_dim"], c["kv_lora_rank"]
    q = mm(h, a["wq"], fp8).view(B, S, H, nope + rp)
    q_pe = rope(c, q[..., nope:], plain_rope)
    kv = mm(h, a["wkv_a"], fp8)
    c_kv = rmsnorm(c, kv[..., :lora], a["kv_norm"]["scale"])
    k_pe = rope(c, kv[..., lora:], plain_rope)               # (B, S, rope)
    k_nope = mm(c_kv, a["wk_b"], fp8).view(B, S, H, nope)
    v = mm(c_kv, a["wv_b"], fp8).view(B, S, H, dv)
    qq = torch.cat([q[..., :nope], q_pe], -1).transpose(1, 2)
    kk = torch.cat([k_nope, k_pe[:, :, None].expand(B, S, H, rp)],
                   -1).transpose(1, 2)
    o = attention(qq, kk, v.transpose(1, 2),
                  softmax_scale(c, plain_rope), fp8)
    o = o.transpose(1, 2).reshape(B, S, H * dv)
    return mm(o, a["wo"], fp8), c_kv, k_pe


def mlp(h, w_in, w_gate, w_out, fp8: bool):
    return mm(F.silu(mm(h, w_gate, fp8)) * mm(h, w_in, fp8), w_out, fp8)


def moe(c: dict, m: dict, h, fp8: bool = False, renorm: bool = False):
    """The DeepSeekMoE FFN on f32 parameters ``m`` of h (..., D): the
    shared experts plus each routed expert on exactly its own tokens,
    weighted by its gate."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    probs = torch.softmax(mm(x, m["router"], fp8), dim=-1)
    gate, idx = torch.topk(probs, c["num_experts_per_tok"], dim=-1)
    if renorm or c["norm_topk_prob"]:
        gate = gate / gate.sum(-1, keepdim=True)
    gate = gate * c["routed_scaling_factor"]
    y = mlp(x, m["shared_in"], m["shared_gate"], m["shared_out"], fp8)
    for e in range(c["n_routed_experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel():
            y = y.index_add(0, rows, gate[rows, slot, None] * mlp(
                x[rows], m["w_in"][e], m["w_gate"][e], m["w_out"][e], fp8))
    return y.view(shape)


def f32(tree):
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.float32)
    return {k: f32(v) for k, v in tree.items()}


def layer_params(params: dict, c: dict, i: int) -> dict:
    """Layer ``i``'s block in the program's layout (bf16/f32 leaves)."""
    n = c["first_k_dense_replace"]
    return params["dense_prefix"][i] if i < n else params["layers"][i - n]


@torch.no_grad()
def prefill(c: dict, params: dict, tokens, fp8: bool = False,
            renorm: bool = False, plain_rope: bool = False, on_latent=None,
            on_moe_input=None) -> torch.Tensor:
    """Logits (B, V) at the last position of ``tokens`` (B, S); calls
    ``on_latent(i, c_kv, k_pe)`` with layer i's (B, S, kv_lora) latent and
    (B, S, rope) rope key, and ``on_moe_input(i, h)`` with the normed input
    (B, S, D) of each MoE layer."""
    with ieee_f32():
        x = params["embed"][tokens.long()].to(torch.float32)
        for i in range(c["num_hidden_layers"]):
            lp = f32(layer_params(params, c, i))
            h = rmsnorm(c, x, lp["ln1"]["scale"])
            o, c_kv, k_pe = mla(c, lp["mla"], h, fp8, plain_rope)
            if on_latent is not None:
                on_latent(i, c_kv, k_pe)
            del c_kv, k_pe
            x = x + o
            h = rmsnorm(c, x, lp["ln2"]["scale"])
            if "mlp" in lp:
                m = lp["mlp"]
                x = x + mlp(h, m["w_in"], m["w_gate"], m["w_out"], fp8)
            else:
                if on_moe_input is not None:
                    on_moe_input(i, h)
                x = x + moe(c, lp["moe"], h, fp8, renorm)
            del lp
        h = rmsnorm(c, x[:, -1], params["final_norm"]["scale"])
        return mm(h, params["head"].to(torch.float32), fp8)
