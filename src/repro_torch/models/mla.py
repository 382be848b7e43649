"""Multi-head Latent Attention (DeepSeek-V2): train/prefill forward and the
*absorbed* decode (port of ``repro.models.mla``).

Train and prefill expand the latent kv to per-head K/V and fold
(nope ++ rope) into one head of ``d_nope + d_rope`` dims, then attend
through ``kernels.ops.attention`` with :func:`softmax_scale`: at q/k 192
and v 128 on a sequence of a multiple of 128 that is the flash kernel
(K4), on a card its CUDA kernel; other shapes run the plain
``ref.attention_ref``. Decode projects the queries into the kv-latent
space, so attention runs against the cached ``(S, kv_lora)`` latent plus
the shared ``(S, d_rope)`` rope key; the cache never expands to per-head
K/V.

The queries come from one ``wq`` where the config has no query LoRA
(``q_lora`` None, DeepSeek-V2-Lite), else through ``wq_a``, ``q_norm`` and
``wq_b``. With ``cfg.yarn`` the rope dims rotate at YaRN's frequencies and
the softmax scale takes YaRN's mscale squared, in prefill and decode
alike. Each call runs inside the span ``mla``.

The port writes the latent caches in place, as ``models/attention.py``
does the KV caches, and decode reads only their written prefix
``[0, pos]`` (the reference's ``k_pos <= pos`` mask gives the rest weight
exactly 0). Decode's products accumulate in float32 on operands rounded to
the cache dtype, as the reference's ``preferred_element_type``. The cache
stays in its storage dtype: decode casts it to float32 ``DECODE_BLOCK``
positions at a time, so no float32 copy of the whole prefix is made.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.obs import runtime as obs

from .common import apply_rope, dense_init, dt, split_heads, yarn_mscale
from .config import ArchConfig

#: Cache positions that decode casts to float32 at a time.
DECODE_BLOCK = 1024


def init_mla(generator, cfg: ArchConfig, device) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dtype = dt(cfg)
    d_q = h * (m.d_nope + m.d_rope)
    if m.q_lora is None:
        q = {"wq": dense_init(generator, (d, d_q), dtype, device)}
    else:
        q = {"wq_a": dense_init(generator, (d, m.q_lora), dtype, device),
             "q_norm": {"scale": torch.ones(m.q_lora, dtype=torch.float32,
                                            device=device)},
             "wq_b": dense_init(generator, (m.q_lora, d_q), dtype, device)}
    return {
        **q,
        "wkv_a": dense_init(generator, (d, m.kv_lora + m.d_rope), dtype,
                            device),
        "kv_norm": {"scale": torch.ones(m.kv_lora, dtype=torch.float32,
                                        device=device)},
        "wk_b": dense_init(generator, (m.kv_lora, h * m.d_nope), dtype,
                           device),
        "wv_b": dense_init(generator, (m.kv_lora, h * m.d_v), dtype, device),
        "wo": dense_init(generator, (h * m.d_v, d), dtype, device),
    }


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def softmax_scale(cfg: ArchConfig) -> float:
    """(d_nope + d_rope)^-0.5, times YaRN's mscale(factor,
    mscale_all_dim) squared where the config has YaRN (DeepSeek-V2's
    ``softmax_scale``)."""
    m, y = cfg.mla, cfg.yarn
    scale = (m.d_nope + m.d_rope) ** -0.5
    if y is not None and y.mscale_all_dim:
        scale *= yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return scale


def _queries(cfg: ArchConfig, p: dict, x: torch.Tensor,
             positions: torch.Tensor):
    m = cfg.mla
    if m.q_lora is None:
        q = x @ p["wq"].to(x.dtype)
    else:
        cq = _rms(x @ p["wq_a"].to(x.dtype), p["q_norm"]["scale"])
        q = cq @ p["wq_b"].to(x.dtype)
    q = split_heads(q, cfg.n_heads, m.d_nope + m.d_rope)
    q_nope, q_pe = q[..., :m.d_nope], q[..., m.d_nope:]
    q_pe = apply_rope(q_pe, positions, 1.0, cfg.rope_theta, cfg.yarn)
    return q_nope, q_pe


def _latents(cfg: ArchConfig, p: dict, x: torch.Tensor,
             positions: torch.Tensor):
    m = cfg.mla
    kv = x @ p["wkv_a"].to(x.dtype)
    c_kv = _rms(kv[..., :m.kv_lora], p["kv_norm"]["scale"])
    k_pe = apply_rope(kv[..., m.kv_lora:], positions, 1.0, cfg.rope_theta,
                      cfg.yarn)
    return c_kv, k_pe           # (B, S, kv_lora), (B, S, d_rope)


def _mla_core(cfg: ArchConfig, p: dict, x: torch.Tensor):
    m = cfg.mla
    B, S, _ = x.shape
    h = cfg.n_heads
    positions = torch.arange(S, device=x.device)
    q_nope, q_pe = _queries(cfg, p, x, positions)     # (B,S,h,*)
    c_kv, k_pe = _latents(cfg, p, x, positions)
    k_nope = split_heads(c_kv @ p["wk_b"].to(x.dtype), h, m.d_nope)
    v = split_heads(c_kv @ p["wv_b"].to(x.dtype), h, m.d_v)

    # Fold (nope ++ rope) into one head dim, heads first, so the
    # concatenation is the one copy the kernel's layout needs; the shared
    # rope key broadcasts across heads.
    qq = torch.cat([q_nope.transpose(1, 2), q_pe.transpose(1, 2)],
                   dim=-1)                            # (B,h,S,dn+dr)
    kk = torch.cat([k_nope.transpose(1, 2),
                    k_pe[:, None].expand(B, h, S, m.d_rope)], dim=-1)
    o = ops.attention(qq, kk, v.transpose(1, 2), causal=True,
                      scale=softmax_scale(cfg))
    o = o.transpose(1, 2).to(x.dtype).reshape(B, S, h * m.d_v)
    out = o @ p["wo"].to(x.dtype)
    return out, c_kv, k_pe


def mla_forward(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Training: expand latents to per-head K/V."""
    with obs.span("mla", "model", x.device):
        return _mla_core(cfg, p, x)[0]


def mla_prefill(cfg: ArchConfig, p: dict, x: torch.Tensor, c_kv_cache,
                k_pe_cache) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Parallel prefill writing the *latent* cache for positions [0, S),
    in place. Returns (out, c_kv_cache, k_pe_cache)."""
    with obs.span("mla", "model", x.device):
        out, c_kv, k_pe = _mla_core(cfg, p, x)
        S = x.shape[1]
        c_kv_cache[:, :S] = c_kv
        k_pe_cache[:, :S] = k_pe
    return out, c_kv_cache, k_pe_cache


# --------------------------------------------------------------- decode ----

def init_mla_cache(cfg: ArchConfig, n_layers: int, batch: int, max_seq: int,
                   dtype: torch.dtype, device) -> dict:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((n_layers, batch, max_seq, m.kv_lora),
                            dtype=dtype, device=device),
        "k_pe": torch.zeros((n_layers, batch, max_seq, m.d_rope),
                            dtype=dtype, device=device),
    }


def mla_decode(cfg: ArchConfig, p: dict, x: torch.Tensor,
               c_kv_cache: torch.Tensor, k_pe_cache: torch.Tensor, pos: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed one-token decode. x: (B, 1, D); caches: (B, S, kv_lora)
    and (B, S, d_rope), written at the host int ``pos`` in place."""
    with obs.span("mla", "model", x.device):
        return _mla_decode(cfg, p, x, c_kv_cache, k_pe_cache, pos)


def _mla_decode(cfg: ArchConfig, p: dict, x: torch.Tensor,
                c_kv_cache: torch.Tensor, k_pe_cache: torch.Tensor, pos: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    m = cfg.mla
    B = x.shape[0]
    h = cfg.n_heads
    f32 = torch.float32
    positions = torch.full((1,), pos, device=x.device)
    q_nope, q_pe = _queries(cfg, p, x, positions)   # (B,1,h,*)
    c_kv, k_pe = _latents(cfg, p, x, positions)     # (B,1,kv_lora/d_rope)
    c_kv_cache[:, pos] = c_kv[:, 0]
    k_pe_cache[:, pos] = k_pe[:, 0]
    blocks = [(i, min(i + DECODE_BLOCK, pos + 1))      # the written prefix
              for i in range(0, pos + 1, DECODE_BLOCK)]

    # absorb W^UK into the query: q_c (B, 1, h, kv_lora)
    cd = c_kv_cache.dtype
    wk_b = p["wk_b"].to(cd).to(f32).reshape(m.kv_lora, h, m.d_nope)
    q_c = torch.einsum("bqhd,lhd->bqhl", q_nope.to(cd).to(f32), wk_b)
    q_c, q_pe = q_c.to(cd).to(f32), q_pe.to(cd).to(f32)

    scale = softmax_scale(cfg)
    s = torch.cat([
        torch.einsum("bqhl,bkl->bhqk", q_c, c_kv_cache[:, a:b].to(f32))
        + torch.einsum("bqhd,bkd->bhqk", q_pe, k_pe_cache[:, a:b].to(f32))
        for a, b in blocks], dim=-1) * scale
    attn = torch.softmax(s, dim=-1).to(cd).to(f32)
    # attend in latent space, then expand through W^UV
    o_lat = 0
    for a, b in blocks:
        o_lat = o_lat + torch.einsum("bhqk,bkl->bqhl", attn[..., a:b],
                                     c_kv_cache[:, a:b].to(f32))
    wv_b = p["wv_b"].to(f32).reshape(m.kv_lora, h, m.d_v)
    o = torch.einsum("bqhl,lhd->bqhd", o_lat, wv_b)
    o = o.to(x.dtype).reshape(B, 1, h * m.d_v)
    out = o @ p["wo"].to(x.dtype)
    return out, c_kv_cache, k_pe_cache
