"""GQA attention block: prefill forward and cached decode step (port of
``repro.models.attention``).

Per-layer sliding windows arrive as plain ``int``s (0 = full attention),
because the port's layer stack is a Python loop; softcap per config. The
attention math of prefill routes through ``repro_torch.kernels.ops.attention``
(the CUDA flash kernel where its predicate holds, the plain oracle
elsewhere); decode attention is plain PyTorch, as in the reference.

The reference returns new caches built with ``dynamic_update_slice``. The
port writes K/V into the cache tensors in place (slice assignment) and
returns the same tensors, so a caller that keeps the stacked
``(L, B, Hkv, S, D)`` cache and hands each layer a view of it sees every
write. Decode positions are host ints.

Cross-attention (``repro/models/attention.py:187-222``) waits for the
vision slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

from .common import apply_rope, dense_init, dt
from .config import ArchConfig


def init_attn(generator, cfg: ArchConfig, device) -> dict:
    dtype = dt(cfg)
    d = cfg.d_model
    p = {
        "wq": dense_init(generator, (d, cfg.d_q), dtype, device),
        "wk": dense_init(generator, (d, cfg.d_kv), dtype, device),
        "wv": dense_init(generator, (d, cfg.d_kv), dtype, device),
        "wo": dense_init(generator, (cfg.d_q, d), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(cfg.d_q, dtype=dtype, device=device)
        p["bk"] = torch.zeros(cfg.d_kv, dtype=dtype, device=device)
        p["bv"] = torch.zeros(cfg.d_kv, dtype=dtype, device=device)
    return p


def _qkv(cfg: ArchConfig, p: dict, x: torch.Tensor,
         positions: torch.Tensor, rope: bool = True):
    B, S, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.d_head)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    if rope and cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_frac, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_frac, cfg.rope_theta)
    # -> (B, H, S, D)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _attn_core(cfg: ArchConfig, p: dict, x: torch.Tensor, window,
               causal: bool):
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions)
    static_window = isinstance(window, int) or window is None
    if static_window:
        win = None if not window else int(window)
        o = ops.attention(q, k, v, causal=causal, window=win,
                          softcap=cfg.attn_softcap)
    else:
        o = _masked_attention(q, k, v, window, causal, cfg.attn_softcap)
    o = o.transpose(1, 2).reshape(B, S, cfg.d_q)
    out = o @ p["wo"].to(x.dtype)
    return out, k, v


def attn_forward(cfg: ArchConfig, p: dict, x: torch.Tensor,
                 window: torch.Tensor | int | None = None,
                 causal: bool = True) -> torch.Tensor:
    """Full-sequence attention. An ``int`` window (0 = full) or ``None``
    goes through ``ops.attention``; a tensor window through the masked
    oracle."""
    return _attn_core(cfg, p, x, window, causal)[0]


def attn_prefill(cfg: ArchConfig, p: dict, x: torch.Tensor, cache_k,
                 cache_v, window: torch.Tensor | int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Parallel prefill: forward + write K/V for positions [0, S) into the
    cache, in place. Returns (out, cache_k, cache_v)."""
    out, k, v = _attn_core(cfg, p, x, window, causal=True)
    S = x.shape[1]
    cache_k[:, :, :S] = k
    cache_v[:, :, :S] = v
    return out, cache_k, cache_v


def _masked_attention(q, k, v, window, causal: bool,
                      softcap: float | None) -> torch.Tensor:
    """Oracle attention with a tensor window (0 = full attn)."""
    return kref.attention_ref(q, k, v, causal=causal, window=window,
                              softcap=softcap)


# --------------------------------------------------------------- decode ----

def init_kv_cache(cfg: ArchConfig, n_layers: int, batch: int, max_seq: int,
                  dtype: torch.dtype, device) -> dict:
    shape = (n_layers, batch, cfg.n_kv_heads, max_seq, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(cfg: ArchConfig, p: dict, x: torch.Tensor,
                cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                window: torch.Tensor | int | None = None,
                start: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, D); cache_k/v: (B, Hkv, S, D);
    pos: host int — index where the new token is written (in place).
    ``start``, when given, is a (B,) vector of per-slot window origins for
    token-level continuous batching: slot b attends only to cache
    positions in [start[b], pos]. Returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    positions = torch.full((1,), pos, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions)
    cache_k[:, :, pos] = k[:, :, 0]
    cache_v[:, :, pos] = v[:, :, 0]
    win = window if window is not None else 0
    o = _decode_attention(q, cache_k, cache_v, pos, win, cfg.attn_softcap,
                          start=start)
    o = o.transpose(1, 2).reshape(B, 1, cfg.d_q)
    out = o @ p["wo"].to(x.dtype)
    return out, cache_k, cache_v


def _decode_attention(q, cache_k, cache_v, pos: int, window,
                      softcap: float | None,
                      start: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, Hq, 1, D) against the cache; masks unwritten and
    out-of-window positions, plus per-batch positions below ``start``
    (stale cache from a slot's previous occupant). Masking (not zeroing)
    is load-bearing for slot reuse: a zeroed K row still gets softmax
    weight exp(0).

    The casts are the reference's: q is cast to the cache dtype, scores
    accumulate in float32, and p is cast back to the cache dtype before the
    P.V product, which accumulates in float32. (The reference gets f32
    accumulation from bf16 operands with ``preferred_element_type``; here
    the operands are widened, which gives the same exact products.)
    Positions past ``pos`` are masked with weight exactly 0, so the port
    reads only the written prefix [0, pos] of the cache."""
    B, Hq, _, D = q.shape
    Hkv = cache_k.shape[1]
    group = Hq // Hkv
    ck = cache_k[:, :, :pos + 1]
    cv = cache_v[:, :, :pos + 1]
    qg = q.reshape(B, Hkv, group, D).to(cache_k.dtype)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.to(torch.float32),
                     ck.to(torch.float32)) * (D ** -0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    k_pos = torch.arange(pos + 1, device=q.device)   # all written
    if not isinstance(window, int):
        valid = torch.where(window > 0, (pos - k_pos) < window, True)
    elif window > 0:   # a host int masks without a host-to-device copy
        valid = (pos - k_pos) < window
    else:
        valid = torch.ones_like(k_pos, dtype=torch.bool)
    if start is None:
        mask = valid[None, None, None, :]
    else:
        mask = (valid[None, :]
                & (k_pos[None, :] >= start[:, None]))[:, None, None, :]
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd",
                     p.to(cache_v.dtype).to(torch.float32),
                     cv.to(torch.float32))
    return o.reshape(B, Hq, 1, D).to(q.dtype)
