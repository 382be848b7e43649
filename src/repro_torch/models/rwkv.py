"""RWKV-6 (Finch) mixer: token-shift mixing, data-dependent decay via a
low-rank projection, per-head wkv state recurrence; plus the RWKV
channel-mix FFN (port of ``repro.models.rwkv``). Attention-free: decode
carries only (state, previous token).

The reference scans the wkv recurrence over the sequence with
``lax.scan``; the port runs it as a Python loop over S on the f32 state
(B, H, hd, hd), two device operations a token (a ``bmm`` and an
``addcmul``): the bonus term ``r_t . (u * k_t) v_t`` is computed for
every token before the loop (it reads no state), and each chunk of
``WKV_CHUNK`` tokens forms its outer products ``k_t v_t^T`` in one
operation. The reference computes all of this in jnp, outside any Pallas
kernel, so the port's is plain PyTorch on the tensors' device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init, dt
from .config import ArchConfig

#: Tokens whose k v^T outer products are formed together in the wkv loop.
WKV_CHUNK = 64


def n_rwkv_heads(cfg: ArchConfig) -> int:
    return cfg.d_model // cfg.rwkv.head_dim


def init_rwkv(generator, cfg: ArchConfig, device) -> dict:
    c = cfg.rwkv
    d = cfg.d_model
    dtype = dt(cfg)

    def dense(shape):
        return dense_init(generator, shape, dtype, device)

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {
        # time-mix
        "mu": zeros((5, d)),                             # r,k,v,w,g mixing
        "w_r": dense((d, d)),
        "w_k": dense((d, d)),
        "w_v": dense((d, d)),
        "w_g": dense((d, d)),
        "w_o": dense((d, d)),
        "decay_base": zeros((d,)),
        "decay_a": dense((d, c.decay_lora)),
        "decay_b": dense((c.decay_lora, d)),
        "bonus": zeros((d,)),                            # u
        "ln_x": {"scale": torch.ones(d, dtype=torch.float32, device=device)},
        # channel-mix
        "mu_c": zeros((2, d)),
        "cm_r": dense((d, d)),
        "cm_k": dense((d, cfg.d_ff)),
        "cm_v": dense((cfg.d_ff, d)),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor | None = None
           ) -> torch.Tensor:
    """Previous-token view of x: (B, S, D). prev: (B, D) carried context."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None, :], x[:, :-1]], dim=1)


def _mix(x, xx, mu):
    return x + (xx - x) * mu.to(x.dtype)


def _decay(cfg: ArchConfig, p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel decay in (0, 1): w = exp(-exp(...))."""
    lora = torch.tanh(xw @ p["decay_a"].to(xw.dtype)) \
        @ p["decay_b"].to(xw.dtype)
    logit = p["decay_base"].to(torch.float32) + lora.to(torch.float32)
    return torch.exp(-torch.exp(logit))


def _group_norm(p, y):
    """Per-head group norm of the wkv output. y: (B, S, H, hd). The
    population variance, as ``jnp.var``."""
    y32 = y.to(torch.float32)
    mean = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, correction=0)
    yn = (y32 - mean) * torch.rsqrt(var + 1e-5)
    B, S, H, hd = y.shape
    scale = p["ln_x"]["scale"].reshape(H, hd)
    return (yn * scale).reshape(B, S, H * hd)


def _rkvwg(cfg, p, x, xx):
    mu = p["mu"]
    r = _mix(x, xx, mu[0]) @ p["w_r"].to(x.dtype)
    k = _mix(x, xx, mu[1]) @ p["w_k"].to(x.dtype)
    v = _mix(x, xx, mu[2]) @ p["w_v"].to(x.dtype)
    w = _decay(cfg, p, _mix(x, xx, mu[3]))
    g = F.silu(_mix(x, xx, mu[4]) @ p["w_g"].to(x.dtype))
    return r, k, v, w, g


def _wkv_step(u, h, r_t, k_t, v_t, w_t):
    """h: (B, H, hd, hd) state [k-dim, v-dim]; r/k/v/w_t: (B, H, hd).
    Returns (new state, y (B, H, hd))."""
    kv = k_t[..., :, None] * v_t[..., None, :]           # (B,H,hd,hd)
    y = torch.einsum("bhk,bhkv->bhv", r_t, h + u[..., :, None] * kv)
    h = w_t[..., :, None] * h + kv
    return h, y


def _wkv_scan(u, r, k, v, w):
    """The wkv recurrence over S tokens from a zero state; r/k/v/w:
    (B, S, H, hd) f32. y_t = r_t (h_{t-1} + diag(u) k_t v_t^T), h_t =
    diag(w_t) h_{t-1} + k_t v_t^T. The loop keeps the state as (B*H, hd,
    hd) so each token is one ``bmm`` and one ``addcmul``. Returns (h_S
    (B, H, hd, hd), y (B, S, H, hd))."""
    B, S, H, hd = r.shape
    bonus = (r * u * k).sum(-1, keepdim=True) * v         # (B,S,H,hd)

    def seq_major(a):                                     # (S, B*H, hd)
        return a.transpose(0, 1).reshape(S, B * H, hd)

    r, k, v, w = (seq_major(a) for a in (r, k, v, w))
    h = torch.zeros((B * H, hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    for s0 in range(0, S, WKV_CHUNK):
        sl = slice(s0, s0 + WKV_CHUNK)
        kv = (k[sl, :, :, None] * v[sl, :, None, :]).unbind(0)
        for r_t, kv_t, w_t in zip(r[sl, :, None, :].unbind(0), kv,
                                  w[sl, :, :, None].unbind(0)):
            ys.append(torch.bmm(r_t, h))                  # (B*H, 1, hd)
            h = torch.addcmul(kv_t, w_t, h)
    y = torch.stack(ys).reshape(S, B, H, hd).transpose(0, 1)
    return h.reshape(B, H, hd, hd), y + bonus


def rwkv_time_mix(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    return _time_mix_core(cfg, p, x)[0]


def rwkv_time_mix_prefill(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """Returns (out, final wkv state, last-token shift context)."""
    return _time_mix_core(cfg, p, x)


def _time_mix_core(cfg: ArchConfig, p: dict, x: torch.Tensor):
    H = n_rwkv_heads(cfg)
    hd = cfg.rwkv.head_dim
    B, S, D = x.shape
    xx = _shift(x)
    r, k, v, w, g = _rkvwg(cfg, p, x, xx)

    def to_h(a):
        return a.to(torch.float32).reshape(B, S, H, hd)

    u = p["bonus"].to(torch.float32).reshape(H, hd)
    h_final, y = _wkv_scan(u, to_h(r), to_h(k), to_h(v), to_h(w))
    y = _group_norm(p, y).to(x.dtype) * g
    out = y @ p["w_o"].to(x.dtype)
    return out, h_final, x[:, -1]


def rwkv_channel_mix_prefill(cfg: ArchConfig, p: dict, x: torch.Tensor):
    return rwkv_channel_mix(cfg, p, x), x[:, -1]


def _channel_mix(p, x, xx):
    mu = p["mu_c"]
    r = torch.sigmoid(_mix(x, xx, mu[0]) @ p["cm_r"].to(x.dtype))
    k = _mix(x, xx, mu[1]) @ p["cm_k"].to(x.dtype)
    k = torch.square(F.relu(k))
    return r * (k @ p["cm_v"].to(x.dtype))


def rwkv_channel_mix(cfg: ArchConfig, p: dict, x: torch.Tensor
                     ) -> torch.Tensor:
    return _channel_mix(p, x, _shift(x))


# --------------------------------------------------------------- decode ----

def init_rwkv_cache(cfg: ArchConfig, n_layers: int, batch: int, dtype,
                    device) -> dict:
    H, hd = n_rwkv_heads(cfg), cfg.rwkv.head_dim
    d = cfg.d_model
    return {
        "wkv": torch.zeros((n_layers, batch, H, hd, hd), dtype=torch.float32,
                           device=device),
        # time-mix and channel-mix shifts
        "prev_t": torch.zeros((n_layers, batch, d), dtype=dtype,
                              device=device),
        "prev_c": torch.zeros((n_layers, batch, d), dtype=dtype,
                              device=device),
    }


def rwkv_time_mix_decode(cfg: ArchConfig, p: dict, x: torch.Tensor,
                         wkv_state, prev_t):
    """x: (B, 1, D). Returns (out, new_wkv, new_prev_t)."""
    H, hd = n_rwkv_heads(cfg), cfg.rwkv.head_dim
    B = x.shape[0]
    xx = _shift(x, prev=prev_t.to(x.dtype))
    r, k, v, w, g = _rkvwg(cfg, p, x, xx)

    def to_h(a):
        return a[:, 0].to(torch.float32).reshape(B, H, hd)

    u = p["bonus"].to(torch.float32).reshape(H, hd)[None]
    h, y = _wkv_step(u, wkv_state, to_h(r), to_h(k), to_h(v), to_h(w))
    y = _group_norm(p, y.reshape(B, 1, H, hd)).to(x.dtype) * g
    out = y @ p["w_o"].to(x.dtype)
    return out, h, x[:, -1]


def rwkv_channel_mix_decode(cfg: ArchConfig, p: dict, x: torch.Tensor,
                            prev_c):
    xx = _shift(x, prev=prev_c.to(x.dtype))
    return _channel_mix(p, x, xx), x[:, -1]
