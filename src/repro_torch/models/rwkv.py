"""RWKV-6 (Finch) mixer: token-shift mixing, data-dependent decay via a
low-rank projection, per-head wkv state recurrence; plus the RWKV
channel-mix FFN (port of ``repro.models.rwkv``). Attention-free: decode
carries only (state, previous token).

The reference scans the wkv recurrence over the sequence with
``lax.scan``; the port runs it as a Python loop over S on the f32 state
(B, H, hd, hd), two device operations a token (a ``bmm`` over the
flattened (B*H) state and an ``addcmul``): the bonus term ``r_t . (u *
k_t) v_t`` is computed for every token before the loop (it reads no
state), and each chunk of ``WKV_CHUNK`` tokens forms its outer products
``k_t v_t^T`` in one operation. On ``DTensor``s that split the batch and
the heads (on two mesh dims, which a (B*H) flatten of the ``DTensor``
could not join) the recurrence runs on each rank's shards
(``kernels.sharded.per_shard``), as the reference's partitioner splits
its scan; the chunks are a ``core.trip_count.scan``, which a counter on
``meta`` folds.
The reference computes all of this in jnp, outside any Pallas kernel, so
the port's is plain PyTorch on the tensors' device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.trip_count import scan
from repro_torch.kernels import sharded

from .common import dense_init, dt, reduce_partial, split_heads
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
        # a zero first row, as F.pad (which DTensor cannot plan) gives it
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    return torch.cat([prev[:, None, :], x[:, :-1]], dim=1)


def _mix(x, xx, mu):
    return x + (xx - x) * mu.to(x.dtype)


def _decay(cfg: ArchConfig, p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel decay in (0, 1): w = exp(-exp(...))."""
    lora = reduce_partial(torch.tanh(xw @ p["decay_a"].to(xw.dtype))
                          @ p["decay_b"].to(xw.dtype))
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
    """h: (B, H, hd, hd) state [k-dim, v-dim]; u: (1, H, hd); r/k/v/w_t:
    (B, H, hd). Returns (new state, y (B, H, hd))."""
    out = sharded.per_shard(_wkv_step_local, (u, h, r_t, k_t, v_t, w_t),
                            ((None, 1),) + ((0, 1),) * 5, ((0, 1), (0, 1)))
    return out if out is not None else _wkv_step_local(u, h, r_t, k_t, v_t,
                                                       w_t)


def _wkv_step_local(u, h, r_t, k_t, v_t, w_t):
    kv = k_t[..., :, None] * v_t[..., None, :]           # (B,H,hd,hd)
    y = torch.einsum("bhk,bhkv->bhv", r_t, h + u[..., :, None] * kv)
    h = w_t[..., :, None] * h + kv
    return h, y


def _wkv_scan(u, r, k, v, w):
    """The wkv recurrence over S tokens from a zero state; u: (H, hd);
    r/k/v/w: (B, S, H, hd) f32; per shard on ``DTensor``s (see
    :func:`_wkv_scan_local`)."""
    out = sharded.per_shard(_wkv_scan_local, (u, r, k, v, w),
                            ((None, 0),) + ((0, 2),) * 4, ((0, 1), (0, 2)))
    return out if out is not None else _wkv_scan_local(u, r, k, v, w)


def _wkv_scan_local(u, r, k, v, w):
    """The wkv recurrence over S tokens from a zero state; r/k/v/w:
    (B, S, H, hd) f32. y_t = r_t (h_{t-1} + diag(u) k_t v_t^T), h_t =
    diag(w_t) h_{t-1} + k_t v_t^T. Each token is one ``bmm`` and one
    ``addcmul`` (:func:`_wkv_chunk`). The whole chunks are a
    ``trip_count.scan``: a folding counter runs the first and counts it
    for all, forward and backward. Returns (h_S (B, H, hd, hd), y (B, S,
    H, hd))."""
    B, S, H, hd = r.shape
    bonus = (r * u * k).sum(-1, keepdim=True) * v         # (B,S,H,hd)
    # sequence-major views (S, B, H, hd)
    r, k, v, w = (a.transpose(0, 1) for a in (r, k, v, w))
    h = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)

    def step(c, carry, r, k, v, w):
        h, y = _wkv_chunk(carry[0], r, k, v, w)
        return (h,), y

    n, tail = divmod(S, WKV_CHUNK)
    seqs = (r, k, v, w) if not tail else tuple(
        a[:n * WKV_CHUNK] for a in (r, k, v, w))
    (h,), y = scan(n, step, (h,), seqs=seqs)
    ys = [] if y is None else [y]
    if tail:
        h, y = _wkv_chunk(h, *(a[n * WKV_CHUNK:] for a in (r, k, v, w)))
        ys.append(y)
    y = torch.cat(ys)[..., 0, :].transpose(0, 1)          # (B, S, H, hd)
    return h, y + bonus


def _wkv_chunk(h, r, k, v, w):
    """The recurrence over a chunk of sequence-major r/k/v/w (c, B, H,
    hd) from the state h (B, H, hd, hd): (h after it, y (c, B, H, 1,
    hd)). A chunk runs on plain tensors (``per_shard`` gives it a rank's
    shards), so it flattens (B, H) to keep each token at one ``bmm`` and
    one ``addcmul``."""
    c, B, H, hd = r.shape
    r, k, v, w = (a.reshape(c, B * H, hd) for a in (r, k, v, w))
    h = h.reshape(B * H, hd, hd)
    ys = []
    kv = (k[:, :, :, None] * v[:, :, None, :]).unbind(0)
    for r_t, kv_t, w_t in zip(r[:, :, None, :].unbind(0), kv,
                              w[:, :, :, None].unbind(0)):
        ys.append(torch.bmm(r_t, h))                      # (B*H, 1, hd)
        h = torch.addcmul(kv_t, w_t, h)
    return h.reshape(B, H, hd, hd), torch.stack(ys).reshape(c, B, H, 1, hd)


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
        return split_heads(a.to(torch.float32), H, hd)

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
        return split_heads(a.to(torch.float32), H, hd)[:, 0]

    u = p["bonus"].to(torch.float32).reshape(H, hd)[None]
    h, y = _wkv_step(u, wkv_state, to_h(r), to_h(k), to_h(v), to_h(w))
    y = _group_norm(p, y.reshape(B, 1, H, hd)).to(x.dtype) * g
    out = y @ p["w_o"].to(x.dtype)
    return out, h, x[:, -1]


def rwkv_channel_mix_decode(cfg: ArchConfig, p: dict, x: torch.Tensor,
                            prev_c):
    xx = _shift(x, prev=prev_c.to(x.dtype))
    return _channel_mix(p, x, xx), x[:, -1]
