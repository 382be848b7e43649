"""Selective SSM (Mamba) mixer, used by hymba's parallel attention + mamba
heads (port of ``repro.models.mamba``).

Prefill runs the selective scan chunk by chunk: inside a chunk of
``MAMBA_CHUNK`` tokens (halved while it does not divide S) a log-depth
(Hillis-Steele) scan over the chunk axis, in place of the reference's
``lax.associative_scan``; across chunks a Python loop carries the f32
state (B, d_inner, d_state); the chunks are a ``core.trip_count.scan``,
which a counter on ``meta`` folds. Decode is one recurrence step with the
state held in the serve cache. The short causal depthwise conv is a sum
of shifted views (no conv primitive), as in the reference. Shifts pad with
a ``torch.cat`` of a zero (or one) slice, which ``DTensor`` plans where it
cannot plan ``F.pad``; the values are the same.

The reference computes all of this in jnp, outside any Pallas kernel, so
the port's is plain PyTorch on the tensors' device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.core.trip_count import scan

from .common import dense_init, dt, reduce_partial
from .config import ArchConfig


def d_inner(cfg: ArchConfig) -> int:
    return cfg.mamba.expand * cfg.d_model


def init_mamba(generator, cfg: ArchConfig, device) -> dict:
    m = cfg.mamba
    d, di = cfg.d_model, d_inner(cfg)
    dtype = dt(cfg)
    return {
        "w_in": dense_init(generator, (d, 2 * di), dtype, device),
        "conv_w": dense_init(generator, (m.d_conv, di), dtype, device),
        "w_bcdt": dense_init(generator, (di, 2 * m.d_state + 1), dtype,
                             device),
        "dt_bias": torch.zeros(di, dtype=torch.float32, device=device),
        "A_log": torch.zeros((di, m.d_state), dtype=torch.float32,
                             device=device),
        "D_skip": torch.ones(di, dtype=torch.float32, device=device),
        "w_out": dense_init(generator, (di, d), dtype, device),
    }


def _split_xz(cfg, p, x):
    xz = x @ p["w_in"].to(x.dtype)
    di = d_inner(cfg)
    return xz[..., :di], xz[..., di:]


def _conv(p, xp, prev_window=None):
    """Causal depthwise conv along seq; xp: (B, S, di).
    prev_window: (B, d_conv-1, di) trailing context for decode."""
    w = p["conv_w"].to(xp.dtype)                      # (d_conv, di)
    d_conv = w.shape[0]
    if prev_window is not None:
        xp_full = torch.cat([prev_window.to(xp.dtype), xp], dim=1)
    else:
        zeros = torch.zeros_like(xp[:, :1]).expand(-1, d_conv - 1, -1)
        xp_full = torch.cat([zeros, xp], dim=1)
    S = xp.shape[1]
    out = sum(xp_full[:, i:i + S, :] * w[d_conv - 1 - i]
              for i in range(d_conv))
    return F.silu(out)


def _ssm_inputs(cfg, p, xc):
    """Per-token B, C (B, S, N) and the dt logit (B, S, 1), shared across
    channels, upcast to float32 from one product."""
    m = cfg.mamba
    bcdt = reduce_partial(xc @ p["w_bcdt"].to(xc.dtype))
    B_t = bcdt[..., :m.d_state].to(torch.float32)
    C_t = bcdt[..., m.d_state:2 * m.d_state].to(torch.float32)
    dt_t = bcdt[..., -1:].to(torch.float32)
    return B_t, C_t, dt_t


def mamba_forward(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    return _mamba_core(cfg, p, x)[0]


def mamba_prefill(cfg: ArchConfig, p: dict, x: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Parallel prefill. Returns (out, final ssm state, conv window)."""
    return _mamba_core(cfg, p, x)


MAMBA_CHUNK = 128   # log-depth scan span; sequential across chunks


def chunk_len(S: int) -> int:
    """The reference's chunk rule: MAMBA_CHUNK (or S if shorter), halved
    while it does not divide S."""
    q = MAMBA_CHUNK if S >= MAMBA_CHUNK else S
    while S % q:
        q //= 2
    return q


def _scan_chunk(h0, xq, bq, cq, dtq, A):
    """One chunk: h_t = a_t h_{t-1} + b_t from h0, with a = exp(dt A) and
    b = (dt x) B^T, as an inclusive Hillis-Steele scan of the pairs (a, b)
    under (a_l, b_l) . (a_r, b_r) = (a_l a_r, a_r b_l + b_r) over the
    chunk axis: ceil(log2 q) doubling steps. Returns (h_q, y (B, q, di))."""
    a = torch.exp(dtq[..., None] * A)                        # (B,q,di,N)
    b = (dtq * xq)[..., None] * bq[:, :, None, :]            # (B,q,di,N)
    q = a.shape[1]
    d = 1
    while d < q:
        # positions t < d combine with the identity (1, 0)
        a_prev = torch.cat([torch.ones_like(a[:, :d]), a[:, :-d]], dim=1)
        b_prev = torch.cat([torch.zeros_like(b[:, :d]), b[:, :-d]], dim=1)
        b = torch.addcmul(b, a, b_prev)
        a = a * a_prev
        d *= 2
    h = torch.addcmul(b, a, h0[:, None])                     # (B,q,di,N)
    y = torch.einsum("bqdn,bqn->bqd", h, cq)
    return h[:, -1], y


def _chunked_selective_scan(xc32, B_t, C_t, dt_ch, A, d_state: int):
    """Selective scan h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t^T,
    y_t = h_t C_t, in chunks of :func:`chunk_len` tokens, the state
    carried across chunks. Each chunk runs under ``torch.utils.checkpoint``
    when autograd records, as the reference remats each chunk: the backward
    keeps only the chunk-boundary states."""
    Bb, S, di = xc32.shape
    q = chunk_len(S)
    h = torch.zeros((Bb, di, d_state), dtype=torch.float32,
                    device=xc32.device)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xc32, B_t, C_t, dt_ch, A))
    def step(c, carry, A, xq, bq, cq, dtq):
        args = (carry[0], xq, bq, cq, dtq, A)
        if grad:
            h, y = checkpoint(_scan_chunk, *args, use_reentrant=False)
        else:
            h, y = _scan_chunk(*args)
        return (h,), y

    (h,), y = scan(S // q, step, (h,), (A,), (xc32, B_t, C_t, dt_ch), dim=1)
    return y, h


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``F.softplus``; on a ``DTensor`` the same values from ops whose
    gradients ``DTensor`` shards (it has no rule for softplus or its
    gradient in torch 2.11)."""
    if not isinstance(x, DTensor):
        return F.softplus(x)
    return torch.where(x > 20, x, torch.log1p(torch.exp(x.clamp(max=20))))


def _mamba_core(cfg: ArchConfig, p: dict, x: torch.Tensor):
    m = cfg.mamba
    S = x.shape[1]
    xp, z = _split_xz(cfg, p, x)
    xc = _conv(p, xp)                                        # (B, S, di)
    B_t, C_t, dt_t = _ssm_inputs(cfg, p, xc)
    A = -torch.exp(p["A_log"].to(torch.float32))             # (di, N)
    # per-channel dt via learned bias: (B, S, di)
    dt_ch = _softplus(dt_t + p["dt_bias"].to(torch.float32))
    xc32 = xc.to(torch.float32)
    y, h_final = _chunked_selective_scan(xc32, B_t, C_t, dt_ch, A,
                                         m.d_state)
    y = y + xc32 * p["D_skip"].to(torch.float32)
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["w_out"].to(x.dtype)
    conv_win = xp[:, S - (m.d_conv - 1):, :]                 # (B, dc-1, di)
    return out, h_final, conv_win


# --------------------------------------------------------------- decode ----

def init_mamba_cache(cfg: ArchConfig, n_layers: int, batch: int, dtype,
                     device) -> dict:
    m = cfg.mamba
    di = d_inner(cfg)
    return {
        "ssm": torch.zeros((n_layers, batch, di, m.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((n_layers, batch, m.d_conv - 1, di), dtype=dtype,
                            device=device),
    }


def mamba_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, ssm_state,
                 conv_win) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token. x: (B, 1, D); ssm_state: (B, di, N);
    conv_win: (B, d_conv-1, di). Returns (out, new state, new window)."""
    xp, z = _split_xz(cfg, p, x)                             # (B,1,di)
    xc = _conv(p, xp, prev_window=conv_win)                  # (B,1,di)
    new_win = torch.cat([conv_win[:, 1:], xp.to(conv_win.dtype)], dim=1)
    B_t, C_t, dt_t = _ssm_inputs(cfg, p, xc)
    dt_ch = _softplus(dt_t + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["A_log"].to(torch.float32))
    xt = xc[:, 0].to(torch.float32)
    bt, ct, dtt = B_t[:, 0], C_t[:, 0], dt_ch[:, 0]
    decay = torch.exp(dtt[..., None] * A)
    h = decay * ssm_state + (dtt * xt)[..., None] * bt[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, ct)[:, None, :]        # (B,1,di)
    y = y + xc.to(torch.float32) * p["D_skip"].to(torch.float32)
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["w_out"].to(x.dtype)
    return out, h, new_win
