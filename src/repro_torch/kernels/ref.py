"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

They are (a) the oracles the tuner and ``chip_smoke.py`` hold each CUDA kernel
against on the card, and (b) what a launch on CPU tensors runs. The term
functions are the single source of the stencil math, as in the reference.

Conventions kept from the reference: a shift closure ``s(o)`` returns the
field shifted by ``o`` cells, ``result[i] = f[i + o]`` (``torch.roll(f, -o)``),
periodic; the axis map is x -> 2, y -> 1, z -> 0; stencils compute in float32
and cast back to the input dtype. Attention keeps the reference's
conventions too: softmax in float32, masked scores at -1e30, fully masked
rows giving 0, and sequences of 1024 or more on both sides going through
the blockwise online-softmax path.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core.trip_count import scan

from . import sharded

# --------------------------------------------------------------------------
# advec_u: 2nd-order flux-form advection with 5th-order interpolation
# --------------------------------------------------------------------------

_C0, _C1, _C2 = 37.0 / 60.0, -8.0 / 60.0, 1.0 / 60.0


def advec_terms(su_x, su_y, su_z, sv_y, sw_z, dxi, dyi, dzi):
    """Advection tendency of u. Each ``s*`` is a shift closure s(offset)
    returning the field shifted by ``offset`` cells along one axis
    (result[idx] = field[idx + offset], periodic)."""

    def interp(s, o):
        # 5th-order interpolation to the face between cells o-1 and o
        return (_C0 * (s(o - 1) + s(o)) + _C1 * (s(o - 2) + s(o + 1))
                + _C2 * (s(o - 3) + s(o + 2)))

    fx_p = 0.5 * (su_x(0) + su_x(1)) * interp(su_x, 1)
    fx_m = 0.5 * (su_x(-1) + su_x(0)) * interp(su_x, 0)
    fy_p = 0.5 * (sv_y(0) + sv_y(1)) * interp(su_y, 1)
    fy_m = 0.5 * (sv_y(-1) + sv_y(0)) * interp(su_y, 0)
    fz_p = 0.5 * (sw_z(0) + sw_z(1)) * interp(su_z, 1)
    fz_m = 0.5 * (sw_z(-1) + sw_z(0)) * interp(su_z, 0)
    return -(dxi * (fx_p - fx_m) + dyi * (fy_p - fy_m)
             + dzi * (fz_p - fz_m))


ADVEC_FLOPS_PER_POINT = 78  # counted from advec_terms


def _roll_shift(f, axis):
    return lambda s: f if s == 0 else torch.roll(f, -s, axis)


def advec_u_ref(u, v, w, scal):
    """Oracle. scal is a (1, 4) f32 tensor [dxi, dyi, dzi, 0]."""
    dxi, dyi, dzi = scal[0, 0], scal[0, 1], scal[0, 2]
    u32 = u.to(torch.float32)
    v32 = v.to(torch.float32)
    w32 = w.to(torch.float32)
    ut = advec_terms(
        su_x=_roll_shift(u32, 2), su_y=_roll_shift(u32, 1),
        su_z=_roll_shift(u32, 0), sv_y=_roll_shift(v32, 1),
        sw_z=_roll_shift(w32, 0), dxi=dxi, dyi=dyi, dzi=dzi)
    return ut.to(u.dtype)


# --------------------------------------------------------------------------
# diff_uvw: 2nd-order diffusion of all three velocity components with a
# variable eddy viscosity
# --------------------------------------------------------------------------


def diff_term(sf, se, di):
    """One-axis variable-viscosity diffusion: d/dx( ev * du/dx )."""
    ev_p = 0.5 * (se(0) + se(1))
    ev_m = 0.5 * (se(-1) + se(0))
    return (di * di) * (ev_p * (sf(1) - sf(0)) - ev_m * (sf(0) - sf(-1)))


def diff_field(sf_x, sf_y, sf_z, se_x, se_y, se_z, dxi, dyi, dzi):
    return (diff_term(sf_x, se_x, dxi) + diff_term(sf_y, se_y, dyi)
            + diff_term(sf_z, se_z, dzi))


DIFF_FLOPS_PER_POINT_PER_FIELD = 27


def diff_one_ref(f, evisc, scal):
    """One field's tendency: the plain version of the single-field kernel."""
    dxi, dyi, dzi = scal[0, 0], scal[0, 1], scal[0, 2]
    e32 = evisc.to(torch.float32)
    f32 = f.to(torch.float32)
    se = [_roll_shift(e32, ax) for ax in (2, 1, 0)]
    sf = [_roll_shift(f32, ax) for ax in (2, 1, 0)]
    return diff_field(*sf, *se, dxi, dyi, dzi).to(f.dtype)


def diff_uvw_ref(u, v, w, evisc, scal):
    """Oracle: (ut, vt, wt)."""
    return tuple(diff_one_ref(f, evisc, scal) for f in (u, v, w))


# --------------------------------------------------------------------------
# matmul
# --------------------------------------------------------------------------


@contextlib.contextmanager
def ieee_f32():
    """Switch TF32 off for float32 products on the card inside the block
    (restored afterwards), so float32 means IEEE float32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matmul_ref(a, b):
    """f32 product written in A's dtype, with TF32 off."""
    with ieee_f32():
        out = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return out.to(a.dtype)


# --------------------------------------------------------------------------
# attention (full-featured oracle: GQA, causal, sliding window, softcap)
# --------------------------------------------------------------------------

NEG_INF = -1e30
BLOCKWISE_THRESHOLD = 1024  # blockwise path when Sq and Sk both reach this


def attention_ref(q, k, v, *, causal: bool = True, window=None,
                  softcap: float | None = None, scale: float | None = None,
                  kv_offset: int = 0):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, Dv). GQA via head repetition.

    ``window`` may be an int or a 0-d tensor (0/None = full).
    ``kv_offset``: absolute position of q[0] minus position of k[0].
    Long sequences dispatch to the blockwise online-softmax path. On
    ``DTensor``s that split the batch and heads alike, each rank attends
    its own shards (``kernels.sharded``)."""
    out = sharded.local_attention(
        attention_ref, q, k, v, causal=causal, window=window,
        softcap=softcap, scale=scale, kv_offset=kv_offset)
    if out is not None:
        return out
    Sq, Sk = q.shape[2], k.shape[2]
    if Sq >= BLOCKWISE_THRESHOLD and Sk >= BLOCKWISE_THRESHOLD:
        return blockwise_attention_ref(
            q, k, v, causal=causal, window=window, softcap=softcap,
            scale=scale, kv_offset=kv_offset)
    return _naive_attention_ref(q, k, v, causal=causal, window=window,
                                softcap=softcap, scale=scale,
                                kv_offset=kv_offset)


def _repeat_kv(q, k, v):
    rep = q.shape[1] // k.shape[1]
    if rep == 1:
        return k, v
    return k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)


def _mask(q_pos, k_pos, causal: bool, window):
    """(Sq, Sk) bool: causal and window conditions (window 0 = full)."""
    mask = torch.ones(q_pos.shape[0], k_pos.shape[1], dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        win = torch.as_tensor(window, device=q_pos.device)
        mask &= torch.where(win > 0, (q_pos - k_pos) < win, True)
    return mask


def _scores(qi, ki, scale, softcap):
    with ieee_f32():
        s = torch.einsum("bhqd,bhkd->bhqk", qi, ki) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s


def _naive_attention_ref(q, k, v, *, causal, window, softcap, scale,
                         kv_offset):
    Sq, D = q.shape[2], q.shape[3]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    k, v = _repeat_kv(q, k, v)
    s = _scores(q.to(torch.float32), k.to(torch.float32), scale, softcap)
    Sk = k.shape[2]
    q_pos = torch.arange(Sq, device=q.device)[:, None] + kv_offset
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = _mask(q_pos, k_pos, causal, window)[None, None]
    s = torch.where(mask, s, NEG_INF)
    # fully-masked rows produce 0 (matches the blockwise/flash convention)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    p = p / (p.sum(-1, keepdim=True) + 1e-30)
    with ieee_f32():
        o = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    return o.to(q.dtype)


def blockwise_attention_ref(q, k, v, *, causal: bool = True, window=None,
                            softcap: float | None = None,
                            scale: float | None = None, kv_offset: int = 0,
                            q_chunk: int = 512, k_chunk: int = 1024):
    """Flash-style attention in plain PyTorch: loops over q and k chunks
    with an online softmax, O(Sq·k_chunk) live memory instead of O(Sq·Sk).
    Same math as :func:`_naive_attention_ref` up to fp reassociation. The
    reference pads the last chunks and masks the padded keys; slicing them
    off instead leaves every sum the same.

    Every (q chunk, k chunk) pair runs, the causally masked ones too, so
    where the chunks divide the sequences each pair costs the same, and
    both loops are ``core.trip_count.scan``s: a counter folding loops (on
    ``meta``) counts the forward and backward of every pair from three.
    On real tensors every pair runs."""
    B, Hq, Sq, D = q.shape
    Sk, Dv = k.shape[2], v.shape[3]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    k, v = _repeat_kv(q, k, v)
    qc, kc = min(q_chunk, Sq), min(k_chunk, Sk)

    def k_step(j, carry, qi, qp, k, v):
        m, l, acc = carry
        k0 = j * kc
        ki = k[:, :, k0:k0 + kc].to(torch.float32)
        vi = v[:, :, k0:k0 + kc].to(torch.float32)
        kp = torch.arange(k0, k0 + ki.shape[2], device=q.device)[None, :]
        s = _scores(qi, ki, scale, softcap)
        mask = _mask(qp, kp, causal, window)[None, None]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        # explicit zero for masked entries: in a fully-masked chunk
        # s == m_new == -1e30 and exp(s - m_new) would be 1, not 0
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        with ieee_f32():
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vi)
        return (m_new, l, acc), None

    def q_step(i, carry, q, k, v):
        q0 = i * qc
        qi = q[:, :, q0:q0 + qc].to(torch.float32)
        n = qi.shape[2]
        qp = torch.arange(q0, q0 + n, device=q.device)[:, None] + kv_offset
        m = torch.full((B, Hq, n, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, Hq, n, 1), device=q.device)
        acc = torch.zeros((B, Hq, n, Dv), device=q.device)
        (m, l, acc), _ = _chunks(Sk, kc, k_step, (m, l, acc), (qi, qp, k, v))
        return carry, acc / torch.clamp(l, min=1e-30)

    _, out = _chunks(Sq, qc, q_step, (), (q, k, v), dim=2)
    return out.to(q.dtype)


def _chunks(total: int, chunk: int, step, carry, xs, dim: int = 0):
    """``step`` over the ``chunk``-long pieces of ``total``: a
    ``trip_count.scan`` where they are whole (each costs the same), else
    every piece in turn, the last one shorter."""
    if total % chunk == 0:
        return scan(total // chunk, step, carry, xs, dim=dim)
    outs = []
    for i in range(-(-total // chunk)):
        carry, out = step(i, carry, *xs)
        outs.append(out)
    return carry, None if outs[0] is None else torch.cat(outs, dim)


def flash_attention_ref_factory(causal: bool):
    """Plain version of the flash kernel, in its flattened-head layout:
    q, k: (BH or BHkv, S, D), v: (BHkv, S, Dv), an optional softmax
    ``scale`` (default D^-0.5)."""

    def flash_attention_ref(q, k, v, scale=None):
        group = q.shape[0] // k.shape[0]
        k_e = k.repeat_interleave(group, dim=0)
        v_e = v.repeat_interleave(group, dim=0)
        o = attention_ref(q[:, None], k_e[:, None], v_e[:, None],
                          causal=causal, scale=scale)
        return o[:, 0]

    return flash_attention_ref


def flash_attention_bwd_ref_factory(causal: bool):
    """Plain version of the flash backward kernel: (dq, dk, dv) of the
    plain forward (:func:`flash_attention_ref_factory`) recomputed from q,
    k and v, by autograd against the output's gradient ``do``. The
    gradients come in the inputs' dtype."""
    forward = flash_attention_ref_factory(causal)

    def flash_attention_bwd_ref(q, k, v, do, scale=None):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
            return torch.autograd.grad(forward(*inputs, scale=scale),
                                       inputs, do)

    return flash_attention_bwd_ref
