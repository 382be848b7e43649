"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

They are (a) the oracles the tuner and ``chip_smoke.py`` hold each CUDA kernel
against on the card, and (b) what a launch on CPU tensors runs. The term
functions are the single source of the stencil math, as in the reference.

Conventions kept from the reference: a shift closure ``s(o)`` returns the
field shifted by ``o`` cells, ``result[i] = f[i + o]`` (``torch.roll(f, -o)``),
periodic; the axis map is x -> 2, y -> 1, z -> 0; stencils compute in float32
and cast back to the input dtype. The attention oracles belong to the
second port slice.
"""

from __future__ import annotations

import torch

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


def matmul_ref(a, b):
    """f32 product written in A's dtype. On the card TF32 is switched off
    for the call, so float32 means IEEE float32 (restored afterwards)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out.to(a.dtype)
