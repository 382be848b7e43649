"""The MicroHH stencils of the paper's section 5, written plainly.

A shift ``s(o)`` is the field moved by ``o`` cells with periodic wrap,
``s(o)[i] = f[i + o]`` (``torch.roll(f, -o)``), along x (axis 2), y (axis
1) or z (axis 0). ``advec_u`` is second-order flux-form advection of u with
fifth-order interpolation to the faces; ``diff_uvw`` second-order diffusion
of u, v and w with a variable eddy viscosity.

``dtype`` is what the arithmetic runs in: float32 for the reference,
bfloat16 for its control.
"""

from __future__ import annotations

import torch

C0, C1, C2 = 37.0 / 60.0, -8.0 / 60.0, 1.0 / 60.0


def _shift(f, axis):
    return lambda o: f if o == 0 else torch.roll(f, -o, axis)


def _interp(s, o):
    """Fifth-order interpolation to the face between cells o - 1 and o."""
    return (C0 * (s(o - 1) + s(o)) + C1 * (s(o - 2) + s(o + 1))
            + C2 * (s(o - 3) + s(o + 2)))


def advec_u(u, v, w, dxi, dyi, dzi, dtype=torch.float32):
    u, v, w = (t.to(dtype) for t in (u, v, w))
    ux, uy, uz = _shift(u, 2), _shift(u, 1), _shift(u, 0)
    vy, wz = _shift(v, 1), _shift(w, 0)
    out = torch.zeros_like(u)
    for di, adv, su in ((dxi, ux, ux), (dyi, vy, uy), (dzi, wz, uz)):
        flux_p = 0.5 * (adv(0) + adv(1)) * _interp(su, 1)
        flux_m = 0.5 * (adv(-1) + adv(0)) * _interp(su, 0)
        out -= di * (flux_p - flux_m)
        del flux_p, flux_m
    return out


def _diff_one(f, evisc, dxi, dyi, dzi):
    out = torch.zeros_like(f)
    for axis, di in ((2, dxi), (1, dyi), (0, dzi)):
        sf, se = _shift(f, axis), _shift(evisc, axis)
        ev_p = 0.5 * (se(0) + se(1))
        ev_m = 0.5 * (se(-1) + se(0))
        out += (di * di) * (ev_p * (sf(1) - sf(0)) - ev_m * (sf(0) - sf(-1)))
    return out


def diff_uvw(u, v, w, evisc, dxi, dyi, dzi, dtype=torch.float32):
    """(ut, vt, wt)."""
    e = evisc.to(dtype)
    return tuple(_diff_one(f.to(dtype), e, dxi, dyi, dzi) for f in (u, v, w))
