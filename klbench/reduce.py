"""Helpers the per-layer readers (``klbench/metrics/<metric>.py``) share.

A reader is ``read(view, ctx) -> float | None``: ``view`` the traced
window (``klbench.trace.TraceView``), ``ctx`` what the cell's loop says of
the work in it. A reader that finds nothing to read returns None, and the
metric is left out of the line.
"""

from __future__ import annotations

from klbench.counts import peaks, stencils


def range_kernels(view, name: str) -> list[tuple[object, list]]:
    """(range, its kernels) for every benchmark range ``name`` in the
    window."""
    w0, w1 = view.window.ts, view.window.end
    return [(r, view.kernels_in(r)) for r in view.ranges.get(name, ())
            if r.ts >= w0 and r.end <= w1]


def seconds(events) -> float:
    return sum(e.dur for e in events) / 1e6


def share(x: float) -> float:
    return 100.0 * x


def idle_share(view, ctx) -> float | None:
    """The device's idle share of the traced window, in percent."""
    if view.window is None or view.busy_s <= 0:
        return None
    return share(1.0 - view.busy_s / view.window_s)


def roofline(view, name: str, bound_s: float) -> float | None:
    """The bound over the mean device time of the kernels launched inside
    each ``name`` range, in percent."""
    hits = [ks for _, ks in range_kernels(view, name) if ks]
    if not hits:
        return None
    return share(len(hits) * bound_s / sum(seconds(ks) for ks in hits))


def mfu(flops: float, window_s: float, dtype: str = "bfloat16"
        ) -> float | None:
    if window_s <= 0 or flops <= 0:
        return None
    return share(flops / (window_s * peaks.flops_peak(dtype)))


def stencil_bound_s(op, ctx) -> float:
    """The frozen bound of one call of ``op`` (``stencils.advec_u`` or
    ``stencils.diff_uvw``) at the cell's grid and dtype."""
    return peaks.bound_s(*op(ctx["grid"], ctx["dtype"]), ctx["dtype"])


def advec_u_roofline(view, ctx):
    """advec_u's share of its roofline: the bound of one call (78 flops a
    point; u, v, w read and ut written once) over the mean device time of
    the kernels launched inside each ``klbench.advec_u`` range."""
    return roofline(view, "klbench.advec_u",
                    stencil_bound_s(stencils.advec_u, ctx))


def diff_uvw_roofline(view, ctx):
    """diff_uvw's share of its roofline: the bound of one call (81 flops a
    point; u, v, w, evisc read and three tendencies written once, whether
    one launch or three runs) over the mean device time of the kernels
    launched inside each ``klbench.diff_uvw`` range."""
    return roofline(view, "klbench.diff_uvw",
                    stencil_bound_s(stencils.diff_uvw, ctx))


def launch_overhead_us(view, ctx):
    """The launch path's host time a MicroHH op call: the op ranges' host
    duration minus the device time of the kernels launched inside them,
    averaged over the calls (selection, the scalar block's copy, the
    per-launch event sync and the bookkeeping)."""
    calls = [(r, ks) for name in ("klbench.advec_u", "klbench.diff_uvw")
             for r, ks in range_kernels(view, name) if ks]
    if not calls:
        return None
    host = sum(r.dur for r, _ in calls) / 1e6
    return 1e6 * (host - sum(seconds(ks) for _, ks in calls)) / len(calls)
