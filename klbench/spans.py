"""Helpers for the per-layer readers of the program's own spans.

While a profiler is on, the program (``repro_torch``) opens a
``record_function`` range named ``repro_torch.<name>`` at each of its layer
boundaries (``repro_torch.obs.span``): ``launch`` around a kernel call,
with ``select``, ``build`` (a compile-cache miss), ``enqueue`` and
``sync`` inside it; ``scalars``, ``attn_backward``, ``accumulate`` and
``optimizer``. A ``--trace 1`` window holds them beside the benchmark's
``klbench.*`` ranges and the kernels they launched, joined by correlation
id. The spans are host times; the kernels device times, which the
profiler may shift against the host's by up to milliseconds in a session,
so a reader compares times of one side only. A program without the spans
gives these readers nothing to read: they return None, and the line
leaves the metric out.
"""

from __future__ import annotations

import bisect

from klbench.reduce import range_kernels, seconds, share

PREFIX = "repro_torch."


def spans(view, name: str) -> list:
    """The program's spans ``name`` inside the window, by start."""
    if view.window is None:
        return []
    w0, w1 = view.window.ts, view.window.end
    return sorted((r for r in view.ranges.get(PREFIX + name, ())
                   if r.ts >= w0 and r.end <= w1), key=lambda r: r.ts)


def launch_host_us(view, ctx) -> float | None:
    """The launch path's host time a launch: the mean over the window's
    ``launch`` spans of the span's duration less its ``sync`` child's,
    the host work the device waits through while the per-launch sync
    stands."""
    launches = spans(view, "launch")
    if not launches:
        return None
    syncs = spans(view, "sync")
    starts = [r.ts for r in syncs]
    host = 0.0
    for r in launches:
        host += r.dur
        i = bisect.bisect_left(starts, r.ts)
        for s in syncs[i:]:
            if s.ts > r.end:
                break
            if s.tid == r.tid and s.end <= r.end:
                host -= s.dur
    return host / len(launches)


def synced_kernel_ends(view) -> list[float]:
    """The device end of the kernels each synced launch waited for: for
    every ``sync`` span, the kernels launched inside the last ``enqueue``
    span before it on its thread, joined by correlation id."""
    enqueues: dict = {}
    for r in spans(view, "enqueue"):
        enqueues.setdefault(r.tid, []).append(r)
    starts = {tid: [r.ts for r in rs] for tid, rs in enqueues.items()}
    ends = []
    for s in spans(view, "sync"):
        i = bisect.bisect_right(starts.get(s.tid, []), s.ts) - 1
        if i < 0:
            continue
        kernels = view.kernels_in(enqueues[s.tid][i])
        if kernels:
            ends.append(max(k.end for k in kernels))
    return ends


def sync_idle_share(view, ctx) -> float | None:
    """The device's idle time right after each kernel that a launch synced
    on, in percent of the window: each idle gap that begins at the end of
    the busy stretch holding such a kernel's end, counted once. While the
    launch waits for its kernel nothing more is queued, so the device
    idles from that end until the host enqueues again. Device times only:
    the profiler may shift the device's clock against the host's by up to
    milliseconds, so no host time is compared with a device time. 0.0 in a
    window with launches and no syncs; None in one without launches."""
    if not spans(view, "launch"):
        return None
    gaps = view.idle_gaps()
    starts = [a for a, _ in gaps]
    held = {bisect.bisect_left(starts, end)
            for end in synced_kernel_ends(view)}
    idle = sum(gaps[i][1] - gaps[i][0] for i in held if i < len(gaps))
    return share(idle / view.window.dur)


def kernel_share(view, name: str) -> float | None:
    """The device time of the kernels launched inside the window's ``name``
    spans (joined by correlation id on the span's thread), in percent of
    the window's busy time; None without such spans."""
    hits = range_kernels(view, PREFIX + name)
    busy = view.busy_s
    if not hits or busy <= 0:
        return None
    return share(sum(seconds(ks) for _, ks in hits) / busy)
