"""The trace reduction and the readers on a synthetic Chrome trace: device
time is joined to the benchmark's ranges by correlation id, never by the
kernel's name."""

import pytest

from klbench import harness
from klbench.counts import peaks, stencils
from klbench.trace import TraceView

ROOT = harness.KLBENCH.parent


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def stencil_trace(kernel_us=(400.0, 800.0), host_us=(500.0, 1000.0),
                  steps=3):
    """``steps`` MicroHH steps: each op range launches one kernel (named
    anything) that runs ``kernel_us`` inside ``host_us`` of host time."""
    events, t, corr = [], 0.0, 0
    for _ in range(steps):
        for name, k_us, h_us in zip(("klbench.advec_u", "klbench.diff_uvw"),
                                    kernel_us, host_us):
            corr += 1
            events += [ev("user_annotation", name, t, h_us),
                       ev("cuda_runtime", "cudaLaunchKernel", t + 10, 5,
                          corr=corr),
                       ev("kernel", f"renamed_{corr}", t + 20, k_us, tid=7,
                          corr=corr)]
            t += h_us
    events.append(ev("user_annotation", "klbench.window", 0.0, t))
    return TraceView.from_events(events), t


def test_busy_idle_and_breakdown():
    view, t = stencil_trace()
    assert view.window_s == pytest.approx(t / 1e6)
    assert view.busy_s == pytest.approx(3 * 1200 / 1e6)
    b = view.breakdown()
    assert len(b["device_ops"]) == 6
    assert sum(s for _, s in b["idle_gaps"]) == pytest.approx(
        (t - 3 * 1200) / 1e6)


def test_kernels_are_joined_by_correlation_on_the_ranges_thread():
    view, _ = stencil_trace()
    r = view.ranges["klbench.advec_u"][0]
    assert [k.name for k in view.kernels_in(r)] == ["renamed_1"]
    r.tid = 2
    assert view.kernels_in(r) == []


def test_stencil_readers():
    view, t = stencil_trace()
    ctx = {"grid": (512, 512, 512), "dtype": "float32", "steps": 3}
    readers = harness.metric_readers(harness.benchmark(ROOT),
                                     "microhh-f32.grid512")
    got = {name: read(view, ctx) for name, (read, _) in readers.items()}
    adv = peaks.bound_s(*stencils.advec_u(ctx["grid"], "float32"),
                        "float32")
    assert got["advec_u_roofline"] == pytest.approx(100 * adv / 400e-6)
    assert got["launch_overhead_us"] == pytest.approx((100 + 200) / 2)
    assert got["idle_share.step"] == pytest.approx(
        100 * (1 - 3 * 1200 / t))


def test_a_reader_with_nothing_to_read_returns_none():
    view = TraceView.from_events(
        [ev("user_annotation", "klbench.window", 0.0, 1000.0)])
    ctx = {"grid": (8, 8, 8), "dtype": "float32", "steps": 0,
           "config": {}, "calls": []}
    readers = harness.metric_readers(harness.benchmark(ROOT),
                                     "microhh-f32.grid256")
    assert all(read(view, ctx) is None for read, _ in readers.values())
