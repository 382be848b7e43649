"""The readers of the program's own spans (``klbench/spans.py``) on
synthetic Chrome traces: the spans are ``repro_torch.*`` ranges beside the
benchmark's ``klbench.*`` ones, and kernels join them by correlation id on
the span's thread."""

import pytest

from klbench import harness
from klbench.trace import TraceView

ROOT = harness.KLBENCH.parent
BENCH = harness.benchmark(ROOT)
SPAN_METRICS = {
    "microhh-f32.grid512": ["launch_host_us"],
    "microhh-f32.grid256": ["launch_host_us.grid256"],
    "codeqwen1.5-7b.prefill-mix": ["sync_idle_share.prefill"],
    "codeqwen1.5-7b.train": ["sync_idle_share.train",
                             "optimizer_share.train",
                             "attn_backward_share.train",
                             "accumulate_share.train"],
}


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def readers(cell):
    return {n: r for n, (r, _) in harness.metric_readers(BENCH, cell).items()}


def stencil_call(events, t, corr, name, kernel_us, sync=True):
    """One MicroHH op call at ``t`` in its benchmark range: the scalar
    block's copy, then a launch span with select, enqueue (one kernel
    running ``kernel_us`` from ``t + 70``) and, with ``sync``, the sync
    that ends 5 us after the kernel; 20 us of bookkeeping end the launch,
    30 us more the call. Returns the call's end."""
    k1 = t + 70.0 + kernel_us
    wait_end = k1 + 5.0 if sync else t + 75.0
    launch_end = wait_end + 20.0
    end = launch_end + 30.0
    events += [
        ev("user_annotation", name, t, end - t),
        ev("user_annotation", "repro_torch.scalars", t + 5, 10),
        ev("cuda_runtime", "cudaMemcpyAsync", t + 8, 4, corr=corr),
        ev("gpu_memcpy", "Memcpy HtoD", t + 12, 2, tid=7, corr=corr),
        ev("user_annotation", "repro_torch.launch", t + 20,
           launch_end - (t + 20)),
        ev("user_annotation", "repro_torch.select", t + 25, 15),
        ev("user_annotation", "repro_torch.enqueue", t + 45, 20),
        ev("cuda_runtime", "cudaLaunchKernel", t + 60, 3, corr=corr + 1),
        ev("kernel", f"k_{corr}", t + 70.0, kernel_us, tid=7,
           corr=corr + 1),
    ]
    if sync:
        events.append(ev("user_annotation", "repro_torch.sync", t + 66,
                         wait_end - (t + 66)))
    return end


def stencil_trace(steps=3, sync=True, kernel_us=(400.0, 800.0),
                  device_shift=0.0):
    """``steps`` MicroHH steps, with the device's events moved by
    ``device_shift`` us against the host's, as a profiler's clocks may
    disagree."""
    events, t, corr = [], 0.0, 0
    for _ in range(steps):
        for name, k_us in zip(("klbench.advec_u", "klbench.diff_uvw"),
                              kernel_us):
            t = stencil_call(events, t, corr, name, k_us, sync)
            corr += 2
    for e in events:
        if e["tid"] == 7:
            e["ts"] += device_shift
    events.append(ev("user_annotation", "klbench.window", 0.0, t))
    return TraceView.from_events(events), t


def test_launch_host_us_is_the_launch_span_less_its_sync():
    view, _ = stencil_trace()
    # launch 20 -> 70 + k + 25 (k + 75 us) less the sync 66 -> 75 + k
    for cell, name in (("microhh-f32.grid512", "launch_host_us"),
                       ("microhh-f32.grid256", "launch_host_us.grid256")):
        got = readers(cell)[name](view, {})
        assert got == pytest.approx(75.0 - 9.0)
        # the benchmark's range is wider than the launch span
        assert got <= readers(cell)[name.replace(
            "launch_host_us", "launch_overhead_us")](view, {})


def test_launch_host_us_without_a_sync_is_the_whole_span():
    view, _ = stencil_trace(sync=False)
    assert readers("microhh-f32.grid512")["launch_host_us"](
        view, {}) == pytest.approx(75.0)


@pytest.mark.parametrize("shift", [0.0, 40.0, -40.0])
def test_sync_idle_share_counts_the_gap_after_each_synced_kernel(shift):
    """Each call: the memcpy at 12 -> 14, the kernel at 70 -> 70 + k;
    the idle gap after the kernel, which holds the sync's end, runs to the
    next call's memcpy at its + 12. Moving the device's clock against the
    host's moves no gap but the last, which ends with the window."""
    view, t = stencil_trace(steps=2, device_shift=shift)
    ks = [400.0, 800.0, 400.0, 800.0]
    starts, s = [], 0.0
    for k in ks:
        starts.append(s)
        s += 70.0 + k + 5.0 + 20.0 + 30.0
    held = sum((starts[i + 1] + 12.0 if i + 1 < len(ks) else t - shift)
               - (starts[i] + 70.0 + ks[i]) for i in range(len(ks)))
    for cell, name in (("codeqwen1.5-7b.prefill-mix",
                        "sync_idle_share.prefill"),
                       ("codeqwen1.5-7b.train", "sync_idle_share.train")):
        assert readers(cell)[name](view, {}) == pytest.approx(
            100.0 * held / t)


def test_sync_idle_share_is_zero_without_syncs_and_none_without_launches():
    view, _ = stencil_trace(sync=False)
    read = readers("codeqwen1.5-7b.train")["sync_idle_share.train"]
    assert read(view, {}) == 0.0
    bare = TraceView.from_events(
        [ev("user_annotation", "klbench.window", 0.0, 1000.0),
         ev("kernel", "k", 10.0, 100.0, tid=7, corr=1)])
    assert read(bare, {}) is None


def train_trace():
    """One training step: a K4 launch (synced), the attention backward on
    the autograd thread (tid 2) with two kernels, a main-thread kernel
    launched while it runs, the accumulator's add, and the optimizer's
    two kernels."""
    events = [ev("user_annotation", "klbench.train_step", 0.0, 2000.0)]
    events += [
        ev("user_annotation", "repro_torch.launch", 10, 200),
        ev("user_annotation", "repro_torch.enqueue", 20, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 25, 3, corr=1),
        ev("kernel", "fa", 30, 100, tid=7, corr=1),
        ev("user_annotation", "repro_torch.sync", 45, 90),
        ev("user_annotation", "repro_torch.attn_backward", 300, 400, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 310, 3, tid=2, corr=2),
        ev("kernel", "sgemm", 320, 150, tid=7, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 500, 3, tid=2, corr=3),
        ev("kernel", "sgemm", 505, 100, tid=7, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 400, 3, tid=1, corr=4),
        ev("kernel", "other", 620, 50, tid=7, corr=4),
        ev("user_annotation", "repro_torch.accumulate", 700, 60),
        ev("cuda_runtime", "cudaLaunchKernel", 710, 3, corr=7),
        ev("kernel", "add", 715, 80, tid=7, corr=7),
        ev("user_annotation", "repro_torch.optimizer", 1000, 900),
        ev("cuda_runtime", "cudaLaunchKernel", 1010, 3, corr=5),
        ev("kernel", "adam", 1020, 300, tid=7, corr=5),
        ev("cuda_runtime", "cudaLaunchKernel", 1015, 3, corr=6),
        ev("kernel", "adam", 1320, 300, tid=7, corr=6),
        ev("user_annotation", "klbench.window", 0.0, 2000.0),
    ]
    return TraceView.from_events(events)


def test_shares_of_the_optimizer_and_the_attention_backward():
    view = train_trace()
    busy = 100 + 150 + 100 + 50 + 80 + 300 + 300
    rs = readers("codeqwen1.5-7b.train")
    got = {n: rs[n](view, {}) for n in SPAN_METRICS["codeqwen1.5-7b.train"]}
    assert view.busy_s == pytest.approx(busy / 1e6)
    assert got["optimizer_share.train"] == pytest.approx(100 * 600 / busy)
    assert got["accumulate_share.train"] == pytest.approx(100 * 80 / busy)
    # the main thread's kernel launched during the backward is not its own
    assert got["attn_backward_share.train"] == pytest.approx(
        100 * 250 / busy)
    # the gap after the K4 kernel holds the sync's end: 130 -> 320
    assert got["sync_idle_share.train"] == pytest.approx(
        100 * (320 - 130) / 2000)


def test_every_span_metric_is_read_in_its_cells_and_nothing_without_spans():
    """Each of the seven is a reader of its cells; on a trace without the
    program's spans (an older program) each finds nothing."""
    listed = {m["name"]: m["workloads"] for m in BENCH["per_layer"]}
    bare = TraceView.from_events(
        [ev("user_annotation", "klbench.prefill", 0.0, 500.0),
         ev("cuda_runtime", "cudaLaunchKernel", 10, 3, corr=1),
         ev("kernel", "k", 20, 100, tid=7, corr=1),
         ev("user_annotation", "klbench.window", 0.0, 1000.0)])
    for cell, names in SPAN_METRICS.items():
        rs = readers(cell)
        for name in names:
            assert listed[name] == [cell]
            assert rs[name](bare, {}) is None, name
