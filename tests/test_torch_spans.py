"""The port's spans (``repro_torch.obs.span``) at its layer boundaries:
off, they cost a flag check and record nothing; under ``torch.profiler``
they are ``repro_torch.*`` ranges in the exported trace, nested on the
calling thread; with the tracer on, complete events with their real start.
"""

from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.core import WisdomKernel, get_kernel
from repro_torch.kernels import flash_attention, ops
from repro_torch.models import build_model
from repro_torch.obs import Tracer, runtime
from repro_torch.optim import AdamW
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(1)
LAUNCH_ARGS = {"kernel", "tier", "scenario", "cached", "compile_us",
               "load_us", "launch_us"}


@pytest.fixture(autouse=True)
def _obs_off():
    runtime.disable()
    yield
    runtime.disable()


@pytest.fixture()
def wisdom_dir(tmp_path):
    return tmp_path / "wisdom"


def profiled(fn, tmp_path) -> list[dict]:
    """The ``repro_torch.*`` ranges of a CPU profile of ``fn()``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("name", "").startswith("repro_torch.")]


def inside(inner: dict, outer: dict) -> bool:
    return (inner["tid"] == outer["tid"] and inner["ts"] >= outer["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def names(events) -> list[str]:
    return [e["name"] for e in events]


def meta_flash_call(wisdom_dir):
    k = WisdomKernel(flash_attention.causal_builder, wisdom_dir=wisdom_dir,
                     device_kind="gpu-h100")
    q = torch.empty(4, 256, 128, device="meta")
    return k(q, q, q)


def test_off_a_launch_enters_no_range_and_records_nothing(wisdom_dir,
                                                          monkeypatch):
    """(a) With the tracer off and no profiler, every span is the one
    shared no-op: no span object is made, no ``record_function`` entered."""
    def refuse(*args, **kwargs):
        raise AssertionError("a span was made with both sinks off")

    monkeypatch.setattr(runtime, "_Span", refuse)
    monkeypatch.setattr(runtime._autograd_profiler, "record_function",
                        refuse)
    assert runtime.span("launch", "kernel") is runtime.NO_SPAN
    assert not runtime.NO_SPAN.recording
    a = torch.ones((64, 64))
    k = WisdomKernel(get_kernel("matmul"), wisdom_dir=wisdom_dir,
                     device_kind="gpu-h100")
    k(a, a)
    k(a, a)
    ops.advec_u(*(torch.randn(8, 8, 8) for _ in range(3)), 1.0, 1.0, 1.0)
    assert runtime.tracer() is None and len(k.stats) == 2


def test_profiled_launch_nests_its_spans_on_one_thread(wisdom_dir,
                                                       tmp_path):
    """(b) Under the profiler a launch is ``repro_torch.launch`` with
    ``select`` and ``enqueue`` inside it on its thread; the first launch
    of a scenario (a compile-cache miss) adds ``build``; a ``meta`` call
    adds nothing; no sync on CPU tensors."""
    a = torch.ones((64, 64))
    k = WisdomKernel(get_kernel("matmul"), wisdom_dir=wisdom_dir,
                     device_kind="gpu-h100")
    spans = profiled(lambda: (k(a, a), k(a, a)), tmp_path)
    launches = [e for e in spans if e["name"] == "repro_torch.launch"]
    assert len(launches) == 2
    for i, launch in enumerate(launches):
        kids = sorted((e for e in spans if e is not launch
                       and inside(e, launch)), key=lambda e: e["ts"])
        want = ["repro_torch.select", "repro_torch.build",
                "repro_torch.enqueue"] if i == 0 else [
                    "repro_torch.select", "repro_torch.enqueue"]
        assert names(kids) == want
    assert "repro_torch.sync" not in names(spans)
    assert profiled(lambda: meta_flash_call(wisdom_dir), tmp_path) == []


def test_the_scalar_block_has_its_span(tmp_path):
    spans = profiled(lambda: ops.pack_scalars(1.1, 0.9, 1.3), tmp_path)
    assert names(spans) == ["repro_torch.scalars"]


def test_the_tracer_records_the_real_launch_span(wisdom_dir):
    """(c) With the tracer on, ``launch`` is the real host interval: it
    starts at or before its ``select`` child and ends at or after its
    ``enqueue``, with the reference's args keys; its children are events
    of their own. A ``meta`` call records nothing."""
    clock = iter(range(0, 10_000)).__next__
    _, tr = runtime.enable(tracer=Tracer(clock=clock))
    a = torch.ones((64, 64))
    k = WisdomKernel(get_kernel("matmul"), wisdom_dir=wisdom_dir,
                     device_kind="gpu-h100")
    k(a, a)
    by = {e["name"]: e for e in tr.events}
    assert sorted(by) == ["build", "enqueue", "launch", "select"]
    launch = by["launch"]
    assert launch["cat"] == "kernel" and set(launch["args"]) == LAUNCH_ARGS
    assert launch["ts"] <= by["select"]["ts"]
    for child in ("select", "build", "enqueue"):
        assert inside(by[child], launch)
    assert by["select"]["args"] == {}
    n = len(tr.events)
    meta_flash_call(wisdom_dir)
    assert len(tr.events) == n


def test_a_failed_launch_records_no_launch_event(wisdom_dir, monkeypatch):
    """A launch whose build raises is no finished span: the tracer records
    neither ``launch`` nor ``build``, so no event without the launch's
    args reaches the health report."""
    builder = get_kernel("matmul")

    def refuse(config, meta):
        raise RuntimeError("nvcc refused the config")

    monkeypatch.setattr(builder, "make", refuse)
    _, tr = runtime.enable()
    a = torch.ones((64, 64))
    k = WisdomKernel(builder, wisdom_dir=wisdom_dir, device_kind="gpu-h100")
    with pytest.raises(RuntimeError, match="nvcc refused"):
        k(a, a)
    assert names(tr.events) == ["select"]


@pytest.mark.parametrize("device", ["meta", torch.device("meta")])
def test_no_span_fires_on_the_meta_device(device, tmp_path):
    """Work on ``meta`` tensors (shapes only, as the dry-run) makes no span
    under the profiler or the tracer, whichever way its device is given."""
    _, tr = runtime.enable()
    with profile(activities=[ProfilerActivity.CPU]):
        assert runtime.span("optimizer", "model", device) is runtime.NO_SPAN
        assert runtime.span("optimizer", "model", "cpu") is not \
            runtime.NO_SPAN
    assert tr.events == []


def test_a_profiled_train_step_shows_the_model_step_spans(tmp_path):
    """(d) A two-microbatch CPU step through the flash path: the
    accumulator's passes and the optimizer each under their span, and
    ``attn_backward`` inside the autograd backward, never inside
    ``accumulate``."""
    cfg = get_arch("codeqwen1.5-7b").reduced(
        n_layers=1, d_model=256, n_heads=2, n_kv_heads=2, d_head=128,
        d_ff=256, vocab=128)
    model = build_model(cfg, device="cpu")
    opt = AdamW(lr=1e-3)
    state = init_train_state(model, opt, 0)
    step = make_train_step(model, opt, microbatches=2)
    ids = torch.randint(cfg.vocab, (2, 129),
                        generator=torch.Generator().manual_seed(0))
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    spans = profiled(lambda: step(state, batch), tmp_path)
    got = names(spans)
    assert got.count("repro_torch.optimizer") == 1
    # the accumulator's zeros, each microbatch's add, the division
    assert got.count("repro_torch.accumulate") == 4
    backward = [e for e in spans if e["name"] == "repro_torch.attn_backward"]
    assert len(backward) == 2 * cfg.n_layers
    for e in backward:
        assert not any(inside(e, acc) for acc in spans
                       if acc["name"] == "repro_torch.accumulate")
    (opt_span,) = [e for e in spans if e["name"] == "repro_torch.optimizer"]
    assert not [e for e in spans if e is not opt_span
                and inside(e, opt_span)]


def test_a_profiled_backward_runs_attn_backward_inside_autograd(tmp_path):
    """The attention backward's span lies inside the autograd node that
    runs ``FlashAttentionFn.backward``, on that node's thread."""
    q, k, v = (torch.randn(1, 2, 128, 128, requires_grad=True)
               for _ in range(3))

    def run():
        ops.attention(q, k, v).sum().backward()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    (span,) = [e for e in events
               if e["name"] == "repro_torch.attn_backward"]
    nodes = [e for e in events if "FlashAttentionFnBackward" in e["name"]]
    assert nodes and any(inside(span, n) for n in nodes)
