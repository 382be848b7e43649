"""The port's kernel profiler (``repro_torch.prof``) and the Hopper
workload models of K1–K4, against the JAX package's ``repro.prof``.

``profile_from_workload`` is the reference's function: the same workload
numbers and peaks give byte-identical profile JSON in both packages. The
workload hooks are the port's own (compulsory traffic, a block's shared
memory); their floors on ``gpu-h100`` are the bounds PERF.md §6 lists for
each kernel row, and their ``vmem_bytes`` is what the launchers ask the
card for. Counterparts of ``tests/test_prof.py``, but for the tests that
need recorded tuning spaces or the fitted cost model, which are not
ported (the entry points raise instead).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro.prof as rp
from repro.core import get_kernel as repro_kernel
from repro.core.device import DeviceSpec as RefDeviceSpec
from repro.core.workload import Workload as RefWorkload

from repro_torch.core import (GPU_H100, KernelBuilder, Wisdom, WisdomKernel,
                              WisdomRecord, get_kernel, make_provenance)
from repro_torch.core.device import get_device
from repro_torch.kernels import advec_u, diff_uvw, flash_attention, matmul
from repro_torch.obs import MetricsRegistry, Tracer, render_report, runtime
from repro_torch.obs import validate_trace
from repro_torch.prof import (DEFAULT_SAMPLE_EVERY, PROFILE_FEATURES,
                              PROFILE_VERSION, KernelProfile, Profiler,
                              ProfileVersionError, StepProfiler,
                              classify_bottleneck, classify_dataset,
                              load_profiles, process_profiler,
                              prof_requested, profile_feature_vector,
                              profile_fields, profile_from_workload,
                              render_attribution, render_profiles,
                              reset_process_profiler, save_profiles,
                              summarize)

torch.set_num_threads(1)
H100 = get_device("gpu-h100")


@pytest.fixture(autouse=True)
def _clean():
    """Profiler tests start and end with obs off and no ambient profiler."""
    runtime.disable()
    reset_process_profiler()
    os.environ.pop("KERNEL_LAUNCHER_PROF", None)
    yield
    runtime.disable()
    reset_process_profiler()
    os.environ.pop("KERNEL_LAUNCHER_PROF", None)


def _matmul_profile(latency_us=100.0, baseline_us=None,
                    problem=(64, 64, 64), config=None, dtype="float32"):
    builder = get_kernel("matmul")
    config = config or builder.default_config()
    w = builder.make_workload(config, problem, dtype)
    return profile_from_workload(
        w, H100, dtype, latency_us, kernel="matmul",
        problem_size=problem, config=config, tier="exact",
        baseline_us=baseline_us)


# ------------------------- classification physics ----------------------------

def test_classify_bottleneck_ordering_and_ties():
    assert classify_bottleneck(2.0, 1.0) == "compute"
    assert classify_bottleneck(1.0, 2.0) == "memory"
    assert classify_bottleneck(0.0, 1.0, 3.0) == "collective"
    # ties resolve in declaration order: compute, then memory
    assert classify_bottleneck(1.0, 1.0) == "compute"
    assert classify_bottleneck(0.0, 1.0, 1.0) == "memory"


def test_small_matmul_is_memory_bound_large_is_compute_bound():
    """On the H100's ridge (20 FLOP/byte f32, 295 bf16): 64^3 f32 and the
    quickstart's (512, 512, 1024) in bf16 sit below it, 8192^3 above."""
    small = _matmul_profile()
    assert small.bottleneck == "memory"
    assert small.arithmetic_intensity < H100.flops_f32 / H100.hbm_bw
    qs = _matmul_profile(problem=(512, 512, 1024), dtype="bfloat16")
    assert qs.bottleneck == "memory"
    for dtype in ("float32", "bfloat16"):
        big = _matmul_profile(problem=(8192, 8192, 8192), dtype=dtype)
        assert big.bottleneck == "compute"
        peak = H100.flops_bf16 if dtype == "bfloat16" else H100.flops_f32
        assert big.arithmetic_intensity > peak / H100.hbm_bw


@pytest.mark.parametrize("name", ["advec_u", "diff_uvw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stencils_are_memory_bound(name, dtype):
    builder = get_kernel(name)
    w = builder.make_workload(builder.default_config(), (512, 512, 512),
                              dtype)
    p = profile_from_workload(w, H100, dtype, 1000.0, kernel=name)
    assert p.bottleneck == "memory"
    assert p.arithmetic_intensity < 16.0


def test_bf16_uses_bf16_peak():
    """The peak follows the launch's dtype (the reference's rule, kept
    verbatim): bf16 is held to the tensor-core peak."""
    builder = get_kernel("matmul")
    cfg = builder.default_config()
    w = builder.make_workload(cfg, (256, 256, 256), "bfloat16")
    p = profile_from_workload(w, H100, "bfloat16", 100.0)
    w32 = builder.make_workload(cfg, (256, 256, 256), "float32")
    p32 = profile_from_workload(w32, H100, "float32", 100.0)
    assert p.compute_us == pytest.approx(
        p32.compute_us * H100.flops_f32 / H100.flops_bf16, rel=1e-4)


# ---------------------------- parity with repro -------------------------------

def _ref_spec(spec) -> RefDeviceSpec:
    """The reference's DeviceSpec holding ``spec``'s peaks."""
    names = [f.name for f in dataclasses.fields(RefDeviceSpec)]
    return RefDeviceSpec(**{n: getattr(spec, n) for n in names})


PARITY_CASES = [
    ("advec_u", (512, 512, 512), "float32", {}),
    ("advec_u", (256, 256, 256), "bfloat16", {"body": "ldg",
                                             "block_size_x": 32,
                                             "strip_z": 64}),
    ("diff_uvw", (512, 512, 512), "float32", {}),
    ("diff_uvw", (512, 512, 512), "bfloat16", {"fuse_outputs": False,
                                              "body": "tile"}),
    ("matmul", (512, 512, 1024), "float32", {"split_k": 2}),
    ("matmul", (8192, 8192, 8192), "bfloat16", {}),
    ("flash_attention_causal", (128, 128, 2048, 128), "bfloat16", {}),
    ("flash_attention_full", (32, 8, 200, 256), "float32", {}),
]


@pytest.mark.parametrize("name,problem,dtype,upd", PARITY_CASES)
def test_profile_json_matches_the_reference(name, problem, dtype, upd):
    """Same Workload numbers, same peaks, same latency and baseline: the
    same profile JSON, byte for byte, in both packages."""
    builder = get_kernel(name)
    cfg = builder.default_config() | upd
    assert builder.space.is_valid(cfg)
    w = builder.make_workload(cfg, problem, dtype)
    assert w.valid
    ref_w = RefWorkload(flops=w.flops, hbm_bytes=w.hbm_bytes,
                        vmem_bytes=w.vmem_bytes, grid=w.grid)
    kw = dict(kernel=name, problem_size=problem, config=cfg, tier="exact",
              baseline_us=250.0)
    got = profile_from_workload(w, H100, dtype, 333.3, **kw)
    want = rp.profile_from_workload(ref_w, _ref_spec(GPU_H100), dtype,
                                    333.3, **kw)
    assert json.dumps(got.to_json(), sort_keys=True) == json.dumps(
        want.to_json(), sort_keys=True)
    assert profile_fields(got) == rp.profile_fields(want)


# --------------------------- workload models ----------------------------------

#: PERF.md §6's bound for each kernel row, ms (NVIDIA H100 SXM peaks).
FLOOR_ROWS = [
    ("advec_u", (512, 512, 512), "float32", {}, 0.641),
    ("advec_u", (512, 512, 512), "bfloat16", {}, 0.3205),
    ("diff_uvw", (512, 512, 512), "float32", {}, 1.122),
    ("diff_uvw", (512, 512, 512), "float32", {"fuse_outputs": False},
     1.442),
    ("matmul", (8192, 8192, 8192), "float32", {}, 16.41),
    ("matmul", (8192, 8192, 8192), "bfloat16", {}, 1.112),
    ("matmul", (512, 512, 1024), "float32", {}, 0.00801),
    ("flash_attention_causal", (128, 128, 2048, 128), "bfloat16", {},
     0.139),
]


@pytest.mark.parametrize("name,problem,dtype,upd,bound_ms", FLOOR_ROWS)
def test_workload_floor_is_the_kernel_rows_bound(name, problem, dtype, upd,
                                                 bound_ms):
    builder = get_kernel(name)
    w = builder.make_workload(builder.default_config() | upd, problem, dtype)
    p = profile_from_workload(w, H100, dtype, 1.0)
    assert max(p.compute_us, p.memory_us) / 1e3 == pytest.approx(
        bound_ms, rel=5e-3)


def test_workload_counts_compulsory_traffic():
    """Each input read once, each output written once, scal's 16 bytes; an
    unfused diff_uvw call is three launches of three fields each."""
    pts = 64 * 32 * 16
    for name, upd, fields, launches in (
            ("advec_u", {}, 4, 1), ("diff_uvw", {}, 7, 1),
            ("diff_uvw", {"fuse_outputs": False}, 9, 3)):
        b = get_kernel(name)
        cfg = b.default_config() | upd
        mod = advec_u if name == "advec_u" else diff_uvw
        for dtype, elem in (("float32", 4), ("bfloat16", 2)):
            w = b.make_workload(cfg, (64, 32, 16), dtype)
            assert w.hbm_bytes == fields * pts * elem + 16
            grid = mod.plan(cfg, (64, 32, 16), dtype).grid
            assert w.grid == launches * grid[0] * grid[1] * grid[2]
    w = get_kernel("matmul").make_workload(
        get_kernel("matmul").default_config(), (100, 77, 50), "bfloat16")
    assert w.hbm_bytes == (100 * 50 + 50 * 77 + 100 * 77) * 2
    assert w.flops == 2.0 * 100 * 77 * 50
    w = get_kernel("flash_attention_full").make_workload(
        get_kernel("flash_attention_full").default_config(),
        (8, 2, 200, 128), "float32")
    assert w.hbm_bytes == (2 * 8 + 2 * 2) * 200 * 128 * 4
    assert w.flops == 4.0 * 8 * 128 * 200 * 200
    assert w.grid == -(-200 // 64) * 8


#: (builder, problem, config update): the flops of each port hook against
#: the reference builder's hook on the same problem, each in its default
#: config updated so. The reference counts causal attention over whole
#: diagonal tiles, 4 BH S^2 D (1/2 + 1/(2 S/block_k)); at one key a tile
#: that is the S(S+1)/2 pairs the port counts, the pairs the output needs.
FLOPS_PARITY = [
    ("advec_u", (64, 32, 128), {}, {}),
    ("diff_uvw", (64, 32, 128), {}, {}),
    ("diff_uvw", (64, 32, 128), {"fuse_outputs": False},
     {"fuse_outputs": False}),
    ("matmul", (256, 128, 512), {}, {}),
    ("matmul", (100, 77, 50), {}, {}),
    ("flash_attention_full", (8, 2, 256, 128), {}, {}),
    ("flash_attention_causal", (8, 2, 256, 128), {},
     {"block_q": 1, "block_k": 1}),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,problem,upd,ref_upd", FLOPS_PARITY)
def test_workload_flops_are_the_references(name, problem, upd, ref_upd,
                                           dtype):
    """hbm_bytes is left out: the port counts compulsory traffic, the
    reference a TPU's re-fetches (the hooks' docstrings say why)."""
    b, rb = get_kernel(name), repro_kernel(name)
    w = b.make_workload(b.default_config() | upd, problem, dtype)
    rw = rb.make_workload(rb.default_config() | ref_upd, problem, dtype)
    assert w.valid and rw.valid
    assert w.flops == rw.flops


SMEM_CASES = [
    ("advec_u", {}, "float32"),                                  # tile
    ("advec_u", {"body": "tile", "block_size_x": 256, "block_size_y": 4,
                 "strip_z": 128, "min_blocks_per_sm": 1}, "bfloat16"),
    ("advec_u", {"body": "ldg", "strip_z": 64}, "float32"),      # ldg
    ("diff_uvw", {"fuse_outputs": False, "body": "tile"}, "float32"),
    ("diff_uvw", {}, "bfloat16"),                                # fused
    ("diff_uvw", {"body": "tile", "block_size_x": 64}, "float32"),  # fused
    ("matmul", {}, "float32"),                                   # simt
    ("matmul", {"stages": 4, "block_m": 64}, "bfloat16"),        # wgmma
    ("flash_attention_causal", {}, "bfloat16"),                  # wgmma
    ("flash_attention_causal", {"block_q": 128, "block_k": 64}, "float32"),
]


@pytest.mark.parametrize("name,upd,dtype", SMEM_CASES)
def test_vmem_bytes_is_the_launchers_shared_memory(name, upd, dtype):
    b = get_kernel(name)
    cfg = b.default_config() | upd
    assert b.space.is_valid(cfg)
    if name == "matmul":
        problem = (512, 512, 1024)
        want = matmul.plan(cfg, *problem, dtype).smem_bytes
        body = matmul.plan(cfg, *problem, dtype).body
        assert want == matmul.smem_bytes(cfg, body)
    elif name.startswith("flash"):
        problem = (32, 32, 512, 128)
        body = flash_attention.choose_body(dtype, 128, cfg)
        want = flash_attention.smem_bytes(cfg, body, 128, dtype)
    else:
        problem = (64, 64, 64)
        mod = advec_u if name == "advec_u" else diff_uvw
        want = mod.plan(cfg, problem, dtype).smem_bytes
        if cfg["body"] == "ldg":
            assert want == 0
    assert b.make_workload(cfg, problem, dtype).vmem_bytes == want


INVALID_CASES = [
    ("advec_u", {}, (2, 64, 64), "float32"),          # axis under 3 cells
    ("diff_uvw", {"body": "tile", "block_size_x": 256, "block_size_y": 16},
     (64, 64, 64), "float32"),        # fused tile: 304,128 B a block
    ("advec_u", {}, (64, 64, 64), "float16"),         # no such kernel
    ("matmul", {}, (64, 0, 64), "float32"),           # empty problem
    ("matmul", {"grid_order": "nmk", "block_m": 64}, (64 * 70_000, 64, 64),
     "float32"),                                      # grid y past 65535
    ("flash_attention_causal", {}, (8, 8, 256, 64), "bfloat16"),  # D = 64
    ("flash_attention_causal", {}, (6, 4, 256, 128), "bfloat16"),  # GQA 6/4
]


@pytest.mark.parametrize("name,upd,problem,dtype", INVALID_CASES)
def test_workload_invalid_where_the_launcher_refuses(name, upd, problem,
                                                     dtype):
    b = get_kernel(name)
    assert not b.make_workload(b.default_config() | upd, problem,
                               dtype).valid


# ------------------------------ round-trips ----------------------------------

def test_profile_json_roundtrip_and_version_refusal():
    p = _matmul_profile(baseline_us=80.0)
    d = p.to_json()
    assert d["version"] == PROFILE_VERSION
    back = KernelProfile.from_json(d)
    assert back.to_json() == d
    assert back.drift == pytest.approx(100.0 / 80.0, rel=1e-4)
    assert rp.KernelProfile.from_json(d).to_json() == d

    future = dict(d, version=PROFILE_VERSION + 1)
    with pytest.raises(ProfileVersionError):
        KernelProfile.from_json(future)


def test_baseline_omitted_when_absent():
    d = _matmul_profile().to_json()
    assert "baseline_us" not in d and "drift" not in d


def test_save_load_profiles_roundtrip(tmp_path):
    ps = [_matmul_profile(50.0), _matmul_profile(60.0, baseline_us=50.0)]
    path = save_profiles(tmp_path / "x.prof.json", ps)
    back = load_profiles(path)
    assert [p.to_json() for p in back] == [p.to_json() for p in ps]
    # byte-determinism of the document itself, and the reference's reader
    again = save_profiles(tmp_path / "y.prof.json", ps)
    assert path.read_bytes() == again.read_bytes()
    assert [p.to_json() for p in rp.load_profiles(path)] == [
        p.to_json() for p in ps]

    bad = {"version": 1, "profiles": [
        dict(ps[0].to_json(), version=PROFILE_VERSION + 7)]}
    (tmp_path / "bad.prof.json").write_text(json.dumps(bad))
    with pytest.raises(ProfileVersionError):
        load_profiles(tmp_path / "bad.prof.json")


# ------------------------------ drift ----------------------------------------

def test_drift_detection_threshold():
    slow = _matmul_profile(100.0, baseline_us=50.0)
    assert slow.drift == pytest.approx(2.0)
    assert slow.has_drift()
    ok = _matmul_profile(60.0, baseline_us=50.0)
    assert not ok.has_drift()          # 1.2x < default 1.5x
    assert ok.has_drift(threshold=1.1)
    assert not _matmul_profile(100.0).has_drift()   # no baseline, no drift


# ------------------------------ sampling -------------------------------------

def test_profiler_sampling_period():
    pr = Profiler(sample_every=4)
    hits = [pr.due("matmul") for _ in range(9)]
    assert hits == [True, False, False, False, True,
                    False, False, False, True]
    # independent streams sample independently
    assert pr.due("advec_u")


def test_profiler_bounds_retained_profiles():
    pr = Profiler(sample_every=1, max_profiles=4)
    for i in range(10):
        pr.record(_matmul_profile(float(i + 1)))
    assert len(pr.profiles) == 4
    assert pr.dropped > 0
    assert pr.profiles[-1].latency_us == 10.0


def test_profile_launch_guards_never_raise():
    pr = Profiler(sample_every=1)
    bare = KernelBuilder("bare")           # no workload hook
    assert pr.profile_launch(bare, {}, (8,), "float32", "gpu-h100",
                             1.0) is None
    builder = get_kernel("flash_attention_causal")
    # D = 64: the launcher refuses it, so the workload is invalid
    assert pr.profile_launch(builder, builder.default_config(),
                             (8, 8, 256, 64), "bfloat16", "gpu-h100",
                             1.0) is None
    assert pr.profiles == []


def test_prof_requested_env_parsing(monkeypatch):
    monkeypatch.delenv("KERNEL_LAUNCHER_PROF", raising=False)
    assert prof_requested() == 0
    for raw, want in [("0", 0), ("off", 0), ("false", 0),
                      ("1", DEFAULT_SAMPLE_EVERY),
                      ("true", DEFAULT_SAMPLE_EVERY),
                      ("4", 4), ("-3", 1),
                      ("garbage", DEFAULT_SAMPLE_EVERY)]:
        monkeypatch.setenv("KERNEL_LAUNCHER_PROF", raw)
        assert prof_requested() == want == rp.prof_requested(), raw


def test_process_profiler_lifecycle(monkeypatch):
    monkeypatch.delenv("KERNEL_LAUNCHER_PROF", raising=False)
    reset_process_profiler()
    assert process_profiler() is None
    monkeypatch.setenv("KERNEL_LAUNCHER_PROF", "8")
    reset_process_profiler()
    pr = process_profiler()
    assert pr is not None and pr.sample_every == 8
    assert process_profiler() is pr        # one shared instance


# ------------------------- telemetry fan-out ---------------------------------

def test_record_emits_metrics_and_counter_events():
    reg, tr = runtime.enable()
    pr = Profiler(sample_every=1)
    pr.record(_matmul_profile(100.0))
    pr.record(_matmul_profile(200.0, baseline_us=50.0))   # 4x drift
    assert pr.drift_events == 1
    snap = reg.snapshot()
    assert snap["counters"][
        "prof.launches{bottleneck=memory,kernel=matmul}"] == 2
    assert snap["counters"]["prof.drift{kernel=matmul}"] == 1
    doc = tr.to_chrome()
    assert validate_trace(doc) == []
    counters = [e for e in doc["traceEvents"] if e["ph"] == "C"]
    assert len(counters) == 2
    assert counters[0]["name"] == "prof.matmul"
    assert set(counters[0]["args"]) >= {"roofline_fraction",
                                        "arithmetic_intensity"}
    assert any(e["ph"] == "i" and e["name"] == "prof.drift"
               for e in doc["traceEvents"])


def test_validate_trace_counter_events():
    base = {"name": "c", "cat": "p", "ph": "C", "ts": 1.0,
            "pid": 1, "tid": 1}
    good = {**base, "args": {"frac": 0.5}}
    assert validate_trace({"traceEvents": [good]}) == []
    for bad_args in ({}, {"frac": "high"}, {"frac": True}):
        errors = validate_trace(
            {"traceEvents": [{**base, "args": bad_args}]})
        assert errors, bad_args
    tr = Tracer()
    with pytest.raises(ValueError):
        tr.counter("prof.matmul", frac="high")
    with pytest.raises(ValueError):
        tr.counter("prof.matmul")


# --------------------------- launch-path wiring ------------------------------

def test_wisdom_kernel_samples_launches_with_exact_baseline(tmp_path):
    builder = get_kernel("matmul")
    w = Wisdom("matmul")
    w.add(WisdomRecord(
        device_kind="gpu-h100", device_family="gpu-hopper",
        problem_size=(64, 64, 64), dtype="float32",
        config=builder.default_config(), score_us=12.0,
        provenance=make_provenance()))
    w.save(tmp_path)

    k = WisdomKernel(builder, wisdom_dir=tmp_path, device_kind="gpu-h100")
    assert k.profiler is None              # detached by default
    pr = Profiler(sample_every=2)
    k.attach_profiler(pr)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    for _ in range(4):
        k(a, b)
    assert len(pr.profiles) == 2           # launches 0 and 2 sampled
    for p, st in zip(pr.profiles, k.stats[::2]):
        assert p.kernel == "matmul" and p.tier == "exact"
        assert p.baseline_us == 12.0       # the wisdom-recorded score
        assert p.problem_size == (64, 64, 64)
        # the latency is the launch's own timing, no second clock
        assert p.latency_us == pytest.approx(st.launch_s * 1e6, abs=1e-6)


def test_wisdom_kernel_ambient_profiler_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("KERNEL_LAUNCHER_PROF", "2")
    reset_process_profiler()
    k = WisdomKernel(get_kernel("matmul"), wisdom_dir=tmp_path,
                     device_kind="gpu-h100")
    assert k.profiler is process_profiler()
    a = torch.ones((64, 64))
    k(a, a)
    assert len(k.profiler.profiles) == 1
    assert k.profiler.profiles[0].baseline_us is None   # default tier


class _Toy:
    vocab = 13
    device = torch.device("cpu")

    def init_cache(self, n, m):
        return {"pos": torch.zeros((), dtype=torch.int64)}

    def decode_step(self, params, cache, tok):
        nxt = (tok[:, 0].long() + 1) % self.vocab
        logits = torch.nn.functional.one_hot(nxt, self.vocab).float()
        return logits[:, None], {"pos": cache["pos"] + 1}


def test_serve_engine_profiles_decode_steps():
    from repro_torch.serve import Request, ServeEngine

    params = {"w": torch.ones((64, 64)), "layers": [{"b": torch.ones(8)}]}
    pr = Profiler(sample_every=2)
    eng = ServeEngine(_Toy(), params=params, n_slots=2, max_seq=16,
                      profiler=StepProfiler(pr, device="gpu-h100"))
    for rid in range(2):
        eng.submit(Request(rid, np.array([1, 2], np.int32),
                           max_new_tokens=3))
    rep = eng.run()
    assert rep.steps > 0 and pr.profiles
    assert len(pr.profiles) == -(-rep.steps // 2)
    first = pr.profiles[0]
    assert first.kernel == "serve.decode" and first.tier == "serve"
    assert first.bottleneck == "memory"    # params stream from HBM
    assert first.hbm_bytes == (64 * 64 + 8) * 4
    assert first.device_kind == "gpu-h100"
    assert first.baseline_us is None       # first sample IS the baseline
    assert all(p.baseline_us == first.latency_us
               for p in pr.profiles[1:])
    # engines without a profiler (and no env) stay detached
    assert ServeEngine(_Toy(), params={}).profiler is None


def test_serve_engine_ambient_step_profiler(monkeypatch):
    from repro_torch.serve import Request, ServeEngine

    monkeypatch.setenv("KERNEL_LAUNCHER_PROF", "1")
    reset_process_profiler()
    eng = ServeEngine(_Toy(), params={"w": torch.ones(4)}, n_slots=2,
                      max_seq=16)
    assert isinstance(eng.profiler, StepProfiler)
    assert eng.profiler.profiler is process_profiler()
    eng.submit(Request(0, np.array([1, 2], np.int32), max_new_tokens=2))
    eng.run()
    (p,) = process_profiler().profiles     # step 0 of period 16
    assert p.device_kind == "cpu" and p.kernel == "serve.decode"


def test_evaluator_profiles_every_config():
    """The tuner's evaluator joins each score with the workload: the
    profile fields of that (workload, score) on the evaluator's device."""
    from repro_torch.tuner.runner import WallClockEvaluator
    builder = get_kernel("matmul")
    problem = (64, 48, 32)
    ev = WallClockEvaluator(builder, builder.make_probe_args(problem,
                                                             "float32"),
                            device="cpu", repeats=1)
    cfg = builder.default_config() | {"split_k": 2}
    res = ev(cfg)
    want = profile_from_workload(
        builder.make_workload(cfg, problem, "float32"), get_device("cpu"),
        "float32", res.score_us, kernel="matmul", problem_size=problem,
        config=cfg)
    assert res.info["profile"] == profile_fields(want)
    assert res.info["profile"]["flops"] == 2.0 * 64 * 48 * 32
    assert ev(dict(cfg, block_m=7)).info == {}   # restricted: no profile


def test_profile_feature_vector_tolerates_garbage():
    assert profile_feature_vector({}) == [0.0] * len(PROFILE_FEATURES)
    v = profile_feature_vector({"compute_us": "NaNsense", "grid": 0,
                                "arithmetic_intensity": 42.0})
    assert len(v) == len(PROFILE_FEATURES)
    assert v[0] == 0.0 and v[3] == pytest.approx(np.log1p(42.0))


# ------------------------------ reporting ------------------------------------

def test_summarize_and_render_profiles():
    ps = [_matmul_profile(100.0), _matmul_profile(300.0, baseline_us=100.0)]
    s = summarize(ps)
    assert s["matmul"]["launches"] == 2
    assert s["matmul"]["dominant"] == "memory"
    assert s["matmul"]["drifted"] == 1
    text = render_profiles(ps)
    assert "matmul: launches=2" in text and "drifted=1" in text
    assert render_profiles([]) == render_profiles([])
    assert text == rp.render_profiles(ps)


def test_health_report_renders_prof_and_sandbox_sections():
    reg = MetricsRegistry()
    snap0 = reg.snapshot()
    assert "Profiler" not in render_report(snap0)   # sections are opt-in
    reg.counter("sandbox.verdict", status="ok").inc(3)
    reg.counter("oracle.checks", kernel="matmul", status="ok").inc(2)
    reg.counter("prof.launches", kernel="matmul",
                bottleneck="memory").inc(5)
    reg.counter("prof.drift", kernel="matmul").inc()
    text = render_report(reg.snapshot())
    assert "Sandbox & oracle" in text
    assert "sandbox verdicts: n=3 [ok=3]" in text
    assert "oracle matmul: [ok=2]" in text
    assert "Profiler (roofline bottlenecks)" in text
    assert "matmul: profiled=5 memory-bound [memory=5]" in text
    assert "drift-events=1" in text
    assert render_report(reg.snapshot()) == text


def test_dataset_entry_points_raise_until_tunebench_is_ported(tmp_path):
    from repro_torch.prof.cli import main
    from repro_torch.prof.demo import run_demo
    with pytest.raises(NotImplementedError, match="item 13"):
        classify_dataset(None)
    with pytest.raises(NotImplementedError, match="item 13"):
        render_attribution([])
    with pytest.raises(NotImplementedError, match="item 13"):
        main(["report", "--datasets", "*.space.json"])
    with pytest.raises(NotImplementedError, match="item 13"):
        run_demo(tmp_path, device="cpu", dataset_glob="*.space.json")


# ------------------------------ demo + CLI -----------------------------------

def test_demo_produces_valid_artifacts(tmp_path):
    from repro_torch.prof.demo import run_demo
    art = run_demo(tmp_path / "d", device="cpu")
    assert art["n_profiles"] > 0 and art["drift_events"] >= 1
    profiles = load_profiles(art["profiles"])
    assert {p.kernel for p in profiles} >= {"matmul", "advec_u"}
    trace = json.loads((tmp_path / "d" / "trace.json").read_text())
    assert validate_trace(trace) == []
    assert any(e["ph"] == "C" for e in trace["traceEvents"])
    report = (tmp_path / "d" / "report.txt").read_text()
    assert "Launch profiles" in report and "memory" in report


def test_cli_report_is_byte_deterministic(tmp_path):
    from repro_torch.prof.cli import main
    ps = save_profiles(tmp_path / "s.prof.json",
                       [_matmul_profile(100.0),
                        _matmul_profile(400.0, baseline_us=100.0)])
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    assert main(["report", "--profiles", str(ps), "--out", str(a)]) == 0
    assert main(["report", "--profiles", str(ps), "--out", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()
    assert "drifted=1" in a.read_text()


def test_cli_profile_and_diff(tmp_path):
    from repro_torch.prof.cli import main
    out = tmp_path / "p.prof.json"
    assert main(["profile", "--kernel", "advec_u",
                 "--problem", "512,512,512", "--latency-us", "942",
                 "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["bottleneck"] == "memory" and doc["device_kind"] == "gpu-h100"
    assert doc["roofline_fraction"] == pytest.approx(641.04 / 942, rel=1e-4)
    out2 = tmp_path / "q.prof.json"
    main(["profile", "--kernel", "advec_u", "--problem", "512,512,512",
          "--latency-us", "942", "--out", str(out2)])
    assert out.read_text() == out2.read_text()
    if not torch.cuda.is_available():   # without a latency it needs a card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["profile", "--kernel", "advec_u",
                  "--problem", "16,16,16"])

    ps = tmp_path / "s.prof.json"
    save_profiles(ps, [_matmul_profile(100.0)])
    assert main(["diff", str(ps), str(ps), "--check"]) == 0
    slow = tmp_path / "slow.prof.json"
    save_profiles(slow, [_matmul_profile(200.0)])
    assert main(["diff", str(ps), str(slow), "--check"]) == 1


def test_cli_roofline_places_a_kernel(capsys):
    from repro_torch.prof.cli import main
    assert main(["roofline", "--kernel", "matmul",
                 "--problem", "8192,8192,8192"]) == 0
    out = capsys.readouterr().out
    assert "roofline: gpu-h100 (family gpu-hopper" in out
    assert "ridge AI f32       20.0 FLOP/byte" in out
    assert "compute-bound" in out
