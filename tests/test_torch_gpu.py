"""The port's CUDA kernels on the card. Every test here needs a CUDA device
(an H100: the kernels are built for sm_90a) and skips without one. Run on
the card with:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import GPU_H100, WisdomKernel, args_meta, get_kernel
from repro_torch.kernels import (_build, advec_u, diff_uvw, flash_attention,
                                 matmul, ref)
from repro_torch.kernels._stencil_common import stencil_defines
from repro_torch.tuner import WallClockEvaluator, verify_outcome

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "PYTHONPATH=src python -m pytest -m gpu "
                    "tests/test_torch_gpu.py")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["advec_u", "diff_uvw", "matmul"])
def test_cuda_kernel_matches_plain_version(cuda_device, name, dtype):
    """The default config and three sampled ones, on a ragged shape."""
    b = get_kernel(name)
    problem = (128, 96, 72) if name == "matmul" else (24, 40, 136)
    args = [a.to(cuda_device) for a in b.make_probe_args(problem, dtype)]
    want = b.make_reference()(*args)
    for cfg in [b.default_config(),
                *b.space.sample(np.random.default_rng(0), 3)]:
        got = b.make(cfg, args_meta(*args))(*args)
        torch.cuda.synchronize()
        out = verify_outcome(got, want, dtype)
        assert out.ok, f"{cfg}: {out.error}"


#: Grids for the stencil bodies: ragged and smaller than a tile (nx odd:
#: no 16-byte copy fits a row), the smallest the kernels take, and two
#: ragged ones wider than some tiles.
STENCIL_BODY_SHAPES = [(5, 7, 9), (3, 3, 3), (24, 40, 136), (33, 17, 200)]
#: Updates of each builder's default: one ldg config and three tile ones
#: (the default shape, the smallest tile with the shortest strip, the
#: widest with the longest).
STENCIL_BODY_CONFIGS = [
    {"body": "ldg", "block_size_x": 32, "block_size_y": 4, "strip_z": 64,
     "min_blocks_per_sm": 1},
    {"body": "tile", "block_size_x": 64, "block_size_y": 4, "strip_z": 128,
     "min_blocks_per_sm": 2},
    {"body": "tile", "block_size_x": 16, "block_size_y": 2, "strip_z": 32,
     "min_blocks_per_sm": 1},
    {"body": "tile", "block_size_x": 256, "block_size_y": 4, "strip_z": 128,
     "unravel_permutation": "zyx", "min_blocks_per_sm": 1},
]


def _stencil_fields(cuda_device, shape, n, dtype, offset):
    """n seeded fields (the last nonnegative when n == 4) on the card; with
    ``offset`` each starts one element into its buffer, so no field is
    16-byte aligned and the tile body copies element by element."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    out = []
    for i in range(n):
        f = torch.randn(shape, generator=g, device=cuda_device)
        if n == 4 and i == 3:
            f = f.abs() + 0.1
        f = f.to(getattr(torch, dtype))
        if offset:
            buf = torch.empty(f.numel() + 1, dtype=f.dtype, device=cuda_device)
            buf[1:].copy_(f.flatten())
            f = buf[1:].view(shape)
        out.append(f)
    return out


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("shape", STENCIL_BODY_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["advec_u", "diff_uvw_single",
                                  "diff_uvw_fused"])
def test_stencil_bodies_match_plain_version(cuda_device, name, dtype, shape,
                                            offset):
    """Both bodies of K1, K2a and K2b against the plain version under the
    tuner's tolerance, on ragged and tiny grids, aligned or not; each
    launch counted under the body its config names."""
    scal = torch.tensor([[1.1, 0.9, 1.3, 0.0]], device=cuda_device)
    u, v, w, e = _stencil_fields(cuda_device, shape, 4, dtype, offset)
    b = get_kernel("advec_u" if name == "advec_u" else "diff_uvw")
    extra = ({} if name == "advec_u"
             else {"fuse_outputs": name == "diff_uvw_fused"})
    configs = [b.default_config() | extra | upd
               for upd in STENCIL_BODY_CONFIGS]
    src = "advec_u.cu" if name == "advec_u" else "diff_uvw.cu"
    _build.build_many((src, stencil_defines(c)) for c in configs)
    k = _build.CUDA_KERNELS[name]
    for cfg in configs:
        assert b.space.is_valid(cfg), cfg
        before = k.body_launches.get(cfg["body"], 0)
        if name == "advec_u":
            got = advec_u.launch(cfg, u, v, w, scal)
            want = ref.advec_u_ref(u, v, w, scal)
        elif name == "diff_uvw_fused":
            got = diff_uvw.launch_fused(cfg, u, v, w, e, scal)
            want = ref.diff_uvw_ref(u, v, w, e, scal)
        else:
            got = diff_uvw.launch_single(cfg, u, e, scal)
            want = ref.diff_one_ref(u, e, scal)
        torch.cuda.synchronize()
        out = verify_outcome(got, want, dtype)
        assert out.ok, f"{cfg}: {out.error}"
        assert k.body_launches[cfg["body"]] == before + 1


def test_tile_launch_the_card_refuses_raises(cuda_device):
    """A tile block of 256 x 8 threads in K1 and of 256 x 16 in K2a
    (outside the space: 2048 and 4096 threads; K2a's plan needs 304,128
    bytes of shared memory) is refused by nvcc or by the card: the wrapper
    raises, counts nothing, and does not fall back to the other body or
    the plain version."""
    cfg = advec_u.builder.default_config() | {"block_size_x": 256,
                                              "block_size_y": 8}
    assert not advec_u.builder.space.is_valid(cfg)
    u, v, w, e = _stencil_fields(cuda_device, (16, 16, 256), 4, "float32",
                                 False)
    scal = torch.tensor([[1.1, 0.9, 1.3, 0.0]], device=cuda_device)
    k = _build.CUDA_KERNELS["advec_u"]
    before = (k.launches, dict(k.body_launches))
    with pytest.raises((_build.KernelBuildError, _build.KernelLaunchError)):
        advec_u.launch(cfg, u, v, w, scal)
    assert (k.launches, dict(k.body_launches)) == before

    fused = diff_uvw.builder.default_config() | {
        "body": "tile", "block_size_x": 256, "block_size_y": 16,
        "fuse_outputs": True}
    assert not diff_uvw.builder.space.is_valid(fused)
    assert diff_uvw.plan(fused, (16, 16, 256), "float32").refusal
    k = _build.CUDA_KERNELS["diff_uvw_fused"]
    before = (k.launches, dict(k.body_launches))
    with pytest.raises((_build.KernelBuildError, _build.KernelLaunchError)):
        diff_uvw.launch_fused(fused, u, v, w, e, scal)
    assert (k.launches, dict(k.body_launches)) == before


@pytest.mark.parametrize("shape", [(24, 40, 136), (33, 17, 200), (64,) * 3],
                         ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_tile_matches_single_tile_launches(cuda_device, dtype, shape):
    """K2a's tile body (one launch, three tendencies) against K2b's tile
    body (three launches) at the same block, under the tuner's tolerance:
    the same arithmetic, term for term."""
    scal = torch.tensor([[1.1, 0.9, 1.3, 0.0]], device=cuda_device)
    u, v, w, e = _stencil_fields(cuda_device, shape, 4, dtype, False)
    cfg = diff_uvw.builder.default_config() | {
        "body": "tile", "block_size_x": 64, "block_size_y": 4,
        "strip_z": 64, "min_blocks_per_sm": 2}
    fused, single = cfg | {"fuse_outputs": True}, cfg | {
        "fuse_outputs": False}
    assert diff_uvw.builder.space.is_valid(fused)
    got = diff_uvw.launch_fused(fused, u, v, w, e, scal)
    want = tuple(diff_uvw.launch_single(single, f, e, scal)
                 for f in (u, v, w))
    torch.cuda.synchronize()
    out = verify_outcome(got, want, dtype)
    assert out.ok, out.error


#: (dtype, shape) -> the body the shape rule gives it: (128, 96, 72) is
#: ragged for every tile but TMA takes its bf16 rows; (100, 77, 50) is a
#: bf16 shape TMA cannot take (n, k not multiples of 8).
MATMUL_BODY_CASES = {("float32", (128, 96, 72)): "simt",
                     ("bfloat16", (128, 96, 72)): "wgmma",
                     ("float32", (100, 77, 50)): "simt",
                     ("bfloat16", (100, 77, 50)): "simt"}


def _matmul_args(cuda_device, problem, dtype):
    return [a.to(cuda_device)
            for a in matmul.builder.make_probe_args(problem, dtype)]


@pytest.mark.parametrize("dtype,problem", sorted(MATMUL_BODY_CASES))
def test_matmul_body_split_stages_match_plain_version(cuda_device, dtype,
                                                      problem):
    """Each body x split_k x stages (64- and 128-wide tiles alternating)
    against the plain version under the tuner's tolerance, and the body
    the shape rule names is the one that ran."""
    args = _matmul_args(cuda_device, problem, dtype)
    want = ref.matmul_ref(*args)
    base = matmul.builder.default_config()
    pairs = [(sk, st) for sk in (1, 2, 4) for st in (2, 3, 4)]
    configs = [base | {"split_k": sk, "stages": st, "block_m": w,
                       "block_n": w}
               for (sk, st), w in zip(pairs, [64, 128] * 5)]
    _build.build_many(("matmul.cu", matmul.defines(
        c, matmul.plan(c, *problem, dtype))) for c in configs)
    before = _build.CUDA_KERNELS["matmul"].launches
    for cfg in configs:
        assert matmul.launch_plan(cfg, *args).body == \
            MATMUL_BODY_CASES[(dtype, problem)]
        got = matmul.launch(cfg, *args)
        torch.cuda.synchronize()
        out = verify_outcome(got, want, dtype)
        assert out.ok, f"{cfg}: {out.error}"
    assert _build.CUDA_KERNELS["matmul"].launches == before + len(configs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_split_k_launches_are_bit_identical(cuda_device, dtype):
    """No atomics: two launches of one split_k 4 config agree bit for bit."""
    args = _matmul_args(cuda_device, (384, 256, 1024), dtype)
    cfg = matmul.builder.default_config() | {"split_k": 4, "stages": 3}
    first = matmul.launch(cfg, *args)
    second = matmul.launch(cfg, *args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_refused_launch_raises(cuda_device, dtype):
    """A ring of 8 stages of 128 x 128 tiles (outside the space) needs more
    shared memory than a block may have in either body: the plan says so,
    the card refuses, the wrapper raises and counts nothing."""
    args = _matmul_args(cuda_device, (256, 256, 256), dtype)
    cfg = matmul.builder.default_config() | {"block_k": 32, "stages": 8}
    assert not matmul.builder.space.is_valid(cfg)
    assert matmul.launch_plan(cfg, *args).refusal
    before = _build.CUDA_KERNELS["matmul"].launches
    with pytest.raises(_build.KernelLaunchError):
        matmul.launch(cfg, *args)
    assert _build.CUDA_KERNELS["matmul"].launches == before
    out = matmul.launch(matmul.builder.default_config(), *args)   # still fine
    torch.cuda.synchronize()
    assert verify_outcome(out, ref.matmul_ref(*args), dtype).ok


def test_wisdom_kernel_launch_stats_on_card(cuda_device, tmp_path,
                                            monkeypatch):
    # A library an earlier test loaded would cost this process no load.
    monkeypatch.setattr(_build, "_LOADED", {})
    k = WisdomKernel(get_kernel("matmul"), wisdom_dir=tmp_path)
    a = torch.randn(96, 64, device=cuda_device)
    b = torch.randn(64, 80, device=cuda_device)
    before = _build.CUDA_KERNELS["matmul"].launches
    c1 = k(a, b)
    c2 = k(a, b)
    assert _build.CUDA_KERNELS["matmul"].launches == before + 2
    first, second = k.stats
    assert not first.cached and second.cached
    assert first.load_s > 0 and second.compile_s == second.load_s == 0.0
    assert first.launch_s > 0 and second.launch_s > 0
    assert torch.equal(c1, c2)


def test_wallclock_evaluator_on_card(cuda_device):
    b = get_kernel("advec_u")
    ev = WallClockEvaluator(b, b.make_probe_args((32, 32, 128), "float32"),
                            device=cuda_device, repeats=3)
    r = ev(b.default_config())
    assert r.feasible and r.verified and 0 < r.score_us < 1e6
    assert len(r.info["times_us"]) == 3


@pytest.mark.parametrize("head_dim", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_plain_version(cuda_device, dtype, causal,
                                               head_dim):
    """GQA 4/2 on a ragged S (200: no config's tiles divide it), the
    default config, the two-warpgroup 128 x 128 one and three sampled ones
    that fit a block's shared memory at this head dim, so bfloat16 at
    D=128 runs both bodies; the tuner's allclose and the row relative L2
    bound, and each launch counted under the body choose_body names."""
    name = "flash_attention_causal" if causal else "flash_attention_full"
    b = get_kernel(name)
    args = [a.to(cuda_device)
            for a in b.make_probe_args((8, 4, 200, head_dim), dtype)]
    want = b.make_reference()(*args)
    fa = _build.CUDA_KERNELS["flash_attention"]
    before = fa.launches
    bodies_before = dict(flash_attention.BODY_LAUNCHES)

    def body(c):
        return flash_attention.choose_body(dtype, head_dim, c)

    fits = [c for c in b.space.enumerate()
            if flash_attention.smem_bytes(c, body(c), head_dim, dtype)
            <= GPU_H100.smem_per_block]
    two_wg = {"block_q": 128, "block_k": 128, "threads": 256}
    rng = np.random.default_rng(1)
    configs = [b.default_config(), *([two_wg] if two_wg in fits else []),
               *(fits[i] for i in rng.choice(len(fits), 3, replace=False))]
    for cfg in configs:
        got = b.make(cfg, args_meta(*args))(*args)
        torch.cuda.synchronize()
        out = verify_outcome(got, want, dtype)
        assert out.ok, f"{cfg}: {out.error}"
        row = flash_attention.row_l2_error(got, want)
        assert row <= flash_attention.ROW_L2_TOL[dtype], f"{cfg}: {row}"
    assert fa.launches == before + len(configs)
    ran = {k: n - bodies_before.get(k, 0)
           for k, n in flash_attention.BODY_LAUNCHES.items()
           if n != bodies_before.get(k, 0)}
    want_bodies = {}
    for cfg in configs:
        want_bodies[body(cfg)] = want_bodies.get(body(cfg), 0) + 1
    assert ran == want_bodies
    if dtype == "bfloat16" and head_dim == 128:
        assert ran["wgmma"] >= 2 and set(ran) <= {"wgmma", "mma"}


@pytest.mark.parametrize("head_dim", [384, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_ops_attention_head_dims_without_a_kernel_run_plain(cuda_device,
                                                            causal, head_dim):
    """K4 has no counterpart at D 384 and 512 (the reference's kernel takes
    any D % 128 == 0): ops.attention computes such calls on CUDA tensors
    with the plain ref.attention_ref and launches no flash kernel. A K4
    that takes these head dims replaces this routing, and this test."""
    from repro_torch.kernels import ops

    assert head_dim not in flash_attention.HEAD_DIMS
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((1, 2, 128, head_dim), generator=g,
                           device=cuda_device) for _ in range(3))
    fa = _build.CUDA_KERNELS["flash_attention"]
    before = (fa.launches, dict(flash_attention.BODY_LAUNCHES))
    got = ops.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (fa.launches, dict(flash_attention.BODY_LAUNCHES)) == before
    want = ref.attention_ref(q, k, v, causal=causal)
    assert verify_outcome(got, want, "float32").ok


def test_flash_attention_refused_launch_raises(cuda_device):
    """A config whose float32 tiles at D=256 need more shared memory than
    a block may have: the launcher returns the card's refusal, the wrapper
    raises, and nothing is counted."""
    b = get_kernel("flash_attention_causal")
    cfg = {"block_q": 128, "block_k": 128, "threads": 256}
    assert flash_attention.smem_bytes(cfg, "mma", 256, "float32") > \
        GPU_H100.smem_per_block
    args = [a.to(cuda_device)
            for a in b.make_probe_args((2, 2, 128, 256), "float32")]
    before = _build.CUDA_KERNELS["flash_attention"].launches
    with pytest.raises(_build.KernelLaunchError):
        b.make(cfg, args_meta(*args))(*args)
    assert _build.CUDA_KERNELS["flash_attention"].launches == before
    out = b.make(b.default_config(), args_meta(*args))(*args)   # still fine
    torch.cuda.synchronize()
    assert verify_outcome(out, b.make_reference()(*args), "float32").ok


def _small_lm(cuda_device, dtype):
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = get_arch("codeqwen1.5-7b").reduced(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_head=128,
        param_dtype=dtype, compute_dtype=dtype)
    model = build_model(cfg, device=cuda_device)
    return model, model.init(
        torch.Generator(device=cuda_device).manual_seed(0))


def test_lm_prefill_runs_flash_and_matches_decode(cuda_device):
    """float32: the prefill's 2 layers launch the flash kernel, and its
    last logits match the same tokens fed through decode_step (plain
    attention) within 1e-4 (both IEEE float32)."""
    model, params = _small_lm(cuda_device, "float32")
    tokens = torch.randint(0, model.cfg.vocab, (2, 128), device=cuda_device,
                           generator=torch.Generator(
                               device=cuda_device).manual_seed(1))
    fa = _build.CUDA_KERNELS["flash_attention"]
    before = fa.launches
    pre, cache = model.prefill(params, tokens, model.init_cache(2, 128))
    assert fa.launches == before + 2 and cache["pos"] == 128
    cache = model.init_cache(2, 128)
    for i in range(128):
        dec, cache = model.decode_step(params, cache, tokens[:, i:i + 1])
    assert fa.launches == before + 2
    torch.testing.assert_close(pre, dec, rtol=1e-4, atol=1e-4)


def test_serve_engine_on_card(cuda_device):
    from repro_torch.serve import Request, ServeEngine

    model, params = _small_lm(cuda_device, "bfloat16")
    eng = ServeEngine(model, params, n_slots=2, max_seq=64)
    rng = np.random.default_rng(0)
    for rid in range(4):
        assert eng.submit(Request(rid, rng.integers(
            0, model.cfg.vocab, 8 + rid, dtype=np.int32), max_new_tokens=5))
    rep = eng.run()
    assert rep.mode == "token" and rep.requests_completed == 4
    assert all(len(t) == 5 for t in rep.values())


# ------------------------------------------------- telemetry and profiles

#: (kernel, problem, dtype, config update): each CUDA kernel of the paths,
#: the memory-bound stencils on a grid whose fields do not fit the L2.
PROFILED_CASES = [
    ("advec_u", (256, 256, 256), "float32", {}),
    ("advec_u", (256, 256, 256), "bfloat16", {"body": "ldg", "strip_z": 64}),
    ("diff_uvw", (256, 256, 256), "float32", {}),
    ("diff_uvw", (256, 256, 256), "bfloat16", {"fuse_outputs": False,
                                              "body": "tile"}),
    ("matmul", (512, 512, 1024), "float32", {}),
    ("matmul", (2048, 2048, 2048), "bfloat16", {}),
    ("flash_attention_causal", (32, 8, 1024, 128), "bfloat16", {}),
    ("flash_attention_full", (16, 16, 512, 128), "float32", {}),
]


@pytest.mark.parametrize("name,problem,dtype,upd", PROFILED_CASES)
def test_profiled_launch_has_a_roofline_share(cuda_device, tmp_path, name,
                                              problem, dtype, upd):
    """Three forced launches through a WisdomKernel with obs enabled and a
    profiler sampling every launch: launch.count equals the stats entries,
    every launch has a profile, and each roofline fraction is in (0, 1.05]
    (above 1 the workload's counts would be wrong)."""
    from repro_torch.obs import runtime
    from repro_torch.prof import Profiler

    b = get_kernel(name)
    cfg = b.default_config() | upd
    k = WisdomKernel(b, wisdom_dir=tmp_path, device_kind="gpu-h100")
    pr = Profiler(sample_every=1)
    k.attach_profiler(pr)
    args = [a.to(cuda_device) for a in b.make_probe_args(problem, dtype)]
    runtime.disable()
    reg, _ = runtime.enable()
    try:
        for _ in range(3):
            k(*args, config=cfg)
        snap = reg.snapshot()
    finally:
        runtime.disable()
    assert snap["counters"][f"launch.count{{kernel={name}}}"] == len(
        k.stats) == 3
    assert len(pr.profiles) == 3
    for p, st in zip(pr.profiles, k.stats):
        assert p.config == cfg and p.device_kind == "gpu-h100"
        assert p.latency_us == pytest.approx(st.launch_s * 1e6, abs=1e-3)
        assert 0 < p.roofline_fraction <= 1.05, p.to_json()


@pytest.mark.parametrize("name,upd,problem", [
    ("advec_u", {"block_size_x": 32, "strip_z": 64}, (128, 96, 136)),
    ("diff_uvw", {"fuse_outputs": False, "body": "tile"}, (128, 96, 136)),
    ("diff_uvw", {"block_size_x": 64, "tile_factor_z": 4}, (128, 96, 136)),
    ("matmul", {"split_k": 4, "block_k": 16}, (384, 320, 1000)),
])
def test_static_kernel_matches_forced_wisdom_kernel(cuda_device, tmp_path,
                                                    name, upd, problem):
    """The header's config launched by StaticKernel (on the card by
    default) and by a WisdomKernel forced to it: bit for bit for the
    stencils, within the tuner's tolerance for matmul."""
    from repro_torch.core import Wisdom, WisdomRecord, make_provenance
    from repro_torch.core.export import StaticKernel, export_header

    b = get_kernel(name)
    cfg = b.default_config() | upd
    assert b.space.is_valid(cfg)
    w = Wisdom(name)
    w.add(WisdomRecord(device_kind="gpu-h100", device_family="gpu-hopper",
                       problem_size=problem, dtype="float32", config=cfg,
                       score_us=1.0, provenance=make_provenance()))
    w.save(tmp_path / "wisdom")
    hdr = export_header(name, "gpu-h100", wisdom_dir=tmp_path / "wisdom",
                        out_dir=tmp_path / "gen")
    static = StaticKernel(b, hdr)
    assert static.config == cfg and static.device.type == "cuda"
    wk = WisdomKernel(b, wisdom_dir=tmp_path / "empty",
                      device_kind="gpu-h100")
    for dtype in ("float32", "bfloat16"):
        args = [a.to(cuda_device) for a in b.make_probe_args(problem, dtype)]
        got, want = static(*args), wk(*args, config=cfg)
        if name == "matmul":
            out = verify_outcome(got, want, dtype)
            assert out.ok, out.error
        else:
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            assert all(torch.equal(g, v) for g, v in zip(got, want))
    with pytest.raises(ValueError, match="runs on cuda"):
        static(*b.make_probe_args(problem, "float32"))
