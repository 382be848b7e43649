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


# ------------------------------------------- online tuning on the card

#: K1's tile default, and K2b's tile body at the same block over its ldg
#: default: chip_smoke.py phase 8's configs, here at small grids.
K1_TILE = get_kernel("advec_u").default_config()
K2B_TILE = get_kernel("diff_uvw").default_config() | K1_TILE | {
    "fuse_outputs": False}
K2B_LDG = get_kernel("diff_uvw").default_config() | {"fuse_outputs": False}


def test_gate_checks_the_card_kernel(cuda_device):
    """The gate moves the probe to the card: the hand-written kernel is
    held to the plain version, and the faulty kernel's wrong config is
    vetoed there."""
    from repro_torch.core.registry import register, unregister
    from repro_torch.sandbox import (OracleGate, clear_verdict_cache,
                                     make_faulty_kernel)

    clear_verdict_cache()
    gate = OracleGate(device="cuda")
    verdict = gate.check("advec_u", K1_TILE, (24, 40, 136), "float32")
    assert verdict.ok and verdict.max_err is not None
    oracle = gate._oracles[("advec_u", (24, 40, 136), "float32", "cuda")]
    assert all(a.device.type == "cuda" for a in oracle.args)
    faulty = make_faulty_kernel()
    register(faulty)
    try:
        wrong = gate.check(faulty, {"scale": 1, "fault": "wrong"}, (64, 64),
                           "float32")
        honest = gate.check(faulty, {"scale": 1, "fault": "none"}, (64, 64),
                            "float32")
    finally:
        unregister(faulty.name)
        clear_verdict_cache()
    assert wrong.status == "numerics-mismatch" and not gate.allows(wrong)
    assert honest.ok


def test_online_wallclock_tuning_on_card(cuda_device, tmp_path):
    """Phase 8's loop at 64^3: misses from an empty wisdom file, cost-model
    screening on gpu-h100, live trials timed by CUDA events, then a
    promotion the next launch selects in tier exact without compiling, or
    the incumbent kept."""
    from repro_torch.examples.tune_microhh import launch_args
    from repro_torch.online import enable_online_tuning
    from repro_torch.tuner import CostModelEvaluator

    k = WisdomKernel(get_kernel("advec_u"), wisdom_dir=tmp_path,
                     device_kind="gpu-h100")
    svc = enable_online_tuning(k, objective="wallclock", seed=0)
    args = launch_args("advec_u", (64, 64, 64), "float32", cuda_device)
    for _ in range(400):
        k(*args)
        state = svc.state((64, 64, 64), "float32")
        if state is not None and state.finished:
            break
    assert [s.tier for s in k.stats[:3]] == ["default"] * 3
    assert isinstance(state.evaluator, CostModelEvaluator)
    assert state.finished and state.scheduler.winner() is not None
    trials = [s for s in k.stats if s.tier == "trial"]
    assert trials and all(s.launch_s > 0 for s in trials)
    outcome = svc.events[-1][0]
    assert outcome in ("promote", "keep-incumbent")
    if outcome == "promote":
        out = k(*args)
        st = k.stats[-1]
        assert st.tier == "exact" and st.cached and st.compile_s == 0.0
        rec = svc.promotions()[0].record
        assert rec.provenance["online"] and rec.oracle_verified()
        assert verify_outcome(out, ref.advec_u_ref(*args), "float32").ok


def test_deterministic_promotion_on_card(cuda_device, tmp_path):
    from repro_torch.examples.tune_microhh import launch_args
    from repro_torch.online.promotion import PromotionPipeline

    args = launch_args("diff_uvw", (64, 64, 64), "float32", cuda_device)
    k = WisdomKernel(get_kernel("diff_uvw"), wisdom_dir=tmp_path,
                     device_kind="gpu-h100")
    k(*args, config=K2B_LDG)
    pipe = PromotionPipeline(k)
    promo = pipe.promote("gpu-h100", (64, 64, 64), "float32", K2B_TILE,
                         score_us=80.0, incumbent_score_us=100.0,
                         n_measurements=3, evals=2, objective="wallclock",
                         meta=args_meta(*args))
    assert promo is not None and promo.record.oracle_verified()
    out = k(*args)
    st = k.stats[-1]
    assert st.tier == "exact" and st.config == K2B_TILE
    assert st.cached and st.compile_s == 0.0
    assert verify_outcome(out, ref.diff_uvw_ref(*args), "float32").ok


def test_spawned_sandbox_with_cuda_in_the_child(cuda_device):
    """Each fault mode in a child holding a CUDA context gives its status
    (a device allocation bomb: oom under the memory fraction); a child
    that loses its context to a device-side assertion is a crash; this
    process launches K1 afterwards."""
    import functools

    from repro_torch.sandbox import (SandboxSettings, device_assert,
                                     sandboxed_call)
    from repro_torch.sandbox.demo import EXPECTED_VERDICTS, run_fault_modes

    def settings(mode):
        return SandboxSettings(timeout_s=5.0 if mode == "hang" else 120.0,
                               device_memory_fraction=0.02)

    runs = run_fault_modes(EXPECTED_VERDICTS, settings, device="cuda")
    for mode, want in EXPECTED_VERDICTS.items():
        result, verdict = runs[mode]
        assert verdict.status == want, (mode, verdict.detail, verdict.stderr)
        assert result.feasible == (mode == "none")
    assert runs["segv"][1].exit_cause == "signal:11"
    lost, _ = sandboxed_call(functools.partial(device_assert, "cuda"),
                             settings("assert"))
    assert lost.status == "crash" and "CUDA" in lost.detail
    args = [a.to(cuda_device)
            for a in get_kernel("advec_u").make_probe_args((24, 40, 136),
                                                          "float32")]
    got = advec_u.launch(K1_TILE, *args)
    assert verify_outcome(got, ref.advec_u_ref(*args), "float32").ok


# --------------------------------------------- recorded spaces on the card

#: The quickstart's matmul scenario; its first 18 configs in space order are
#: every (stages, split_k, grid_order) of block 64 x 64 at block_k 8.
RECORD_PROBLEM = (512, 512, 1024)
RECORD_LIMIT = 18


def _build_matmul_configs(configs, problem, dtype):
    """Every config's library at ``problem``, one nvcc each, in parallel."""
    _build.build_many([("matmul.cu", matmul.defines(c, matmul.plan(
        c, *problem, dtype))) for c in configs])


def test_record_space_by_wall_clock_on_card(cuda_device):
    """Every config of one block_k, recorded on the card: each feasible,
    timed, verified against the plain version, with its profile; the
    dataset round-trips and its optimum is one of them."""
    from repro_torch.tunebench import SpaceDataset, record_space

    b = get_kernel("matmul")
    cfgs = list(b.space.enumerate(limit=RECORD_LIMIT))
    assert {(c["block_m"], c["block_n"], c["block_k"]) for c in cfgs} == \
        {(64, 64, 8)}
    _build_matmul_configs(cfgs, RECORD_PROBLEM, "float32")
    ds = record_space(b, RECORD_PROBLEM, "float32", "gpu-h100",
                      objective="wallclock", limit=RECORD_LIMIT)
    assert len(ds) == RECORD_LIMIT == len(ds.feasible())
    assert all(0 < e.score_us < 1e4 and e.profile["bottleneck"]
               for e in ds.feasible())
    assert ds.provenance["device"] == torch.cuda.get_device_name(0)
    again = SpaceDataset.from_doc(ds.to_doc())
    assert again.best().config == ds.best().config in cfgs


def test_tune_kernel_records_its_dataset_on_card(cuda_device, tmp_path):
    """tune_kernel(record_dataset=) by wall clock writes one entry per
    evaluation, with the session's scores, and the winner through the
    WisdomStore."""
    from repro_torch.distrib import WisdomStore
    from repro_torch.tunebench import DatasetStore
    from repro_torch.tuner import tune_kernel

    res = tune_kernel(get_kernel("matmul"), RECORD_PROBLEM, "float32",
                      "gpu-h100", strategy="random", max_evals=4,
                      time_budget_s=None, wisdom_dir=tmp_path / "w",
                      record_dataset=tmp_path / "ds")
    ds = DatasetStore(tmp_path / "ds").load_for(
        "matmul", "gpu-h100", RECORD_PROBLEM, "float32")
    assert len(ds) == len(res.evaluations) == 4
    for e in res.evaluations:
        assert e.feasible and ds.lookup(e.config).score_us == e.score_us
    rec = WisdomStore(tmp_path / "w").load("matmul").records[0]
    assert rec.config == res.best_config


def test_sandboxed_evaluator_records_a_cuda_child(cuda_device):
    """SandboxedEvaluator(record_to=) around a KernelTrial: the spawned
    child builds and times the config on the card; this process records
    the entry, feasible and without a verdict."""
    from repro_torch.sandbox import (KernelTrial, SandboxedEvaluator,
                                     SandboxSettings)
    from repro_torch.tunebench import SpaceDataset

    b = get_kernel("matmul")
    cfg = b.default_config()
    ds = SpaceDataset("matmul", b.space, RECORD_PROBLEM, "float32",
                      "gpu-h100", objective="wallclock")
    ev = SandboxedEvaluator(KernelTrial("matmul", RECORD_PROBLEM, "float32"),
                            SandboxSettings(timeout_s=120.0,
                                            device_memory_fraction=0.02),
                            record_to=ds)
    r = ev(cfg)
    assert r.feasible and r.verified, r.error
    entry = ds.lookup(cfg)
    assert len(ds) == 1 and entry.feasible and entry.verdict == ""
    assert entry.score_us == r.score_us


# ------------------------------------------------------ fleet wisdom (sync)

def _fleet_job(bus, kernel, problem, dtype, results):
    """Publish a two-shard job with the given shard winners
    ``[(config, score_us)]``, as workers would have."""
    from repro_torch.fleet import TuningJob, job_id_for, lease_name
    key = ("gpu-h100", tuple(problem), dtype)
    job = TuningJob(job_id=job_id_for(kernel, key), kernel=kernel,
                    device_kind="gpu-h100", problem=tuple(problem),
                    dtype=dtype, n_shards=len(results), misses=5)
    bus.publish("job", job.job_id, job.to_json())
    for i, (cfg, us) in enumerate(results):
        bus.publish("result", lease_name(job.job_id, f"s{i:03d}"), {
            "job": job.job_id, "shard": f"s{i:03d}", "worker": f"w{i}",
            "strategy": "exhaustive", "evals": 8, "feasible_evals": 8,
            "best_config": dict(cfg), "best_score_us": us})
    return job


def test_coordinator_gate_checks_winners_on_the_card(cuda_device):
    """The coordinator's default gate runs on the card: an honest matmul
    winner is assembled with the ``verified`` stamp, and the faulty
    kernel's wrong winner is vetoed there for its honest runner-up."""
    from repro_torch.core.registry import register, unregister
    from repro_torch.distrib import MemoryTransport
    from repro_torch.fleet import ControlBus, Coordinator
    from repro_torch.sandbox import clear_verdict_cache, make_faulty_kernel

    clear_verdict_cache()
    bus = ControlBus(MemoryTransport())
    coord = Coordinator(bus)
    assert coord.oracle.device.type == "cuda"
    mm = get_kernel("matmul")
    cfg = mm.default_config() | {"split_k": 2}
    _fleet_job(bus, "matmul", (512, 512, 1024), "float32",
               [(mm.default_config(), 60.0), (cfg, 50.0)])
    faulty = make_faulty_kernel()
    register(faulty)
    try:
        _fleet_job(bus, faulty.name, (64, 64), "float32",
                   [({"scale": 1, "fault": "wrong"}, 10.0),
                    ({"scale": 1, "fault": "none"}, 20.0)])
        k3 = _build.CUDA_KERNELS["matmul"]
        before = k3.launches
        records = {r.config.get("fault", "matmul"): r
                   for r in coord.assemble()}
        assert k3.launches > before
    finally:
        unregister(faulty.name)
        clear_verdict_cache()
    assert records["matmul"].config == cfg
    assert records["matmul"].oracle_verified() is not None
    assert records["none"].oracle_verified() is not None
    assert "wrong" not in records
    statuses = [v.status for _, _, v in coord.oracle.checks]
    assert statuses.count("numerics-mismatch") == 1


def test_pull_sync_refreshes_ops_flash_kernel(cuda_device, tmp_path,
                                              monkeypatch):
    """A pull that brings a flash record refreshes ops' WisdomKernel: the
    next launch selects the pulled record at tier exact."""
    from repro_torch.core import Wisdom, WisdomRecord
    from repro_torch.distrib import MemoryTransport, PullSync, WisdomStore
    from repro_torch.kernels import ops

    monkeypatch.setenv("KERNEL_LAUNCHER_WISDOM_DIR", str(tmp_path))
    ops.reload_wisdom()
    fa = ops.fa_causal_kernel
    problem = (8, 8, 256, 128)
    q, k, v = [a.to(cuda_device) for a in
               fa.builder.make_probe_args(problem, "bfloat16")]
    fa(q, k, v)
    assert fa.stats[-1].tier != "exact"
    cfg = fa.builder.default_config() | {"block_q": 128, "block_k": 128,
                                         "threads": 256}
    transport = MemoryTransport()
    transport.publish(fa.builder.name, Wisdom(fa.builder.name, [
        WisdomRecord(device_kind=fa.device_kind,
                     device_family=GPU_H100.family, problem_size=problem,
                     dtype="bfloat16", config=cfg, score_us=12.0,
                     provenance={"source": "fleet"})]).to_doc())
    sync = PullSync(WisdomStore(tmp_path), transport, kernels=[fa])
    assert sync.pull().records_out == 1
    got = fa(q, k, v)
    st = fa.stats[-1]
    monkeypatch.delenv("KERNEL_LAUNCHER_WISDOM_DIR")
    ops.reload_wisdom()
    assert st.tier == "exact" and st.config == cfg
    want = fa.builder.make_reference()(q, k, v)
    assert verify_outcome(got, want, "bfloat16").ok


def test_serve_engine_reports_sync_pulls_on_card(cuda_device, tmp_path):
    from repro_torch.core import Wisdom, WisdomRecord
    from repro_torch.distrib import MemoryTransport, PullSync, WisdomStore
    from repro_torch.serve import Request, ServeEngine

    model, params = _small_lm(cuda_device, "bfloat16")
    transport = MemoryTransport()
    transport.publish("matmul", Wisdom("matmul", [WisdomRecord(
        device_kind="gpu-h100", device_family=GPU_H100.family,
        problem_size=(512, 512, 1024), dtype="float32",
        config=get_kernel("matmul").default_config(), score_us=50.0,
        provenance={"source": "fleet"})]).to_doc())
    sync = PullSync(WisdomStore(tmp_path), transport, interval=8)
    eng = ServeEngine(model, params, n_slots=2, max_seq=64, sync=sync)
    rng = np.random.default_rng(0)
    for rid in range(4):
        assert eng.submit(Request(rid, rng.integers(
            0, model.cfg.vocab, 8 + rid, dtype=np.int32), max_new_tokens=5))
    rep = eng.run()
    assert rep.requests_completed == 4
    assert rep.sync_pulls == sync.pulls == (rep.steps + 7) // 8 >= 1
    assert rep.sync_failures == 0
    assert len(WisdomStore(tmp_path).load("matmul")) == 1
