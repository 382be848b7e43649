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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [384, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_ops_attention_at_head_dims_384_and_512_launches_k4(
        cuda_device, monkeypatch, tmp_path, causal, head_dim, dtype):
    """D 384 and 512 (the reference's kernel takes any D % 128 == 0): on
    CUDA tensors ops.attention launches K4 (the mma body, which splits the
    output's head dim across warps), seen by the launch observer the
    dry-run counts with, in the config the card takes at that D (the
    default, or flash_attention.FIT_CONFIGS where the card refuses it),
    and matches the plain version at the tuner's tolerances, GQA group 4
    (8 q heads on 2 kv heads), S 256."""
    from repro_torch.core import wisdom_kernel
    from repro_torch.kernels import ops

    monkeypatch.setenv("KERNEL_LAUNCHER_WISDOM_DIR", str(tmp_path))
    ops.reload_wisdom()
    assert head_dim in flash_attention.HEAD_DIMS
    g = torch.Generator(device=cuda_device).manual_seed(head_dim)
    q, k, v = (torch.randn((2, h, 256, head_dim), generator=g,
                           device=cuda_device).to(getattr(torch, dtype))
               for h in (8, 2, 2))
    seen = []
    fa = _build.CUDA_KERNELS["flash_attention"]
    before = (fa.launches, flash_attention.BODY_LAUNCHES.get("mma", 0))
    monkeypatch.setattr(wisdom_kernel, "LAUNCH_OBSERVERS",
                        [lambda b, c, p, d: seen.append((b.name, c, p, d))])
    got = ops.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    name = "flash_attention_causal" if causal else "flash_attention_full"
    cfg = flash_attention.fit_config(get_kernel(name).default_config(),
                                     head_dim, dtype)
    assert seen == [(name, cfg, (16, 4, 256, head_dim), dtype)]
    assert (fa.launches, flash_attention.BODY_LAUNCHES["mma"]) == (
        before[0] + 1, before[1] + 1)
    want = ref.flash_attention_ref_factory(causal)(
        q.reshape(16, 256, head_dim), k.reshape(4, 256, head_dim),
        v.reshape(4, 256, head_dim)).reshape(q.shape)
    out = verify_outcome(got, want, dtype)
    assert out.ok, out.error
    assert flash_attention.row_l2_error(got, want) <= \
        flash_attention.ROW_L2_TOL[dtype]


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


# ------------------------------------------------------------- training


@pytest.fixture()
def empty_wisdom(tmp_path, monkeypatch):
    """ops' kernels select from an empty wisdom dir: the default configs."""
    from repro_torch.kernels import ops
    monkeypatch.setenv("KERNEL_LAUNCHER_WISDOM_DIR", str(tmp_path / "w"))
    ops.reload_wisdom()
    yield
    monkeypatch.delenv("KERNEL_LAUNCHER_WISDOM_DIR")
    ops.reload_wisdom()


@pytest.mark.parametrize("dtype,body", [("bfloat16", "wgmma"),
                                        ("float32", "mma")])
def test_flash_gradient_matches_plain_autograd_on_card(cuda_device,
                                                       empty_wisdom, dtype,
                                                       body):
    """``ops.attention`` on CUDA tensors that want a gradient: its output
    carries ``FlashAttentionFn``, K4 launches once in the body the dtype
    selects, the backward launches the backward kernel once in bfloat16
    and never in float32 (the plain recompute), and the output and the q,
    k, v gradients match the plain version's autograd on the same tensors.
    bfloat16: max abs <= 0.05 x max(1, max|ref|) and relative L2 <= 0.05
    (the LM slice's bound); float32: rtol = 1e-3, atol = 1e-3 x max|ref|.
    A K4 output without a gradient fails the first assertion or leaves
    q.grad None."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=cuda_device).manual_seed(3)
    dt = getattr(torch, dtype)
    b, hq, hkv, s, d = 2, 4, 2, 256, 128
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dt)
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    ct = torch.randn((b, hq, s, d), generator=g, device=cuda_device).to(dt)
    got = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa = _build.CUDA_KERNELS["flash_attention"]
    bwd = _build.CUDA_KERNELS["flash_attention_bwd"]
    n0, body0, b0 = fa.launches, fa.body_launches.get(body, 0), bwd.launches
    out = ops.attention(*got, causal=True)
    assert flash_attention.through_flash_fn(out)
    assert fa.launches == n0 + 1 and fa.body_launches[body] == body0 + 1
    out.backward(ct)
    want = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref.attention_ref(*want, causal=True).backward(ct)
    assert fa.launches == n0 + 1          # the backward launches no forward
    assert bwd.launches == b0 + (dtype == "bfloat16")
    pairs = [(out.detach(), ref.attention_ref(q, k, v, causal=True))]
    pairs += [(a.grad, r.grad) for a, r in zip(got, want)]
    for a, r in pairs:
        a, r = a.double(), r.double()
        top = float(r.abs().max())
        if dtype == "bfloat16":
            assert float((a - r).abs().max()) <= 0.05 * max(1.0, top)
            assert float((a - r).norm() / r.norm()) <= 0.05
        else:
            torch.testing.assert_close(a, r, rtol=1e-3, atol=1e-3 * top)


#: The flash backward's shapes on the card: the training cell's (BH 64,
#: BHkv 8, S 2048) and a ragged S no tile divides, at GQA 8/2.
FA_BWD_SHAPES = [(64, 8, 2048, 128), (8, 2, 200, 128)]


def _fa_bwd_case(cuda_device, problem, causal):
    """bfloat16 q, k, v, dO on the card and the plain version's float32
    autograd gradients of the same bfloat16 values."""
    g = torch.Generator(device=cuda_device).manual_seed(sum(problem))
    bh, bhkv, s, d = problem
    args = [torch.randn(shape, generator=g, device=cuda_device)
            .to(torch.bfloat16) for shape in
            ((bh, s, d), (bhkv, s, d), (bhkv, s, d), (bh, s, d))]
    want = ref.flash_attention_bwd_ref_factory(causal)(
        *(t.float() for t in args))
    return args, want


@pytest.mark.parametrize("problem", FA_BWD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_matches_float32_autograd_on_card(cuda_device,
                                                          problem, causal):
    """The backward kernel in its default config and, on the ragged shape,
    three sampled configs: each of dq, dk and dv within relative L2 1e-2 of
    float32 autograd on the same bfloat16 inputs (P and dS round to bf16
    before their products: ~3e-3), its worst row (``row_l2_error``) within
    5e-2; one launch counted a call; and a second call gives the same bits
    (no atomics)."""
    b = get_kernel("flash_attention_bwd_causal" if causal
                   else "flash_attention_bwd_full")
    args, want = _fa_bwd_case(cuda_device, problem, causal)
    configs = [b.default_config()]
    if problem[2] == 200:
        rng = np.random.default_rng(2)
        space = list(b.space.enumerate())
        configs += [space[i] for i in rng.choice(len(space), 3,
                                                 replace=False)]
    bwd = _build.CUDA_KERNELS["flash_attention_bwd"]
    for cfg in configs:
        fn = b.make(cfg, args_meta(*args))
        n0 = bwd.launches
        got = fn(*args)
        again = fn(*args)
        torch.cuda.synchronize()
        assert bwd.launches == n0 + 2
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            a64, w64 = a.double(), w.double()
            rel = float((a64 - w64).norm() / w64.norm())
            row = flash_attention.row_l2_error(a64, w64)
            assert rel <= 1e-2 and row <= 5e-2, (cfg, name, rel, row)
        assert all(torch.equal(x, y) for x, y in zip(got, again)), cfg


def test_flash_backward_refuses_what_it_does_not_take(cuda_device):
    """float32 operands, another head dim or an operand off a 16-byte
    boundary: the wrapper raises before any launch."""
    b = get_kernel("flash_attention_bwd_causal")
    args, _ = _fa_bwd_case(cuda_device, (4, 2, 128, 128), True)
    run = b.make(b.default_config(), args_meta(*args))
    n0 = _build.CUDA_KERNELS["flash_attention_bwd"].launches
    with pytest.raises(ValueError, match="bfloat16"):
        run(*(t.float() for t in args))
    with pytest.raises(ValueError, match="head dim 128"):
        run(*(t[..., :64].contiguous() for t in args))
    off = [torch.empty(t.numel() + 8, dtype=t.dtype, device=cuda_device)
           [1:1 + t.numel()].view(t.shape) for t in args]
    with pytest.raises(ValueError, match="16-byte"):
        run(*off)
    assert _build.CUDA_KERNELS["flash_attention_bwd"].launches == n0


def _small_train(device, remat=True):
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_schedule

    cfg = get_arch("codeqwen1.5-7b").reduced(
        n_layers=2, d_model=256, n_heads=2, n_kv_heads=2, d_head=128,
        d_ff=512, vocab=512)
    model = build_model(cfg, device=device, remat=remat)
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=1, total=4))
    return model, opt, build_model(cfg, device="cpu").init(0)


def test_train_step_on_card_matches_the_host(cuda_device, empty_wisdom):
    """One ``make_train_step`` (2 microbatches, remat) at the small f32
    config that reaches K4, on the card and on the CPU from the same
    weights and batch: K4 launches 2 x 2 x 2 = 8 times (each layer's
    forward and recompute, each microbatch); the loss and the gradient's
    global norm within 1e-4 relative; each leaf of the first moment m,
    which after one step is 0.1 x the clipped gradient and so linear in
    it, within 1e-3 x max|host leaf| + 1e-9 (both sides are IEEE f32, K4
    included; a gradient lost through attention leaves m's q/k/v leaves
    at 0 and fails); every parameter within 2 lr + 1e-6 (Adam moves a
    weight by about lr x sign(g) on its first step, and a near-zero
    gradient can flip sign between the two devices' summation orders)."""
    from repro_torch import tree
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.train import init_train_state, make_train_step

    model, opt, params = _small_train(cuda_device)
    host, _, _ = _small_train("cpu")
    batch = SyntheticTokenDataset(vocab=512, seq=128, global_batch=4,
                                  seed=2).batch(0)
    states = []
    for m, dev in ((model, cuda_device), (host, torch.device("cpu"))):
        st = init_train_state(m, opt, 0)
        st["params"] = tree.tree_map(lambda p: p.to(dev), params)
        states.append(st)
    fa = _build.CUDA_KERNELS["flash_attention"]
    n0 = fa.launches
    on_card, m1 = make_train_step(model, opt, microbatches=2)(states[0],
                                                              batch)
    assert fa.launches - n0 == 8
    on_host, m2 = make_train_step(host, opt, microbatches=2)(states[1],
                                                            batch)
    for key in ("loss", "grad_norm"):
        assert abs(float(m1[key]) - float(m2[key])) <= \
            1e-4 * abs(float(m2[key])), key
    for (path, a), b in zip(tree.leaves_with_paths(on_card["opt"]["m"]),
                            tree.leaves(on_host["opt"]["m"])):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-3 * float(b.abs().max()) + 1e-9, (path, err)
    for (path, a), b in zip(tree.leaves_with_paths(on_card["params"]),
                            tree.leaves(on_host["params"])):
        err = float((a.cpu() - b).abs().max())
        assert err <= 2 * 3e-3 + 1e-6, (path, err)


def test_remat_gives_the_same_gradients_on_card(cuda_device, empty_wisdom):
    """``build_model(..., remat=True)`` on the card: the same gradients
    as ``remat=False`` (max abs <= 1e-5 x max(1, max|g|): the recompute
    repeats the same kernels; the embedding backward's atomic adds may
    sum in another order), with K4 launched twice a layer instead of
    once."""
    from repro_torch import tree
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.train import move_batch

    batch = move_batch(SyntheticTokenDataset(
        vocab=512, seq=128, global_batch=2, seed=4).batch(0), cuda_device)
    fa = _build.CUDA_KERNELS["flash_attention"]
    grads = {}
    for remat, per_layer in ((False, 1), (True, 2)):
        model, _, params = _small_train(cuda_device, remat=remat)
        params = tree.tree_map(
            lambda p: p.to(cuda_device).requires_grad_(True), params)
        n0 = fa.launches
        loss, _ = model.loss(params, batch)
        loss.backward()
        assert fa.launches - n0 == per_layer * model.cfg.n_layers
        grads[remat] = tree.leaves(tree.tree_map(lambda p: p.grad, params))
    for a, b in zip(grads[False], grads[True]):
        top = float(a.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * max(1.0, top)


# ----------------------------------------------------------------- the zoo

def _zoo_model(device, arch, dtype="float32", **upd):
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = get_arch(arch).reduced(param_dtype=dtype, compute_dtype=dtype,
                                 **upd)
    return build_model(cfg, device=device)


def _to(tree_, device):
    from repro_torch import tree
    return tree.tree_map(lambda t: t.to(device), tree_)


def test_moe_ffn_on_card_matches_the_host(cuda_device):
    """``moe_ffn`` at a small width, capacity factor 1.25 and chunk 16,
    with a router skewed to expert 0 so buckets overflow and tokens drop:
    the card (float32, IEEE products) against the CPU on the same inputs,
    rtol = atol = 1e-4; both drop the same (token, k) choices."""
    import dataclasses

    from repro_torch.models import moe

    model = _zoo_model("cpu", "deepseek-moe-16b")
    cfg = dataclasses.replace(model.cfg, moe=dataclasses.replace(
        model.cfg.moe, capacity_factor=1.25, chunk=16))
    g = torch.Generator().manual_seed(0)
    p = moe.init_moe(g, cfg, "cpu")
    u = torch.randn(cfg.d_model, generator=g)
    u /= u.norm()
    p["router"][:, 0] += 3.0 * u
    x = torch.randn((2, 64, cfg.d_model), generator=g) + 2.0 * u
    cap = moe._capacity(cfg.moe, 16)
    sel = moe.route(cfg, p, x[:, :16])[3]
    assert int(torch.bincount(sel[0].reshape(-1)).max()) > cap
    want, want_aux = moe.moe_ffn(cfg, p, x)
    got, aux = moe.moe_ffn(cfg, _to(p, cuda_device), x.to(cuda_device))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for k in want_aux:
        torch.testing.assert_close(aux[k].cpu(), want_aux[k], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("block", [1024, 3])
def test_mla_decode_on_card_matches_the_host(cuda_device, monkeypatch, block):
    """Absorbed MLA decode (4 steps after an 8-token prefill) on the card
    against the CPU, float32, rtol = atol = 1e-4, and against the
    expanded forward on the card; with the cache cast to float32 in one
    block and in blocks of 3 positions."""
    from repro_torch.models import mla

    monkeypatch.setattr(mla, "DECODE_BLOCK", block)

    model = _zoo_model("cpu", "deepseek-v2-236b")
    cfg = model.cfg
    g = torch.Generator().manual_seed(1)
    p = mla.init_mla(g, cfg, "cpu")
    x = torch.randn((2, 12, cfg.d_model), generator=g)
    outs = {}
    for dev in ("cpu", cuda_device):
        pd, xd = _to(p, dev), x.to(dev)
        c = mla.init_mla_cache(cfg, 1, 2, 16, torch.float32, dev)
        ckv, kpe = c["c_kv"][0], c["k_pe"][0]
        _, ckv, kpe = mla.mla_prefill(cfg, pd, xd[:, :8], ckv, kpe)
        steps = []
        for pos in range(8, 12):
            o, ckv, kpe = mla.mla_decode(cfg, pd, xd[:, pos:pos + 1], ckv,
                                         kpe, pos)
            steps.append(o)
        outs[str(dev)] = (torch.cat(steps, 1), mla.mla_forward(cfg, pd, xd))
    (got, full), (want, _) = outs["cuda"], outs["cpu"]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, full[:, 8:], rtol=1e-4, atol=1e-4)


def test_vision_prefill_on_card_runs_flash_and_matches_the_host(cuda_device):
    """A reduced vision model with d_head 128 (2 groups of a gated cross
    block, gate 1.0, and 2 self layers), S 128, float32: the card's
    prefill launches K4 once a self layer and never in a cross block; its
    logits, and 2 decode steps', match the CPU's within 1e-4 (both IEEE
    float32)."""
    model = _zoo_model("cpu", "llama-3.2-vision-11b", n_layers=6,
                       cross_attn_period=3, d_model=64, n_heads=4,
                       n_kv_heads=2, d_head=128)
    card = _zoo_model(cuda_device, "llama-3.2-vision-11b", n_layers=6,
                      cross_attn_period=3, d_model=64, n_heads=4,
                      n_kv_heads=2, d_head=128)
    cfg = model.cfg
    params = model.init(0)
    for cross in params["cross"]:
        cross["attn"]["gate"].fill_(1.0)
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (2, 130), generator=g)
    img = torch.randn((2, cfg.n_img_tokens, cfg.d_model), generator=g)
    fa = _build.CUDA_KERNELS["flash_attention"]
    outs = {}
    for m, dev in ((model, "cpu"), (card, cuda_device)):
        p = _to(params, dev)
        n0 = fa.launches
        lg, cache = m.prefill(p, tokens[:, :128].to(dev),
                              m.init_cache(2, 130), img=img.to(dev))
        if m is card:
            assert fa.launches - n0 == 4      # 2 groups x 2 self layers
        got = [lg]
        for i in range(2):
            lg, cache = m.decode_step(p, cache,
                                      tokens[:, 128 + i:129 + i].to(dev))
            got.append(lg)
        outs[str(dev)] = torch.cat(got, 1).cpu()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=1e-4,
                               atol=1e-4)


def test_flash_attention_gqa_32_8_matches_plain_version(cuda_device):
    """K4 through ``ops.attention`` at llama-3.2-vision's GQA 32/8 (D 128,
    S 512, bfloat16: the wgmma body) against ``ref.attention_ref``: the
    tuner's bf16 allclose and the row relative L2 bound."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device)
               .to(torch.bfloat16)
               for shape in ((1, 32, 512, 128), (1, 8, 512, 128),
                             (1, 8, 512, 128)))
    fa = _build.CUDA_KERNELS["flash_attention"]
    n0, w0 = fa.launches, fa.body_launches.get("wgmma", 0)
    got = ops.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1
    assert fa.body_launches.get("wgmma", 0) == w0 + 1
    want = ref.attention_ref(q, k, v, causal=True)
    out = verify_outcome(got, want, "bfloat16")
    assert out.ok, out.error
    row = flash_attention.row_l2_error(got.reshape(32, 512, 128),
                                       want.reshape(32, 512, 128))
    assert row <= flash_attention.ROW_L2_TOL["bfloat16"], row


# ------------------------------------------- the recurrent and enc-dec stacks

def _redraw_recurrent(params: dict, g: torch.Generator) -> None:
    """Redraw, in place, the parameters the reference initialises to 0 or
    1 (rwkv's ``mu``, ``mu_c``, ``bonus``, ``decay_base``, ``ln_x.scale``;
    mamba's ``A_log``, ``dt_bias``, ``D_skip``), which would hide a wrong
    token shift, bonus or decay."""
    from repro_torch import tree

    for path, t in tree.leaves_with_paths(params):
        name = path.split("/")[-1]
        if name in ("mu", "mu_c"):
            t.copy_(torch.rand(t.shape, generator=g))
        elif name in ("bonus", "decay_base", "dt_bias", "A_log"):
            t.copy_(0.5 * torch.randn(t.shape, generator=g))
        elif name == "D_skip" or path.endswith("ln_x/scale"):
            t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=g))


@pytest.mark.parametrize("arch,upd,seq", [
    ("hymba-1.5b", dict(n_layers=3), 256),
    ("rwkv6-7b", dict(n_layers=2), 64),
    ("whisper-base", dict(n_layers=2, enc_seq=32), 64)])
def test_recurrent_stacks_on_card_match_the_host(cuda_device, arch, upd,
                                                 seq):
    """A reduced hymba (windows full, 8, full; 256 tokens: the mamba scan
    carries its state across 2 chunks of 128), rwkv6 and whisper (32
    frames), float32, the zero-initialised recurrent parameters redrawn:
    forward, prefill and 2 decode steps on the card match the CPU within
    1e-4 (both IEEE float32), and none of them launches K4 (d_head 16
    here; the full configs' 64 is no flash head dim either)."""
    model = _zoo_model("cpu", arch, **upd)
    card = _zoo_model(cuda_device, arch, **upd)
    cfg = model.cfg
    params = model.init(0)
    g = torch.Generator().manual_seed(4)
    _redraw_recurrent(params, g)
    tokens = torch.randint(0, cfg.vocab, (2, seq + 2), generator=g)
    extra = ({"frames": torch.randn((2, cfg.enc_seq, cfg.d_model),
                                    generator=g)} if cfg.enc_dec else {})
    fa = _build.CUDA_KERNELS["flash_attention"]
    n0 = fa.launches
    outs = {}
    for m, dev in ((model, "cpu"), (card, cuda_device)):
        p = _to(params, dev)
        ex = {k: v.to(dev) for k, v in extra.items()}
        tok = tokens.to(dev)
        with torch.no_grad():
            x, _ = m.forward(p, tok[:, :seq], **ex)
            lg, cache = m.prefill(p, tok[:, :seq], m.init_cache(2, seq + 2),
                                  **ex)
            got = [lg]
            for i in range(2):
                lg, cache = m.decode_step(p, cache,
                                          tok[:, seq + i:seq + i + 1])
                got.append(lg)
        outs[str(dev)] = (x.cpu(), torch.cat(got, 1).cpu())
    assert fa.launches == n0
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_debug_mesh_prefill_adds_k4_workload_per_launch(cuda_device,
                                                        empty_wisdom):
    """A reduced codeqwen (2 layers, d_head 128, bf16) prefill of 2 x 256
    tokens on the card's 1x1 debug mesh, through the dry-run: K4 launches
    once a layer in each of its two runs (counted, then timed), and the
    counted run adds K4's workload flops for each launch."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.shapes import SHAPES

    cfg = get_arch("codeqwen1.5-7b").reduced(
        n_layers=2, n_heads=2, n_kv_heads=2, d_head=128, d_model=256,
        param_dtype="bfloat16", compute_dtype="bfloat16")
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq=256,
                                global_batch=2)
    fa = _build.CUDA_KERNELS["flash_attention"]
    n0 = fa.launches
    try:
        mesh = mesh_mod.make_debug_mesh(device="cuda")
        rec = lower_cell("codeqwen1.5-7b", "prefill_32k", mesh,
                         verbose=False, cfg=cfg, shape=shape)
    finally:
        mesh_mod.release()
    assert rec["status"] == "ok" and rec["device"] == "cuda"
    assert rec["kernel_launches"] == {"flash_attention_causal": 2}
    assert fa.launches - n0 == 4
    b = flash_attention.causal_builder
    w = b.make_workload(b.default_config(), (2 * 2, 2 * 2, 256, 128),
                        "bfloat16")
    assert rec["hlo_walk"]["flops"] >= 2 * w.flops
    assert rec["step_s"] > 0 and rec["peak_bytes"] > 0


def test_constrain_batch_without_a_mesh_returns_its_input_on_card(
        cuda_device):
    """No mesh active: ``constrain_batch`` hands back the very tensor and
    runs nothing on the card."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import common

    x = torch.randn(4, 64, 8, 128, device=cuda_device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        y = common.constrain_batch(x, head_dim=2)
        z = common.constrain_batch(x)
        torch.cuda.synchronize()
    assert y is x and z is x
    names = [e.key for e in prof.key_averages()]
    assert not [n for n in names if n.startswith("aten::")], names
    assert all(e.device_time_total == 0 for e in prof.key_averages())
