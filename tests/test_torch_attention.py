"""The port's attention (oracles, the flash kernel's plain version, the
routing of ``ops.attention``) against the JAX package's.

The same inputs, made with numpy from a seed, go to both packages. In
float32 the tolerance is the tuner's (``repro.tuner.runner._tolerances``):
rtol 1e-5 and atol 1e-5 scaled by max(1, max|ref|); the two packages sum
the same products in other orders, well inside it. In bfloat16 the
tolerance is 2e-2, after identical bf16 inputs. The CUDA kernel itself is
checked on the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import subprocess
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import args_meta as repro_args_meta
from repro.core import get_kernel as repro_kernel
from repro.kernels import ops as repro_ops
from repro.kernels import ref as repro_ref

from repro_torch.core import args_meta, get_kernel, to_torch
from repro_torch.kernels import _build, flash_attention, ops, ref

torch.set_num_threads(1)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GQA = [(4, 4), (4, 2), (8, 1)]


def _qkv(rng, b, hq, hkv, sq, sk, d, dtype="float32"):
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    return [np.asarray(jnp.asarray(a, dtype)) for a in arrays]


def _port(arrays, dtype="float32"):
    return [to_torch(a, dtype) for a in arrays]


def _assert_close(got, want, dtype="float32"):
    g = got.to(torch.float64).numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert g.shape == w.shape
    tol = TOL[dtype]
    scale = max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale)


# ------------------------------------------------------------------ oracles

CASES = [
    # causal, window, softcap, kv_offset, sq, sk
    (True, None, None, 0, 64, 64),
    (False, None, None, 0, 64, 64),
    (True, 8, None, 0, 64, 64),
    (True, None, 30.0, 0, 64, 64),
    (True, 16, 50.0, 0, 48, 48),
    (True, None, None, 16, 16, 32),
    (False, 4, None, 8, 8, 40),
]


@pytest.mark.parametrize("hq,hkv", GQA)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_naive_attention_ref_matches_repro(rng, case, hq, hkv):
    causal, window, softcap, kv_offset, sq, sk = case
    q, k, v = _qkv(rng, 2, hq, hkv, sq, sk, 32)
    kw = dict(causal=causal, window=window, softcap=softcap,
              kv_offset=kv_offset)
    want = repro_ref.attention_ref(q, k, v, **kw)
    got = ref.attention_ref(*_port([q, k, v]), **kw)
    _assert_close(got, want)


@pytest.mark.parametrize("hq,hkv", [(4, 2)])
@pytest.mark.parametrize("case", CASES[:5], ids=str)
def test_blockwise_attention_ref_matches_repro(rng, case, hq, hkv):
    """Small chunks, so the loops cross several q and k chunks and the last
    ones are ragged."""
    causal, window, softcap, kv_offset, sq, sk = case
    q, k, v = _qkv(rng, 1, hq, hkv, sq, sk, 16)
    kw = dict(causal=causal, window=window, softcap=softcap,
              kv_offset=kv_offset, q_chunk=24, k_chunk=20)
    want = repro_ref.blockwise_attention_ref(q, k, v, **kw)
    got = ref.blockwise_attention_ref(*_port([q, k, v]), **kw)
    _assert_close(got, want)


def test_attention_ref_dispatches_to_blockwise_at_the_threshold(monkeypatch):
    calls = []
    orig = ref.blockwise_attention_ref

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(ref, "blockwise_attention_ref", spy)
    t = ref.BLOCKWISE_THRESHOLD
    assert t == repro_ref.BLOCKWISE_THRESHOLD == 1024
    x = torch.zeros(1, 1, t, 8)
    ref.attention_ref(x, x, x)
    ref.attention_ref(x[:, :, :t - 1], x, x)
    assert calls == [(1, 1, t, 8)]


def test_fully_masked_rows_give_zero():
    """A window and an offset that leave row 0 with no key: 0, not NaN."""
    q = torch.randn(1, 2, 4, 8)
    k = torch.randn(1, 2, 4, 8)
    out = ref.attention_ref(q, k, k, causal=True, kv_offset=-2)
    assert torch.isfinite(out).all()
    assert torch.equal(out[:, :, :2], torch.zeros(1, 2, 2, 8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", GQA)
def test_flash_plain_version_matches_repro_oracle(rng, hq, hkv, causal,
                                                  dtype):
    """``tests/test_kernels.py``'s GQA shapes, S=256, D=128."""
    q, k, v = (a[0] for a in _qkv(rng, 1, hq, hkv, 256, 256, 128, dtype))
    want = repro_ref.flash_attention_ref_factory(causal)(q, k, v)
    b = flash_attention.causal_builder if causal else \
        flash_attention.full_builder
    args = _port([q, k, v], dtype)
    got = b.make(b.default_config(), args_meta(*args))(*args)
    assert got.dtype == args[0].dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_version_matches_pallas_interpret(rng, causal):
    """The Pallas kernel itself (interpret mode) at S=256, D=128, GQA 4/2."""
    q, k, v = (a[0] for a in _qkv(rng, 1, 4, 2, 256, 256, 128))
    name = "flash_attention_causal" if causal else "flash_attention_full"
    rb = repro_kernel(name)
    pallas = rb.make(rb.default_config(), repro_args_meta(q, k, v),
                     interpret=True)(q, k, v)
    args = _port([q, k, v])
    b = get_kernel(name)
    got = b.make(b.default_config(), args_meta(*args))(*args)
    _assert_close(got, pallas)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_probe_args_bit_identical_to_repro(causal, dtype):
    name = "flash_attention_causal" if causal else "flash_attention_full"
    problem = (8, 2, 128, 128)
    want = repro_kernel(name).make_probe_args(problem, dtype)
    got = get_kernel(name).make_probe_args(problem, dtype)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w_t = to_torch(w, dtype)
        assert g.dtype == w_t.dtype and torch.equal(g, w_t)


def test_problem_size_matches_repro():
    q = np.zeros((8, 256, 128), np.float32)
    k = np.zeros((2, 256, 128), np.float32)
    for name in ("flash_attention_causal", "flash_attention_full"):
        want = repro_kernel(name).get_problem_size(q, k, k)
        t = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k)
        assert get_kernel(name).get_problem_size(*t) == want == (8, 2, 256,
                                                                 128)


# ------------------------------------------------------------------ routing

ROUTES = [
    # (shape q, shape k, kwargs)
    ((1, 4, 128, 128), (1, 2, 128, 128), {}),
    ((2, 4, 256, 128), (2, 4, 256, 128), {"causal": False}),
    ((1, 4, 128, 128), (1, 2, 128, 128), {"window": 16}),
    ((1, 4, 128, 128), (1, 2, 128, 128), {"softcap": 50.0}),
    ((1, 4, 128, 128), (1, 2, 128, 128), {"scale": 128 ** -0.5}),
    ((1, 4, 128, 128), (1, 2, 128, 128), {"scale": 0.1}),
    ((1, 4, 128, 128), (1, 2, 256, 128), {}),
    ((1, 4, 128, 128), (1, 2, 128, 128), {"kv_offset": 4}),
    ((1, 4, 96, 128), (1, 2, 96, 128), {}),
    ((1, 4, 128, 64), (1, 2, 128, 64), {}),
    ((1, 4, 128, 256), (1, 2, 128, 256), {}),
]


@pytest.mark.parametrize("qs,ks,kw", ROUTES, ids=str)
def test_routing_predicate_matches_repro(monkeypatch, qs, ks, kw):
    """``ops.flashable`` is ``repro/kernels/ops.py:67-76`` without its
    backend terms: with those forced true (interpret backend, a TPU-kind
    device), the reference routes to its flash kernel exactly when the
    port does."""
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "interpret")
    monkeypatch.setenv("KERNEL_LAUNCHER_DEVICE", "tpu-v5e")
    q = np.zeros(qs, np.float32)
    k = np.zeros(ks, np.float32)
    kw_ref = {key: val for key, val in kw.items() if key != "causal"}
    causal = kw.get("causal", True)
    wisdom_kernel = repro_ops.fa_causal_kernel if causal else \
        repro_ops.fa_full_kernel
    hit = []
    monkeypatch.setattr(type(wisdom_kernel), "__call__",
                        lambda self, *a, **k: hit.append(self.builder.name)
                        or jnp.zeros(a[0].shape, a[0].dtype))
    monkeypatch.setattr(repro_ref, "attention_ref",
                        lambda *a, **k: jnp.zeros(a[0].shape, a[0].dtype))
    repro_ops.attention(q, k, k, causal=causal, **kw_ref)
    want = bool(hit)
    got = ops.flashable(torch.from_numpy(q), torch.from_numpy(k), **kw_ref)
    assert got == want


@pytest.mark.parametrize("causal", [True, False])
def test_ops_attention_routes_flashable_calls_through_the_kernel(
        rng, causal, monkeypatch):
    """A flashable CPU call goes through the flash WisdomKernel (and so its
    plain version); a window sends it to the full oracle instead."""
    q, k, v = _port(_qkv(rng, 2, 4, 2, 128, 128, 128))
    kernel = ops.fa_causal_kernel if causal else ops.fa_full_kernel
    n0 = len(kernel.stats)
    out = ops.attention(q, k, v, causal=causal)
    assert len(kernel.stats) == n0 + 1
    assert kernel.stats[-1].tier in ("default", "exact", "device+dtype",
                                     "device", "family+dtype", "family",
                                     "any+dtype", "any")
    want = ref.attention_ref(q, k, v, causal=causal)
    _assert_close(out, want.numpy())
    ops.attention(q, k, v, causal=causal, window=8)
    assert len(kernel.stats) == n0 + 1


@pytest.mark.parametrize("head_dim", [384, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_ops_attention_at_head_dims_the_kernel_does_not_take(rng, causal,
                                                             head_dim):
    """D 384 and 512 meet the reference's flash predicate, and K4 takes
    them (``HEAD_DIMS``): the port sends such calls through the flash
    kernel's ``WisdomKernel`` (its plain version on CPU tensors), in the
    config the card takes at that D, and returns what the reference's
    ``ops.attention`` returns (float32, the tuner's tolerance: rtol 1e-5,
    atol 1e-5 x max(1, max|ref|))."""
    assert head_dim in flash_attention.HEAD_DIMS
    q, k, v = _qkv(rng, 1, 2, 2, 128, 128, head_dim)
    want = repro_ops.attention(q, k, v, causal=causal)
    kernel = ops.fa_causal_kernel if causal else ops.fa_full_kernel
    n0 = len(kernel.stats)
    got = ops.attention(*_port([q, k, v]), causal=causal)
    assert len(kernel.stats) == n0 + 1
    assert not flash_attention.card_refusal(
        kernel.stats[-1].config, "mma", head_dim, "float32")
    _assert_close(got, want)


def test_non_cpu_tensor_never_reaches_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU never gets the plain version. On
    the meta device (shapes only, as the dry-run counts a step) the launch
    gives the output's shape and launches nothing; any other device but
    the card's raises."""
    def refuse(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(ref, "flash_attention_ref_factory", refuse)
    monkeypatch.setattr(ref, "attention_ref", refuse)
    args = [torch.zeros(4, 128, 128, device="meta"),
            torch.zeros(2, 128, 128, device="meta"),
            torch.zeros(2, 128, 128, device="meta")]
    before = flash_attention.kernel.launches
    for b in (flash_attention.causal_builder, flash_attention.full_builder):
        fn = b.make(b.default_config(), args_meta(*args))
        out = fn(*args)
        assert out.device.type == "meta" and out.shape == args[0].shape
    assert flash_attention.kernel.launches == before
    # a device neither the host's, the card's nor meta: the launch raises
    # (a stand-in, as this build of torch makes no such tensor)
    monkeypatch.setattr(flash_attention, "check_args", lambda *a: None)
    other = SimpleNamespace(device=torch.device("xpu"))
    for causal in (True, False):
        with pytest.raises(ValueError, match="CUDA tensors"):
            flash_attention.launch(flash_attention.causal_builder
                                   .default_config(), other, other, other,
                                   causal=causal)
    assert flash_attention.kernel.launches == before


def test_cpu_launch_never_invokes_the_builder(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the builder ran for a CPU tensor")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    before = flash_attention.kernel.launches
    q = torch.randn(4, 128, 128)
    k = torch.randn(2, 128, 128)
    b = flash_attention.causal_builder
    b.make(b.default_config(), args_meta(q, k, k))(q, k, k)
    assert flash_attention.kernel.launches == before


@pytest.mark.parametrize("case", ["rank", "dtype", "mixed", "noncontig",
                                  "group", "head_dim", "rows"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v = torch.randn(4, 128, 128), torch.randn(2, 128, 128), \
        torch.randn(2, 128, 128)
    if case == "rank":
        q = q[None]
    elif case == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif case == "mixed":
        k = k.to(torch.bfloat16)
    elif case == "noncontig":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "group":
        q = torch.randn(3, 128, 128)
    elif case == "head_dim":
        q, k, v = q[..., :48].contiguous(), k[..., :48].contiguous(), \
            v[..., :48].contiguous()
    else:
        k, v = k[:, :64].contiguous(), v[:, :64].contiguous()
    with pytest.raises(ValueError):
        flash_attention.launch(flash_attention.causal_builder
                               .default_config(), q, k, v, causal=True)


def _late_tile_dropped(q, k, v, block):
    """Causal attention in float32 in which the query rows of the later
    half lose their diagonal key tile: the fault the row bound is for."""
    s = q.shape[1]
    i, j = torch.arange(s)[:, None], torch.arange(s)[None]
    diag = i // block
    keep = (j <= i) & ~((diag >= s // block // 2) & (j // block == diag))
    scores = (q @ k.transpose(1, 2)) / q.shape[-1] ** 0.5
    return torch.softmax(scores.masked_fill(~keep, -1e30), -1) @ v


def test_row_l2_bound_passes_rounding_and_rejects_a_late_row_fault(rng):
    """bf16 rounding of the output stays inside ROW_L2_TOL, a dropped key
    tile in late rows does not, and a row the reference leaves at 0 counts
    any error in full."""
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 512, 128),
                                                    dtype=np.float32))
               for _ in range(3))
    want = ref.flash_attention_ref_factory(True)(q, k, v)
    tol = flash_attention.ROW_L2_TOL["bfloat16"]
    assert flash_attention.row_l2_error(want.to(torch.bfloat16), want) < \
        tol / 2
    bad = _late_tile_dropped(q, k, v, 64)
    torch.testing.assert_close(bad[:, :256], want[:, :256], rtol=1e-5,
                               atol=1e-5)   # early rows untouched
    assert flash_attention.row_l2_error(bad, want) > 10 * tol
    zero = torch.zeros(1, 1, 128)
    assert flash_attention.row_l2_error(zero + 1e-3, zero) == \
        pytest.approx(128 ** 0.5 * 1e-3)


def test_build_command_targets_sm_90a():
    b = flash_attention.causal_builder
    d = flash_attention.defines(b.default_config(), True, 128, "wgmma")
    assert dict(d) == {"BLOCK_Q": 64, "BLOCK_K": 64, "THREADS": 128,
                       "CAUSAL": 1, "HEAD_DIM": 128, "WGMMA": 1}
    out = _build.library_path("flash_attention.cu", d)
    cmd = _build.nvcc_command("flash_attention.cu", d, out)
    assert "arch=compute_90a,code=sm_90a" in cmd
    for flag in ("-DBLOCK_Q=64", "-DCAUSAL=1", "-DHEAD_DIM=128",
                 "-DWGMMA=1", "-O3"):
        assert flag in cmd
    full = flash_attention.defines(b.default_config(), False, 128, "wgmma")
    mma = flash_attention.defines(b.default_config(), True, 128, "mma")
    assert dict(mma)["WGMMA"] == 0
    assert len({_build.library_path("flash_attention.cu", x)
                for x in (d, full, mma)}) == 3
    assert (_build.CSRC / "flash_attention.cu").exists()


def test_space_fits_the_h100():
    """Every config the space admits fits a block's shared memory at
    D=128 in the body each dtype selects, and gives each warp 16 or 32
    query rows; four configs run the wgmma body in bfloat16 (the default
    among them) and none in float32; both builders share the space, and
    one CUDA kernel counts their launches."""
    from repro_torch.core.device import GPU_H100
    for b in (flash_attention.causal_builder, flash_attention.full_builder):
        configs = list(b.space.enumerate())
        assert len(configs) == 15
        assert b.space.is_valid(b.default_config())
        for dtype, n_wgmma in (("float32", 0), ("bfloat16", 4)):
            bodies = [flash_attention.choose_body(dtype, 128, cfg)
                      for cfg in configs]
            assert bodies.count("wgmma") == n_wgmma
            assert bodies.count("mma") == 15 - n_wgmma
            for cfg, body in zip(configs, bodies):
                assert flash_attention.smem_bytes(cfg, body, 128, dtype) <= \
                    GPU_H100.smem_per_block
        assert flash_attention.choose_body(
            "bfloat16", 128, b.default_config()) == "wgmma"
        for cfg in configs:
            assert cfg["block_q"] * 32 // cfg["threads"] in (16, 32)
    assert _build.CUDA_KERNELS["flash_attention"] is flash_attention.kernel


_WGMMA_CONFIGS = {(64, 64, 128), (64, 128, 128), (128, 64, 256),
                  (128, 128, 256)}


@pytest.mark.parametrize("head_dim", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_choose_body_over_the_space(dtype, head_dim):
    """wgmma exactly for bfloat16 at D=128 with one of the four
    whole-warpgroup configs; mma for every other launch. Written out as
    the rule's table, not as the rule."""
    for cfg in flash_attention.causal_builder.space.enumerate():
        key = (cfg["block_q"], cfg["block_k"], cfg["threads"])
        want = ("wgmma" if dtype == "bfloat16" and head_dim == 128
                and key in _WGMMA_CONFIGS else "mma")
        assert flash_attention.choose_body(dtype, head_dim, cfg) == want, key


@pytest.mark.parametrize("head_dim", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smem_of_the_selected_body_fits_a_block(dtype, head_dim):
    """Every config in the body it selects, and the wgmma body's byte
    count (alignment slack, Q, two stages of K and V, five mbarriers):
    under 227 KB wherever the body runs, except mma in float32 at D=256,
    where the card's refusal is what the wrapper reports."""
    from repro_torch.core.device import GPU_H100
    for cfg in flash_attention.causal_builder.space.enumerate():
        body = flash_attention.choose_body(dtype, head_dim, cfg)
        smem = flash_attention.smem_bytes(cfg, body, head_dim, dtype)
        refusal = flash_attention.card_refusal(cfg, body, head_dim, dtype)
        assert bool(refusal) == (smem > GPU_H100.smem_per_block)
        if body == "wgmma":
            bq, bk = cfg["block_q"], cfg["block_k"]
            assert smem == 1024 + (bq + 4 * bk) * 256 + 40 <= 232448
        elif dtype == "bfloat16" or head_dim == 128:
            assert not refusal, (cfg, refusal)
    worst = {"block_q": 128, "block_k": 128, "threads": 256}
    assert flash_attention.smem_bytes(worst, "wgmma", 128, "bfloat16") == \
        1024 + 32768 + 2 * 65536 + 40


@pytest.mark.parametrize("key", sorted(_WGMMA_CONFIGS))
def test_wgmma_configs_build_the_wgmma_body_at_the_slice(key):
    """Each whole-warpgroup config (the default among them) at the LM
    slice's D=128 in bfloat16 selects wgmma, whose build carries WGMMA=1
    and whose block holds the slack, Q, a two-stage K/V ring and five
    mbarriers; in float32 or at D=256 it selects mma and builds WGMMA=0."""
    bq, bk, threads = key
    cfg = {"block_q": bq, "block_k": bk, "threads": threads}
    assert flash_attention.causal_builder.space.is_valid(cfg)
    body = flash_attention.choose_body("bfloat16", 128, cfg)
    assert body == "wgmma"
    assert dict(flash_attention.defines(cfg, True, 128, body))["WGMMA"] == 1
    assert flash_attention.smem_bytes(cfg, body, 128, "bfloat16") == \
        1024 + (bq + 2 * flash_attention.WGMMA_STAGES * bk) * 256 + 40
    assert flash_attention.card_refusal(cfg, body, 128, "bfloat16") == ""
    for dtype, d in (("float32", 128), ("bfloat16", 256)):
        body = flash_attention.choose_body(dtype, d, cfg)
        assert body == "mma"
        assert dict(flash_attention.defines(cfg, True, d, body))["WGMMA"] == 0


def test_body_launch_counts_reset_with_the_launch_counts(monkeypatch):
    """A launch that names its body counts there, under (body, dtype)
    and in ``launches``; ``reset_launch_counts`` zeroes all three, and
    BODY_LAUNCHES is the kernel's own dict, so it sees the reset."""
    kern = flash_attention.kernel
    monkeypatch.setattr(kern, "entry", lambda defines: lambda *a: 0)
    before = kern.launches
    by = dict(kern.body_dtype_launches)
    kern((), "bfloat16", body="wgmma")
    kern((), "bfloat16", body="wgmma")
    kern((), "float32", body="mma")
    assert kern.launches == before + 3
    assert flash_attention.BODY_LAUNCHES["wgmma"] >= 2
    assert flash_attention.BODY_LAUNCHES is kern.body_launches
    assert kern.body_dtype_launches[("wgmma", "bfloat16")] == by.get(
        ("wgmma", "bfloat16"), 0) + 2
    assert kern.body_dtype_launches[("mma", "float32")] == by.get(
        ("mma", "float32"), 0) + 1
    _build.reset_launch_counts()
    assert kern.launches == 0 and flash_attention.BODY_LAUNCHES == {}
    assert kern.body_dtype_launches == {}


def test_port_sources_import_neither_jax_nor_repro():
    """A grep over the port's sources, chip_smoke.py and
    chip_fault_check.py: no import of
    jax, jaxlib or the JAX package (``repro``; ``repro_torch`` is fine)."""
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)\b(?!_)",
                         re.MULTILINE)
    files = [*sorted((root / "src" / "repro_torch").rglob("*.py")),
             root / "chip_smoke.py", root / "chip_fault_check.py"]
    assert len(files) > 30
    hits = [f"{f.relative_to(root)}: {m.group(0).strip()}" for f in files
            for m in pattern.finditer(f.read_text())]
    assert not hits, hits
