"""DeepSeek-V2-Lite's new paths on the card: K4 at MLA's heads (q/k 192,
v 128, YaRN's softmax scale), the dropless grouped MoE dispatch, and one
traced prefill's spans and counters. Every test needs a CUDA device (an
H100) and skips without one. Run on the card with:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_dsv2_gpu.py

This file imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import _build, flash_attention, ops, ref
from repro_torch.models import build_model, mla, moe

pytestmark = pytest.mark.gpu

#: DeepSeek-V2-Lite's softmax scale: 192^-0.5 x (0.1 x 0.707 x ln 40 + 1)^2.
SCALE = mla.softmax_scale(get_arch("deepseek-v2-lite"))
#: K4 in bf16 against float32 attention on the same bf16 inputs: the
#: kernel rounds P to bf16 before P.V and its output to bf16, a few 1e-3
#: of a row's norm (the card read 1.9e-3 over the whole tensor and 3.2e-3
#: for the worst row at both shapes); 1e-2 is ``ROW_L2_TOL``'s bf16 bound.
K4_TOL = flash_attention.ROW_L2_TOL["bfloat16"]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "PYTHONPATH=src python -m pytest -m gpu "
                    "tests/test_torch_dsv2_gpu.py")
    return torch.device("cuda")


def _attention_f32(q, k, v):
    """Causal float32 attention, 8 heads at a time."""
    return torch.cat([ref.attention_ref(
        q[i:i + 8, None].float(), k[i:i + 8, None].float(),
        v[i:i + 8, None].float(), causal=True, scale=SCALE)[:, 0]
        for i in range(0, q.shape[0], 8)])


@pytest.mark.parametrize("bh,s", [(128, 2048), (16, 16384)])
def test_k4_at_mla_heads_matches_f32_attention(cuda_device, bh, s):
    """The cell's shapes: 8 x 2048 and 1 x 16384 prompts of 16 heads.
    Two launches give the same bits, and each row is within K4_TOL."""
    g = torch.Generator(device=cuda_device).manual_seed(bh + s)
    q, k = (torch.randn(bh, s, 192, device=cuda_device, generator=g)
            .bfloat16() for _ in range(2))
    v = torch.randn(bh, s, 128, device=cuda_device, generator=g).bfloat16()
    want = _attention_f32(q, k, v)
    for cfg in (flash_attention.causal_builder.default_config(),
                {"block_q": 128, "block_k": 128, "threads": 256}):
        before = flash_attention.BODY_LAUNCHES.get("wgmma", 0)
        o1 = flash_attention.launch(cfg, q, k, v, SCALE, causal=True)
        o2 = flash_attention.launch(cfg, q, k, v, SCALE, causal=True)
        torch.cuda.synchronize()
        assert flash_attention.BODY_LAUNCHES["wgmma"] == before + 2
        assert torch.equal(o1, o2)
        assert flash_attention.row_l2_error(o1, want) < K4_TOL, cfg


def test_mla_prefill_runs_k4_once_a_layer(cuda_device):
    """A 3-layer cut of deepseek-v2-lite at its widths: every MLA layer's
    attention is one K4 launch in the wgmma body, none plain."""
    cfg = dataclasses.replace(get_arch("deepseek-v2-lite"), n_layers=3)
    model = build_model(cfg, device=cuda_device)
    params = model.init(0)
    tok = torch.randint(cfg.vocab, (2, 1024), device=cuda_device)
    _build.reset_launch_counts()
    calls = []
    orig = ref.attention_ref
    ref.attention_ref = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        model.prefill(params, tok, model.init_cache(2, 1024))
    finally:
        ref.attention_ref = orig
    torch.cuda.synchronize()
    assert _build.CUDA_KERNELS["flash_attention"].launches == 3
    assert flash_attention.BODY_LAUNCHES == {"wgmma": 3}
    assert calls == []


def test_grouped_dispatch_on_the_card_matches_the_host(cuda_device):
    """The dropless MoE layer at deepseek-v2-lite's widths (64 experts of
    1408, top-6, 2 shared) on 512 tokens: the card's grouped products
    against the host's, on the same bf16 weights; the routes agree, and
    the outputs to bf16's rounding of the products."""
    cfg = get_arch("deepseek-v2-lite")
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn(1, 512, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    want, _ = moe.moe_ffn(cfg, p, x)
    pd = {k: t.to(cuda_device) for k, t in p.items()}
    got, _ = moe.moe_ffn(cfg, pd, x.to(cuda_device))
    sel_h = moe.route(cfg, p, x[0])[3]
    sel_d = moe.route(cfg, pd, x[0].to(cuda_device))[3].cpu()
    assert (sel_h.sort(-1).values != sel_d.sort(-1).values).any(-1) \
        .float().mean() < 0.01
    err = (got.cpu().float() - want.float()).norm() / want.float().norm()
    assert float(err) < 1e-2


def test_grouped_dispatch_makes_no_host_sync(cuda_device):
    """The dropless MoE layer at deepseek-v2-lite's widths reads nothing
    back to the host: under ``torch.cuda.set_sync_debug_mode("error")`` a
    synchronising call raises."""
    cfg = get_arch("deepseek-v2-lite")
    p = {k: t.to(cuda_device) for k, t in moe.init_moe(
        torch.Generator().manual_seed(0), cfg, "cpu").items()}
    x = torch.randn(1, 512, cfg.d_model, device=cuda_device).bfloat16()
    moe.moe_ffn(cfg, p, x)                       # one-time set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _ = moe.moe_ffn(cfg, p, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(y.float()).all()


def test_a_traced_prefill_has_every_span_and_counter(cuda_device):
    cfg = dataclasses.replace(get_arch("deepseek-v2-lite"), n_layers=3)
    model = build_model(cfg, device=cuda_device)
    params = model.init(0)
    tok = torch.randint(cfg.vocab, (1, 2048), device=cuda_device)
    cache = model.init_cache(1, 2048)
    moe.EXPERT_LOAD = counted = []
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            model.prefill(params, tok, cache)
            torch.cuda.synchronize()
        moe.EXPERT_LOAD = idle = []
        model.prefill(params, tok, cache)       # profiler off: no counts
    finally:
        moe.EXPERT_LOAD = None
    names = [e.name for e in prof.events()]
    for span, n in (("mla", 3), ("moe", 2), ("route", 2), ("experts", 2),
                    ("combine", 2)):
        assert names.count("repro_torch." + span) >= n, span
    load = [t.tolist() for t in counted]
    assert len(load) == 2 and all(pairs == 2048 * 6 for pairs, _ in load)
    assert all(pairs / 64 <= busiest <= 2048 for pairs, busiest in load)
    assert idle == []
    assert ops.fa_causal_kernel.tier_counts


def test_deepseek_v2_lite_is_15_7_b_parameters():
    cfg = get_arch("deepseek-v2-lite")
    assert cfg.n_params() == pytest.approx(15.7e9, rel=0.01)
