"""DeepSeek-V2-Lite on the host: the port's MLA with one ``wq`` and YaRN,
its dropless MoE and K4's plain version at MLA's heads, held to the plain
reference ``klbench/reference/deepseek_v2.py`` on seeded random weights.

The model is ``klbench.loops.prefill_mla_moe.REHEARSAL``: 1 dense + 2 MoE
layers at d 256, 8 routed experts of 64, top-2, 1 shared; kv_lora 64,
nope 32, rope 16, v 32; YaRN over 64 original positions, so the ramp
bites at these lengths. The port runs it in float32 on the seeded bf16
values, so the reference's float32 agrees to float32's rounding.
"""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from klbench.loops.prefill_mla_moe import REHEARSAL, arch_config
from klbench.reference import deepseek_v2 as R
from klbench.weights_mla_moe import params as dsv2_params
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention, ops
from repro_torch.models import build_model, common, mla, moe

SEED = 2**31 + 77
#: float32 against float32 through different orders of summation (the
#: expanded latent, the blocked softmax, grouped against looped experts).
TOL = 2e-4


def _f32_model(c=REHEARSAL):
    cfg = dataclasses.replace(arch_config(c), param_dtype="float32",
                              compute_dtype="float32")
    params = dsv2_params(c, SEED, "cpu")
    return (build_model(cfg, device="cpu"), params,
            tree.tree_map(lambda t: t.to(torch.float32), params))


def _rel(got, want) -> float:
    got = got.to(torch.float64)
    want = want.to(torch.float64)
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("shape", [(2, 128), (1, 200)])
def test_prefill_logits_and_latents_match_the_reference(shape):
    model, params, p32 = _f32_model()
    tok = torch.randint(REHEARSAL["vocab_size"], shape,
                        generator=torch.Generator().manual_seed(1))
    cache = model.init_cache(*shape)
    logits, cache = model.prefill(p32, tok, cache)
    lat = {}
    want = R.prefill(REHEARSAL, params, tok,
                     on_latent=lambda i, c, k: lat.__setitem__(i, (c, k)))
    assert _rel(logits[:, -1], want) < TOL
    for i, (c_kv, k_pe) in lat.items():
        m, j = (cache["mla_dense"], i) if i == 0 else (cache["mla"], i - 1)
        assert _rel(m["c_kv"][j], c_kv) < TOL, i
        assert _rel(m["k_pe"][j], k_pe) < TOL, i


def test_prefill_then_decode_matches_the_references_full_forward():
    """Prefill 120 tokens, then 8 absorbed decode steps through the latent
    cache: each step's logits against the reference's forward over every
    token so far, compared on logits."""
    model, params, p32 = _f32_model()
    tok = torch.randint(REHEARSAL["vocab_size"], (2, 128),
                        generator=torch.Generator().manual_seed(2))
    cache = model.init_cache(2, 128)
    logits, cache = model.prefill(p32, tok[:, :120], cache)
    assert _rel(logits[:, -1], R.prefill(REHEARSAL, params,
                                         tok[:, :120])) < TOL
    for pos in range(120, 128):
        logits, cache = model.decode_step(p32, cache, tok[:, pos:pos + 1])
        want = R.prefill(REHEARSAL, params, tok[:, :pos + 1])
        assert _rel(logits[:, -1], want) < TOL, pos


def _per_token_moe(cfg, p, x):
    """Each token through its own top-k experts, one at a time."""
    e = cfg.moe
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        probs = torch.softmax(x[t] @ p["router"], -1)
        gate, idx = torch.topk(probs, e.top_k)
        if e.norm_topk_prob:
            gate = gate / gate.sum()
        for g, i in zip(gate, idx):
            h = x[t] @ p["w_in"][i]
            out[t] += g * ((torch.nn.functional.silu(x[t] @ p["w_gate"][i])
                            * h) @ p["w_out"][i])
        out[t] += (torch.nn.functional.silu(x[t] @ p["shared_gate"])
                   * (x[t] @ p["shared_in"])) @ p["shared_out"]
    return out


@pytest.mark.parametrize("skew", ["seeded", "one_expert"])
def test_dropless_dispatch_matches_a_per_token_loop(skew):
    """Every (token, choice) pair reaches its expert, whatever the load:
    with the router drawn from the seed, and with a router that sends
    every token to expert 3 (and one other), whose load is then all the
    tokens."""
    cfg = dataclasses.replace(arch_config(REHEARSAL),
                              param_dtype="float32", compute_dtype="float32")
    p = moe.init_moe(torch.Generator().manual_seed(3), cfg, "cpu")
    if skew == "one_expert":
        p["router"][:, 3] = 0.0
        p["router"][0, 3] = 50.0
    x = torch.randn(1, 96, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    if skew == "one_expert":
        x[..., 0] = x[..., 0].abs() + 1.0
    moe.EXPERT_LOAD = []
    try:
        y, aux = moe.moe_ffn(cfg, p, x)
        assert moe.EXPERT_LOAD == []        # spans off: nothing counted
    finally:
        moe.EXPERT_LOAD = None
    assert _rel(y[0], _per_token_moe(cfg, p, x[0])) < 1e-5
    assert set(aux) == {"moe_load_balance", "moe_z_loss"}
    sel = moe.route(cfg, p, x[0])[3]
    if skew == "one_expert":
        assert bool((sel == 3).any(-1).all())


def test_dropless_counts_pairs_while_spans_are_on():
    cfg = arch_config(REHEARSAL)
    p = moe.init_moe(torch.Generator().manual_seed(5), cfg, "cpu")
    x = torch.randn(2, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(6)).bfloat16()
    moe.EXPERT_LOAD = load = []
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            moe.moe_ffn(cfg, p, x)
    finally:
        moe.EXPERT_LOAD = None
    names = {e.name for e in prof.events()}
    assert {"repro_torch.moe", "repro_torch.route", "repro_torch.experts",
            "repro_torch.combine"} <= names
    (pairs, busiest), = [t.tolist() for t in load]
    sel = moe.route(cfg, p, x.reshape(-1, cfg.d_model))[3]
    assert pairs == 2 * 64 * 2
    assert busiest == int(torch.bincount(sel.reshape(-1)).max())


def test_dropless_counts_nothing_without_a_reader():
    """Spans on but no list in ``EXPERT_LOAD``: a traced process that never
    reads the counter keeps nothing, however many calls it makes."""
    cfg = arch_config(REHEARSAL)
    p = moe.init_moe(torch.Generator().manual_seed(5), cfg, "cpu")
    x = torch.randn(1, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(6)).bfloat16()
    assert moe.EXPERT_LOAD is None
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            moe.moe_ffn(cfg, p, x)
    assert moe.EXPERT_LOAD is None


def test_yarn_frequencies_and_scale_follow_their_formulas():
    cfg = get_arch("deepseek-v2-lite")
    y = cfg.yarn
    d = cfg.mla.d_rope
    # correction range: floor/ceil of d log(L / (2 pi r)) / (2 log theta)
    def dim(r):
        return d * math.log(4096 / (r * 2 * math.pi)) / (2 * math.log(1e4))
    low, high = math.floor(dim(32)), math.ceil(dim(1))
    assert common.yarn_correction_range(y, d, 1e4) == (low, high) == (10, 23)
    freqs = common.rope_freqs(d, 1e4, yarn=y)
    for i in range(d // 2):
        plain = 1e4 ** (-2 * i / d)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want = plain / 40 * ramp + plain * (1 - ramp)
        assert float(freqs[i]) == pytest.approx(want, rel=1e-6)
    assert torch.allclose(freqs, R.yarn_inv_freq(
        {"rope_theta": 1e4, "rope_scaling": {
            "factor": 40, "original_max_position_embeddings": 4096,
            "beta_fast": 32, "beta_slow": 1}}, d))
    scale = 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2
    assert mla.softmax_scale(cfg) == pytest.approx(scale, rel=1e-12)
    assert scale == pytest.approx(0.114721, abs=1e-6)
    assert common.yarn_mscale(1.0, 0.707) == 1.0
    # no YaRN: the plain frequencies and (nope + rope)^-0.5
    v2 = get_arch("deepseek-v2-236b")
    assert mla.softmax_scale(v2) == 192 ** -0.5
    assert torch.equal(common.rope_freqs(d, 1e4), 1.0 / 1e4 ** (
        torch.arange(0, d, 2, dtype=torch.float32) / d))


def test_k4_plain_version_at_192_and_128_with_a_scale():
    """K4's plain version (what the CPU runs in ``launch``) at MLA's heads,
    against the softmax written out; ``ops.attention`` sends the call
    there, and the problem keeps the v head dim as its fifth entry."""
    g = torch.Generator().manual_seed(7)
    q, k = (torch.randn(6, 128, 192, generator=g) for _ in range(2))
    v = torch.randn(6, 128, 128, generator=g)
    scale = 0.11473
    got = flash_attention.launch({"block_q": 64, "block_k": 64,
                                  "threads": 128}, q, k, v, scale,
                                 causal=True)
    s = torch.einsum("bqd,bkd->bqk", q.double(), k.double()) * scale
    s = s.masked_fill(torch.ones(128, 128, dtype=torch.bool).triu(1),
                      float("-inf"))
    want = torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), v.double())
    assert got.shape == (6, 128, 128) and _rel(got, want) < 1e-5
    o = ops.attention(q.view(2, 3, 128, 192), k.view(2, 3, 128, 192),
                      v.view(2, 3, 128, 128), causal=True, scale=scale)
    assert _rel(o.reshape(6, 128, 128), want) < 1e-5
    assert ops.flashable(q[None], k[None], scale=scale, v=v[None])
    assert not ops.flashable(q[None], k[None], scale=scale)
    assert flash_attention.causal_builder.get_problem_size(q, k, v) == \
        (6, 6, 128, 192, 128)
    assert flash_attention.causal_builder.get_problem_size(
        q[..., :128], k[..., :128], v) == (6, 6, 128, 128)
    w = flash_attention.causal_builder.make_workload(
        {"block_q": 64, "block_k": 64, "threads": 128}, (6, 6, 128, 192, 128),
        "bfloat16")
    assert w.valid and w.flops == 2.0 * 6 * 320 * 128 * 129 / 2
    assert w.hbm_bytes == 2 * 6 * 128 * 320 * 2


def test_k4_picks_wgmma_at_mla_heads_and_keeps_d128_defines():
    cfg = {"block_q": 64, "block_k": 64, "threads": 128}
    assert flash_attention.choose_body("bfloat16", 192, cfg, 128) == "wgmma"
    assert flash_attention.choose_body("float32", 192, cfg, 128) == "mma"
    assert "V_DIM" in dict(flash_attention.defines(cfg, True, 192, "wgmma",
                                                   128))
    assert flash_attention.defines(cfg, True, 128, "wgmma", 128) == \
        flash_attention.defines(cfg, True, 128, "wgmma")
    big = {"block_q": 128, "block_k": 128, "threads": 256}
    assert not flash_attention.card_refusal(big, "wgmma", 192, "bfloat16",
                                            128)
    assert flash_attention.smem_bytes(big, "wgmma", 192, "bfloat16", 128) \
        == 1024 + (128 * 192 + 2 * 128 * 320) * 2 + 5 * 8


def test_deepseek_v2_lite_has_its_published_size():
    """15.7 B parameters (31.4 GB in bf16); the meta model's elements
    are ``n_params`` plus the norm scales it leaves out."""
    cfg = get_arch("deepseek-v2-lite")
    assert cfg.n_params() == pytest.approx(15.7e9, rel=0.01)
    params = build_model(cfg, device="meta").init()
    leaves = tree.leaves(params)
    assert len(params["dense_prefix"]) == 1 and len(params["layers"]) == 26
    assert "wq" in params["layers"][0]["mla"]
    assert tuple(params["layers"][0]["mla"]["wq"].shape) == (2048, 16 * 192)
    norms = cfg.n_layers * cfg.mla.kv_lora
    assert sum(t.numel() for t in leaves) == cfg.n_params() + norms
