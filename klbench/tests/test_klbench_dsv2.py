"""The ``deepseek-v2-lite.prefill-16k`` cell on the host: its loop at the
rehearsal size (``prefill_mla_moe.REHEARSAL``), the planted faults of
``control_dsv2.py`` failing its checks, its frozen counts against the
program's hooks, and its readers on synthetic traces."""

import json

import pytest

from klbench import harness
from klbench.counts import mla_moe
from klbench.loops import prefill_mla_moe as L
from klbench.trace import TraceView
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as fa

ROOT = harness.KLBENCH.parent
BENCH = harness.benchmark(ROOT)
CELL = "deepseek-v2-lite.prefill-16k"
SEED = 2**31 + 23
#: The check each planted fault must fail, by at least its limit.
CAUGHT_BY = {"fp8": "moe_rows_off", "renorm": "moe_rows_off",
             "plain_rope": "latent_rel_l2", "capacity": "moe_rows_off"}


def config():
    return json.loads((ROOT / "klbench/configs/deepseek-v2-lite.json")
                      .read_text())


@pytest.fixture(scope="module")
def measured():
    """One rehearsal run, measured and released, its check not yet run."""
    run = harness.make_run(ROOT, CELL, SEED, 0.3, False, "cpu", 0.0)
    loop, result = harness.measure(run, {})
    return loop, result


def test_a_sound_rehearsal_is_correct(measured):
    loop, result = measured
    checks = loop.check()
    assert all(c.ok for c in checks), [(c.name, c.value) for c in checks]
    assert [c.name for c in checks] == ["latent_rel_l2", "logits_rel_l2",
                                        "top_logit_gap", "moe_rows_off"]
    assert set(result["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("variant", sorted(CAUGHT_BY))
def test_each_planted_fault_fails_its_check(measured, variant):
    loop, _ = measured
    checks = {c.name: c for c in loop.check(variant)}
    caught = checks[CAUGHT_BY[variant]]
    assert not caught.ok and caught.value > caught.limit


def test_the_cells_config_is_the_programs_deepseek_v2_lite():
    cfg = L.arch_config(config())
    want = get_arch("deepseek-v2-lite")
    assert cfg.mla == want.mla and cfg.moe == want.moe
    assert cfg.yarn == want.yarn and cfg.n_params() == want.n_params()
    assert L.arch_config(config(), capacity_factor=1.25).moe \
        .capacity_factor == 1.25


@pytest.mark.parametrize("b,s", [(8, 2048), (4, 4096), (1, 16384)])
def test_k4_counts_are_the_hook_at_mla_heads(b, s):
    c = config()
    w = fa.causal_builder.make_workload(
        fa.causal_builder.default_config(), (16 * b, 16 * b, s, 192, 128),
        "bfloat16")
    assert mla_moe.k4(16 * b, s, c) == (w.flops, w.hbm_bytes)


def test_prefill_flops_are_the_active_parameters_and_attention():
    c = config()
    cfg = get_arch("deepseek-v2-lite")
    tokens = 16384
    # the active parameters less the embedding, the head and the norms'
    # scales (2 d a layer, d at the end): each a product of every token
    mm = (cfg.n_active_params() - 2 * cfg.d_model * cfg.vocab
          - 27 * 2 * cfg.d_model - cfg.d_model)
    attn = 27 * mla_moe.k4(16, tokens, c)[0]
    head = 2.0 * cfg.d_model * cfg.vocab          # the last position only
    assert mla_moe.prefill_flops(c, 1, tokens) == pytest.approx(
        2.0 * tokens * mm + attn + head, rel=1e-12)
    flops, nbytes = mla_moe.experts(c, tokens)
    assert flops == 2.0 * tokens * 6 * 3 * 2048 * 1408
    assert nbytes == (64 * 3 * 2048 * 1408 + 2 * tokens * 6 * 2048) * 2


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def readers():
    return {n: r for n, (r, _) in harness.metric_readers(BENCH, CELL).items()}


def test_the_cells_readers_read_its_spans_and_nothing_without_them():
    listed = {m["name"]: m["workloads"] for m in BENCH["per_layer"]}
    names = ["moe_share.dsv2", "mla_share.dsv2", "experts_roofline.dsv2",
             "k4_roofline.dsv2", "prefill_mfu.dsv2", "expert_load_max.dsv2"]
    assert set(readers()) == set(names) | {"idle_share.prefill"}
    assert all(listed[n] == [CELL] for n in names)
    assert CELL in listed["idle_share.prefill"]
    c = config()
    c["num_hidden_layers"], c["first_k_dense_replace"] = 2, 1
    window = ev("user_annotation", "klbench.window", 0.0, 1000.0)
    call = ev("user_annotation", "klbench.prefill", 0.0, 900.0)
    bare = TraceView.from_events([
        window, call, ev("cuda_runtime", "cudaLaunchKernel", 10, 3, corr=1),
        ev("kernel", "k", 20, 100, tid=7, corr=1)])
    ctx = {"config": c, "calls": [(1, 16384)], "expert_load": [],
           "n_experts": 64}
    rs = readers()
    for n in ("moe_share.dsv2", "mla_share.dsv2", "experts_roofline.dsv2",
              "k4_roofline.dsv2", "expert_load_max.dsv2"):
        assert rs[n](bare, ctx) is None, n
    spans = TraceView.from_events([
        window, call,
        ev("user_annotation", "repro_torch.mla", 10, 100),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 3, corr=1),
        ev("kernel", "fa_wgmma_kernel", 30, 200, tid=7, corr=1),
        ev("user_annotation", "repro_torch.moe", 200, 500),
        ev("user_annotation", "repro_torch.experts", 300, 300),
        ev("cuda_runtime", "cudaLaunchKernel", 310, 3, corr=2),
        ev("kernel", "grouped_gemm", 320, 400, tid=7, corr=2)])
    busy = 600.0
    assert rs["mla_share.dsv2"](spans, ctx) == pytest.approx(100 * 200 / busy)
    assert rs["moe_share.dsv2"](spans, ctx) == pytest.approx(100 * 400 / busy)
    from klbench.counts import peaks
    want = peaks.bound_s(*mla_moe.experts(c, 16384), "bfloat16") / 400e-6
    assert rs["experts_roofline.dsv2"](spans, ctx) == pytest.approx(
        100 * want)
    want = 2 * peaks.bound_s(*mla_moe.k4(16, 16384, c), "bfloat16") / 200e-6
    assert rs["k4_roofline.dsv2"](spans, ctx) == pytest.approx(100 * want)
    assert rs["idle_share.prefill"](spans, ctx) == pytest.approx(
        100 * (1 - busy / 1000))
    ctx["expert_load"] = [[98304, 3072], [98304, 1536]]
    assert rs["expert_load_max.dsv2"](bare, ctx) == pytest.approx(1.5)
