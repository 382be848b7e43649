"""The port's roofline (``repro_torch.roofline``: the analysis, the op
counter, the report) against the JAX package's (``repro.roofline``).

``roofline_report`` and ``model_flops`` keep the reference's arithmetic:
given the reference's ``HW`` values the report is the reference's dict,
exactly. The report tables are the same text from the same records. The
op counter is the counterpart of the reference's HLO walker: the walker's
own invariants (a repeated body counts as many times as it runs; nested
trip counts multiply) hold for it, its folded loops equal the full count,
and a reduced stablelm train step counts within the reference's bound of
``model_flops`` and within 25 % of the walker's count of the reference's
compiled step (the walker counts XLA's fused program, the counter the
eager ops). Collectives are counted on a fake 2x2 mesh; a kernel launch
on ``meta`` tensors adds its workload hook's flops and bytes.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as repro_arch
from repro.launch import sharding as ref_sh
from repro.models import build_model as repro_build
from repro.optim import AdamW as RefAdamW
from repro.roofline import HW as RefHW
from repro.roofline import model_flops as ref_model_flops
from repro.roofline import report as ref_report
from repro.roofline import roofline_report as ref_roofline_report
from repro.roofline.hlo_parse import hlo_cost_analysis
from repro.train import init_train_state as ref_init_train_state
from repro.train import make_train_step as ref_make_train_step

from repro_torch.configs import get_arch, list_archs
from repro_torch.core.device import GPU_H100
from repro_torch.kernels import flash_attention, ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.roofline import HW, model_flops, report, roofline_report
from repro_torch.core import trip_count
from repro_torch.core.trip_count import loop
from repro_torch.roofline.op_count import (FoldOnRealData, OpCounter,
                                           op_cost_analysis)
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(1)


# --------------------------------------------------------------- analysis ----

def test_hw_defaults_are_the_h100s():
    hw = HW()
    assert (hw.peak_flops_bf16, hw.peak_flops_f32, hw.hbm_bw, hw.ici_bw) \
        == (GPU_H100.flops_bf16, GPU_H100.flops_f32, GPU_H100.hbm_bw,
            GPU_H100.ici_bw)
    assert hw.hbm_bytes == 80 * 10**9


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_roofline_report_is_the_references_on_its_hw(kind, dtype):
    ref_hw = RefHW()
    hw = HW(**dataclasses.asdict(ref_hw))
    for arch in list_archs():
        kw = dict(flops_per_chip=1.97e14, bytes_per_chip=8.19e11,
                  collective_per_chip={"total": 5e10, "all-gather": 5e10},
                  chips=256, kind=kind, global_batch=256, seq=4096,
                  dtype=dtype)
        assert roofline_report(cfg=get_arch(arch), hw=hw, **kw) \
            == ref_roofline_report(cfg=repro_arch(arch), hw=ref_hw, **kw)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_match_the_reference(kind):
    for arch in list_archs():
        assert model_flops(get_arch(arch), kind, 128, 32768) \
            == ref_model_flops(repro_arch(arch), kind, 128, 32768)


# ----------------------------------------------------------------- report ----

def _records() -> list[dict]:
    roof = {"compute_s": 1.5, "memory_s": 2e-3, "collective_s": 4e-6,
            "dominant": "compute", "model_flops": 3.2e15,
            "useful_flops_ratio": 0.41, "roofline_fraction": 0.2734}
    ok = {"arch": "codeqwen1.5-7b", "shape": "train_4k", "status": "ok",
          "mesh_tag": "singlepod", "compile_s": 0.0,
          "hlo_walk": {"flops": 1.234e15, "bytes_fused": 5.6e12,
                       "bytes_upper": 5.6e12},
          "collective_bytes": {"total": 7.8e10},
          "memory_analysis": {"temp_bytes": 3 * 2**30},
          "roofline": roof}
    return [
        ok,
        {**ok, "shape": "prefill_32k", "memory_analysis": {"temp_bytes": None},
         "roofline": {**roof, "dominant": "memory"}},
        {**ok, "mesh_tag": "multipod", "compile_s": 12.4},
        {"arch": "gemma2-2b", "shape": "long_500k", "status": "skipped",
         "reason": "quadratic", "mesh_tag": "singlepod"},
        {"arch": "rwkv6-7b", "shape": "prefill_32k", "status": "unfinished",
         "error": "counting ran past 600 s", "mesh_tag": "singlepod"},
        {"arch": "hymba-1.5b", "shape": "train_4k", "status": "error",
         "error": "RuntimeError: x", "mesh_tag": "multipod"},
    ]


def test_report_tables_are_the_references_text(tmp_path):
    recs = _records()
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    loaded = report.load_records(tmp_path)
    assert loaded == ref_report.load_records(tmp_path) == recs
    for tag in ("singlepod", "multipod"):
        assert report.dryrun_table(loaded, tag) \
            == ref_report.dryrun_table(loaded, tag)
        assert report.roofline_table(loaded, tag) \
            == ref_report.roofline_table(loaded, tag)
    assert "**unfinished**" in report.dryrun_table(loaded, "singlepod")
    for x in (3.0, 2.5e-2, 7e-5):
        assert report._fmt_s(x) == ref_report._fmt_s(x)


# ------------------------------------------------------------- op counter ----

def _tanh_mm(a, n: int):
    for _ in range(n):
        a = torch.tanh(a @ a)
    return a


def test_repeated_body_counts_each_time():
    """The walker's scan invariant: 6 applications of tanh(a @ a) count
    6 x one application, and a folded loop of 6 counts the same."""
    a = torch.randn(128, 128)
    one = op_cost_analysis(_tanh_mm, a, 1)
    six = op_cost_analysis(_tanh_mm, a, 6)
    assert one["flops"] == 2 * 128**3 + 128 * 128
    assert six["flops"] == 6 * one["flops"]
    assert six["bytes"] == 6 * one["bytes"] == six["bytes_upper"]
    x = a.to("meta")             # folding counts meta tensors only
    with OpCounter(fold_loops=True) as c:
        for _ in loop(6):
            x = torch.tanh(x @ x)
    assert c.result() == six


def test_nested_trip_counts_multiply():
    """The walker's nested-scan case: a 4 x 3 loop of (64, 64) products
    counts 12 x 2 x 64^3, folded or not."""
    a = torch.empty(64, 64, device="meta")

    def nested(fold_loops):
        with OpCounter(fold_loops=fold_loops) as c:
            x = a
            for _ in loop(4):
                for _ in loop(3):
                    x = x @ x
        return c.result()

    full, folded = nested(False), nested(True)
    assert full == folded
    assert full["flops"] == pytest.approx(12 * 2 * 64**3, rel=0.05)


@pytest.mark.parametrize("device", ["cpu", "factory"])
def test_a_folding_counter_refuses_real_tensors(device):
    """A folded loop runs 1/n of its work (a folded microbatch loop would
    update from one microbatch), so folding takes meta tensors only: a
    real tensor, an input or one an op makes, raises before the loop
    could run short."""
    a = torch.randn(8, 8)
    with pytest.raises(FoldOnRealData, match="meta tensors only"):
        with OpCounter(fold_loops=True):
            for _ in loop(2):
                if device == "cpu":
                    a @ a
                else:
                    torch.zeros(3)
    assert not trip_count.FOLDING
    assert list(loop(3)) == [0, 1, 2]        # no counter: every iteration


def test_collectives_are_counted_on_a_fake_mesh():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    try:
        mesh = mesh_mod.make_fake_mesh((2, 2), ("data", "model"))
        x = DTensor.from_local(torch.empty(4, 64, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(32, 32, device="meta"), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        with OpCounter() as c:
            y = (x @ w).redistribute(mesh, [Shard(0), Replicate()])
        r = c.result()
        # local product (4, 64) @ (64, 32) after gathering w's rows
        assert r["flops"] == 2 * 4 * 64 * 32
        assert r["collectives"]["all-gather"] > 0
        assert r["collectives"]["total"] == sum(
            v for k, v in r["collectives"].items() if k != "total")
        assert y.to_local().shape == (4, 64)
    finally:
        mesh_mod.release()


def test_a_kernel_launch_on_meta_adds_its_workload():
    """On ``meta`` the flash launch computes nothing; the counter adds its
    workload hook's flops and bytes. On CPU the plain version's ops are
    counted instead, and no hook fires."""
    bh, s, d = 4, 256, 128
    q, k, v = (torch.empty(1, bh, s, d, device="meta") for _ in range(3))
    with OpCounter() as c:
        out = ops.attention(q, k, v, causal=True)
    assert out.shape == (1, bh, s, d) and out.device.type == "meta"
    w = flash_attention.causal_builder.make_workload(
        ops.fa_causal_kernel.builder.default_config(), (bh, bh, s, d),
        "float32")
    assert c.launches == {"flash_attention_causal": 1}
    assert c.flops == w.flops and c.bytes >= w.hbm_bytes
    qc, kc, vc = (torch.randn(1, bh, s, d) for _ in range(3))
    with OpCounter() as c:
        ops.attention(qc, kc, vc, causal=True)
    assert not c.launches and c.flops >= 2 * w.flops


def test_a_meta_stand_in_is_no_launch(wisdom_dir):
    """A kernel called on ``meta`` gives its output's shape and tells the
    observers its workload, and nothing a real launch records changes:
    the kernel's stats and tier tallies, ``launch.count``, the trace, the
    profiler and the online tuner see nothing."""
    from repro_torch.core import WisdomKernel
    from repro_torch.obs import runtime

    class Refuse:
        def __getattr__(self, name):
            raise AssertionError(f"{name} was called for a meta call")

    k = WisdomKernel(flash_attention.causal_builder, wisdom_dir=wisdom_dir,
                     device_kind="gpu-h100")
    k.online, k.profiler = Refuse(), Refuse()
    q = torch.empty(4, 256, 128, device="meta")
    reg, tr = runtime.enable()
    try:
        with OpCounter() as c:
            out = k(q, q, q)
        snap = reg.snapshot()
    finally:
        runtime.disable()
    assert out.shape == q.shape and out.device.type == "meta"
    assert c.launches == {"flash_attention_causal": 1}
    assert k.stats == [] and k.tier_counts == {}
    assert not any(s.startswith("launch.count") for s in snap["counters"])
    assert not [ev for ev in tr.events if ev["name"] == "launch"]


# ------------------------------------------------------- a reduced step ----

STEP_B, STEP_S, STEP_MB = 4, 64, 2


def _port_step_count(cfg, fold_loops: bool, device: str = "cpu") -> dict:
    model = build_model(cfg, device=device, remat=True)
    opt = AdamW()
    state = init_train_state(model, opt, 0)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab,
                                             (STEP_B, STEP_S), np.int32),
                                device=device)
             for k in ("tokens", "labels")}
    step = make_train_step(model, opt, microbatches=STEP_MB)
    with OpCounter(fold_loops=fold_loops) as c:
        step(state, batch)
    return c.result()


def _ref_walker_flops(arch: str) -> float:
    """The reference's debug-mesh train step, compiled and walked
    (``tests/test_sharding_dryrun.py``)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = repro_arch(arch).reduced()
    model = repro_build(cfg, remat=True)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    opt = RefAdamW()
    state_shape = jax.eval_shape(lambda r: ref_init_train_state(model, opt, r),
                                 jax.random.PRNGKey(0))
    batch = {k: jax.ShapeDtypeStruct((STEP_B, STEP_S), np.int32)
             for k in ("tokens", "labels")}
    named = lambda t: jax.tree.map(  # noqa: E731
        lambda s: NamedSharding(mesh, s), t,
        is_leaf=lambda x: isinstance(x, P))
    step = ref_make_train_step(model, opt, microbatches=STEP_MB)
    with mesh:
        compiled = jax.jit(step, in_shardings=(
            named(ref_sh.state_pspecs(state_shape, mesh, cfg)),
            named(ref_sh.batch_pspecs(batch, mesh))),
            donate_argnums=(0,)).lower(state_shape, batch).compile()
    return hlo_cost_analysis(compiled.as_text())["flops"]


def test_reduced_train_step_counts_near_model_flops_and_the_walker():
    arch = "stablelm-1.6b"
    cfg = get_arch(arch).reduced()
    full = _port_step_count(cfg, fold_loops=False)
    # the microbatch loop folded by its trip count gives the full count
    # (folding counts meta tensors only)
    assert _port_step_count(cfg, fold_loops=True, device="meta") \
        == _port_step_count(cfg, fold_loops=False, device="meta")
    mf = model_flops(cfg, "train", STEP_B, STEP_S)
    assert 0.8 * mf < full["flops"] < 8 * mf
    assert full["flops"] == pytest.approx(_ref_walker_flops(arch), rel=0.25)


def test_a_folded_scan_counts_forward_and_backward_as_unfolded():
    """``trip_count.scan`` under a folding counter runs 3 of its 10 steps
    (the first, a middle one counted 8 times, the last) and counts what
    the unfolded loop does, forward and backward: the pieces' gradients
    joined, the gradients of a tensor every step reads summed, the carry's
    chain through every step."""
    def step(i, carry, w, x):
        h = torch.tanh(carry[0] @ w + x)
        return (h,), h * 2.0

    counts = []
    for fold in (False, True):
        h0, w = (torch.empty(s, device="meta", requires_grad=True)
                 for s in ((4, 8), (8, 8)))
        xs = torch.empty(40, 8, device="meta", requires_grad=True)
        with OpCounter(fold_loops=fold) as c:
            (h,), y = trip_count.scan(10, step, (h0,), (w,), (xs,))
            grads = torch.autograd.grad(y.sum() + h.sum(), (h0, w, xs))
        assert y.shape == (40, 8) and [g.shape for g in grads] == [
            h0.shape, w.shape, xs.shape]
        counts.append((c.flops, c.bytes, c._ops))
    assert counts[1][:2] == counts[0][:2]
    assert counts[1][2] < counts[0][2] / 2
    assert not trip_count.FOLDING
