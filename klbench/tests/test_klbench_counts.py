"""The frozen counts agree with the program's workload hooks at the
cells' shapes, as the program stands."""

import json
from dataclasses import replace

import pytest

from klbench import harness
from klbench.counts import flash, lm, peaks, stencils
from repro_torch.configs import get_arch
from repro_torch.core.device import GPU_H100
from repro_torch.kernels import advec_u, diff_uvw
from repro_torch.kernels import flash_attention as fa

ROOT = harness.KLBENCH.parent


def config(name):
    return json.loads((ROOT / f"klbench/configs/{name}.json").read_text())


@pytest.mark.parametrize("grid", [(512, 512, 512), (256, 256, 256)])
def test_stencil_counts_are_the_hooks(grid):
    b = advec_u.builder
    w = b.make_workload(b.default_config(), grid, "float32")
    assert stencils.advec_u(grid, "float32") == (w.flops, w.hbm_bytes)
    b = diff_uvw.builder
    cfg = dict(b.default_config(), fuse_outputs=True)
    w = b.make_workload(cfg, grid, "float32")
    assert stencils.diff_uvw(grid, "float32") == (w.flops, w.hbm_bytes)


@pytest.mark.parametrize("bh,bhkv,s", [(256, 32, 1024), (128, 16, 2048),
                                       (64, 8, 4096), (64, 8, 2048),
                                       (128, 128, 2048)])
def test_flash_counts_are_the_hook(bh, bhkv, s):
    b = fa.causal_builder
    w = b.make_workload(b.default_config(), (bh, bhkv, s, 128), "bfloat16")
    assert flash.attention(bh, bhkv, s, 128, "bfloat16") == (w.flops,
                                                             w.hbm_bytes)


def test_peaks_are_the_programs_h100():
    p = peaks.peaks()
    assert (p["bf16_flops"], p["f32_flops"], p["hbm_bytes_per_s"]) == (
        GPU_H100.flops_bf16, GPU_H100.flops_f32, GPU_H100.hbm_bw)


@pytest.mark.parametrize("name", ["codeqwen1.5-7b", "codeqwen1.5-7b-stage"])
def test_lm_matrix_parameters_are_the_models(name):
    c = config(name)
    arch = get_arch("codeqwen1.5-7b")
    assert (arch.d_model, arch.d_ff, arch.d_head, arch.vocab) == (
        c["hidden_size"], c["intermediate_size"], c["head_dim"],
        c["vocab_size"])
    d, n = c["hidden_size"], c["num_hidden_layers"]
    embed_head = 2 * c["vocab_size"] * d
    norms = (2 * n + 1) * d
    assert n * lm.layer_matmul_params(c) + embed_head + norms == replace(
        arch, n_layers=n, n_kv_heads=c["num_key_value_heads"]).n_params()


def test_the_whole_model_has_the_published_parameter_count():
    c = config("codeqwen1.5-7b")
    arch = replace(get_arch("codeqwen1.5-7b"),
                   n_kv_heads=c["num_key_value_heads"])
    assert arch.n_params() == pytest.approx(7.25e9, rel=1e-3)


def test_prefill_flops_of_the_mix():
    c = config("codeqwen1.5-7b")
    f = lm.prefill_flops(c, 4, 2048)
    # 2 x 32 x 202.9e6 x 8192 matrix flops + 4.4e12 attention + the head
    assert f == pytest.approx(1.108e14, rel=0.01)
    assert lm.prefill_flops(c, 2, 4096) > f > lm.prefill_flops(c, 8, 1024)


def test_train_flops_of_a_step():
    c = config("codeqwen1.5-7b-stage")
    assert lm.train_flops(c, 4, 2048) == pytest.approx(1.017e14, rel=0.02)


def test_bounds_at_the_paper_grid():
    f, b = stencils.advec_u((512, 512, 512), "float32")
    assert peaks.bound_s(f, b, "float32") == pytest.approx(0.641e-3,
                                                          rel=0.01)
    f, b = stencils.diff_uvw((512, 512, 512), "float32")
    assert peaks.bound_s(f, b, "float32") == pytest.approx(1.122e-3,
                                                          rel=0.01)
    f, b = flash.attention(128, 128, 2048, 128, "bfloat16")
    assert peaks.bound_s(f, b, "bfloat16") == pytest.approx(0.139e-3,
                                                           rel=0.01)
