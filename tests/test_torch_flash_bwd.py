"""The flash-attention backward's wiring on the host
(``kernels/flash_attention_bwd.py``): which gradients ``FlashAttentionFn``
sends to the backward kernel's builders, their spaces, the card's refusals,
the workload hook, the plain gradient the CPU path runs, the ``meta``
stand-in and the ``attn_backward`` span around the launch. The CUDA kernel
itself is checked on the card by ``tests/test_torch_gpu.py``.
"""

from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import args_meta, get_kernel, wisdom_kernel
from repro_torch.kernels import _build, flash_attention, ops, ref
from repro_torch.kernels import flash_attention_bwd as fb

torch.set_num_threads(1)
BUILDERS = ["flash_attention_bwd_causal", "flash_attention_bwd_full"]


def _qkv(dtype, d=128, b=1, hq=4, hkv=2, s=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, h, s, d), generator=g).to(dtype)
            .requires_grad_(True) for h in (hq, hkv, hkv)]


def _bwd_kernel(causal):
    return ops.fa_bwd_causal_kernel if causal else ops.fa_bwd_full_kernel


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,d,through", [
    (torch.bfloat16, 128, True), (torch.float32, 128, False),
    (torch.bfloat16, 256, False), (torch.float32, 256, False)])
def test_the_backward_kernel_takes_bf16_at_head_dim_128_only(
        causal, dtype, d, through):
    """``ops.attention``'s gradient goes through the backward kernel's
    WisdomKernel (its plain gradient on the host) for bfloat16 at D 128;
    float32 and other head dims keep the plain recompute. Either way the
    gradients are plain autograd's of ``ref.attention_ref``, bit for bit,
    and no CUDA kernel launches."""
    kern = _bwd_kernel(causal)
    q, k, v = _qkv(dtype, d)
    assert fb.takes(q.reshape(-1, 128, d)) is through
    n0 = len(kern.stats)
    launches = {n: c.launches for n, c in _build.CUDA_KERNELS.items()}
    out = ops.attention(q, k, v, causal=causal)
    assert flash_attention.through_flash_fn(out)
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)
                     ).to(dtype)
    out.backward(ct)
    assert len(kern.stats) == n0 + through
    if through:
        assert kern.stats[-1].config == kern.builder.default_config()
    want = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    ref.attention_ref(*want, causal=causal).backward(ct)
    for a, w in zip((q, k, v), want):
        assert a.grad.dtype == dtype and torch.equal(a.grad, w.grad)
    assert launches == {n: c.launches for n, c in _build.CUDA_KERNELS.items()}


@pytest.mark.parametrize("name", BUILDERS)
def test_backward_spaces_refuse_what_the_card_cannot_hold(name):
    """18 of the 27 (block_q, block_k, threads) configs: block_q 128 would
    hold 192 + 64 f32 accumulators a thread in the dk/dv pass. Every config
    the space keeps fits a block's shared memory and the accumulator
    budget, and selection's fit leaves it as it is (the kernel takes one
    head dim, the space's)."""
    b = get_kernel(name)
    configs = list(b.space.enumerate())
    assert len(configs) == 18
    assert b.default_config() in configs
    assert {c["block_q"] for c in configs} == {32, 64}
    for cfg in configs:
        assert fb.card_refusal(cfg) == ""
        assert max(fb.smem_bytes(cfg).values()) <= 232_448
        assert b.fit_config(cfg, (64, 8, 2048, 128), "bfloat16") == cfg
    wide = {"block_q": 128, "block_k": 64, "threads": 128}
    assert "dkdv pass holds 256 f32 accumulators" in fb.card_refusal(wide)
    assert not b.space.is_valid(wide)
    assert fb.smem_bytes({"block_q": 64, "block_k": 128, "threads": 256}) \
        == {"dq": (256 + 256) * 136 * 2, "dkdv": (256 + 128) * 136 * 2 + 512}


@pytest.mark.parametrize("causal", [True, False])
def test_backward_workload_counts_nine_products_a_pair(causal):
    """At the training cell's shape (BH 64, BHkv 8, S 2048, D 128): nine
    products of 2 D flop for each (query, key) pair, S(S+1)/2 pairs a head
    when causal (309 GFLOP); q, k, v and dO read once, dq, dk, dv written
    once, lse and delta written and read once."""
    b = get_kernel("flash_attention_bwd_causal" if causal
                   else "flash_attention_bwd_full")
    bh, bhkv, s, d = 64, 8, 2048, 128
    w = b.make_workload(b.default_config(), (bh, bhkv, s, d), "bfloat16")
    pairs = s * (s + 1) / 2 if causal else s * s
    assert w.valid and w.flops == 9 * 2 * d * pairs * bh
    if causal:
        assert w.flops == pytest.approx(309.4e9, rel=1e-3)
    assert w.hbm_bytes == (3 * bh + 4 * bhkv) * s * d * 2 + 4 * bh * s * 4
    assert w.grid == 2048 // 64 * (bh + bhkv)
    assert not b.make_workload(b.default_config(), (bh, bhkv, s, d),
                               "float32").valid
    assert not b.make_workload(b.default_config(), (bh, 7, s, d),
                               "bfloat16").valid


@pytest.mark.parametrize("name", BUILDERS)
def test_backward_cpu_launch_is_the_plain_gradient(name):
    """The builder on CPU tensors runs the plain gradient (no nvcc, no
    launch): float32 autograd of the plain forward on the probe's bf16 q,
    k, v against its dO, in bf16; a ragged S at GQA 8/2."""
    b = get_kernel(name)
    args = b.make_probe_args((8, 2, 200, 128), "bfloat16")
    assert [tuple(t.shape) for t in args] == [(8, 200, 128), (2, 200, 128),
                                              (2, 200, 128), (8, 200, 128)]
    launches = fb.kernel.launches
    got = b.make(b.default_config(), args_meta(*args))(*args)
    causal = name.endswith("causal")
    q, k, v, do = (t.detach().requires_grad_(True) for t in args)
    out = ref.flash_attention_ref_factory(causal)(q, k, v)
    want = torch.autograd.grad(out, (q, k, v), do)
    assert all(g.dtype == torch.bfloat16 and torch.equal(g, w)
               for g, w in zip(got, want))
    assert fb.kernel.launches == launches
    with pytest.raises(ValueError, match="bfloat16"):
        fb.launch(b.default_config(), *(t.float() for t in args),
                  causal=causal)
    with pytest.raises(ValueError, match="head dim 128"):
        fb.launch(b.default_config(), *(t[..., :64].contiguous()
                                        for t in args), causal=causal)


def test_backward_meta_stand_in_is_seen_and_launches_nothing(monkeypatch):
    """On ``meta`` tensors (the dry-run) the gradient goes through the
    backward's stand-in: the gradients' shapes, the launch observers hear
    of the backward builder's work, and no plain gradient runs."""
    def refuse(*a, **k):
        raise AssertionError("the plain gradient ran on meta tensors")

    seen = []
    monkeypatch.setattr(wisdom_kernel, "LAUNCH_OBSERVERS",
                        [lambda b, c, p, d: seen.append((b.name, p, d))])
    monkeypatch.setattr(ref, "flash_attention_bwd_ref_factory", refuse)
    q, k, v = (torch.empty((2, h, 256, 128), dtype=torch.bfloat16,
                           device="meta", requires_grad=True)
               for h in (8, 2, 2))
    out = ops.attention(q, k, v, causal=True)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert [t.shape for t in (dq, dk, dv)] == [q.shape, k.shape, v.shape]
    assert [t.device.type for t in (dq, dk, dv)] == ["meta"] * 3
    assert seen == [("flash_attention_causal", (16, 4, 256, 128),
                     "bfloat16"),
                    ("flash_attention_bwd_causal", (16, 4, 256, 128),
                     "bfloat16")]


@pytest.mark.parametrize("dtype,launches", [(torch.bfloat16, 1),
                                            (torch.float32, 0)])
def test_backward_launch_sits_inside_the_attn_backward_span(tmp_path, dtype,
                                                            launches):
    """Under the profiler, the backward kernel's ``launch`` span lies inside
    ``attn_backward`` on the autograd thread (bf16): the span still wraps
    the whole backward. In float32 the plain recompute runs there and no
    launch does."""
    q, k, v = _qkv(dtype)

    def run():
        ops.attention(q, k, v).sum().backward()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    (span,) = [e for e in events if e["name"] == "repro_torch.attn_backward"]
    spans = [e for e in events if e["name"] == "repro_torch.launch"]
    within = [e for e in spans
              if e["tid"] == span["tid"] and e["ts"] >= span["ts"]
              and e["ts"] + e["dur"] <= span["ts"] + span["dur"]]
    assert len(spans) == 1 + launches and len(within) == launches
