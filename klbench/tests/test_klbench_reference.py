"""The plain references agree with the program's CPU path at tiny sizes,
in float32."""

import torch

from klbench.reference import decoder as R
from klbench.reference import stencils as S
from klbench.weights import decoder_params, flatten
from klbench.loops._lm import arch_config
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.train.step import make_train_step

TINY = dict(name="tiny", num_hidden_layers=2, hidden_size=256,
            num_attention_heads=4, num_key_value_heads=2, head_dim=128,
            intermediate_size=512, vocab_size=512, rope_theta=1e6,
            rms_norm_eps=1e-6,
            qkv_bias=True, tie_word_embeddings=False, torch_dtype="float32")
OPT = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
           clip_norm=1.0)


def f32(tree):
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.float32, copy=True)
    if isinstance(tree, list):
        return [f32(t) for t in tree]
    return {k: f32(v) for k, v in tree.items()}


def test_stencils_are_the_programs_plain_versions():
    g = torch.Generator().manual_seed(3)
    u, v, w, e = (torch.randn(6, 7, 9, generator=g) for _ in range(4))
    e = e.abs() + 0.1
    want = ops.advec_u(u, v, w, 1.1, 0.9, 1.3)
    got = S.advec_u(u, v, w, 1.1, 0.9, 1.3)
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)
    for a, b in zip(S.diff_uvw(u, v, w, e, 1.1, 0.9, 1.3),
                    ops.diff_uvw(u, v, w, e, 1.1, 0.9, 1.3)):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-6)


def test_decoder_prefill_is_the_programs():
    params = f32(decoder_params(TINY, 5, "cpu"))
    model = build_model(arch_config(TINY), device="cpu")
    tokens = torch.randint(512, (2, 128), generator=torch.Generator()
                           .manual_seed(1))
    cache = model.init_cache(2, 128)
    logits, _ = model.prefill(params, tokens, cache)
    kv = {}
    ref = R.prefill(TINY, params, tokens,
                    on_kv=lambda i, k, v: kv.setdefault(i, (k, v)))
    assert torch.allclose(logits[:, -1], ref, rtol=1e-4, atol=1e-4)
    for i, (k, v) in kv.items():
        assert torch.allclose(cache["kv"]["k"][i], k, rtol=1e-4, atol=1e-4)
        assert torch.allclose(cache["kv"]["v"][i], v, rtol=1e-4, atol=1e-4)


def test_decoder_training_is_the_programs():
    params = f32(decoder_params(TINY, 6, "cpu"))
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(512, (3, 4, 129), generator=g)
    batches = [{"tokens": b[:, :-1].contiguous(),
                "labels": b[:, 1:].contiguous()} for b in ids]
    model = build_model(arch_config(TINY), device="cpu", remat=True)
    opt = AdamW(**OPT)
    step = make_train_step(model, opt, microbatches=2)
    state = {"params": f32(params), "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    losses = []
    for i, b in enumerate(batches):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        if i == 0:
            grads = {p: float(torch.linalg.vector_norm(t)) / (1 - OPT["b1"])
                     for p, t in flatten(state["opt"]["m"])}
    ref = R.train(TINY, params, batches, OPT, 2, 3)
    for a, b in zip(losses, ref["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    for p, n in ref["grad_norms"].items():
        assert abs(grads[p] - n) <= 1e-4 * n + 1e-7
    p0 = dict(flatten(params))
    for p, t in flatten(state["params"]):
        change = float(torch.linalg.vector_norm(t - p0[p]))
        assert abs(change - ref["change"][p]) <= 1e-3 * ref["change"][p] \
            + 1e-7
