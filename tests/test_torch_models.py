"""The port's dense LM (``repro_torch.models``) against the JAX package's.

Weights come from the reference's ``DecoderLM.init`` and cross through
``repro_torch.models.convert.params_from_jax``; inputs are drawn with numpy
from a seed. Everything runs in float32 on the CPU. Tolerances:

* layer primitives (norms, rotary, MLP): rtol = atol = 1e-5, the tuner's
  float32 tolerance; the two packages differ only in summation order;
* attention blocks and whole-model logits: rtol = atol = 1e-4. A model
  chains a dozen float32 products and softmaxes, each adding rounding of
  order 1e-7 relative in another order in each package; the logits are
  of order 1;
* the port against itself (prefill vs forward, decode vs forward): the
  reference's own tolerances in ``tests/test_models.py`` (2e-3, 5e-3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as repro_arch
from repro.kernels import ops as repro_ops
from repro.models import attention as repro_attn
from repro.models import build_model as repro_build
from repro.models import common as repro_common
from repro.models.common import KeyGen

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import build_model, common
from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)
DENSE = ["codeqwen1.5-7b", "stablelm-1.6b", "h2o-danube-1.8b", "gemma2-2b"]
PRIM_TOL = 1e-5
MODEL_TOL = 1e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------ primitives

@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_apply_norm_matches_repro(rng, norm):
    cfg = get_arch("stablelm-1.6b").reduced(norm=norm)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    p = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32),
         "bias": rng.standard_normal(cfg.d_model).astype(np.float32)}
    want = repro_common.apply_norm(cfg, p, jnp.asarray(x))
    got = common.apply_norm(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
    _close(got, want, PRIM_TOL)


@pytest.mark.parametrize("heads", [True, False])
@pytest.mark.parametrize("rope_frac", [1.0, 0.25, 0.3])
def test_apply_rope_matches_repro(rng, rope_frac, heads):
    """Interleaved pairs, a partial rotary fraction (0.3 of 40 dims rounds
    to 12) with the tail unrotated, and positions past 1000."""
    shape = (2, 7, 3, 40) if heads else (2, 7, 40)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = np.arange(1000, 1007)
    want = repro_common.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                   rope_frac, 10000.0)
    got = common.apply_rope(_t(x), torch.from_numpy(pos), rope_frac,
                            10000.0)
    _close(got, want, PRIM_TOL)
    d_rot = int(40 * rope_frac) // 2 * 2
    assert torch.equal(got[..., d_rot:], _t(x)[..., d_rot:])


def test_apply_rope_rotates_interleaved_pairs():
    """Position 1 with one frequency (d=2) rotates (x0, x1) as a pair."""
    x = torch.tensor([[1.0, 0.0]])
    got = common.apply_rope(x, torch.tensor([1]), 1.0, 10000.0)
    assert torch.allclose(got, torch.tensor([[np.cos(1.0), np.sin(1.0)]],
                                            dtype=torch.float32))


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False)])
def test_apply_mlp_matches_repro(rng, act, gated):
    cfg = get_arch("gemma2-2b").reduced(act=act, gated_mlp=gated)
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_in": rng.standard_normal((d, f)).astype(np.float32) / 8,
         "w_out": rng.standard_normal((f, d)).astype(np.float32) / 11,
         "w_gate": rng.standard_normal((d, f)).astype(np.float32) / 8}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    want = repro_common.apply_mlp(cfg, p, jnp.asarray(x))
    got = common.apply_mlp(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
    _close(got, want, PRIM_TOL)


# ------------------------------------------------------------- attention

def _attn_params(cfg, seed=0):
    p = repro_attn.init_attn(KeyGen(jax.random.PRNGKey(seed)), cfg)
    if cfg.qkv_bias:   # non-zero biases, so the bias path is exercised
        p = {k: (v + 0.1 if k.startswith("b") else v) for k, v in p.items()}
    return p, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("arch", DENSE)
def test_attn_prefill_and_decode_match_repro(rng, arch):
    """Prefill 12 tokens into a 20-slot cache, then decode 3 steps, each
    with a per-slot ``start`` window; outputs and caches agree."""
    cfg = get_arch(arch).reduced()
    window = int(cfg.layer_windows[0])
    jp, tp = _attn_params(cfg)
    B, S, M = 2, 12, 20
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    shape = (B, cfg.n_kv_heads, M, cfg.d_head)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    want, jk, jv = repro_attn.attn_prefill(cfg, jp, jnp.asarray(x), jk, jv,
                                           window=window)
    got, tk, tv = attn.attn_prefill(cfg, tp, _t(x), tk, tv, window=window)
    _close(got, want, MODEL_TOL)
    _close(tk, jk, MODEL_TOL)
    start = np.array([0, 5])
    for pos in range(S, S + 3):
        xt = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, jk, jv = repro_attn.attn_decode(
            cfg, jp, jnp.asarray(xt), jk, jv, jnp.asarray(pos, jnp.int32),
            window=window, start=jnp.asarray(start))
        got, tk, tv = attn.attn_decode(cfg, tp, _t(xt), tk, tv, pos,
                                       window=window,
                                       start=torch.from_numpy(start))
        _close(got, want, MODEL_TOL)
    _close(tv, jv, MODEL_TOL)


def test_attn_prefill_matches_pallas_flash_interpret(rng, monkeypatch):
    """d_head=128, S=128 and a static window (0 = full): the reference runs
    its Pallas flash kernel in interpret mode, the port its flash plain
    version; both went through their flash kernels."""
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "interpret")
    cfg = get_arch("codeqwen1.5-7b").reduced(d_model=64, n_heads=2,
                                             n_kv_heads=1, d_head=128)
    jp, tp = _attn_params(cfg, seed=3)
    B, S = 1, 128
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    shape = (B, cfg.n_kv_heads, S, cfg.d_head)
    n_ref = len(repro_ops.fa_causal_kernel.stats)
    n_port = len(ops.fa_causal_kernel.stats)
    want, _, _ = repro_attn.attn_prefill(cfg, jp, jnp.asarray(x),
                                         jnp.zeros(shape), jnp.zeros(shape),
                                         window=0)
    got, _, _ = attn.attn_prefill(cfg, tp, _t(x), torch.zeros(shape),
                                  torch.zeros(shape), window=0)
    assert len(repro_ops.fa_causal_kernel.stats) == n_ref + 1
    assert len(ops.fa_causal_kernel.stats) == n_port + 1
    _close(got, want, MODEL_TOL)


def test_tensor_window_takes_the_masked_oracle(monkeypatch):
    """The static-window rule, word for word: an int goes to
    ``ops.attention``, a tensor window to the masked oracle."""
    cfg = get_arch("h2o-danube-1.8b").reduced()
    _, tp = _attn_params(cfg)
    routed = []
    monkeypatch.setattr(attn.ops, "attention",
                        lambda *a, **k: routed.append("ops")
                        or attn.kref.attention_ref(*a, **k))
    x = torch.randn(1, 6, cfg.d_model)
    a = attn.attn_forward(cfg, tp, x, window=4)
    b = attn.attn_forward(cfg, tp, x, window=torch.tensor(4))
    assert routed == ["ops"]
    assert torch.allclose(a, b, rtol=PRIM_TOL, atol=PRIM_TOL)


# ------------------------------------------------------------ whole model

def _models(arch, seed=0):
    rcfg = repro_arch(arch).reduced()
    rmodel = repro_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(seed))
    cfg = get_arch(arch).reduced()
    model = build_model(cfg, device="cpu")
    return rmodel, rparams, model, params_from_jax(cfg, _np_tree(rparams))


@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_match_repro(rng, arch):
    rmodel, rparams, model, params = _models(arch)
    cfg = model.cfg
    B, S = 2, 16
    tokens = rng.integers(0, cfg.vocab, (B, S + 2)).astype(np.int32)
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens)

    x_ref, _ = rmodel.forward(rparams, jt)
    x, aux = model.forward(params, tt)
    _close(x, x_ref, MODEL_TOL)
    _close(model._head(params, x), rmodel._head(rparams, x_ref), MODEL_TOL)
    assert float(aux["moe_load_balance"]) == 0.0

    jc = rmodel.init_cache(B, 32)
    tc = model.init_cache(B, 32)
    want, jc = rmodel.prefill(rparams, jt[:, :S], jc)
    got, tc = model.prefill(params, tt[:, :S], tc)
    assert int(tc["pos"]) == int(jc["pos"]) == S
    _close(got, want, MODEL_TOL)
    _close(tc["kv"]["k"], jc["kv"]["k"], MODEL_TOL)
    for i in range(2):
        want, jc = rmodel.decode_step(rparams, jc, jt[:, S + i:S + i + 1])
        got, tc = model.decode_step(params, tc, tt[:, S + i:S + i + 1])
        _close(got, want, MODEL_TOL)
    assert got.shape == (B, 1, cfg.padded_vocab)
    _close(tc["kv"]["v"], jc["kv"]["v"], MODEL_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_forward(arch):
    """The port against itself, as ``tests/test_models.py`` holds the
    reference: prefill logits (last position) == full-forward logits."""
    cfg = get_arch(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    x, _ = model.forward(params, tokens)
    full = model._head(params, x[:, -1:])
    logits, cache = model.prefill(params, tokens, model.init_cache(2, 64))
    assert cache["pos"] == 16
    torch.testing.assert_close(logits, full, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """decode_step after prefill == forward on the extended sequence."""
    cfg = get_arch(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(2))
    tokens = torch.randint(0, cfg.vocab, (2, 13),
                           generator=torch.Generator().manual_seed(2))
    _, cache = model.prefill(params, tokens[:, :12], model.init_cache(2, 64))
    dec, cache = model.decode_step(params, cache, tokens[:, 12:13])
    x, _ = model.forward(params, tokens)
    torch.testing.assert_close(dec, model._head(params, x[:, -1:]),
                               rtol=5e-3, atol=5e-3)


def test_padded_vocab_columns_are_masked():
    cfg = get_arch("codeqwen1.5-7b").reduced(vocab=200)
    assert cfg.padded_vocab == 256
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    logits, _ = model.prefill(params, torch.zeros(1, 4, dtype=torch.long),
                              model.init_cache(1, 8))
    assert torch.all(logits[..., 200:] == -1e30)
    assert torch.isfinite(logits[..., :200]).all()


def test_full_codeqwen_param_count_on_meta():
    cfg = get_arch("codeqwen1.5-7b")
    model = build_model(cfg, device="meta")
    params = model.init()
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            leaves.append(t)

    walk(params)
    assert all(t.device.type == "meta" for t in leaves)
    n = sum(t.numel() for t in leaves)
    biases = cfg.n_layers * (cfg.d_q + 2 * cfg.d_kv)   # not in n_params
    assert n - biases == cfg.n_params()
    assert 8.1e9 < cfg.n_params() < 8.3e9


def test_other_families_raise_with_their_roadmap_item():
    for name in ("llama-3.2-vision-11b", "deepseek-moe-16b", "hymba-1.5b",
                 "deepseek-v2-236b", "rwkv6-7b", "whisper-base"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            get_arch(name)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            build_model(repro_arch(name), device="cpu")
    with pytest.raises(KeyError):
        get_arch("no-such-model")


def test_configs_are_the_reference_configs():
    for name in DENSE:
        assert get_arch(name).__dict__ == repro_arch(name).__dict__
    assert set(ArchConfig.__dataclass_fields__) == \
        set(repro_arch("gemma2-2b").__dataclass_fields__)


def test_build_model_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        build_model(get_arch("codeqwen1.5-7b").reduced())


def test_prefill_capture_tune_then_exact(tmp_path, monkeypatch):
    """The paper's loop on the LM slice, as ``chip_smoke.py`` runs it on
    the card: capture a one-layer prefill's flash launch, replay-tune it,
    and the next prefill of the full stack selects tier ``exact`` in every
    layer (here with the plain version and the host clock)."""
    from repro_torch.core import list_captures
    from repro_torch.core.capture import CAPTURE_DIR_ENV, CAPTURE_ENV
    from repro_torch.core.wisdom import WISDOM_DIR_ENV
    from repro_torch.tuner import tune_capture

    cfg = get_arch("codeqwen1.5-7b").reduced(n_layers=3, d_model=64,
                                             n_heads=2, n_kv_heads=2,
                                             d_head=128)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab, (1, 128),
                           generator=torch.Generator().manual_seed(0))
    one = build_model(ArchConfig(**{**cfg.__dict__, "n_layers": 1}),
                      device="cpu")
    monkeypatch.setenv(CAPTURE_ENV, "flash_attention_causal")
    monkeypatch.setenv(CAPTURE_DIR_ENV, str(tmp_path / "captures"))
    one.prefill({**params, "layers": params["layers"][:1]}, tokens,
                one.init_cache(1, 128))
    monkeypatch.delenv(CAPTURE_ENV)
    caps = list_captures(tmp_path / "captures")
    assert [c.name for c in caps] == [
        "flash_attention_causal-2x2x128x128-float32.capture.json"]
    res = tune_capture(caps[0], "cpu", strategy="random", max_evals=2,
                       wisdom_dir=tmp_path / "wisdom", device="cpu")
    assert res.best_config is not None
    monkeypatch.setenv(WISDOM_DIR_ENV, str(tmp_path / "wisdom"))
    ops.reload_wisdom()
    try:
        before = dict(ops.fa_causal_kernel.tier_counts)
        model.prefill(params, tokens, model.init_cache(1, 128))
        after = ops.fa_causal_kernel.tier_counts
        assert {t: n - before.get(t, 0) for t, n in after.items()
                if n != before.get(t, 0)} == {"exact": 3}
        assert ops.fa_causal_kernel.stats[-1].config == res.best_config
    finally:
        monkeypatch.delenv(WISDOM_DIR_ENV)
        ops.reload_wisdom()
