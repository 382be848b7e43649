"""The port's attention families of the model zoo (``repro_torch.models``:
MoE, MLA and gated cross-attention) against the JAX package's.

Three architectures, each at a reduced config in float32 on the CPU:
deepseek-moe-16b (a dense-FFN layer, then MoE layers), deepseek-v2-236b
(MoE with MLA) and llama-3.2-vision-11b (two groups, each a gated
cross-attention block and two self layers). Weights come from the
reference's ``DecoderLM.init`` and cross through
``repro_torch.models.convert.params_from_jax``; tokens and image
embeddings are drawn with numpy from a seed. The reference initialises
every cross block's ``gate`` to 0, and ``tanh(0) = 0`` removes the cross
block from the output, so the vision tests set each gate to a non-zero
value before comparing (:func:`_open_gates`).

Tolerances: rtol = atol = 1e-4 on hidden states, logits, caches and the
auxiliary losses (``MODEL_TOL`` of ``tests/test_torch_models.py``: a
model chains a dozen float32 products and softmaxes, each rounding in
another order in each package); losses 1e-5 x max(1, |ref|) and
gradients, leaf by leaf, max abs <= 1e-4 x max(1, max|ref leaf|), as in
``tests/test_torch_train.py``; the port against itself (absorbed MLA
decode against the expanded forward) 1e-4.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as repro_arch
from repro.models import attention as repro_attn
from repro.models import build_model as repro_build
from repro.models import mla as repro_mla
from repro.models import moe as repro_moe
from repro.models.common import KeyGen
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine

from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import build_model, mla, moe
from repro_torch.models.config import PORT_ONLY_FIELDS
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Request, ServeEngine

torch.set_num_threads(1)
MODEL_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
#: Each architecture's reduced config: 2 MoE layers after the dense one;
#: vision in 2 groups of a cross block and 2 self layers.
ZOO = {"deepseek-moe-16b": dict(n_layers=3),
       "deepseek-v2-236b": dict(n_layers=3),
       "llama-3.2-vision-11b": dict(n_layers=6, cross_attn_period=3)}
ARCHS = sorted(ZOO)
MOE_ARCHS = ["deepseek-moe-16b", "deepseek-v2-236b"]
B, S = 2, 16


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got: torch.Tensor, want, tol: float = MODEL_TOL) -> None:
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _open_gates(rparams: dict) -> dict:
    """The reference's params with each cross block's tanh gate non-zero
    (0.5, 1.0, ... by group), so the cross blocks reach the output."""
    if "cross" not in rparams:
        return rparams
    cross = dict(rparams["cross"])
    g = cross["attn"]["gate"]
    cross["attn"] = {**cross["attn"],
                     "gate": 0.5 * jnp.arange(1, g.shape[0] + 1,
                                              dtype=jnp.float32)}
    return {**rparams, "cross": cross}


def _cfgs(arch, **upd):
    red = {**ZOO[arch], **upd}
    return repro_arch(arch).reduced(**red), get_arch(arch).reduced(**red)


def _models(arch, seed=0, remat=False, **upd):
    rcfg, cfg = _cfgs(arch, **upd)
    rmodel = repro_build(rcfg, remat=remat)
    rparams = _open_gates(rmodel.init(jax.random.PRNGKey(seed)))
    model = build_model(cfg, device="cpu", remat=remat)
    return rmodel, rparams, model, params_from_jax(cfg, _np_tree(rparams))


def _inputs(cfg, seed=0, seq=S + 2):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)
    img = (rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model))
           .astype(np.float32) if cfg.cross_attn_period else None)
    return tokens, img


def _j(a):
    return None if a is None else jnp.asarray(a)


def _tt(a):
    return None if a is None else torch.from_numpy(a)


def stack_like_reference(cfg, t: dict) -> dict:
    """The port's tree (tensors or numpy) with its per-layer lists stacked
    into the reference's leaves: ``layers`` (L, ...) or, for vision,
    (G, period - 1, ...), and ``cross`` (G, ...); ``dense_prefix`` stays a
    list, as in the reference."""
    def np_(x):
        return x.detach().numpy() if isinstance(x, torch.Tensor) else x

    def stack(items):
        return tree.tree_map(lambda *xs: np.stack([np_(x) for x in xs]),
                             *items)

    out = {k: tree.tree_map(np_, v) for k, v in t.items()
           if k not in ("layers", "cross")}
    if cfg.cross_attn_period:
        out["cross"] = stack(t["cross"])
        out["layers"] = stack([stack(g) for g in t["layers"]])
    else:
        out["layers"] = stack(t["layers"])
    return out


def _assert_trees_close(got: dict, want, tol: float) -> None:
    g = dict(tree.leaves_with_paths(got))
    w = dict(tree.leaves_with_paths(_np_tree(want)))
    assert sorted(g) == sorted(w)
    for path in w:
        ref = np.asarray(w[path], np.float64)
        err = np.abs(np.asarray(g[path], np.float64) - ref).max()
        bound = tol * max(1.0, np.abs(ref).max())
        assert err <= bound, f"{path}: {err} > {bound}"


# --------------------------------------------------------------- configs

def _fields(cfg) -> dict:
    """``cfg.__dict__`` with each nested config (``MoECfg``, ``MLACfg``:
    the port's own copies of the reference's classes) as its class name
    and field dict. The fields only the port has (``PORT_ONLY_FIELDS``)
    must hold the values at which it behaves as the reference does, and
    are then left out."""
    extra = PORT_ONLY_FIELDS.get(type(cfg).__name__, {})
    out = {}
    for k, v in cfg.__dict__.items():
        if k in extra:
            assert v == extra[k], f"{type(cfg).__name__}.{k} = {v!r}"
            continue
        out[k] = ((type(v).__name__, _fields(v))
                  if dataclasses.is_dataclass(v) else v)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_configs_are_the_reference_configs(arch):
    assert _fields(get_arch(arch)) == _fields(repro_arch(arch))
    assert _fields(get_arch(arch).reduced()) == \
        _fields(repro_arch(arch).reduced())


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_element_count_on_meta(arch):
    """The full config on ``meta`` (236 B parameters cost nothing there):
    the port's element count, leaf count and dtypes equal those of
    ``jax.eval_shape`` of the reference's init."""
    cfg = get_arch(arch)
    params = build_model(cfg, device="meta").init()
    leaves = tree.leaves(params)
    assert all(t.device.type == "meta" for t in leaves)
    shapes = jax.eval_shape(repro_build(repro_arch(arch)).init,
                            jax.random.PRNGKey(0))
    want = jax.tree_util.tree_leaves(shapes)
    assert sum(t.numel() for t in leaves) == sum(
        int(np.prod(s.shape)) for s in want)
    layered = stack_like_reference(cfg, tree.tree_map(
        lambda t: np.empty((0,)), params))
    assert len(tree.leaves(layered)) == len(want)
    assert sorted({str(t.dtype).removeprefix("torch.") for t in leaves}) \
        == sorted({str(s.dtype) for s in want})
    if arch == "deepseek-moe-16b":
        assert sum(t.numel() for t in leaves) == cfg.n_params()


# ---------------------------------------------------------- whole model

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_aux_match_repro(arch):
    rmodel, rparams, model, params = _models(arch)
    tokens, img = _inputs(model.cfg)
    x_ref, aux_ref = rmodel.forward(rparams, jnp.asarray(tokens),
                                    img=_j(img))
    x, aux = model.forward(params, torch.from_numpy(tokens), img=_tt(img))
    _close(x, x_ref)
    _close(model._head(params, x), rmodel._head(rparams, x_ref))
    for k in ("moe_load_balance", "moe_z_loss"):
        _close(aux[k], aux_ref[k])
    if model.cfg.moe is not None:
        assert float(aux["moe_load_balance"]) > 0.0
        assert float(aux["moe_z_loss"]) > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_repro(arch):
    """Prefill 16 tokens into a 32-slot cache, then 2 decode steps: the
    logits and every cache (``kv``/``kv_dense``, ``mla``/``mla_dense``,
    ``cross_kv``) agree after prefill and after decode."""
    rmodel, rparams, model, params = _models(arch, seed=1)
    tokens, img = _inputs(model.cfg, seed=1)
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens)
    jc, tc = rmodel.init_cache(B, 32), model.init_cache(B, 32)
    cache_keys = sorted(k for k in jc if k != "pos")
    assert sorted(k for k in tc if k != "pos") == cache_keys
    want, jc = rmodel.prefill(rparams, jt[:, :S], jc, img=_j(img))
    got, tc = model.prefill(params, tt[:, :S], tc, img=_tt(img))
    assert int(tc["pos"]) == int(jc["pos"]) == S
    _close(got, want)
    for k in cache_keys:
        _assert_trees_close(tree.tree_map(lambda t: t.numpy(), tc[k]),
                            jc[k], MODEL_TOL)
    for i in range(2):
        want, jc = rmodel.decode_step(rparams, jc, jt[:, S + i:S + i + 1])
        got, tc = model.decode_step(params, tc, tt[:, S + i:S + i + 1])
        _close(got, want)
    assert got.shape == (B, 1, model.cfg.padded_vocab)
    for k in cache_keys:
        _assert_trees_close(tree.tree_map(lambda t: t.numpy(), tc[k]),
                            jc[k], MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_metrics_match_repro(arch):
    rmodel, rparams, model, params = _models(arch, seed=2)
    tokens, img = _inputs(model.cfg, seed=2, seq=S)
    labels = np.roll(tokens, -1, axis=1)
    batch = {"tokens": tokens, "labels": labels}
    if img is not None:
        batch["img"] = img
    want, wm = rmodel.loss(rparams, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    got, gm = model.loss(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert set(gm) == set(wm)
    if model.cfg.moe is not None:
        assert {"moe_load_balance", "moe_z_loss"} <= set(gm)
    for k in gm:
        assert abs(float(gm[k]) - float(wm[k])) <= LOSS_TOL * max(
            1.0, abs(float(wm[k]))), k
    assert float(got) == float(gm["loss"])


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_repro(arch, remat):
    """``loss.backward()`` in the port against ``jax.grad`` of the
    reference's loss, leaf by leaf (the router, the experts, the MLA
    projections and norms, the cross blocks and their gates included)."""
    rmodel, rparams, model, params = _models(arch, seed=3, remat=remat)
    tokens, img = _inputs(model.cfg, seed=3, seq=S)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if img is not None:
        batch["img"] = img
    want = jax.grad(lambda p: rmodel.loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(rparams)
    for leaf in tree.leaves(params):
        leaf.requires_grad_(True)
    loss, _ = model.loss(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    loss.backward()
    grads = tree.tree_map(lambda p: p.grad, params)
    _assert_trees_close(stack_like_reference(model.cfg, grads), want,
                        GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_forward(arch):
    """The port against itself: prefill's last logits and 2 decode steps
    equal the full forward's logits at those positions (the reduced MoE
    configs' capacity factor 4 drops no token)."""
    cfg = get_arch(arch).reduced(**ZOO[arch])
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(4))
    for cross in params.get("cross", []):
        cross["attn"]["gate"].fill_(0.75)
    tokens, img = _inputs(cfg, seed=4)
    tt, ti = torch.from_numpy(tokens), _tt(img)
    x, _ = model.forward(params, tt, img=ti)
    full = model._head(params, x)
    logits, cache = model.prefill(params, tt[:, :S], model.init_cache(B, 32),
                                  img=ti)
    torch.testing.assert_close(logits, full[:, S - 1:S], rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    for i in range(2):
        logits, cache = model.decode_step(params, cache,
                                          tt[:, S + i:S + i + 1])
        torch.testing.assert_close(logits, full[:, S + i:S + i + 1],
                                   rtol=MODEL_TOL, atol=MODEL_TOL)


def test_vision_needs_image_embeddings():
    _, _, model, params = _models("llama-3.2-vision-11b")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="image embeddings"):
        model.forward(params, tokens)
    with pytest.raises(ValueError, match="image embeddings"):
        model.prefill(params, tokens, model.init_cache(1, 8))


def test_gate_zero_removes_the_cross_blocks():
    """The reference's init (gate 0): the cross blocks add nothing, so an
    image changes no logit; with the gates open it does."""
    rcfg, cfg = _cfgs("llama-3.2-vision-11b")
    rparams = repro_build(rcfg).init(jax.random.PRNGKey(6))
    model = build_model(cfg, device="cpu")
    tokens, img = _inputs(cfg, seed=6)
    outs = {}
    for name, p in (("closed", rparams), ("open", _open_gates(rparams))):
        params = params_from_jax(cfg, _np_tree(p))
        xs = [model.forward(params, torch.from_numpy(tokens), img=i)[0]
              for i in (_tt(img), _tt(2 * img))]
        outs[name] = float((xs[0] - xs[1]).abs().max())
    assert outs["closed"] == 0.0 and outs["open"] > 1e-3


@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "llama-3.2-vision-11b"])
def test_self_layers_reach_the_flash_kernel(arch):
    """At d_head 128 and S 128 every self-attention layer (deepseek-moe's
    dense prefix and MoE layers; vision's self layers, not its cross
    blocks) goes through ``ops.attention``'s flash path, whose plain
    version runs on the CPU, and the prefill still matches the
    reference's."""
    upd = dict(d_model=64, n_heads=2, n_kv_heads=1, d_head=128)
    rmodel, rparams, model, params = _models(arch, seed=7, **upd)
    cfg = model.cfg
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, (1, 128)).astype(np.int32)
    img = (rng.standard_normal((1, cfg.n_img_tokens, cfg.d_model))
           .astype(np.float32) if cfg.cross_attn_period else None)
    n0 = len(ops.fa_causal_kernel.stats)
    got, _ = model.prefill(params, torch.from_numpy(tokens),
                           model.init_cache(1, 128), img=_tt(img))
    n_self = (cfg.n_layers // cfg.cross_attn_period
              * (cfg.cross_attn_period - 1) if cfg.cross_attn_period
              else cfg.n_layers)
    assert len(ops.fa_causal_kernel.stats) - n0 == n_self
    want, _ = rmodel.prefill(rparams, jnp.asarray(tokens),
                             rmodel.init_cache(1, 128), img=_j(img))
    _close(got, want)


# ------------------------------------------------------------------- MoE

def _skewed_moe(arch, seed):
    """A MoE layer's params at capacity factor 1.25 and chunk 16, with a
    router that sends most tokens to expert 0, and inputs sharing a mean
    direction the router reads, so buckets overflow and tokens drop."""
    rcfg, cfg = _cfgs(arch)
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, capacity_factor=1.25, chunk=16))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25, chunk=16))
    p = {k: np.array(v) for k, v in repro_moe.init_moe(
        KeyGen(jax.random.PRNGKey(seed)), rcfg).items()}
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(cfg.d_model).astype(np.float32)
    u /= np.linalg.norm(u)
    p["router"][:, 0] += 3.0 * u
    x = (rng.standard_normal((B, 64, cfg.d_model)) + 2.0 * u) \
        .astype(np.float32)
    return rcfg, cfg, p, x


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_with_capacity_drops_matches_repro(arch):
    """S 64 in 4 chunks of 16 at capacity factor 1.25: some (token, k)
    choices overflow their expert's bucket and drop, in the bucket order
    of the reference's exclusive cumsum; output, aux and the gradients of
    x and of every parameter agree."""
    rcfg, cfg, p, x = _skewed_moe(arch, seed=8)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    cap = moe._capacity(cfg.moe, 16)
    _, _, _, sel = moe.route(cfg, tp, tx[:, :16])
    counts = torch.bincount(sel[0].reshape(-1), minlength=cfg.moe.n_routed)
    assert int(counts.max()) > cap, "no bucket overflows: nothing drops"

    def ref_fn(p, x):
        y, aux = repro_moe.moe_ffn(rcfg, p, x)
        return (y * 0.37).sum() + aux["moe_load_balance"] \
            + aux["moe_z_loss"], (y, aux)

    (_, (want, want_aux)), grads = jax.value_and_grad(
        ref_fn, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got, aux = moe.moe_ffn(cfg, tp, tx)
    _close(got, want)
    for k in aux:
        _close(aux[k], want_aux[k])
    ((got * 0.37).sum() + aux["moe_load_balance"]
     + aux["moe_z_loss"]).backward()
    _assert_trees_close({"p": {k: v.grad.numpy() for k, v in tp.items()},
                         "x": tx.grad.numpy()},
                        {"p": grads[0], "x": grads[1]}, GRAD_TOL)


def test_moe_drops_change_the_output():
    """The same inputs at capacity factor n_routed / top_k (every bucket
    holds a whole chunk) give another output: the drops are real."""
    _, cfg, p, x = _skewed_moe("deepseek-moe-16b", seed=9)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_routed / cfg.moe.top_k))
    assert moe._capacity(roomy.moe, 16) >= 16
    with torch.no_grad():
        a, _ = moe.moe_ffn(cfg, tp, torch.from_numpy(x))
        b, _ = moe.moe_ffn(roomy, tp, torch.from_numpy(x))
    assert float((a - b).abs().max()) > 1e-3


# ------------------------------------------------------------------- MLA

def test_mla_decode_matches_forward_and_repro():
    """MLA alone: the absorbed decode of 4 tokens after a 12-token prefill
    equals the expanded forward at those positions and the reference's
    decode; the latent caches agree with the reference's."""
    _mla_decode_vs_repro()


def test_mla_decode_in_cache_blocks_matches_repro(monkeypatch):
    """The same with decode casting the cache 5 positions at a time, so
    the written prefix (13-16 positions) spans 3 and 4 blocks, the last
    one partial."""
    monkeypatch.setattr(mla, "DECODE_BLOCK", 5)
    _mla_decode_vs_repro()


def _mla_decode_vs_repro():
    rcfg, cfg = _cfgs("deepseek-v2-236b")
    jp = mla_params = repro_mla.init_mla(KeyGen(jax.random.PRNGKey(10)),
                                         rcfg)
    tp = tree.tree_map(lambda a: torch.from_numpy(np.array(a)),
                       _np_tree(mla_params))
    rng = np.random.default_rng(10)
    x = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    full = mla.mla_forward(cfg, tp, _t(x))
    _close(full, repro_mla.mla_forward(rcfg, jp, jnp.asarray(x)))
    shapes = mla.init_mla_cache(cfg, 1, B, 20, torch.float32, "cpu")
    ckv, kpe = shapes["c_kv"][0], shapes["k_pe"][0]
    jckv, jkpe = jnp.zeros(ckv.shape), jnp.zeros(kpe.shape)
    out, ckv, kpe = mla.mla_prefill(cfg, tp, _t(x[:, :12]), ckv, kpe)
    want, jckv, jkpe = repro_mla.mla_prefill(rcfg, jp, jnp.asarray(x[:, :12]),
                                             jckv, jkpe)
    _close(out, want)
    for pos in range(12, 16):
        got, ckv, kpe = mla.mla_decode(cfg, tp, _t(x[:, pos:pos + 1]), ckv,
                                       kpe, pos)
        want, jckv, jkpe = repro_mla.mla_decode(
            rcfg, jp, jnp.asarray(x[:, pos:pos + 1]), jckv, jkpe,
            jnp.asarray(pos, jnp.int32))
        _close(got, want)
        _close(got, full[:, pos:pos + 1].detach().numpy())
    _close(ckv, jckv)
    _close(kpe, jkpe)


# --------------------------------------------------------- cross-attention

def test_cross_attention_matches_repro():
    rcfg, cfg = _cfgs("llama-3.2-vision-11b")
    jp = repro_attn.init_cross_attn(KeyGen(jax.random.PRNGKey(11)), rcfg)
    jp = {**jp, "gate": jnp.float32(0.8)}
    tp = {k: _t(v) for k, v in jp.items()}
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)) \
        .astype(np.float32)
    jk, jv = repro_attn.cross_kv(rcfg, jp, jnp.asarray(mem))
    k, v = attn.cross_kv(cfg, tp, _t(mem))
    _close(k, jk)
    _close(v, jv)
    for gated in (True, False):
        _close(attn.cross_attn_forward(cfg, tp, _t(x), k, v, gated=gated),
               repro_attn.cross_attn_forward(rcfg, jp, jnp.asarray(x), jk,
                                             jv, gated=gated))


# ---------------------------------------------------------------- serving

def _requests(cls, cfg, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid, rng.integers(0, cfg.vocab, int(rng.integers(2, 9)),
                                  dtype=np.int32),
                max_new_tokens=int(rng.integers(2, 7)))
            for rid in range(n)]


@pytest.mark.parametrize("arch,mode", [("deepseek-moe-16b", "token"),
                                       ("deepseek-v2-236b", "cohort")])
def test_serve_engine_matches_repro(arch, mode):
    """``ServeEngine(mode="auto")`` picks token mode for deepseek-moe and
    cohort mode for MLA, as the reference's does, and both engines give
    the same run statistics and greedy tokens."""
    rmodel, rparams, model, params = _models(arch, seed=12)
    ref = RefEngine(rmodel, rparams, n_slots=3, max_seq=16)
    port = ServeEngine(model, params, n_slots=3, max_seq=16)
    for r in _requests(RefRequest, model.cfg):
        assert ref.submit(r)
    for r in _requests(Request, model.cfg):
        assert port.submit(r)
    want, got = ref.run(), port.run()
    assert got.mode == want.mode == mode
    for key in ("steps", "occupancy", "cohorts", "inflight_admissions",
                "requests_completed"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.requests_completed == 6
    assert dict(got.items()) == dict(want.items())
