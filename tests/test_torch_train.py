"""The port's training path (``repro_torch.models`` loss, ``optim``,
``data``, ``checkpoint``, ``train``, ``runtime`` and the ``train_lm``
example) against the JAX package's, on the CPU.

Weights come from the reference's ``DecoderLM.init`` through
``params_from_jax``; every other input is drawn with numpy from a seed and
handed to both packages. Two configs: codeqwen1.5-7b reduced to 2 layers
of width 256 with d_head 128, whose attention at seq 128 is flashable (so
``ops.attention`` goes through ``flash_attention.FlashAttentionFn``, its
plain version forward on CPU tensors), and stablelm-1.6b's ``reduced()``
at seq 64 (d_head 16: plain attention). Tolerances, all in float32:

* losses and cross entropy: 1e-5 x max(1, |ref|); both packages sum the
  same chunks in the same order, and differ in a product's summation
  order only;
* gradients, leaf by leaf (the port's per-layer list stacked into the
  reference's (L, ...) leaves): max abs <= 1e-4 x max(1, max|ref leaf|);
  a backward chains twice the forward's products;
* attention gradients (q, k, v): max abs <= 1e-5 x max(1, max|ref|);
* three train steps: losses within 1e-4 relative; parameters within
  2 lr + 1e-6 absolute, since Adam's first steps move a weight by about
  lr x sign(g), which flips where a gradient is near 0;
* the optimiser, schedules and compression on the same arrays: 1e-6
  relative (the int8 codes exactly);
* the data pipeline and the watchdog: identical; checkpoints: the other
  package reads the same manifest and bit-identical arrays.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as repro_load
from repro.checkpoint import save_checkpoint as repro_save
from repro.configs import get_arch as repro_arch
from repro.data import SyntheticTokenDataset as RefDataset
from repro.kernels import ref as repro_ref
from repro.models import build_model as repro_build
from repro.models import common as repro_common
from repro.optim import AdamW as RefAdamW
from repro.optim import clip_by_global_norm as repro_clip
from repro.optim import compress_int8 as repro_compress
from repro.optim import constant_schedule as repro_constant
from repro.optim import cosine_schedule as repro_cosine
from repro.runtime import CrossPodSync as RefCrossPodSync
from repro.runtime import StepWatchdog as RefWatchdog
from repro.train import make_train_step as repro_make_step

from repro_torch import tree
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticTokenDataset, make_batch_iterator
from repro_torch.examples import train_lm
from repro_torch.kernels import flash_attention, ops
from repro_torch.models import build_model, common
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import (AdamW, CompressionState, clip_by_global_norm,
                               compress_int8, compress_tree,
                               constant_schedule, cosine_schedule,
                               decompress_int8, decompress_tree)
from repro_torch.runtime import (CrossPodSync, InjectedFault, StepWatchdog,
                                 TrainDriver)
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(1)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ATTN_GRAD_TOL = 1e-5
STEP_LOSS_RTOL = 1e-4
OPT_RTOL = 1e-6
#: The flashable config (codeqwen at d_head 128) and the plain one.
FLASH_REDUCED = dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=2,
                     d_head=128, d_ff=512, vocab=512)
CONFIGS = {"codeqwen-flash": ("codeqwen1.5-7b", FLASH_REDUCED, 128),
           "stablelm": ("stablelm-1.6b", {}, 64)}


def _cfgs(name):
    arch, red, seq = CONFIGS[name]
    return (repro_arch(arch).reduced(**red), get_arch(arch).reduced(**red),
            seq)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _setup(name, seed=0, batch=2, remat=False):
    """(reference model, its params, port model, port params, numpy
    batch) for one config."""
    rcfg, cfg, seq = _cfgs(name)
    rmodel = repro_build(rcfg, remat=remat)
    rparams = rmodel.init(jax.random.PRNGKey(seed))
    model = build_model(cfg, device="cpu", remat=remat)
    params = params_from_jax(cfg, _np_tree(rparams))
    data = RefDataset(vocab=rcfg.vocab, seq=seq, global_batch=batch,
                      seed=seed + 5).batch(0)
    return rmodel, rparams, model, params, data


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def stack_layers(t):
    """The port's tree with its per-layer list stacked into the
    reference's (L, ...) leaves, as numpy."""
    out = {k: tree.tree_map(lambda x: x.detach().numpy(), v)
           for k, v in t.items() if k != "layers"}
    out["layers"] = tree.tree_map(
        lambda *xs: np.stack([x.detach().numpy() for x in xs]),
        *t["layers"])
    return out


def _assert_trees_close(got: dict, want, tol: float, rel=True) -> None:
    g = dict(tree.leaves_with_paths(got))
    w = dict(tree.leaves_with_paths(_np_tree(want)))
    assert sorted(g) == sorted(w)
    for path in w:
        ref = np.asarray(w[path], np.float64)
        err = np.abs(np.asarray(g[path], np.float64) - ref).max()
        bound = tol * max(1.0, np.abs(ref).max()) if rel else tol
        assert err <= bound, f"{path}: {err} > {bound}"


# ------------------------------------------------------------ the loss ----

@pytest.mark.parametrize("valid_vocab,cap,masked,seq", [
    (None, None, False, 64), (40, None, False, 64), (40, 30.0, True, 64),
    (None, 5.0, True, 48)])
def test_chunked_ce_loss_matches_repro(rng, valid_vocab, cap, masked, seq):
    """Several chunks (chunk 32; seq 48 halves it to 16), the padded
    vocab masked, a final softcap, a token mask; values and gradients."""
    x = rng.standard_normal((2, seq, 32)).astype(np.float32)
    head = rng.standard_normal((32, 48)).astype(np.float32) / 4
    labels = rng.integers(0, valid_vocab or 48, (2, seq)).astype(np.int32)
    mask = ((rng.random((2, seq)) > 0.3).astype(np.float32) if masked
            else None)

    def ref_fn(x, head):
        return repro_common.chunked_ce_loss(
            x, head, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), final_softcap=cap,
            chunk=32, valid_vocab=valid_vocab)

    (want_nll, want_w), vjp = jax.vjp(ref_fn, jnp.asarray(x),
                                      jnp.asarray(head))
    want_gx, want_gh = vjp((jnp.float32(1.0), jnp.float32(0.0)))
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(head).requires_grad_(True)
    nll, w = common.chunked_ce_loss(
        tx, th, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), final_softcap=cap,
        chunk=32, valid_vocab=valid_vocab)
    for got, want in ((nll.detach(), want_nll), (w, want_w)):
        assert abs(float(got) - float(want)) <= LOSS_TOL * max(
            1.0, abs(float(want)))
    nll.backward()
    for got, want in ((tx.grad, want_gx), (th.grad, want_gh)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= GRAD_TOL * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decoder_loss_matches_repro(name):
    rmodel, rparams, model, params, data = _setup(name, seed=1)
    want, wm = rmodel.loss(rparams, {k: jnp.asarray(v)
                                     for k, v in data.items()})
    got, gm = model.loss(params, _tensors(data))
    assert set(gm) == set(wm) == {"ce", "tokens", "loss"}
    for k in gm:
        assert abs(float(gm[k]) - float(wm[k])) <= LOSS_TOL * max(
            1.0, abs(float(wm[k]))), k
    assert float(got) == float(gm["loss"])


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decoder_gradients_match_repro(name, remat):
    """``loss.backward()`` in the port against ``jax.grad`` of the
    reference's loss, leaf by leaf."""
    rmodel, rparams, model, params, data = _setup(name, seed=2,
                                                  remat=remat)
    want = jax.grad(lambda p: rmodel.loss(
        p, {k: jnp.asarray(v) for k, v in data.items()})[0])(rparams)
    for leaf in tree.leaves(params):
        leaf.requires_grad_(True)
    loss, _ = model.loss(params, _tensors(data))
    loss.backward()
    grads = tree.tree_map(lambda p: p.grad, params)
    _assert_trees_close(stack_layers(grads), want, GRAD_TOL)


def test_flash_layers_carry_the_flash_function_in_training():
    """The flashable config's attention output has the Function's
    grad_fn when a gradient is wanted, and none under no_grad; a remat'd
    loss launches the flash builder twice a layer (forward and the
    backward's recompute), a plain one once."""
    _, _, model, params, data = _setup("codeqwen-flash")
    cfg = model.cfg
    B, H, S, D = 2, cfg.n_heads, 128, cfg.d_head
    q, k, v = (torch.randn(B, H, S, D) for _ in range(3))
    q.requires_grad_(True)
    for causal in (True, False):
        assert flash_attention.through_flash_fn(
            ops.attention(q, k, v, causal=causal))
    with torch.no_grad():
        assert ops.attention(q, k, v, causal=True).grad_fn is None
    assert ops.attention(q.detach(), k, v).grad_fn is None

    fa = ops.fa_causal_kernel
    for remat, per_layer in ((False, 1), (True, 2)):
        model.remat = remat
        for leaf in tree.leaves(params):
            leaf.requires_grad_(True)
        n0 = len(fa.stats)
        loss, _ = model.loss(params, _tensors(data))
        loss.backward()
        assert len(fa.stats) - n0 == per_layer * cfg.n_layers, remat


@pytest.mark.parametrize("causal,hq,hkv,s", [
    (True, 4, 4, 128), (True, 4, 2, 128), (False, 4, 4, 128),
    (False, 4, 2, 256), (True, 2, 1, 1024)])
def test_ops_attention_gradient_matches_repro(rng, causal, hq, hkv, s):
    """q, k and v gradients of the flash call against ``jax.grad`` of the
    reference's ``attention_ref``, for a random cotangent; GQA 4/2 and,
    at S 1024, the blockwise plain version in the backward."""
    b, d = (2, 128) if s < 1024 else (1, 128)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    ct = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: repro_ref.attention_ref(
        q, k, v, causal=causal), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = ops.attention(tq, tk, tv, causal=causal)
    assert flash_attention.through_flash_fn(out)
    out.backward(torch.from_numpy(ct))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        w = np.asarray(w)
        err = np.abs(got.numpy() - w).max()
        assert err <= ATTN_GRAD_TOL * max(1.0, np.abs(w).max()), err


# ------------------------------------------------------ the train step ----

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_step_matches_repro(name):
    """Three steps with two microbatches and a warmup-cosine schedule:
    the port's eager step against the reference's jitted one."""
    rmodel, rparams, model, params, _ = _setup(name, seed=3, batch=4)
    rcfg, _, seq = _cfgs(name)
    peak = 3e-3
    ropt = RefAdamW(lr=repro_cosine(peak, warmup=2, total=3))
    opt = AdamW(lr=cosine_schedule(peak, warmup=2, total=3))
    rstate = {"params": rparams, "opt": ropt.init(rparams),
              "step": jnp.zeros((), jnp.int32)}
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    rstep = jax.jit(repro_make_step(rmodel, ropt, microbatches=2))
    step = make_train_step(model, opt, microbatches=2)
    ds = RefDataset(vocab=rcfg.vocab, seq=seq, global_batch=4, seed=11)
    for i in range(3):
        rstate, rm = rstep(rstate, ds.batch(i))
        state, m = step(state, ds.batch(i))
        assert abs(float(m["loss"]) - float(rm["loss"])) <= \
            STEP_LOSS_RTOL * abs(float(rm["loss"]))
        assert abs(float(m["lr"]) - float(rm["lr"])) <= \
            OPT_RTOL * float(rm["lr"])
    assert int(state["step"]) == 3 and int(state["opt"]["count"]) == 3
    _assert_trees_close(stack_layers(state["params"]), rstate["params"],
                        2 * peak + 1e-6, rel=False)


def test_train_step_gives_unread_leaves_zero_gradients_as_repro():
    """whisper-base's decoder never reads its cross blocks' ``gate`` (its
    cross-attention is ungated), so ``jax.grad`` gives them zero and the
    reference's step leaves them at 0; the port's step does the same (it
    raised on them before) and its loss is the reference's."""
    rcfg = repro_arch("whisper-base").reduced()
    cfg = get_arch("whisper-base").reduced()
    rmodel = repro_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(2))
    model = build_model(cfg, device="cpu")
    params = params_from_jax(cfg, _np_tree(rparams))
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, cfg.vocab, (2, 16), np.int32)
             for k in ("tokens", "labels")}
    batch["frames"] = rng.standard_normal(
        (2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    ropt, opt = RefAdamW(), AdamW()
    rstate = {"params": rparams, "opt": ropt.init(rparams),
              "step": jnp.zeros((), jnp.int32)}
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    rstate, rm = jax.jit(repro_make_step(rmodel, ropt))(rstate, batch)
    state, m = make_train_step(model, opt)(state, batch)
    assert abs(float(m["loss"]) - float(rm["loss"])) <= \
        STEP_LOSS_RTOL * abs(float(rm["loss"]))
    assert not np.asarray(rstate["params"]["decoder"]["cross"]["gate"]).any()
    assert all(float(blk["cross"]["gate"]) == 0.0
               for blk in state["params"]["decoder"])


def test_microbatching_matches_full_batch():
    """The reference's test, in the port: one batch of 8 in one piece or
    in 4 microbatches gives the same update."""
    cfg = get_arch("stablelm-1.6b").reduced()
    model = build_model(cfg, device="cpu", remat=True)
    opt = AdamW(lr=constant_schedule(3e-3), weight_decay=0.0)
    ds = SyntheticTokenDataset(vocab=cfg.vocab, seq=64, global_batch=8,
                               seed=0)
    state0 = init_train_state(model, opt, 1)
    s1, _ = make_train_step(model, opt, microbatches=1)(state0, ds.batch(0))
    s4, _ = make_train_step(model, opt, microbatches=4)(state0, ds.batch(0))
    for (path, a), b in zip(tree.leaves_with_paths(s1["params"]),
                            tree.leaves(s4["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-4, err_msg=path)
    # the step left its input state as it was
    assert int(state0["step"]) == 0 and int(state0["opt"]["count"]) == 0


def test_train_step_ticks_online_during_warmup():
    class FakeTuner:
        ticks = 0

        def tick(self):
            self.ticks += 1
            return 0

    class TinyModel:
        device = torch.device("cpu")

        def loss(self, params, batch):
            loss = (params["w"] ** 2).sum() + batch["x"].sum()
            return loss, {"loss": loss}

    svc = FakeTuner()
    opt = AdamW(lr=1e-2)
    params = {"w": torch.ones(4)}
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step_fn = make_train_step(TinyModel(), opt, online=svc,
                              online_warmup_steps=2)
    for _ in range(4):
        state, _ = step_fn(state, {"x": np.ones((2, 2), np.float32)})
    assert svc.ticks == 2


# ------------------------------------------------------------- optim ----

def _grad_tree(rng, scale=1.0):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32) * scale,
            "b": {"x": rng.standard_normal(7).astype(np.float32) * scale}}


def _t_tree(t):
    return tree.tree_map(torch.from_numpy, t)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adamw_matches_repro(rng, clip):
    """Four updates on the same parameters and gradients (scaled past the
    clip norm), weight decay on, a cosine schedule."""
    params = _grad_tree(rng)
    kw = dict(lr=None, weight_decay=0.1, clip_norm=clip)
    ropt = RefAdamW(**(kw | {"lr": repro_cosine(1e-2, 2, 4)}))
    opt = AdamW(**(kw | {"lr": cosine_schedule(1e-2, 2, 4)}))
    rp, rs = jax.tree_util.tree_map(jnp.asarray, params), None
    p, s = _t_tree(params), None
    rs, s = ropt.init(rp), opt.init(p)
    for i in range(4):
        g = _grad_tree(rng, scale=3.0)
        rp, rs, rm = ropt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 rs, rp)
        p, s, m = opt.update(_t_tree(g), s, p)
        for k in ("grad_norm", "lr"):
            assert math.isclose(float(m[k]), float(rm[k]),
                                rel_tol=OPT_RTOL, abs_tol=1e-12), k
    for got, want in ((p, rp), (s["m"], rs["m"]), (s["v"], rs["v"])):
        _assert_trees_close(tree.tree_map(lambda x: x.numpy(), got), want,
                            OPT_RTOL)
    assert int(s["count"]) == int(rs["count"]) == 4


def test_clip_by_global_norm_matches_repro(rng):
    g = _grad_tree(rng, scale=2.0)
    want, wn = repro_clip(jax.tree_util.tree_map(jnp.asarray, g), 1.5)
    got, gn = clip_by_global_norm(_t_tree(g), 1.5)
    assert math.isclose(float(gn), float(wn), rel_tol=OPT_RTOL)
    _assert_trees_close(tree.tree_map(lambda x: x.numpy(), got), want,
                        OPT_RTOL)


@pytest.mark.parametrize("kind", ["constant", "cosine"])
def test_schedules_match_repro(kind):
    if kind == "constant":
        want, got = repro_constant(3e-4), constant_schedule(3e-4)
    else:
        want, got = repro_cosine(3e-4, 5, 40), cosine_schedule(3e-4, 5, 40)
    for c in range(0, 45):
        w = float(want(jnp.asarray(c, jnp.int32)))
        g = float(got(torch.tensor(c, dtype=torch.int32)))
        assert math.isclose(g, w, rel_tol=OPT_RTOL, abs_tol=1e-12), c


@pytest.mark.parametrize("with_residual", [False, True])
def test_compress_int8_matches_repro(rng, with_residual):
    g = rng.standard_normal((33, 17)).astype(np.float32)
    r = (rng.standard_normal((33, 17)).astype(np.float32) * 0.01
         if with_residual else None)
    wq, ws, we = repro_compress(jnp.asarray(g),
                                None if r is None else jnp.asarray(r))
    q, s, e = compress_int8(torch.from_numpy(g),
                            None if r is None else torch.from_numpy(r))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    assert math.isclose(float(s), float(ws), rel_tol=OPT_RTOL)
    np.testing.assert_allclose(e.numpy(), np.asarray(we), rtol=OPT_RTOL,
                               atol=OPT_RTOL * float(ws))
    np.testing.assert_allclose(decompress_int8(q, s).numpy(),
                               np.asarray(wq, np.float32) * float(ws),
                               rtol=OPT_RTOL)


def test_compress_tree_carries_error_feedback(rng):
    g = _t_tree(_grad_tree(rng))
    state = CompressionState.init(g)
    qs, scales, state = compress_tree(g, state)
    back = decompress_tree(qs, scales)
    for a, b, e in zip(tree.leaves(g), tree.leaves(back),
                       tree.leaves(state.residual)):
        torch.testing.assert_close(b + e, a, rtol=0, atol=1e-6)


def test_crosspod_sync_matches_repro(rng):
    """Two pods' divergent deltas: the same anchor, agreement after the
    sync, and the same stats; then 20 syncs of sub-step deltas, whose
    error feedback keeps them, as in the reference's test."""
    base = _grad_tree(rng)
    rsync, sync = RefCrossPodSync(n_pods=2, inner_steps=4), \
        CrossPodSync(n_pods=2, inner_steps=4)
    rpods = rsync.init(jax.tree_util.tree_map(jnp.asarray, base))
    pods = sync.init(_t_tree(base))
    d = [_grad_tree(rng, scale=0.01), _grad_tree(rng, scale=0.03)]
    for i in range(2):
        rpods[i] = jax.tree_util.tree_map(lambda p, x: p + x, rpods[i],
                                          jax.tree_util.tree_map(
                                              jnp.asarray, d[i]))
        pods[i] = tree.tree_map(lambda p, x: p + torch.from_numpy(x),
                                pods[i], d[i])
    ranchor, _, rstats = rsync.sync(
        jax.tree_util.tree_map(jnp.asarray, base), rpods)
    anchor, new_pods, stats = sync.sync(_t_tree(base), pods)
    assert stats == rstats and stats["compression"] > 3.0
    _assert_trees_close(tree.tree_map(lambda x: x.numpy(), anchor), ranchor,
                        OPT_RTOL)
    for a, b in zip(tree.leaves(new_pods[0]), tree.leaves(new_pods[1])):
        assert torch.equal(a, b)
    assert sync.should_sync(8) and not sync.should_sync(6)

    one = CrossPodSync(n_pods=1, inner_steps=1)
    anchor = {"w": torch.zeros(16)}
    pods = one.init(anchor)
    for step in range(20):
        delta = torch.full((16,), 1e-4)
        delta[0] = 1.0 if step == 0 else 0.0
        pods[0] = {"w": anchor["w"] + delta}
        anchor, pods, _ = one.sync(anchor, pods)
    np.testing.assert_allclose(anchor["w"][1:].numpy(), np.full(15, 20e-4),
                               rtol=0.2)


# -------------------------------------------------------------- data ----

@pytest.mark.parametrize("seed,step,hosts,host", [
    (0, 0, 1, 0), (17, 5, 1, 0), (3, 41, 2, 1), (9, 7, 4, 2)])
def test_dataset_batches_are_byte_identical(seed, step, hosts, host):
    kw = dict(vocab=300, seq=48, global_batch=8, seed=seed, num_hosts=hosts,
              host_id=host)
    want, got = RefDataset(**kw).batch(step), \
        SyntheticTokenDataset(**kw).batch(step)
    assert set(got) == set(want) == {"tokens", "labels", "mask"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


def test_batch_iterator_addresses_steps():
    ds = SyntheticTokenDataset(vocab=64, seq=8, global_batch=2, seed=1)
    it = make_batch_iterator(ds, start_step=3)
    for want_step in (3, 4):
        step, b = next(it)
        assert step == want_step
        assert b["tokens"].tobytes() == ds.batch(step)["tokens"].tobytes()
    with pytest.raises(ValueError):
        SyntheticTokenDataset(vocab=64, seq=8, global_batch=3, num_hosts=2)


# ----------------------------------------------------------- watchdog ----

def test_watchdog_matches_repro(rng):
    """The same durations (two workers, straggles and a hang) give the
    same reports, suspects, deadlines and hang verdicts."""
    durations = [(i, 1.0 + 0.05 * rng.random(), i % 2) for i in range(20)]
    durations += [(20, 1.8, 1), (21, 30.0, 0), (22, 1.0, 1), (23, 2.5, 1),
                  (24, 2.6, 1)]
    ref, port = RefWatchdog(min_samples=5), StepWatchdog(min_samples=5)
    for step, d, w in durations:
        a, b = ref.record(step, d, worker=w), port.record(step, d, worker=w)
        assert (a is None) == (b is None)
        assert a is None or a.__dict__ == b.__dict__
    assert [r.__dict__ for r in port.reports] == \
        [r.__dict__ for r in ref.reports]
    assert port.suspects() == ref.suspects()
    assert port.deadline() == ref.deadline()
    for t in (2.0, 25.0):
        assert port.is_hang(t) == ref.is_hang(t)
    assert [r.kind for r in port.reports] == ["straggle", "hang", "straggle",
                                              "straggle"]


# --------------------------------------------------------- checkpoint ----

def _mixed_state(rng):
    """f32, bf16 and int32 leaves, nested dicts and a per-layer list."""
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    return {"params": {"w": torch.from_numpy(
                           rng.standard_normal((4, 6)).astype(np.float32)),
                       "emb": torch.from_numpy(bf).to(torch.bfloat16),
                       "layers": [{"a": torch.full((2,), float(i))}
                                  for i in range(2)]},
            "opt": {"count": torch.tensor(3, dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_port_checkpoint_reads_in_repro(rng, tmp_path):
    state = _mixed_state(rng)
    save_checkpoint(tmp_path, 7, state, {"note": "x"})
    manifest, arrays = repro_load(tmp_path)
    assert manifest["step"] == 7 and manifest["extra"] == {"note": "x"}
    assert [r["path"] for r in manifest["leaves"]] == [
        "opt/count", "params/emb", "params/layers/0/a", "params/layers/1/a",
        "params/w", "step"]
    assert [r["dtype"] for r in manifest["leaves"]] == [
        "int32", "bfloat16", "float32", "float32", "float32", "int32"]
    for a, t in zip(arrays, tree.leaves(state)):
        assert a.shape == tuple(t.shape)
        if t.dtype == torch.bfloat16:
            assert a.tobytes() == t.view(torch.int16).numpy().tobytes()
        else:
            np.testing.assert_array_equal(a, t.numpy())


def test_repro_checkpoint_reads_in_port(rng, tmp_path):
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    state = {"params": {"w": jnp.asarray(bf), "emb": jnp.asarray(
                 bf.astype(ml_dtypes.bfloat16))},
             "step": jnp.asarray(4, jnp.int32)}
    repro_save(tmp_path, 4, state)
    like = {"params": {"w": torch.empty((3, 5), device="meta"),
                       "emb": torch.empty((3, 5), dtype=torch.bfloat16,
                                          device="meta")},
            "step": torch.empty((), dtype=torch.int32, device="meta")}
    got, manifest = load_checkpoint(tmp_path, like=like, device="cpu")
    assert manifest["step"] == 4
    assert got["params"]["emb"].dtype == torch.bfloat16
    want = np.asarray(state["params"]["emb"]).view(np.int16)
    np.testing.assert_array_equal(
        got["params"]["emb"].view(torch.int16).numpy(), want)
    np.testing.assert_array_equal(got["params"]["w"].numpy(), bf)
    assert int(got["step"]) == 4
    raw_manifest, raw = load_checkpoint(tmp_path)
    assert raw_manifest == manifest and len(raw) == 3


def test_checkpoint_atomicity_and_latest(rng, tmp_path):
    save_checkpoint(tmp_path, 5, _mixed_state(rng))
    assert not list(tmp_path.glob("*.tmp"))
    bad = tmp_path / "step-00000009.tmp"
    bad.mkdir()
    (bad / "leaf-00000.npy").write_bytes(b"garbage")
    assert latest_step(tmp_path) == 5
    assert latest_step(tmp_path / "missing") is None


def test_checkpoint_keep_k(rng, tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, save_every=1)
    for s in range(1, 6):
        mgr.save(s, _mixed_state(rng))
    steps = sorted(int(p.name.split("-")[1]) for p in tmp_path.iterdir())
    assert steps == [4, 5] and mgr.latest_step() == 5
    assert mgr.should_save(3) and not mgr.should_save(0)


def test_checkpoint_rejects_mismatch_and_shardings(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(tmp_path, like={"w": torch.zeros((3, 3))})
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(tmp_path, like={"w": torch.zeros((2, 2)),
                                        "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="shardings"):
        load_checkpoint(tmp_path, like={"w": torch.zeros((2, 2))},
                        shardings={"w": None})
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "none")


# ------------------------------------------------------------ driver ----

def _tiny(seed=0):
    cfg = get_arch("stablelm-1.6b").reduced()
    model = build_model(cfg, device="cpu", remat=True)
    opt = AdamW(lr=constant_schedule(3e-3), weight_decay=0.0)
    ds = SyntheticTokenDataset(vocab=cfg.vocab, seq=64, global_batch=8,
                               seed=seed)
    return model, opt, ds


def test_loss_decreases():
    """The reference's bound, over 40 steps of the port."""
    model, opt, ds = _tiny()
    step_fn = make_train_step(model, opt)
    state = init_train_state(model, opt, 0)
    losses = []
    for step in range(40):
        state, metrics = step_fn(state, ds.batch(step))
        losses.append(float(metrics["loss"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.25, f"no learning: {first:.3f} -> {last:.3f}"


def test_crash_resume_bit_exact(tmp_path):
    def build(dir_, fault=None):
        model, opt, ds = _tiny(seed=3)
        return TrainDriver(
            model=model, optimizer=opt,
            train_step=make_train_step(model, opt),
            dataset=ds, ckpt=CheckpointManager(dir_, keep=3, save_every=5),
            total_steps=12, watchdog=StepWatchdog(), fault_injector=fault,
            log_every=100)

    ref = build(tmp_path / "ref").run(42)

    def bomb(step):
        if step == 8:
            raise InjectedFault("simulated node failure")

    crash = tmp_path / "crash"
    with pytest.raises(InjectedFault):
        build(crash, fault=bomb).run(42)
    assert CheckpointManager(crash).latest_step() == 5
    resumed = build(crash).run(42)
    assert [h["step"] for h in resumed["history"]] == list(range(5, 12))
    for (path, a), b in zip(tree.leaves_with_paths(ref["state"]),
                            tree.leaves(resumed["state"])):
        assert torch.equal(a, b), path
    assert resumed["final_checkpoint"].endswith("step-00000012")


# ----------------------------------------------------------- example ----

def test_train_lm_example_runs_on_cpu(tmp_path, capsys):
    out = train_lm.main(["--device", "cpu", "--steps", "3", "--batch", "4",
                         "--seq", "64", "--ckpt-dir", str(tmp_path)])
    assert len(out["history"]) == 3
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert latest_step(tmp_path) == 3
    assert "final checkpoint" in capsys.readouterr().out


def test_train_lm_example_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the test is of one without")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])


#: A fresh interpreter: a reduced codeqwen (remat) trained 2 steps of 2
#: microbatches by ``TrainDriver`` with the cycle collector off; prints
#: whether a parameter and an AdamW moment of the dropped state survive.
_DROPPED_STATE = r"""
import gc, sys, weakref
import torch
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticTokenDataset
from repro_torch.models import build_model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime import TrainDriver
from repro_torch.train import make_train_step
from repro_torch.tree import leaves

gc.disable()
cfg = get_arch("codeqwen1.5-7b").reduced()
model = build_model(cfg, device="cpu", remat=True)
opt = AdamW(lr=cosine_schedule(3e-4, 2, 10))
driver = TrainDriver(
    model=model, optimizer=opt,
    train_step=make_train_step(model, opt, microbatches=2),
    dataset=SyntheticTokenDataset(vocab=cfg.vocab, seq=32, global_batch=4,
                                  seed=1),
    ckpt=CheckpointManager(sys.argv[1], keep=1, save_every=1),
    total_steps=2, log_every=10)
run = driver.run(0)
refs = [weakref.ref(leaves(run["state"]["params"])[0]),
        weakref.ref(leaves(run["state"]["opt"])[-1])]
del run, driver
print([r() is not None for r in refs])
"""


def test_a_dropped_train_state_is_freed_without_the_cycle_collector(
        tmp_path):
    """Reference counts alone free a dropped train state, as they do in
    the reference, with the cycle collector off from the start of a fresh
    interpreter: no reference cycle holds its tensors (a recursive closure
    in ``tree.unflatten`` held the values it rebuilt; torch's lazy import
    of ``torch._dynamo`` on the first ``torch.utils.checkpoint`` call
    pinned the calling frames, the train step's among them)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in ("src", os.environ.get("PYTHONPATH")) if p),
        OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", _DROPPED_STATE,
                        str(tmp_path / "ckpt")], env=env, text=True,
                       capture_output=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[False, False]", p.stdout
