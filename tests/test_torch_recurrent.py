"""The port's recurrent and encoder-decoder families
(``repro_torch.models``: mamba+attn, RWKV-6 and ``EncDecLM``) against the
JAX package's.

Three architectures, each at a reduced config in float32 on the CPU:
hymba-1.5b (3 layers, the middle one sliding-window), rwkv6-7b (2 layers)
and whisper-base (2 encoder and 2 decoder layers over 16 frames). Weights
come from the reference's ``init`` and cross through
``repro_torch.models.convert.params_from_jax``; tokens and frames are
drawn with numpy from a seed.

The reference initialises some parameters to constants that hide a
wrong port: rwkv's ``mu`` and ``mu_c`` (0: ``_mix`` returns x, so a
wrong token shift never shows), ``bonus`` and ``decay_base`` (0), and
``ln_x.scale`` (1); mamba's ``A_log`` and ``dt_bias`` (0) and ``D_skip``
(1). :func:`redraw` replaces them, in the reference's tree before the
conversion, so both packages get the same values: uniform [0, 1) for
``mu`` and ``mu_c``; normal x 0.5 for ``bonus``, ``decay_base``,
``dt_bias`` and ``A_log``; 1 + normal x 0.1 for ``ln_x.scale`` and
``D_skip``.

Tolerance: max abs error <= 1e-4 x max(1, max|ref|) on outputs, logits,
states, caches, losses and gradients (leaf by leaf): each package rounds
a dozen float32 products, scans and norms in its own order. The mamba
scan is a Hillis-Steele scan in the port and ``lax.associative_scan`` in
the reference: the same products, associated differently.

The reference's functions run under ``jax.jit``: eager dispatch compiles
each primitive for each shape, which costs more here than one compile of
the whole function.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as repro_arch
from repro.configs import list_archs as repro_list_archs
from repro.models import build_model as repro_build
from repro.models import mamba as repro_mamba
from repro.models import rwkv as repro_rwkv
from repro.models.common import KeyGen
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine

from repro_torch import tree
from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels import flash_attention
from repro_torch.models import EncDecLM, build_model, mamba, rwkv
from repro_torch.models.config import PORT_ONLY_FIELDS
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Request, ServeEngine

torch.set_num_threads(1)
TOL = 1e-4
#: Each architecture's reduced config: hymba's 3 layers have windows
#: (full, 8, full), so layer 1 slides over the 16-token prompt.
RECURRENT = {"hymba-1.5b": dict(n_layers=3), "rwkv6-7b": dict(n_layers=2),
             "whisper-base": dict(n_layers=2)}
ARCHS = sorted(RECURRENT)
B, S = 2, 16
#: The full configs' element counts (``jax.eval_shape`` of the
#: reference's init).
FULL_PARAMS = {"hymba-1.5b": 1_642_497_600, "rwkv6-7b": 7_534_546_944,
               "whisper-base": 92_420_102}


def _bound(want) -> float:
    return TOL * max(1.0, float(np.abs(np.asarray(want, np.float64)).max()))


def _close(got, want) -> None:
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    g, w = np.asarray(g, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    err = float(np.abs(g - w).max()) if w.size else 0.0
    assert err <= _bound(w), f"max abs err {err} > {_bound(w)}"


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _assert_trees_close(got: dict, want) -> None:
    g = dict(tree.leaves_with_paths(tree.tree_map(
        lambda t: t.detach().numpy() if isinstance(t, torch.Tensor) else t,
        got)))
    w = dict(tree.leaves_with_paths(_np_tree(want)))
    assert sorted(g) == sorted(w)
    for path in w:
        try:
            _close(g[path], w[path])
        except AssertionError as e:
            raise AssertionError(f"{path}: {e}") from None


def redraw(params, seed: int):
    """The reference's (numpy) tree with the zero- and one-initialised
    recurrent parameters redrawn from ``seed`` (module docstring)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        a = np.asarray(a)
        name = path[-1]
        if name in ("mu", "mu_c"):
            return rng.uniform(0.0, 1.0, a.shape).astype(a.dtype)
        if name in ("bonus", "decay_base", "dt_bias", "A_log"):
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name == "D_skip" or path[-2:] == ("ln_x", "scale"):
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return np.array(a)

    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, (*path, k)) for k, v in t.items()}
        return draw(path, t)

    return walk(_np_tree(params))


def stack_like_reference(t: dict) -> dict:
    """The port's tree with its per-layer lists (``layers``; whisper's
    ``encoder`` and ``decoder``) stacked into the reference's leaves."""
    def np_(x):
        return x.detach().numpy() if isinstance(x, torch.Tensor) else x

    out = {}
    for k, v in t.items():
        if isinstance(v, list):
            out[k] = tree.tree_map(lambda *xs: np.stack([np_(x) for x in xs]),
                                   *v)
        else:
            out[k] = tree.tree_map(np_, v)
    return out


# ------------------------------------------------------------- fixtures

class Pair:
    """One architecture in both packages: the reference's model and its
    (redrawn) params, the port's config and the params converted."""

    def __init__(self, arch: str, seed: int):
        red = RECURRENT[arch]
        self.rcfg = repro_arch(arch).reduced(**red)
        self.cfg = get_arch(arch).reduced(**red)
        self.rmodel = repro_build(self.rcfg)
        self.np_params = redraw(jax.jit(self.rmodel.init)(
            jax.random.PRNGKey(seed)), seed)
        self.rparams = jax.tree_util.tree_map(jnp.asarray, self.np_params)
        self.model = build_model(self.cfg, device="cpu")
        self.params = self.port_params()
        rng = np.random.default_rng(seed)
        self.tokens = rng.integers(0, self.cfg.vocab, (B, S + 2)) \
            .astype(np.int32)
        self.frames = (rng.standard_normal((B, self.cfg.enc_seq,
                                            self.cfg.d_model))
                       .astype(np.float32) if self.cfg.enc_dec else None)

    def port_params(self) -> dict:
        return params_from_jax(self.cfg, self.np_params)

    def extra(self, jax_side: bool) -> dict:
        """The frames keyword of whisper's entry points."""
        if self.frames is None:
            return {}
        return {"frames": jnp.asarray(self.frames) if jax_side
                else torch.from_numpy(self.frames)}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request) -> Pair:
    return Pair(request.param, seed=ARCHS.index(request.param))


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
def test_configs_are_the_reference_configs(arch):
    assert _fields(get_arch(arch)) == _fields(repro_arch(arch))
    assert _fields(get_arch(arch).reduced()) == \
        _fields(repro_arch(arch).reduced())


def test_list_archs_is_the_references():
    assert list_archs() == repro_list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_element_count_on_meta(arch):
    """The full config on ``meta``: the port's element count, leaf count
    and dtypes equal those of ``jax.eval_shape`` of the reference's
    init."""
    cfg = get_arch(arch)
    model = build_model(cfg, device="meta")
    assert isinstance(model, EncDecLM) == cfg.enc_dec
    params = model.init()
    leaves = tree.leaves(params)
    assert all(t.device.type == "meta" for t in leaves)
    shapes = jax.eval_shape(repro_build(repro_arch(arch)).init,
                            jax.random.PRNGKey(0))
    want = jax.tree_util.tree_leaves(shapes)
    n = sum(t.numel() for t in leaves)
    assert n == sum(int(np.prod(s.shape)) for s in want) == FULL_PARAMS[arch]
    assert len(tree.leaves(stack_like_reference(tree.tree_map(
        lambda t: np.empty((0,)), params)))) == len(want)
    assert sorted({str(t.dtype).removeprefix("torch.") for t in leaves}) \
        == sorted({str(s.dtype) for s in want})


# ----------------------------------------------------------------- mamba

def test_chunk_rule_halves_until_it_divides():
    assert [mamba.chunk_len(s) for s in (16, 200, 256, 320, 1000, 2048)] \
        == [16, 8, 128, 64, 8, 128]


def _mamba_case(S_, seed):
    rcfg = repro_arch("hymba-1.5b").reduced()
    cfg = get_arch("hymba-1.5b").reduced()
    p = redraw(jax.jit(lambda k: repro_mamba.init_mamba(KeyGen(k), rcfg))(
        jax.random.PRNGKey(seed)), seed)
    x = np.random.default_rng(seed).standard_normal(
        (B, S_ + 3, cfg.d_model)).astype(np.float32)
    return rcfg, cfg, p, x


@pytest.mark.parametrize("S_", [16, 200, 256])
def test_mamba_matches_repro(S_):
    """``mamba_forward``, ``mamba_prefill`` (out, final state, conv
    window) and 3 ``mamba_decode`` steps after it. S 16 is one chunk of
    16, 200 halves the chunk to 8 (25 chunks), 256 runs 2 chunks of 128:
    the state crosses chunk boundaries. The decode steps also equal the
    port's forward over the S + 3 tokens."""
    rcfg, cfg, p, x = _mamba_case(S_, seed=S_)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    prefill = jax.jit(functools.partial(repro_mamba.mamba_prefill, rcfg))
    decode = jax.jit(functools.partial(repro_mamba.mamba_decode, rcfg))
    got = mamba.mamba_prefill(cfg, tp, tx[:, :S_])
    want = prefill(jp, jx[:, :S_])
    _close(mamba.mamba_forward(cfg, tp, tx[:, :S_]), want[0])
    for g, w in zip(got, want, strict=True):
        _close(g, w)
    _, h, win = got
    _, jh, jwin = want
    full = mamba.mamba_forward(cfg, tp, tx)
    for t in range(S_, S_ + 3):
        out, h, win = mamba.mamba_decode(cfg, tp, tx[:, t:t + 1], h, win)
        jout, jh, jwin = decode(jp, jx[:, t:t + 1], jh, jwin)
        _close(out, jout)
        _close(out, full[:, t:t + 1].detach().numpy())
    _close(h, jh)
    _close(win, jwin)


# ------------------------------------------------------------------ rwkv

def _rwkv_case(seed):
    rcfg = repro_arch("rwkv6-7b").reduced()
    cfg = get_arch("rwkv6-7b").reduced()
    p = redraw(jax.jit(lambda k: repro_rwkv.init_rwkv(KeyGen(k), rcfg))(
        jax.random.PRNGKey(seed)), seed)
    x = np.random.default_rng(seed).standard_normal(
        (B, S + 3, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = tree.tree_map(torch.from_numpy, p)
    return rcfg, cfg, jp, tp, jnp.asarray(x), torch.from_numpy(x)


def test_rwkv_time_mix_matches_repro():
    """``rwkv_time_mix``, its prefill (out, wkv state, shift) and 3
    decode steps after it, which also equal the forward over the S + 3
    tokens."""
    rcfg, cfg, jp, tp, jx, tx = _rwkv_case(seed=5)
    prefill = jax.jit(functools.partial(repro_rwkv.rwkv_time_mix_prefill,
                                        rcfg))
    decode = jax.jit(functools.partial(repro_rwkv.rwkv_time_mix_decode,
                                       rcfg))
    got = rwkv.rwkv_time_mix_prefill(cfg, tp, tx[:, :S])
    want = prefill(jp, jx[:, :S])
    _close(rwkv.rwkv_time_mix(cfg, tp, tx[:, :S]), want[0])
    for g, w in zip(got, want, strict=True):
        _close(g, w)
    _, h, prev = got
    _, jh, jprev = want
    full = rwkv.rwkv_time_mix(cfg, tp, tx)
    for t in range(S, S + 3):
        out, h, prev = rwkv.rwkv_time_mix_decode(cfg, tp, tx[:, t:t + 1], h,
                                                 prev)
        jout, jh, jprev = decode(jp, jx[:, t:t + 1], jh, jprev)
        _close(out, jout)
        _close(out, full[:, t:t + 1].detach().numpy())
    _close(h, jh)
    _close(prev, jprev)


def test_rwkv_channel_mix_matches_repro():
    rcfg, cfg, jp, tp, jx, tx = _rwkv_case(seed=6)
    prefill = jax.jit(functools.partial(repro_rwkv.rwkv_channel_mix_prefill,
                                        rcfg))
    got, prev = rwkv.rwkv_channel_mix_prefill(cfg, tp, tx[:, :S])
    want, jprev = prefill(jp, jx[:, :S])
    _close(rwkv.rwkv_channel_mix(cfg, tp, tx[:, :S]), want)
    _close(got, want)
    _close(prev, jprev)
    got, prev = rwkv.rwkv_channel_mix_decode(cfg, tp, tx[:, S:S + 1], prev)
    want, jprev = jax.jit(functools.partial(
        repro_rwkv.rwkv_channel_mix_decode, rcfg))(jp, jx[:, S:S + 1], jprev)
    _close(got, want)
    _close(prev, jprev)


# Before the DTensor rewrites (F.pad shifts, a (B*H) ``bmm`` loop): the
# port's own formulas, kept here as the oracle the rewrites equal bit for
# bit on plain tensors.
def _shift_with_pad(x):
    return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]


def _wkv_scan_flat(u, r, k, v, w):
    B, S_, H, hd = r.shape
    bonus = (r * u * k).sum(-1, keepdim=True) * v
    r, k, v, w = (a.transpose(0, 1).reshape(S_, B * H, hd)
                  for a in (r, k, v, w))
    h = torch.zeros((B * H, hd, hd), dtype=torch.float32)
    ys = []
    for s0 in range(0, S_, rwkv.WKV_CHUNK):
        sl = slice(s0, s0 + rwkv.WKV_CHUNK)
        kv = (k[sl, :, :, None] * v[sl, :, None, :]).unbind(0)
        for r_t, kv_t, w_t in zip(r[sl, :, None, :].unbind(0), kv,
                                  w[sl, :, :, None].unbind(0)):
            ys.append(torch.bmm(r_t, h))
            h = torch.addcmul(kv_t, w_t, h)
    y = torch.stack(ys).reshape(S_, B, H, hd).transpose(0, 1)
    return h.reshape(B, H, hd, hd), y + bonus


def _wkv_step_einsum(u, h, r_t, k_t, v_t, w_t):
    kv = k_t[..., :, None] * v_t[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r_t, h + u[..., :, None] * kv)
    return w_t[..., :, None] * h + kv, y


def _scan_chunk_with_pad(h0, xq, bq, cq, dtq, A):
    F = torch.nn.functional
    a = torch.exp(dtq[..., None] * A)
    b = (dtq * xq)[..., None] * bq[:, :, None, :]
    d = 1
    while d < a.shape[1]:
        a_prev = F.pad(a[:, :-d], (0, 0, 0, 0, d, 0), value=1.0)
        b_prev = F.pad(b[:, :-d], (0, 0, 0, 0, d, 0))
        b = torch.addcmul(b, a, b_prev)
        a = a * a_prev
        d *= 2
    h = torch.addcmul(b, a, h0[:, None])
    return h[:, -1], torch.einsum("bqdn,bqn->bqd", h, cq)


def test_shift_pad_and_wkv_rewrites_equal_the_pads_and_bmm_bit_for_bit():
    """rwkv's ``_shift`` (a cat of a zero row), its wkv scan in
    ``trip_count.scan`` chunks (130 tokens: two whole chunks of 64 and a
    tail of 2) and its decode step (per shard on a mesh), and mamba's
    conv and scan pads (cats of zero and one slices) give the same bits
    as the F.pad and whole-sequence (B*H) ``bmm`` forms they replace, and
    the reference's shift and wkv step to float32 rounding."""
    rng = np.random.default_rng(11)
    f32 = np.float32
    x = torch.from_numpy(rng.standard_normal((B, 130, 64)).astype(f32))
    assert torch.equal(rwkv._shift(x), _shift_with_pad(x))
    _close(rwkv._shift(x), repro_rwkv._shift(jnp.asarray(x.numpy())))
    r, k, v = (torch.from_numpy(rng.standard_normal((B, 130, 4, 16))
                                .astype(f32)) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.5, 1.0, (B, 130, 4, 16)).astype(f32))
    u = torch.from_numpy(rng.standard_normal((4, 16)).astype(f32))
    for g, want in zip(rwkv._wkv_scan(u, r, k, v, w),
                       _wkv_scan_flat(u, r, k, v, w), strict=True):
        assert torch.equal(g, want)
    h = torch.from_numpy(rng.standard_normal((B, 4, 16, 16)).astype(f32))
    step = (u[None], h, r[:, 0], k[:, 0], v[:, 0], w[:, 0])
    got = rwkv._wkv_step(*step)
    for g, want, ref in zip(got, _wkv_step_einsum(*step), repro_rwkv._wkv_step(
            *(jnp.asarray(t.numpy()) for t in step)), strict=True):
        assert torch.equal(g, want)
        _close(g, ref)
    p = {"conv_w": torch.from_numpy(rng.standard_normal((4, 32))
                                    .astype(f32))}
    xp = torch.from_numpy(rng.standard_normal((B, 20, 32)).astype(f32))
    w_ = p["conv_w"]
    padded = torch.nn.functional.pad(xp, (0, 0, 3, 0))
    want = torch.nn.functional.silu(sum(padded[:, i:i + 20] * w_[3 - i]
                                        for i in range(4)))
    assert torch.equal(mamba._conv(p, xp), want)
    h0 = torch.from_numpy(rng.standard_normal((B, 32, 4)).astype(f32))
    xq = torch.from_numpy(rng.standard_normal((B, 16, 32)).astype(f32))
    bq, cq = (torch.from_numpy(rng.standard_normal((B, 16, 4)).astype(f32))
              for _ in range(2))
    dtq = torch.from_numpy(rng.uniform(0.01, 0.1, (B, 16, 32)).astype(f32))
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, (32, 4)).astype(f32))
    for g, want in zip(mamba._scan_chunk(h0, xq, bq, cq, dtq, A),
                       _scan_chunk_with_pad(h0, xq, bq, cq, dtq, A),
                       strict=True):
        assert torch.equal(g, want)


def test_group_norm_uses_the_population_variance():
    rng = np.random.default_rng(7)
    y = rng.standard_normal((B, 3, 4, 16)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    _close(rwkv._group_norm({"ln_x": {"scale": torch.from_numpy(scale)}},
                            torch.from_numpy(y)),
           repro_rwkv._group_norm({"ln_x": {"scale": jnp.asarray(scale)}},
                                  jnp.asarray(y)))


# ----------------------------------------------------------- whole model

def test_forward_matches_repro(pair):
    tokens = pair.tokens[:, :S]
    x_ref, aux_ref = jax.jit(pair.rmodel.forward)(
        pair.rparams, jnp.asarray(tokens), **pair.extra(True))
    x, aux = pair.model.forward(pair.params, torch.from_numpy(tokens),
                                **pair.extra(False))
    _close(x, x_ref)
    _close(pair.model._head(pair.params, x),
           pair.rmodel._head(pair.rparams, x_ref))
    assert sorted(aux) == sorted(aux_ref)
    for k in aux:
        _close(aux[k], aux_ref[k])


def _batch(pair, jax_side: bool) -> dict:
    tokens = pair.tokens[:, :S]
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if pair.frames is not None:
        batch["frames"] = pair.frames
    conv = jnp.asarray if jax_side else torch.from_numpy
    return {k: conv(v) for k, v in batch.items()}


def test_loss_and_metrics_match_repro(pair):
    want, wm = jax.jit(pair.rmodel.loss)(pair.rparams, _batch(pair, True))
    got, gm = pair.model.loss(pair.params, _batch(pair, False))
    assert set(gm) == set(wm)
    for k in gm:
        _close(gm[k], wm[k])
    assert float(got) == float(gm["loss"])


@pytest.mark.parametrize("remat", [False, True])
def test_loss_gradients_match_repro(pair, remat):
    """``loss.backward()`` in the port against ``jax.grad`` of the
    reference's loss, leaf by leaf (mamba's and rwkv's redrawn parameters
    included), with each layer (and each mamba chunk) recomputed or
    kept."""
    rmodel = type(pair.rmodel)(pair.rcfg, remat=remat)
    want = jax.jit(jax.grad(lambda p, b: rmodel.loss(p, b)[0]))(
        pair.rparams, _batch(pair, True))
    model = build_model(pair.cfg, device="cpu", remat=remat)
    params = pair.port_params()
    for leaf in tree.leaves(params):
        leaf.requires_grad_(True)
    loss, _ = model.loss(params, _batch(pair, False))
    loss.backward()
    # a parameter the loss does not read (whisper's cross ``gate``: its
    # cross-attention is ungated) has no gradient in torch, 0 in jax
    _assert_trees_close(stack_like_reference(tree.tree_map(
        lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
        params)), want)


def test_prefill_then_decode_match_repro(pair):
    """Prefill 16 tokens into a 32-slot cache, then 2 decode steps: the
    logits and every cache (``kv`` and ``mamba``; ``rwkv``; ``kv`` and
    ``cross_kv``) agree with the reference's after each."""
    rm, m = pair.rmodel, pair.model
    jt, tt = jnp.asarray(pair.tokens), torch.from_numpy(pair.tokens)
    jc, tc = rm.init_cache(B, 32), m.init_cache(B, 32)
    keys = sorted(k for k in jc if k != "pos")
    assert sorted(k for k in tc if k != "pos") == keys
    want, jc = jax.jit(rm.prefill)(pair.rparams, jt[:, :S], jc,
                                   **pair.extra(True))
    got, tc = m.prefill(pair.params, tt[:, :S], tc, **pair.extra(False))
    assert int(tc["pos"]) == int(jc["pos"]) == S
    _close(got, want)
    for k in keys:
        _assert_trees_close(tc[k], jc[k])
    decode = jax.jit(rm.decode_step)
    for i in range(2):
        want, jc = decode(pair.rparams, jc, jt[:, S + i:S + i + 1])
        got, tc = m.decode_step(pair.params, tc, tt[:, S + i:S + i + 1])
        _close(got, want)
    assert got.shape == (B, 1, m.cfg.padded_vocab)
    for k in keys:
        _assert_trees_close(tc[k], jc[k])


def test_prefill_and_decode_match_forward(pair):
    """The port against itself: prefill's last logits and 2 decode steps
    equal the forward's logits at those positions."""
    m, params = pair.model, pair.params
    tt = torch.from_numpy(pair.tokens)
    x, _ = m.forward(params, tt, **pair.extra(False))
    full = m._head(params, x)
    logits, cache = m.prefill(params, tt[:, :S], m.init_cache(B, 32),
                              **pair.extra(False))
    _close(logits, full[:, S - 1:S].detach().numpy())
    for i in range(2):
        logits, cache = m.decode_step(params, cache, tt[:, S + i:S + i + 1])
        _close(logits, full[:, S + i:S + i + 1].detach().numpy())


def test_learned_positions_decoder_matches_repro():
    """A ``DecoderLM`` with ``pos="learned"`` (no shipped decoder config
    has it): forward, prefill and 2 decode steps, and ``pos_embed``'s
    gradient."""
    upd = dict(pos="learned")
    rcfg = repro_arch("codeqwen1.5-7b").reduced(**upd)
    cfg = get_arch("codeqwen1.5-7b").reduced(**upd)
    rmodel = repro_build(rcfg)
    rparams = jax.jit(rmodel.init)(jax.random.PRNGKey(8))
    model = build_model(cfg, device="cpu")
    assert not model.decode_supports_start
    params = params_from_jax(cfg, _np_tree(rparams))
    assert params["pos_embed"].shape == (cfg.max_seq, cfg.d_model)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, (B, S + 2)) \
        .astype(np.int32)
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens)
    _close(model.forward(params, tt)[0],
           jax.jit(rmodel.forward)(rparams, jt)[0])
    jc, tc = rmodel.init_cache(B, 32), model.init_cache(B, 32)
    want, jc = jax.jit(rmodel.prefill)(rparams, jt[:, :S], jc)
    got, tc = model.prefill(params, tt[:, :S], tc)
    _close(got, want)
    decode = jax.jit(rmodel.decode_step)
    for i in range(2):
        want, jc = decode(rparams, jc, jt[:, S + i:S + i + 1])
        got, tc = model.decode_step(params, tc, tt[:, S + i:S + i + 1])
        _close(got, want)
    batch = {"tokens": tokens[:, :S],
             "labels": np.roll(tokens[:, :S], -1, axis=1)}
    gw = jax.jit(jax.grad(lambda p, b: rmodel.loss(p, b)[0]))(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params["pos_embed"].requires_grad_(True)
    model.loss(params, {k: torch.from_numpy(v)
                        for k, v in batch.items()})[0].backward()
    _close(params["pos_embed"].grad, gw["pos_embed"])


# ---------------------------------------------------------------- serving

def _requests(cls, cfg, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid, rng.integers(0, cfg.vocab, int(rng.integers(2, 9)),
                                  dtype=np.int32),
                max_new_tokens=int(rng.integers(2, 7)))
            for rid in range(n)]


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-7b"])
def test_serve_engine_cohorts_match_repro(arch):
    """``ServeEngine(mode="auto")`` picks cohort mode for the recurrent
    stacks, as the reference's does, and both engines give the same run
    statistics and greedy tokens."""
    p = Pair(arch, seed=9)
    ref = RefEngine(p.rmodel, p.rparams, n_slots=3, max_seq=16)
    port = ServeEngine(p.model, p.params, n_slots=3, max_seq=16)
    for r in _requests(RefRequest, p.cfg):
        assert ref.submit(r)
    for r in _requests(Request, p.cfg):
        assert port.submit(r)
    want, got = ref.run(), port.run()
    assert got.mode == want.mode == "cohort"
    for key in ("steps", "occupancy", "cohorts", "inflight_admissions",
                "requests_completed"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.requests_completed == 6
    assert dict(got.items()) == dict(want.items())


# --------------------------------------------------------------- routing

def test_no_recurrent_family_reaches_the_flash_kernel(monkeypatch):
    """With ``FlashAttentionFn.apply`` raising, each family at its real
    d_head (64) runs forward, prefill and a decode step over 128 tokens
    (whisper over 128 frames): ``ops.attention`` sends d_head 64 to the
    plain attention, as the reference's ``flashable`` (D % 128 == 0)
    does. The control: hymba at d_head 128, whose global layers are
    flashable at 128 tokens, reaches it."""
    def refuse(*args):
        raise AssertionError("FlashAttentionFn.apply reached")

    monkeypatch.setattr(flash_attention.FlashAttentionFn, "apply", refuse)
    n = 128
    for arch in ARCHS:
        cfg = get_arch(arch).reduced(**RECURRENT[arch], d_head=64,
                                     enc_seq=n)
        model = build_model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(10))
        tok = torch.randint(0, cfg.vocab, (1, n + 1),
                            generator=torch.Generator().manual_seed(10))
        extra = ({"frames": torch.randn((1, n, cfg.d_model))}
                 if cfg.enc_dec else {})
        with torch.no_grad():
            model.forward(params, tok[:, :n], **extra)
            logits, cache = model.prefill(params, tok[:, :n],
                                          model.init_cache(1, n + 1), **extra)
            logits, _ = model.decode_step(params, cache, tok[:, n:])
        assert bool(torch.isfinite(logits[..., :cfg.vocab]).all()), arch
    cfg = get_arch("hymba-1.5b").reduced(**RECURRENT["hymba-1.5b"],
                                         d_head=128)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(11))
    with torch.no_grad(), pytest.raises(AssertionError, match="reached"):
        model.forward(params, torch.zeros((1, n), dtype=torch.long))
