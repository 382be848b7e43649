"""Decoder LM (port of ``repro.models.transformer``).

The families the port builds:

  * plain/dense (codeqwen, stablelm, h2o-danube, gemma2): GQA attention
    with per-layer windows + (gated) MLP, pre-norm, optional gemma2
    sandwich norms, tied or separate head, padded vocab masked at -1e30;
  * moe (deepseek-moe, deepseek-v2): a dense-FFN prefix
    (``cfg.dense_layers``), then MoE layers (``models/moe.py``);
    deepseek-v2 swaps GQA for MLA (``models/mla.py``);
  * vision (llama-3.2-vision): period-grouped stack, each group one gated
    cross-attention block over the image embeddings + (period-1)
    self-attention layers;
  * mamba+attn (hymba): each layer's attention and selective-SSM heads
    read the same normed input and their outputs are summed
    (``models/mamba.py``);
  * rwkv (rwkv6): time-mix + channel-mix, no attention
    (``models/rwkv.py``).

Learned absolute positions (``cfg.pos == "learned"``: ``pos_embed``,
added at the embedding) are supported as in the reference; no shipped
decoder config uses them.

The reference scans one layer body over stacked ``(L, ...)`` parameters.
The port keeps per-layer dicts in lists and loops over them in Python:
``params["layers"]`` is a list of L layers for the dense family, a list of
the ``n_layers - len(dense_layers)`` MoE layers beside
``params["dense_prefix"]`` (a list, as in the reference) for MoE, a
list of G lists of ``period - 1`` self layers beside ``params["cross"]``
(a list of G cross blocks) for vision, and a list of L layers (each
``{"ln1", "ln2", "rwkv"}``; hymba's blocks add ``"mamba"``) for the
recurrent mixers. Layer ``i`` gets the window
``int(cfg.layer_windows[i])`` (vision's self layers ``FULL_WINDOW``).
Under the reference's own static-window rule (``attention._attn_core``)
every such layer with ``d_head % 128 == 0``, no window and no softcap
therefore reaches the flash kernel at a prefill of ``S % 128 == 0``
tokens, where the reference's scanned stack sees a traced window and runs
its masked oracle; the two compute the same function. MLA and the cross
blocks run the plain attention, as the reference's do.

Caches keep the reference's layout: ``{"pos", "kv": {"k", "v"}}`` with
``(L, B, Hkv, max_seq, D)`` tensors, plus ``kv_dense`` for a MoE stack's
dense prefix, ``mla`` / ``mla_dense`` latent caches (``{"c_kv", "k_pe"}``,
``(L, B, max_seq, *)``) in place of ``kv`` / ``kv_dense`` for MLA, and
``cross_kv`` (``(G, B, Hkv, n_img_tokens, D)``, written by prefill) for
vision; hymba adds ``mamba`` (``{"ssm": (L, B, d_inner, d_state)`` f32,
``"conv": (L, B, d_conv - 1, d_inner)``}), and rwkv keeps only ``rwkv``
(``{"wkv": (L, B, H, hd, hd)`` f32, ``"prev_t"``, ``"prev_c"``: (L, B,
D)}). Every cache is written in place; ``pos`` is a host int. An
optional ``cache["start"]`` (B,) tensor scopes decode attention per slot
(token-level serving) in the stacks that honour it
(:attr:`DecoderLM.decode_supports_start`); the recurrent stacks are
served in cohorts.

Training: ``loss`` is the reference's (chunked cross entropy over the
final hidden states, plus the router's weighted auxiliary losses for
MoE). With ``remat=True`` each layer the reference scans (every layer of
a dense, hybrid or rwkv stack, the MoE layers, each vision group) runs
under
``torch.utils.checkpoint`` (non-reentrant), as the reference wraps its
scanned body in ``jax.checkpoint``; the backward recomputes it, flash
launches included (``kernels.flash_attention.FlashAttentionFn``).

Public surface: init / forward / loss / init_cache / prefill / decode_step.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as A
from . import mamba as M
from . import mla as ML
from . import moe as MO
from . import rwkv as R
from .common import (apply_mlp, apply_norm, cdt, chunked_ce_loss,
                     constrain_batch, dense_init, dt, embed_init,
                     init_generator, init_mlp, init_norm, lm_head,
                     pin_grad)
from .config import ArchConfig, FULL_WINDOW

Params = dict
Cache = dict
AUX_KEYS = ("moe_load_balance", "moe_z_loss")


class DecoderLM:
    """Decoder LM on one torch device, which the caller names
    (``build_model`` resolves it: ``cuda`` unless told otherwise)."""

    def __init__(self, cfg: ArchConfig, device: torch.device | str,
                 remat: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.remat = remat      # activation-checkpoint each scanned layer

    def _maybe_remat(self, fn, *args):
        if self.remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    @property
    def _n_dense(self) -> int:
        cfg = self.cfg
        return len(cfg.dense_layers) if cfg.moe is not None else 0

    # ------------------------------------------------------------ init ----

    def init(self, generator: torch.Generator | int | None = 0) -> Params:
        """Random weights drawn from ``generator`` (a ``torch.Generator`` on
        this device, or a seed for one). On the ``meta`` device nothing is
        drawn and the generator is ignored."""
        cfg = self.cfg
        dev = self.device
        generator = init_generator(generator, dev)
        dtype = dt(cfg)
        p: Params = {
            "embed": embed_init(generator, (cfg.padded_vocab, cfg.d_model),
                                dtype, dev),
            "final_norm": init_norm(cfg, cfg.d_model, dev),
        }
        if not cfg.tie_embeddings:
            p["head"] = dense_init(generator, (cfg.d_model, cfg.padded_vocab),
                                   dtype, dev)
        if cfg.pos == "learned":
            p["pos_embed"] = embed_init(generator, (cfg.max_seq, cfg.d_model),
                                        dtype, dev)
        if cfg.cross_attn_period:
            p.update(self._init_vision(generator))
        elif cfg.mixer == "rwkv":
            p["layers"] = [{"ln1": self._norm_stack(),
                            "ln2": self._norm_stack(),
                            "rwkv": R.init_rwkv(generator, cfg, dev)}
                           for _ in range(cfg.n_layers)]
        elif cfg.moe is not None:
            n_dense = len(cfg.dense_layers)
            if cfg.dense_layers != tuple(range(n_dense)):
                raise ValueError(f"{cfg.name}: dense MoE layers must be a "
                                 f"prefix, got {cfg.dense_layers}")
            p["dense_prefix"] = [self._init_block(generator, moe=False)
                                 for _ in range(n_dense)]
            p["layers"] = [self._init_block(generator, moe=True)
                           for _ in range(cfg.n_layers - n_dense)]
        else:
            p["layers"] = [self._init_block(generator, moe=False)
                           for _ in range(cfg.n_layers)]
        return p

    def _init_block(self, generator, moe: bool) -> dict:
        cfg = self.cfg
        blk: dict = {"ln1": self._norm_stack(), "ln2": self._norm_stack()}
        if cfg.post_norm:
            blk["post_ln1"] = self._norm_stack()
            blk["post_ln2"] = self._norm_stack()
        if cfg.mla is not None:
            blk["mla"] = ML.init_mla(generator, cfg, self.device)
        else:
            blk["attn"] = A.init_attn(generator, cfg, self.device)
        if cfg.mixer == "mamba+attn":
            blk["mamba"] = M.init_mamba(generator, cfg, self.device)
        if moe:
            blk["moe"] = MO.init_moe(generator, cfg, self.device)
        else:
            blk["mlp"] = init_mlp(generator, cfg, cfg.d_model, cfg.d_ff,
                                  self.device)
        return blk

    def _norm_stack(self) -> dict:
        return init_norm(self.cfg, self.cfg.d_model, self.device)

    def _groups(self) -> tuple[int, int]:
        """Vision: (groups, self layers per group)."""
        period = self.cfg.cross_attn_period
        return self.cfg.n_layers // period, period - 1

    def _init_vision(self, generator) -> dict:
        cfg = self.cfg
        groups, n_self = self._groups()
        dev = self.device
        return {
            "cross": [{"ln": self._norm_stack(),
                       "attn": A.init_cross_attn(generator, cfg, dev),
                       "ln2": self._norm_stack(),
                       "mlp": init_mlp(generator, cfg, cfg.d_model, cfg.d_ff,
                                       dev)}
                      for _ in range(groups)],
            "layers": [[self._init_block(generator, moe=False)
                        for _ in range(n_self)] for _ in range(groups)],
        }

    # --------------------------------------------------------- forward ----

    def _window(self, i: int) -> int:
        return int(self.cfg.layer_windows[i])

    def _embed(self, p: Params, tokens: torch.Tensor, pos: int = 0
               ) -> torch.Tensor:
        """Token embeddings of ``tokens`` (B, T) at positions [pos,
        pos + T), plus the learned positions there where the config has
        them."""
        embed = pin_grad(p["embed"]) if self.cfg.tie_embeddings \
            else p["embed"]
        x = embed[tokens.long()].to(cdt(self.cfg))
        if self.cfg.pos == "learned":
            x = x + p["pos_embed"][pos:pos + tokens.shape[1]].to(x.dtype)
        return constrain_batch(x)

    def _head(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        return lm_head(self.cfg, p, x)

    def _ffn(self, blk: dict, h: torch.Tensor):
        """The block's FFN: (y, aux), aux None for a dense MLP."""
        if "moe" in blk:
            return MO.moe_ffn(self.cfg, blk["moe"], h)
        return apply_mlp(self.cfg, blk["mlp"], h), None

    def _block_tail(self, blk: dict, x, mix):
        """Residual add of the mixer's output, then the FFN: (x, aux)."""
        cfg = self.cfg
        if cfg.post_norm:
            mix = apply_norm(cfg, blk["post_ln1"], mix)
        x = x + mix
        y, aux = self._ffn(blk, apply_norm(cfg, blk["ln2"], x))
        if cfg.post_norm:
            y = apply_norm(cfg, blk["post_ln2"], y)
        return x + y, aux

    def _block_fwd(self, blk: dict, x: torch.Tensor, window):
        """One decoder block. Returns (x, aux), aux None without MoE."""
        cfg = self.cfg
        h = apply_norm(cfg, blk["ln1"], x)
        if cfg.mla is not None:
            mix = ML.mla_forward(cfg, blk["mla"], h)
        else:
            mix = A.attn_forward(cfg, blk["attn"], h, window=window)
        if cfg.mixer == "mamba+attn":
            mix = mix + M.mamba_forward(cfg, blk["mamba"], h)
        return self._block_tail(blk, x, mix)

    def _rwkv_fwd(self, blk: dict, x: torch.Tensor) -> torch.Tensor:
        """One rwkv layer: time-mix, then channel-mix, each pre-norm."""
        cfg = self.cfg
        h = apply_norm(cfg, blk["ln1"], x)
        x = x + R.rwkv_time_mix(cfg, blk["rwkv"], h)
        h = apply_norm(cfg, blk["ln2"], x)
        return x + R.rwkv_channel_mix(cfg, blk["rwkv"], h)

    def forward(self, p: Params, tokens: torch.Tensor,
                img: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict]:
        """Full-sequence forward to final hidden states (B, S, D), plus the
        reference's auxiliary losses summed over the MoE layers (zero for
        the other stacks). Vision needs ``img`` (B, n_img_tokens, D)."""
        cfg = self.cfg
        x = self._embed(p, tokens)
        aux = {k: torch.zeros((), dtype=torch.float32, device=x.device)
               for k in AUX_KEYS}
        if cfg.cross_attn_period:
            x = self._vision_fwd(p, x, img)
        elif cfg.mixer == "rwkv":
            for blk in p["layers"]:
                x = self._maybe_remat(self._rwkv_fwd, blk, x)
        else:
            n_dense = self._n_dense
            for i in range(n_dense):
                x, _ = self._block_fwd(p["dense_prefix"][i], x,
                                       self._window(i))
            for j, blk in enumerate(p["layers"]):
                x, aux_l = self._maybe_remat(self._block_fwd, blk, x,
                                             self._window(n_dense + j))
                if aux_l is not None:
                    aux = {k: aux[k] + aux_l[k] for k in AUX_KEYS}
        return apply_norm(cfg, p["final_norm"], x), aux

    def _cross_block(self, cross: dict, x, k, v):
        """A vision group's gated cross-attention block against the image
        K/V (B, Hkv, M, D)."""
        cfg = self.cfg
        h = apply_norm(cfg, cross["ln"], x)
        x = x + A.cross_attn_forward(cfg, cross["attn"], h, k, v)
        h = apply_norm(cfg, cross["ln2"], x)
        return x + apply_mlp(cfg, cross["mlp"], h) \
            * torch.tanh(cross["attn"]["gate"]).to(x.dtype)

    def _vision_group(self, cross: dict, selfs: list, x, img):
        k, v = A.cross_kv(self.cfg, cross["attn"], img)
        x = self._cross_block(cross, x, k, v)
        for blk in selfs:
            x, _ = self._block_fwd(blk, x, FULL_WINDOW)
        return x

    def _vision_fwd(self, p: Params, x: torch.Tensor, img) -> torch.Tensor:
        if img is None:
            raise ValueError(f"{self.cfg.name} needs image embeddings")
        img = img.to(x.dtype)
        for cross, selfs in zip(p["cross"], p["layers"]):
            x = self._maybe_remat(self._vision_group, cross, selfs, x, img)
        return x

    # ------------------------------------------------------------ loss ----

    def loss(self, p: Params, batch: dict) -> tuple[torch.Tensor, dict]:
        """Mean next-token cross entropy over ``batch`` (tensors
        ``tokens``, ``labels`` and, optionally, ``mask`` and ``img``), plus
        the router's weighted auxiliary losses for MoE: ``(total,
        metrics)`` with the reference's metrics (``ce``, ``tokens``,
        ``loss``, and for MoE ``moe_load_balance`` and ``moe_z_loss``)."""
        cfg = self.cfg
        x, aux = self.forward(p, batch["tokens"], img=batch.get("img"))
        head = p["embed"].T if cfg.tie_embeddings else p["head"]
        nll, w = chunked_ce_loss(x, head, batch["labels"], batch.get("mask"),
                                 final_softcap=cfg.final_softcap,
                                 valid_vocab=cfg.vocab)
        ce = nll / torch.clamp(w, min=1.0)
        total = ce
        metrics = {"ce": ce, "tokens": w}
        if cfg.moe is not None:
            total = total + cfg.moe.router_aux_weight \
                * aux["moe_load_balance"]
            total = total + cfg.moe.router_z_weight * aux["moe_z_loss"]
            metrics.update(aux)
        metrics["loss"] = total
        return total, metrics

    # ---------------------------------------------------------- decode ----

    def init_cache(self, batch: int, max_seq: int) -> Cache:
        cfg = self.cfg
        dtype, dev = cdt(cfg), self.device
        cache: Cache = {"pos": 0}
        if cfg.mixer == "rwkv":
            cache["rwkv"] = R.init_rwkv_cache(cfg, cfg.n_layers, batch, dtype,
                                              dev)
            return cache
        n_dense = self._n_dense
        n_scan = cfg.n_layers - n_dense
        if cfg.cross_attn_period:
            groups, n_self = self._groups()
            cache["kv"] = A.init_kv_cache(cfg, groups * n_self, batch,
                                          max_seq, dtype, dev)
            shape = (groups, batch, cfg.n_kv_heads, cfg.n_img_tokens,
                     cfg.d_head)
            cache["cross_kv"] = {
                "k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
            return cache
        if cfg.mla is not None:
            cache["mla"] = ML.init_mla_cache(cfg, n_scan, batch, max_seq,
                                             dtype, dev)
            if n_dense:
                cache["mla_dense"] = ML.init_mla_cache(cfg, n_dense, batch,
                                                       max_seq, dtype, dev)
        else:
            cache["kv"] = A.init_kv_cache(cfg, n_scan, batch, max_seq, dtype,
                                          dev)
            if n_dense:
                cache["kv_dense"] = A.init_kv_cache(cfg, n_dense, batch,
                                                    max_seq, dtype, dev)
        if cfg.mixer == "mamba+attn":
            cache["mamba"] = M.init_mamba_cache(cfg, cfg.n_layers, batch,
                                                dtype, dev)
        return cache

    def _layer_caches(self, cache: Cache, dense: bool) -> list[dict]:
        """Per-layer views of a stack's cache, as keyword arguments of
        :meth:`_block_decode` / :meth:`_block_prefill`: ``kv`` or ``mla``
        pairs of the dense prefix (``dense``) or of the other layers, and
        for hymba each layer's ``mamba`` (ssm, conv) pair."""
        suffix = "_dense" if dense else ""
        if self.cfg.mla is not None:
            c = cache["mla" + suffix]
            out = [{"mla": (a, b)} for a, b in zip(c["c_kv"], c["k_pe"])]
        else:
            c = cache["kv" + suffix]
            out = [{"kv": (a, b)} for a, b in zip(c["k"], c["v"])]
        if self.cfg.mixer == "mamba+attn":
            m = cache["mamba"]
            for c, a, b in zip(out, m["ssm"], m["conv"]):
                c["mamba"] = (a, b)
        return out

    def _block_decode(self, blk: dict, x, window, pos: int, kv=None,
                      mla=None, mamba=None, start=None) -> torch.Tensor:
        """One-layer decode; writes the layer's cache at ``pos`` (and its
        mamba state and conv window) in place. ``start`` (per-slot
        attention-window origins, token-level serving) only reaches the
        plain-attention path, as in the reference."""
        cfg = self.cfg
        h = apply_norm(cfg, blk["ln1"], x)
        if cfg.mla is not None:
            mix, _, _ = ML.mla_decode(cfg, blk["mla"], h, mla[0], mla[1], pos)
        else:
            mix, _, _ = A.attn_decode(cfg, blk["attn"], h, kv[0], kv[1], pos,
                                      window=window, start=start)
        if mamba is not None:
            mo, ssm, win = M.mamba_decode(cfg, blk["mamba"], h, *mamba)
            mamba[0].copy_(ssm)
            mamba[1].copy_(win)
            mix = mix + mo
        return self._block_tail(blk, x, mix)[0]

    @property
    def decode_supports_start(self) -> bool:
        """Whether :meth:`decode_step` honors a per-slot ``cache["start"]``
        vector (token-level continuous batching, ``repro_torch.serve``).
        True only for plain rotary/positionless attention stacks (the
        dense family and deepseek-moe): cross-attention and MLA caches
        are not start-masked, and learned positional embeddings index
        absolute arena positions. ``ServeEngine(mode="auto")`` reads this
        to pick token-level vs cohort scheduling."""
        cfg = self.cfg
        return (cfg.mixer == "attn" and cfg.mla is None
                and not cfg.cross_attn_period and cfg.pos != "learned")

    def decode_step(self, p: Params, cache: Cache, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, Cache]:
        """tokens: (B, 1) -> (logits (B, 1, V), cache with ``pos`` + 1).
        An optional ``cache["start"]`` (B,) tensor scopes each batch row's
        attention to cache positions [start[b], pos] (see
        :attr:`decode_supports_start`)."""
        pos = int(cache["pos"])
        x = self._embed(p, tokens, pos)
        cache = dict(cache)
        if self.cfg.mixer == "rwkv":
            x = self._rwkv_cached(p, x, cache["rwkv"], decode=True)
        elif self.cfg.cross_attn_period:
            x = self._vision_decode(p, x, cache, pos)
        else:
            x = self._stack_decode(p, x, cache, pos, start=cache.get("start"))
        x = apply_norm(self.cfg, p["final_norm"], x)
        logits = self._head(p, x)
        cache["pos"] = pos + 1
        return logits, cache

    def _rwkv_cached(self, p, x, rc: dict, decode: bool):
        """The rwkv stack with its cache ``rc``: one token from each
        layer's wkv state and shifts (``decode``), or the prompt from zero
        state (prefill). Each layer's new state and last-token shifts
        (cast to the compute dtype) are written into ``rc`` in place."""
        cfg = self.cfg
        for i, blk in enumerate(p["layers"]):
            h = apply_norm(cfg, blk["ln1"], x)
            if decode:
                o, wkv, prev_t = R.rwkv_time_mix_decode(
                    cfg, blk["rwkv"], h, rc["wkv"][i], rc["prev_t"][i])
            else:
                o, wkv, prev_t = R.rwkv_time_mix_prefill(cfg, blk["rwkv"], h)
            x = x + o
            h = apply_norm(cfg, blk["ln2"], x)
            if decode:
                o, prev_c = R.rwkv_channel_mix_decode(cfg, blk["rwkv"], h,
                                                      rc["prev_c"][i])
            else:
                o, prev_c = R.rwkv_channel_mix_prefill(cfg, blk["rwkv"], h)
            x = x + o
            for key, new in (("wkv", wkv), ("prev_t", prev_t),
                             ("prev_c", prev_c)):
                rc[key][i].copy_(new)
        return x

    def _stack_decode(self, p, x, cache, pos: int, start=None):
        n_dense = self._n_dense
        if n_dense:
            for i, c in enumerate(self._layer_caches(cache, dense=True)):
                x = self._block_decode(p["dense_prefix"][i], x,
                                       self._window(i), pos, start=start, **c)
        for j, c in enumerate(self._layer_caches(cache, dense=False)):
            x = self._block_decode(p["layers"][j], x,
                                   self._window(n_dense + j), pos,
                                   start=start, **c)
        return x

    def _vision_decode(self, p, x, cache, pos: int):
        kv, ckv = cache["kv"], cache["cross_kv"]
        n_self = self._groups()[1]
        for g, (cross, selfs) in enumerate(zip(p["cross"], p["layers"])):
            x = self._cross_block(cross, x, ckv["k"][g], ckv["v"][g])
            for j, blk in enumerate(selfs):
                i = g * n_self + j
                x = self._block_decode(blk, x, FULL_WINDOW, pos,
                                       kv=(kv["k"][i], kv["v"][i]))
        return x

    # --------------------------------------------------------- prefill ----

    def prefill(self, p: Params, tokens: torch.Tensor, cache: Cache,
                img: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, Cache]:
        """Parallel prefill: full-sequence forward with cache writes (for
        vision also the image's cross K/V, from ``img``). Returns
        (last-position logits (B, 1, V), filled cache)."""
        S = tokens.shape[1]
        x = self._embed(p, tokens)
        cache = dict(cache)
        if self.cfg.mixer == "rwkv":
            x = self._rwkv_cached(p, x, cache["rwkv"], decode=False)
        elif self.cfg.cross_attn_period:
            x = self._vision_prefill(p, x, cache, img)
        else:
            x = self._stack_prefill(p, x, cache)
        cache["pos"] = int(cache["pos"]) + S
        x = apply_norm(self.cfg, p["final_norm"], x)
        logits = self._head(p, x[:, -1:])
        return logits, cache

    def _block_prefill(self, blk: dict, x, window, kv=None, mla=None,
                       mamba=None) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(cfg, blk["ln1"], x)
        if cfg.mla is not None:
            mix, _, _ = ML.mla_prefill(cfg, blk["mla"], h, mla[0], mla[1])
        else:
            mix, _, _ = A.attn_prefill(cfg, blk["attn"], h, kv[0], kv[1],
                                       window=window)
        if mamba is not None:
            mo, ssm, win = M.mamba_prefill(cfg, blk["mamba"], h)
            mamba[0].copy_(ssm)
            mamba[1].copy_(win)     # the input before the conv
            mix = mix + mo
        return self._block_tail(blk, x, mix)[0]

    def _stack_prefill(self, p, x, cache):
        n_dense = self._n_dense
        if n_dense:
            for i, c in enumerate(self._layer_caches(cache, dense=True)):
                x = self._block_prefill(p["dense_prefix"][i], x,
                                        self._window(i), **c)
        for j, c in enumerate(self._layer_caches(cache, dense=False)):
            x = self._block_prefill(p["layers"][j], x,
                                    self._window(n_dense + j), **c)
        return x

    def _vision_prefill(self, p, x, cache, img):
        if img is None:
            raise ValueError(f"{self.cfg.name} needs image embeddings")
        img = img.to(x.dtype)
        kv, ckv = cache["kv"], cache["cross_kv"]
        n_self = self._groups()[1]
        for g, (cross, selfs) in enumerate(zip(p["cross"], p["layers"])):
            k, v = A.cross_kv(self.cfg, cross["attn"], img)
            ckv["k"][g] = k
            ckv["v"][g] = v
            x = self._cross_block(cross, x, k, v)
            for j, blk in enumerate(selfs):
                i = g * n_self + j
                x = self._block_prefill(blk, x, FULL_WINDOW,
                                        kv=(kv["k"][i], kv["v"][i]))
        return x
