"""Decoder LM, dense family (port of ``repro.models.transformer``).

The dense architectures (codeqwen, stablelm, h2o-danube, gemma2): GQA
attention with per-layer windows + (gated) MLP, pre-norm, optional gemma2
sandwich norms, tied or separate head, padded vocab masked at -1e30.

The reference scans one layer body over stacked ``(L, ...)`` parameters.
The port keeps ``params["layers"]`` as a list of per-layer dicts and loops
over them in Python, handing layer ``i`` the window
``int(cfg.layer_windows[i])``. Under the reference's own static-window rule
(``attention._attn_core``) every layer with ``d_head % 128 == 0``, no
window and no softcap therefore reaches the flash kernel at a prefill of
``S % 128 == 0`` tokens, where the reference's scanned stack sees a traced
window and runs its masked oracle; the two compute the same function.

Caches keep the reference's layout: ``{"pos", "kv": {"k", "v"}}`` with
``(L, B, Hkv, max_seq, D)`` tensors, written in place; ``pos`` is a host
int. An optional ``cache["start"]`` (B,) tensor scopes decode attention per
slot (token-level serving). MoE, MLA, mamba, rwkv, vision, enc-dec and
learned-position stacks raise ``NotImplementedError``.

Training: ``loss`` is the reference's (chunked cross entropy over the
final hidden states). With ``remat=True`` each layer of ``forward`` runs
under ``torch.utils.checkpoint`` (non-reentrant), as the reference wraps
its scanned layer body in ``jax.checkpoint``; the backward recomputes
the layer, flash launch included
(``kernels.flash_attention.FlashAttentionFn``).

Public surface: init / forward / loss / init_cache / prefill / decode_step.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as A
from .common import (apply_mlp, apply_norm, cdt, chunked_ce_loss,
                     dense_init, dt, embed_init, init_mlp, init_norm, softcap)
from .config import ArchConfig

Params = dict
Cache = dict


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port cannot build,
    naming the ROADMAP.md item (queue 1) that ports it."""
    missing = []
    if cfg.cross_attn_period:
        missing.append("cross-attention (item 8, vision)")
    if cfg.enc_dec:
        missing.append("encoder-decoder (item 9)")
    if cfg.moe is not None:
        missing.append("MoE (item 9)")
    if cfg.mla is not None:
        missing.append("MLA (item 9)")
    if cfg.mixer != "attn":
        missing.append(f"mixer {cfg.mixer!r} (item 9)")
    if cfg.pos == "learned":
        missing.append("learned positions (item 9, with enc-dec)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port builds dense attention stacks only; not "
            f"ported yet: {', '.join(missing)} (ROADMAP.md queue 1)")


class DecoderLM:
    """Dense decoder LM on one torch device, which the caller names
    (``build_model`` resolves it: ``cuda`` unless told otherwise)."""

    def __init__(self, cfg: ArchConfig, device: torch.device | str,
                 remat: bool = False):
        check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.remat = remat      # activation-checkpoint each layer

    # ------------------------------------------------------------ init ----

    def init(self, generator: torch.Generator | int | None = 0) -> Params:
        """Random weights drawn from ``generator`` (a ``torch.Generator`` on
        this device, or a seed for one). On the ``meta`` device nothing is
        drawn and the generator is ignored."""
        cfg = self.cfg
        dev = self.device
        if dev.type == "meta":
            generator = None
        elif not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=dev).manual_seed(
                int(generator or 0))
        dtype = dt(cfg)
        p: Params = {
            "embed": embed_init(generator, (cfg.padded_vocab, cfg.d_model),
                                dtype, dev),
            "final_norm": init_norm(cfg, cfg.d_model, dev),
        }
        if not cfg.tie_embeddings:
            p["head"] = dense_init(generator, (cfg.d_model, cfg.padded_vocab),
                                   dtype, dev)
        p["layers"] = [self._init_block(generator)
                       for _ in range(cfg.n_layers)]
        return p

    def _init_block(self, generator) -> dict:
        cfg = self.cfg
        blk: dict = {"ln1": self._norm_stack(), "ln2": self._norm_stack()}
        if cfg.post_norm:
            blk["post_ln1"] = self._norm_stack()
            blk["post_ln2"] = self._norm_stack()
        blk["attn"] = A.init_attn(generator, cfg, self.device)
        blk["mlp"] = init_mlp(generator, cfg, cfg.d_model, cfg.d_ff,
                              self.device)
        return blk

    def _norm_stack(self) -> dict:
        return init_norm(self.cfg, self.cfg.d_model, self.device)

    # --------------------------------------------------------- forward ----

    def _window(self, i: int) -> int:
        return int(self.cfg.layer_windows[i])

    def _embed(self, p: Params, tokens: torch.Tensor) -> torch.Tensor:
        return p["embed"][tokens.long()].to(cdt(self.cfg))

    def _head(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        head = p["embed"].T if cfg.tie_embeddings else p["head"]
        logits = x @ head.to(x.dtype)
        logits = softcap(logits.to(torch.float32), cfg.final_softcap)
        if cfg.padded_vocab != cfg.vocab:
            valid = torch.arange(cfg.padded_vocab, device=logits.device) \
                < cfg.vocab
            logits = torch.where(valid, logits, -1e30)
        return logits

    def _block_fwd(self, blk: dict, x: torch.Tensor, window) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(cfg, blk["ln1"], x)
        mix = A.attn_forward(cfg, blk["attn"], h, window=window)
        if cfg.post_norm:
            mix = apply_norm(cfg, blk["post_ln1"], mix)
        x = x + mix
        h = apply_norm(cfg, blk["ln2"], x)
        y = apply_mlp(cfg, blk["mlp"], h)
        if cfg.post_norm:
            y = apply_norm(cfg, blk["post_ln2"], y)
        return x + y

    def forward(self, p: Params, tokens: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
        """Full-sequence forward to final hidden states (B, S, D), plus the
        reference's auxiliary losses (zero for dense stacks)."""
        x = self._embed(p, tokens)
        for i, blk in enumerate(p["layers"]):
            if self.remat:
                x = checkpoint(self._block_fwd, blk, x, self._window(i),
                               use_reentrant=False)
            else:
                x = self._block_fwd(blk, x, self._window(i))
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return apply_norm(self.cfg, p["final_norm"], x), {
            "moe_load_balance": zero, "moe_z_loss": zero}

    # ------------------------------------------------------------ loss ----

    def loss(self, p: Params, batch: dict) -> tuple[torch.Tensor, dict]:
        """Mean next-token cross entropy over ``batch`` (tensors
        ``tokens``, ``labels`` and, optionally, ``mask``): ``(total,
        {"ce", "tokens", "loss"})``, the reference's metrics for a dense
        stack (no MoE auxiliary terms)."""
        cfg = self.cfg
        x, _ = self.forward(p, batch["tokens"])
        head = p["embed"].T if cfg.tie_embeddings else p["head"]
        nll, w = chunked_ce_loss(x, head, batch["labels"], batch.get("mask"),
                                 final_softcap=cfg.final_softcap,
                                 valid_vocab=cfg.vocab)
        ce = nll / torch.clamp(w, min=1.0)
        return ce, {"ce": ce, "tokens": w, "loss": ce}

    # ---------------------------------------------------------- decode ----

    def init_cache(self, batch: int, max_seq: int) -> Cache:
        cfg = self.cfg
        return {"pos": 0,
                "kv": A.init_kv_cache(cfg, cfg.n_layers, batch, max_seq,
                                      cdt(cfg), self.device)}

    def _block_decode(self, blk: dict, x, window, pos: int, kv, start=None):
        """One-layer decode; writes the layer's K/V at ``pos`` in place.
        Returns (x, (cache_k, cache_v))."""
        cfg = self.cfg
        h = apply_norm(cfg, blk["ln1"], x)
        mix, ck, cv = A.attn_decode(cfg, blk["attn"], h, kv[0], kv[1], pos,
                                    window=window, start=start)
        if cfg.post_norm:
            mix = apply_norm(cfg, blk["post_ln1"], mix)
        x = x + mix
        h = apply_norm(cfg, blk["ln2"], x)
        y = apply_mlp(cfg, blk["mlp"], h)
        if cfg.post_norm:
            y = apply_norm(cfg, blk["post_ln2"], y)
        return x + y, (ck, cv)

    @property
    def decode_supports_start(self) -> bool:
        """Whether :meth:`decode_step` honors a per-slot ``cache["start"]``
        vector (token-level continuous batching, ``repro_torch.serve``).
        True for plain rotary/positionless attention stacks, the only ones
        the port builds; the reference's rule is kept for the families to
        come (learned positional embeddings index absolute arena
        positions)."""
        cfg = self.cfg
        return (cfg.mixer == "attn" and cfg.mla is None
                and not cfg.cross_attn_period and cfg.pos != "learned")

    def decode_step(self, p: Params, cache: Cache, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, Cache]:
        """tokens: (B, 1) -> (logits (B, 1, V), cache with ``pos`` + 1).
        An optional ``cache["start"]`` (B,) tensor scopes each batch row's
        attention to cache positions [start[b], pos]."""
        pos = int(cache["pos"])
        x = self._embed(p, tokens)
        cache = dict(cache)
        x = self._stack_decode(p, x, cache, pos, start=cache.get("start"))
        x = apply_norm(self.cfg, p["final_norm"], x)
        logits = self._head(p, x)
        cache["pos"] = pos + 1
        return logits, cache

    def _stack_decode(self, p, x, cache, pos: int, start=None):
        kv = cache["kv"]
        for i, blk in enumerate(p["layers"]):
            x, _ = self._block_decode(blk, x, self._window(i), pos,
                                      (kv["k"][i], kv["v"][i]), start=start)
        return x

    # --------------------------------------------------------- prefill ----

    def prefill(self, p: Params, tokens: torch.Tensor, cache: Cache
                ) -> tuple[torch.Tensor, Cache]:
        """Parallel prefill: full-sequence forward with cache writes.
        Returns (last-position logits (B, 1, V), filled cache)."""
        S = tokens.shape[1]
        x = self._embed(p, tokens)
        cache = dict(cache)
        x = self._stack_prefill(p, x, cache)
        cache["pos"] = int(cache["pos"]) + S
        x = apply_norm(self.cfg, p["final_norm"], x)
        logits = self._head(p, x[:, -1:])
        return logits, cache

    def _block_prefill(self, blk: dict, x, window, kv):
        cfg = self.cfg
        h = apply_norm(cfg, blk["ln1"], x)
        mix, ck, cv = A.attn_prefill(cfg, blk["attn"], h, kv[0], kv[1],
                                     window=window)
        if cfg.post_norm:
            mix = apply_norm(cfg, blk["post_ln1"], mix)
        x = x + mix
        h = apply_norm(cfg, blk["ln2"], x)
        y = apply_mlp(cfg, blk["mlp"], h)
        if cfg.post_norm:
            y = apply_norm(cfg, blk["post_ln2"], y)
        return x + y, (ck, cv)

    def _stack_prefill(self, p, x, cache):
        kv = cache["kv"]
        for i, blk in enumerate(p["layers"]):
            x, _ = self._block_prefill(blk, x, self._window(i),
                                       (kv["k"][i], kv["v"][i]))
        return x
