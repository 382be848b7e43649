"""Encoder-decoder backbone (whisper-base; port of ``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: the caller feeds
precomputed frame embeddings (B, T, d_model) straight into the encoder.
Encoder = non-causal self-attention stack; decoder = causal
self-attention, then cross-attention (ungated) to the encoder's output,
then the MLP, each pre-norm. Cross K/V are computed once at prefill and
cached as ``cross_kv``.

The reference scans stacked ``(L, ...)`` parameters; the port keeps
``params["encoder"]`` and ``params["decoder"]`` as lists of per-layer
dicts and loops over them. Caches keep the reference's keys: ``pos`` (a
host int), ``kv`` (``(L, B, Hkv, max_seq, D)``, written in place) and
``cross_kv`` (``(L, B, Hkv, T, D)``, replaced by prefill with the K/V
of its T frames). With ``remat=True`` each encoder and decoder layer of
``forward`` runs under ``torch.utils.checkpoint``.

Public surface: init / encode / forward / loss / init_cache / prefill /
decode_step.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as A
from .common import (apply_mlp, apply_norm, cdt, chunked_ce_loss,
                     constrain_batch, dense_init, dt, embed_init,
                     init_generator, init_mlp, init_norm, lm_head, pin_grad)
from .config import ArchConfig
from .transformer import AUX_KEYS

Params = dict
Cache = dict


class EncDecLM:
    """Encoder-decoder LM on one torch device, which the caller names
    (``build_model`` resolves it: ``cuda`` unless told otherwise)."""

    def __init__(self, cfg: ArchConfig, device: torch.device | str,
                 remat: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.remat = remat

    def _maybe_remat(self, fn, *args):
        if self.remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # ------------------------------------------------------------ init ----

    def _norm(self) -> dict:
        return init_norm(self.cfg, self.cfg.d_model, self.device)

    def init(self, generator: torch.Generator | int | None = 0) -> Params:
        """Random weights drawn from ``generator`` (a ``torch.Generator`` on
        this device, or a seed for one); nothing is drawn on ``meta``."""
        cfg = self.cfg
        dev = self.device
        generator = init_generator(generator, dev)
        dtype = dt(cfg)
        p: Params = {
            "embed": embed_init(generator, (cfg.padded_vocab, cfg.d_model),
                                dtype, dev),
            "dec_pos": embed_init(generator, (cfg.max_seq, cfg.d_model),
                                  dtype, dev),
            "enc_pos": embed_init(generator, (cfg.enc_seq, cfg.d_model),
                                  dtype, dev),
            "final_norm": self._norm(),
            "enc_final_norm": self._norm(),
            "encoder": [{"ln1": self._norm(),
                         "attn": A.init_attn(generator, cfg, dev),
                         "ln2": self._norm(),
                         "mlp": init_mlp(generator, cfg, cfg.d_model,
                                         cfg.d_ff, dev)}
                        for _ in range(cfg.n_enc_layers)],
            "decoder": [{"ln1": self._norm(),
                         "attn": A.init_attn(generator, cfg, dev),
                         "ln_x": self._norm(),
                         "cross": A.init_cross_attn(generator, cfg, dev),
                         "ln2": self._norm(),
                         "mlp": init_mlp(generator, cfg, cfg.d_model,
                                         cfg.d_ff, dev)}
                        for _ in range(cfg.n_layers)],
        }
        if not cfg.tie_embeddings:
            p["head"] = dense_init(generator, (cfg.d_model, cfg.padded_vocab),
                                   dtype, dev)
        return p

    # ---------------------------------------------------------- encode ----

    def _enc_layer(self, blk: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(cfg, blk["ln1"], x)
        x = x + A.attn_forward(cfg, blk["attn"], h, causal=False)
        h = apply_norm(cfg, blk["ln2"], x)
        return x + apply_mlp(cfg, blk["mlp"], h)

    def encode(self, p: Params, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T, D) stubbed frontend embeddings -> memory."""
        x = frames.to(cdt(self.cfg))
        x = x + p["enc_pos"][:x.shape[1]].to(x.dtype)
        for blk in p["encoder"]:
            x = self._maybe_remat(self._enc_layer, blk, x)
        return apply_norm(self.cfg, p["enc_final_norm"], x)

    # --------------------------------------------------------- forward ----

    def _dec_embed(self, p: Params, tokens: torch.Tensor, pos0: int = 0
                   ) -> torch.Tensor:
        embed = pin_grad(p["embed"]) if self.cfg.tie_embeddings \
            else p["embed"]
        x = embed[tokens.long()].to(cdt(self.cfg))
        pe = p["dec_pos"][pos0:pos0 + tokens.shape[1]]
        return constrain_batch(x + pe.to(x.dtype))

    def _head(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        return lm_head(self.cfg, p, x)

    def _cross_mlp(self, blk: dict, x, ck, cv) -> torch.Tensor:
        """A decoder layer's ungated cross-attention to the memory's K/V
        (B, Hkv, T, D), then its MLP."""
        cfg = self.cfg
        h = apply_norm(cfg, blk["ln_x"], x)
        x = x + A.cross_attn_forward(cfg, blk["cross"], h, ck, cv,
                                     gated=False)
        h = apply_norm(cfg, blk["ln2"], x)
        return x + apply_mlp(cfg, blk["mlp"], h)

    def _dec_layer(self, blk: dict, x, memory) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(cfg, blk["ln1"], x)
        x = x + A.attn_forward(cfg, blk["attn"], h, causal=True)
        return self._cross_mlp(blk, x, *A.cross_kv(cfg, blk["cross"], memory))

    def forward(self, p: Params, tokens: torch.Tensor,
                frames: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """Final decoder hidden states (B, S, D) for ``tokens`` against the
        encoded ``frames``, and the reference's auxiliary losses (zero)."""
        memory = self.encode(p, frames)
        x = self._dec_embed(p, tokens)
        for blk in p["decoder"]:
            x = self._maybe_remat(self._dec_layer, blk, x, memory)
        x = apply_norm(self.cfg, p["final_norm"], x)
        aux = {k: torch.zeros((), dtype=torch.float32, device=x.device)
               for k in AUX_KEYS}
        return x, aux

    def loss(self, p: Params, batch: dict) -> tuple[torch.Tensor, dict]:
        """Mean next-token cross entropy over ``batch`` (``tokens``,
        ``labels``, ``frames`` and, optionally, ``mask``): ``(ce,
        {"ce", "loss", "tokens"})``."""
        cfg = self.cfg
        x, _ = self.forward(p, batch["tokens"], batch["frames"])
        head = p["embed"].T if cfg.tie_embeddings else p["head"]
        nll, w = chunked_ce_loss(x, head, batch["labels"], batch.get("mask"),
                                 valid_vocab=cfg.vocab)
        ce = nll / torch.clamp(w, min=1.0)
        return ce, {"ce": ce, "loss": ce, "tokens": w}

    # ---------------------------------------------------------- decode ----

    def init_cache(self, batch: int, max_seq: int) -> Cache:
        cfg = self.cfg
        dtype, dev = cdt(cfg), self.device
        nd = cfg.n_layers
        shape = (nd, batch, cfg.n_kv_heads, cfg.enc_seq, cfg.d_head)
        return {
            "pos": 0,
            "kv": A.init_kv_cache(cfg, nd, batch, max_seq, dtype, dev),
            "cross_kv": {
                "k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)},
        }

    def prefill(self, p: Params, tokens: torch.Tensor, cache: Cache,
                frames: torch.Tensor) -> tuple[torch.Tensor, Cache]:
        """Encode ``frames``, run the decoder over ``tokens`` writing the
        self-attention cache, and cache each layer's cross K/V. Returns
        (last-position logits (B, 1, V), filled cache)."""
        cfg = self.cfg
        memory = self.encode(p, frames)
        x = self._dec_embed(p, tokens)
        cache = dict(cache)
        kv = cache["kv"]
        cks, cvs = [], []
        for i, blk in enumerate(p["decoder"]):
            h = apply_norm(cfg, blk["ln1"], x)
            o, _, _ = A.attn_prefill(cfg, blk["attn"], h, kv["k"][i],
                                     kv["v"][i])
            x = x + o
            ck, cv = A.cross_kv(cfg, blk["cross"], memory)
            x = self._cross_mlp(blk, x, ck, cv)
            cks.append(ck)
            cvs.append(cv)
        cache["cross_kv"] = {"k": torch.stack(cks), "v": torch.stack(cvs)}
        cache["pos"] = int(cache["pos"]) + tokens.shape[1]
        x = apply_norm(cfg, p["final_norm"], x)
        return self._head(p, x[:, -1:]), cache

    def decode_step(self, p: Params, cache: Cache, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, Cache]:
        """tokens: (B, 1) -> (logits (B, 1, V), cache with ``pos`` + 1)."""
        cfg = self.cfg
        pos = int(cache["pos"])
        x = self._dec_embed(p, tokens, pos)
        cache = dict(cache)
        kv, xkv = cache["kv"], cache["cross_kv"]
        for i, blk in enumerate(p["decoder"]):
            h = apply_norm(cfg, blk["ln1"], x)
            o, _, _ = A.attn_decode(cfg, blk["attn"], h, kv["k"][i],
                                    kv["v"][i], pos)
            x = self._cross_mlp(blk, x + o, xkv["k"][i], xkv["v"][i])
        cache["pos"] = pos + 1
        x = apply_norm(cfg, p["final_norm"], x)
        return self._head(p, x), cache
