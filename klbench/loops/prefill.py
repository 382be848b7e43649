"""Batch prefill through ``DecoderLM.prefill``, calls back to back.

Each call prefills one batch of prompts of one of the traffic's ``shapes``
(batch, length). The calls come in blocks that hold each shape ``weights``
times, in an order drawn from the seed, so every seed sends the same mix;
token ids are uniform over the vocabulary. Each shape has one cache, made by ``init_cache`` in
set-up with room for exactly its prompts, so every call rewrites all of it
from position 0.

After the window, the last call of each shape is compared with the plain
decoder on the same prompts: every layer's K and V in the cache, and the
logits at the last position.
"""

from __future__ import annotations

import numpy as np
import torch

from klbench.harness import Check, annotation
from klbench.reference import decoder as R
from klbench.seeds import generator, rng
from klbench.weights import decoder_params

from ._lm import arch_config, rel_l2, row_rel_l2, top_gap


class Loop:
    def __init__(self, run):
        self.run = run
        self.c = run.config
        t = run.traffic
        self.shapes = [tuple(s) for s in t["shapes"]]
        block = np.repeat(np.arange(len(self.shapes)), t["weights"])
        r = rng(run.seed, "order")
        self.order = np.concatenate([r.permutation(block) for _ in range(
            -(-t["pool"] // len(block)))])
        self.calls: list[int] = []
        self.last: dict = {}

    def tokens(self, i: int) -> torch.Tensor:
        b, s = self.shapes[self.order[i % len(self.order)]]
        return self.pool[i % len(self.order), :b * s].view(b, s)

    def setup(self) -> None:
        from repro_torch.models import build_model
        run = self.run
        self.model = build_model(arch_config(self.c), device=run.device)
        run.mark("program imported")
        self.params = decoder_params(self.c, run.seed, run.device)
        n = max(b * s for b, s in self.shapes)
        self.pool = torch.randint(
            self.c["vocab_size"], (len(self.order), n), dtype=torch.int64,
            generator=generator(run.seed, "tokens", run.device),
            device=run.device)
        self.caches = [self.model.init_cache(b, s) for b, s in self.shapes]
        run.mark("weights, prompts and caches made")
        for k in range(len(self.shapes)):      # every shape once
            i = int(np.flatnonzero(self.order == k)[0])
            self.model.prefill(self.params, self.tokens(i), self.caches[k])

    def step(self, i: int, annotate: bool) -> int:
        k = int(self.order[i % len(self.order)])
        tok = self.tokens(i)
        with annotation(annotate, "klbench.prefill"):
            logits, _ = self.model.prefill(self.params, tok, self.caches[k])
        self.calls.append(k)
        self.last[k] = (i, logits)
        return tok.numel()

    def metrics(self, win) -> dict:
        return {"prefill_tokens_per_s": (win.work / win.elapsed_s,
                                         "tokens/s")}

    def context(self, win) -> dict:
        return {"config": self.c,
                "calls": [self.shapes[k] for k in self.calls]}

    def finish(self, win) -> tuple[int, int]:
        return win.steps, 0

    def release(self) -> None:
        del self.params, self.model

    def outputs(self):
        """(prompts, logits (B, V), {layer: (k, v)}) of the last call of each
        shape, the cache's K and V as (B, Hkv, S, D)."""
        for k, (i, logits) in sorted(self.last.items()):
            kv = self.caches[k]["kv"]
            yield (self.tokens(i), logits[:, -1],
                   lambda l, kv=kv: (kv["k"][l], kv["v"][l]))

    def check(self, fp8_control: bool = False) -> list[Check]:
        """The program's outputs against the reference; with
        ``fp8_control`` the reference in float8 takes the program's place."""
        params = decoder_params(self.c, self.run.seed, self.run.device)
        kv_gap = logit_gap = gap = 0.0
        for tok, logits, cache_kv in self.outputs():
            if fp8_control:
                logits, cache_kv = _fp8_outputs(self.c, params, tok)
            worst = [0.0]

            def on_kv(layer, k, v):
                pk, pv = cache_kv(layer)
                worst[0] = max(worst[0], rel_l2(pk, k), rel_l2(pv, v))

            ref = R.prefill(self.c, params, tok, on_kv=on_kv)
            kv_gap = max(kv_gap, worst[0])
            logit_gap = max(logit_gap, row_rel_l2(logits, ref))
            gap = max(gap, top_gap(logits, ref))
        lim = self.run.limits
        return [Check("kv_rel_l2", kv_gap, lim["kv_rel_l2"]),
                Check("logits_rel_l2", logit_gap, lim["logits_rel_l2"]),
                Check("top_logit_gap", gap, lim["top_logit_gap"])]


def _fp8_outputs(c: dict, params: dict, tok: torch.Tensor):
    """The float8 reference's logits and per-layer K, V (kept in f32)."""
    kv = {}

    def keep(layer, k, v):
        kv[layer] = (k, v)

    logits = R.prefill(c, params, tok, fp8=True, on_kv=keep)
    return logits, lambda layer: kv[layer]
