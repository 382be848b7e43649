"""Batch prefill of a DeepSeek-V2 decoder (MLA attention, DeepSeekMoE FFN)
through ``DecoderLM.prefill``, calls back to back.

The calls, shapes, prompts and caches are ``prefill.Loop``'s: blocks that
hold each shape ``weights`` times in an order drawn from the seed, token
ids uniform over the vocabulary, one latent cache per shape rewritten from
position 0 by every call. The model is the configuration file's
(``arch_config``), its weights ``klbench.weights_mla_moe``'s.

After the window, the last call of each shape is compared with the plain
reference (``klbench.reference.deepseek_v2``) on the same prompts: every
layer's ``c_kv`` and ``k_pe`` in the cache, the logits at the last
position, and each MoE layer on the program's own input: the model and
the weights the window timed run that prefill again with each layer's MoE
FFN output set beside the reference's FFN on the same input, and the
check counts the rows off by more than :data:`MOE_ROW_GAP`. Dropped
(token, expert) pairs barely move the logits after 26 residual layers;
they move whole rows of the layer's output. The loop therefore keeps its
model and weights past ``release`` for the check; they go with the loop.

Just before the window the loop puts a list in the program's counter of
routed pairs and of the busiest expert's load (``moe.EXPERT_LOAD``), which
a traced window fills on the device; ``context`` takes it back once the
window is over.

Where the run's device is not a card (the CPU rehearsals), the loop runs
:data:`REHEARSAL`, the same kinds of layers at the CPU tests' widths, on
:data:`REHEARSAL_SHAPES`: the CPU cannot hold the configuration.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from klbench.harness import Check
from klbench.reference import deepseek_v2 as R
from klbench.seeds import generator
from klbench.weights_mla_moe import params as dsv2_params

from . import prefill
from ._lm import rel_l2, row_rel_l2, top_gap

#: A row of a MoE layer's output is off when its relative L2 gap from the
#: reference's exceeds this (PERF.md section 2).
MOE_ROW_GAP = 0.05
#: 1 dense + 2 MoE layers at d 256: 8 routed experts of 64, top-2, 1
#: shared; MLA at kv_lora 64, nope 32, rope 16, v 32; YaRN over 64 original
#: positions, so that the ramp bites at the rehearsal's lengths. The
#: program computes in float32 here: at these widths bf16's rounding flips
#: near-tied routes, and a flip moves a row of 512 logits by 10 %.
REHEARSAL = {
    "name": "deepseek-v2-lite-rehearsal", "num_hidden_layers": 3,
    "hidden_size": 256, "num_attention_heads": 4, "num_key_value_heads": 4,
    "intermediate_size": 512, "vocab_size": 512, "q_lora_rank": None,
    "kv_lora_rank": 64, "qk_nope_head_dim": 32, "qk_rope_head_dim": 16,
    "v_head_dim": 32, "first_k_dense_replace": 1, "n_routed_experts": 8,
    "num_experts_per_tok": 2, "n_shared_experts": 1,
    "moe_intermediate_size": 64, "norm_topk_prob": False,
    "routed_scaling_factor": 1, "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 64,
                     "type": "yarn"},
    "max_position_embeddings": 2560, "tie_word_embeddings": False,
    "torch_dtype": "float32"}
REHEARSAL_SHAPES = [[2, 128], [1, 256]]


def arch_config(c: dict, **moe):
    """The program's ``ArchConfig`` for the configuration file ``c``;
    ``moe`` overrides fields of its ``MoECfg`` (the planted faults)."""
    from repro_torch.models import ArchConfig, MLACfg, MoECfg, YarnCfg
    y = c["rope_scaling"]
    if c["routed_scaling_factor"] != 1 or c["q_lora_rank"] is not None:
        raise ValueError(f"{c['name']}: the program takes "
                         f"routed_scaling_factor 1 and no query LoRA")
    cfg = ArchConfig(
        name=c["name"], family="moe", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_head=c["v_head_dim"],
        d_ff=c["intermediate_size"], vocab=c["vocab_size"],
        rope_theta=float(c["rope_theta"]),
        yarn=YarnCfg(factor=float(y["factor"]),
                     original_max_pos=y["original_max_position_embeddings"],
                     beta_fast=float(y["beta_fast"]),
                     beta_slow=float(y["beta_slow"]),
                     mscale=float(y["mscale"]),
                     mscale_all_dim=float(y["mscale_all_dim"])),
        max_seq=c["max_position_embeddings"],
        mla=MLACfg(q_lora=None, kv_lora=c["kv_lora_rank"],
                   d_nope=c["qk_nope_head_dim"], d_rope=c["qk_rope_head_dim"],
                   d_v=c["v_head_dim"]),
        moe=MoECfg(n_routed=c["n_routed_experts"],
                   top_k=c["num_experts_per_tok"],
                   d_expert=c["moe_intermediate_size"],
                   n_shared=c["n_shared_experts"], capacity_factor=None,
                   norm_topk_prob=c["norm_topk_prob"], router_f32=True),
        dense_layers=tuple(range(c["first_k_dense_replace"])),
        tie_embeddings=c["tie_word_embeddings"],
        param_dtype=c["torch_dtype"], compute_dtype=c["torch_dtype"])
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


#: The planted faults of ``check(variant=...)``: the reference options
#: whose outputs take the program's place in the latent and logit checks,
#: and the ``MoECfg`` fields of a second program, built with the fault,
#: whose MoE layers the MoE check compares. Where a fault has no reference
#: options (``capacity``), that faulty program's own prefill gives the
#: latents and the logits too.
VARIANTS = {
    None: ({}, {}),
    "fp8": ({"fp8": True}, {}),
    "renorm": ({"renorm": True}, {"norm_topk_prob": True}),
    "plain_rope": ({"plain_rope": True}, {}),
    "capacity": (None, {"capacity_factor": 1.25}),
}


class Loop(prefill.Loop):
    def __init__(self, run):
        if run.device.type != "cuda":
            run.config = REHEARSAL
            run.traffic = dict(run.traffic, shapes=REHEARSAL_SHAPES,
                               weights=[1] * len(REHEARSAL_SHAPES))
        super().__init__(run)

    def setup(self) -> None:
        from repro_torch.models import build_model
        run = self.run
        self.model = build_model(arch_config(self.c), device=run.device)
        run.mark("program imported")
        self.params = dsv2_params(self.c, run.seed, run.device)
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
        _count_expert_load()                   # the window's calls only

    def release(self) -> None:
        """Keeps the model and the weights: :meth:`check` compares the
        objects the window timed."""

    def context(self, win) -> dict:
        ctx = super().context(win)
        ctx["expert_load"] = _take_expert_load()
        ctx["n_experts"] = self.c["n_routed_experts"]
        return ctx

    def outputs(self):
        """(prompts, logits (B, V), latent(layer) -> (c_kv, k_pe)) of the
        last call of each shape, from the cache."""
        for k, (i, logits) in sorted(self.last.items()):
            yield (self.tokens(i), logits[:, -1],
                   _latents(self.c, self.caches[k]))

    def check(self, variant: str | None = None) -> list[Check]:
        """The program's outputs against the reference, its MoE layers
        rerun by the model on the weights the window timed; with
        ``variant`` one of :data:`VARIANTS`' planted faults takes the
        program's place (``fp8``: the reference in float8, one precision
        below bf16), a second model built only for a fault of the MoE
        layers."""
        from repro_torch.models import build_model
        c, run, params = self.c, self.run, self.params
        _take_expert_load()                    # counts nothing more
        swap, moe_fault = VARIANTS[variant]
        model = (build_model(arch_config(c, **moe_fault), device=run.device)
                 if moe_fault else self.model)
        latent_gap = logit_gap = gap = rows_off = 0.0
        for tok, logits, latent in self.outputs():
            off, own = moe_rows_off(c, model, params, tok,
                                    fp8=variant == "fp8")
            rows_off = max(rows_off, off)
            if swap:
                logits, latent = _reference_outputs(c, params, tok, **swap)
            elif moe_fault:
                logits, latent = own
            del own
            worst = [0.0]

            def on_latent(layer, c_kv, k_pe):
                pc, pk = latent(layer)
                worst[0] = max(worst[0], rel_l2(pc, c_kv), rel_l2(pk, k_pe))

            ref = R.prefill(c, params, tok, on_latent=on_latent)
            latent_gap = max(latent_gap, worst[0])
            logit_gap = max(logit_gap, row_rel_l2(logits, ref))
            gap = max(gap, top_gap(logits, ref))
        del model
        lim = run.limits
        return [Check("latent_rel_l2", latent_gap, lim["latent_rel_l2"]),
                Check("logits_rel_l2", logit_gap, lim["logits_rel_l2"]),
                Check("top_logit_gap", gap, lim["top_logit_gap"]),
                Check("moe_rows_off", rows_off, lim["moe_rows_off"])]


def _count_expert_load() -> None:
    """Puts a fresh list in the program's counter (``moe.EXPERT_LOAD``),
    for a program that has it."""
    from repro_torch.models import moe
    if hasattr(moe, "EXPERT_LOAD"):
        moe.EXPERT_LOAD = []


def _take_expert_load() -> list:
    """The program's (routed pairs, busiest expert's pairs) of each MoE
    call since :func:`_count_expert_load`, read to the host, the counter
    taken back; empty for a program without the counter."""
    from repro_torch.models import moe
    load = getattr(moe, "EXPERT_LOAD", None)
    if hasattr(moe, "EXPERT_LOAD"):
        moe.EXPERT_LOAD = None
    return torch.stack(load).tolist() if load else []


def _latents(c: dict, cache: dict):
    """latent(layer) -> (c_kv, k_pe) of ``cache``, a prefilled cache."""
    n_dense = c["first_k_dense_replace"]

    def latent(layer):
        m, j = ((cache["mla_dense"], layer) if layer < n_dense
                else (cache["mla"], layer - n_dense))
        return m["c_kv"][j], m["k_pe"][j]

    return latent


def _reference_outputs(c: dict, params: dict, tok, **faults):
    """The reference's logits and per-layer latents (kept in f32) under
    ``faults``."""
    lat = {}

    def keep(layer, c_kv, k_pe):
        lat[layer] = (c_kv, k_pe)

    logits = R.prefill(c, params, tok, on_latent=keep, **faults)
    return logits, lambda layer: lat[layer]


def moe_rows_off(c: dict, model, params: dict, tok, fp8: bool = False):
    """The program ``model`` prefills ``tok`` on ``params`` with each MoE
    layer's output compared, on the layer's own input, with the
    reference's MoE FFN in float32 (or, with ``fp8``, the reference's in
    float8 put in the program's place). Returns the largest share over
    layers, in %, of rows whose relative L2 gap exceeds
    :data:`MOE_ROW_GAP`, and that prefill's (logits (B, V) at the last
    position, latent(layer) -> (c_kv, k_pe))."""
    from repro_torch.models import moe
    orig, worst = moe.moe_ffn, [0.0]

    def compared(cfg, p, h):
        y, aux = orig(cfg, p, h)
        with R.ieee_f32():
            lp = R.f32(p)
            want = R.moe(c, lp, h.to(torch.float32))
            if fp8:
                y = R.moe(c, lp, h.to(torch.float32), fp8=True).to(y.dtype)
        err = (torch.linalg.vector_norm(y.to(torch.float32) - want, dim=-1)
               / torch.linalg.vector_norm(want, dim=-1))
        worst[0] = max(worst[0], float((err > MOE_ROW_GAP).float().mean()))
        return y, aux

    moe.moe_ffn = compared
    try:
        b, s = tok.shape
        with torch.no_grad():
            logits, cache = model.prefill(params, tok,
                                          model.init_cache(b, s))
    finally:
        moe.moe_ffn = orig
    return 100.0 * worst[0], (logits[:, -1].clone(), _latents(c, cache))
