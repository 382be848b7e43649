"""K4's share of its roofline at MLA's heads (q/k 192, v 128): the frozen
causal bound of every flash call the traced prefills made (each layer
once, batch x heads of the call's length, bf16;
``klbench.counts.mla_moe.k4``) over the summed device time of K4's
kernels launched inside the ``klbench.prefill`` ranges."""

from klbench.counts import mla_moe, peaks
from klbench.reduce import range_kernels, seconds, share

SYMBOLS = ("fa_wgmma_kernel", "fa_bf16_kernel", "fa_f32_kernel")


def read(view, ctx):
    c = ctx["config"]
    hits = range_kernels(view, "klbench.prefill")
    if len(hits) != len(ctx["calls"]):
        return None
    bound, t = 0.0, 0.0
    for (_, ks), (b, s) in zip(hits, ctx["calls"]):
        k4 = [k for k in ks if any(sym in k.name for sym in SYMBOLS)]
        if not k4:
            continue
        t += seconds(k4)
        bound += c["num_hidden_layers"] * peaks.bound_s(*mla_moe.k4(
            b * c["num_attention_heads"], s, c), "bfloat16")
    return share(bound / t) if t > 0 else None
