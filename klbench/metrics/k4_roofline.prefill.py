"""K4's share of its roofline in prefill: the frozen causal bound of every
flash call the traced prefills made (each layer once, batch x heads query
heads of the call's length, bf16) over the summed device time of K4's
kernels launched inside the ``klbench.prefill`` ranges. K4's kernels are
the ones whose name holds one of ``SYMBOLS``."""

from klbench.counts import flash, peaks
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
        bound += c["num_hidden_layers"] * peaks.bound_s(*flash.attention(
            b * c["num_attention_heads"], b * c["num_key_value_heads"], s,
            c["head_dim"], "bfloat16"), "bfloat16")
    return share(bound / t) if t > 0 else None
