"""The routed experts' share of their roofline: the frozen bound of every
MoE call the traced prefills made (``klbench.counts.mla_moe.experts``: the
top-k pairs' three products; every expert's weights, the gathered inputs
and the outputs moved once) over the device time of the kernels launched
inside the program's ``repro_torch.experts`` spans."""

from klbench.counts import mla_moe, peaks
from klbench.reduce import seconds, share
from klbench.spans import PREFIX, range_kernels


def read(view, ctx):
    c = ctx["config"]
    hits = [ks for _, ks in range_kernels(view, PREFIX + "experts")]
    moe_layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
    if not hits or len(hits) != moe_layers * len(ctx["calls"]):
        return None
    t = sum(seconds(ks) for ks in hits)
    bound = moe_layers * sum(
        peaks.bound_s(*mla_moe.experts(c, b * s), "bfloat16")
        for b, s in ctx["calls"])
    return share(bound / t) if t > 0 else None
