"""The prefill step's share of the bf16 peak: the frozen active flops of
the traced window's prefill calls (``klbench.counts.mla_moe.prefill_flops``)
over the traced window times 989 TFLOP/s."""

from klbench.counts import mla_moe
from klbench.reduce import mfu


def read(view, ctx):
    c = ctx["config"]
    return mfu(sum(mla_moe.prefill_flops(c, b, s) for b, s in ctx["calls"]),
               view.window_s)
