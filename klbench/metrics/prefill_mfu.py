"""The prefill step's share of the bf16 peak: the frozen model flops of
the traced window's prefill calls (``klbench.counts.lm.prefill_flops``)
over the traced window times 989 TFLOP/s."""

from klbench.counts import lm
from klbench.reduce import mfu


def read(view, ctx):
    c = ctx["config"]
    return mfu(sum(lm.prefill_flops(c, b, s) for b, s in ctx["calls"]),
               view.window_s)
