"""The training step's share of the bf16 peak: the frozen model flops of
the traced window's steps (``klbench.counts.lm.train_flops``: 3 x the
forward, remat's recompute not counted) over the traced window times
989 TFLOP/s."""

from klbench.counts import lm
from klbench.reduce import mfu


def read(view, ctx):
    return mfu(ctx["steps"] * lm.train_flops(ctx["config"], ctx["batch"],
                                              ctx["seq"]), view.window_s)
