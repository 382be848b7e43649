"""The attention backward's share of the device's busy time in training:
the device time of the kernels launched inside the program's
``repro_torch.attn_backward`` spans (``FlashAttentionFn.backward``'s plain
recompute and its gradient, on the autograd thread that runs it) over the
traced window's busy time, in percent."""

from klbench.spans import kernel_share


def read(view, ctx):
    return kernel_share(view, "attn_backward")
