"""The gradient accumulator's share of the device's busy time in training:
the device time of the kernels launched inside the program's
``repro_torch.accumulate`` spans (the f32 accumulator's zeros, each
microbatch's ``add_`` and the final ``div_``, not the microbatches' forward
and backward) over the traced window's busy time, in percent."""

from klbench.spans import kernel_share


def read(view, ctx):
    return kernel_share(view, "accumulate")
