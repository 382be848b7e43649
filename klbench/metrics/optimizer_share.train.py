"""The optimizer's share of the device's busy time in training: the device
time of the kernels launched inside the program's ``repro_torch.optimizer``
spans (AdamW's clipping and its moment and parameter passes) over the
traced window's busy time, in percent."""

from klbench.spans import kernel_share


def read(view, ctx):
    return kernel_share(view, "optimizer")
