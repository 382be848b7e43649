"""The MoE FFN's share of the device's busy time in prefill: the device
time of the kernels launched inside the program's ``repro_torch.moe`` spans
(router, dispatch, the grouped expert products, the combine and the shared
experts of each MoE layer) over the traced window's busy time, in
percent."""

from klbench.spans import kernel_share


def read(view, ctx):
    return kernel_share(view, "moe")
