"""MLA's share of the device's busy time in prefill: the device time of the
kernels launched inside the program's ``repro_torch.mla`` spans (the
query and latent projections, YaRN's rope, the latent's expansion, K4 and
the output projection of each layer) over the traced window's busy time,
in percent."""

from klbench.spans import kernel_share


def read(view, ctx):
    return kernel_share(view, "mla")
