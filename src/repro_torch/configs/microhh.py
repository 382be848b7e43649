"""The paper's own application: MicroHH CFD kernel scenarios (§5), port of
``repro.configs.microhh``.

{advec_u, diff_uvw} x {256^3, 512^3} x {float32, bfloat16} on the H100: the
reference's table with the device swapped for the card this port runs on.
The paper's float/double pair stays float32/bfloat16, as in the reference:
double would be a feature the JAX package lacks.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

KERNELS = ("advec_u", "diff_uvw")
GRIDS = ((256, 256, 256), (512, 512, 512))
DTYPES = ("float32", "bfloat16")     # paper: float / double
DEVICES = ("gpu-h100",)              # paper: A4000 / A100

# smaller grids for fast CI / smoke paths
SMOKE_GRIDS = ((32, 32, 128), (64, 64, 128))


@dataclass(frozen=True)
class Scenario:
    kernel: str
    grid: tuple[int, int, int]
    dtype: str
    device: str

    @property
    def key(self) -> str:
        g = self.grid[0]
        return f"{self.kernel}-{g}^3-{self.dtype}-{self.device}"


def scenarios(grids=GRIDS, devices=DEVICES) -> list[Scenario]:
    return [Scenario(k, g, p, d)
            for k, g, p, d in itertools.product(KERNELS, grids, DTYPES,
                                                devices)]
