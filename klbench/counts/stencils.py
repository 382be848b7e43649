"""Counts of the two MicroHH kernels of the paper's section 5.

Copied from the program as it stood when the benchmark was written:

* flops a point: ``ADVEC_FLOPS_PER_POINT = 78`` and
  ``DIFF_FLOPS_PER_POINT_PER_FIELD = 27`` (``src/repro_torch/kernels/ref.py``
  lines 53 and 91), counted from the stencil terms;
* bytes: each field read once and each tendency written once
  (``stencil_workload``, ``src/repro_torch/kernels/_stencil_common.py`` lines
  229-262, called with ``fields=4`` by ``advec_u.py`` line 93 and
  ``fields=7`` by the fused ``diff_uvw.py`` line 124), plus the 16-byte
  scalar block.

``diff_uvw`` counts seven fields whichever body runs: the unfused path's
three launches re-read ``evisc`` twice, which the compulsory traffic does
not count.
"""

from __future__ import annotations

ADVEC_FLOPS_PER_POINT = 78
DIFF_FLOPS_PER_POINT = 3 * 27
SCAL_BYTES = 16
ELEM_BYTES = {"float32": 4, "bfloat16": 2}


def points(grid) -> int:
    nz, ny, nx = grid
    return nz * ny * nx


def advec_u(grid, dtype: str) -> tuple[float, float]:
    """(flops, bytes) of one ``advec_u`` call: u, v, w read, ut written."""
    n = points(grid)
    return (float(ADVEC_FLOPS_PER_POINT * n),
            float(4 * n * ELEM_BYTES[dtype] + SCAL_BYTES))


def diff_uvw(grid, dtype: str) -> tuple[float, float]:
    """(flops, bytes) of one ``diff_uvw`` call: u, v, w, evisc read, ut, vt,
    wt written."""
    n = points(grid)
    return (float(DIFF_FLOPS_PER_POINT * n),
            float(7 * n * ELEM_BYTES[dtype] + SCAL_BYTES))
