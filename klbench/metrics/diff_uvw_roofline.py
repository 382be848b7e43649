"""`diff_uvw_roofline` in the cells that report `step_ms`: see
``klbench.reduce.diff_uvw_roofline``."""

from klbench.reduce import diff_uvw_roofline as read  # noqa: F401
