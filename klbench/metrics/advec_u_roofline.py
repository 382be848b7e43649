"""`advec_u_roofline` in the cells that report `step_ms`: see
``klbench.reduce.advec_u_roofline``."""

from klbench.reduce import advec_u_roofline as read  # noqa: F401
