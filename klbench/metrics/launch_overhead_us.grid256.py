"""`launch_overhead_us` in the cells that report `step_ms.grid256`: see
``klbench.reduce.launch_overhead_us``."""

from klbench.reduce import launch_overhead_us as read  # noqa: F401
