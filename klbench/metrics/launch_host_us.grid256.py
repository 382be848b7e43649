"""`launch_host_us` in the cells that report `step_ms.grid256`: see
``klbench.spans.launch_host_us``."""

from klbench.spans import launch_host_us as read  # noqa: F401
