"""`sync_idle_share` in the cells that report `prefill_tokens_per_s`: see
``klbench.spans.sync_idle_share``."""

from klbench.spans import sync_idle_share as read  # noqa: F401
