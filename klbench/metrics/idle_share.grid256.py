"""The device's idle share of the traced window: 100 x (1 - busy / window),
busy the union of the device operations' intervals in it."""

from klbench.reduce import idle_share as read  # noqa: F401
