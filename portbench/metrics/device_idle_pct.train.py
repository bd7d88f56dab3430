"""The device's idle share of the profiled training window: 1 - busy / window."""

from portbench.tracing import idle_pct as read  # noqa: F401
