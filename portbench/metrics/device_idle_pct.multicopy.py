"""The device's idle share of the profiled multi-copy decode window: 1 - busy / window."""

from portbench.tracing import idle_pct as read  # noqa: F401
