"""The device's idle share of the profiled training window of the q = 639-647 profile models: 1 - busy / window."""

from portbench.tracing import idle_pct as read  # noqa: F401
