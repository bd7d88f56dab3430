"""Device kernels a window batch in the profiled window."""

from portbench.tracing import kernels_per_unit as read  # noqa: F401
