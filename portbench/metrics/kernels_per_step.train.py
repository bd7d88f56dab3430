"""Device kernels a training step in the profiled window."""

from portbench.tracing import kernels_per_unit as read  # noqa: F401
