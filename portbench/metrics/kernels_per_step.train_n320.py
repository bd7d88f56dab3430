"""Device kernels a training step in the profiled window of the q = 639-647
profile models: above K2c/K3c's q <= 512 each pass is an eager loop of a
few kernels a position."""

from portbench.tracing import kernels_per_unit as read  # noqa: F401
