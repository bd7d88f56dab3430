"""Device kernels a window batch in the profiled window of the multi-copy
decode: at q > 16 the sequential max-plus loop and the pointer walk launch
a few kernels a position."""

from portbench.tracing import kernels_per_unit as read  # noqa: F401
