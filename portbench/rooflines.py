"""A roofline share over the launches of a set of kernels in the
profiled window: the sum of their least times (counted from the shapes,
:mod:`portbench.counts`) over the sum of their device times."""

from __future__ import annotations

from portbench import counts, tracing


def share_pct(rec, kernels):
    """``kernels``: {profiler name pattern: counts function of the shape}.
    None where none of them ran."""
    shape, device = rec["shape"], rec["device_name"]
    bound, spent = 0.0, 0.0
    for pattern, cost in kernels.items():
        n, secs = tracing.kernel_time(rec["trace"], pattern)
        if n:
            bound += n * counts.bound_s(*cost(shape), device)
            spent += secs
    return 100.0 * bound / spent if spent > 0 else None
