"""Kernel times on the card with CUDA events, warm and cold.

``median_ms`` times ``reps`` back-to-back calls (after ``warmup`` calls);
their inputs then stay in the 50 MB L2 of an H100 when they fit.
``cold_median_ms`` writes a scratch buffer larger than the L2 before each
single call, so that the call finds its inputs in device memory. Both
return the median over ``samples`` in ms, and need a CUDA device.
"""

from __future__ import annotations

import statistics

import torch

FLUSH_BYTES = 256 * 2**20  # written before each cold call: five times the L2


def _event_ms(fn, reps=1):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, samples=20, reps=1, warmup=2):
    """Median over ``samples`` of (CUDA-event time of ``reps`` back-to-back
    calls) / reps, in ms."""
    for _ in range(warmup):
        fn()
    return statistics.median(_event_ms(fn, reps) for _ in range(samples))


def cold_median_ms(fn, samples=20):
    """Median over ``samples`` single calls, each timed after FLUSH_BYTES
    written to a scratch buffer, in ms."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for i in range(samples):
        flush.fill_(float(i))
        times.append(_event_ms(fn))
    return statistics.median(times)
