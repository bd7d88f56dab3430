"""Profiling and debugging utilities (port of
``hmm_layer_tpu/utils/profiling.py``).

* :func:`trace` — a ``torch.profiler`` trace of the CPU and (where there is
  one) the CUDA device, written as a Chrome trace (viewable in Perfetto).
* :func:`timed` — wall-clock timing that waits for the device.
* :func:`debug_nans` — autograd anomaly detection (a backward that makes a
  NaN raises, naming the forward operation).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "timed", "debug_nans"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write ``log_dir/trace.json`` (Chrome trace
    format). Yields the ``torch.profiler.profile`` object, whose
    ``key_averages()`` tabulate the recorded operations and kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _device_sync(result):
    """Wait for the devices of the tensors in ``result`` (a tensor, or a
    nested tuple/list/dict of them)."""
    stack, devices = [result], set()
    while stack:
        item = stack.pop()
        if isinstance(item, torch.Tensor):
            devices.add(item.device)
        elif isinstance(item, dict):
            stack.extend(item.values())
        elif isinstance(item, (tuple, list)):
            stack.extend(item)
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def timed(fn, *args, sync=None, iters: int = 1, warmup: int = 1, **kwargs):
    """Time ``fn(*args, **kwargs)``; returns (seconds_per_call, last_result).

    ``sync(result)`` must wait for the work to finish; by default it
    synchronises every CUDA device that holds a tensor of the result.
    """
    sync = _device_sync if sync is None else sync
    for _ in range(warmup):
        sync(fn(*args, **kwargs))
    t0 = time.perf_counter()
    result = None
    for _ in range(iters):
        result = fn(*args, **kwargs)
        sync(result)
    return (time.perf_counter() - t0) / iters, result


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Autograd anomaly detection on (``enable``) or off within the block;
    the previous setting is restored after it."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)
