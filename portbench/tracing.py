"""The profiled window: ``torch.profiler`` over a fixed amount of work,
reduced to what the per-layer metrics read.

The trace is exported as a Chrome trace into the run's temporary
directory, read back and deleted. Device activity is every kernel, copy and
set of memory on the device; the window is the harness's own annotation
around the work and the closing synchronise.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import Counter, defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW = "portbench.window"
TOP = 10


def profile(work, device):
    """Run ``work()`` (returns the units of work it did) under the
    profiler; returns the reduction (see :func:`reduce_trace`)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            units = work()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    finally:
        os.remove(path)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    out = reduce_trace(events)
    out["units"], out["host_s"] = units, host_s
    return out


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _short(name, width=96):
    return name if len(name) <= width else name[: width - 3] + "..."


def reduce_trace(events):
    """From Chrome-trace events: ``window_s``, ``busy_s`` (the union of
    device intervals inside the window), ``kernels`` {name: [count,
    seconds]} (kernel launches only), ``device_ops`` and ``idle_gaps`` (the
    top entries by seconds: device operations by name, and idle time by
    the innermost host operation that spanned it)."""
    window = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
    if not window:
        raise RuntimeError("the profiled window's annotation is missing from the trace")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    device, host = [], []
    kernels = defaultdict(lambda: [0, 0.0])
    ops = Counter()
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        if a + d < w0 or a > w1:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in DEVICE_CATS:
            device.append((max(a, w0), min(a + d, w1)))
            ops[_short(name)] += d * 1e-6
            if cat == "kernel":
                kernels[name][0] += 1
                kernels[name][1] += d * 1e-6
        elif cat in HOST_CATS and name != WINDOW:
            host.append((a, a + d, name))
    busy = _union(device)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    idle = _name_gaps(gaps, host)
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "kernels": {k: list(v) for k, v in kernels.items()},
        "device_ops": [[k, v] for k, v in ops.most_common(TOP)],
        "idle_gaps": idle,
    }


def _name_gaps(gaps, host):
    """Idle seconds by the innermost host operation spanning each gap's
    middle; ``host (outside any operation)`` where none did."""
    host.sort()
    starts = [h[0] for h in host]
    total, count = Counter(), Counter()
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        best = None
        for j in range(i - 1, max(i - 400, -1), -1):
            h0, h1, name = host[j]
            if h1 >= mid and (best is None or h1 - h0 < best[1] - best[0]):
                best = host[j]
        name = _short(best[2]) if best else "host (outside any operation)"
        total[name] += (b - a) * 1e-6
        count[name] += 1
    return [[f"{name} ({count[name]} gaps)", s] for name, s in total.most_common(TOP)]


def kernel_time(trace, pattern):
    """(launches, seconds) of the kernels whose name matches ``pattern``."""
    rx = re.compile(pattern)
    n, s = 0, 0.0
    for name, (count, secs) in trace["kernels"].items():
        if rx.search(name):
            n, s = n + count, s + secs
    return n, s


def idle_pct(rec):
    """The device's idle share of the profiled window: 1 - busy / window;
    None where no device operation is in the trace."""
    if rec["trace"]["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["trace"]["busy_s"] / rec["trace"]["window_s"])


def kernels_per_unit(rec):
    """Device kernels a unit of the profiled work (a step, a batch); None
    where no device operation is in the trace."""
    if rec["trace"]["busy_s"] <= 0:
        return None
    return sum(n for n, _ in rec["trace"]["kernels"].values()) / rec["trace"]["units"]
