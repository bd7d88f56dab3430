"""Profiling and debugging utilities (port of
``hmm_layer_tpu/utils/profiling.py``).

* :func:`trace` — a ``torch.profiler`` trace of the CPU and (where there is
  one) the CUDA device, written as a Chrome trace (viewable in Perfetto).
* :func:`timed` — wall-clock timing that waits for the device.
* :func:`debug_nans` — autograd anomaly detection (a backward that makes a
  NaN raises, naming the forward operation).
* :func:`span` — a named stage of the port, recorded only while a
  ``torch.profiler`` profile runs; :func:`recorded_spans` and
  :func:`clear_spans` read and empty the records.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import time

import torch

__all__ = ["trace", "timed", "debug_nans", "span", "recorded_spans", "clear_spans", "SpanRecord"]


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


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpanRecord:
    """One span of the newest profiler session: ``name``, host clock
    ``start_ns`` and ``end_ns`` (``time.perf_counter_ns``; ``end_ns`` None
    while the span is open), and the index in :func:`recorded_spans` of
    its ``parent`` (None for a root). Spans nest per thread: a span opened
    on the autograd engine's thread is a root there."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None


class _Thread(threading.local):
    def __init__(self):
        self.stack = []  # (the records list, index) of each open span


class _Recorder:
    """The records of the newest profiler session, and each thread's stack
    of open spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records: list[SpanRecord] = []  # a new list for every session
        self.recording = False  # false after a span opened with the profiler off
        self.thread = _Thread()

    def clear(self):
        with self.lock:
            self.records = []

    def open(self, name):
        stack = self.thread.stack
        with self.lock:
            if not self.recording:
                self.records, self.recording = [], True
            records = self.records
            index = len(records)
            # An enclosing span of an older session is no parent here.
            parent = stack[-1][1] if stack and stack[-1][0] is records else None
            record = SpanRecord(name, time.perf_counter_ns(), None, parent)
            records.append(record)
        stack.append((records, index))
        return record

    def close(self, record):
        record.end_ns = time.perf_counter_ns()
        self.thread.stack.pop()


_RECORDER = _Recorder()


class _Idle:
    """A span with no profiler running: enters and leaves doing nothing
    (one per name, shared). As a decorator, looks for a profiler at every
    call."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


class _Span(_Idle):
    """A span while a profiler runs: a ``record_function`` range in the
    profiler's trace and a :class:`SpanRecord`."""

    __slots__ = ("_range", "_record")

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._record = _RECORDER.open(self.name)
        return self

    def __exit__(self, *exc):
        _RECORDER.close(self._record)
        self._range.__exit__(*exc)
        return False


class _IdleSpans(dict):
    def __missing__(self, name):
        idle = self[name] = _Idle(name)
        return idle


_IDLE = _IdleSpans()


def span(name: str):
    """A named stage of the port, as a context manager (``with
    span("hmm.layer.viterbi"):``) or a decorator (``@span(...)``, which
    looks for a profiler at every call).

    With no ``torch.profiler`` profile running it is a shared no-op, and
    makes no other call. Under a profile it enters
    ``torch.profiler.record_function(name)``, so the span lands in the
    profile's Chrome trace beside the kernels and copies, on the trace's
    own clock (a ``user_annotation`` event), and it appends a
    :class:`SpanRecord` to :func:`recorded_spans`. The records' host clock
    serves durations only; to align a span with the device, read the
    trace's copy.

    The port's spans name its stages (``hmm.predict.*``, ``hmm.layer.*``,
    ``hmm.recursion.*``, ``hmm.train.*``, ``hmm.cuda.load``); none opens in
    a loop over positions, chunks or windows.
    """
    if not torch.autograd._profiler_enabled():
        _RECORDER.recording = False
        return _IDLE[name]
    return _Span(name)


def recorded_spans() -> list[SpanRecord]:
    """The spans of the newest profiler session, in the order they opened.

    A session starts at the first span opened with the profiler on after a
    span opened with it off, and that span clears the older records. Two
    profiler sessions with no span between them merge into one."""
    with _RECORDER.lock:
        return list(_RECORDER.records)


def clear_spans() -> None:
    """Drop every recorded span."""
    _RECORDER.clear()
