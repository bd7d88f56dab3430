"""Lightweight training/inference metrics (port of
``hmm_layer_tpu/utils/metrics.py``): a metrics dict + JSON-lines writer and
a sequences-per-second meter. NumPy only.
"""

from __future__ import annotations

import json
import time

import numpy as np

__all__ = ["MetricsLogger", "Throughput"]


class MetricsLogger:
    """Collects scalar metrics per step; writes JSON lines to a file and/or
    stderr."""

    def __init__(self, path: str | None = None, stream=None, every: int = 1):
        self.path = path
        self.stream = stream
        self.every = every
        self._file = open(path, "a") if path else None
        self.history: list[dict] = []

    def log(self, step: int, **metrics):
        record = {"step": int(step)}
        for k, v in metrics.items():
            record[k] = float(np.asarray(v)) if not isinstance(v, str) else v
        self.history.append(record)
        if step % self.every == 0:
            line = json.dumps(record)
            if self._file:
                self._file.write(line + "\n")
                self._file.flush()
            if self.stream:
                print(line, file=self.stream, flush=True)
        return record

    def close(self):
        if self._file:
            self._file.close()
            self._file = None


class Throughput:
    """Sequences/sec meter on the host clock. Device work is asynchronous:
    read it after a synchronising call (e.g. ``float(loss)``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._count = 0

    def update(self, n: int):
        self._count += n

    @property
    def seqs_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._count / dt if dt > 0 else float("nan")
