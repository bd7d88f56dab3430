"""Failure detection and recovery for long-running training (port of
``hmm_layer_tpu/utils/resilience.py``).

* :func:`init_distributed_with_retries` — multi-process bring-up
  retries: ``torch.distributed.init_process_group`` with exponential
  backoff (ranks routinely race their rendezvous at start-up).
* :class:`HangWatchdog` — detects a wedged device step: arm it around a
  blocking host sync; on timeout it dumps every Python thread's stack and
  sets a flag the caller checks (a hung CUDA call cannot be interrupted
  safely from Python).
* :func:`latest_checkpoint` + :func:`hmm_layer_torch.utils.checkpoint.
  load_checkpoint` — recovery: restart the process, reload the newest
  step, continue.
"""

from __future__ import annotations

import faulthandler
import glob
import os
import re
import sys
import threading
import time

__all__ = ["init_distributed_with_retries", "HangWatchdog", "latest_checkpoint"]


def init_distributed_with_retries(max_retries: int = 5, backoff_s: float = 5.0, **kwargs) -> None:
    """:func:`hmm_layer_torch.parallel.init_distributed` (over
    ``torch.distributed.init_process_group``) with exponential-backoff
    retries; ``kwargs`` pass through (``backend``, ``init_method``,
    ``world_size``, ``rank``, ``timeout``)."""
    from ..parallel import init_distributed

    delay = backoff_s
    for attempt in range(max_retries + 1):
        try:
            init_distributed(**kwargs)
            return
        except Exception as e:  # noqa: BLE001 — any bring-up failure retries
            if attempt == max_retries:
                raise
            print(
                f"init_process_group failed (attempt {attempt + 1}/"
                f"{max_retries + 1}): {e}; retrying in {delay:.0f}s",
                file=sys.stderr,
                flush=True,
            )
            time.sleep(delay)
            delay *= 2


class HangWatchdog:
    """Detect hung device steps.

    Usage::

        wd = HangWatchdog(timeout_s=300)
        for batch in batches:
            with wd:                      # arm ... disarm
                loss = float(train_step(batch))   # blocking host sync
            if wd.fired:
                ...  # diagnostics were dumped; decide: restart / reload

    On timeout the watchdog dumps every Python thread's stack to
    ``stream`` and sets :attr:`fired`; ``on_timeout`` runs in the watchdog
    thread. It does not try to interrupt the hung call; the supported
    recovery is a process restart and a checkpoint reload
    (:func:`latest_checkpoint`).
    """

    def __init__(self, timeout_s: float, on_timeout=None, stream=None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self.stream = stream if stream is not None else sys.stderr
        self.fired = False
        self._timer: threading.Timer | None = None

    def _fire(self):
        self.fired = True
        print(
            f"HangWatchdog: step exceeded {self.timeout_s}s — thread stacks:",
            file=self.stream,
            flush=True,
        )
        try:
            faulthandler.dump_traceback(file=self.stream)
        except (OSError, ValueError, AttributeError):  # a stream without a file descriptor
            pass
        if self.on_timeout is not None:
            self.on_timeout()

    def arm(self):
        self.disarm()
        self._timer = threading.Timer(self.timeout_s, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def disarm(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def __enter__(self):
        self.arm()
        return self

    def __exit__(self, *exc):
        self.disarm()
        return False


def latest_checkpoint(checkpoint_dir: str) -> tuple[str, int] | None:
    """Newest ``step_*.npz`` in ``checkpoint_dir`` -> (path, step), or None."""
    best = None
    for path in glob.glob(os.path.join(checkpoint_dir, "step_*.npz")):
        found = re.search(r"step_(\d+)\.npz$", path)
        if found:
            step = int(found.group(1))
            if best is None or step > best[1]:
                best = (path, step)
    return best
