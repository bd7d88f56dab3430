"""Failure detection and recovery for long-running training (port of
``hmm_layer_tpu/utils/resilience.py``, single-device part).

* :class:`HangWatchdog` — detects a wedged device step: arm it around a
  blocking host sync; on timeout it dumps every Python thread's stack and
  sets a flag the caller checks (a hung CUDA call cannot be interrupted
  safely from Python).
* :func:`latest_checkpoint` + :func:`hmm_layer_torch.utils.checkpoint.
  load_checkpoint` — recovery: restart the process, reload the newest
  step, continue.

``init_distributed_with_retries`` waits for the multi-device port
(ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import faulthandler
import glob
import os
import re
import sys
import threading

__all__ = ["HangWatchdog", "latest_checkpoint"]


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
