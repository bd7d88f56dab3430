"""Utilities of the port: :mod:`.checkpoint` (the ``.npz`` format shared
with the JAX package, training state and configs), :mod:`.metrics`
(JSON-lines metrics, throughput), :mod:`.resilience` (hang watchdog,
latest checkpoint), :mod:`.bijectors` (the MVN scale parameterisation),
:mod:`.profiling` (traces, synchronised timing, anomaly detection) and
:mod:`.substitution` (amino-acid substitution models). The submodules
load on first access."""

from __future__ import annotations

import importlib

_MODULES = ("bijectors", "checkpoint", "metrics", "profiling", "resilience", "substitution")

__all__ = list(_MODULES)


def __getattr__(name):
    if name not in _MODULES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return importlib.import_module(f".{name}", __name__)
