"""Recursions, semiring primitives, k-mers, auxiliary inference and the
CUDA kernels of the port.

Submodules: :mod:`.semiring`, :mod:`.kmer`, :mod:`.recursion`,
:mod:`.sampling` (posterior path sampling), :mod:`.em` (Baum-Welch),
:mod:`.scan` (scan loops for custom cells), :mod:`.sparse` (the
recursions over COO edge lists, for large multi-copy models),
:mod:`.cuda_forward`
(kernels K1–K3, K2c–K3c), :mod:`.cuda_adjoint` (kernels K4–K5),
:mod:`.cuda_viterbi` (kernels K6–K8b, K7c–K8c), :mod:`.cuda_mxu` (K9) and
:mod:`._cuda_build` (their build). The names in ``__all__`` (the JAX
package's ``ops`` namespace: functions, constants and submodules) load
their modules on first access.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "ForwardResult": ".recursion",
    "forward": ".recursion",
    "backward": ".recursion",
    "posterior": ".recursion",
    "log_likelihood": ".recursion",
    "viterbi": ".recursion",
    "logmatmul": ".semiring",
    "logmatvec": ".semiring",
    "maxmatmul": ".semiring",
    "maxargmatvec": ".semiring",
    "log_normalize": ".semiring",
    "EPS": ".semiring",
    "LOG_ZERO": ".semiring",
    "em_step": ".em",
    "expected_statistics": ".em",
    "sample_posterior": ".sampling",
    "rnn_scan": ".scan",
    "bidirectional_scan": ".scan",
}

_MODULES = ("em", "kmer", "plan7", "recursion", "sampling", "scan", "semiring", "sparse")

__all__ = sorted(_EXPORTS) + list(_MODULES)


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f".{name}", __name__)
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name], __name__), name)
