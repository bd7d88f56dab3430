"""hmm_layer_torch — the PyTorch/CUDA port of ``hmm_layer_tpu``.

The JAX package ``hmm_layer_tpu`` is the reference; this package computes
the same functions with PyTorch on an NVIDIA GPU, and its TPU (Pallas)
kernels become CUDA C++ kernels written for Hopper (``csrc/``). It imports
``torch`` and ``numpy`` only — never ``jax`` nor anything of the JAX
package.

Importing it initialises no CUDA context and compiles nothing: the kernels
are built by ``nvcc`` at their first launch (:mod:`.ops._cuda_build`), and
the public names below load their modules on first access.

Every float32 matrix product of the port runs in full IEEE float32 (no
TF32): the dynamic-programming recursions accumulate rounding linearly in
the sequence length, so reduced precision shows up as whole nats of
log-likelihood error.
"""

from __future__ import annotations

import importlib

import torch

torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

_EXPORTS = {
    "HMMLayer": ".layer",
    "forward": ".ops.recursion",
    "backward": ".ops.recursion",
    "posterior": ".ops.recursion",
    "log_likelihood": ".ops.recursion",
    "viterbi": ".ops.recursion",
    "recommended_parallel_factor": ".ops.recursion",
    "ForwardResult": ".ops.recursion",
    "set_dp_precision": ".ops.recursion",
    "dp_precision": ".ops.recursion",
    "Trainer": ".training",
    "load_jax_params": ".convert",
    "params_from_jax": ".convert",
    "set_prior_alpha": ".convert",
    "sample_posterior": ".ops.sampling",
    "em_step": ".ops.em",
    "expected_statistics": ".ops.em",
    "rnn_scan": ".ops.scan",
    "bidirectional_scan": ".ops.scan",
}
_MODULES = ("data", "models", "native", "ops", "parallel", "streaming", "utils")

__all__ = sorted(_EXPORTS) + list(_MODULES) + ["__version__"]


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f".{name}", __name__)
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name], __name__), name)
