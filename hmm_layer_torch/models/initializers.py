"""Initial parameter values (port of ``hmm_layer_tpu/models/initializers.py``).

Only the gene-prediction class kernel is ported so far; the profile-HMM
initializers come with that family (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_15_class_emission_kernel"]


def make_15_class_emission_kernel(smoothing=0.1, num_copies=1, num_models=1):
    """Smoothed-identity 15-class emission logits for the gene-pred HMM, so
    upstream class probabilities pass through to the matching states.

    Returns log-probs of shape (num_models, 1 + 14*num_copies, 15).
    """
    if not smoothing > 0:
        raise ValueError("smoothing must be > 0 for numerical stability")
    n = 15
    probs = np.eye(n)
    probs += -probs * smoothing + (1 - probs) * smoothing / (n - 1)
    if num_copies > 1:
        repeats = [1] + [num_copies] * (probs.shape[-2] - 1)
        probs = np.repeat(probs, repeats, axis=-2)
    probs = np.repeat(probs[None, ...], num_models, axis=0)
    return np.log(probs).astype(np.float32)
