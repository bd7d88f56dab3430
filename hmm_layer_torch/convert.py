"""Carry trained weights from the JAX package to the port.

The JAX layer keeps its weights in a params pytree
``{"transitions": {...}, "emissions": [{...}, ...]}``; the port's
:class:`~hmm_layer_torch.layer.HMMLayer` owns the same arrays as module
parameters named after their place in that tree
(``transitions.transition_kernel``, ``emissions.0.emission_kernel``, ...).
Pass the tree with its leaves as NumPy arrays (``jax.device_get``); this
module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "load_jax_params"]


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` entries for a JAX params pytree: nested
    dict keys and list positions joined by dots, leaves as CPU tensors."""
    state = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for key, value in node.items():
                walk(f"{prefix}{key}.", value)
        elif isinstance(node, (list, tuple)):
            for i, value in enumerate(node):
                walk(f"{prefix}{i}.", value)
        else:
            state[prefix[:-1]] = torch.from_numpy(np.array(node))

    walk("", tree)
    return state


def load_jax_params(layer, tree):
    """Load a JAX params pytree into ``layer`` (strictly: every parameter
    present, shapes equal); returns the layer."""
    layer.load_state_dict(params_from_jax(tree))
    return layer
