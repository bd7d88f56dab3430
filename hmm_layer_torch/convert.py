"""Carry trained weights from the JAX package to the port.

The JAX layer keeps its weights in a params pytree
``{"transitions": {...}, "emissions": [{...}, ...]}``; the port's
:class:`~hmm_layer_torch.layer.HMMLayer` owns the same arrays as module
parameters named after their place in that tree
(``transitions.transition_kernel``, ``emissions.0.emission_kernel``, ...).
Pass the tree with its leaves as NumPy arrays (``jax.device_get``); this
module imports no JAX.

The experimental Dirichlet transition prior's concentration is no
parameter: the JAX transitions keep it beside the params
(``np.asarray(transitions._prior_alpha())``), the port in the buffer
``prior_alpha``; :func:`set_prior_alpha` carries it across.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "load_jax_params", "set_prior_alpha"]


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


def set_prior_alpha(layer, alpha):
    """Set the Dirichlet concentration of ``layer``'s transitions (a layer
    or a transition module with ``use_experimental_prior``) to the JAX
    value ``alpha`` (1 + 6k, 2); returns the layer."""
    transitions = getattr(layer, "transitions", layer)
    if getattr(transitions, "prior_alpha", None) is None:
        raise ValueError("the transitions have no experimental prior (use_experimental_prior=False)")
    value = torch.tensor(np.asarray(alpha, np.float32))
    if value.shape != transitions.prior_alpha.shape:
        raise ValueError(
            f"alpha has shape {tuple(value.shape)}, expected {tuple(transitions.prior_alpha.shape)}"
        )
    transitions.prior_alpha.copy_(value)
    return layer
