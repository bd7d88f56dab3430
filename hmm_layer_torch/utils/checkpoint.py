"""Parameter checkpoints in the JAX package's ``.npz`` format (port of
``hmm_layer_tpu/utils/checkpoint.py``).

A checkpoint is one ``.npz`` file whose keys are the parameters' places in
the JAX params tree joined by ``/`` (``transitions/transition_kernel``,
``emissions/0/emission_kernel``), plus an optional JSON sidecar
``<base>.meta.json`` for metadata such as the training step. The port's
``state_dict`` names are the same places joined by dots, so a checkpoint
written by either package loads into the other. NumPy only.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "load_metadata"]

_SEP = "/"


def _key(name: str) -> str:
    """Checkpoint key of a ``state_dict`` name."""
    return name.replace(".", _SEP)


def _meta_path(path: str) -> str:
    """Sidecar path, whether or not ``path`` carries the ``.npz`` suffix
    (``np.savez`` appends it when absent)."""
    base = path[: -len(".npz")] if path.endswith(".npz") else path
    return base + ".meta.json"


def save_checkpoint(path: str, module, step: int | None = None, **metadata):
    """Write the parameters of ``module`` (an ``nn.Module``) and optional
    metadata to ``path`` (.npz)."""
    arrays = {_key(name): t.detach().cpu().numpy() for name, t in module.state_dict().items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)
    meta = dict(metadata)
    if step is not None:
        meta["step"] = step
    if meta:
        with open(_meta_path(path), "w") as f:
            json.dump(meta, f, indent=2, default=str)


def load_checkpoint(path: str, module):
    """Load a checkpoint into ``module`` strictly (every parameter present,
    shapes equal) and return the module."""
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    state = {}
    with np.load(path) as data:
        for name, current in module.state_dict().items():
            key = _key(name)
            if key not in data:
                raise KeyError(f"checkpoint missing parameter {key!r}")
            arr = data[key]
            if arr.shape != tuple(current.shape):
                raise ValueError(
                    f"shape mismatch for {key!r}: checkpoint {arr.shape} vs "
                    f"model {tuple(current.shape)}"
                )
            state[name] = torch.from_numpy(arr)
    module.load_state_dict(state)
    return module


def load_metadata(path: str) -> dict:
    """Metadata sidecar of a checkpoint, with or without the ``.npz``
    suffix on ``path`` (the suffix-appended sidecar name is read too)."""
    for candidate in (_meta_path(path), path + ".meta.json"):
        if os.path.exists(candidate):
            with open(candidate) as f:
                return json.load(f)
    return {}
