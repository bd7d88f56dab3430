"""Parameter checkpoints in the JAX package's ``.npz`` format (port of
``hmm_layer_tpu/utils/checkpoint.py``).

A checkpoint is one ``.npz`` file whose keys are the parameters' places in
the JAX params tree joined by ``/`` (``transitions/transition_kernel``,
``emissions/0/emission_kernel``), plus an optional JSON sidecar
``<base>.meta.json`` for metadata such as the training step. The port's
``state_dict`` names are the same places joined by dots, so a checkpoint
written by either package loads into the other.

A training checkpoint (``Trainer.fit``) holds the full training state, as
the JAX trainer's ``{"params", "opt_state"}`` does: the parameters under
``params/`` and the ``torch.optim`` state under ``opt_state/`` (each state
tensor as an array, the parameter groups as one JSON string; nothing is
pickled). :func:`load_checkpoint` reads both kinds.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "load_metadata", "save_config", "load_config"]

_SEP = "/"
_PARAMS, _OPT = "params", "opt_state"


def _key(name: str) -> str:
    """Checkpoint key of a ``state_dict`` name."""
    return name.replace(".", _SEP)


def _meta_path(path: str) -> str:
    """Sidecar path, whether or not ``path`` carries the ``.npz`` suffix
    (``np.savez`` appends it when absent)."""
    base = path[: -len(".npz")] if path.endswith(".npz") else path
    return base + ".meta.json"


def _optimizer_arrays(optimizer) -> dict:
    state = optimizer.state_dict()
    arrays = {f"{_OPT}/param_groups": np.asarray(json.dumps(state["param_groups"]))}
    for index, entries in state["state"].items():
        for name, value in entries.items():
            if value is None:  # an absent buffer (``state.get`` finds none either)
                continue
            if isinstance(value, torch.Tensor):
                value = value.detach().cpu().numpy()
            arrays[f"{_OPT}/state/{index}/{name}"] = np.asarray(value)
    return arrays


def _optimizer_state(data) -> dict:
    state = {}
    for key in data.files:
        parts = key.split(_SEP)
        if parts[:2] == [_OPT, "state"]:
            state.setdefault(int(parts[2]), {})[parts[3]] = torch.from_numpy(np.array(data[key]))
    return {"state": state, "param_groups": json.loads(str(data[f"{_OPT}/param_groups"]))}


def save_checkpoint(path: str, module, step: int | None = None, optimizer=None, **metadata):
    """Write the parameters of ``module`` (an ``nn.Module``) and optional
    metadata to ``path`` (.npz); with ``optimizer`` (a ``torch.optim``
    optimizer over the module's parameters) the training state too."""
    arrays = {_key(name): t.detach().cpu().numpy() for name, t in module.state_dict().items()}
    if optimizer is not None:
        arrays = {f"{_PARAMS}/{key}": value for key, value in arrays.items()}
        arrays.update(_optimizer_arrays(optimizer))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)
    meta = dict(metadata)
    if step is not None:
        meta["step"] = step
    if meta:
        with open(_meta_path(path), "w") as f:
            json.dump(meta, f, indent=2, default=str)


def load_checkpoint(path: str, module, optimizer=None):
    """Load a checkpoint into ``module`` strictly (every parameter present,
    shapes equal) and return the module.

    A training checkpoint's parameters (``params/``, also those of the
    JAX trainer) load the same way; its ``torch.optim`` state goes into
    ``optimizer`` when one is given. A parameters-only checkpoint leaves
    ``optimizer`` as it is.
    """
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    state = {}
    with np.load(path) as data:
        training = any(key.startswith(f"{_PARAMS}/") for key in data.files)
        prefix = f"{_PARAMS}/" if training else ""
        for name, current in module.state_dict().items():
            key = prefix + _key(name)
            if key not in data:
                raise KeyError(f"checkpoint missing parameter {key!r}")
            arr = data[key]
            if arr.shape != tuple(current.shape):
                raise ValueError(
                    f"shape mismatch for {key!r}: checkpoint {arr.shape} vs "
                    f"model {tuple(current.shape)}"
                )
            state[name] = torch.from_numpy(arr)
        if optimizer is not None and f"{_OPT}/param_groups" in data.files:
            optimizer.load_state_dict(_optimizer_state(data))
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


def save_config(path: str, config: dict):
    """Write a layer or component config as JSON (arrays and tensors as
    lists)."""
    with open(path, "w") as f:
        json.dump(config, f, indent=2, default=_json_default)


def load_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _json_default(o):
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().numpy().tolist()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    raise TypeError(f"not JSON serializable: {type(o)}")
