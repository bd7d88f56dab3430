"""Initial parameter values (port of ``hmm_layer_tpu/models/initializers.py``).

Every initializer is a callable ``init(generator, shape, dtype=torch.float32)``
returning a CPU tensor; ``generator`` (a ``torch.Generator`` or ``None``)
feeds the random ones. The factories attach a JSON-able ``spec`` with the
same ``kind`` and fields as the JAX package's, so a component config
written by either package rebuilds the other's initializers
(:func:`init_to_config`, :func:`init_from_config`). The draws themselves
come from ``torch.Generator``, not ``jax.random``: compare the two packages
on parameters carried across, not on two inits.

Also: the profile-HMM defaults (named-edge transition logits, flank init,
background emission logits) and the gene-prediction class kernel.
"""

from __future__ import annotations

import functools
import inspect

import numpy as np
import torch

__all__ = [
    "constant_init",
    "tiled_dist_init",
    "random_normal_init",
    "entry_init",
    "exit_init",
    "match_transition_init",
    "make_default_transition_init",
    "make_default_flank_init",
    "make_default_emission_init",
    "make_15_class_emission_kernel",
    "init_to_config",
    "init_from_config",
]

_INIT_FACTORIES: dict = {}


def _jsonable(v):
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return np.asarray(v).tolist()
    return v


def _with_spec(kind):
    def deco(factory):
        _INIT_FACTORIES[kind] = factory

        @functools.wraps(factory)
        def wrapper(*args, **kwargs):
            fn = factory(*args, **kwargs)
            bound = inspect.signature(factory).bind(*args, **kwargs)
            bound.apply_defaults()
            fn.spec = {"kind": kind, **{k: _jsonable(v) for k, v in bound.arguments.items()}}
            return fn

        return wrapper

    return deco


def init_to_config(fn) -> dict:
    """JSON-able spec of an initializer built by this module."""
    spec = getattr(fn, "spec", None)
    if spec is None:
        raise ValueError(
            f"initializer {fn!r} has no serialization spec; build it from "
            "hmm_layer_torch.models.initializers (or attach a .spec dict "
            "matching a registered factory) to make the component "
            "config-serializable"
        )
    return dict(spec)


def init_from_config(spec: dict):
    """Inverse of :func:`init_to_config`."""
    spec = dict(spec)
    kind = spec.pop("kind")
    factory = _INIT_FACTORIES.get(kind)
    if factory is None:
        raise ValueError(f"unknown initializer kind {kind!r}; known: {sorted(_INIT_FACTORIES)}")
    return globals()[factory.__name__](**spec)


def _randn(generator, shape, dtype):
    return torch.randn(tuple(shape), generator=generator, dtype=dtype)


@_with_spec("constant")
def constant_init(value):
    """Fill with a constant scalar or tile a constant array."""
    value = np.asarray(value)

    def init(generator, shape, dtype=torch.float32):
        if value.ndim == 0:
            return torch.full(tuple(shape), float(value), dtype=dtype)
        arr = torch.as_tensor(value, dtype=dtype)
        if tuple(arr.shape) == tuple(shape):
            return arr.clone()
        reps = int(np.prod(shape)) // arr.numel()
        return arr.reshape(-1).repeat(reps).reshape(tuple(shape))

    return init


@_with_spec("tiled_dist")
def tiled_dist_init(dist):
    """Tile a fixed distribution along all leading axes."""
    dist = np.asarray(dist, np.float32)

    def init(generator, shape, dtype=torch.float32):
        assert shape[-1] == dist.shape[-1], f"last dim {shape[-1]} != dist size {dist.shape[-1]}"
        reps = int(np.prod(shape[:-1]))
        return torch.as_tensor(np.tile(dist, (reps, 1)).reshape(shape), dtype=dtype)

    return init


@_with_spec("random_normal")
def random_normal_init(mean=0.0, stddev=0.05):
    def init(generator, shape, dtype=torch.float32):
        return mean + stddev * _randn(generator, shape, dtype)

    return init


@_with_spec("entry")
def entry_init():
    """First entry 0 (logit), the remaining ones uniform."""

    def init(generator, shape, dtype=torch.float32):
        p0 = torch.zeros((1,) + tuple(shape[1:]), dtype=dtype)
        # max(..., 1) guards the length-1 profile (no remaining entries to
        # spread mass over), as match_transition_init does.
        rest = torch.full(
            (shape[0] - 1,) + tuple(shape[1:]), float(np.log(1.0 / max(shape[0] - 1, 1))), dtype=dtype
        )
        return torch.cat([p0, rest], dim=0)

    return init


@_with_spec("exit")
def exit_init():
    """Uniform exit mass of 0.5 split over the non-first matches."""

    def init(generator, shape, dtype=torch.float32):
        return torch.full(tuple(shape), float(np.log(0.5 / max(shape[0] - 1, 1))), dtype=dtype)

    return init


@_with_spec("match_transition")
def match_transition_init(val, i, scale=0.1):
    """Softmax-consistent match-transition logits with per-position noise."""
    val = np.asarray(val, np.float32)

    def init(generator, shape, dtype=torch.float32):
        z = scale * _randn(generator, (shape[0], 1), dtype)
        val_z = torch.as_tensor(val, dtype=dtype)[None, :] + z
        p_exit_desired = 0.5 / max(shape[0] - 1, 1)
        prob = torch.softmax(val_z, dim=-1) * (1.0 - p_exit_desired)
        return torch.log(prob[:, i])

    return init


def make_default_flank_init():
    return constant_init(0.0)


def make_default_emission_init(background=None, alphabet_size: int = 25, epsilon: float = 1e-3):
    """Match-emission logits from a background amino-acid distribution.

    The default background is the LG substitution model's stationary
    frequencies (:func:`~hmm_layer_torch.utils.substitution.lg_matrix`) in
    the first 20 channels, ``epsilon`` mass on any extra channels,
    renormalised; the logits are ``log(background)``, so the emission
    softmax starts exactly at the background distribution.
    """
    if background is None:
        from ..utils.substitution import lg_matrix

        _, background = lg_matrix()
    background = np.asarray(background, np.float64)
    if background.shape[-1] > alphabet_size:
        raise ValueError(
            f"background has {background.shape[-1]} channels > alphabet_size {alphabet_size}"
        )
    full = np.full((alphabet_size,), epsilon, np.float64)
    full[: background.shape[-1]] = background / background.sum()
    full = full / full.sum()
    return tiled_dist_init(np.log(full).astype(np.float32))


def make_default_transition_init(
    MM=1.0,
    MI=-1.0,
    MD=-1.0,
    II=-0.5,
    IM=0.0,
    DM=0.0,
    DD=-0.5,
    FC=0.0,
    FE=-1.0,
    R=-9.0,
    RF=0.0,
    T=0.0,
    scale=0.1,
):
    """Default initializer per Plan7 edge type (the explicit parts of
    :func:`~hmm_layer_torch.models.profile_transitions.explicit_transition_kernel_parts`)."""
    return {
        "begin_to_match": entry_init(),
        "match_to_end": exit_init(),
        "match_to_match": match_transition_init([MM, MI, MD], 0, scale),
        "match_to_insert": match_transition_init([MM, MI, MD], 1, scale),
        "insert_to_match": random_normal_init(IM, scale),
        "insert_to_insert": random_normal_init(II, scale),
        "match_to_delete": match_transition_init([MM, MI, MD], 2, scale),
        "delete_to_match": random_normal_init(DM, scale),
        "delete_to_delete": random_normal_init(DD, scale),
        "left_flank_loop": random_normal_init(FC, scale),
        "left_flank_exit": random_normal_init(FE, scale),
        "right_flank_loop": random_normal_init(FC, scale),
        "right_flank_exit": random_normal_init(FE, scale),
        "unannotated_segment_loop": random_normal_init(FC, scale),
        "unannotated_segment_exit": random_normal_init(FE, scale),
        "end_to_unannotated_segment": random_normal_init(R, scale),
        "end_to_right_flank": random_normal_init(RF, scale),
        "end_to_terminal": random_normal_init(T, scale),
    }


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
