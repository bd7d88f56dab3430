"""Seeded generators and weights: every input and weight of a run comes
from ``--seed`` through here, drawn on the run's device in a few large
calls."""

from __future__ import annotations

import zlib

import numpy as np
import torch

_MASK = (1 << 63) - 1


def derived(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose (weights, inputs, order, ...) of a
    run seed of any size."""
    return (int(seed) * 0x9E3779B97F4A7C15 + zlib.crc32(purpose.encode())) & _MASK


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derived(seed, purpose))


def rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng(derived(seed, purpose))


def noisy_params(bases: dict, sd: float, seed: int, device) -> dict:
    """name -> float32 tensor on ``device``: each base plus ``sd`` N(0, 1),
    the noise of all parameters drawn in one call."""
    sizes = [int(np.prod(np.shape(v))) for v in bases.values()]
    noise = torch.randn(sum(sizes), generator=generator(seed, "weights", device), device=device)
    out, start = {}, 0
    for (name, base), n in zip(bases.items(), sizes):
        value = torch.as_tensor(np.asarray(base), dtype=torch.float32, device=device).reshape(-1)
        out[name] = (value + sd * noise[start : start + n]).reshape(np.shape(base))
        start += n
    return out


@torch.no_grad()
def load_params(layer, params: dict) -> None:
    """Copy ``params`` into the layer's parameters of the same names; the
    two sets of names and shapes must be equal."""
    own = dict(layer.named_parameters())
    if set(own) != set(params):
        raise ValueError(f"parameter names differ: the layer's {sorted(set(own) ^ set(params))}")
    for name, value in params.items():
        if tuple(own[name].shape) != tuple(value.shape):
            raise ValueError(f"{name}: shape {tuple(own[name].shape)} against {tuple(value.shape)}")
        own[name].copy_(value)
