"""Helpers shared by the emission model families (port of
``hmm_layer_tpu/models/emission_utils.py``)."""

from __future__ import annotations

import torch

__all__ = ["apply_end_hints"]


def apply_end_hints(emit, end_hints):
    """Mask border emissions with caller-provided state hints.

    * ``end_hints`` of shape ``(m, b, 2, q)`` — multiply the first/last
      position of the whole sequence.
    * ``end_hints`` of shape ``(m, b, P, 2, q)`` — multiply the first/last
      position of every chunk in row-major ``(b, P)`` order. ``P`` must
      divide ``L`` and each chunk must span at least 2 positions.

    Multiplicative and differentiable in both ``emit`` and ``end_hints``.
    """
    if end_hints is None:
        return emit
    end_hints = torch.as_tensor(end_hints, dtype=emit.dtype, device=emit.device)
    if end_hints.ndim == emit.ndim + 1:
        m, b, L, q = emit.shape
        P = end_hints.shape[-3]
        if L % P != 0:
            raise ValueError(f"end_hints chunk count P={P} does not divide L={L}")
        c = L // P
        if c < 2:
            raise ValueError(
                f"end_hints chunks must span >= 2 positions, got L/P={c}"
            )
        chunks = emit.reshape(*emit.shape[:-2], P, c, q)
        left = end_hints[..., :1, :] * chunks[..., :1, :]
        right = end_hints[..., 1:, :] * chunks[..., -1:, :]
        chunks = torch.cat([left, chunks[..., 1:-1, :], right], dim=-2)
        return chunks.reshape(emit.shape)
    if end_hints.shape[-2] != 2:
        raise ValueError(
            "end_hints must be (m, b, 2, q) sequence-level or "
            f"(m, b, P, 2, q) per-chunk masks; got shape {tuple(end_hints.shape)}"
        )
    left = end_hints[..., :1, :] * emit[..., :1, :]
    right = end_hints[..., 1:, :] * emit[..., -1:, :]
    return torch.cat([left, emit[..., 1:-1, :], right], dim=-2)
