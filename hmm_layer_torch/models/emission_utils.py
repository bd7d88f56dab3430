"""Helpers shared by the emission model families (port of
``hmm_layer_tpu/models/emission_utils.py``), and the emitters' blocks.

An emitter's ``emissions(inputs, ..., block=None)`` takes the whole
(m, b, L, s) inputs and returns its (m, b, L, q) emissions, or with
``block`` (three ``(start, stop)`` ranges: batch rows, positions, states,
e.g. a :class:`~hmm_layer_torch.parallel.LocalRanges`) only
``E[:, rows, positions, states]``, computed from the inputs it needs and
no more (the layer's rank-local routes give each rank its block).
"""

from __future__ import annotations

import torch

__all__ = ["apply_end_hints"]


def block_ranges(inputs, num_states: int, block=None):
    """``block`` as ``(rows, positions, states)`` ranges, or the ranges of
    the whole (m, b, L, ``num_states``) output of ``inputs`` when it is
    ``None``."""
    if block is None:
        return (0, inputs.shape[1]), (0, inputs.shape[2]), (0, num_states)
    rows, positions, states = (tuple(int(i) for i in r) for r in block)
    return rows, positions, states


def apply_end_hints(emit, end_hints, block=None, length: int | None = None):
    """Mask border emissions with caller-provided state hints.

    * ``end_hints`` of shape ``(m, b, 2, q)`` — multiply the first/last
      position of the whole sequence.
    * ``end_hints`` of shape ``(m, b, P, 2, q)`` — multiply the first/last
      position of every chunk in row-major ``(b, P)`` order. ``P`` must
      divide ``L`` and each chunk must span at least 2 positions.

    With ``block`` (rows, positions, states ranges of a sequence of
    ``length`` positions) ``emit`` is that block of the emissions and the
    hints are the whole ones: the block takes its rows and states of the
    hints at the borders that fall in its positions (a block's own edges
    are no borders, unless they are the sequence's or a chunk's).

    Multiplicative and differentiable in both ``emit`` and ``end_hints``.
    """
    if end_hints is None:
        return emit
    end_hints = torch.as_tensor(end_hints, dtype=emit.dtype, device=emit.device)
    chunked = end_hints.ndim == emit.ndim + 1
    if not chunked and end_hints.shape[-2] != 2:
        raise ValueError(
            "end_hints must be (m, b, 2, q) sequence-level or "
            f"(m, b, P, 2, q) per-chunk masks; got shape {tuple(end_hints.shape)}"
        )
    L = emit.shape[-2] if block is None else length
    if chunked:
        P = end_hints.shape[-3]
        if L % P != 0:
            raise ValueError(f"end_hints chunk count P={P} does not divide L={L}")
        c = L // P
        if c < 2:
            raise ValueError(
                f"end_hints chunks must span >= 2 positions, got L/P={c}"
            )
    if block is not None:
        return _block_end_hints(emit, end_hints, block, L, c if chunked else L)
    if chunked:
        q = emit.shape[-1]
        chunks = emit.reshape(*emit.shape[:-2], P, c, q)
        left = end_hints[..., :1, :] * chunks[..., :1, :]
        right = end_hints[..., 1:, :] * chunks[..., -1:, :]
        chunks = torch.cat([left, chunks[..., 1:-1, :], right], dim=-2)
        return chunks.reshape(emit.shape)
    left = end_hints[..., :1, :] * emit[..., :1, :]
    right = end_hints[..., 1:, :] * emit[..., -1:, :]
    return torch.cat([left, emit[..., 1:-1, :], right], dim=-2)


def _block_end_hints(emit, end_hints, block, length, c):
    """:func:`apply_end_hints` on a block: the chunks (of ``c`` positions;
    the whole sequence for sequence-level hints) whose first or last
    position lies in the block's positions."""
    (r0, r1), (p0, p1), (s0, s1) = block
    hints = end_hints[:, r0:r1, ..., s0:s1]
    if hints.ndim == emit.ndim:  # sequence-level: one chunk
        hints = hints[:, :, None]
    t = torch.arange(p0, p1, device=emit.device)
    left, right = t[t % c == 0], t[t % c == c - 1]
    pos = torch.cat([left, right])
    if pos.numel() == 0:
        return emit
    side = torch.cat([torch.zeros_like(left), torch.ones_like(right)])
    vals = hints[:, :, pos // c, side]  # (m, b_l, n, q_l)
    local = pos - p0
    return emit.index_copy(-2, local, vals * emit.index_select(-2, local))
