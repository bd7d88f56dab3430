"""Generic sequence-scan loops for custom recurrent cells (port of
``hmm_layer_tpu/ops/scan.py``).

Run an arbitrary cell over the time axis of a batch, forwards or
backwards, optionally returning the full output sequence and/or the final
state, and combine a forward and a backward pass with a merge mode. The
HMM engine does not use these (it has its own recursions in
:mod:`.recursion`); they serve users who drive custom cells.

A cell is a function ``cell(x_t, state) -> (output_t, new_state)``; the
state and the outputs are tensors or (nested) tuples, lists or dicts of
tensors. The time loop is a plain Python loop over the steps.
"""

from __future__ import annotations

import torch

__all__ = ["rnn_scan", "bidirectional_scan"]


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        out = [_tree_map(fn, *parts) for parts in zip(*trees)]
        return type(first)(*out) if hasattr(first, "_fields") else type(first)(out)
    return fn(*trees)


def rnn_scan(
    cell,
    inputs,
    initial_state,
    time_axis: int = 1,
    reverse: bool = False,
    return_sequences: bool = True,
    return_state: bool = False,
):
    """Run ``cell`` over ``inputs`` along ``time_axis``.

    Args:
        cell: ``cell(x_t, state) -> (output_t, new_state)``.
        inputs: tensor with a time axis (default axis 1, batch first).
        initial_state: carried through the steps.
        reverse: consume the sequence last-to-first; outputs are returned in
            the original time order.
        return_sequences: return the outputs of every step, else the last
            step's (the first position's when ``reverse``).
        return_state: also return the final state.

    Returns:
        outputs [, final_state]
    """
    xs = torch.movedim(inputs, time_axis, 0)
    steps = range(xs.shape[0] - 1, -1, -1) if reverse else range(xs.shape[0])
    state, outs = initial_state, [None] * xs.shape[0]
    for t in steps:
        outs[t], state = cell(xs[t], state)
    if return_sequences:
        outputs = _tree_map(lambda *o: torch.movedim(torch.stack(o), 0, time_axis), *outs)
    else:
        outputs = outs[0 if reverse else -1]
    if return_state:
        return outputs, state
    return outputs


def bidirectional_scan(
    forward_cell,
    backward_cell,
    inputs,
    forward_initial_state,
    backward_initial_state,
    time_axis: int = 1,
    merge_mode: str | None = "concat",
    return_state: bool = False,
):
    """Forward + backward pass with output merging.

    ``merge_mode``: ``"sum"``, ``"concat"``, ``"mul"``, ``"ave"`` or ``None``
    (return the pair).
    """
    fwd, fwd_state = rnn_scan(
        forward_cell, inputs, forward_initial_state, time_axis=time_axis, return_state=True
    )
    bwd, bwd_state = rnn_scan(
        backward_cell,
        inputs,
        backward_initial_state,
        time_axis=time_axis,
        reverse=True,
        return_state=True,
    )
    if merge_mode == "sum":
        merged = _tree_map(torch.add, fwd, bwd)
    elif merge_mode == "mul":
        merged = _tree_map(torch.mul, fwd, bwd)
    elif merge_mode == "ave":
        merged = _tree_map(lambda a, b: (a + b) / 2, fwd, bwd)
    elif merge_mode == "concat":
        merged = _tree_map(lambda a, b: torch.cat([a, b], dim=-1), fwd, bwd)
    elif merge_mode is None:
        merged = (fwd, bwd)
    else:
        raise ValueError(f"unknown merge_mode: {merge_mode}")
    if return_state:
        return merged, fwd_state, bwd_state
    return merged
