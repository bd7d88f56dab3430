"""Posterior-occupancy length adaptation for profile HMMs, the learnMSA
loop (port of ``hmm_layer_tpu/models/profile_adapt.py``).

learnMSA alternates training with *length adaptation*: match columns used
by too few sequences are discarded, and insert positions that absorb many
residues are promoted to new match columns. The proposals come from
posterior state marginals and are applied with the param-preserving
:meth:`~hmm_layer_torch.layer.HMMLayer.resize` (trained logits of
surviving columns carry over), so adaptation composes with continued
training. The statistics are NumPy, in float64.

State order per model (implicit profile layout,
``models/profile_transitions.py``): ``LEFT_FLANK, MATCH x Lm,
INSERT x Lm-1, UNANNOTATED, RIGHT_FLANK, TERMINAL``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["match_statistics", "propose_keep", "adapt_profile_layer"]


def match_statistics(log_gamma, length, seq_mask=None):
    """Per-column usage statistics from posterior marginals of ONE model.

    Args:
      log_gamma: ``(b, L, q)`` posterior state log-probs (normalized).
      length: the model's match-state count ``Lm``.
      seq_mask: optional ``(b, L)`` {0,1} mask of real (unpadded)
        positions.

    Returns:
      ``(occupancy (Lm,), insert_load (Lm+1,))``: ``occupancy[j]`` is the
      mean per-sequence expected usage of match column ``j+1`` (capped at
      1); ``insert_load[k]`` is the mean number of residues emitted
      between columns ``k`` and ``k+1`` (``k=0``: left flank; ``k=Lm``:
      right flank + unannotated; interior: insert states).
    """
    gamma = np.exp(np.asarray(log_gamma, np.float64))
    if seq_mask is not None:
        gamma = gamma * np.asarray(seq_mask, np.float64)[..., None]
    Lm = int(length)
    usage = gamma.sum(axis=1)  # (b, q) expected visits per state
    occupancy = np.minimum(usage[:, 1 : Lm + 1], 1.0).mean(axis=0)
    insert_load = np.zeros(Lm + 1)
    insert_load[0] = usage[:, 0].mean()  # left flank
    if Lm > 1:
        insert_load[1:Lm] = usage[:, Lm + 1 : 2 * Lm].mean(axis=0)
    insert_load[Lm] = (usage[:, 2 * Lm] + usage[:, 2 * Lm + 1]).mean()
    return occupancy, insert_load


def propose_keep(
    occupancy,
    insert_load,
    min_occupancy: float = 0.3,
    expand_threshold: float = 1.0,
    max_new_per_site: int = 3,
    min_length: int = 2,
    flank_threshold: float = 2.0,
    max_new_per_flank: int = 4,
):
    """Propose a ``keep`` map (resize semantics) from usage statistics.

    Match columns with occupancy below ``min_occupancy`` are discarded;
    ``round(insert_load)`` new columns (capped at ``max_new_per_site``)
    are inserted where an interior insertion site absorbs at least
    ``expand_threshold`` residues per sequence. Flank loads (sites 0 and
    Lm) get their own, higher ``flank_threshold``: flank states
    legitimately absorb short unaligned tails, but a too-short model
    parks the REST of the motif there (measured: a 12-column model on a
    24-column planted motif puts ~12.7 residues/seq in the left flank),
    so heavy flank load grows capped new columns at that end.

    Returns:
      ``(keep (new_length,), new_length)`` — entries are surviving old
      column indices or ``-1`` for fresh columns.
    """
    occupancy = np.asarray(occupancy)
    insert_load = np.asarray(insert_load)
    Lm = len(occupancy)

    def flank_new(load):
        if load >= flank_threshold:
            return min(int(round(load)), max_new_per_flank)
        return 0

    keep = [-1] * flank_new(insert_load[0])
    for j in range(Lm):
        if occupancy[j] >= min_occupancy:
            keep.append(j)
        if j < Lm - 1 and insert_load[j + 1] >= expand_threshold:
            n_new = min(int(round(insert_load[j + 1])), max_new_per_site)
            keep.extend([-1] * n_new)
    keep.extend([-1] * flank_new(insert_load[Lm]))
    surviving = [k for k in keep if k >= 0]
    if len(surviving) < min_length:
        # Degenerate proposal (everything below threshold): keep the
        # most-used columns instead of collapsing the model.
        top = np.sort(np.argsort(occupancy)[-min_length:])
        keep = list(top)
    return np.asarray(keep, np.int64), len(keep)


def adapt_profile_layer(
    layer,
    inputs,
    generator: torch.Generator | None = None,
    seq_mask=None,
    min_occupancy: float = 0.3,
    expand_threshold: float = 1.0,
):
    """One learnMSA-style adaptation round on a (multi-model) profile layer.

    Computes the layer's posterior marginals of ``inputs`` (m, b, L, s),
    proposes per-model ``keep`` maps, and applies
    :meth:`~hmm_layer_torch.layer.HMMLayer.resize` (new columns drawn from
    ``generator``).

    Returns:
      ``(new_layer, info)`` where ``info`` lists per-model
      ``{"old_length", "new_length", "keep"}``. If no model changes, the
      layer itself comes back (``info`` still reports lengths).
    """
    with torch.no_grad():
        lg = layer.state_posterior_log_probs(inputs).cpu().numpy()
    lengths = layer.transitions.lengths
    keeps, new_lengths, info = [], [], []
    for i, Lm in enumerate(lengths):
        occ, load = match_statistics(lg[i], Lm, seq_mask=seq_mask)
        keep, new_len = propose_keep(
            occ,
            load,
            min_occupancy=min_occupancy,
            expand_threshold=expand_threshold,
        )
        keeps.append(keep)
        new_lengths.append(new_len)
        info.append({"old_length": Lm, "new_length": new_len, "keep": keep})
    if new_lengths == list(lengths) and all(
        np.array_equal(k, np.arange(l)) for k, l in zip(keeps, lengths)
    ):
        return layer, info
    return layer.resize(new_lengths, keep=keeps, generator=generator), info
