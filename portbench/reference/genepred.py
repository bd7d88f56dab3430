"""The 15-state gene-structure HMM of Tiberius (Gabriel et al., 2024), as
its definition reads: the grammar, the per-row softmax over its 23 edges,
the class emissions with shared intron parameters, and the codon factors of
the START, STOP, splice-site and last-exon-codon states from 3-mers of the
nucleotide track.

State order: ``Ir, I0-2, E0-2, START, EI0-2, IE0-2, STOP``. Parameters, by
the names the benchmark gives them: ``transitions.transition_kernel``
(23,), ``transitions.starting_distribution_kernel`` (15,) and
``emissions.0.emission_kernel`` (1, 13, s): 13 parameter states, the
introns I1 and I2 reading I0's row.
"""

from __future__ import annotations

import numpy as np
import torch

from .hmm import F64, Precision

NUM_STATES = 15
LOG_ZERO = -1e3
IR, I, E, START, EI, IE, STOP = 0, (1, 2, 3), (4, 5, 6), 7, (8, 9, 10), (11, 12, 13), 14
# The 13 parameter states' row for each of the 15 states (I1, I2 read I0).
PARAM_ROW = [0, 1, 1, 1] + list(range(2, 13))


def edges() -> np.ndarray:
    """(23, 2) allowed (from, to) pairs."""
    out = [(IR, IR), (IR, START), (STOP, IR), (START, E[1]), (E[1], STOP)]
    for cds in range(3):
        out += [(E[cds], E[(cds + 1) % 3]), (E[cds], EI[cds]), (EI[cds], I[cds]),
                (I[cds], I[cds]), (I[cds], IE[cds]), (IE[cds], E[cds])]
    return np.asarray(out, np.int64)


def base_transition_logits(initial_exon_len=100, initial_intron_len=10000, initial_ir_len=10000):
    """(23,) float64: the length-geometry init, logit(1 - 1/len) on the
    loops and the exon steps, log 0.5 on E1's two exits, 0 elsewhere."""

    def geo(length):
        p = 1.0 - 1.0 / length
        return -np.log(1.0 / p - 1.0)

    out = []
    for a, b in edges():
        if a == b == IR:
            out.append(geo(initial_ir_len))
        elif a == b and a in I:
            out.append(geo(initial_intron_len))
        elif a in E and b == E[(E.index(a) + 1) % 3]:
            out.append(geo(initial_exon_len))
        elif a == E[1] and a != b:
            out.append(np.log(0.5))
        else:
            out.append(0.0)
    return np.asarray(out, np.float64)


def matrices(params, prec: Precision = F64):
    """(init (q,), A (q, q)): softmaxes over the starting logits and over
    each state's allowed out-edges (logits held at LOG_ZERO + 1 or above)."""
    logits = params["transitions.transition_kernel"].to(prec.dtype).clamp_min(LOG_ZERO + 1.0)
    idx = torch.as_tensor(edges(), device=logits.device)
    dense = torch.full((NUM_STATES, NUM_STATES), float("-inf"), dtype=prec.dtype, device=logits.device)
    dense = dense.index_put((idx[:, 0], idx[:, 1]), logits)
    A = torch.softmax(dense, -1)
    init = torch.softmax(params["transitions.starting_distribution_kernel"].to(prec.dtype), -1)
    return init, A


# -- codon factors -------------------------------------------------------------


def k_mers(seq, k: int, pivot_left: bool):
    """(..., L, 4**(k-1), 4) k-mer tensors of (..., L, 5) ACGTN rows: N
    spread over the 4 bases, the ends padded with the uniform distribution;
    the last axis is the pivot base (leftmost or rightmost)."""
    L, n = seq.shape[-2], seq.shape[-1] - 1
    seq = seq[..., :-1] + seq[..., -1:] / n
    if isinstance(seq, np.ndarray):
        pad = np.full(seq.shape[:-2] + (k - 1, n), 1.0 / n, seq.dtype)
        cat = np.concatenate
    else:
        pad = torch.full(tuple(seq.shape[:-2]) + (k - 1, n), 1.0 / n, dtype=seq.dtype, device=seq.device)
        cat = torch.cat
    if pivot_left:
        padded = cat([seq, pad], axis=-2)
        out = padded[..., :L, None, :]
        order = range(1, k)
    else:
        padded = cat([pad, seq], axis=-2)
        out = padded[..., k - 1 : L + k - 1, None, :]
        order = range(k - 2, -1, -1)
    for i in order:
        shifted = padded[..., i : L + i, None, :, None]
        out = out[..., None, :] * shifted
        width = 4**i if pivot_left else 4 ** (k - i - 1)
        out = out.reshape(tuple(out.shape[:-3]) + (width, n))
    return out


def _kmer_table(triplet: str, pivot_left: bool) -> np.ndarray:
    one_hot = np.eye(5)[["ACGTN".index(c) for c in triplet]]
    enc = k_mers(one_hot[None], 3, pivot_left)
    return (enc[0, 0] if pivot_left else enc[0, -1]).reshape(64)


def _codon_probs(pattern, pivot_left: bool) -> np.ndarray:
    return sum(p * _kmer_table(t, pivot_left) for t, p in pattern)


def codon_tables(codons) -> np.ndarray:
    """(2, 9, 64) float64: the left- and right-pivot 3-mer probabilities of
    the 9 constrained states E2, START, EI0-2, IE0-2, STOP."""
    start = _codon_probs(codons["start_codons"], True)
    stop = _codon_probs(codons["stop_codons"], False)
    begin = _codon_probs(codons["intron_begin_pattern"], True)
    end = _codon_probs(codons["intron_end_pattern"], False)
    any_codon = _codon_probs([("NNN", 1.0)], False)
    not_stop = any_codon * (stop == 0)
    not_stop = not_stop / not_stop.sum()
    left = [any_codon, start, begin, begin, begin, any_codon, any_codon, any_codon, any_codon]
    right = [not_stop, any_codon, any_codon, not_stop, any_codon, end, end, end, stop]
    return np.stack([np.stack(left), np.stack(right)])


def emissions(params, x, codons, training: bool, prec: Precision = F64):
    """(b, L, 15) emission probabilities of inputs ``x`` (b, L, s + 5): the
    class channels times each state's softmax row, times the codon factor
    (1/4096 on the six free states Ir, I0-2, E0, E1; the constrained
    states' pattern probabilities of the 3-mers pivoting left and right),
    plus 1e-7 on the factor in training."""
    x = x.to(prec.dtype)
    B = torch.softmax(params["emissions.0.emission_kernel"][0].to(prec.dtype), -1)[PARAM_ROW]
    emit = prec.mm(x[..., :-5], B.T)
    tables = torch.as_tensor(codon_tables(codons), dtype=prec.dtype, device=x.device)
    nuc = x[..., -5:]
    factor = prec.mm(k_mers(nuc, 3, True).flatten(-2), tables[0].T)
    factor = factor * prec.mm(k_mers(nuc, 3, False).flatten(-2), tables[1].T)
    free = torch.full(tuple(factor.shape[:-1]) + (6,), 1.0 / 4096.0, dtype=prec.dtype, device=x.device)
    factor = torch.cat([free, factor], -1)
    if training:
        factor = factor + 1e-7
    return emit * factor


def cross_entropy(params, batch, codons, prec: Precision = F64):
    """The supervised objective: the mean over the labelled positions
    (weights ``mask``) of -log P(s_t = label_t | x)."""
    from . import hmm

    init, A = matrices(params, prec)
    E = emissions(params, batch["x"][0], codons, True, prec)
    lg, _ = hmm.posterior(init, A, E, prec)
    labels, mask = batch["labels"][0].long(), batch["mask"][0].to(prec.dtype)
    ce = -lg.gather(-1, labels[..., None])[..., 0]
    return (ce * mask).sum() / mask.sum().clamp_min(1.0)
