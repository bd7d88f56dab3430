"""Tiberius's multi-copy gene-structure HMM (Gabriel et al., 2024;
``GenePredMultiHMMTransitioner`` with k copies), as its definition reads:
k copies of the 15-state gene grammar sharing one intergenic state, the
per-row softmax over the 1 + 22k edges, the class emissions with each
copy's introns reading its I0 parameters, and the codon factors of the 15-state
model repeated for every copy.

State order (q = 1 + 14k): ``Ir``, then each of ``I0, I1, I2, E0, E1, E2,
START, EI0, EI1, EI2, IE0, IE1, IE2, STOP`` as a block of k copies. The
parameters, by the names the benchmark gives them:
``transitions.transition_kernel`` (1 + 22k,),
``transitions.starting_distribution_kernel`` (q,) and
``emissions.0.emission_kernel`` (1, 1 + 12k, s): the introns I1 and I2 of
copy h read I0's row of copy h.

Departures from the published model, each also the program's:

* the intergenic state's k exits to the copies' START states start at the
  logit log(1/k) (equal shares; the 15-state model's is 0 = log 1);
* probabilities are held at ``hmm.EPS`` before their logs, so an edge off
  the grammar scores log(1e-16), not minus infinity (the engine's floor,
  :mod:`.hmm`);
* decoding ties go to the lowest state.

The codon tables and the 3-mers are the 15-state reference's
(:mod:`.genepred`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import genepred
from .hmm import F64, Precision, _log_terms

LOG_ZERO = genepred.LOG_ZERO
CLASSES = 15
# The 14 states of one copy, in the order of their blocks.
BLOCKS = ("I0", "I1", "I2", "E0", "E1", "E2", "START", "EI0", "EI1", "EI2", "IE0", "IE1", "IE2", "STOP")


def num_states(k: int) -> int:
    return 1 + 14 * k


def state(k: int, block: str, h: int) -> int:
    """The index of copy ``h`` of ``block`` (``Ir`` is 0)."""
    return 1 + BLOCKS.index(block) * k + h


def edges(k: int) -> np.ndarray:
    """(1 + 22k, 2) allowed (from, to) pairs: the intergenic loop, then per
    copy its four gene-boundary edges and per reading frame its six."""
    def s(block, h):
        return state(k, block, h)

    out = [(0, 0)]
    for h in range(k):
        out += [(0, s("START", h)), (s("STOP", h), 0), (s("START", h), s("E1", h)), (s("E1", h), s("STOP", h))]
        for cds in range(3):
            nxt = (cds + 1) % 3
            out += [(s(f"E{cds}", h), s(f"E{nxt}", h)), (s(f"E{cds}", h), s(f"EI{cds}", h)),
                    (s(f"EI{cds}", h), s(f"I{cds}", h)), (s(f"I{cds}", h), s(f"I{cds}", h)),
                    (s(f"I{cds}", h), s(f"IE{cds}", h)), (s(f"IE{cds}", h), s(f"E{cds}", h))]
    return np.asarray(out, np.int64)


def base_transition_logits(k, initial_exon_len=100, initial_intron_len=10000, initial_ir_len=10000):
    """(1 + 22k,) float64: logit(1 - 1/len) on the intergenic and intron
    loops and the exon steps of each copy, log 0.5 on each E1's two exits
    off the frame, log(1/k) on the intergenic state's exits, 0 elsewhere."""

    def geo(length):
        p = 1.0 - 1.0 / length
        return -np.log(1.0 / p - 1.0)

    def block(i):
        return "Ir" if i == 0 else BLOCKS[(i - 1) // k]

    out = []
    for a, b in edges(k):
        ba, bb = block(a), block(b)
        if a == b == 0:
            out.append(geo(initial_ir_len))
        elif a == b:  # the intron loops
            out.append(geo(initial_intron_len))
        elif ba in ("E0", "E1", "E2") and bb == f"E{(int(ba[1]) + 1) % 3}":
            out.append(geo(initial_exon_len))
        elif ba == "E1":
            out.append(np.log(0.5))
        elif a == 0:
            out.append(np.log(1.0 / k))
        else:
            out.append(0.0)
    return np.asarray(out, np.float64)


def param_row(k: int) -> list:
    """The emission parameter row of each of the q states: I1 and I2 of a
    copy read its I0 row, every other state its own."""
    rows = [0] + list(range(1, 1 + k)) * 3
    return rows + list(range(1 + k, 1 + 12 * k))


def matrices(params, k, prec: Precision = F64):
    """(init (q,), A (q, q)): softmaxes over the starting logits and over
    each state's allowed out-edges (logits held at LOG_ZERO + 1 or above)."""
    q = num_states(k)
    logits = params["transitions.transition_kernel"].to(prec.dtype).clamp_min(LOG_ZERO + 1.0)
    idx = torch.as_tensor(edges(k), device=logits.device)
    dense = torch.full((q, q), float("-inf"), dtype=prec.dtype, device=logits.device)
    dense = dense.index_put((idx[:, 0], idx[:, 1]), logits)
    A = torch.softmax(dense, -1)
    init = torch.softmax(params["transitions.starting_distribution_kernel"].to(prec.dtype), -1)
    return init, A


def emissions(params, x, codons, k, prec: Precision = F64):
    """(b, L, q) emission probabilities of inputs ``x`` (b, L, s + 5): the
    class channels times each state's softmax row, times the codon factor
    (1/4096 on the 1 + 5k free states Ir, I0-2, E0, E1; the 15-state
    model's factor of each constrained class E2, START, EI0-2, IE0-2, STOP
    on each of its k copies)."""
    x = x.to(prec.dtype)
    B = torch.softmax(params["emissions.0.emission_kernel"][0].to(prec.dtype), -1)[param_row(k)]
    emit = prec.mm(x[..., :-5], B.T)
    tables = torch.as_tensor(genepred.codon_tables(codons), dtype=prec.dtype, device=x.device)
    nuc = x[..., -5:]
    factor = prec.mm(genepred.k_mers(nuc, 3, True).flatten(-2), tables[0].T)
    factor = factor * prec.mm(genepred.k_mers(nuc, 3, False).flatten(-2), tables[1].T)
    free = torch.full(tuple(factor.shape[:-1]) + (1 + 5 * k,), 1.0 / 4096.0, dtype=prec.dtype, device=x.device)
    return emit * torch.cat([free, factor.repeat_interleave(k, -1)], -1)


def viterbi_path(init, A, E):
    """(b, L) int64: a best path (lowest state on ties), computed in the
    dtype of the inputs, its pointers held as int16 (q up to 32,767)."""
    log_init, log_A, log_E = _log_terms(init, A, E)
    delta = log_init + log_E[0]
    pointers = []
    for t in range(1, log_E.shape[0]):
        best, arg = (delta[:, :, None] + log_A).max(1)
        pointers.append(arg.to(torch.int16))
        delta = best + log_E[t]
    state = delta.argmax(-1)
    path = [state]
    for arg in reversed(pointers):
        state = arg.gather(1, state[:, None])[:, 0].long()
        path.append(state)
    return torch.stack(path[::-1], 1)
