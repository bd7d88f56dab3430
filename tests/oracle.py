"""Brute-force NumPy oracles for HMM inference.

Plain O(L·q²) float64 log-space implementations of forward, backward,
posterior and Viterbi, plus exhaustive path enumeration for tiny problems.
These define "correct" for every engine test (the reference repo ships no
numeric assertions; see SURVEY.md §4).
"""

import itertools

import numpy as np
from scipy.special import logsumexp


def forward_np(init, A, E):
    """init (q,), A (q, q), E (L, q) linear space -> (log_alpha (L, q), loglik)."""
    L, q = E.shape
    log_A = np.log(np.maximum(A, 1e-300))
    log_alpha = np.zeros((L, q))
    log_alpha[0] = np.log(np.maximum(init, 1e-300)) + np.log(np.maximum(E[0], 1e-300))
    for t in range(1, L):
        log_alpha[t] = (
            logsumexp(log_alpha[t - 1][:, None] + log_A, axis=0)
            + np.log(np.maximum(E[t], 1e-300))
        )
    return log_alpha, logsumexp(log_alpha[-1])


def backward_np(A, E):
    """A (q, q), E (L, q) -> log_beta (L, q)."""
    L, q = E.shape
    log_A = np.log(np.maximum(A, 1e-300))
    log_beta = np.zeros((L, q))
    for t in range(L - 2, -1, -1):
        log_beta[t] = logsumexp(
            log_A + np.log(np.maximum(E[t + 1], 1e-300))[None, :] + log_beta[t + 1][None, :],
            axis=1,
        )
    return log_beta


def posterior_np(init, A, E):
    la, ll = forward_np(init, A, E)
    lb = backward_np(A, E)
    return la + lb - ll, ll


def viterbi_np(init, A, E):
    """Most likely path (L,) int."""
    L, q = E.shape
    log_A = np.log(np.maximum(A, 1e-300))
    log_E = np.log(np.maximum(E, 1e-300))
    delta = np.log(np.maximum(init, 1e-300)) + log_E[0]
    bp = np.zeros((L, q), dtype=int)
    for t in range(1, L):
        s = delta[:, None] + log_A
        bp[t] = np.argmax(s, axis=0)
        delta = np.max(s, axis=0) + log_E[t]
    path = np.zeros(L, dtype=int)
    path[-1] = np.argmax(delta)
    for t in range(L - 1, 0, -1):
        path[t - 1] = bp[t, path[t]]
    return path


def brute_force_loglik(init, A, E):
    """Exhaustive sum over all state paths (tiny L, q only)."""
    L, q = E.shape
    if q**L > 2_000_000:  # ~seconds; beyond this use forward_np instead
        raise ValueError(f"q**L = {q}**{L} paths is infeasible to enumerate")
    total = 0.0
    for path in itertools.product(range(q), repeat=L):
        p = init[path[0]] * E[0, path[0]]
        for t in range(1, L):
            p *= A[path[t - 1], path[t]] * E[t, path[t]]
        total += p
    return np.log(total)


def brute_force_viterbi(init, A, E):
    L, q = E.shape
    if q**L > 2_000_000:
        raise ValueError(f"q**L = {q}**{L} paths is infeasible to enumerate")
    best, best_path = -np.inf, None
    for path in itertools.product(range(q), repeat=L):
        p = np.log(init[path[0]]) + np.log(E[0, path[0]])
        for t in range(1, L):
            p += np.log(A[path[t - 1], path[t]]) + np.log(E[t, path[t]])
        if p > best:
            best, best_path = p, np.array(path)
    return best_path, best


def random_hmm(rng, q, L, b=1, peaked=False):
    """Random well-conditioned HMM instance. Returns (init, A, E(b, L, q))."""
    init = rng.dirichlet(np.ones(q))
    A = rng.dirichlet(np.ones(q), size=q)
    if peaked:
        E = rng.dirichlet(np.ones(q) * 0.1, size=(b, L))
    else:
        E = rng.uniform(0.05, 1.0, size=(b, L, q))
    return init.astype(np.float32), A.astype(np.float32), E.astype(np.float32)


def window_inputs_np(enc, cls, window, batch, overlap):
    """Per window batch of a contig, the (1, batch, window, 20) inputs and
    the window starts, built on the host from ``data.window_batches``: the
    class rows ``cls`` (L, 15), padded with a uniform row past the contig's
    end and in fill windows, before the nucleotide windows of ``enc``."""
    from hmm_layer_torch import data

    out = []
    for wins, starts in data.window_batches(enc, window, batch, overlap):
        rows = []
        for st in starts:
            chunk = cls[st : st + window] if st >= 0 else cls[:0]
            pad = np.full((window - len(chunk), 15), 1.0 / 15.0, np.float32)
            rows.append(np.concatenate([chunk, pad]))
        out.append((np.concatenate([np.stack(rows), wins], -1)[None], starts))
    return out


def stitched_track_np(viterbi_fn, enc, cls, window, batch, overlap):
    """The (L,) state track of a contig decoded from
    :func:`window_inputs_np`'s batches, each later window's first
    ``overlap`` positions taken from the window before it."""
    L = enc.shape[0]
    track = np.zeros(L, np.int32)
    for x, starts in window_inputs_np(enc, cls, window, batch, overlap):
        paths = np.asarray(viterbi_fn(x)[0].cpu())
        for i, st in enumerate(starts):
            if st < 0:
                continue
            end = min(st + window, L)
            lo = st + overlap if st > 0 else st
            track[lo:end] = paths[i, lo - st : end - st]
    return track
