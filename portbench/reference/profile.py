"""learnMSA's profile HMMs (Becker & Stanke, 2022) as their definition
reads: Plan7 with the delete states eliminated, match emissions over the
amino acids, and the Dirichlet priors of the MAP objective.

Per model of length ``n``: the explicit model's 18 edge types, each row a
softmax over its allowed edges; the delete chains marginalised into the
implicit model over ``2n + 3`` states (``LEFT_FLANK, MATCH x n, INSERT x
n-1, UNANNOTATED_SEGMENT, RIGHT_FLANK, TERMINAL``); its initial
distribution from the flank-init sigmoid and the entry probabilities.
Each model is computed at its own size, with no padding to the largest.

Parameters, by the names the benchmark gives them:
``transitions.kernels.{i}.{part}`` (the flanks share their loop and exit
parts under the right flank's name), ``transitions.flank_init_kernel.{i}``
(1,), ``emissions.0.emission_kernel.{i}`` (n, 25) and
``emissions.0.insertion_kernel.{i}`` (25,).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .hmm import F64, Precision

LOG_ZERO = -1e3
SHARED = {"left_flank_loop": "right_flank_loop", "left_flank_exit": "right_flank_exit"}
PRIORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "priors")


def explicit_parts(n):
    return [
        ("begin_to_match", n), ("match_to_end", n), ("match_to_match", n - 1),
        ("match_to_insert", n - 1), ("insert_to_match", n - 1), ("insert_to_insert", n - 1),
        ("match_to_delete", n), ("delete_to_match", n), ("delete_to_delete", n - 1),
        ("left_flank_loop", 1), ("left_flank_exit", 1), ("unannotated_segment_loop", 1),
        ("unannotated_segment_exit", 1), ("right_flank_loop", 1), ("right_flank_exit", 1),
        ("end_to_unannotated_segment", 1), ("end_to_right_flank", 1), ("end_to_terminal", 1),
    ]


def explicit_edges(n):
    """Per explicit part, its (from, to) pairs; states as in the implicit
    order, then BEGIN (2n+3), END (2n+4), DELETE x n."""
    a = np.arange(n + 1)
    lf, ins, un, rf, term, begin, end, dl = 0, n + 1, 2 * n, 2 * n + 1, 2 * n + 2, 2 * n + 3, 2 * n + 4, 2 * n + 5
    z = np.zeros(n, np.int64)
    st = lambda x, y: np.stack([x, y], 1)  # noqa: E731
    return {
        "begin_to_match": st(z + begin, a[1:]),
        "match_to_end": st(a[1:], z + end),
        "match_to_match": st(a[1:-1], a[1:-1] + 1),
        "match_to_insert": st(a[1:-1], a[:-2] + ins),
        "insert_to_match": st(a[:-2] + ins, a[2:]),
        "insert_to_insert": st(a[:-2] + ins, a[:-2] + ins),
        "match_to_delete": st(np.insert(a[1:-1], 0, begin), a[:-1] + dl),
        "delete_to_match": st(a[:-1] + dl, np.append(a[:-2] + 2, end)),
        "delete_to_delete": st(a[:-2] + dl, a[:-2] + dl + 1),
        "left_flank_loop": np.asarray([[lf, lf]]),
        "left_flank_exit": np.asarray([[lf, begin]]),
        "unannotated_segment_loop": np.asarray([[un, un]]),
        "unannotated_segment_exit": np.asarray([[un, begin]]),
        "right_flank_loop": np.asarray([[rf, rf]]),
        "right_flank_exit": np.asarray([[rf, term]]),
        "end_to_unannotated_segment": np.asarray([[end, un]]),
        "end_to_right_flank": np.asarray([[end, rf]]),
        "end_to_terminal": np.asarray([[end, term]]),
    }


def base_kernels(n):
    """Per part, the default initializers' mean logits (float64): the
    entry and exit spreads, the match triple's softmax (1, -1, -1) scaled
    by the exit mass, and the constant means of the other parts."""
    p_exit = 0.5 / max(n - 1, 1)
    triple = np.exp([1.0, -1.0, -1.0]) / np.exp([1.0, -1.0, -1.0]).sum() * (1.0 - p_exit)
    const = {"insert_to_match": 0.0, "insert_to_insert": -0.5, "delete_to_match": 0.0,
             "delete_to_delete": -0.5, "left_flank_loop": 0.0, "left_flank_exit": -1.0,
             "right_flank_loop": 0.0, "right_flank_exit": -1.0, "unannotated_segment_loop": 0.0,
             "unannotated_segment_exit": -1.0, "end_to_unannotated_segment": -9.0,
             "end_to_right_flank": 0.0, "end_to_terminal": 0.0}
    out = {}
    for name, size in explicit_parts(n):
        if name in SHARED:
            continue
        if name == "begin_to_match":
            v = np.r_[0.0, np.full(size - 1, np.log(1.0 / max(size - 1, 1)))]
        elif name == "match_to_end":
            v = np.full(size, np.log(0.5 / max(size - 1, 1)))
        elif name in ("match_to_match", "match_to_insert", "match_to_delete"):
            v = np.full(size, np.log(triple[("match_to_match", "match_to_insert", "match_to_delete").index(name)]))
        else:
            v = np.full(size, const[name])
        out[name] = v
    return out


def explicit_probs(kernels, n, prec: Precision = F64):
    """Per part, its edges' probabilities: each explicit row a softmax over
    its allowed edges (logits held at LOG_ZERO + 1 or above)."""
    idx = explicit_edges(n)
    parts = explicit_parts(n)
    values = torch.cat([kernels[SHARED.get(name, name)].to(prec.dtype) for name, _ in parts]).clamp_min(LOG_ZERO + 1.0)
    pairs = torch.as_tensor(np.concatenate([idx[name] for name, _ in parts]), device=values.device)
    size = 3 * n + 5
    dense = torch.full((size, size), float("-inf"), dtype=prec.dtype, device=values.device)
    dense = dense.index_put((pairs[:, 0], pairs[:, 1]), values)
    rows = torch.isfinite(dense).any(-1, keepdim=True)
    probs = torch.where(rows, torch.softmax(torch.where(rows, dense, 0.0), -1), 0.0)
    vec = probs[pairs[:, 0], pairs[:, 1]]
    out, offset = {}, 0
    for name, length in parts:
        out[name] = vec[offset : offset + length]
        offset += length
    return out


def implicit_model(kernels, flank_kernel, n, prec: Precision = F64):
    """(init (2n+3,), A (2n+3, 2n+3), explicit probabilities): the delete
    chains marginalised, ``skip(i, j) = MD_i + sum DD_i..j + DM_j``."""
    p = explicit_probs(kernels, n, prec)
    lp = {k: torch.log(v.clamp_min(1e-32)) for k, v in p.items()}
    dt, dev = prec.dtype, p["match_to_match"].device
    MD = lp["match_to_delete"][:, None]
    DD = torch.cat([torch.zeros(1, dtype=dt, device=dev), lp["delete_to_delete"]])
    cs = torch.cumsum(DD, 0)
    skip = MD + (cs[None, :] - cs[:, None]) + lp["delete_to_match"][None, :]  # (n, n); row 0 = BEGIN
    log_zero = torch.full((1,), LOG_ZERO, dtype=dt, device=dev)
    entry = torch.logaddexp(lp["begin_to_match"], torch.cat([log_zero, skip[0, :-1]]))
    exit_ = torch.logaddexp(lp["match_to_end"], torch.cat([skip[1:, -1], log_zero]))
    skip_all = skip[0, -1]
    q = 2 * n + 3
    lf, ins, un, rf, term = 0, n + 1, 2 * n, 2 * n + 1, 2 * n + 2
    match = torch.arange(1, n + 1, device=dev)
    logA = torch.full((q, q), float("-inf"), dtype=dt, device=dev)
    lfe = lp["left_flank_exit"]
    logA[lf, lf] = lp["left_flank_loop"][0]
    logA[lf, match] = lfe + entry
    logA[lf, rf] = (lfe + skip_all + lp["end_to_right_flank"])[0]
    logA[lf, un] = (lfe + skip_all + lp["end_to_unannotated_segment"])[0]
    logA[lf, term] = (lfe + skip_all + lp["end_to_terminal"])[0]
    logA[match[:-1], match[:-1] + 1] = lp["match_to_match"]
    if n > 2:
        r, c = np.triu_indices(n - 2)
        logA[torch.as_tensor(r + 1, device=dev), torch.as_tensor(c + 3, device=dev)] = skip[1:-1, 1:-1][r, c]
    logA[match, un] = exit_ + lp["end_to_unannotated_segment"]
    logA[match, rf] = exit_ + lp["end_to_right_flank"]
    logA[match, term] = exit_ + lp["end_to_terminal"]
    logA[match[:-1], match[:-1] + n] = lp["match_to_insert"]
    logA[match[:-1] + n, match[1:]] = lp["insert_to_match"]
    logA[match[:-1] + n, match[:-1] + n] = lp["insert_to_insert"]
    use = lp["unannotated_segment_exit"]
    logA[un, match] = use + entry
    logA[un, un] = torch.logaddexp(lp["unannotated_segment_loop"], use + skip_all + lp["end_to_unannotated_segment"])[0]
    logA[un, rf] = (use + skip_all + lp["end_to_right_flank"])[0]
    logA[un, term] = (use + skip_all + lp["end_to_terminal"])[0]
    logA[rf, rf] = lp["right_flank_loop"][0]
    logA[rf, term] = lp["right_flank_exit"][0]
    logA[term, term] = 0.0
    flank = torch.sigmoid(flank_kernel.to(dt))[0]
    corr = torch.log1p(-flank) - lfe[0]
    log_init = torch.full((q,), float("-inf"), dtype=dt, device=dev)
    log_init[lf] = torch.log(flank)
    log_init[match] = logA[lf, match] + corr
    log_init[un] = logA[lf, un] + corr
    log_init[rf] = logA[lf, rf] + corr
    log_init[term] = logA[lf, term] + corr
    return torch.exp(log_init), torch.exp(logA), p, flank


def emission_matrix(match_kernel, insert_kernel, prec: Precision = F64):
    """(2n+3, s+1): softmax rows of [insert; match x n; insert x (n+1)]
    with a zero terminal column, and the terminal state's one-hot row."""
    em, ins = match_kernel.to(prec.dtype), insert_kernel.to(prec.dtype)
    n, s = em.shape
    rows = torch.softmax(torch.cat([ins[None], em, ins[None].expand(n + 1, s)]), -1)
    rows = torch.cat([rows, torch.zeros_like(rows[:, :1])], -1)
    terminal = torch.zeros((1, s + 1), dtype=rows.dtype, device=rows.device)
    terminal[0, s] = 1.0
    return torch.cat([rows, terminal])


# -- priors ----------------------------------------------------------------------


def _mixture(name):
    with np.load(os.path.join(PRIORS, f"{name}.npz")) as f:
        alpha_kernel = np.asarray(f["alpha_kernel"], np.float64)
        mix_kernel = np.asarray(f["mix_kernel"], np.float64)
    alpha = np.where(alpha_kernel > 30.0, alpha_kernel, np.log1p(np.exp(np.minimum(alpha_kernel, 30.0))))
    mix = np.exp(mix_kernel - mix_kernel.max())
    return alpha, mix / mix.sum()


def dirichlet_mixture_log_pdf(p, alpha, mix):
    """(rows,) log-density of probability rows ``p`` under a Dirichlet
    mixture (alpha (k, s), mix (k,))."""
    alpha = torch.as_tensor(alpha, dtype=p.dtype, device=p.device)
    mix = torch.as_tensor(mix, dtype=p.dtype, device=p.device)
    log_z = torch.lgamma(alpha).sum(-1) - torch.lgamma(alpha.sum(-1))
    terms = (torch.log(p.clamp_min(1e-16))[:, None] * (alpha - 1.0)[None]).sum(-1) - log_z
    return torch.logsumexp(terms + torch.log(mix), -1)


ALPHA_FLANK, ALPHA_SINGLE, ALPHA_GLOBAL = 7000.0, 1e9, 1e4


def transition_prior(p, flank):
    """The transition prior of one model: Dirichlet mixtures on the match,
    insert and delete triples and pairs, and the flank, single-hit and
    global entry/exit terms (complements at concentration 1 add nothing)."""
    eps = 1e-16
    lp = {k: torch.log(v.clamp_min(eps)) for k, v in p.items()}
    triple = torch.stack([p["match_to_match"], p["match_to_insert"], p["match_to_delete"][1:]], -1) + eps
    triple = triple / triple.sum(-1, keepdim=True)
    total = dirichlet_mixture_log_pdf(triple, *_mixture("match_prior_1")).sum()
    total = total + dirichlet_mixture_log_pdf(
        torch.stack([p["insert_to_match"], p["insert_to_insert"]], -1), *_mixture("insert_prior_1")).sum()
    total = total + dirichlet_mixture_log_pdf(
        torch.stack([p["delete_to_match"][:-1], p["delete_to_delete"]], -1), *_mixture("delete_prior_1")).sum()
    flank_terms = (lp["unannotated_segment_loop"] + lp["right_flank_loop"] + lp["left_flank_loop"]
                   + lp["end_to_right_flank"] + torch.log(flank))
    total = total + (ALPHA_FLANK - 1) * flank_terms.sum()
    total = total + (ALPHA_SINGLE - 1) * torch.log(p["end_to_right_flank"] + p["end_to_terminal"]).sum()
    btm = p["begin_to_match"] / (1 - p["match_to_delete"][0]).clamp_min(eps)
    enex = torch.tril(btm[:, None] * p["match_to_end"][None, :])
    log_enex = torch.log((1 - enex).clamp_min(eps))
    return total + (ALPHA_GLOBAL - 1) * (log_enex.sum() - log_enex[0, -1])


def amino_prior(B, n):
    """The match states' amino-acid distributions (first 20 channels,
    renormalised) under the 9-component mixture."""
    rows = B[1 : n + 1, :20]
    rows = rows / rows.sum(-1, keepdim=True).clamp_min(1e-16)
    return dirichlet_mixture_log_pdf(rows, *_mixture("amino_prior_9")).sum()


def map_loss(params, lengths, x, num_seqs, prec: Precision = F64):
    """The MAP objective, negated: -(mean log-likelihood over models and
    sequences + mean over models of (transition + amino prior) / num_seqs).
    ``x`` (b, L, 26) one-hot residues, shared by the models."""
    from . import hmm

    x = x.to(prec.dtype)
    ll, prior = [], []
    for i, n in enumerate(lengths):
        kernels = {name: params[f"transitions.kernels.{i}.{name}"]
                   for name, _ in explicit_parts(n) if name not in SHARED}
        init, A, p, flank = implicit_model(kernels, params[f"transitions.flank_init_kernel.{i}"], n, prec)
        B = emission_matrix(params[f"emissions.0.emission_kernel.{i}"], params[f"emissions.0.insertion_kernel.{i}"], prec)
        E = prec.mm(x, B.T)
        ll.append(hmm.log_likelihood(init, A, E, prec))
        prior.append(transition_prior(p, flank) + amino_prior(B, n))
    return -(torch.stack(ll).mean() + (torch.stack(prior) / num_seqs).mean())
