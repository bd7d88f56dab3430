"""Structured Plan7 matvec: the implicit profile-HMM transition operator
applied in O(L) per position instead of a dense O(q²) matvec (port of
``hmm_layer_tpu/ops/plan7.py``).

The implicit transition matrix of the profile family (silent-state
elimination, :mod:`hmm_layer_torch.models.profile_transitions`) is ~1/8
dense and rank-structured: the upper-triangular ``match_skip`` block is
exactly rank one, ``skip(i→j) = exp(MD_i − csDD_i) · exp(csDD_{j-2} +
DM_{j-2})``, the match and insert bands are diagonals, and the flank and
unannotated rows and columns are O(L) vectors. The forward matvec
``r = α @ A`` is therefore elementwise products, two shifts, a cumulative
sum (for the rank-one triangle) and four dot products.

State components per model (implicit order LF, M×L, I×(L−1), U, RF, T)
are padded to ``Lmax`` across models; padded entries carry zero
probability and never receive mass.

Plain torch ops differentiated by autograd, as the JAX package tapes its
scan; no kernel runs here.
"""

from __future__ import annotations

import numpy as np
import torch

from .semiring import EPS

__all__ = ["structured_operator", "split_components", "structured_log_likelihood"]


def _pad_to(x, n, value=0.0):
    pad = n - x.shape[-1]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_full(x.shape[:-1] + (pad,), value)], dim=-1)


def structured_operator(trans):
    """The O(L) operator vectors of a :class:`ProfileTransitions`.

    Returns a dict of tensors stacked over models (padded to Lmax):
    scalars (m,), vectors (m, Lmax). Probabilities in linear space.
    """
    implicit, log_probs, _ = trans.make_implicit_log_probs()
    Lm = max(trans.lengths)
    models = range(trans.num_models)

    def stack(name):
        return torch.stack([_pad_to(torch.exp(implicit[i][name]), Lm) for i in models])

    def scal(name):
        return torch.stack([torch.exp(implicit[i][name][0]) for i in models])

    op = {
        "lf_loop": scal("left_flank_loop"),
        "lf_to_match": stack("left_flank_to_match"),
        "lf_to_rf": scal("left_flank_to_right_flank"),
        "lf_to_u": scal("left_flank_to_unannotated_segment"),
        "lf_to_t": scal("left_flank_to_terminal"),
        "MM": stack("match_to_match"),
        "MI": stack("match_to_insert"),
        "IM": stack("insert_to_match"),
        "II": stack("insert_to_insert"),
        "m_to_u": stack("match_to_unannotated"),
        "m_to_rf": stack("match_to_right_flank"),
        "m_to_t": stack("match_to_terminal"),
        "u_to_match": stack("unannotated_segment_to_match"),
        "u_loop": scal("unannotated_segment_loop"),
        "u_to_rf": scal("unannotated_segment_to_right_flank"),
        "u_to_t": scal("unannotated_segment_to_terminal"),
        "rf_loop": scal("right_flank_loop"),
        "rf_exit": scal("right_flank_exit"),
    }

    # Rank-one match-skip factors: skip(i→j) = u_vec[i-1] * v_vec[j-1]
    # (match indices 1..l → 0-based t = i-1), valid for j ≥ i+2; u_vec is
    # zero outside 1..l-2 and v_vec outside 3..l, so the cumsum below needs
    # no masks. M_skip[r, c] = MD[r] + csDD[c] − csDD[r] + DM[c] is the
    # edge (i = r, j = c+2).
    def skip_uv(i):
        p = log_probs[i]
        l = trans.lengths[i]
        MD = p["match_to_delete"]
        DD = torch.cat([MD.new_zeros(1), p["delete_to_delete"]], dim=0)
        cs = torch.cumsum(DD, dim=0)
        DM = p["delete_to_match"]
        u_log = MD - cs  # (l,) rows of M_skip (row 0 = BEGIN)
        v_log = cs + DM  # (l,) columns of M_skip (column c → match c+2)
        t = torch.arange(l, device=MD.device)
        u = torch.where((t >= 1) & (t <= l - 2), torch.exp(u_log), 0.0)
        u_vec = torch.cat([u[1:], MD.new_zeros(1)])  # index t = i-1
        v = torch.cat([MD.new_zeros(2), torch.exp(v_log[1 : l - 1])])  # v_log[j-2], j >= 3
        return _pad_to(u_vec, Lm), _pad_to(v, Lm)

    uv = [skip_uv(i) for i in models]
    op["skip_u"] = torch.stack([u for u, _ in uv])
    op["skip_v"] = torch.stack([v for _, v in uv])

    # Per-model component masks: l matches, l-1 inserts, in (m, Lmax).
    mask_m = np.zeros((trans.num_models, Lm), np.float32)
    mask_i = np.zeros((trans.num_models, Lm), np.float32)
    for i, l in enumerate(trans.lengths):
        mask_m[i, :l] = 1.0
        mask_i[i, : l - 1] = 1.0
    device = op["MM"].device
    op["match_mask"] = torch.as_tensor(mask_m, device=device)
    op["insert_mask"] = torch.as_tensor(mask_i, device=device)
    return op


def split_components(trans, x):
    """Split a dense state-ordered tensor (m, ..., q_max) into components.

    Returns a dict with 'lf', 'u', 'rf', 't' of shape (m, ...) and 'm',
    'i' of shape (m, ..., Lmax) (zero padded).
    """
    Lm = max(trans.lengths)
    lf, mm, ii, uu, rf, tt = [], [], [], [], [], []
    for k, l in enumerate(trans.lengths):
        xk = x[k]
        lf.append(xk[..., 0])
        mm.append(_pad_to(xk[..., 1 : 1 + l], Lm))
        ii.append(_pad_to(xk[..., 1 + l : 2 * l], Lm))
        uu.append(xk[..., 2 * l])
        rf.append(xk[..., 2 * l + 1])
        tt.append(xk[..., 2 * l + 2])
    return {
        "lf": torch.stack(lf),
        "m": torch.stack(mm),
        "i": torch.stack(ii),
        "u": torch.stack(uu),
        "rf": torch.stack(rf),
        "t": torch.stack(tt),
    }


def _shift_add(r, x, k):
    """``r`` with ``x[..., :-k]`` added at ``[..., k:]`` (out of place)."""
    return torch.cat([r[..., :k], r[..., k:] + x[..., :-k]], dim=-1)


def _matvec(op, a):
    """r = alpha @ A_implicit in component space; O(L) per call."""
    a_lf, a_m, a_i = a["lf"], a["m"], a["i"]
    a_u, a_rf, a_t = a["u"], a["rf"], a["t"]
    # broadcast helpers: scalars (m,) -> (m, 1) matching (m, b)
    s = lambda x: x[:, None]  # noqa: E731
    v = lambda x: x[:, None, :]  # noqa: E731

    # match destinations
    r_m = a_lf[..., None] * v(op["lf_to_match"])
    r_m = _shift_add(r_m, a_m * v(op["MM"]), 1)
    r_m = _shift_add(r_m, a_i * v(op["IM"]), 1)
    S = torch.cumsum(a_m * v(op["skip_u"]), dim=-1)
    r_m = torch.cat([r_m[..., :2], r_m[..., 2:] + v(op["skip_v"])[..., 2:] * S[..., :-2]], dim=-1)
    r_m = r_m + a_u[..., None] * v(op["u_to_match"])

    # insert destinations: insert k is fed by match i = k+1 (0-based t = k)
    # and by its own loop: r_i[k] = a_m[k]*MI[k] + a_i[k]*II[k].
    r_i = a_i * v(op["II"]) + a_m * v(op["MI"])

    dot = lambda x, w: (x * v(w)).sum(-1)  # noqa: E731
    r_u = dot(a_m, op["m_to_u"]) + a_u * s(op["u_loop"]) + a_lf * s(op["lf_to_u"])
    r_rf = (
        dot(a_m, op["m_to_rf"])
        + a_u * s(op["u_to_rf"])
        + a_lf * s(op["lf_to_rf"])
        + a_rf * s(op["rf_loop"])
    )
    r_t = (
        dot(a_m, op["m_to_t"])
        + a_u * s(op["u_to_t"])
        + a_rf * s(op["rf_exit"])
        + a_lf * s(op["lf_to_t"])
        + a_t
    )
    r_lf = a_lf * s(op["lf_loop"])
    return {"lf": r_lf, "m": r_m, "i": r_i, "u": r_u, "rf": r_rf, "t": r_t}


def _total(a):
    return a["lf"] + a["m"].sum(-1) + a["i"].sum(-1) + a["u"] + a["rf"] + a["t"]


def _scale(a, z):
    zi = 1.0 / z
    return {k: v * (zi[..., None] if v.dim() == 3 else zi) for k, v in a.items()}


def _emul(E_t, r, masks):
    """s = E_t ⊙ r (clamped), the padded match/insert entries kept at 0."""
    mask_m, mask_i = masks
    out = {}
    for k in ("lf", "u", "rf", "t"):
        out[k] = torch.clamp_min(E_t[k], EPS) * torch.clamp_min(r[k], EPS)
    for k, mask in (("m", mask_m), ("i", mask_i)):
        out[k] = torch.clamp_min(E_t[k], EPS) * torch.clamp_min(r[k], EPS) * mask[:, None, :]
    return out


def structured_log_likelihood(trans, E):
    """(m, b) log-likelihoods through the structured Plan7 matvec.

    Equals ``recursion.log_likelihood(*trans.matrices(), E, 1)`` to
    floating-point tolerance without building A; differentiable by
    autograd through the scan.
    """
    op = structured_operator(trans)
    init = trans.make_initial_distribution()
    masks = (op["match_mask"], op["insert_mask"])
    m, b, L, q = E.shape

    Es = split_components(trans, E.movedim(2, 1))  # (m, L, b, ·)
    init_c = split_components(trans, init)  # (m, ·)
    init_b = {
        k: (x[:, None, :].expand(m, b, x.shape[-1]) if x.dim() == 2 else x[:, None].expand(m, b))
        for k, x in init_c.items()
    }

    s0 = _emul({k: x[:, 0] for k, x in Es.items()}, init_b, masks)
    z0 = _total(s0)
    alpha, ll = _scale(s0, z0), torch.log(z0)
    for t in range(1, L):
        s = _emul({k: x[:, t] for k, x in Es.items()}, _matvec(op, alpha), masks)
        z = _total(s)
        alpha, ll = _scale(s, z), ll + torch.log(z)
    return ll
