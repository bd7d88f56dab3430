"""Sequential textbook recursions over one model: scaled forward and
backward passes, the posterior, the log-likelihood and the max-plus
(Viterbi) score and path, one position at a time, differentiated by
autograd.

The engine's numerical floor is part of the model that is judged: the
emissions, the initial distribution and every step's predicted mass are
held at ``EPS`` or above, as the port defines its recursions (the scaled
forward pass normalises by the sum, the backward pass by the maximum).
Shapes: ``init`` (q,), ``A`` (q, q), ``E`` (b, L, q).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

EPS = 1e-16


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest with
    ties to even: the operands a TF32 tensor-core product reads."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """A product whose operands, forward and backward, are rounded to
    TF32, with float32 sums: what a TF32 tensor-core matmul computes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(tf32_round(a), tf32_round(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        ga = torch.matmul(g, tf32_round(b).transpose(-1, -2))
        gb = torch.matmul(tf32_round(a).transpose(-1, -2), g)
        return _sum_to(ga, a.shape), _sum_to(gb, b.shape)


def _sum_to(g, shape):
    """``g`` summed over the axes that broadcasting added to ``shape``."""
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


@dataclass(frozen=True)
class Precision:
    """How the reference computes: ``float64`` (the truth); ``tf32``
    (float32 storage, every product's operands rounded to TF32, float32
    sums: the control one step below float32 with TF32 off, for the
    training cells); ``float32``; ``bfloat16`` (every value and sum in
    bfloat16: the step below float32 for work no tensor core does, the
    decode's max-plus recursion)."""

    name: str = "float64"

    @property
    def dtype(self):
        return {"float64": torch.float64, "bfloat16": torch.bfloat16}.get(self.name, torch.float32)

    def mm(self, a, b):
        if self.name == "tf32":
            return _TF32MatMul.apply(a, b)
        return torch.matmul(a, b)


F64 = Precision("float64")
TF32 = Precision("tf32")
BF16 = Precision("bfloat16")


def _time_major(E):
    return E.clamp_min(EPS).transpose(0, 1).contiguous()  # (L, b, q)


def forward(init, A, E, prec: Precision = F64):
    """(log alpha (b, L, q), loglik (b,)): alpha normalised by its sum
    each step, the log-scale accumulated."""
    Et = _time_major(E)
    s = Et[0] * init.clamp_min(EPS)
    z = s.sum(-1, keepdim=True)
    alpha = s / z
    alphas, zs = [alpha], [z]
    for t in range(1, Et.shape[0]):
        s = Et[t] * prec.mm(alpha, A).clamp_min(EPS)
        z = s.sum(-1, keepdim=True)
        alpha = s / z
        alphas.append(alpha)
        zs.append(z)
    log_scale = torch.cumsum(torch.log(torch.cat(zs, -1)), -1)  # (b, L)
    return torch.log(torch.stack(alphas, 1)) + log_scale[..., None], log_scale[:, -1]


def backward(A, E, prec: Precision = F64):
    """log beta (b, L, q): beta_L = 1, beta_t = A (e_{t+1} beta_{t+1}),
    normalised by its maximum each step."""
    Et = _time_major(E)
    L, b, q = Et.shape
    beta = torch.ones((b, q), dtype=Et.dtype, device=Et.device)
    A_T = A.transpose(-1, -2)
    betas, ws = [beta], [torch.ones((b, 1), dtype=Et.dtype, device=Et.device)]
    for t in range(L - 1, 0, -1):
        s = prec.mm(Et[t] * beta, A_T).clamp_min(EPS)
        w = s.amax(-1, keepdim=True)
        beta = s / w
        betas.append(beta)
        ws.append(w)
    log_scale = torch.cumsum(torch.log(torch.cat(ws, -1)), -1)  # (b, L), from the end
    log_beta = torch.log(torch.stack(betas, 1)) + log_scale[..., None]
    return log_beta.flip(1)


def log_likelihood(init, A, E, prec: Precision = F64):
    """(b,): the forward pass's log-scale alone."""
    Et = _time_major(E)
    s = Et[0] * init.clamp_min(EPS)
    z = s.sum(-1, keepdim=True)
    alpha, zs = s / z, [z]
    for t in range(1, Et.shape[0]):
        s = Et[t] * prec.mm(alpha, A).clamp_min(EPS)
        z = s.sum(-1, keepdim=True)
        alpha = s / z
        zs.append(z)
    return torch.log(torch.cat(zs, -1)).sum(-1)


def posterior(init, A, E, prec: Precision = F64):
    """(log gamma (b, L, q), loglik (b,)) = log alpha + log beta - loglik."""
    la, ll = forward(init, A, E, prec)
    return la + backward(A, E, prec) - ll[:, None, None], ll


def _log_terms(init, A, E):
    return (torch.log(init.clamp_min(EPS)), torch.log(A.clamp_min(EPS)),
            torch.log(E.clamp_min(EPS)).transpose(0, 1).contiguous())


def viterbi_score(init, A, E, allowed=None):
    """(b,): the best path's log score. ``allowed`` (b, L, q) bool, where
    given, restricts the paths to its True states: the best score of the
    paths that agree with a decoded track where it is pinned."""
    log_init, log_A, log_E = _log_terms(init, A, E)
    if allowed is not None:
        log_E = log_E.masked_fill(~allowed.transpose(0, 1), float("-inf"))
    delta = log_init + log_E[0]
    for t in range(1, log_E.shape[0]):
        delta = (delta[:, :, None] + log_A).amax(1) + log_E[t]
    return delta.amax(-1)


def viterbi_path(init, A, E, log_emission_dtype=None):
    """(b, L) int64: a best path (lowest state on ties). With
    ``log_emission_dtype`` the log-emissions are rounded to it first (the
    decode's lower-precision control)."""
    log_init, log_A, log_E = _log_terms(init, A, E)
    if log_emission_dtype is not None:
        log_E = log_E.to(log_emission_dtype).to(log_init.dtype)
    L = log_E.shape[0]
    delta = log_init + log_E[0]
    pointers = []
    for t in range(1, L):
        best, arg = (delta[:, :, None] + log_A).max(1)
        pointers.append(arg.to(torch.uint8))
        delta = best + log_E[t]
    state = delta.argmax(-1)
    path = [state]
    for arg in reversed(pointers):
        state = arg.gather(1, state[:, None])[:, 0].long()
        path.append(state)
    return torch.stack(path[::-1], 1)


def path_score(init, A, E, path):
    """(b,) log score of each path (b, L)."""
    log_init, log_A, log_E = _log_terms(init, A, E)
    log_E = log_E.transpose(0, 1)  # (b, L, q)
    score = log_init[path[:, 0]] + log_E.gather(-1, path[..., None])[..., 0].sum(-1)
    return score + log_A[path[:, :-1], path[:, 1:]].sum(-1)
