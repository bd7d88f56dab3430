"""Max-plus Viterbi kernels K6–K8: CUDA wrappers, plain versions, counters.

Port of the q <= 16 kernels of ``hmm_layer_tpu/ops/pallas_viterbi.py``.
Each kernel of ``csrc/max_plus.cu`` has here

* a wrapper (:func:`maxplus_chunk_summaries`, :func:`maxplus_deltas`,
  :func:`maxplus_backtrace`) that takes the plain version for a tensor on
  the CPU, and for a CUDA tensor launches the kernel or raises;
* a plain PyTorch version (``*_plain``) that does the kernel's arithmetic
  in the kernel's order — one rounded add per term, an exact max, one
  rounded add of the emission — so the two are bit-equal;
* a launch count in :data:`LAUNCHES`, raised by one where the wrapper
  launches its kernel and nowhere else.

:func:`maxplus_decode` is K7 then K8, as ``pallas_viterbi.maxplus_decode``.

Layouts (R = b·P chunk elements, lane ``r`` = sequence ``r // P``, chunk
``r % P``; the model axis ``m`` leads; everything log space):

* ``log_A`` (m, q, q) ``log(max(A, EPS))``; ``log_E_T`` (m, c, q, R)
  ``log(max(E, EPS))``.
* ``C_T`` (m, R, q, q), TRANSPOSED: ``C_T[:, r, j, i]`` = best path score
  from left border ``i`` to right border ``j``.
* ``deltas`` (m, c, q, R); ``states`` (m, c, R) int32.

Decoding has no gradient: on CUDA the float-valued launches are wrapped in
an ``autograd.Function`` whose backward raises, so none is silently
dropped.

The blocked bodies of ``maxplus_deltas`` / ``maxplus_backtrace`` for
16 < q <= 64 (K7b, K8b) are not ported yet (ROADMAP Queue 2).
"""

from __future__ import annotations

import torch

from . import _cuda_build
from .cuda_forward import _check, _kernel_shapes, _KernelOnly, _launch_args, _raise_on

__all__ = [
    "NEG",
    "LAUNCHES",
    "reset_launches",
    "maxplus_chunk_summaries",
    "maxplus_deltas",
    "maxplus_backtrace",
    "maxplus_decode",
    "maxplus_chunk_summaries_plain",
    "maxplus_deltas_plain",
    "maxplus_backtrace_plain",
]

# Sentinel for impossible paths: finite, never -inf (the JAX ``_NEG``).
NEG = -1e30

LAUNCHES = {
    "maxplus_chunk_summaries": 0,
    "maxplus_deltas": 0,
    "maxplus_backtrace": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions (the kernels' arithmetic, vectorised over lanes)
# ---------------------------------------------------------------------------


def maxplus_chunk_summaries_plain(log_A, log_E_T, P: int):
    """K6's plain version: transposed tropical chunk operators C_T
    (m, R, q, q)."""
    m, c, q, R = log_E_T.shape
    e = log_E_T.transpose(-1, -2)  # (m, c, R, q)
    first = (torch.arange(R, device=log_E_T.device) % P == 0)[None, :, None, None]
    eye = torch.full((q, q), NEG, dtype=log_E_T.dtype, device=log_E_T.device)
    eye.fill_diagonal_(0.0)
    # Carry M[m, r, i, k]: column i of C_T over the current state k.
    M = torch.where(first, eye, log_A[:, None]) + e[:, 0, :, None, :]
    A_b = log_A[:, None, None]  # (m, 1, 1, k, p)
    for t in range(1, c):
        M = (M[..., :, None] + A_b).amax(dim=-2) + e[:, t, :, None, :]
    return M.transpose(-1, -2).contiguous()


def maxplus_deltas_plain(log_A, log_E_T, delta0):
    """K7's plain version: deltas (m, c, q, R) from the start delta0
    (m, q, R) (conditional start plus first emission)."""
    m, c, q, R = log_E_T.shape
    e = log_E_T.transpose(-1, -2)  # (m, c, R, q)
    A_b = log_A[:, None]  # (m, 1, k, p)
    d = delta0.transpose(-1, -2)  # (m, R, q)
    outs = [d]
    for t in range(1, c):
        d = (d[..., :, None] + A_b).amax(dim=-2) + e[:, t]
        outs.append(d)
    return torch.stack(outs, dim=1).transpose(-1, -2).contiguous()


def maxplus_backtrace_plain(log_A, deltas, last_state):
    """K8's plain version: states (m, c, R) int32, walking back from
    ``last_state`` (m, R) with the lowest argmax of
    ``deltas[t, k] + log_A[k, s_{t+1}]``."""
    m, c, q, R = deltas.shape
    log_A_T = log_A.transpose(-1, -2)  # (m, p, k): row s is column s of log A
    rows = torch.arange(m, device=deltas.device)[:, None]
    s = last_state.long()
    out = [s]
    for t in range(c - 2, -1, -1):
        s = (deltas[:, t].transpose(-1, -2) + log_A_T[rows, s]).argmax(dim=-1)
        out.append(s)
    return torch.stack(out[::-1], dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


class _NoGradient(_KernelOnly):
    """Runs ``launch(*tensors)``; its backward raises instead of returning a
    wrong (missing) gradient."""

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the max-plus Viterbi kernels have no gradient: decoding is not "
            "differentiable; differentiate the posterior or the log-likelihood"
        )


def maxplus_chunk_summaries(log_A, log_E_T, P: int):
    """K6: transposed tropical chunk operators C_T (m, R, q, q).

    Args:
        log_A: (m, q, q) log transition matrices.
        log_E_T: (m, c, q, R) log emissions.
        P: chunks per sequence (lane ``r`` starts its sequence when
            ``r % P == 0``: identity first step instead of log A's rows).
    """
    if log_E_T.device.type == "cpu":
        return maxplus_chunk_summaries_plain(log_A, log_E_T, P)
    name = "maxplus_chunk_summaries"
    m, c, q, R = _kernel_shapes(name, log_A, log_E_T)
    _check(name, log_E_T.device, log_A=log_A, log_E_T=log_E_T)
    lib = _cuda_build.load("max_plus")

    def launch(log_A, log_E_T):
        C_T = torch.empty((m, R, q, q), dtype=torch.float32, device=log_E_T.device)
        device, stream = _launch_args(log_E_T.device)
        _raise_on(name, lib.hmm_maxplus_chunk_summaries(
            log_A.data_ptr(), log_E_T.data_ptr(), C_T.data_ptr(),
            m, c, q, R, int(P), device, stream,
        ))
        return C_T

    C_T = _NoGradient.apply(launch, log_A, log_E_T)
    LAUNCHES[name] += 1
    return C_T


def maxplus_deltas(log_A, log_E_T, delta0):
    """K7: max-plus forward values (m, c, q, R) at every position.

    Args:
        log_A: (m, q, q); log_E_T: (m, c, q, R) as for
            :func:`maxplus_chunk_summaries`.
        delta0: (m, q, R) the value at each chunk's first position
            (conditional start plus first emission).
    """
    if log_E_T.device.type == "cpu":
        return maxplus_deltas_plain(log_A, log_E_T, delta0)
    name = "maxplus_deltas"
    m, c, q, R = _kernel_shapes(name, log_A, log_E_T)
    _check(name, log_E_T.device, log_A=log_A, log_E_T=log_E_T, delta0=delta0)
    if tuple(delta0.shape) != (m, q, R):
        raise ValueError(f"{name}: delta0 {tuple(delta0.shape)} does not match "
                         f"log_E_T {tuple(log_E_T.shape)}")
    lib = _cuda_build.load("max_plus")

    def launch(log_A, log_E_T, delta0):
        out = torch.empty((m, c, q, R), dtype=torch.float32, device=log_E_T.device)
        device, stream = _launch_args(log_E_T.device)
        _raise_on(name, lib.hmm_maxplus_deltas(
            log_A.data_ptr(), log_E_T.data_ptr(), delta0.data_ptr(), out.data_ptr(),
            m, c, q, R, device, stream,
        ))
        return out

    out = _NoGradient.apply(launch, log_A, log_E_T, delta0)
    LAUNCHES[name] += 1
    return out


def maxplus_backtrace(log_A, deltas, last_state):
    """K8: decoded states (m, c, R) int32 from stored deltas; always one
    valid optimal path per chunk element.

    Args:
        log_A: (m, q, q); deltas: (m, c, q, R) from :func:`maxplus_deltas`.
        last_state: (m, R) int32 in [0, q), the state at each chunk's last
            position.
    """
    if deltas.device.type == "cpu":
        return maxplus_backtrace_plain(log_A, deltas, last_state)
    name = "maxplus_backtrace"
    m, c, q, R = _kernel_shapes(name, log_A, deltas)
    _check(name, deltas.device, log_A=log_A, deltas=deltas)
    if (tuple(last_state.shape) != (m, R) or last_state.dtype != torch.int32
            or last_state.device != deltas.device or not last_state.is_contiguous()):
        raise ValueError(f"{name}: last_state must be a contiguous int32 {(m, R)} "
                         f"tensor on {deltas.device}, got {last_state.dtype} "
                         f"{tuple(last_state.shape)} on {last_state.device}")
    lib = _cuda_build.load("max_plus")
    states = torch.empty((m, c, R), dtype=torch.int32, device=deltas.device)
    device, stream = _launch_args(deltas.device)
    _raise_on(name, lib.hmm_maxplus_backtrace(
        log_A.data_ptr(), deltas.data_ptr(), last_state.data_ptr(), states.data_ptr(),
        m, c, q, R, device, stream,
    ))
    LAUNCHES[name] += 1
    return states


def maxplus_decode(log_A, log_E_T, delta0, last_state):
    """Chunk-local delta pass (K7) then within-chunk backtrace (K8):
    states (m, c, R) int32."""
    return maxplus_backtrace(log_A, maxplus_deltas(log_A, log_E_T, delta0), last_state)
