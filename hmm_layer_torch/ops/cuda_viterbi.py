"""Max-plus Viterbi kernels K6–K8, K7b, K8b, K7c, K8c: CUDA wrappers, plain
versions, counters.

Port of ``hmm_layer_tpu/ops/pallas_viterbi.py``. Each kernel of
``csrc/max_plus.cu`` has here

* a wrapper (:func:`maxplus_chunk_summaries`, :func:`maxplus_deltas`,
  :func:`maxplus_backtrace`) that takes the plain version for a tensor on
  the CPU, and for a CUDA tensor launches the kernel or raises;
* a plain PyTorch version (``*_plain``) that does the kernel's arithmetic
  in the kernel's order — one rounded add per term, an exact max, one
  rounded add of the emission — so the two are bit-equal;
* a launch count in :data:`LAUNCHES`, raised by one where the wrapper
  launches its kernel and nowhere else.

As in the JAX package, :func:`maxplus_deltas` and :func:`maxplus_backtrace`
pick their body by q: the q <= 16 kernels K7 and K8, or for
16 < q <= :data:`MAX_BLOCKED_Q` the blocked bodies K7b and K8b (counted
under ``maxplus_deltas_blocked`` and ``maxplus_backtrace_blocked``). The
blocked bodies work sequence-major, (m, b, L, q): their own wrappers
:func:`maxplus_deltas_seq` and :func:`maxplus_backtrace_seq` take that
layout, and :func:`maxplus_deltas` and :func:`maxplus_backtrace` transpose
from and to the layouts below around them. The plain versions are generic
in q and are the plain versions of both bodies (``*_seq_plain`` only
change the layout). :func:`maxplus_decode` is the delta pass then the
backtrace, as ``pallas_viterbi.maxplus_decode``; :func:`maxplus_decode_seq`
is the sequential decode of 16 < q <= 64 on the emissions' own layout.

Layouts (R = b·P chunk elements, lane ``r`` = sequence ``r // P``, chunk
``r % P``; the model axis ``m`` leads; everything log space):

* ``log_A`` (m, q, q) ``log(max(A, EPS))``; ``log_E_T`` (m, c, q, R)
  ``log(max(E, EPS))``.
* ``C_T`` (m, R, q, q), TRANSPOSED: ``C_T[:, r, j, i]`` = best path score
  from left border ``i`` to right border ``j``.
* ``deltas`` (m, c, q, R); ``states`` (m, c, R) int32.

The sequential decode at 16 < q <= 64 (``recursion._viterbi_seq_kernels``)
calls :func:`maxplus_decode_seq` on log E (m, b, L, q): K7b and K8b with
no layout change.

The sequential decode at 64 < q <= :data:`MAX_WIDE_Q`
(``recursion._viterbi_wide_kernels``) runs K7c, :func:`maxplus_deltas_wide`
(uint16 backpointers (m, b, L - 1, q) and the last delta (m, b, q)), then
K8c, :func:`maxplus_backtrace_wide` (the lowest argmax of the last delta
and the pointer walk: paths (m, b, L) int32), both in
``csrc/max_plus_wide.cu`` and counted under ``maxplus_deltas_wide`` and
``maxplus_backtrace_wide``. They replace no TPU kernel: the JAX package
leaves that decode to ``lax.scan``; their plain versions are the scan's
arithmetic (``recursion._viterbi_seq``) with the pointers kept as uint16.

Decoding has no gradient: on CUDA the float-valued launches are wrapped in
an ``autograd.Function`` whose backward raises, so none is silently
dropped.
"""

from __future__ import annotations

import torch

from . import _cuda_build
from .semiring import maxargmatvec
from .cuda_forward import (
    KERNEL_MAX_Q,
    _check,
    _kernel_shapes,
    _KernelOnly,
    _launch_args,
    _raise_on,
)

__all__ = [
    "NEG",
    "MAX_BLOCKED_Q",
    "LAUNCHES",
    "reset_launches",
    "maxplus_chunk_summaries",
    "maxplus_deltas",
    "maxplus_backtrace",
    "maxplus_decode",
    "maxplus_deltas_seq",
    "maxplus_backtrace_seq",
    "maxplus_decode_seq",
    "MAX_WIDE_Q",
    "maxplus_deltas_wide",
    "maxplus_backtrace_wide",
    "maxplus_deltas_wide_plain",
    "maxplus_backtrace_wide_plain",
    "maxplus_chunk_summaries_plain",
    "maxplus_deltas_plain",
    "maxplus_backtrace_plain",
    "maxplus_deltas_seq_plain",
    "maxplus_backtrace_seq_plain",
]

# Sentinel for impossible paths: finite, never -inf (the JAX ``_NEG``).
NEG = -1e30
# Largest state count of the blocked delta/backtrace bodies (the JAX
# ``pallas_viterbi.MAX_BLOCKED_Q``); K6 keeps q <= 16.
MAX_BLOCKED_Q = 64
# Largest state count of K7c/K8c: a cluster of 8 blocks holds log A in
# registers, 64 columns x 512 rows a block (csrc/max_plus_wide.cu).
MAX_WIDE_Q = 512
# Pointer rows a tile of K8c (WIDE_T in csrc/max_plus_wide.cu, which checks
# it); it sizes the walk's scratch.
_TRACE_TILE = 32

LAUNCHES = {
    "maxplus_chunk_summaries": 0,
    "maxplus_deltas": 0,
    "maxplus_backtrace": 0,
    "maxplus_deltas_blocked": 0,
    "maxplus_backtrace_blocked": 0,
    "maxplus_deltas_wide": 0,
    "maxplus_backtrace_wide": 0,
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
    """K7's and K7b's plain version: deltas (m, c, q, R) from the start
    delta0 (m, q, R) (conditional start plus first emission)."""
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
    """K8's and K8b's plain version: states (m, c, R) int32, walking back from
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


def maxplus_deltas_seq_plain(log_A, log_E, delta0):
    """:func:`maxplus_deltas_plain` on the sequence-major layout: deltas
    (m, b, L, q) from log E (m, b, L, q) and delta0 (m, b, q)."""
    deltas = maxplus_deltas_plain(log_A, log_E.permute(0, 2, 3, 1), delta0.transpose(1, 2))
    return deltas.permute(0, 3, 1, 2).contiguous()


def maxplus_backtrace_seq_plain(log_A, deltas, last_state):
    """:func:`maxplus_backtrace_plain` on the sequence-major layout: states
    (m, b, L) int32 from deltas (m, b, L, q) and ``last_state`` (m, b)."""
    states = maxplus_backtrace_plain(log_A, deltas.permute(0, 2, 3, 1), last_state)
    return states.transpose(1, 2).contiguous()


def maxplus_deltas_wide_plain(log_A, log_E, delta0):
    """K7c's plain version, the delta loop of ``recursion._viterbi_seq``
    (the sequential decode at any q): backpointers (m, b, L - 1, q) uint16
    (int32 past q = 65,536), ``bp[:, :, t - 1, j]`` the lowest k maximising
    ``delta_{t-1}[k] + log_A[k, j]``, and the last delta (m, b, q), from
    log E (m, b, L, q) and delta0 (m, b, q)."""
    m, b, L, q = log_E.shape
    dtype = torch.uint16 if q <= 1 << 16 else torch.int32
    bp = torch.empty((m, b, max(L - 1, 0), q), dtype=dtype, device=log_E.device)
    delta = delta0
    for t in range(1, L):
        best, arg = maxargmatvec(delta, log_A[:, None])
        delta = best + log_E[:, :, t]
        bp[:, :, t - 1] = arg
    return bp, delta


def maxplus_backtrace_wide_plain(bp, last_delta):
    """K8c's plain version, the walk of ``recursion._viterbi_seq``: paths
    (m, b, L) int32 from the lowest argmax of ``last_delta`` (m, b, q)
    back through ``bp`` (m, b, L - 1, q)."""
    state = last_delta.argmax(dim=-1)
    path = [state]
    for t in range(bp.shape[2] - 1, -1, -1):
        state = torch.gather(bp[:, :, t].long(), -1, state[..., None])[..., 0]
        path.append(state)
    return torch.stack(path[::-1], dim=-1).to(torch.int32)


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


def _seq_major(x):
    """(m, c, q, R) -> (m, R, c, q), or (m, q, R) -> (m, R, q): the blocked
    bodies' layout."""
    return x.movedim(-1, 1).contiguous()


def _blocked_shapes(name, log_A, x):
    """(m, R, c, q) of a blocked body's sequence-major input ``x``."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {x.device} have no kernel")
    m, R, c, q = x.shape
    if not KERNEL_MAX_Q < q <= MAX_BLOCKED_Q:
        raise ValueError(f"{name}: the kernel takes {KERNEL_MAX_Q} < q <= {MAX_BLOCKED_Q}, got q={q}")
    if tuple(log_A.shape) != (m, q, q):
        raise ValueError(f"{name}: log_A has shape {tuple(log_A.shape)}, expected {(m, q, q)}")
    if min(m, c, R) < 1:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")
    return m, R, c, q


def _check_last(name, last_state, shape, device):
    if (tuple(last_state.shape) != shape or last_state.dtype != torch.int32
            or last_state.device != device or not last_state.is_contiguous()):
        raise ValueError(f"{name}: last_state must be a contiguous int32 {shape} "
                         f"tensor on {device}, got {last_state.dtype} "
                         f"{tuple(last_state.shape)} on {last_state.device}")


def maxplus_deltas_seq(log_A, log_E, delta0):
    """K7b: max-plus forward values (m, b, L, q) of whole sequences, for
    16 < q <= 64.

    Args:
        log_A: (m, q, q) log transition matrices.
        log_E: (m, b, L, q) log emissions, sequence-major.
        delta0: (m, b, q) the value at each sequence's first position
            (start plus first emission).
    """
    if log_E.device.type == "cpu":
        return maxplus_deltas_seq_plain(log_A, log_E, delta0)
    name = "maxplus_deltas_blocked"
    m, R, c, q = _blocked_shapes(name, log_A, log_E)
    _check(name, log_E.device, log_A=log_A, log_E=log_E, delta0=delta0)
    if tuple(delta0.shape) != (m, R, q):
        raise ValueError(f"{name}: delta0 {tuple(delta0.shape)} does not match "
                         f"log_E {tuple(log_E.shape)}")
    lib = _cuda_build.load("max_plus")

    def launch(log_A, log_E, delta0):
        out = torch.empty(log_E.shape, dtype=torch.float32, device=log_E.device)
        device, stream = _launch_args(log_E.device)
        _raise_on(name, lib.hmm_maxplus_deltas_blocked(
            log_A.data_ptr(), log_E.data_ptr(), delta0.data_ptr(), out.data_ptr(),
            m, c, q, R, device, stream,
        ))
        return out

    out = _NoGradient.apply(launch, log_A, log_E, delta0)
    LAUNCHES[name] += 1
    return out


def maxplus_backtrace_seq(log_A, deltas, last_state):
    """K8b: decoded states (m, b, L) int32 of whole sequences from their
    deltas (m, b, L, q), for 16 < q <= 64; ``last_state`` (m, b) int32 is
    the state at each sequence's last position."""
    if deltas.device.type == "cpu":
        return maxplus_backtrace_seq_plain(log_A, deltas, last_state)
    name = "maxplus_backtrace_blocked"
    m, R, c, q = _blocked_shapes(name, log_A, deltas)
    _check(name, deltas.device, log_A=log_A, deltas=deltas)
    _check_last(name, last_state, (m, R), deltas.device)
    states = torch.empty((m, R, c), dtype=torch.int32, device=deltas.device)
    device, stream = _launch_args(deltas.device)
    _raise_on(name, _cuda_build.load("max_plus").hmm_maxplus_backtrace_blocked(
        log_A.data_ptr(), deltas.data_ptr(), last_state.data_ptr(), states.data_ptr(),
        m, c, q, R, device, stream,
    ))
    LAUNCHES[name] += 1
    return states


def maxplus_decode_seq(log_A, log_E, delta0):
    """Sequential decode of 16 < q <= 64 on the emissions' layout: K7b, the
    lowest argmax of the last deltas, K8b. States (m, b, L) int32."""
    deltas = maxplus_deltas_seq(log_A, log_E, delta0)
    last = deltas[:, :, -1].argmax(dim=-1).to(torch.int32)
    return maxplus_backtrace_seq(log_A, deltas, last)


def _wide_shapes(name, log_A, x):
    """(m, b, L, q) of K7c's or K8c's sequence-major input ``x``."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {x.device} have no kernel")
    m, R, c, q = x.shape
    if not MAX_BLOCKED_Q < q <= MAX_WIDE_Q:
        raise ValueError(f"{name}: the kernel takes {MAX_BLOCKED_Q} < q <= {MAX_WIDE_Q}, got q={q}")
    if log_A is not None and tuple(log_A.shape) != (m, q, q):
        raise ValueError(f"{name}: log_A has shape {tuple(log_A.shape)}, expected {(m, q, q)}")
    if min(m, R) < 1:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")
    return m, R, c, q


def maxplus_deltas_wide(log_A, log_E, delta0):
    """K7c: the sequential delta pass for 64 < q <= 512, keeping only what
    the walk needs: backpointers (m, b, L - 1, q) uint16 and the last delta
    (m, b, q), bit-equal to :func:`maxplus_deltas_wide_plain`.

    Args:
        log_A: (m, q, q) log transition matrices.
        log_E: (m, b, L, q) log emissions, sequence-major.
        delta0: (m, b, q) the value at each sequence's first position
            (start plus first emission).
    """
    if log_E.device.type == "cpu":
        return maxplus_deltas_wide_plain(log_A, log_E, delta0)
    name = "maxplus_deltas_wide"
    m, R, c, q = _wide_shapes(name, log_A, log_E)
    if c < 1:
        raise ValueError(f"{name}: empty input {tuple(log_E.shape)}")
    _check(name, log_E.device, log_A=log_A, log_E=log_E, delta0=delta0)
    if tuple(delta0.shape) != (m, R, q):
        raise ValueError(f"{name}: delta0 {tuple(delta0.shape)} does not match "
                         f"log_E {tuple(log_E.shape)}")
    lib = _cuda_build.load("max_plus_wide")

    def launch(log_A, log_E, delta0):
        bp = torch.empty((m, R, c - 1, q), dtype=torch.uint16, device=log_E.device)
        last = torch.empty((m, R, q), dtype=torch.float32, device=log_E.device)
        device, stream = _launch_args(log_E.device)
        _raise_on(name, lib.hmm_maxplus_deltas_wide(
            log_A.data_ptr(), log_E.data_ptr(), delta0.data_ptr(), bp.data_ptr(), last.data_ptr(),
            m, c, q, R, device, stream,
        ))
        return bp, last

    bp, last = _NoGradient.apply(launch, log_A, log_E, delta0)
    LAUNCHES[name] += 1
    return bp, last


def maxplus_backtrace_wide(bp, last_delta):
    """K8c: decoded states (m, b, L) int32 for 64 < q <= 512 from K7c's
    backpointers ``bp`` (m, b, L - 1, q) uint16 and last delta
    ``last_delta`` (m, b, q): the lowest argmax of the last delta, then the
    walk back, equal to :func:`maxplus_backtrace_wide_plain`."""
    if bp.device.type == "cpu":
        return maxplus_backtrace_wide_plain(bp, last_delta)
    name = "maxplus_backtrace_wide"
    m, R, rows, q = _wide_shapes(name, None, bp)
    if bp.dtype != torch.uint16 or not bp.is_contiguous():
        raise TypeError(f"{name}: bp must be a contiguous uint16 tensor, got {bp.dtype}")
    _check(name, bp.device, last_delta=last_delta)
    if tuple(last_delta.shape) != (m, R, q):
        raise ValueError(f"{name}: last_delta {tuple(last_delta.shape)} does not match "
                         f"bp {tuple(bp.shape)}")
    c = rows + 1
    tiles = -(-rows // _TRACE_TILE)
    states = torch.empty((m, R, c), dtype=torch.int32, device=bp.device)
    maps = torch.empty((m * R * tiles * q,), dtype=torch.uint16, device=bp.device)
    border = torch.empty((m * R * tiles,), dtype=torch.int32, device=bp.device)
    device, stream = _launch_args(bp.device)
    _raise_on(name, _cuda_build.load("max_plus_wide").hmm_maxplus_backtrace_wide(
        bp.data_ptr(), last_delta.data_ptr(), maps.data_ptr(), border.data_ptr(), states.data_ptr(),
        m, c, q, R, tiles, device, stream,
    ))
    LAUNCHES[name] += 1
    return states


def maxplus_deltas(log_A, log_E_T, delta0):
    """K7 (q <= 16) or K7b (16 < q <= 64): max-plus forward values
    (m, c, q, R) at every position.

    Args:
        log_A: (m, q, q); log_E_T: (m, c, q, R) as for
            :func:`maxplus_chunk_summaries`.
        delta0: (m, q, R) the value at each chunk's first position
            (conditional start plus first emission).
    """
    if log_E_T.device.type == "cpu":
        return maxplus_deltas_plain(log_A, log_E_T, delta0)
    name = "maxplus_deltas"
    m, c, q, R = _kernel_shapes(name, log_A, log_E_T, MAX_BLOCKED_Q)
    _check(name, log_E_T.device, log_A=log_A, log_E_T=log_E_T, delta0=delta0)
    if tuple(delta0.shape) != (m, q, R):
        raise ValueError(f"{name}: delta0 {tuple(delta0.shape)} does not match "
                         f"log_E_T {tuple(log_E_T.shape)}")
    if q > KERNEL_MAX_Q:
        deltas = maxplus_deltas_seq(log_A, _seq_major(log_E_T), _seq_major(delta0))
        return deltas.movedim(1, -1).contiguous()
    lib = _cuda_build.load("max_plus")

    def launch(log_A, log_E_T, delta0):
        out = torch.empty(log_E_T.shape, dtype=torch.float32, device=log_E_T.device)
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
    """K8 (q <= 16) or K8b (16 < q <= 64): decoded states (m, c, R) int32
    from stored deltas; always one valid optimal path per chunk element.

    Args:
        log_A: (m, q, q); deltas: (m, c, q, R) from :func:`maxplus_deltas`.
        last_state: (m, R) int32 in [0, q), the state at each chunk's last
            position.
    """
    if deltas.device.type == "cpu":
        return maxplus_backtrace_plain(log_A, deltas, last_state)
    name = "maxplus_backtrace"
    m, c, q, R = _kernel_shapes(name, log_A, deltas, MAX_BLOCKED_Q)
    _check(name, deltas.device, log_A=log_A, deltas=deltas)
    _check_last(name, last_state, (m, R), deltas.device)
    if q > KERNEL_MAX_Q:
        return maxplus_backtrace_seq(log_A, _seq_major(deltas), last_state).transpose(1, 2).contiguous()
    states = torch.empty((m, c, R), dtype=torch.int32, device=deltas.device)
    device, stream = _launch_args(deltas.device)
    _raise_on(name, _cuda_build.load("max_plus").hmm_maxplus_backtrace(
        log_A.data_ptr(), deltas.data_ptr(), last_state.data_ptr(), states.data_ptr(),
        m, c, q, R, device, stream,
    ))
    LAUNCHES[name] += 1
    return states


def maxplus_decode(log_A, log_E_T, delta0, last_state):
    """Delta pass (K7 or K7b) then backtrace (K8 or K8b): states (m, c, R)
    int32."""
    return maxplus_backtrace(log_A, maxplus_deltas(log_A, log_E_T, delta0), last_state)
