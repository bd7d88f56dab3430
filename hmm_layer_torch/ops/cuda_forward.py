"""Sum-product chunk kernels K1–K3: CUDA wrappers, plain versions, counters.

Port of ``hmm_layer_tpu/ops/pallas_forward.py``. Each kernel of
``csrc/sum_product.cu`` has here

* a wrapper (:func:`sum_chunk_summaries`, :func:`sum_fwd_outputs`,
  :func:`beta_bwd_outputs`) that takes the plain version for a tensor on
  the CPU, and for a CUDA tensor launches the kernel or raises;
* a plain PyTorch version (``*_plain``) that follows the Pallas kernel
  body's arithmetic step for step, including its unclamped first step;
* a launch count in :data:`LAUNCHES`, raised by one where the wrapper
  launches its kernel and nowhere else.

Layouts (R = b·P chunk elements, lane ``r`` = sequence ``r // P``, chunk
``r % P``; the model axis ``m`` leads):

* ``A`` (m, q, q); ``E_T`` (m, c, q, R) emissions clamped to >= EPS.
* ``C`` (m, R, q, q) with ``C[:, r, i, j] = log P(chunk emissions, right
  border j | left border i)``.
* log alpha / log beta (m, c, q, R).

The kernels have no backward of their own: on CUDA each launch is wrapped
in an ``autograd.Function`` whose backward raises, so no gradient is
silently dropped. Gradients come from the analytic VJPs of
:mod:`.recursion` (``_LoglikChunked``, ``_PosteriorChunked``, ...), which
launch these kernels in their forward, where autograd records nothing, and
solve the adjoints with K4–K5 (:mod:`.cuda_adjoint`).
"""

from __future__ import annotations

import torch

from . import _cuda_build
from .semiring import EPS

__all__ = [
    "KERNEL_MAX_Q",
    "LAUNCHES",
    "reset_launches",
    "sum_chunk_summaries",
    "sum_fwd_outputs",
    "beta_bwd_outputs",
    "sum_chunk_summaries_plain",
    "sum_fwd_outputs_plain",
    "beta_bwd_outputs_plain",
]

KERNEL_MAX_Q = 16  # states a thread carries in registers (MAXQ in csrc)
_TINY = 1e-30  # normaliser floor (no 0/0 in dead rows)

LAUNCHES = {
    "sum_chunk_summaries": 0,
    "sum_fwd_outputs": 0,
    "beta_bwd_outputs": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions (the Pallas kernel bodies' arithmetic, vectorised)
# ---------------------------------------------------------------------------


def sum_chunk_summaries_plain(A, E_T, P: int):
    """K1's plain version: log chunk operators C (m, R, q, q)."""
    m, c, q, R = E_T.shape
    e = E_T.transpose(-1, -2)  # (m, c, R, q)
    first = (torch.arange(R, device=E_T.device) % P == 0)[None, :, None, None]
    eye = torch.eye(q, dtype=E_T.dtype, device=E_T.device)
    M = torch.where(first, eye, A[:, None]) * e[:, 0, :, None, :]  # (m, R, i, j)
    z = torch.clamp_min(M.sum(-1, keepdim=True), _TINY)
    M = M / z
    LL = torch.log(z)
    A_b = A[:, None]
    for t in range(1, c):
        acc = torch.clamp_min(torch.matmul(M, A_b), EPS) * e[:, t, :, None, :]
        z = torch.clamp_min(acc.sum(-1, keepdim=True), _TINY)
        M = acc / z
        LL = LL + torch.log(z)
    return torch.log(torch.clamp_min(M, _TINY)) + LL


def sum_fwd_outputs_plain(A, E_T, r0, ll0):
    """K2's plain version: log alpha (m, c, q, R) from starts r0 (m, q, R)
    and their log-masses ll0 (m, R)."""
    m, c, q, R = E_T.shape
    e = E_T.transpose(-1, -2)  # (m, c, R, q)
    s = r0.transpose(-1, -2) * e[:, 0]  # (m, R, q)
    z = torch.clamp_min(s.sum(-1, keepdim=True), _TINY)
    al = s / z
    LL = ll0[..., None] + torch.log(z)
    outs = [torch.log(torch.clamp_min(al, _TINY)) + LL]
    for t in range(1, c):
        s = torch.clamp_min(torch.matmul(al, A), EPS) * e[:, t]
        z = torch.clamp_min(s.sum(-1, keepdim=True), _TINY)
        al = s / z
        LL = LL + torch.log(z)
        outs.append(torch.log(torch.clamp_min(al, _TINY)) + LL)
    return torch.stack(outs, dim=1).transpose(-1, -2)


def beta_bwd_outputs_plain(A, E_T, beta0, ll0):
    """K3's plain version: log beta (m, c, q, R) from right-boundary values
    beta0 (m, q, R) (max-scaled) and their log-scales ll0 (m, R)."""
    m, c, q, R = E_T.shape
    e = E_T.transpose(-1, -2)  # (m, c, R, q)
    A_T = A.transpose(-1, -2)
    be = beta0.transpose(-1, -2)  # (m, R, q)
    LL = ll0[..., None]
    outs = [torch.log(torch.clamp_min(be, _TINY)) + LL]
    for t in range(c - 2, -1, -1):
        s = torch.clamp_min(torch.matmul(be * e[:, t + 1], A_T), EPS)
        z = torch.clamp_min(s.amax(-1, keepdim=True), _TINY)
        be = s / z
        LL = LL + torch.log(z)
        outs.append(torch.log(torch.clamp_min(be, _TINY)) + LL)
    return torch.stack(outs[::-1], dim=1).transpose(-1, -2)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


class _KernelOnly(torch.autograd.Function):
    """Runs ``launch(*tensors)``; its backward raises instead of returning
    a wrong (missing) gradient."""

    @staticmethod
    def forward(ctx, launch, *tensors):
        return launch(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "a CUDA kernel launch has no autograd backward: gradients come "
            "from the analytic chunked VJPs of hmm_layer_torch.ops.recursion "
            "(forward, backward, log_likelihood, posterior; ROADMAP Queue 1 "
            "item 6), whose adjoint solves run K4-K5; call those instead"
        )


def _check(name, device, **tensors):
    for arg, x in tensors.items():
        if x.device != device:
            raise ValueError(f"{name}: {arg} is on {x.device}, expected {device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _launch_args(device):
    """(device index, current stream handle) for a launch on ``device``."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(device).cuda_stream


def _raise_on(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _kernel_shapes(name, A, E_T, max_q=KERNEL_MAX_Q):
    if E_T.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {E_T.device} have no kernel")
    m, c, q, R = E_T.shape
    if not 1 <= q <= max_q:
        raise ValueError(f"{name}: the kernel takes 1 <= q <= {max_q}, got q={q}")
    if tuple(A.shape) != (m, q, q):
        raise ValueError(f"{name}: A has shape {tuple(A.shape)}, expected {(m, q, q)}")
    if min(m, c, R) < 1:
        raise ValueError(f"{name}: empty input E_T {tuple(E_T.shape)}")
    return m, c, q, R


def sum_chunk_summaries(A, E_T, P: int):
    """K1: log chunk transfer operators C (m, R, q, q).

    Args:
        A: (m, q, q) linear transition matrices.
        E_T: (m, c, q, R) linear emissions clamped to >= EPS.
        P: chunks per sequence (lane ``r`` starts its sequence when
            ``r % P == 0``: identity first step instead of A's rows).
    """
    if E_T.device.type == "cpu":
        return sum_chunk_summaries_plain(A, E_T, P)
    name = "sum_chunk_summaries"
    m, c, q, R = _kernel_shapes(name, A, E_T)
    _check(name, E_T.device, A=A, E_T=E_T)
    lib = _cuda_build.load()

    def launch(A, E_T):
        C = torch.empty((m, R, q, q), dtype=torch.float32, device=E_T.device)
        device, stream = _launch_args(E_T.device)
        _raise_on(name, lib.hmm_sum_chunk_summaries(
            A.data_ptr(), E_T.data_ptr(), C.data_ptr(),
            m, c, q, R, int(P), device, stream,
        ))
        return C

    C = _KernelOnly.apply(launch, A, E_T)
    LAUNCHES[name] += 1
    return C


def sum_fwd_outputs(A, E_T, r0, ll0):
    """K2: log alpha (m, c, q, R) at every position of every chunk.

    Args:
        A: (m, q, q); E_T: (m, c, q, R) as for :func:`sum_chunk_summaries`.
        r0: (m, q, R) scaled pre-emission start of each chunk.
        ll0: (m, R) its log-mass (log alpha_start = log r0 + ll0).
    """
    if E_T.device.type == "cpu":
        return sum_fwd_outputs_plain(A, E_T, r0, ll0)
    name = "sum_fwd_outputs"
    m, c, q, R = _kernel_shapes(name, A, E_T)
    _check(name, E_T.device, A=A, E_T=E_T, r0=r0, ll0=ll0)
    if tuple(r0.shape) != (m, q, R) or tuple(ll0.shape) != (m, R):
        raise ValueError(f"{name}: r0 {tuple(r0.shape)} / ll0 {tuple(ll0.shape)} "
                         f"do not match E_T {tuple(E_T.shape)}")
    lib = _cuda_build.load()

    def launch(A, E_T, r0, ll0):
        out = torch.empty((m, c, q, R), dtype=torch.float32, device=E_T.device)
        device, stream = _launch_args(E_T.device)
        _raise_on(name, lib.hmm_sum_fwd_outputs(
            A.data_ptr(), E_T.data_ptr(), r0.data_ptr(), ll0.data_ptr(),
            out.data_ptr(), m, c, q, R, device, stream,
        ))
        return out

    out = _KernelOnly.apply(launch, A, E_T, r0, ll0)
    LAUNCHES[name] += 1
    return out


def beta_bwd_outputs(A, E_T, beta0, ll0):
    """K3: log beta (m, c, q, R) at every position of every chunk.

    Args:
        A: (m, q, q); E_T: (m, c, q, R) as for :func:`sum_chunk_summaries`.
        beta0: (m, q, R) max-scaled backward value at each chunk's last
            position.
        ll0: (m, R) its log-scale.
    """
    if E_T.device.type == "cpu":
        return beta_bwd_outputs_plain(A, E_T, beta0, ll0)
    name = "beta_bwd_outputs"
    m, c, q, R = _kernel_shapes(name, A, E_T)
    _check(name, E_T.device, A=A, E_T=E_T, beta0=beta0, ll0=ll0)
    if tuple(beta0.shape) != (m, q, R) or tuple(ll0.shape) != (m, R):
        raise ValueError(f"{name}: beta0 {tuple(beta0.shape)} / ll0 "
                         f"{tuple(ll0.shape)} do not match E_T {tuple(E_T.shape)}")
    lib = _cuda_build.load()

    def launch(A, E_T, beta0, ll0):
        out = torch.empty((m, c, q, R), dtype=torch.float32, device=E_T.device)
        device, stream = _launch_args(E_T.device)
        _raise_on(name, lib.hmm_beta_bwd_outputs(
            A.data_ptr(), E_T.data_ptr(), beta0.data_ptr(), ll0.data_ptr(),
            out.data_ptr(), m, c, q, R, device, stream,
        ))
        return out

    out = _KernelOnly.apply(launch, A, E_T, beta0, ll0)
    LAUNCHES[name] += 1
    return out
