"""Sum-product kernels K1–K3, K2c and K3c: CUDA wrappers, plain versions,
counters.

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

The sequential passes at 64 < q <= :data:`MAX_WIDE_Q` (``recursion._LoglikSeq``
on CUDA) run K2c, :func:`sum_forward_wide` (the scaled forward pass: the
log-likelihood (m, b) and, when asked, log alpha (m, b, L, q)), and K3c,
:func:`sum_backward_wide` (log beta (m, b, L, q)), both in
``csrc/sum_product_wide.cu`` on the sequence-major layout of E (m, b, L, q),
counted under ``sum_forward_wide`` and ``sum_backward_wide``. They replace
no TPU kernel: the JAX package leaves those passes to ``lax.scan``; their
plain versions are the scan's arithmetic, which ``recursion._forward_seq``
and ``recursion._backward_seq`` run. The kernel picks its cut from q: A's
columns in the shared memory of one block (q <= 160) or of a cluster of up
to 8 (q <= 512); above that the register cut, 96 columns a block of a
cluster of ceil(q / 96), a third of them in registers (q = 647: seven
blocks, ~2.9 us a step of a cluster on an H100, a pass at m = 5, b = 64,
L = 400 in ~6.8 ms).

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
    "MIN_WIDE_Q",
    "MAX_WIDE_Q",
    "sum_forward_wide",
    "sum_backward_wide",
    "sum_forward_wide_plain",
    "sum_backward_wide_plain",
]

KERNEL_MAX_Q = 16  # states a thread carries in registers (MAXQ in csrc)
_TINY = 1e-30  # normaliser floor (no 0/0 in dead rows)
# States of K2c/K3c: above the eager loop's q <= 64, up to the A that a
# cluster of 8 blocks holds on chip (csrc/sum_product_wide.cu): in shared
# memory to q = 512, above that a third of each block's columns in
# registers, 44 states a warp's slice (16 x 44 = 704).
MIN_WIDE_Q, MAX_WIDE_Q = 65, 704

LAUNCHES = {
    "sum_chunk_summaries": 0,
    "sum_fwd_outputs": 0,
    "beta_bwd_outputs": 0,
    "sum_forward_wide": 0,
    "sum_backward_wide": 0,
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


def sum_forward_wide_plain(init, A, E, write_alpha: bool):
    """K2c's plain version, the scaled sequential forward loop
    (``recursion._forward_seq``): (log alpha (m, b, L, q), or None without
    ``write_alpha``; the log-likelihood (m, b))."""
    L = E.shape[2]
    s = torch.clamp_min(E[:, :, 0], EPS) * torch.clamp_min(init, EPS)[:, None, :]
    z = s.sum(-1, keepdim=True)
    alpha, ll = s / z, torch.log(z[..., 0])
    outs = [torch.log(alpha) + ll[..., None]] if write_alpha else None
    for t in range(1, L):
        s = torch.clamp_min(E[:, :, t], EPS) * torch.clamp_min(torch.matmul(alpha, A), EPS)
        z = s.sum(-1, keepdim=True)
        alpha, ll = s / z, ll + torch.log(z[..., 0])
        if write_alpha:
            outs.append(torch.log(alpha) + ll[..., None])
    return (torch.stack(outs, dim=2) if write_alpha else None), ll


def sum_backward_wide_plain(A, E):
    """K3c's plain version, the scaled sequential backward loop
    (``recursion._backward_seq``): log beta (m, b, L, q), rescaled by the
    row max each step.

    beta_L = 1; beta_t(i) = sum_j A[i, j] * E_{t+1}(j) * beta_{t+1}(j).
    """
    m, b, L, q = E.shape
    beta = torch.ones((m, b, q), dtype=E.dtype, device=E.device)
    ll = torch.zeros((m, b), dtype=E.dtype, device=E.device)
    A_T = A.transpose(-1, -2)
    outs = [torch.zeros_like(beta)]
    for t in range(L - 1, 0, -1):  # consume e_t, produce beta_{t-1}
        s = torch.clamp_min(torch.matmul(torch.clamp_min(E[:, :, t], EPS) * beta, A_T), EPS)
        z = s.amax(-1, keepdim=True)
        beta, ll = s / z, ll + torch.log(z[..., 0])
        outs.append(torch.log(beta) + ll[..., None])
    return torch.stack(outs[::-1], dim=2)


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


def _wide_shapes(name, A, E):
    """(m, b, L, q) of K2c's or K3c's emissions E (m, b, L, q)."""
    if E.dim() != 4:
        raise ValueError(f"{name}: E must be (m, b, L, q), got {tuple(E.shape)}")
    m, b, L, q = E.shape
    if not MIN_WIDE_Q <= q <= MAX_WIDE_Q:
        raise ValueError(f"{name}: the kernel takes {MIN_WIDE_Q - 1} < q <= {MAX_WIDE_Q}, got q={q}")
    if tuple(A.shape) != (m, q, q):
        raise ValueError(f"{name}: A has shape {tuple(A.shape)}, expected {(m, q, q)}")
    if min(m, b, L) < 1:
        raise ValueError(f"{name}: empty input E {tuple(E.shape)}")
    return m, b, L, q


def _cuda_only(name, E):
    if E.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {E.device} have no kernel")


def sum_forward_wide(init, A, E, write_alpha: bool):
    """K2c: the scaled sequential forward pass for 64 < q <= 704, as
    :func:`sum_forward_wide_plain` within float32 rounding (the division
    by the scale follows the product; the sums run in another order).

    Args:
        init: (m, q) linear initial distributions.
        A: (m, q, q) linear transition matrices.
        E: (m, b, L, q) linear emissions, sequence-major.
        write_alpha: also return log alpha (m, b, L, q) (``log(alpha_t) +
            ll_t`` as the plain version); else None in its place.

    Returns:
        (log alpha or None, the log-likelihood (m, b)).
    """
    if E.device.type == "cpu":
        return sum_forward_wide_plain(init, A, E, write_alpha)
    name = "sum_forward_wide"
    m, b, L, q = _wide_shapes(name, A, E)
    _check(name, E.device, init=init, A=A, E=E)
    if tuple(init.shape) != (m, q):
        raise ValueError(f"{name}: init has shape {tuple(init.shape)}, expected {(m, q)}")
    _cuda_only(name, E)
    lib = _cuda_build.load("sum_product_wide")

    def launch(init, A, E):
        ll = torch.empty((m, b), dtype=torch.float32, device=E.device)
        la = torch.empty(E.shape, dtype=torch.float32, device=E.device) if write_alpha else None
        device, stream = _launch_args(E.device)
        _raise_on(name, lib.hmm_sum_forward_wide(
            init.data_ptr(), A.data_ptr(), E.data_ptr(), None if la is None else la.data_ptr(),
            ll.data_ptr(), m, b, L, q, device, stream,
        ))
        return (la, ll) if write_alpha else ll

    res = _KernelOnly.apply(launch, init, A, E)
    LAUNCHES[name] += 1
    return res if write_alpha else (None, res)


def sum_backward_wide(A, E):
    """K3c: log beta (m, b, L, q) of the scaled sequential backward pass
    for 64 < q <= 704, as :func:`sum_backward_wide_plain` within float32
    rounding.

    Args:
        A: (m, q, q) linear transition matrices.
        E: (m, b, L, q) linear emissions, sequence-major.
    """
    if E.device.type == "cpu":
        return sum_backward_wide_plain(A, E)
    name = "sum_backward_wide"
    m, b, L, q = _wide_shapes(name, A, E)
    _check(name, E.device, A=A, E=E)
    _cuda_only(name, E)
    lib = _cuda_build.load("sum_product_wide")

    def launch(A, E):
        out = torch.empty(E.shape, dtype=torch.float32, device=E.device)
        device, stream = _launch_args(E.device)
        _raise_on(name, lib.hmm_sum_backward_wide(
            A.data_ptr(), E.data_ptr(), out.data_ptr(), m, b, L, q, device, stream,
        ))
        return out

    out = _KernelOnly.apply(launch, A, E)
    LAUNCHES[name] += 1
    return out
