"""Affine adjoint kernels K4–K5: CUDA wrappers, plain versions, counters.

Port of ``hmm_layer_tpu/ops/pallas_adjoint.py``. Both kernels solve the
reverse adjoint recursion shared by the analytic VJPs of the chunked
engine (:func:`~hmm_layer_torch.ops.recursion._chunked_affine_reverse`),

    x_t = s_t + u_t * (B @ (v_t * x_{t+1})),

chunk by chunk: K4 (:func:`affine_chunk_composites`) composes each chunk's
steps into one affine map ``[K | o]`` (``x_chunk_start = K @ x_chunk_end +
o``), the boundary fold between the chunks stays in torch, and K5
(:func:`affine_reverse_outputs`) re-runs each chunk from its right-edge
value, writing ``x_t`` at every position. The per-step map entries
``u_i B[i, k] v_k`` are softmax weights in [0, 1] and the sources are
centred, so neither kernel rescales.

Each kernel of ``csrc/affine.cu`` has here

* a wrapper that takes the plain version for a tensor on the CPU, and for
  a CUDA tensor launches the kernel or raises;
* a plain PyTorch version (``*_plain``) with the Pallas body's arithmetic;
* a launch count in :data:`LAUNCHES`, raised by one where the wrapper
  launches its kernel and nowhere else.

Layouts (R = b·P chunk elements, lane ``r`` = sequence ``r // P``, chunk
``r % P``; the model axis ``m`` leads, and the posterior VJP stacks
``B = [A; A^T]`` as 2m models):

* ``B`` (m, q, q); ``U_T``, ``V_T``, ``S_T`` (m, c, q, R), time-major and
  state-transposed.
* ``comp`` (m, R, q, q+1): column ``q`` is the offset ``o``.
* ``x_right`` (m, q, R): the adjoint entering each chunk's right edge;
  ``x`` (m, c, q, R).

The gate mirrors ``pallas_adjoint.supported``: a composite column carry
of q states plus the offset column, q + 1 <= 16.
"""

from __future__ import annotations

import torch

from . import _cuda_build
from .cuda_forward import _check, _KernelOnly, _launch_args, _raise_on

__all__ = [
    "KERNEL_MAX_Q",
    "LAUNCHES",
    "supported",
    "reset_launches",
    "affine_chunk_composites",
    "affine_reverse_outputs",
    "affine_chunk_composites_plain",
    "affine_reverse_outputs_plain",
]

KERNEL_MAX_Q = 15  # q states + 1 offset column <= 16 (MAXQ in csrc)

LAUNCHES = {
    "affine_chunk_composites": 0,
    "affine_reverse_outputs": 0,
}


def supported(q: int) -> bool:
    """The composite carry needs q states + 1 offset column <= 16."""
    return 1 <= q <= KERNEL_MAX_Q


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions (the Pallas kernel bodies' arithmetic, vectorised)
# ---------------------------------------------------------------------------


def affine_chunk_composites_plain(B, U_T, V_T, S_T):
    """K4's plain version: composites ``[K | o]`` (m, R, q, q+1).

    The first step (t = c-1) is applied to ``[I | 0]``; every column then
    evolves on its own, ``X[:, col] <- u * (B (v * X[:, col])) + [col == q] s``.
    """
    m, c, q, R = U_T.shape
    u, v, s = (x.transpose(-1, -2) for x in (U_T, V_T, S_T))  # (m, c, R, q)
    B_b = B[:, None]  # (m, 1, q, q)
    X = B_b * v[:, c - 1, :, None, :] * u[:, c - 1, :, :, None]  # (m, R, p, col)
    X = torch.cat([X, s[:, c - 1, :, :, None]], dim=-1)
    for t in range(c - 2, -1, -1):
        X = u[:, t, :, :, None] * torch.matmul(B_b, v[:, t, :, :, None] * X)
        X[..., q] += s[:, t]
    return X


def affine_reverse_outputs_plain(B, U_T, V_T, S_T, x_right):
    """K5's plain version: the adjoint x (m, c, q, R) at every position of
    every chunk, from each chunk's right-edge value ``x_right`` (m, q, R)."""
    m, c, q, R = U_T.shape
    x = x_right
    outs = [None] * c
    for t in range(c - 1, -1, -1):
        x = S_T[:, t] + U_T[:, t] * torch.matmul(B, V_T[:, t] * x)
        outs[t] = x
    return torch.stack(outs, dim=1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _kernel_shapes(name, B, U_T, V_T, S_T):
    if U_T.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {U_T.device} have no kernel")
    m, c, q, R = U_T.shape
    if not supported(q):
        raise ValueError(f"{name}: the kernel takes 1 <= q <= {KERNEL_MAX_Q}, got q={q}")
    if tuple(B.shape) != (m, q, q):
        raise ValueError(f"{name}: B has shape {tuple(B.shape)}, expected {(m, q, q)}")
    if tuple(V_T.shape) != (m, c, q, R) or tuple(S_T.shape) != (m, c, q, R):
        raise ValueError(f"{name}: U_T {tuple(U_T.shape)}, V_T {tuple(V_T.shape)} and "
                         f"S_T {tuple(S_T.shape)} must have one shape")
    if min(m, c, R) < 1:
        raise ValueError(f"{name}: empty input U_T {tuple(U_T.shape)}")
    return m, c, q, R


def affine_chunk_composites(B, U_T, V_T, S_T):
    """K4: per-chunk composite affine maps of the reverse adjoint
    recursion, (m, R, q, q+1), with ``x_start = comp[..., :q] @ x_end +
    comp[..., q]`` over one chunk.

    Args:
        B: (m, q, q) linear map (A or A^T of the HMM).
        U_T, V_T, S_T: (m, c, q, R) per-step diagonals and sources.
    """
    if U_T.device.type == "cpu":
        return affine_chunk_composites_plain(B, U_T, V_T, S_T)
    name = "affine_chunk_composites"
    m, c, q, R = _kernel_shapes(name, B, U_T, V_T, S_T)
    _check(name, U_T.device, B=B, U_T=U_T, V_T=V_T, S_T=S_T)
    lib = _cuda_build.load("affine")

    def launch(B, U_T, V_T, S_T):
        comp = torch.empty((m, R, q, q + 1), dtype=torch.float32, device=U_T.device)
        device, stream = _launch_args(U_T.device)
        _raise_on(name, lib.hmm_affine_chunk_composites(
            B.data_ptr(), U_T.data_ptr(), V_T.data_ptr(), S_T.data_ptr(),
            comp.data_ptr(), m, c, q, R, device, stream,
        ))
        return comp

    comp = _KernelOnly.apply(launch, B, U_T, V_T, S_T)
    LAUNCHES[name] += 1
    return comp


def affine_reverse_outputs(B, U_T, V_T, S_T, x_right):
    """K5: the adjoint x (m, c, q, R) at every position of every chunk.

    Args:
        B: (m, q, q); U_T, V_T, S_T: (m, c, q, R) as for
            :func:`affine_chunk_composites`.
        x_right: (m, q, R) adjoint entering each chunk's right edge.
    """
    if U_T.device.type == "cpu":
        return affine_reverse_outputs_plain(B, U_T, V_T, S_T, x_right)
    name = "affine_reverse_outputs"
    m, c, q, R = _kernel_shapes(name, B, U_T, V_T, S_T)
    _check(name, U_T.device, B=B, U_T=U_T, V_T=V_T, S_T=S_T, x_right=x_right)
    if tuple(x_right.shape) != (m, q, R):
        raise ValueError(f"{name}: x_right {tuple(x_right.shape)} does not match "
                         f"U_T {tuple(U_T.shape)}")
    lib = _cuda_build.load("affine")

    def launch(B, U_T, V_T, S_T, x_right):
        out = torch.empty((m, c, q, R), dtype=torch.float32, device=U_T.device)
        device, stream = _launch_args(U_T.device)
        _raise_on(name, lib.hmm_affine_reverse_outputs(
            B.data_ptr(), U_T.data_ptr(), V_T.data_ptr(), S_T.data_ptr(),
            x_right.data_ptr(), out.data_ptr(), m, c, q, R, device, stream,
        ))
        return out

    out = _KernelOnly.apply(launch, B, U_T, V_T, S_T, x_right)
    LAUNCHES[name] += 1
    return out
