"""Chunk summaries for 16 < q <= 128 (K9): CUDA wrapper, plain version,
counter and opt-in gate.

Port of ``hmm_layer_tpu/ops/pallas_mxu.py``: the same chunk transfer
operators as K1 (:func:`.cuda_forward.sum_chunk_summaries`) for the state
counts whose q x q carry K1's registers cannot hold, one (rows, q) x (q, q)
product and a row rescale per step. ``csrc/mxu.cu`` computes it with IEEE
float32 FMAs, a group of threads per chunk element, each thread a register
tile of the product.

* :func:`sum_chunk_summaries_mxu` takes the plain version for a tensor on
  the CPU, and for a CUDA tensor launches the kernel or raises;
* :func:`sum_chunk_summaries_mxu_plain` does the kernel's arithmetic step
  for step in torch (its sums run in another order, so the two agree to
  float32 rounding, not bit for bit);
* :data:`LAUNCHES` counts the wrapper's launches.

:data:`MXU_KERNELS` is the gate of ``recursion._chunk_summaries_dispatch``:
opt-in, seeded at import from the same environment variable as the JAX
package's (``HMM_PALLAS_MXU=1``), so that one switch means the same in
both packages. Whether K9 should run by default on an H100 is to be
decided from the measurements in ``PERF.md``.

Layouts (R = b·P chunk elements, lane ``r`` = sequence ``r // P``, chunk
``r % P``; the model axis ``m`` leads): ``A`` (m, q, q) linear; ``E_S``
(m, c, R, q) linear emissions, states last; ``C`` (m, R, q, q) log with
``C[:, r, i, j] = log P(chunk emissions, right border j | left border i)``.
"""

from __future__ import annotations

import os

import torch

from . import _cuda_build
from .cuda_forward import _check, _KernelOnly, _launch_args, _raise_on
from .semiring import EPS

__all__ = [
    "MXU_KERNELS",
    "LAUNCHES",
    "reset_launches",
    "mxu_supported",
    "sum_chunk_summaries_mxu",
    "sum_chunk_summaries_mxu_plain",
]

# Opt-in, as in the JAX package (the same variable).
MXU_KERNELS = os.environ.get("HMM_PALLAS_MXU", "0") == "1"

_TINY = 1e-30  # normaliser and log floor

LAUNCHES = {"sum_chunk_summaries_mxu": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def mxu_supported(q: int) -> bool:
    return 16 < q <= 128


def sum_chunk_summaries_mxu_plain(A, E_S, P: int):
    """K9's plain version: log chunk operators C (m, R, q, q)."""
    m, c, R, q = E_S.shape
    first = (torch.arange(R, device=E_S.device) % P == 0)[None, :, None, None]
    eye = torch.eye(q, dtype=E_S.dtype, device=E_S.device)
    e = torch.clamp_min(E_S, EPS)[..., None, :]  # (m, c, R, 1, q)
    R0 = torch.where(first, eye, A[:, None])  # (m, R, i, j)
    s = torch.clamp_min(R0, 0.0) * e[:, 0]
    z = torch.clamp_min(s.sum(-1, keepdim=True), _TINY)
    M, LL = s / z, torch.log(z)
    A_b = A[:, None]
    for t in range(1, c):
        s = torch.clamp_min(torch.matmul(M, A_b), EPS) * e[:, t]
        z = torch.clamp_min(s.sum(-1, keepdim=True), _TINY)
        M, LL = s / z, LL + torch.log(z)
    return torch.log(torch.clamp_min(M, _TINY)) + LL


def sum_chunk_summaries_mxu(A, E_S, P: int):
    """K9: log chunk transfer operators C (m, R, q, q) for 16 < q <= 128.

    Args:
        A: (m, q, q) linear transition matrices.
        E_S: (m, c, R, q) linear emissions (clamped to >= EPS inside).
        P: chunks per sequence (lane ``r`` starts its sequence when
            ``r % P == 0``: identity first step instead of A's rows).
    """
    if E_S.device.type == "cpu":
        return sum_chunk_summaries_mxu_plain(A, E_S, P)
    name = "sum_chunk_summaries_mxu"
    if E_S.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {E_S.device} have no kernel")
    m, c, R, q = E_S.shape
    if not mxu_supported(q):
        raise ValueError(f"{name}: the kernel takes 16 < q <= 128, got q={q}")
    if tuple(A.shape) != (m, q, q):
        raise ValueError(f"{name}: A has shape {tuple(A.shape)}, expected {(m, q, q)}")
    if min(m, c, R) < 1:
        raise ValueError(f"{name}: empty input E_S {tuple(E_S.shape)}")
    _check(name, E_S.device, A=A, E_S=E_S)
    lib = _cuda_build.load("mxu")

    def launch(A, E_S):
        C = torch.empty((m, R, q, q), dtype=torch.float32, device=E_S.device)
        device, stream = _launch_args(E_S.device)
        _raise_on(name, lib.hmm_sum_chunk_summaries_mxu(
            A.data_ptr(), E_S.data_ptr(), C.data_ptr(),
            m, c, q, R, int(P), device, stream,
        ))
        return C

    C = _KernelOnly.apply(launch, A, E_S)
    LAUNCHES[name] += 1
    return C
