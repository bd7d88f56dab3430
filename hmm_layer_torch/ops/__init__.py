"""Recursions, semiring primitives, k-mers and the CUDA kernels of the port.

Submodules: :mod:`.semiring`, :mod:`.kmer`, :mod:`.recursion`,
:mod:`.cuda_forward` (kernels K1–K3), :mod:`.cuda_adjoint` (kernels K4–K5),
:mod:`.cuda_viterbi` (kernels K6–K8) and :mod:`._cuda_build` (their build).
"""
