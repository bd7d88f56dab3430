"""Kernels K1–K3 of the port (hmm_layer_torch.ops.cuda_forward) against the
JAX package's Pallas kernels (hmm_layer_tpu.ops.pallas_forward, interpret
mode), on the same numpy inputs.

On the CPU the wrappers take their plain versions, which follow the Pallas
bodies' arithmetic; tests/test_torch_cuda.py holds the CUDA kernels against
those plain versions on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hmm_layer_tpu.ops import pallas_forward, pallas_viterbi
from hmm_layer_tpu.ops import recursion as jrec
from hmm_layer_tpu.models import GenePredTransitions as JaxGenePredTransitions
from hmm_layer_torch.ops import cuda_forward, recursion
from oracle import random_hmm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tiny CPU ops: the test workers
    share the cores, and per-op thread pools contending for them made
    these tests many times slower than one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL, ATOL = 1e-5, 1e-4
Q = 15


def _gene_pred_A():
    """The real gene-pred A: a masked softmax with exact zeros."""
    t = JaxGenePredTransitions()
    init, A = t.matrices(t.init_params(jax.random.PRNGKey(0)))
    return np.array(init[0]), np.array(A[0])


def _inputs(seed, m, c, R, P, gene_pred):
    """A (m, q, q) and clamped E_T (m, c, q, R) as numpy float32."""
    rng = np.random.default_rng(seed)
    As = []
    for _ in range(m):
        if gene_pred:
            As.append(_gene_pred_A()[1])
        else:
            As.append(random_hmm(rng, Q, 1)[1])
    E_T = rng.uniform(0.05, 1.0, size=(m, c, Q, R)).astype(np.float32)
    return np.stack(As).astype(np.float32), E_T


def _pad_lanes(x, R_pad, value):
    pad = [(0, 0)] * (x.ndim - 1) + [(0, R_pad - x.shape[-1])]
    return np.pad(x, pad, constant_values=value)


def _masked(C):
    """Entries within 30 nats of their row max: the EPS-floor entries of
    impossible border pairs legitimately differ between formulations."""
    return C >= C.max(axis=-1, keepdims=True) - 30.0


CASES = [
    pytest.param(1, 32, 24, 3, False, id="m1-dirichlet"),
    pytest.param(2, 20, 24, 4, False, id="m2-dirichlet"),
    pytest.param(1, 32, 24, 3, True, id="m1-genepred"),
    pytest.param(2, 17, 21, 7, True, id="m2-genepred-ragged"),
]


@pytest.mark.parametrize("m,c,R,P,gene_pred", CASES)
def test_sum_chunk_summaries_matches_pallas(m, c, R, P, gene_pred):
    A, E_T = _inputs(0, m, c, R, P, gene_pred)
    R_pad = pallas_viterbi.pad_chunk_elements(R)
    for mi in range(m):
        ref = np.asarray(
            pallas_forward.sum_chunk_summaries(
                jnp.asarray(A[mi]), jnp.asarray(_pad_lanes(E_T[mi], R_pad, 1.0)),
                P, interpret=True,
            )
        )[:R]
        got = cuda_forward.sum_chunk_summaries(
            torch.from_numpy(A), torch.from_numpy(E_T), P
        )[mi].numpy()
        mask = _masked(ref)
        np.testing.assert_allclose(got[mask], ref[mask], rtol=RTOL, atol=ATOL)


def _starts(rng, m, R):
    r0 = rng.dirichlet(np.ones(Q), size=(m, R)).astype(np.float32)  # (m, R, q)
    ll0 = rng.normal(-50.0, 10.0, size=(m, R)).astype(np.float32)
    return np.ascontiguousarray(np.swapaxes(r0, -1, -2)), ll0


@pytest.mark.parametrize("m,c,R,P,gene_pred", CASES)
def test_sum_fwd_outputs_matches_pallas(m, c, R, P, gene_pred):
    A, E_T = _inputs(1, m, c, R, P, gene_pred)
    r0, ll0 = _starts(np.random.default_rng(2), m, R)
    R_pad = pallas_viterbi.pad_chunk_elements(R)
    got = cuda_forward.sum_fwd_outputs(*map(torch.from_numpy, (A, E_T, r0, ll0)))
    for mi in range(m):
        ref = np.asarray(
            pallas_forward.sum_fwd_outputs(
                jnp.asarray(A[mi]),
                jnp.asarray(_pad_lanes(E_T[mi], R_pad, 1.0)),
                jnp.asarray(_pad_lanes(r0[mi], R_pad, 1.0)),
                jnp.asarray(_pad_lanes(ll0[mi], R_pad, 0.0)),
                interpret=True,
            )
        )[:, :Q, :R]
        np.testing.assert_allclose(got[mi].numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m,c,R,P,gene_pred", CASES)
def test_beta_bwd_outputs_matches_pallas(m, c, R, P, gene_pred):
    A, E_T = _inputs(3, m, c, R, P, gene_pred)
    rng = np.random.default_rng(4)
    b0 = rng.uniform(0.01, 1.0, size=(m, Q, R)).astype(np.float32)
    b0 /= b0.max(axis=1, keepdims=True)  # max-scaled, as the caller builds it
    ll0 = rng.normal(-50.0, 10.0, size=(m, R)).astype(np.float32)
    R_pad = pallas_viterbi.pad_chunk_elements(R)
    got = cuda_forward.beta_bwd_outputs(*map(torch.from_numpy, (A, E_T, b0, ll0)))
    for mi in range(m):
        ref = np.asarray(
            pallas_forward.beta_bwd_outputs(
                jnp.asarray(A[mi]),
                jnp.asarray(_pad_lanes(E_T[mi], R_pad, 1.0)),
                jnp.asarray(_pad_lanes(b0[mi], R_pad, 1.0)),
                jnp.asarray(_pad_lanes(ll0[mi], R_pad, 0.0)),
                interpret=True,
            )
        )[:, :Q, :R]
        np.testing.assert_allclose(got[mi].numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("no_loglik", [False, True])
def test_kernel_route_matches_jax_pallas_route(monkeypatch, no_loglik):
    """The port's kernel route (layouts, boundary glue, combine) against the
    JAX Pallas route, both on the real gene-pred A; on the CPU the port's
    wrappers run their plain versions."""
    monkeypatch.setattr(pallas_viterbi, "FORCE_INTERPRET", True)
    init, A = _gene_pred_A()
    rng = np.random.default_rng(5)
    b, L, P = 2, 48, 4
    E = rng.uniform(0.05, 1.0, size=(1, b, L, Q)).astype(np.float32)
    lg_j, ll_j, la_j = jrec._posterior_chunked_pallas(
        jnp.asarray(init[None]), jnp.asarray(A[None]), jnp.asarray(E), P, no_loglik
    )
    lg_t, ll_t, la_t = recursion._posterior_chunked_kernels(
        torch.from_numpy(init[None]), torch.from_numpy(A[None]),
        torch.from_numpy(E), P, no_loglik,
    )
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=2e-4)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(la_t.numpy(), np.asarray(la_j), rtol=1e-3, atol=2e-3)


def test_wrappers_take_plain_version_on_cpu():
    A, E_T = _inputs(6, 1, 8, 10, 2, True)
    A_t, E_t = torch.from_numpy(A), torch.from_numpy(E_T)
    cuda_forward.reset_launches()
    torch.testing.assert_close(
        cuda_forward.sum_chunk_summaries(A_t, E_t, 2),
        cuda_forward.sum_chunk_summaries_plain(A_t, E_t, 2),
        rtol=0, atol=0,
    )
    assert cuda_forward.LAUNCHES == {name: 0 for name in cuda_forward.LAUNCHES}


def test_wrapper_refuses_other_devices():
    A = torch.zeros((1, Q, Q), device="meta")
    E_T = torch.zeros((1, 4, Q, 6), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_forward.sum_chunk_summaries(A, E_T, 2)


def test_kernel_backward_raises():
    x = torch.ones(3, requires_grad=True)
    y = cuda_forward._KernelOnly.apply(lambda t: t * 2.0, x)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        y.sum().backward()
