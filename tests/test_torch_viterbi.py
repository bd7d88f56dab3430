"""The port's Viterbi decode against the JAX package on the same numpy
inputs: the plain versions of kernels K6–K8 (hmm_layer_torch.ops.
cuda_viterbi) against the Pallas kernels in interpret mode, the port's
``viterbi`` (sequential, chunked plain route, chunked kernel route) against
JAX's, and ``HMMLayer.viterbi`` with converted JAX parameters.

On the CPU the kernel wrappers take their plain versions, which do the
kernels' arithmetic in the kernels' order: C_T and deltas are expected to
be bit-equal to the Pallas kernels (compared within rtol 1e-6, atol 1e-4),
states exactly equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hmm_layer_tpu.layer import HMMLayer as JaxHMMLayer
from hmm_layer_tpu.models import GenePredEmissions as JaxEmissions
from hmm_layer_tpu.models import GenePredTransitions as JaxTransitions
from hmm_layer_tpu.ops import pallas_viterbi
from hmm_layer_tpu.ops import recursion as jrec
from hmm_layer_torch import HMMLayer, load_jax_params
from hmm_layer_torch.models import GenePredEmissions, GenePredTransitions
from hmm_layer_torch.ops import cuda_viterbi, recursion
from hmm_layer_torch.ops.semiring import maxargmatvec, maxmatmul
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


NEG = -1e30
EPS = 1e-16
Q = 15
CODONS = dict(
    start_codons=[("ATG", 1.0)],
    stop_codons=[("TAG", 0.34), ("TAA", 0.33), ("TGA", 0.33)],
    intron_begin_pattern=[("NGT", 0.99), ("NGC", 0.005), ("NAT", 0.005)],
    intron_end_pattern=[("AGN", 0.99), ("ACN", 0.01)],
)


def _gene_pred_hmm():
    """The real gene-pred init and A: a masked softmax with exact zeros."""
    t = JaxTransitions()
    init, A = t.matrices(t.init_params(jax.random.PRNGKey(0)))
    return np.array(init[0]), np.array(A[0])


def _log(x):
    return np.log(np.maximum(x, EPS)).astype(np.float32)


def _kernel_inputs(seed, m, c, R, gene_pred, peaked=False):
    """log A (m, q, q) and log E_T (m, c, q, R) as numpy float32."""
    rng = np.random.default_rng(seed)
    if gene_pred:
        As = [_gene_pred_hmm()[1]] * m
    else:
        As = [random_hmm(rng, Q, 1)[1] for _ in range(m)]
    if peaked:
        E_T = rng.dirichlet(np.ones(Q) * 0.1, size=(m, c, R)).transpose(0, 1, 3, 2)
    else:
        E_T = rng.uniform(0.05, 1.0, size=(m, c, Q, R))
    return _log(np.stack(As)), _log(np.ascontiguousarray(E_T))


def _pad_lanes(x, R_pad, value):
    pad = [(0, 0)] * (x.ndim - 1) + [(0, R_pad - x.shape[-1])]
    return np.pad(x, pad, constant_values=value)


CASES = [
    pytest.param(1, 24, 24, 3, False, False, id="m1-dirichlet"),
    pytest.param(2, 20, 24, 4, False, True, id="m2-dirichlet-peaked"),
    pytest.param(1, 24, 24, 3, True, False, id="m1-genepred"),
    pytest.param(2, 17, 21, 7, True, True, id="m2-genepred-ragged-peaked"),
]


@pytest.mark.parametrize("m,c,R,P,gene_pred,peaked", CASES)
def test_maxplus_chunk_summaries_matches_pallas(m, c, R, P, gene_pred, peaked):
    log_A, log_E_T = _kernel_inputs(0, m, c, R, gene_pred, peaked)
    R_pad = pallas_viterbi.pad_chunk_elements(R)
    got = cuda_viterbi.maxplus_chunk_summaries(
        torch.from_numpy(log_A), torch.from_numpy(log_E_T), P
    ).numpy()
    for mi in range(m):
        ref = np.asarray(
            pallas_viterbi.maxplus_chunk_summaries(
                jnp.asarray(log_A[mi]), jnp.asarray(_pad_lanes(log_E_T[mi], R_pad, NEG)),
                P, interpret=True,
            )
        )[:R]
        np.testing.assert_allclose(got[mi], ref, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("m,c,R,P,gene_pred,peaked", CASES)
def test_maxplus_deltas_and_backtrace_match_pallas(m, c, R, P, gene_pred, peaked):
    log_A, log_E_T = _kernel_inputs(1, m, c, R, gene_pred, peaked)
    rng = np.random.default_rng(2)
    delta0 = (rng.normal(-20.0, 5.0, size=(m, Q, R)) + log_E_T[:, 0]).astype(np.float32)
    last = rng.integers(0, Q, size=(m, R)).astype(np.int32)
    R_pad = pallas_viterbi.pad_chunk_elements(R)
    t = [torch.from_numpy(x) for x in (log_A, log_E_T, delta0, last)]
    deltas = cuda_viterbi.maxplus_deltas(t[0], t[1], t[2])
    states = cuda_viterbi.maxplus_backtrace(t[0], deltas, t[3])
    decoded = cuda_viterbi.maxplus_decode(*t)
    assert states.dtype == torch.int32 and tuple(states.shape) == (m, c, R)
    assert torch.equal(decoded, states)
    for mi in range(m):
        ref_d = pallas_viterbi.maxplus_deltas(
            jnp.asarray(log_A[mi]), jnp.asarray(_pad_lanes(log_E_T[mi], R_pad, NEG)),
            jnp.asarray(_pad_lanes(delta0[mi], R_pad, NEG)), interpret=True,
        )
        ref_s = pallas_viterbi.maxplus_backtrace(
            jnp.asarray(log_A[mi]), ref_d, jnp.asarray(_pad_lanes(last[mi], R_pad, 0)),
            interpret=True,
        )
        np.testing.assert_allclose(
            deltas[mi].numpy(), np.asarray(ref_d)[:, :Q, :R], rtol=1e-6, atol=1e-4
        )
        np.testing.assert_array_equal(states[mi].numpy(), np.asarray(ref_s)[:, :R])


def test_backtrace_takes_the_lowest_tied_state():
    log_A = torch.zeros((1, 3, 3))
    deltas = torch.zeros((1, 2, 3, 1))
    deltas[0, 0, 1:, 0] = 5.0  # states 1 and 2 tie at t=0
    states = cuda_viterbi.maxplus_backtrace(log_A, deltas, torch.tensor([[2]], dtype=torch.int32))
    assert states[0, :, 0].tolist() == [1, 2]


# ---------------------------------------------------------------------------
# semiring primitives
# ---------------------------------------------------------------------------


def test_maxmatmul_and_maxargmatvec_match_jax():
    from hmm_layer_tpu.ops import semiring as jsr

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 5)).astype(np.float32)
    y = rng.normal(size=(2, 5, 3)).astype(np.float32)
    v = np.round(rng.normal(size=(2, 5)), 1).astype(np.float32)  # ties
    M = np.round(rng.normal(size=(2, 5, 6)), 1).astype(np.float32)
    np.testing.assert_array_equal(
        maxmatmul(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jsr.maxmatmul(jnp.asarray(x), jnp.asarray(y))),
    )
    s_t, a_t = maxargmatvec(torch.from_numpy(v), torch.from_numpy(M))
    s_j, a_j = jsr.maxargmatvec(jnp.asarray(v), jnp.asarray(M))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))


# ---------------------------------------------------------------------------
# recursion.viterbi against JAX
# ---------------------------------------------------------------------------


def _path_score64(init, A, E, path):
    """float64 log score of each path (m, b), and whether each uses only
    transitions of A > 0."""
    init, A, E = (np.asarray(x, np.float64) for x in (init, A, E))
    path = np.asarray(path)
    m, b, L = path.shape
    mi = np.arange(m)[:, None, None]
    bi = np.arange(b)[None, :, None]
    ti = np.arange(L)[None, None, :]
    lA = np.log(np.maximum(A, EPS))
    score = np.log(np.maximum(init[np.arange(m)[:, None], path[..., 0]], EPS))
    score = score + np.log(np.maximum(E[mi, bi, ti, path], EPS)).sum(-1)
    prev, nxt = path[..., :-1], path[..., 1:]
    score = score + lA[mi, prev, nxt].sum(-1)
    used = A[mi, prev, nxt] > 0
    return score, used


def _hmm(seed, m, q, b, L, peaked):
    rng = np.random.default_rng(seed)
    parts = [random_hmm(rng, q, L, b=b, peaked=peaked) for _ in range(m)]
    init = np.stack([p[0] for p in parts])
    A = np.stack([p[1] for p in parts])
    E = np.stack([p[2] for p in parts])
    return init, A, E


def _both(init, A, E, pf):
    ref = np.asarray(jrec.viterbi(jnp.asarray(init), jnp.asarray(A), jnp.asarray(E), parallel_factor=pf))
    got = recursion.viterbi(*map(torch.from_numpy, (init, A, E)), parallel_factor=pf)
    assert got.dtype == torch.int32 and tuple(got.shape) == E.shape[:3]
    return got.numpy(), ref


@pytest.mark.parametrize("force_interpret", [False, True], ids=["xla", "pallas-interpret"])
@pytest.mark.parametrize(
    "m,q,b,L,pf",
    [
        pytest.param(1, 5, 3, 88, 1, id="q5-seq"),
        pytest.param(2, 5, 3, 88, 8, id="q5-m2-P8"),
        pytest.param(1, 15, 2, 132, 11, id="q15-P11"),
        pytest.param(2, 15, 2, 96, 8, id="q15-m2-P8"),
    ],
)
def test_viterbi_matches_jax_peaked(monkeypatch, force_interpret, m, q, b, L, pf):
    monkeypatch.setattr(pallas_viterbi, "FORCE_INTERPRET", force_interpret)
    init, A, E = _hmm(4, m, q, b, L, peaked=True)
    got, ref = _both(init, A, E, pf)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("pf", [1, 4])
def test_viterbi_matches_jax_q33(pf):
    """q = 33 on the CPU: the port's sequential and plain chunked routes
    against JAX's off-TPU routes (the blocked K7b/K8b route, taken on CUDA,
    is held in tests/test_torch_multicopy.py and tests/test_torch_cuda.py)."""
    init, A, E = _hmm(5, 1, 33, 2, 64, peaked=True)
    got, ref = _both(init, A, E, pf)
    np.testing.assert_array_equal(got, ref)


def test_viterbi_q33_matches_jax_blocked_kernels(monkeypatch):
    """JAX's blocked sequential Pallas decode (interpret mode) gives the same
    path as the port's sequential scan at q = 33."""
    monkeypatch.setattr(pallas_viterbi, "FORCE_INTERPRET", True)
    init, A, E = _hmm(6, 1, 33, 2, 48, peaked=True)
    got, ref = _both(init, A, E, 1)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("force_interpret", [False, True], ids=["xla", "pallas-interpret"])
@pytest.mark.parametrize("pf", [1, 8, 11])
def test_viterbi_gene_pred_matches_jax_score(monkeypatch, force_interpret, pf):
    """Gene-pred shapes with dense emissions: float32 ties may split, so the
    port's path must avoid every A = 0 transition JAX's path avoids and
    score the same in float64 within rel 1e-6."""
    monkeypatch.setattr(pallas_viterbi, "FORCE_INTERPRET", force_interpret)
    init, A = _gene_pred_hmm()
    rng = np.random.default_rng(7)
    b, L = 3, 616
    E = rng.uniform(0.05, 1.0, size=(1, b, L, Q)).astype(np.float32)
    got, ref = _both(init[None], A[None], E, pf)
    s_got, used_got = _path_score64(init[None], A[None], E, got)
    s_ref, used_ref = _path_score64(init[None], A[None], E, ref)
    assert used_got[used_ref.all(-1)].all()
    np.testing.assert_allclose(s_got, s_ref, rtol=1e-6)


def test_viterbi_prefix_fold_above_64_chunks():
    """P > 64 takes the log-depth prefix product instead of the vector fold;
    the path scores the same as the sequential decode."""
    init, A, E = _hmm(8, 1, 5, 2, 260, peaked=False)
    t = [torch.from_numpy(x) for x in (init, A, E)]
    seq = recursion.viterbi(*t, parallel_factor=1).numpy()
    chunked = recursion.viterbi(*t, parallel_factor=65).numpy()
    np.testing.assert_allclose(
        _path_score64(init, A, E, chunked)[0], _path_score64(init, A, E, seq)[0], rtol=1e-6
    )


def test_kernel_route_equals_plain_route():
    """The kernel route's glue (log layout, K6, fold, chunk-level backtrace,
    conditional starts, K7 + K8, layout back) gives the plain route's paths;
    on the CPU the wrappers run their plain versions."""
    init, A = _gene_pred_hmm()
    rng = np.random.default_rng(9)
    E = rng.dirichlet(np.ones(Q) * 0.3, size=(2, 3, 264)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (np.stack([init] * 2), np.stack([A] * 2), E)]
    cuda_viterbi.reset_launches()
    for P in (1, 8, 11):
        kern = recursion._viterbi_chunked_kernels(*t, P)
        plain = recursion._viterbi_chunked_plain(*t, P)
        assert kern.dtype == torch.int32
        assert torch.equal(kern, plain), P
    assert cuda_viterbi.LAUNCHES == {name: 0 for name in cuda_viterbi.LAUNCHES}


def test_viterbi_has_no_gradient_graph():
    init, A, E = (torch.from_numpy(x).requires_grad_() for x in _hmm(10, 1, 5, 1, 40, False))
    assert not recursion.viterbi(init, A, E, parallel_factor=4).requires_grad


def test_kernel_wrapper_refuses_other_devices():
    log_A = torch.zeros((1, Q, Q), device="meta")
    log_E_T = torch.zeros((1, 4, Q, 6), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_viterbi.maxplus_chunk_summaries(log_A, log_E_T, 2)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_viterbi.maxplus_deltas(log_A, log_E_T, torch.zeros((1, Q, 6), device="meta"))


def test_kernel_backward_raises():
    x = torch.ones(3, requires_grad=True)
    y = cuda_viterbi._NoGradient.apply(lambda t: t * 2.0, x)
    with pytest.raises(NotImplementedError, match="no gradient"):
        y.sum().backward()


# ---------------------------------------------------------------------------
# HMMLayer.viterbi against the JAX layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hints", [False, True])
@pytest.mark.parametrize("pf", [1, 8])
def test_layer_viterbi_matches_jax(pf, hints):
    jl = JaxHMMLayer(JaxTransitions(), JaxEmissions(**CODONS), use_prior=False, parallel_factor=pf)
    params = jax.device_get(jl.init_params(jax.random.PRNGKey(0), 15))
    rng = np.random.default_rng(11)
    params = jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.5, size=np.shape(x)).astype(np.float32), params
    )
    tl = HMMLayer(GenePredTransitions(), GenePredEmissions(**CODONS), use_prior=False,
                  parallel_factor=pf, device="cpu")
    load_jax_params(tl, params)
    b, L = 2, 256
    cls = rng.dirichlet(np.ones(15) * 0.2, size=(1, b, L)).astype(np.float32)
    nuc = np.eye(5, dtype=np.float32)[rng.integers(0, 4, size=(1, b, L))]
    X = np.concatenate([cls, nuc], axis=-1)
    end_hints = None
    if hints:
        end_hints = rng.uniform(0.1, 1, size=(1, b, 2, 15)).astype(np.float32)
    ref = np.asarray(jl.viterbi(params, jnp.asarray(X),
                                end_hints=None if end_hints is None else jnp.asarray(end_hints)))
    got = tl.viterbi(X, end_hints=end_hints).numpy()
    assert got.dtype == np.int32
    init, A = (t.detach().numpy() for t in tl.transitions.matrices())
    E = tl.emission_probs(X, end_hints=end_hints).detach().numpy()
    s_got, used_got = _path_score64(init, A, E, got)
    s_ref, used_ref = _path_score64(init, A, E, ref)
    assert used_got[used_ref.all(-1)].all()
    np.testing.assert_allclose(s_got, s_ref, rtol=1e-6)


def test_layer_auto_parallel_factor_for_viterbi():
    tl = HMMLayer(GenePredTransitions(), GenePredEmissions(**CODONS), use_prior=False,
                  parallel_factor="auto", device="cpu")
    E = torch.zeros((1, 2, 9999, 15))
    assert tl._pf(E, for_viterbi=True) == 33
    assert tl._pf(torch.zeros((1, 2, 600, 33)), for_viterbi=True) == 1
