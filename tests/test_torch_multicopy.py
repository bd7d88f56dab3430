"""Multi-copy gene prediction (q = 1 + 14k states) in the port against the
JAX package on the same numpy inputs and carried-across parameters:
``GenePredMultiTransitions`` and the k-copy emissions, a k = 2 ``HMMLayer``,
the plain versions of the blocked Viterbi kernels K7b/K8b against the
Pallas bodies in interpret mode (bit-equal), the sequential kernel decode
route against JAX's ``_viterbi_seq_pallas``, and K9's plain version and
dispatch against ``pallas_mxu`` (rtol = atol = 2e-4, the JAX suite's).

On the CPU every kernel wrapper takes its plain version; the GPU side is
in ``tests/test_torch_cuda.py``.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hmm_layer_tpu import models as jm
from hmm_layer_tpu.layer import HMMLayer as JaxHMMLayer
from hmm_layer_tpu.models.initializers import make_15_class_emission_kernel as jax_class_kernel
from hmm_layer_tpu.ops import pallas_mxu, pallas_viterbi
from hmm_layer_tpu.ops import recursion as jrec
from hmm_layer_torch import HMMLayer, load_jax_params
from hmm_layer_torch import models as tm
from hmm_layer_torch.ops import cuda_mxu, cuda_viterbi, recursion
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
CODONS = dict(
    start_codons=[("ATG", 1.0)],
    stop_codons=[("TAG", 0.34), ("TAA", 0.33), ("TGA", 0.33)],
    intron_begin_pattern=[("NGT", 0.99), ("NGC", 0.005), ("NAT", 0.005)],
    intron_end_pattern=[("AGN", 0.99), ("ACN", 0.01)],
)


def _inputs(seed, b, L):
    """15 class probabilities and one-hot ACGT(N), (1, b, L, 20)."""
    rng = np.random.default_rng(seed)
    cls = rng.dirichlet(np.ones(15), size=(1, b, L)).astype(np.float32)
    nuc = np.eye(5, dtype=np.float32)[rng.integers(0, 4, size=(1, b, L))]
    return np.concatenate([cls, nuc], axis=-1)


def _emission_kwargs(k, class_kernel):
    return dict(num_copies=k, init=class_kernel(num_copies=k), **CODONS)


# ---------------------------------------------------------------------------
# The k-copy model family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 3])
def test_multi_transitions_match_jax(k):
    jt, tt = jm.GenePredMultiTransitions(k=k), tm.GenePredMultiTransitions(k=k)
    assert tt.num_states == jt.num_states == 1 + 14 * k
    np.testing.assert_array_equal(tt.indices, jt.make_transition_indices())
    assert len(tt.indices) == 1 + 22 * k
    assert tt.get_config() == jt.get_config()
    params = jax.device_get(jt.init_params(jax.random.PRNGKey(k)))  # sd 0.2 noise
    tt.load_state_dict({name: torch.from_numpy(np.array(v)) for name, v in params.items()})
    init_j, A_j = jax.jit(jt.matrices)(params)
    init_t, A_t = tt.matrices()
    np.testing.assert_allclose(init_t.detach().numpy(), np.asarray(init_j), rtol=0, atol=1e-7)
    np.testing.assert_allclose(A_t.detach().numpy(), np.asarray(A_j), rtol=0, atol=1e-7)
    np.testing.assert_allclose(tt.make_A().detach().numpy().sum(-1), 1.0, atol=1e-6)
    again = tm.GenePredMultiTransitions.from_config(tt.get_config())
    assert again.get_config() == tt.get_config() and again.k == k


@pytest.mark.parametrize("k", [2, 3, 4])
def test_multi_copy_emissions_match_jax(k):
    np.testing.assert_array_equal(
        tm.make_15_class_emission_kernel(num_copies=k), jax_class_kernel(num_copies=k)
    )
    je = jm.GenePredEmissions(**_emission_kwargs(k, jax_class_kernel))
    te = tm.GenePredEmissions(**_emission_kwargs(k, tm.make_15_class_emission_kernel))
    params = je.init_params(jax.random.PRNGKey(0), 15)
    np.testing.assert_array_equal(te.emission_kernel.detach().numpy(), np.asarray(params["emission_kernel"]))
    X = _inputs(k, 2, 30)
    ref = np.asarray(jax.jit(je.emissions)(params, jnp.asarray(X)))
    got = te.emissions(torch.from_numpy(X)).detach().numpy()
    assert got.shape == (1, 2, 30, 1 + 14 * k)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def _k2_layers(pf):
    """The JAX k = 2 layer with random params, and the port's layer holding
    the same params."""
    jl = JaxHMMLayer(jm.GenePredMultiTransitions(k=2), jm.GenePredEmissions(**_emission_kwargs(2, jax_class_kernel)),
                     use_prior=False, parallel_factor=pf)
    params = jax.device_get(jl.init_params(jax.random.PRNGKey(0), 15))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.3, size=np.shape(x)).astype(np.float32), params
    )
    tl = HMMLayer(tm.GenePredMultiTransitions(k=2), tm.GenePredEmissions(**_emission_kwargs(2, tm.make_15_class_emission_kernel)),
                  use_prior=False, parallel_factor=pf, device="cpu")
    load_jax_params(tl, params)
    return jl, params, tl


@pytest.mark.parametrize("pf", [4])
def test_k2_layer_matches_jax(pf):
    jl, params, tl = _k2_layers(pf)
    X = _inputs(3, 2, 120)
    with torch.no_grad():
        E_t = tl.emission_probs(X)
        ll_t = tl.log_likelihood(X)
        lg_t = tl.state_posterior_log_probs(X)
    # The JAX layer's posterior and loglik, as one compiled call.
    E_j = jax.jit(jl.emission_probs)(params, jnp.asarray(X))
    init_j, A_j = jl.transitions.matrices(params["transitions"])
    lg_j, ll_j = jax.jit(partial(jrec.posterior, parallel_factor=pf))(init_j, A_j, E_j)
    assert E_t.shape == (1, 2, 120, 29)
    np.testing.assert_allclose(E_t.numpy(), np.asarray(E_j), rtol=1e-5, atol=0)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=2e-4)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=1e-3, atol=2e-3)
    config, jconfig = tl.get_config(), jl.get_config()
    assert config["transitions"] == jconfig["transitions"]
    em, jem = config["emissions"][0]["config"], jconfig["emissions"][0]["config"]
    np.testing.assert_array_equal(em.pop("init"), jem.pop("init"))
    assert em == jem
    rebuilt = HMMLayer.from_config(tl.get_config(), device="cpu")
    assert isinstance(rebuilt.transitions, tm.GenePredMultiTransitions)
    assert rebuilt.get_config()["transitions"] == config["transitions"]


# ---------------------------------------------------------------------------
# K7b / K8b: the plain versions against the blocked Pallas bodies
# ---------------------------------------------------------------------------

# c is prime, so the Pallas bodies run one time step per grid step (TB = 1)
# and interpret quickly.
BLOCKED = [
    pytest.param(1, 17, 13, 3, "zeros", id="q17"),
    pytest.param(2, 29, 13, 5, "zeros", id="q29-m2"),
    pytest.param(1, 64, 11, 2, "zeros", id="q64"),
    pytest.param(1, 20, 7, 2, "flat", id="q20-flat-ties"),
]


def _blocked_inputs(seed, m, q, c, R, kind):
    """log A (m, q, q), log E_T (m, c, q, R), delta0 (m, q, R), last (m, R)."""
    rng = np.random.default_rng(seed)
    if kind == "flat":
        A = np.full((m, q, q), 1.0 / q)
        E = np.full((m, c, q, R), 0.5)
        d0 = np.zeros((m, q, R))
    else:
        A = rng.dirichlet(np.ones(q), size=(m, q))
        A[:, :, q // 2] = 0.0  # structural zeros, as the gene grammar has
        A[:, 1, :] *= rng.uniform(size=q) > 0.5
        A = A / np.maximum(A.sum(-1, keepdims=True), 1e-30)
        E = rng.dirichlet(np.ones(q) * 0.2, size=(m, c, R)).transpose(0, 1, 3, 2)
        d0 = rng.normal(-20.0, 5.0, size=(m, q, R))
    log = lambda x: np.log(np.maximum(x, EPS)).astype(np.float32)  # noqa: E731
    log_E = log(np.ascontiguousarray(E))
    last = rng.integers(0, q, size=(m, R)).astype(np.int32)
    return log(A), log_E, (d0 + log_E[:, 0]).astype(np.float32), last


def _pad_lanes(x, value):
    R = x.shape[-1]
    R_pad = pallas_viterbi.pad_chunk_elements(R)
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, R_pad - R)], constant_values=value)


@pytest.mark.parametrize("m,q,c,R,kind", BLOCKED)
def test_blocked_plain_versions_equal_pallas_bodies(m, q, c, R, kind):
    log_A, log_E_T, delta0, last = _blocked_inputs(q, m, q, c, R, kind)
    t = [torch.from_numpy(x) for x in (log_A, log_E_T, delta0, last)]
    cuda_viterbi.reset_launches()
    deltas = cuda_viterbi.maxplus_deltas(t[0], t[1], t[2])
    states = cuda_viterbi.maxplus_backtrace(t[0], deltas, t[3])
    assert torch.equal(cuda_viterbi.maxplus_decode(*t), states)
    assert cuda_viterbi.LAUNCHES == {name: 0 for name in cuda_viterbi.LAUNCHES}
    for mi in range(m):
        ref_d = pallas_viterbi.maxplus_deltas(
            jnp.asarray(log_A[mi]), jnp.asarray(_pad_lanes(log_E_T[mi], NEG)),
            jnp.asarray(_pad_lanes(delta0[mi], NEG)), interpret=True,
        )
        ref_s = pallas_viterbi.maxplus_backtrace(
            jnp.asarray(log_A[mi]), ref_d, jnp.asarray(_pad_lanes(last[mi], 0)), interpret=True
        )
        np.testing.assert_array_equal(deltas[mi].numpy(), np.asarray(ref_d)[:, :q, :R])
        np.testing.assert_array_equal(states[mi].numpy(), np.asarray(ref_s)[:, :R])
    if kind == "flat":  # every state ties: the lowest index wins everywhere
        assert (states[:, :-1] == 0).all()


SEQ = [
    pytest.param(1, 17, 3, 13, "peaked", id="q17"),
    pytest.param(1, 33, 2, 17, "peaked", id="q33"),
    pytest.param(2, 24, 2, 11, "peaked", id="q24-m2"),
    pytest.param(1, 29, 2, 13, "dense", id="q29-dense"),
    pytest.param(1, 20, 2, 7, "flat", id="q20-flat-ties"),
]


def _seq_inputs(m, q, b, L, kind):
    """init (m, q), A (m, q, q), E (m, b, L, q) float32 of a SEQ case."""
    if kind == "flat":
        return (np.full((m, q), 1.0 / q, np.float32), np.full((m, q, q), 1.0 / q, np.float32),
                np.full((m, b, L, q), 0.5, np.float32))
    rng = np.random.default_rng(q + m)
    parts = [random_hmm(rng, q, L, b=b, peaked=kind == "peaked") for _ in range(m)]
    init, A, E = (np.stack([p[i] for p in parts]) for i in range(3))
    A[:, :, q // 3] = 0.0  # structural zeros
    return init, (A / A.sum(-1, keepdims=True)).astype(np.float32), E


@pytest.mark.parametrize("m,q,b,L,kind", SEQ)
def test_seq_kernel_route_matches_jax_blocked_decode(monkeypatch, m, q, b, L, kind):
    """``_viterbi_seq_kernels`` (its wrappers on their plain versions here)
    gives JAX ``_viterbi_seq_pallas``'s paths (interpret mode) and the
    sequential scan's; on the CPU ``viterbi`` keeps its off-GPU routes."""
    monkeypatch.setattr(pallas_viterbi, "FORCE_INTERPRET", True)
    init, A, E = _seq_inputs(m, q, b, L, kind)
    ref = np.asarray(jax.jit(jrec._viterbi_seq_pallas)(jnp.asarray(init), jnp.asarray(A), jnp.asarray(E)))
    t = [torch.from_numpy(x) for x in (init, A, E)]
    cuda_viterbi.reset_launches()
    got = recursion._viterbi_seq_kernels(*t)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, b, L)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(got, recursion._viterbi_seq(*t))
    assert not recursion._use_seq_viterbi_kernels(t[2])
    assert torch.equal(recursion.viterbi(*t, parallel_factor=1), got)
    assert cuda_viterbi.LAUNCHES == {name: 0 for name in cuda_viterbi.LAUNCHES}
    if kind == "flat":  # every path ties: the lowest state everywhere
        assert (got == 0).all()


def _seq_glue_through_lane_layout(init, A, E):
    """The sequential decode through the (m, c, q, R) wrappers, as the glue
    ran it before the sequence-major entry: E to (m, L, q, b), deltas back,
    states transposed."""
    log_A = torch.log(A.clamp_min(EPS))
    log_E_T = torch.log(E.clamp_min(EPS)).permute(0, 2, 3, 1).contiguous()
    delta0 = (torch.log(init.clamp_min(EPS))[:, :, None] + log_E_T[:, 0]).contiguous()
    deltas = cuda_viterbi.maxplus_deltas(log_A, log_E_T, delta0)
    last = deltas[:, -1].argmax(dim=1).to(torch.int32).contiguous()
    return cuda_viterbi.maxplus_backtrace(log_A, deltas, last).transpose(-1, -2).contiguous()


@pytest.mark.parametrize("m,q,b,L,kind", SEQ)
def test_seq_major_decode_matches_lane_layout_glue_and_jax(monkeypatch, m, q, b, L, kind):
    """The sequence-major route (``maxplus_decode_seq`` on the emissions'
    layout, its wrappers on their plain versions here) equals the old
    route through the (m, c, q, R) wrappers and JAX's
    ``_viterbi_seq_pallas`` in interpret mode; its deltas equal the
    lane-layout plain deltas."""
    monkeypatch.setattr(pallas_viterbi, "FORCE_INTERPRET", True)
    init, A, E = _seq_inputs(m, q, b, L, kind)
    t = [torch.from_numpy(x) for x in (init, A, E)]
    cuda_viterbi.reset_launches()
    got = recursion._viterbi_seq_kernels(*t)
    assert torch.equal(got, _seq_glue_through_lane_layout(*t))
    ref = np.asarray(jax.jit(jrec._viterbi_seq_pallas)(jnp.asarray(init), jnp.asarray(A), jnp.asarray(E)))
    np.testing.assert_array_equal(got.numpy(), ref)
    log_A = torch.log(t[1].clamp_min(EPS))
    log_E = torch.log(t[2].clamp_min(EPS))
    delta0 = (torch.log(t[0].clamp_min(EPS))[:, None, :] + log_E[:, :, 0]).contiguous()
    deltas = cuda_viterbi.maxplus_deltas_seq(log_A, log_E, delta0)
    assert torch.equal(deltas, cuda_viterbi.maxplus_deltas_plain(
        log_A, log_E.permute(0, 2, 3, 1), delta0.transpose(1, 2)).permute(0, 3, 1, 2))
    assert torch.equal(cuda_viterbi.maxplus_decode_seq(log_A, log_E, delta0), got)
    assert cuda_viterbi.LAUNCHES == {name: 0 for name in cuda_viterbi.LAUNCHES}


def test_blocked_wrappers_refuse_other_devices():
    q, R = 29, 4
    log_A = torch.zeros((1, q, q), device="meta")
    log_E_T = torch.zeros((1, 5, q, R), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_viterbi.maxplus_deltas(log_A, log_E_T, torch.zeros((1, q, R), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        cuda_viterbi.maxplus_backtrace(log_A, log_E_T, torch.zeros((1, R), dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# K9: the plain version and the dispatch against pallas_mxu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", [17, 29, 64])
def test_mxu_plain_matches_pallas(q):
    rng = np.random.default_rng(q)
    m, b, L, P = 2, 3, 24, 4
    A = rng.dirichlet(np.ones(q), size=(m, q)).astype(np.float32)
    A[1, :, 2] = 0.0  # structural zeros in the second model
    A[1] /= A[1].sum(-1, keepdims=True)
    E = rng.uniform(0.05, 1.0, size=(m, b * P, L // P, q)).astype(np.float32)
    E_S = np.ascontiguousarray(E.transpose(0, 2, 1, 3))  # (m, c, R, q)
    cuda_mxu.reset_launches()
    got = cuda_mxu.sum_chunk_summaries_mxu(torch.from_numpy(A), torch.from_numpy(E_S), P).numpy()
    assert got.shape == (m, b * P, q, q) and cuda_mxu.LAUNCHES["sum_chunk_summaries_mxu"] == 0
    for mi in range(m):
        ref = np.asarray(pallas_mxu.sum_chunk_summaries_mxu(
            jnp.asarray(A[mi]), jnp.asarray(E_S[mi]), P, interpret=True))
        np.testing.assert_allclose(got[mi], ref, rtol=2e-4, atol=2e-4)


def test_mxu_dispatch_matches_jax_flagged_loglik(monkeypatch):
    """JAX's ``test_flagged_dispatch_loglik`` setup (q = 33, b = 2, L = 24,
    P = 4) with both packages' gates set: the port's K9 glue against JAX's
    gated dispatch, and the port's chunked loglik (the plain summaries on
    the CPU) against JAX's and the sequential one."""
    monkeypatch.setattr(pallas_mxu, "MXU_KERNELS", True)
    monkeypatch.setattr(pallas_viterbi, "FORCE_INTERPRET", True)
    monkeypatch.setattr(cuda_mxu, "MXU_KERNELS", True)
    rng = np.random.default_rng(1)
    q, b, L, P = 33, 2, 24, 4
    init = rng.dirichlet(np.ones(q), size=1).astype(np.float32)
    A = rng.dirichlet(np.ones(q), size=(1, q)).astype(np.float32)
    E = rng.uniform(0.05, 1.0, size=(1, b, L, q)).astype(np.float32)
    j = [jnp.asarray(x) for x in (init, A, E)]
    t = [torch.from_numpy(x) for x in (init, A, E)]
    C_ref = np.asarray(jax.jit(jrec._chunk_summaries_dispatch, static_argnums=2)(j[1], j[2], P))
    np.testing.assert_allclose(recursion._chunk_summaries_mxu(t[1], t[2], P).numpy(), C_ref,
                               rtol=2e-4, atol=2e-4)
    assert not recursion._use_mxu_kernel(t[2])  # CPU tensors: the plain pass
    cuda_mxu.reset_launches()
    ll = recursion.log_likelihood(*t, P).numpy()
    assert cuda_mxu.LAUNCHES["sum_chunk_summaries_mxu"] == 0
    for pf in (P, 1):
        ref = jax.jit(partial(jrec.log_likelihood, parallel_factor=pf))(*j)
        np.testing.assert_allclose(ll, np.asarray(ref), rtol=2e-4)


def test_mxu_gate_is_the_jax_packages_switch():
    assert cuda_mxu.MXU_KERNELS == pallas_mxu.MXU_KERNELS
    assert [cuda_mxu.mxu_supported(q) for q in (16, 17, 128, 129)] == [False, True, True, False]
    A, E_S = torch.zeros((1, 29, 29), device="meta"), torch.zeros((1, 4, 6, 29), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_mxu.sum_chunk_summaries_mxu(A, E_S, 2)
