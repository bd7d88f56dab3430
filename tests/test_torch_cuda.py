"""The port's CUDA kernels K1–K9, K7c and K8c on the card (K2c and K3c:
``tests/test_torch_loglik_wide.py``): each against its plain
PyTorch version, the layer's kernel routes (posterior, Viterbi, the
gradients of the training objectives, the multi-copy decode and the gated
K9 log-likelihood) and the auxiliary inference on them (path sampling,
EM, the streaming filter, chunked forward/backward) against their plain
routes, the launch counts and the refusals; and the sparse edge-list
engine (no kernel of its own) on the card against the same calls on the
CPU, its refusal of CUDA edge indices and its determinism; and
``cli.decode_contig``'s window batches cut on the card against batches
built on the host.

Every test here needs a CUDA device and skips where there is none. The file
imports no JAX, so it runs where JAX is not installed:
``python -m pytest --noconftest -q tests/test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest
import torch

from hmm_layer_torch import HMMLayer, streaming
from hmm_layer_torch.models import (
    GenePredEmissions,
    GenePredMultiTransitions,
    GenePredTransitions,
    make_15_class_emission_kernel,
)
from hmm_layer_torch.ops import cuda_adjoint, cuda_forward, cuda_mxu, cuda_viterbi, em, recursion
from oracle import random_hmm, stitched_track_np

pytestmark = pytest.mark.gpu

Q = 15
CODONS = dict(
    start_codons=[("ATG", 1.0)],
    stop_codons=[("TAG", 0.34), ("TAA", 0.33), ("TGA", 0.33)],
    intron_begin_pattern=[("NGT", 0.99), ("NGC", 0.005), ("NAT", 0.005)],
    intron_end_pattern=[("AGN", 0.99), ("ACN", 0.01)],
)
CASES = [
    pytest.param(1, 32, 24, 3, False, id="m1-dirichlet"),
    pytest.param(2, 20, 300, 4, False, id="m2-dirichlet"),
    pytest.param(1, 303, 1056, 33, True, id="m1-genepred-flagship"),
    pytest.param(2, 17, 21, 7, True, id="m2-genepred-ragged"),
]
# The edges of the blocks and tiles of K1–K3 (in the build: K1 4 elements of
# 16 row threads a block, tiles of 32 steps; K2 8 elements of a 16-lane group
# a block, tiles of 16 steps; K3 8 elements a block, tiles of 32 steps walked
# from the end): c = 1 and c around the tiles, R not a multiple of 4 or 8,
# P = 1 (every element a first chunk) and first chunks that straddle block
# borders, q from 1 to the 16 lanes, m = 3, and a state whose emission is 0
# everywhere (log alpha at the TINY floor). Fields: m, c, R, P, gene_pred,
# q, dead state.
SUM_CASES = [pytest.param(*p.values, Q, False, id=p.id) for p in CASES] + [
    pytest.param(1, 1, 7, 1, False, 15, False, id="c1-R7"),
    pytest.param(3, 2, 9, 3, False, 3, False, id="m3-c2-R9-q3"),
    pytest.param(1, 15, 1, 1, False, 16, False, id="c15-R1-q16"),
    pytest.param(3, 17, 1057, 7, False, 1, False, id="m3-c17-R1057-q1"),
    pytest.param(1, 33, 9, 3, False, 16, True, id="c33-R9-q16-dead"),
    pytest.param(1, 15, 1057, 7, False, 15, True, id="c15-R1057-dead"),
    pytest.param(1, 32, 13, 1, False, 15, False, id="c32-R13-P1"),
    pytest.param(1, 16, 25, 5, False, 16, False, id="c16-R25-P5-q16"),
    pytest.param(3, 31, 40, 8, False, 15, False, id="m3-c31-R40-P8"),
    pytest.param(1, 65, 17, 17, False, 1, False, id="c65-R17-P17-q1"),
    pytest.param(2, 64, 1057, 7, False, 15, True, id="m2-c64-R1057-dead"),
    pytest.param(1, 97, 22, 11, True, 15, False, id="c97-R22-genepred"),
]


def _f32_log_bound(ll, steps):
    """8 standard deviations of ``steps`` float32 roundings (half a spacing
    at |loglik|), for the forward and the backward log-scale together."""
    spacing = 2.0 ** (math.floor(math.log2(float(ll.abs().max()))) - 23)
    return 8.0 * spacing * math.sqrt(2 * steps / 12)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, m, c, R, gene_pred, device, q=Q, dead=False):
    rng = np.random.default_rng(seed)
    if gene_pred:
        A = GenePredTransitions().make_A().detach()[0].numpy()
        A = np.stack([A] * m)
    else:
        A = np.stack([random_hmm(rng, q, 1)[1] for _ in range(m)])
    E_T = rng.uniform(0.05, 1.0, size=(m, c, q, R)).astype(np.float32)
    if dead:
        E_T[:, :, q // 2] = 0.0
    r0 = rng.dirichlet(np.ones(q), size=(m, R)).astype(np.float32).transpose(0, 2, 1)
    ll0 = rng.normal(-50.0, 10.0, size=(m, R)).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device) for x in (A, E_T, r0, ll0)]


@pytest.mark.parametrize("m,c,R,P,gene_pred,q,dead", SUM_CASES)
def test_kernels_match_plain(cuda, m, c, R, P, gene_pred, q, dead):
    A, E_T, r0, ll0 = _inputs(0, m, c, R, gene_pred, cuda, q, dead)
    C = cuda_forward.sum_chunk_summaries(A, E_T, P)
    C_ref = cuda_forward.sum_chunk_summaries_plain(A, E_T, P)
    mask = C_ref >= C_ref.amax(-1, keepdim=True) - 30.0
    torch.testing.assert_close(C[mask], C_ref[mask], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(
        cuda_forward.sum_fwd_outputs(A, E_T, r0, ll0),
        cuda_forward.sum_fwd_outputs_plain(A, E_T, r0, ll0),
        rtol=1e-5, atol=1e-2,
    )
    beta0 = r0 / r0.amax(1, keepdim=True)
    torch.testing.assert_close(
        cuda_forward.beta_bwd_outputs(A, E_T, beta0, ll0),
        cuda_forward.beta_bwd_outputs_plain(A, E_T, beta0, ll0),
        rtol=1e-5, atol=1e-2,
    )
    torch.cuda.synchronize()


@pytest.mark.parametrize("pf", [8, "auto"])
def test_layer_kernel_route_matches_plain_route(cuda, pf):
    layer = HMMLayer(GenePredTransitions(), GenePredEmissions(**CODONS), use_prior=False,
                     parallel_factor=pf)
    rng = np.random.default_rng(1)
    b, L = 3, 1200
    cls = rng.dirichlet(np.ones(15), size=(1, b, L)).astype(np.float32)
    nuc = np.eye(5, dtype=np.float32)[rng.integers(0, 4, size=(1, b, L))]
    X = np.concatenate([cls, nuc], axis=-1)
    with torch.inference_mode():
        cuda_forward.reset_launches()
        lg = layer.state_posterior_log_probs(X)
        ll = layer.log_likelihood(X)
        assert cuda_forward.LAUNCHES == {
            "sum_chunk_summaries": 2, "sum_fwd_outputs": 1, "beta_bwd_outputs": 1,
            "sum_forward_wide": 0, "sum_backward_wide": 0,
        }
        init, A = layer.transitions.matrices()
        E = layer.emission_probs(X)
        P = layer._pf(E)
        lg_p, ll_p, _ = recursion._posterior_chunked_plain(init, A, E, P, False)
        lg_s, ll_s = recursion.posterior(init, A, E, 1)
    torch.testing.assert_close(lg.exp(), lg_p.exp(), rtol=0, atol=1e-3)
    torch.testing.assert_close(ll, ll_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(ll, ll_s, rtol=2e-4, atol=0)
    # Against the sequential engine where the posterior has mass: both carry
    # float32 log-scales that round at |loglik| ~ 1.3e4 for c and L steps.
    mass = lg_s.exp() >= 1e-3
    bound = _f32_log_bound(ll_s, L // P) + _f32_log_bound(ll_s, L)
    torch.testing.assert_close(lg[mass], lg_s[mass], rtol=0, atol=bound)


def test_kernel_route_backward_raises(cuda):
    """A raw kernel launch has no backward; the public recursions on CUDA
    differentiate through their analytic VJPs instead."""
    init, A = (t.detach().to(cuda) for t in GenePredTransitions().matrices())
    E = torch.rand((1, 2, 64, Q), device=cuda).requires_grad_()
    E_T = recursion._kernel_chunk_inputs(E, 4)
    C = cuda_forward.sum_chunk_summaries(A.contiguous(), E_T, 4)
    with pytest.raises(NotImplementedError, match="analytic chunked VJPs"):
        C.sum().backward()
    ll = recursion.log_likelihood(init, A, E, parallel_factor=4)
    (g,) = torch.autograd.grad(ll.sum(), E)
    (g_seq,) = torch.autograd.grad(recursion.log_likelihood(init, A, E, 1).sum(), E)
    torch.testing.assert_close(g, g_seq, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# K4–K5 (affine adjoint solves) and the gradient routes
# ---------------------------------------------------------------------------

AFFINE_CASES = [
    pytest.param(1, 6, 24, 5, id="m1-q5"),
    pytest.param(2, 303, 1056, 15, id="m2-flagship"),
    pytest.param(2, 17, 21, 15, id="m2-ragged"),
    pytest.param(3, 40, 130, 3, id="m3-q3"),
    # The edges of K5's lane groups (16 chunk elements a block, tiles of 8
    # staged steps in the build): c around the tile, R not a multiple of
    # 16, q = 1.
    pytest.param(1, 1, 7, 15, id="c1-R7"),
    pytest.param(3, 2, 9, 3, id="m3-c2-R9-q3"),
    pytest.param(1, 7, 1, 15, id="c7-R1"),
    pytest.param(3, 9, 1057, 1, id="m3-c9-R1057-q1"),
    pytest.param(1, 17, 9, 15, id="c17-R9"),
    pytest.param(1, 33, 1057, 15, id="c33-R1057"),
    # The edges of K4's blocks (8 chunk elements of 16 column threads a
    # block, tiles of 8 staged steps walked from the chunk's end): c around
    # and below the tile, R = 1 and not a multiple of 8, q = 1 and 3
    # (padding columns past the offset column), q = 14.
    pytest.param(1, 15, 5, 15, id="c15-R5"),
    pytest.param(2, 8, 6, 14, id="m2-c8-R6-q14"),
    pytest.param(1, 32, 3, 15, id="c32-R3"),
    pytest.param(3, 31, 1, 3, id="m3-c31-R1-q3"),
    pytest.param(2, 48, 1031, 1, id="m2-c48-R1031-q1"),
]


@pytest.mark.parametrize("m,c,R,q", AFFINE_CASES)
def test_affine_kernels_match_plain(cuda, m, c, R, q):
    gen = torch.Generator(device=cuda).manual_seed(m * 1000 + c)
    B = torch.rand((m, q, q), generator=gen, device=cuda)
    B = (B / B.sum(-1, keepdim=True)).contiguous()
    U, V = (torch.rand((m, c, q, R), generator=gen, device=cuda) for _ in range(2))
    S = torch.randn((m, c, q, R), generator=gen, device=cuda)
    S = S - S.mean(2, keepdim=True)  # centred sources, as the posterior VJP builds them
    x_right = torch.randn((m, q, R), generator=gen, device=cuda)
    cuda_adjoint.reset_launches()
    comp = cuda_adjoint.affine_chunk_composites(B, U, V, S)
    x = cuda_adjoint.affine_reverse_outputs(B, U, V, S, x_right)
    assert cuda_adjoint.LAUNCHES == {"affine_chunk_composites": 1, "affine_reverse_outputs": 1}
    torch.testing.assert_close(comp, cuda_adjoint.affine_chunk_composites_plain(B, U, V, S),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(x, cuda_adjoint.affine_reverse_outputs_plain(B, U, V, S, x_right),
                               rtol=1e-5, atol=1e-6)
    torch.cuda.synchronize()


def test_affine_kernels_refuse_what_they_cannot_take(cuda):
    U = torch.zeros((1, 4, 16, 8), device=cuda)
    with pytest.raises(ValueError, match="q <= 15"):
        cuda_adjoint.affine_chunk_composites(torch.zeros((1, 16, 16), device=cuda), U, U, U)
    U = torch.zeros((1, 4, 5, 8), device=cuda)
    with pytest.raises(ValueError, match="x_right"):
        cuda_adjoint.affine_reverse_outputs(torch.zeros((1, 5, 5), device=cuda), U, U, U,
                                            torch.zeros((1, 5, 9), device=cuda))
    with pytest.raises(TypeError, match="float32"):
        cuda_adjoint.affine_chunk_composites(torch.zeros((1, 5, 5), device=cuda), U.double(), U, U)


def _training_layer(pf, device):
    layer = HMMLayer(GenePredTransitions(), GenePredEmissions(**CODONS), use_prior=False,
                     parallel_factor=pf, device=device)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in layer.parameters():
            p.add_((0.5 * torch.randn(p.shape, generator=gen)).to(p.device))
    return layer


@pytest.mark.parametrize("objective", ["ce", "map"])
def test_kernel_route_gradients_match_plain_route(cuda, monkeypatch, objective):
    """Gradients of the training objectives with respect to every
    parameter: the kernel route (K1–K5) against the plain route on the
    card, with the launches of one step."""
    layer = _training_layer(8, cuda)
    rng = np.random.default_rng(3)
    b, L = 3, 1200
    cls = rng.dirichlet(np.ones(15), size=(1, b, L)).astype(np.float32)
    nuc = np.eye(5, dtype=np.float32)[rng.integers(0, 4, size=(1, b, L))]
    X = np.concatenate([cls, nuc], axis=-1)
    labels = rng.integers(0, 15, size=(b, L))
    mask = (rng.uniform(size=(b, L)) > 0.2).astype(np.float32)
    pars = list(layer.parameters())

    def grads():
        if objective == "ce":
            value = layer.posterior_cross_entropy(X, labels, label_mask=mask)
        else:
            value = layer.loss(X)
        return value, torch.autograd.grad(value, pars)

    cuda_forward.reset_launches()
    cuda_adjoint.reset_launches()
    value, kern = grads()
    launches = {**cuda_forward.LAUNCHES, **cuda_adjoint.LAUNCHES}
    if objective == "ce":
        assert launches == {"sum_chunk_summaries": 1, "sum_fwd_outputs": 1, "beta_bwd_outputs": 1,
                            "sum_forward_wide": 0, "sum_backward_wide": 0,
                            "affine_chunk_composites": 1, "affine_reverse_outputs": 1}
    else:  # C is saved: the backward runs K2 and K3 only
        assert launches == {"sum_chunk_summaries": 1, "sum_fwd_outputs": 1, "beta_bwd_outputs": 1,
                            "sum_forward_wide": 0, "sum_backward_wide": 0,
                            "affine_chunk_composites": 0, "affine_reverse_outputs": 0}
    monkeypatch.setattr(recursion, "_use_kernels", lambda E: False)
    monkeypatch.setattr(recursion, "_use_affine_kernels", lambda x: False)
    value_plain, plain = grads()
    torch.testing.assert_close(value, value_plain, rtol=1e-5, atol=0)
    # 1e-4 of the max, or one float32 spacing at |loglik| where larger: the
    # log-scales both routes carry round independently at that resolution.
    with torch.no_grad():
        ll = layer.log_likelihood(X)
    limit = max(1e-4, 2.0 ** (math.floor(math.log2(float(ll.abs().max()))) - 23))
    for g, r in zip(kern, plain):
        assert float((g - r).abs().max()) <= limit * float(r.abs().max())


def test_kernel_refuses_what_it_cannot_take(cuda):
    A, E_T, r0, ll0 = _inputs(2, 1, 8, 40, False, cuda)
    with pytest.raises(ValueError, match="q <= 16"):
        cuda_forward.sum_chunk_summaries(
            torch.ones((1, 17, 17), device=cuda), torch.ones((1, 8, 17, 40), device=cuda), 2
        )
    with pytest.raises(ValueError, match="contiguous"):
        cuda_forward.sum_fwd_outputs(A, E_T, r0.transpose(1, 2).contiguous().transpose(1, 2), ll0)
    with pytest.raises(TypeError, match="float32"):
        cuda_forward.beta_bwd_outputs(A, E_T.double(), r0, ll0)


# ---------------------------------------------------------------------------
# K6–K8 (max-plus Viterbi)
# ---------------------------------------------------------------------------


def _log_inputs(seed, m, c, R, gene_pred, device, q=Q):
    A, E_T, _, _ = _inputs(seed, m, c, R, gene_pred, device, q)
    return torch.log(A.clamp_min(1e-16)).contiguous(), torch.log(E_T).contiguous()


# The edges of the blocks and tiles of K6–K8 (in the build: K6 8 elements
# of 16 border threads a block, tiles of 32 steps; K7 and K8 8 elements of a
# 16-lane group a block, tiles of 16 steps, K8's walked from the end):
# c = 1 and c around the tiles, R = 1 and not a multiple of 8, first chunks
# that straddle block borders, q = 1, 3, 15 and 16, m = 3. Fields: m, c, R,
# P, gene_pred, q.
MAXPLUS_CASES = [pytest.param(*p.values, Q, id=p.id) for p in CASES] + [
    pytest.param(1, 1, 7, 1, False, 15, id="c1-R7"),
    pytest.param(3, 2, 9, 3, False, 3, id="m3-c2-R9-q3"),
    pytest.param(1, 15, 1, 1, False, 16, id="c15-R1-q16"),
    pytest.param(2, 16, 13, 13, False, 15, id="m2-c16-R13"),
    pytest.param(1, 17, 1057, 7, False, 1, id="c17-R1057-q1"),
    pytest.param(1, 33, 9, 3, False, 16, id="c33-R9-q16"),
    pytest.param(1, 97, 22, 11, True, 15, id="c97-R22-genepred"),
    pytest.param(1, 7, 3, 3, False, 15, id="c7-R3"),
    pytest.param(1, 8, 12, 4, False, 16, id="c8-R12-q16"),
    pytest.param(1, 9, 1, 1, False, 3, id="c9-R1-q3"),
    pytest.param(1, 31, 25, 5, False, 15, id="c31-R25-P5"),
    pytest.param(3, 32, 17, 17, False, 15, id="m3-c32-R17"),
    pytest.param(1, 63, 11, 11, True, 15, id="c63-R11-genepred"),
    pytest.param(2, 64, 9, 3, False, 16, id="m2-c64-R9-q16"),
    pytest.param(1, 65, 1, 1, False, 1, id="c65-R1-q1"),
    pytest.param(3, 129, 1057, 33, True, 15, id="m3-c129-R1057-genepred"),
]


@pytest.mark.parametrize("m,c,R,P,gene_pred,q", MAXPLUS_CASES)
def test_maxplus_kernels_equal_plain(cuda, m, c, R, P, gene_pred, q):
    """Bit-equal: the kernels and the plain versions do the same rounded
    adds in the same order and exact maxes."""
    log_A, log_E_T = _log_inputs(3, m, c, R, gene_pred, cuda, q)
    gen = torch.Generator(device=cuda).manual_seed(0)
    delta0 = (torch.randn((m, q, R), generator=gen, device=cuda) * 5 - 20 + log_E_T[:, 0]).contiguous()
    last = torch.randint(0, q, (m, R), generator=gen, device=cuda, dtype=torch.int32)
    cuda_viterbi.reset_launches()
    C_T = cuda_viterbi.maxplus_chunk_summaries(log_A, log_E_T, P)
    deltas = cuda_viterbi.maxplus_deltas(log_A, log_E_T, delta0)
    states = cuda_viterbi.maxplus_backtrace(log_A, deltas, last)
    assert cuda_viterbi.LAUNCHES == {
        "maxplus_chunk_summaries": 1, "maxplus_deltas": 1, "maxplus_backtrace": 1,
        "maxplus_deltas_blocked": 0, "maxplus_backtrace_blocked": 0,
        "maxplus_deltas_wide": 0, "maxplus_backtrace_wide": 0,
    }
    assert torch.equal(C_T, cuda_viterbi.maxplus_chunk_summaries_plain(log_A, log_E_T, P))
    assert torch.equal(deltas, cuda_viterbi.maxplus_deltas_plain(log_A, log_E_T, delta0))
    assert torch.equal(states, cuda_viterbi.maxplus_backtrace_plain(log_A, deltas, last))
    assert torch.equal(cuda_viterbi.maxplus_decode(log_A, log_E_T, delta0, last), states)
    torch.cuda.synchronize()


@pytest.mark.parametrize("q", [1, 3, 15, 16])
def test_maxplus_backtrace_ties_take_the_lowest_state(cuda, q):
    """K8 breaks ties as torch.argmax does, at the lowest state, and -0 ties
    with +0 as they compare (-0 + -0 stays -0, so log A of -0 checks it)."""
    m, c, R = 2, 77, 37
    gen = torch.Generator(device=cuda).manual_seed(q)
    last = torch.randint(0, q, (m, R), generator=gen, device=cuda, dtype=torch.int32)
    flat = torch.zeros((m, c, q, R), device=cuda)
    signed = flat.clone()
    signed[:, :, 0::2] = -0.0  # -0 in the even states, +0 in the odd ones
    for log_A in (torch.zeros((m, q, q), device=cuda), torch.full((m, q, q), -0.0, device=cuda)):
        for deltas in (flat, signed):
            cuda_viterbi.reset_launches()
            states = cuda_viterbi.maxplus_backtrace(log_A, deltas, last)
            assert cuda_viterbi.LAUNCHES["maxplus_backtrace"] == 1
            assert (states[:, :-1] == 0).all() and torch.equal(states[:, -1], last)
            assert torch.equal(states, cuda_viterbi.maxplus_backtrace_plain(log_A, deltas, last))
    torch.cuda.synchronize()


def _path_score64(init, A, E, path):
    """float64 score of each path (m, b) and whether each transition it
    takes has A > 0 (m, b, L-1)."""
    init, A, E = (x.double().cpu() for x in (init, A, E))
    path = path.long().cpu()
    m, b, L = path.shape
    mi = torch.arange(m)[:, None, None]
    lA = torch.log(A.clamp_min(1e-16))
    score = torch.log(init.clamp_min(1e-16)[torch.arange(m)[:, None], path[..., 0]])
    score = score + torch.log(E.clamp_min(1e-16)).gather(-1, path[..., None])[..., 0].sum(-1)
    prev, nxt = path[..., :-1], path[..., 1:]
    return score + lA[mi, prev, nxt].sum(-1), A[mi, prev, nxt] > 0


@pytest.mark.parametrize("pf", [8, "auto"])
def test_layer_viterbi_kernel_route_matches_plain_route(cuda, pf):
    layer = HMMLayer(GenePredTransitions(), GenePredEmissions(**CODONS), use_prior=False,
                     parallel_factor=pf)
    rng = np.random.default_rng(2)
    b, L = 3, 1200
    cls = rng.dirichlet(np.ones(15) * 0.3, size=(1, b, L)).astype(np.float32)
    nuc = np.eye(5, dtype=np.float32)[rng.integers(0, 4, size=(1, b, L))]
    X = np.concatenate([cls, nuc], axis=-1)
    with torch.inference_mode():
        cuda_viterbi.reset_launches()
        paths = layer.viterbi(X)
        assert cuda_viterbi.LAUNCHES == {
            "maxplus_chunk_summaries": 1, "maxplus_deltas": 1, "maxplus_backtrace": 1,
            "maxplus_deltas_blocked": 0, "maxplus_backtrace_blocked": 0,
            "maxplus_deltas_wide": 0, "maxplus_backtrace_wide": 0,
        }
        init, A = layer.transitions.matrices()
        E = layer.emission_probs(X)
        P = layer._pf(E, for_viterbi=True)
        plain = recursion._viterbi_chunked_plain(init, A, E, P)
        seq = recursion.viterbi(init, A, E, 1)
    assert paths.dtype == torch.int32 and tuple(paths.shape) == (1, b, L)
    assert torch.equal(paths, plain)
    s_k, used_k = _path_score64(init, A, E, paths)
    s_s, used_s = _path_score64(init, A, E, seq)
    assert used_k[used_s.all(-1)].all()
    torch.testing.assert_close(s_k, s_s, rtol=1e-6, atol=0)


def test_maxplus_kernels_refuse_what_they_cannot_take(cuda):
    log_A, log_E_T = _log_inputs(4, 1, 8, 40, False, cuda)
    with pytest.raises(ValueError, match="q <= 16"):
        cuda_viterbi.maxplus_chunk_summaries(
            torch.zeros((1, 17, 17), device=cuda), torch.zeros((1, 8, 17, 40), device=cuda), 2
        )
    with pytest.raises(ValueError, match="delta0"):
        cuda_viterbi.maxplus_deltas(log_A, log_E_T, torch.zeros((1, Q, 41), device=cuda))
    deltas = cuda_viterbi.maxplus_deltas(log_A, log_E_T, log_E_T[:, 0].contiguous())
    with pytest.raises(ValueError, match="int32"):
        cuda_viterbi.maxplus_backtrace(log_A, deltas, torch.zeros((1, 40), dtype=torch.int64, device=cuda))


# ---------------------------------------------------------------------------
# K7b–K8b (blocked max-plus, 16 < q <= 64) and K9 (summaries, 16 < q <= 128)
# ---------------------------------------------------------------------------


def _blocked_inputs(seed, q, c, R, device):
    """log A with structural zeros (m = 1), log E_T (1, c, q, R), delta0 and
    last states."""
    rng = np.random.default_rng(seed)
    A = rng.dirichlet(np.ones(q), size=q)
    A[:, q // 2] = 0.0
    A = A / A.sum(-1, keepdims=True)
    E = rng.dirichlet(np.ones(q) * 0.3, size=(c, R)).transpose(0, 2, 1)
    log = lambda x: torch.log(torch.from_numpy(np.ascontiguousarray(x, np.float32)).clamp_min(1e-16))  # noqa: E731
    log_A, log_E_T = log(A)[None].to(device), log(E)[None].contiguous().to(device)
    delta0 = (log_E_T[:, 0] - 20.0).contiguous()
    last = torch.from_numpy(rng.integers(0, q, size=(1, R)).astype(np.int32)).to(device)
    return log_A.contiguous(), log_E_T, delta0, last


# The tile edges of K7b (emissions staged 64 steps a tile) and K8b
# (backpointer tiles of 128 steps): c - 1 at 0, 1, 64, 65, 128, 129 and 776.
BLOCKED_C = [1, 2, 65, 66, 129, 130, 777]


@pytest.mark.parametrize("R", [1, 37])
@pytest.mark.parametrize("c", BLOCKED_C)
@pytest.mark.parametrize("q", [17, 29, 32, 33, 57, 64])
def test_blocked_maxplus_kernels_equal_plain(cuda, q, c, R):
    """K7b and K8b bit-equal to their plain versions at a sequential
    decode's shape (c = L, R = b), through the lane-layout wrappers and the
    sequence-major ones."""
    log_A, log_E_T, delta0, last = _blocked_inputs(q * c + R, q, c, R, cuda)
    cuda_viterbi.reset_launches()
    deltas = cuda_viterbi.maxplus_deltas(log_A, log_E_T, delta0)
    states = cuda_viterbi.maxplus_backtrace(log_A, deltas, last)
    assert cuda_viterbi.LAUNCHES == {
        "maxplus_chunk_summaries": 0, "maxplus_deltas": 0, "maxplus_backtrace": 0,
        "maxplus_deltas_blocked": 1, "maxplus_backtrace_blocked": 1,
        "maxplus_deltas_wide": 0, "maxplus_backtrace_wide": 0,
    }
    assert torch.equal(deltas, cuda_viterbi.maxplus_deltas_plain(log_A, log_E_T, delta0))
    assert torch.equal(states, cuda_viterbi.maxplus_backtrace_plain(log_A, deltas, last))
    log_E, d0 = log_E_T.movedim(-1, 1).contiguous(), delta0.transpose(1, 2).contiguous()
    deltas_seq = cuda_viterbi.maxplus_deltas_seq(log_A, log_E, d0)
    assert torch.equal(deltas_seq, deltas.movedim(-1, 1))
    assert torch.equal(cuda_viterbi.maxplus_backtrace_seq(log_A, deltas_seq, last), states.transpose(1, 2))
    torch.cuda.synchronize()


@pytest.mark.parametrize("q", [29, 57])
def test_blocked_backtrace_ties_take_the_lowest_state(cuda, q):
    """Flat rows: every state ties and state 0 wins. A -0 term ties with +0:
    deltas of -0 at state 0 and log A of -0 on its row give w = -0 there,
    +0 elsewhere, and state 0 still wins."""
    c, R = 150, 5
    last = torch.arange(R, dtype=torch.int32, device=cuda)[None] % q
    flat_A = torch.full((1, q, q), -math.log(q), device=cuda)
    flat = torch.zeros((1, c, q, R), device=cuda)
    signed_A = torch.zeros((1, q, q), device=cuda)
    signed_A[:, 0] = -0.0
    signed = torch.zeros((1, c, q, R), device=cuda)
    signed[:, :, 0] = -0.0
    for log_A, deltas in ((flat_A, flat), (signed_A, signed)):
        states = cuda_viterbi.maxplus_backtrace(log_A, deltas, last)
        assert torch.equal(states, cuda_viterbi.maxplus_backtrace_plain(log_A, deltas, last))
        assert (states[:, :-1] == 0).all() and torch.equal(states[:, -1], last)
    torch.cuda.synchronize()


@pytest.mark.parametrize("q", [29, 57])
def test_blocked_backtrace_last_state_outside_takes_the_neg_column(cuda, q):
    """A last state of q (outside [0, q)) is written as given and scored
    against an all-NEG column of log A: the state before it is the lowest
    argmax of deltas + NEG, and the path goes on from there."""
    c, R = 130, 3
    log_A, log_E_T, delta0, _ = _blocked_inputs(q, q, c, R, cuda)
    deltas = cuda_viterbi.maxplus_deltas(log_A, log_E_T, delta0)
    last = torch.full((1, R), q, dtype=torch.int32, device=cuda)
    states = cuda_viterbi.maxplus_backtrace(log_A, deltas, last)
    before = (deltas[:, -2] + cuda_viterbi.NEG).argmax(dim=1).to(torch.int32)
    rest = cuda_viterbi.maxplus_backtrace_plain(log_A, deltas[:, :-1], before)
    assert torch.equal(states[:, -1], last)
    assert torch.equal(states[:, :-1], rest)
    torch.cuda.synchronize()


def _multi_copy_layer(k, pf, device):
    layer = HMMLayer(
        GenePredMultiTransitions(k=k),
        GenePredEmissions(num_copies=k, init=make_15_class_emission_kernel(num_copies=k), **CODONS),
        use_prior=False, parallel_factor=pf, device=device,
    )
    gen = torch.Generator().manual_seed(k)
    with torch.no_grad():
        for p in layer.parameters():
            p.add_((0.3 * torch.randn(p.shape, generator=gen)).to(p.device))
    return layer


def _multi_copy_inputs(seed, b, L):
    rng = np.random.default_rng(seed)
    cls = rng.dirichlet(np.ones(15), size=(1, b, L)).astype(np.float32)
    nuc = np.eye(5, dtype=np.float32)[rng.integers(0, 4, size=(1, b, L))]
    return np.concatenate([cls, nuc], axis=-1)


@pytest.mark.parametrize("pf", [1, 8])
def test_multi_copy_viterbi_takes_blocked_kernels(cuda, monkeypatch, pf):
    """At q = 29 ``viterbi`` runs K7b + K8b whatever the parallel factor;
    the paths equal the same glue on the plain versions on the card, and
    are valid and score-equal to the sequential decode."""
    layer = _multi_copy_layer(2, pf, cuda)
    X = _multi_copy_inputs(4, 3, 1200)
    with torch.inference_mode():
        cuda_viterbi.reset_launches()
        paths = layer.viterbi(X)
        assert cuda_viterbi.LAUNCHES == {
            "maxplus_chunk_summaries": 0, "maxplus_deltas": 0, "maxplus_backtrace": 0,
            "maxplus_deltas_blocked": 1, "maxplus_backtrace_blocked": 1,
            "maxplus_deltas_wide": 0, "maxplus_backtrace_wide": 0,
        }
        init, A = layer.transitions.matrices()
        E = layer.emission_probs(X)
        seq = recursion._viterbi_seq(init, A, E)
        monkeypatch.setattr(cuda_viterbi, "maxplus_deltas_seq", cuda_viterbi.maxplus_deltas_seq_plain)
        monkeypatch.setattr(cuda_viterbi, "maxplus_backtrace_seq", cuda_viterbi.maxplus_backtrace_seq_plain)
        plain = recursion._viterbi_seq_kernels(init, A, E)
    assert paths.dtype == torch.int32 and tuple(paths.shape) == (1, 3, 1200)
    assert torch.equal(paths, plain)
    s_k, used_k = _path_score64(init, A, E, paths)
    s_s, used_s = _path_score64(init, A, E, seq)
    assert used_k[used_s.all(-1)].all()
    torch.testing.assert_close(s_k, s_s, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# K7c–K8c (the sequential max-plus decode, 64 < q <= 512)
# ---------------------------------------------------------------------------


def _wide_inputs(seed, m, q, c, R, device):
    """log A with structural zeros (log EPS), log E (m, R, c, q) and delta0
    (m, R, q) as the decode builds them."""
    rng = np.random.default_rng(seed)
    A = rng.dirichlet(np.ones(q) * 0.5, size=(m, q))
    A[:, :, q // 3] = 0.0
    A /= A.sum(-1, keepdims=True)
    E = rng.dirichlet(np.ones(q) * 0.3, size=(m, R, c))
    init = rng.dirichlet(np.ones(q), size=m)
    log = lambda x: torch.log(torch.from_numpy(np.ascontiguousarray(x, np.float32)).clamp_min(1e-16)).to(device)  # noqa: E731
    log_A, log_E = log(A).contiguous(), log(E).contiguous()
    delta0 = (log(init)[:, None, :] + log_E[:, :, 0]).contiguous()
    return log_A, log_E, delta0


def _seq_paths(log_A, log_E, delta0):
    """``recursion._viterbi_seq``'s paths from log inputs: its loops on the
    card (log of exp of a log input rounds, so the loops run here, not the
    function)."""
    bp, last = cuda_viterbi.maxplus_deltas_wide_plain(log_A, log_E, delta0)
    return cuda_viterbi.maxplus_backtrace_wide_plain(bp, last)


# q at the slice and block edges of K7c (4 slices of 32 rows to q = 128, 8
# of 32 to 256, 8 of 64 to 512; blocks of 64 columns at q > 256, so a
# cluster of 8 at 505 and 512), b not a multiple of anything, L = 1 and 2
# and past K7c's 32-step emission tiles and K8c's 32-row pointer tiles.
WIDE_CASES = [
    pytest.param(2, q, c, 3, id=f"m2-q{q}-L{c}")
    for q in (65, 127, 128, 129, 256, 257, 505, 512) for c in (1, 2, 66)
] + [
    pytest.param(1, 257, 33, 5, id="m1-q257-L33"),
    pytest.param(1, 505, 97, 37, id="m1-q505-L97-b37"),
]


@pytest.mark.parametrize("m,q,c,R", WIDE_CASES)
def test_wide_maxplus_kernels_equal_plain(cuda, m, q, c, R):
    """K7c's pointers and last delta bit-equal to the plain version on the
    card; K8c's paths equal to the plain walk and to the sequential scan's."""
    log_A, log_E, delta0 = _wide_inputs(q * c + R, m, q, c, R, cuda)
    cuda_viterbi.reset_launches()
    bp, last = cuda_viterbi.maxplus_deltas_wide(log_A, log_E, delta0)
    paths = cuda_viterbi.maxplus_backtrace_wide(bp, last)
    assert cuda_viterbi.LAUNCHES == {
        "maxplus_chunk_summaries": 0, "maxplus_deltas": 0, "maxplus_backtrace": 0,
        "maxplus_deltas_blocked": 0, "maxplus_backtrace_blocked": 0,
        "maxplus_deltas_wide": 1, "maxplus_backtrace_wide": 1,
    }
    bp_p, last_p = cuda_viterbi.maxplus_deltas_wide_plain(log_A, log_E, delta0)
    assert bp.dtype == torch.uint16 and tuple(bp.shape) == (m, R, c - 1, q)
    assert torch.equal(bp, bp_p)
    assert torch.equal(last, last_p)
    assert paths.dtype == torch.int32 and tuple(paths.shape) == (m, R, c)
    assert torch.equal(paths, cuda_viterbi.maxplus_backtrace_wide_plain(bp_p, last_p))
    assert torch.equal(paths, _seq_paths(log_A, log_E, delta0))
    torch.cuda.synchronize()


@pytest.mark.parametrize("q", [65, 129, 505])
def test_wide_maxplus_ties_take_the_lowest_state(cuda, q):
    """Two identical states k1 < k2 tie exactly at every step: no pointer
    and no path takes k2. Flat inputs tie everywhere and take state 0, and
    -0 terms (deltas and log A rows of -0 at even states) tie with +0."""
    k1, k2 = 1, q - 1
    log_A, log_E, delta0 = _wide_inputs(q, 2, q, 70, 5, cuda)
    log_A[:, k2, :] = log_A[:, k1, :]
    log_A[:, :, k2] = log_A[:, :, k1]
    log_E[..., k2] = log_E[..., k1]
    delta0[..., k2] = delta0[..., k1]
    bp, last = cuda_viterbi.maxplus_deltas_wide(log_A, log_E, delta0)
    paths = cuda_viterbi.maxplus_backtrace_wide(bp, last)
    assert not (bp == k2).any() and not (paths == k2).any()
    assert torch.equal(bp, cuda_viterbi.maxplus_deltas_wide_plain(log_A, log_E, delta0)[0])
    assert torch.equal(paths, _seq_paths(log_A, log_E, delta0))

    signed_A = torch.zeros((1, q, q), device=cuda)
    signed_A[:, 0::2] = -0.0
    signed0 = torch.zeros((1, 3, q), device=cuda)
    signed0[..., 0::2] = -0.0
    flat_E = torch.full((1, 3, 40, q), -0.0, device=cuda)
    for log_A, delta0 in ((torch.full((1, q, q), -math.log(q), device=cuda), torch.zeros((1, 3, q), device=cuda)),
                          (signed_A, signed0)):
        bp, last = cuda_viterbi.maxplus_deltas_wide(log_A, flat_E, delta0)
        paths = cuda_viterbi.maxplus_backtrace_wide(bp, last)
        assert (bp == 0).all() and (paths == 0).all()
        assert torch.equal(bp, cuda_viterbi.maxplus_deltas_wide_plain(log_A, flat_E, delta0)[0])
    torch.cuda.synchronize()


@pytest.mark.parametrize("pf", [1, "auto"])
def test_config5_viterbi_takes_wide_kernels(cuda, monkeypatch, pf):
    """Config 5 (k = 36, q = 505) decodes through K7c + K8c once each at
    P = 1 (``auto`` gives 1 for a decode at q > 16); the paths equal
    ``_viterbi_seq``'s on the card."""
    layer = _multi_copy_layer(36, pf, cuda)
    X = _multi_copy_inputs(5, 3, 700)
    with torch.inference_mode():
        cuda_viterbi.reset_launches()
        paths = layer.viterbi(X)
        assert cuda_viterbi.LAUNCHES == {
            "maxplus_chunk_summaries": 0, "maxplus_deltas": 0, "maxplus_backtrace": 0,
            "maxplus_deltas_blocked": 0, "maxplus_backtrace_blocked": 0,
            "maxplus_deltas_wide": 1, "maxplus_backtrace_wide": 1,
        }
        init, A = layer.transitions.matrices()
        E = layer.emission_probs(X)
        seq = recursion._viterbi_seq(init, A, E)
    assert paths.dtype == torch.int32 and tuple(paths.shape) == (1, 3, 700)
    assert torch.equal(paths, seq)


def test_wide_maxplus_kernels_refuse_what_they_cannot_take(cuda):
    log_A, log_E, delta0 = _wide_inputs(1, 1, 70, 9, 2, cuda)
    for q in (64, cuda_viterbi.MAX_WIDE_Q + 1):
        with pytest.raises(ValueError, match=f"64 < q <= {cuda_viterbi.MAX_WIDE_Q}"):
            cuda_viterbi.maxplus_deltas_wide(torch.zeros((1, q, q), device=cuda),
                                             torch.zeros((1, 2, 4, q), device=cuda),
                                             torch.zeros((1, 2, q), device=cuda))
        with pytest.raises(ValueError, match=f"64 < q <= {cuda_viterbi.MAX_WIDE_Q}"):
            cuda_viterbi.maxplus_backtrace_wide(torch.zeros((1, 2, 3, q), dtype=torch.uint16, device=cuda),
                                                torch.zeros((1, 2, q), device=cuda))
    with pytest.raises(TypeError, match="float32"):
        cuda_viterbi.maxplus_deltas_wide(log_A, log_E.double(), delta0)
    with pytest.raises(ValueError, match="delta0"):
        cuda_viterbi.maxplus_deltas_wide(log_A, log_E, delta0[:, :1].contiguous())
    with pytest.raises(ValueError, match="log_A"):
        cuda_viterbi.maxplus_deltas_wide(log_A[:, :69, :69].contiguous(), log_E, delta0)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_viterbi.maxplus_deltas_wide(log_A, log_E.transpose(1, 2), delta0)
    bp, last = cuda_viterbi.maxplus_deltas_wide(log_A, log_E, delta0)
    with pytest.raises(TypeError, match="uint16"):
        cuda_viterbi.maxplus_backtrace_wide(bp.int(), last)
    with pytest.raises(ValueError, match="last_delta"):
        cuda_viterbi.maxplus_backtrace_wide(bp, last[:, :1].contiguous())
    with pytest.raises(ValueError, match="last_delta is on cpu"):
        cuda_viterbi.maxplus_backtrace_wide(bp, last.cpu())
    torch.cuda.synchronize()


def _mxu_inputs(seed, m, q, c, R, device):
    rng = np.random.default_rng(seed)
    A = rng.dirichlet(np.ones(q), size=(m, q))
    A[:, :, 1] = 0.0
    A = A / A.sum(-1, keepdims=True)
    E_S = rng.uniform(0.05, 1.0, size=(m, c, R, q))
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device) for x in (A, E_S)]


# Every padded width of K9 (QP = 32, 64, 96, 128) at its first and last q.
@pytest.mark.parametrize("q", [17, 29, 32, 33, 64, 65, 96, 97, 127, 128])
def test_mxu_kernel_matches_plain(cuda, q):
    """K9 against its plain version: another order of the sums, so within
    rtol = atol = 2e-4 (the JAX suite's tolerance for this kernel) where
    the operator lies within 30 nats of its row's maximum."""
    A, E_S = _mxu_inputs(q, 2, q, 40, 24, cuda)
    cuda_mxu.reset_launches()
    C = cuda_mxu.sum_chunk_summaries_mxu(A, E_S, 4)
    assert cuda_mxu.LAUNCHES == {"sum_chunk_summaries_mxu": 1}
    ref = cuda_mxu.sum_chunk_summaries_mxu_plain(A, E_S, 4)
    mask = ref >= ref.amax(-1, keepdim=True) - 30.0
    torch.testing.assert_close(C[mask], ref[mask], rtol=2e-4, atol=2e-4)
    torch.cuda.synchronize()


# The edges of K9's blocks and ring (in the build: 8 elements a block at q <=
# 32, one above; ring slots of 16 steps): c = 1 (step 0 only) and c around a
# slot, P = 1 (every element a first chunk), first chunks inside a block's
# elements (P = 3, 5), R not a multiple of 8, m = 2. Fields: m, q, c, R, P.
MXU_EDGE_CASES = [
    pytest.param(1, 29, 1, 13, 1, id="c1-q29-R13-P1"),
    pytest.param(1, 127, 1, 3, 2, id="c1-q127"),
    pytest.param(1, 29, 16, 21, 1, id="c16-R21-P1"),
    pytest.param(1, 29, 17, 27, 3, id="c17-R27-P3"),
    pytest.param(1, 33, 33, 1, 1, id="c33-R1-q33"),
    pytest.param(1, 97, 15, 5, 5, id="c15-R5-P5-q97"),
    pytest.param(2, 29, 37, 19, 4, id="m2-c37-R19-P4"),
    pytest.param(2, 128, 17, 3, 3, id="m2-c17-q128"),
]


@pytest.mark.parametrize("m,q,c,R,P", MXU_EDGE_CASES)
def test_mxu_kernel_edges_match_plain(cuda, m, q, c, R, P):
    A, E_S = _mxu_inputs(q + c, m, q, c, R, cuda)
    C = cuda_mxu.sum_chunk_summaries_mxu(A, E_S, P)
    ref = cuda_mxu.sum_chunk_summaries_mxu_plain(A, E_S, P)
    assert torch.isfinite(C).all()
    mask = ref >= ref.amax(-1, keepdim=True) - 30.0
    torch.testing.assert_close(C[mask], ref[mask], rtol=2e-4, atol=2e-4)
    torch.cuda.synchronize()


@pytest.mark.parametrize("k", [2, 9])
def test_mxu_kernel_gene_pred_matrix_matches_plain(cuda, k):
    """K9 on the multi-copy gene-prediction A (q = 1 + 14k: exact zeros
    wherever the model has no edge) and its emissions, laid out as the
    gated log-likelihood lays them out."""
    layer = _multi_copy_layer(k, 8, cuda)
    X = torch.from_numpy(_multi_copy_inputs(k, 3, 96)).to(cuda)
    with torch.inference_mode():
        _, A = layer.transitions.matrices()
        A = A.contiguous()
        Ec, _ = recursion._split_chunks(layer.emission_probs(X).clamp_min(1e-16), 8)
        E_S = Ec.transpose(1, 2).contiguous()
        assert tuple(E_S.shape) == (1, 12, 24, 1 + 14 * k) and bool((A == 0).any())
        C = cuda_mxu.sum_chunk_summaries_mxu(A, E_S, 8)
        ref = cuda_mxu.sum_chunk_summaries_mxu_plain(A, E_S, 8)
    mask = ref >= ref.amax(-1, keepdim=True) - 30.0
    torch.testing.assert_close(C[mask], ref[mask], rtol=2e-4, atol=2e-4)
    torch.cuda.synchronize()


def test_mxu_branch_only_with_the_gate(cuda, monkeypatch):
    layer = _multi_copy_layer(2, 4, cuda)
    X = _multi_copy_inputs(5, 2, 600)
    with torch.inference_mode():
        monkeypatch.setattr(cuda_mxu, "MXU_KERNELS", False)
        cuda_mxu.reset_launches()
        cuda_forward.reset_launches()
        ll_off = layer.log_likelihood(X)
        assert cuda_mxu.LAUNCHES["sum_chunk_summaries_mxu"] == 0
        monkeypatch.setattr(cuda_mxu, "MXU_KERNELS", True)
        ll_on = layer.log_likelihood(X)
        assert cuda_mxu.LAUNCHES["sum_chunk_summaries_mxu"] == 1
        assert cuda_forward.LAUNCHES["sum_chunk_summaries"] == 0
        init, A = layer.transitions.matrices()
        ll_seq = recursion.log_likelihood(init, A, layer.emission_probs(X), 1)
    torch.testing.assert_close(ll_on, ll_off, rtol=1e-5, atol=0)
    torch.testing.assert_close(ll_on, ll_seq, rtol=2e-4, atol=0)


def test_blocked_and_mxu_kernels_refuse_what_they_cannot_take(cuda):
    with pytest.raises(ValueError, match="q <= 64"):
        cuda_viterbi.maxplus_deltas(torch.zeros((1, 65, 65), device=cuda),
                                    torch.zeros((1, 4, 65, 3), device=cuda),
                                    torch.zeros((1, 65, 3), device=cuda))
    with pytest.raises(ValueError, match="16 < q <= 128"):
        cuda_mxu.sum_chunk_summaries_mxu(torch.zeros((1, 129, 129), device=cuda),
                                         torch.zeros((1, 4, 3, 129), device=cuda), 1)
    with pytest.raises(TypeError, match="float32"):
        cuda_mxu.sum_chunk_summaries_mxu(torch.zeros((1, 29, 29), device=cuda),
                                         torch.zeros((1, 4, 3, 29), device=cuda, dtype=torch.float64), 1)


# ---------------------------------------------------------------------------
# auxiliary inference on the kernels (q = 15 gene-pred, K1–K3)
# ---------------------------------------------------------------------------


def _gene_pred_ingredients(cuda, b=3, L=1200, seed=1):
    layer = HMMLayer(GenePredTransitions(), GenePredEmissions(**CODONS), use_prior=False,
                     parallel_factor="auto")
    rng = np.random.default_rng(seed)
    cls = rng.dirichlet(np.ones(15), size=(1, b, L)).astype(np.float32)
    nuc = np.eye(5, dtype=np.float32)[rng.integers(0, 4, size=(1, b, L))]
    X = np.concatenate([cls, nuc], axis=-1)
    with torch.no_grad():
        init, A = layer.transitions.matrices()
        E = layer.emission_probs(X)
    return layer, X, init, A, E


def test_sample_paths_kernel_route_valid(cuda, monkeypatch):
    layer, X, init, A, E = _gene_pred_ingredients(cuda)
    cuda_forward.reset_launches()
    paths = layer.sample_paths(X, num_samples=8, generator=torch.Generator(cuda).manual_seed(0))
    assert dict(cuda_forward.LAUNCHES) == {"sum_chunk_summaries": 1, "sum_fwd_outputs": 0,
                                           "beta_bwd_outputs": 0, "sum_forward_wide": 0,
                                           "sum_backward_wide": 0}
    monkeypatch.setattr(recursion, "_use_kernels", lambda x: False)
    plain = layer.sample_paths(X, num_samples=8, generator=torch.Generator(cuda).manual_seed(0))
    for p in (paths, plain):
        assert p.shape == (1, 3, 8, 1200) and p.dtype == torch.int32
        p = p[0].long()
        assert bool((init[0][p[..., 0]] > 0).all())
        assert bool((A[0][p[..., :-1], p[..., 1:]] > 0).all())
    # The same noise through both routes: operators that agree to float32
    # rounding flip no more than a sliver of the draws.
    assert float((paths == plain).float().mean()) >= 0.99


def test_em_step_kernel_route_matches_plain(cuda, monkeypatch):
    layer, X, init, A, E = _gene_pred_ingredients(cuda)
    P = layer._pf(E)
    cuda_forward.reset_launches()
    new_init, new_A, ll = em.em_step(init, A, E, parallel_factor=P)
    assert dict(cuda_forward.LAUNCHES) == {"sum_chunk_summaries": 1, "sum_fwd_outputs": 1,
                                           "beta_bwd_outputs": 1, "sum_forward_wide": 0,
                                           "sum_backward_wide": 0}
    monkeypatch.setattr(recursion, "_use_kernels", lambda x: False)
    ref_init, ref_A, ref_ll = em.em_step(init, A, E, parallel_factor=P)
    torch.testing.assert_close(ll, ref_ll, rtol=1e-5, atol=0)
    torch.testing.assert_close(new_A, ref_A, rtol=0, atol=1e-3)
    torch.testing.assert_close(new_init, ref_init, rtol=0, atol=1e-3)
    torch.testing.assert_close(new_A.sum(-1), torch.ones_like(new_A[..., 0]), rtol=0, atol=1e-5)
    assert bool((new_A[A == 0] == 0).all())


def test_streaming_filter_kernel_route_matches_plain(cuda, monkeypatch):
    layer, X, init, A, E = _gene_pred_ingredients(cuda)
    cuda_forward.reset_launches()
    st = streaming.streaming_init(init, A, E[:, :, :600], parallel_factor=4)
    st = streaming.streaming_update(st, A, E[:, :, 600:], parallel_factor=4)
    assert cuda_forward.LAUNCHES["sum_chunk_summaries"] == 2
    ll_dense = recursion.log_likelihood(init, A, E, 4)
    monkeypatch.setattr(recursion, "_use_kernels", lambda x: False)
    sp = streaming.streaming_init(init, A, E[:, :, :600], parallel_factor=4)
    sp = streaming.streaming_update(sp, A, E[:, :, 600:], parallel_factor=4)
    torch.testing.assert_close(st.log_lik, sp.log_lik, rtol=1e-5, atol=0)
    torch.testing.assert_close(st.log_lik, ll_dense, rtol=1e-4, atol=0)
    torch.testing.assert_close(st.log_filter.exp(), sp.log_filter.exp(), rtol=0, atol=1e-3)


def test_chunked_forward_backward_take_k2_k3(cuda, monkeypatch):
    layer, X, init, A, E = _gene_pred_ingredients(cuda)
    cuda_forward.reset_launches()
    la, ll = recursion.forward(init, A, E, 4)
    lb = recursion.backward(init, A, E, 4)
    assert dict(cuda_forward.LAUNCHES) == {"sum_chunk_summaries": 2, "sum_fwd_outputs": 1,
                                           "beta_bwd_outputs": 1, "sum_forward_wide": 0,
                                           "sum_backward_wide": 0}
    monkeypatch.setattr(recursion, "_use_kernels", lambda x: False)
    la_p, ll_p = recursion.forward(init, A, E, 4)
    lb_p = recursion.backward(init, A, E, 4)
    torch.testing.assert_close(ll, ll_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(la, la_p, rtol=1e-5, atol=1e-2)
    torch.testing.assert_close(lb, lb_p, rtol=1e-5, atol=1e-2)


# ---------------------------------------------------------------------------
# The sparse edge-list engine: the same calls on the card and on the CPU
# ---------------------------------------------------------------------------


def _sparse_problem(k=2, b=3, L=40, seed=4):
    """Multi-copy transitions, seeded emissions, labels and a mask on the
    CPU: (indices, init, probs, E, labels, mask)."""
    from hmm_layer_torch.ops import sparse  # noqa: F401 (import check)

    t = GenePredMultiTransitions(k=k, sparse_forward=True, generator=torch.Generator().manual_seed(seed))
    indices, probs = t.make_A_sparse()
    init = t.make_initial_distribution().detach()
    rng = np.random.default_rng(seed)
    E = torch.from_numpy(rng.uniform(0.05, 1.0, (1, b, L, t.num_states)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, t.num_states, (1, b, L)))
    mask = torch.from_numpy((rng.random((1, b, L)) > 0.3).astype(np.float32))
    return indices, init, probs.detach(), E, labels, mask


def test_sparse_posterior_and_viterbi_match_cpu(cuda):
    from hmm_layer_torch.ops import sparse

    indices, init, probs, E, _, _ = _sparse_problem()
    on = [x.to(cuda) for x in (init, probs, E)]
    lg, ll = sparse.sparse_posterior(init, indices, probs, E)
    lg_c, ll_c = sparse.sparse_posterior(on[0], indices, on[1], on[2])
    assert lg_c.is_cuda
    np.testing.assert_allclose(lg_c.cpu().numpy(), lg.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ll_c.cpu().numpy(), ll.numpy(), rtol=1e-6)
    paths = sparse.sparse_viterbi(init, indices, probs, E)
    paths_c = sparse.sparse_viterbi(*on[:1], indices, *on[1:])
    assert paths_c.is_cuda and paths_c.dtype == torch.int32
    assert torch.equal(paths_c.cpu(), paths)


def test_sparse_fused_ce_gradient_matches_cpu(cuda):
    from hmm_layer_torch.ops import sparse

    indices, init, probs, E, labels, mask = _sparse_problem()

    def grads(device):
        leaves = [x.detach().clone().to(device).requires_grad_() for x in (init, probs, E)]
        ce = sparse.sparse_posterior_cross_entropy(
            leaves[0], indices, leaves[1], leaves[2], labels.to(device), label_mask=mask.to(device),
            backward_block=10)
        ce.backward()
        return ce.item(), [x.grad.cpu().numpy() for x in leaves]

    v, g = grads("cpu")
    v_c, g_c = grads(cuda)
    np.testing.assert_allclose(v_c, v, rtol=1e-5)
    for a, b in zip(g_c, g):
        scale = np.abs(b).max() + 1e-9
        np.testing.assert_allclose(a / scale, b / scale, atol=5e-5)


def test_sparse_em_step_matches_cpu(cuda):
    from hmm_layer_torch.ops import sparse

    indices, init, probs, E, _, _ = _sparse_problem()
    ref = sparse.sparse_em_step(init, indices, probs, E)
    got = sparse.sparse_em_step(init.to(cuda), indices, probs.to(cuda), E.to(cuda))
    for a, b in zip(got, ref):
        assert a.is_cuda
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-6)


def test_sparse_refuses_cuda_indices_and_is_deterministic(cuda):
    from hmm_layer_torch.ops import sparse

    indices, init, probs, E, _, _ = _sparse_problem(L=64)
    init, probs, E = (x.to(cuda) for x in (init, probs, E))
    with pytest.raises(TypeError, match="host array"):
        sparse.sparse_forward(init, torch.from_numpy(indices).to(cuda), probs, E)
    la, ll = sparse.sparse_forward(init, indices, probs, E)
    la2, ll2 = sparse.sparse_forward(init, indices, probs, E)
    assert torch.equal(la, la2) and torch.equal(ll, ll2)
    # The edge softmax's row sums too (a last-bit change moves the
    # log-scales of long sequences).
    t = GenePredMultiTransitions(k=36, sparse_forward=True).to(cuda)
    with torch.no_grad():
        first = t.make_A_sparse()[1]
        assert all(torch.equal(t.make_A_sparse()[1], first) for _ in range(10))


def _profile_layer(lengths, device, seed=0):
    from hmm_layer_torch.models import ProfileEmissions, ProfileTransitions

    return HMMLayer(
        ProfileTransitions(lengths, generator=torch.Generator().manual_seed(seed)),
        ProfileEmissions(lengths),
        num_seqs=1000,
        parallel_factor="auto",
        device=device,
    )


def _protein_inputs(seed, m, b, L):
    rng = np.random.default_rng(seed)
    x = np.eye(26, dtype=np.float32)[rng.integers(0, 25, size=(b, L))]
    return torch.from_numpy(np.ascontiguousarray(np.broadcast_to(x, (m, b, L, 26))))


def test_profile_config4_loglik_and_gradients_match_cpu(cuda):
    """Config 4's widths (5 models, q up to 155) at b = 4, L = 100: the
    log-likelihood and its gradients on the card equal those of a CPU copy
    (scale-normalised 1e-4), the MAP loss's within 5e-3; of the kernels
    only K2c and K3c launch (the sequential log-likelihood at 64 < q <=
    512): K2c for the log-likelihood, and for each objective K2c for its
    value and K2c and K3c in its VJP. The prior's hit term,
    ``(1e9 - 1) log(p_rf + p_t)``, has a gradient with respect to the end
    kernels proportional to ``1 - p_rf - p_t`` ~ 5e-5, which float32 gives
    to ~1e-3 on either device."""
    lengths = [60, 64, 68, 72, 76]
    layer = _profile_layer(lengths, cuda)
    cpu = _profile_layer(lengths, "cpu")
    cpu.load_state_dict(layer.state_dict())
    X = _protein_inputs(1, 5, 4, 100)
    for module in (cuda_forward, cuda_adjoint, cuda_viterbi, cuda_mxu):
        module.reset_launches()
    with torch.no_grad():
        ll = layer.log_likelihood(X.to(cuda))
    torch.testing.assert_close(ll.cpu(), cpu.log_likelihood(X), rtol=1e-5, atol=1e-4)
    for objective, atol in ((lambda lay, x: -lay.log_likelihood(x).mean(), 1e-4), (HMMLayer.loss, 5e-3)):
        grads = []
        for lay, x in ((layer, X.to(cuda)), (cpu, X)):
            pars = [p for p in lay.parameters() if p.requires_grad]
            grads.append(torch.autograd.grad(objective(lay, x), pars))
        for a, b in zip(*grads):
            scale = float(b.abs().max()) or 1.0
            np.testing.assert_allclose(a.cpu().numpy() / scale, b.numpy() / scale, atol=atol)
    assert cuda_forward.LAUNCHES == {"sum_chunk_summaries": 0, "sum_fwd_outputs": 0, "beta_bwd_outputs": 0,
                                     "sum_forward_wide": 5, "sum_backward_wide": 2}
    for module in (cuda_adjoint, cuda_viterbi, cuda_mxu):
        assert not any(module.LAUNCHES.values())


def test_profile_decode_takes_blocked_kernels(cuda, monkeypatch):
    """The q = 51 decode of align (one model, Lm = 24) runs K7b + K8b once
    each; its paths equal the same glue on the plain versions on the card
    and the sequential decode's score."""
    layer = _profile_layer([24], cuda)
    X = _protein_inputs(2, 1, 16, 90).to(cuda)
    with torch.inference_mode():
        cuda_viterbi.reset_launches()
        paths = layer.viterbi(X)
        assert cuda_viterbi.LAUNCHES["maxplus_deltas_blocked"] == 1
        assert cuda_viterbi.LAUNCHES["maxplus_backtrace_blocked"] == 1
        init, A = layer.transitions.matrices()
        E = layer.emission_probs(X)
        seq = recursion._viterbi_seq(init, A, E)
        monkeypatch.setattr(cuda_viterbi, "maxplus_deltas_seq", cuda_viterbi.maxplus_deltas_seq_plain)
        monkeypatch.setattr(cuda_viterbi, "maxplus_backtrace_seq", cuda_viterbi.maxplus_backtrace_seq_plain)
        plain = recursion._viterbi_seq_kernels(init, A, E)
    assert torch.equal(paths, plain)
    s_k, used_k = _path_score64(init, A, E, paths)
    s_s, _ = _path_score64(init, A, E, seq)
    assert used_k.all()
    torch.testing.assert_close(s_k, s_s, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# The multi-device routes on the card (one-rank meshes: no process group,
# every collective the identity)
# ---------------------------------------------------------------------------


def test_seq_route_backward_takes_the_affine_kernels(cuda, monkeypatch):
    """The sequence route's posterior VJP runs its two stacked affine
    solves through K4 and K5 on CUDA at q <= 15 (as the JAX route reaches
    the Pallas kernels), and its gradients equal the plain solves'."""
    from hmm_layer_torch.parallel import make_mesh, seq_sharded_posterior

    rng = np.random.default_rng(5)
    init, A, E = (torch.as_tensor(x[None], device=cuda) for x in random_hmm(rng, Q, 120, b=3))
    W = torch.as_tensor(rng.normal(size=E.shape), dtype=torch.float32, device=cuda)
    mesh = make_mesh({"seq": 1})

    def grads():
        xs = [t.clone().requires_grad_() for t in (init, A, E)]
        lg, ll = seq_sharded_posterior(*xs, mesh, local_parallel_factor=4)
        return torch.autograd.grad((lg * W).sum() + ll.sum(), xs)

    cuda_adjoint.reset_launches()
    kern = grads()
    assert cuda_adjoint.LAUNCHES == {"affine_chunk_composites": 1, "affine_reverse_outputs": 1}
    monkeypatch.setattr(recursion, "_use_affine_kernels", lambda x: False)
    plain = grads()
    for a, b in zip(kern, plain):
        scale = float(b.abs().max()) or 1.0
        np.testing.assert_allclose(a.cpu().numpy() / scale, b.cpu().numpy() / scale, atol=1e-5)


def test_data_route_runs_the_layer_kernels(cuda):
    """``partition={"batch": "data"}`` runs the layer's own engine on the
    rank's rows: K1–K3 for the posterior, K6–K8 for the decode, K4–K5 in
    the CE backward; equal to the dense layer."""
    from hmm_layer_torch.parallel import make_mesh

    torch.manual_seed(0)
    dense = HMMLayer(GenePredTransitions(), GenePredEmissions(**CODONS), parallel_factor=3)
    routed = HMMLayer(GenePredTransitions(), GenePredEmissions(**CODONS), parallel_factor=3,
                      mesh=make_mesh({"data": 1}), partition={"batch": "data"})
    routed.load_state_dict(dense.state_dict())
    rng = np.random.default_rng(6)
    cls = rng.dirichlet(np.ones(15), size=(1, 4, 99))
    nuc = np.eye(5)[rng.integers(0, 4, size=(1, 4, 99))]
    X = torch.as_tensor(np.concatenate([cls, nuc], -1), dtype=torch.float32, device=cuda)
    labels = torch.as_tensor(rng.integers(0, 15, size=(1, 4, 99)), device=cuda)
    for module in (cuda_forward, cuda_adjoint, cuda_viterbi):
        module.reset_launches()
    with torch.inference_mode():
        lg = routed.state_posterior_log_probs(X)
        path = routed.viterbi(X)
    loss = routed.posterior_cross_entropy(X, labels)
    g = torch.autograd.grad(loss, list(routed.parameters()))
    assert cuda_forward.LAUNCHES == {"sum_chunk_summaries": 2, "sum_fwd_outputs": 2, "beta_bwd_outputs": 2,
                                     "sum_forward_wide": 0, "sum_backward_wide": 0}
    assert cuda_adjoint.LAUNCHES == {"affine_chunk_composites": 1, "affine_reverse_outputs": 1}
    assert all(cuda_viterbi.LAUNCHES[k] == 1 for k in ("maxplus_chunk_summaries", "maxplus_deltas", "maxplus_backtrace"))
    with torch.inference_mode():
        assert torch.equal(lg, dense.state_posterior_log_probs(X))
        assert torch.equal(path, dense.viterbi(X))
    ref = torch.autograd.grad(dense.posterior_cross_entropy(X, labels), list(dense.parameters()))
    for a, b in zip(g, ref):
        assert torch.equal(a, b)


def test_edge_sharded_routes_equal_the_sparse_engine(cuda):
    """The edge-sharded routes on a one-rank mesh ``{"state": 1}`` (one
    bucket holding every edge in the single-device order): the
    log-likelihood, posterior and decode and the MAP gradients equal
    ``ops.sparse``'s on the card, and no kernel K1–K9 launches."""
    from hmm_layer_torch.ops import sparse
    from hmm_layer_torch.parallel import edge_sharded_log_likelihood, edge_sharded_posterior, edge_sharded_viterbi
    from hmm_layer_torch.parallel import make_mesh

    indices, init, probs, E, _, _ = _sparse_problem(L=64)
    init, probs, E = (x.to(cuda) for x in (init, probs, E))
    mesh = make_mesh({"state": 1})
    for module in (cuda_forward, cuda_adjoint, cuda_viterbi, cuda_mxu):
        module.reset_launches()
    assert torch.equal(edge_sharded_log_likelihood(init, indices, probs, E, mesh),
                       sparse.sparse_log_likelihood(init, indices, probs, E))
    for got, ref in zip(edge_sharded_posterior(init, indices, probs, E, mesh),
                        sparse.sparse_posterior(init, indices, probs, E, analytic_vjp=False)):
        assert torch.equal(got, ref)
    paths = edge_sharded_viterbi(init, indices, probs, E, mesh)
    assert torch.equal(paths, sparse.sparse_viterbi(init, indices, probs, E))
    grads = []
    for fn in (lambda *a: edge_sharded_log_likelihood(*a[:1], indices, *a[1:], mesh),
               lambda *a: sparse.sparse_log_likelihood(a[0], indices, *a[1:])):
        xs = [x.clone().requires_grad_() for x in (init, probs, E)]
        grads.append(torch.autograd.grad(fn(*xs).sum(), xs))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for module in (cuda_forward, cuda_adjoint, cuda_viterbi, cuda_mxu):
        assert not any(module.LAUNCHES.values())


@pytest.mark.parametrize("strand", ["+", "-"])
def test_decode_contig_cuda_windows_equal_the_host_built_batches(cuda, strand):
    """A 3-batch contig (the last batch with fill windows) decoded through
    ``cli.decode_contig``'s CUDA route gives the track that the host-built
    ``data.window_batches`` inputs give through the same layer, bit for
    bit, and opens ``hmm.predict.upload`` once a batch."""
    from hmm_layer_torch import cli, data
    from hmm_layer_torch.utils import profiling

    window, batch, overlap = 400, 4, 64
    L = 10 * (window - overlap) + overlap - 5  # 10 windows
    rng = np.random.default_rng(6)
    enc = data.encode_dna("".join(rng.choice(list("ACGT"), L)))
    enc = data.revcomp_onehot(enc) if strand == "-" else enc
    cls = rng.dirichlet(np.ones(15) * 0.3, L).astype(np.float32)
    layer = cli._gene_pred_layer(8, cuda)
    with torch.inference_mode():
        ref = stitched_track_np(layer.viterbi, enc, cls, window, batch, overlap)
        with profiling.span("hmm.test"):  # opened with the profiler off: ends the older session
            pass
        with torch.profiler.profile():
            got = cli.decode_contig(layer.viterbi, enc, cls, window, batch, overlap)
    names = [r.name for r in profiling.recorded_spans()]
    assert names.count("hmm.predict.upload") == names.count("hmm.predict.decode") == 3
    assert len(set(got.tolist())) > 1
    np.testing.assert_array_equal(got, ref)
