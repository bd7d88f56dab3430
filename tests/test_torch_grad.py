"""The port's analytic gradients against the JAX package's on the same numpy
inputs: the chunked affine adjoint solver (plain route and the kernel
layout of K4–K5, whose wrappers take their plain versions on the CPU)
against the JAX solver with its Pallas kernels in interpret mode and its
XLA branch, and the gradients of ``log_likelihood``, ``forward``,
``backward`` and ``posterior`` at ``parallel_factor`` > 1 against
``jax.grad`` of the JAX functions."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hmm_layer_tpu.layer import HMMLayer as JaxHMMLayer
from hmm_layer_tpu.models import GenePredEmissions as JaxEmissions
from hmm_layer_tpu.models import GenePredTransitions as JaxTransitions
from hmm_layer_tpu.ops import pallas_adjoint, pallas_viterbi
from hmm_layer_tpu.ops import recursion as jrec
from hmm_layer_torch import HMMLayer, load_jax_params, params_from_jax
from hmm_layer_torch.models import GenePredEmissions, GenePredTransitions
from hmm_layer_torch.ops import cuda_adjoint, recursion
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


CODONS = dict(
    start_codons=[("ATG", 1.0)],
    stop_codons=[("TAG", 0.34), ("TAA", 0.33), ("TGA", 0.33)],
    intron_begin_pattern=[("NGT", 0.99), ("NGC", 0.005), ("NAT", 0.005)],
    intron_end_pattern=[("AGN", 0.99), ("ACN", 0.01)],
)


def _affine_inputs(seed, m, b, L, q):
    """B (m, q, q) row-stochastic, u, v in [0, 1] with v = 0 at t = L-1
    (terminal x_L = 0), s normal; as in tests/test_recursion.py."""
    rng = np.random.default_rng(seed)
    B = rng.dirichlet(np.ones(q), size=(m, q)).astype(np.float32)
    u = rng.uniform(0, 1, (m, b, L, q)).astype(np.float32)
    v = rng.uniform(0, 1, (m, b, L, q)).astype(np.float32)
    v[:, :, -1] = 0.0
    s = rng.normal(size=(m, b, L, q)).astype(np.float32)
    return B, u, v, s


def _port_affine_kernel_layout(B, u, v, s, P):
    """The solver through the kernel route's layout helpers (the K4/K5
    wrappers run their plain versions on the CPU)."""
    lanes, b = recursion._affine_kernel_lanes(u, v, s, P), s.shape[1]
    comp = recursion._affine_composites_kernels(B, lanes, b)
    rights = recursion._affine_boundary_fold(comp, torch.zeros_like(s[:, :, 0]))
    return recursion._affine_outputs_kernels(B, lanes, b, rights)


AFFINE_CASES = [
    pytest.param(2, 3, 24, 5, 4, id="m2-q5-P4"),
    pytest.param(1, 2, 6, 15, 1, id="q15-P1"),
    pytest.param(1, 2, 6, 3, 6, id="q3-P6"),
]


@pytest.mark.parametrize("m,b,L,q,P", AFFINE_CASES)
@pytest.mark.parametrize("route", ["plain", "kernel-layout"])
def test_chunked_affine_reverse_matches_jax(monkeypatch, route, m, b, L, q, P):
    args = _affine_inputs(3, m, b, L, q)
    t_args = tuple(map(torch.from_numpy, args))
    if route == "plain":
        got = recursion._chunked_affine_reverse(*t_args, P).numpy()
    else:
        got = _port_affine_kernel_layout(*t_args, P).numpy()
    j_args = tuple(map(jnp.asarray, args))
    with monkeypatch.context() as mp:
        mp.setattr(pallas_viterbi, "FORCE_INTERPRET", True)
        ref_pallas = np.asarray(jrec._chunked_affine_reverse(*j_args, P))
    ref_xla = np.asarray(jrec._chunked_affine_reverse(*j_args, P))  # XLA branch on the CPU
    for ref in (ref_pallas, ref_xla):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m,c,R,q", [(2, 6, 12, 5), (1, 4, 7, 15)])
def test_affine_plain_versions_match_pallas_kernels(m, c, R, q):
    """K4's and K5's plain versions against the Pallas kernels (interpret
    mode, lanes padded as the JAX route pads them: zeros)."""
    rng = np.random.default_rng(7)
    B = rng.dirichlet(np.ones(q), size=(m, q)).astype(np.float32)
    U, V = (rng.uniform(0, 1, (m, c, q, R)).astype(np.float32) for _ in range(2))
    S = rng.normal(size=(m, c, q, R)).astype(np.float32)
    x_right = rng.normal(size=(m, q, R)).astype(np.float32)
    comp = cuda_adjoint.affine_chunk_composites(*map(torch.from_numpy, (B, U, V, S))).numpy()
    x = cuda_adjoint.affine_reverse_outputs(*map(torch.from_numpy, (B, U, V, S, x_right))).numpy()
    R_pad = pallas_viterbi.pad_chunk_elements(R)

    def pad(a, rows=None):
        widths = [(0, 0)] * (a.ndim - 1) + [(0, R_pad - R)]
        if rows is not None:
            widths[-2] = (0, rows - a.shape[-2])
        return jnp.asarray(np.pad(a, widths))

    for mi in range(m):
        ref_comp = pallas_adjoint.affine_chunk_composites(
            jnp.asarray(B[mi]), pad(U[mi]), pad(V[mi]), pad(S[mi]), interpret=True
        )
        ref_x = pallas_adjoint.affine_reverse_outputs(
            jnp.asarray(B[mi]), pad(U[mi]), pad(V[mi]), pad(S[mi]),
            pad(x_right[mi], rows=pallas_viterbi.PAD), interpret=True,
        )
        np.testing.assert_allclose(comp[mi], np.asarray(ref_comp)[:R], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(x[mi], np.asarray(ref_x)[:, :q, :R], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Gradients of the public recursions
# ---------------------------------------------------------------------------


def _hmm(seed, m=2, b=2, L=24, q=5):
    rng = np.random.default_rng(seed)
    hmms = [random_hmm(rng, q=q, L=L, b=b) for _ in range(m)]
    init = np.stack([h[0] for h in hmms]).astype(np.float32)
    A = np.stack([h[1] for h in hmms]).astype(np.float32)
    E = np.stack([h[2] for h in hmms]).astype(np.float32)
    w = rng.normal(size=(m, b, L, q)).astype(np.float32)
    wl = rng.normal(size=(m, b)).astype(np.float32)
    return (init, A, E), w, wl


def _objective(fn, mod, w, wl, pf):
    """A weighted sum of every output of ``fn`` (so each cotangent is
    nonzero), for module ``mod`` (the port's or the JAX recursion)."""

    def loglik(i, a, e):
        return (wl * mod.log_likelihood(i, a, e, pf)).sum()

    def forward(i, a, e):
        la, ll = mod.forward(i, a, e, pf)
        return (w * la).sum() + (wl * ll).sum()

    def backward(i, a, e):
        return (w * mod.backward(i, a, e, pf)).sum()

    def posterior(no_loglik):
        def f(i, a, e):
            lg, ll = mod.posterior(i, a, e, pf, no_loglik=no_loglik)
            return (w * lg).sum() + (wl * ll).sum()

        return f

    return {
        "log_likelihood": loglik,
        "forward": forward,
        "backward": backward,
        "posterior": posterior(False),
        "posterior_no_loglik": posterior(True),
    }[fn]


def _port_grads(fn, hmm, w, wl, pf):
    ts = [torch.tensor(x, requires_grad=True) for x in hmm]
    f = _objective(fn, recursion, torch.from_numpy(w), torch.from_numpy(wl), pf)
    grads = torch.autograd.grad(f(*ts), ts, allow_unused=True)
    return [np.zeros_like(x) if g is None else g.numpy() for x, g in zip(hmm, grads)]


def _jax_grads(fn, hmm, w, wl, pf):
    f = _objective(fn, jrec, jnp.asarray(w), jnp.asarray(wl), pf)
    return [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*map(jnp.asarray, hmm))]


FNS = ["log_likelihood", "forward", "backward", "posterior", "posterior_no_loglik"]


@pytest.mark.parametrize("fn", FNS)
def test_chunked_grads_match_jax_same_route(fn):
    """P = 4 against P = 4: the same analytic VJP on both sides."""
    hmm, w, wl = _hmm(0)
    for got, ref in zip(_port_grads(fn, hmm, w, wl, 4), _jax_grads(fn, hmm, w, wl, 4)):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fn", FNS)
def test_chunked_grads_match_jax_sequential(fn):
    """The port at P = 4 against JAX at P = 1 (autodiff of the sequential
    scans; the analytic Baum-Welch VJP for the log-likelihood)."""
    hmm, w, wl = _hmm(1)
    for got, ref in zip(_port_grads(fn, hmm, w, wl, 4), _jax_grads(fn, hmm, w, wl, 1)):
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_sequential_analytic_loglik_vjp_matches_jax():
    hmm, w, wl = _hmm(2)
    for got, ref in zip(_port_grads("log_likelihood", hmm, w, wl, 1),
                        _jax_grads("log_likelihood", hmm, w, wl, 1)):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    ts = [torch.from_numpy(x).requires_grad_() for x in hmm]
    taped = recursion.log_likelihood(*ts, analytic_vjp=False)
    assert "LoglikSeq" not in type(taped.grad_fn).__name__
    g_taped = torch.autograd.grad((torch.from_numpy(wl) * taped).sum(), ts)
    for got, ref in zip(g_taped, _port_grads("log_likelihood", hmm, w, wl, 1)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_posterior_grad_matches_jax_pallas_adjoint(monkeypatch):
    """Against the JAX posterior VJP whose adjoint solves run the Pallas
    K4/K5 (and its primal K1–K3) in interpret mode."""
    monkeypatch.setattr(pallas_viterbi, "FORCE_INTERPRET", True)
    hmm, w, wl = _hmm(3, m=1)
    for got, ref in zip(_port_grads("posterior", hmm, w, wl, 4),
                        _jax_grads("posterior", hmm, w, wl, 4)):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def _gene_pred_layers(P):
    """The JAX gene-pred layer with random params around its init, and the
    port's layer holding the same params."""
    jl = JaxHMMLayer(JaxTransitions(), JaxEmissions(**CODONS), use_prior=False, parallel_factor=P)
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.5, size=np.shape(x)).astype(np.float32),
        jax.device_get(jl.init_params(jax.random.PRNGKey(0), 15)),
    )
    tl = HMMLayer(GenePredTransitions(), GenePredEmissions(**CODONS), use_prior=False,
                  parallel_factor=P, device="cpu")
    load_jax_params(tl, params)
    return jl, params, tl


@pytest.mark.parametrize("objective", ["ce", "map"])
def test_gene_pred_param_grads_match_jax_at_length(objective):
    """The real gene-pred model (q=15, exact zeros in A, codon-factor
    emissions) at L=1200, P=8: gradients of the posterior cross-entropy
    (with a label mask) and of the MAP loss with respect to every
    parameter, scale-normalised (5e-4 of the gradient's max) against the
    JAX XLA route; and no further from a float64 autograd oracle through
    the sequential engine than the JAX gradients are.

    Against that oracle both float32 engines are off by ~1e-3 of the max
    here: log alpha and log beta carry log-scales of |loglik| ~ 1.3e4,
    where float32 spacing is 2^-10, so gamma is good to ~1e-3 relative.
    """
    jl, params, tl = _gene_pred_layers(8)
    rng = np.random.default_rng(2)
    b, L = 2, 1200
    cls = rng.dirichlet(np.ones(15), size=(1, b, L)).astype(np.float32)
    nuc = np.eye(5, dtype=np.float32)[rng.integers(0, 4, size=(1, b, L))]
    X = np.concatenate([cls, nuc], axis=-1)
    labels = rng.integers(0, 15, size=(b, L))
    mask = (rng.uniform(size=(b, L)) > 0.2).astype(np.float32)

    def jax_loss(p):
        if objective == "ce":
            return jl.posterior_cross_entropy(p, jnp.asarray(X), jnp.asarray(labels),
                                              label_mask=jnp.asarray(mask))
        return jl.loss(p, jnp.asarray(X))

    _, jg = jax.jit(jax.value_and_grad(jax_loss))(params)
    jg = {name: np.asarray(g) for name, g in params_from_jax(jax.device_get(jg)).items()}
    pars = dict(tl.named_parameters())
    if objective == "ce":
        value = tl.posterior_cross_entropy(X, labels, label_mask=mask)
    else:
        value = tl.loss(X)
    got = dict(zip(pars, torch.autograd.grad(value, list(pars.values()))))

    # float64 oracle: the same float32 init, A and E, the sequential
    # recursion in float64, autograd back to the parameters.
    init, A = tl.transitions.matrices()
    E = tl.emission_probs(X, training=True)
    init, A, E = init.double(), A.double(), E.double()
    if objective == "ce":
        lg, _ = recursion.posterior(init, A, E, 1)
        ce = -torch.gather(lg, -1, torch.as_tensor(labels)[None, ..., None])[..., 0]
        m64 = torch.as_tensor(mask, dtype=torch.float64)[None]
        value64 = (ce * m64).sum() / m64.sum()
    else:
        value64 = -recursion.log_likelihood(init, A, E, 1, analytic_vjp=False).mean()
    oracle = dict(zip(pars, torch.autograd.grad(value64, list(pars.values()))))

    for name in pars:
        g, ref, g64 = got[name].numpy(), jg[name], oracle[name].numpy()
        assert np.abs(g - ref).max() <= 5e-4 * np.abs(ref).max(), name
        scale64 = np.abs(g64).max()
        port_err, jax_err = np.abs(g - g64).max() / scale64, np.abs(ref - g64).max() / scale64
        assert port_err <= 1.25 * jax_err + 1e-5, (name, port_err, jax_err)


def test_kernel_layout_vjp_matches_plain_route(monkeypatch):
    """The posterior VJP through the kernel route's layouts (K1–K5
    wrappers, plain versions on the CPU) equals the plain route's."""
    hmm, w, wl = _hmm(5)
    ref = _port_grads("posterior", hmm, w, wl, 4)
    monkeypatch.setattr(recursion, "_use_kernels", lambda E: True)
    monkeypatch.setattr(recursion, "_use_affine_kernels", lambda x: True)
    for got, r in zip(_port_grads("posterior", hmm, w, wl, 4), ref):
        np.testing.assert_allclose(got, r, rtol=1e-4, atol=1e-5)
    for got, r in zip(_port_grads("log_likelihood", hmm, w, wl, 4),
                      _jax_grads("log_likelihood", hmm, w, wl, 4)):
        np.testing.assert_allclose(got, r, rtol=1e-4, atol=1e-5)


def test_affine_wrappers_take_plain_version_on_cpu():
    B, u, v, s = (torch.from_numpy(x) for x in _affine_inputs(6, 1, 2, 8, 4))
    cuda_adjoint.reset_launches()
    _port_affine_kernel_layout(B, u, v, s, 2)
    assert cuda_adjoint.LAUNCHES == {name: 0 for name in cuda_adjoint.LAUNCHES}


def test_affine_wrappers_refuse_other_devices():
    B = torch.zeros((1, 5, 5), device="meta")
    U = torch.zeros((1, 4, 5, 6), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_adjoint.affine_chunk_composites(B, U, U, U)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_adjoint.affine_reverse_outputs(B, U, U, U, torch.zeros((1, 5, 6), device="meta"))


def test_affine_gate_mirrors_pallas():
    for q in (1, 5, 15, 16, 17):
        assert cuda_adjoint.supported(q) == pallas_adjoint.supported(q)


def test_no_grad_and_inference_mode_skip_the_graph():
    hmm, _, _ = _hmm(7)
    ts = [torch.from_numpy(x).requires_grad_() for x in hmm]
    with torch.no_grad():
        assert not recursion.posterior(*ts, 4)[0].requires_grad
    with torch.inference_mode():
        lg, ll = recursion.posterior(*ts, 4)
        assert torch.isfinite(lg).all() and ll.shape == (2, 2)
