"""The port's HMMLayer end to end against the JAX HMMLayer on the same
converted parameters: emission scoring, posterior, log-likelihood and the
forward/backward recursions of the flagship gene-pred model."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hmm_layer_tpu.layer import HMMLayer as JaxHMMLayer
from hmm_layer_tpu.models import GenePredEmissions as JaxEmissions
from hmm_layer_tpu.models import GenePredTransitions as JaxTransitions
from hmm_layer_torch import HMMLayer, load_jax_params, params_from_jax
from hmm_layer_torch.models import GenePredEmissions, GenePredTransitions


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
B, L = 2, 64


def _inputs(seed, b=B, L=L):
    rng = np.random.default_rng(seed)
    cls = rng.dirichlet(np.ones(15), size=(1, b, L)).astype(np.float32)
    nuc = np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=(1, b, L))]
    return np.concatenate([cls, nuc], axis=-1)


def _layers(pf, trained=True):
    """The JAX layer with its params, and the port's layer holding the same
    params (random ones when ``trained``, the default init otherwise)."""
    jl = JaxHMMLayer(JaxTransitions(), JaxEmissions(**CODONS), use_prior=False, parallel_factor=pf)
    params = jax.device_get(jl.init_params(jax.random.PRNGKey(0), 15))
    if trained:
        rng = np.random.default_rng(1)
        params = jax.tree.map(
            lambda x: np.asarray(x) + rng.normal(0, 0.5, size=np.shape(x)).astype(np.float32),
            params,
        )
    tl = HMMLayer(
        GenePredTransitions(), GenePredEmissions(**CODONS), use_prior=False,
        parallel_factor=pf, device="cpu",
    )
    load_jax_params(tl, params)
    return jl, params, tl


@pytest.mark.parametrize("pf", [1, 4, "auto"])
def test_posterior_and_loglik_match_jax(pf):
    jl, params, tl = _layers(pf)
    X = _inputs(0)
    lg_j = np.asarray(jl.state_posterior_log_probs(params, jnp.asarray(X)))
    ll_j = np.asarray(jl.log_likelihood(params, jnp.asarray(X)))
    with torch.no_grad():
        lg_t = tl.state_posterior_log_probs(X).numpy()
        ll_t = tl.log_likelihood(X).numpy()
    np.testing.assert_allclose(ll_t, ll_j, rtol=2e-4)
    np.testing.assert_allclose(lg_t, lg_j, rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(
        torch.logsumexp(torch.from_numpy(lg_t), -1).numpy(), 0.0, atol=1e-3
    )


def test_flagship_entry_shape_matches_jax():
    """``__graft_entry__.entry()``'s posterior decode: b=4, L=512, pf=8."""
    jl, params, tl = _layers(8, trained=False)
    X = _inputs(2, b=4, L=512)
    lg_j = np.asarray(jl.state_posterior_log_probs(params, jnp.asarray(X)))
    with torch.no_grad():
        lg_t = tl.state_posterior_log_probs(X).numpy()
    np.testing.assert_allclose(lg_t, lg_j, rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("pf", [1, 8])
def test_recursions_no_loglik_and_end_hints_match_jax(pf):
    jl, params, tl = _layers(pf)
    X = _inputs(3)
    hints = np.random.default_rng(4).uniform(0.1, 1, size=(1, B, 2, 15)).astype(np.float32)
    Xj, hj = jnp.asarray(X), jnp.asarray(hints)
    with torch.no_grad():
        la_t, ll_t = tl.forward_recursion(X, end_hints=hints)
        lb_t = tl.backward_recursion(X, end_hints=hints)
        lg_t = tl.state_posterior_log_probs(X, end_hints=hints, no_loglik=True)
        E_t = tl.emission_probs(X, end_hints=hints, training=True)
    la_j, ll_j = jl.forward_recursion(params, Xj, end_hints=hj)
    lb_j = jl.backward_recursion(params, Xj, end_hints=hj)
    lg_j = jl.state_posterior_log_probs(params, Xj, end_hints=hj, no_loglik=True)
    E_j = jl.emission_probs(params, Xj, end_hints=hj, training=True)
    np.testing.assert_allclose(E_t.numpy(), np.asarray(E_j), rtol=1e-5, atol=0)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=2e-4)
    for got, ref in ((la_t, la_j), (lb_t, lb_j), (lg_t, lg_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize(
    "method", ["forward_recursion", "backward_recursion", "state_posterior_log_probs"]
)
def test_return_prior_matches_jax(method):
    """``return_prior=True`` appends the unscaled prior and the aux loss to
    the recursion's outputs, in the JAX layer's tuple order."""
    jl, params, tl = _layers(4)
    X = _inputs(7)
    ref = getattr(jl, method)(params, jnp.asarray(X), return_prior=True)
    with torch.no_grad():
        got = getattr(tl, method)(X, return_prior=True)
    assert len(got) == len(ref)
    *outs, prior, aux = got
    *outs_j, prior_j, aux_j = ref
    assert tuple(prior.shape) == np.shape(prior_j) and aux.dim() == np.ndim(aux_j) == 0
    np.testing.assert_allclose(prior.numpy(), np.asarray(prior_j), rtol=1e-5, atol=0)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-5, atol=0)
    for o, o_j in zip(outs, outs_j):
        rtol, atol = (2e-4, 0) if o.dim() == 2 else (1e-3, 2e-3)  # loglik / log-space arrays
        np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=rtol, atol=atol)
    with torch.no_grad():
        plain = getattr(tl, method)(X)
    for o, p in zip(outs, plain if isinstance(plain, tuple) else (plain,)):
        torch.testing.assert_close(o, p, rtol=0, atol=0)


def test_default_init_equals_jax_init():
    jl = JaxHMMLayer(JaxTransitions(), JaxEmissions(**CODONS), use_prior=False)
    params = jax.device_get(jl.init_params(jax.random.PRNGKey(0), 15))
    tl = HMMLayer(GenePredTransitions(), GenePredEmissions(**CODONS), use_prior=False, device="cpu")
    converted = params_from_jax(params)
    state = tl.state_dict()
    assert sorted(state) == sorted(converted)
    for name, value in converted.items():
        torch.testing.assert_close(state[name], value, rtol=0, atol=0)
    assert tl.get_config() == jl.get_config()


def test_gradients_flow_through_cpu_plain_path():
    _, _, tl = _layers(4)
    tl.log_likelihood(_inputs(5)).sum().backward()
    for name, p in tl.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HMMLayer(GenePredTransitions(), GenePredEmissions(**CODONS))


def test_bad_parallel_factor_raises():
    with pytest.raises(ValueError, match="parallel_factor"):
        HMMLayer(GenePredTransitions(), GenePredEmissions(**CODONS), parallel_factor=0, device="cpu")


def test_inputs_follow_the_layer_device():
    _, _, tl = _layers(4)
    out = tl.log_likelihood(torch.from_numpy(_inputs(6)).double())
    assert out.dtype == torch.float32 and out.device == tl.device


def _route_case(name):
    """(layer, inputs) of each model family the dense route serves."""
    from hmm_layer_torch import models as tm
    from hmm_layer_torch.models.initializers import make_15_class_emission_kernel

    torch.manual_seed(0)
    rng = np.random.default_rng(3)
    if name.startswith("profile"):
        lengths = [12, 16]  # the Plan7 matvec and the dense engine differ in float32 bits here
        layer = HMMLayer(tm.ProfileTransitions(lengths, structured_forward=name.endswith("structured")),
                         tm.ProfileEmissions(lengths), use_prior=True, num_seqs=50, device="cpu")
        return layer, rng.dirichlet(np.ones(26), (len(lengths), 2, 60)).astype(np.float32)
    pf = 1 if name.endswith("pf1") else "auto"
    k = 2 if name.startswith("multicopy") else 1
    transitions = (tm.GenePredMultiTransitions(k=k, sparse_forward=name.endswith("sparse")) if k > 1
                   else GenePredTransitions())
    emissions = GenePredEmissions(num_copies=k, init=make_15_class_emission_kernel(num_copies=k), **CODONS)
    layer = HMMLayer(transitions, emissions, use_prior=False,
                     parallel_factor=pf, device="cpu")
    return layer, _inputs(4, b=2, L=600)


@pytest.mark.parametrize(
    "name", ["genepred-auto", "genepred-pf1", "multicopy-k2", "profile-structured", "profile-dense",
             "multicopy-k2-sparse"]
)
def test_dense_route_is_the_engine(name):
    """On the dense route (no mesh) the public methods are bit-equal to the
    engine called directly on ``emission_probs(X)`` at the layer's parallel
    factor: the recursions (the Plan7 matvec for a structured profile
    log-likelihood), or the sparse engine for sparse-forward transitions."""
    from hmm_layer_torch.ops import plan7, recursion
    from hmm_layer_torch.ops import sparse as sparse_ops

    layer, X = _route_case(name)
    with torch.no_grad():
        E = layer.emission_probs(X)
        pf, pf_v = layer._pf(E), layer._pf(E, for_viterbi=True)
        t = layer.transitions
        if getattr(t, "sparse_forward", False):
            init, (idx, probs) = t.make_initial_distribution(), t.make_A_sparse()
            want = {"viterbi": sparse_ops.sparse_viterbi(init, idx, probs, E),
                    "loglik": sparse_ops.sparse_log_likelihood(init, idx, probs, E),
                    "posterior": sparse_ops.sparse_posterior(init, idx, probs, E)[0]}
        else:
            init, A = t.matrices()
            structured = getattr(t, "structured_forward", False) and pf == 1
            want = {"viterbi": recursion.viterbi(init, A, E, pf_v),
                    "loglik": plan7.structured_log_likelihood(t, E) if structured
                    else recursion.log_likelihood(init, A, E, pf),
                    "posterior": recursion.posterior(init, A, E, pf)[0]}
        got = {"viterbi": layer.viterbi(X), "loglik": layer.log_likelihood(X),
               "posterior": layer.state_posterior_log_probs(X)}
    for key in want:
        assert torch.equal(got[key], want[key]), key
