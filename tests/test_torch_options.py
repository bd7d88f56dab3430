"""The gene-prediction options of the port against the JAX package on the
same parameters and inputs: the MVN embedding emissions (both covariance
modes, with the bijectors and ``MvnMixture`` under them), the one-hot
codon lookup, trainable exon nucleotides, the experimental Dirichlet
transition prior (its concentration carried across with
``set_prior_alpha``), ``duplicate``, config round trips, and a layer with
every option on: posterior, CE and MAP values and gradients."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hmm_layer_tpu.layer import HMMLayer as JaxHMMLayer
from hmm_layer_tpu.models import GenePredEmissions as JaxEmissions
from hmm_layer_tpu.models import GenePredTransitions as JaxTransitions
from hmm_layer_tpu.models import SimpleGenePredEmissions as JaxSimpleEmissions
from hmm_layer_tpu.models import mvn as jmvn
from hmm_layer_tpu.utils import bijectors as jbij
from hmm_layer_torch import HMMLayer, load_jax_params, params_from_jax, set_prior_alpha
from hmm_layer_torch import models as tm
from hmm_layer_torch.models import mvn as tmvn
from hmm_layer_torch.utils import bijectors as tbij


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
D = 4  # embedding width
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed, b=2, L=40, dim=D, nucleotides=True, n_frac=0.0):
    """(1, b, L, 15 [+ dim] [+ 5]): class probabilities, embeddings, one-hot
    ACGTN (an ``n_frac`` share of N)."""
    rng = np.random.default_rng(seed)
    parts = [rng.dirichlet(np.ones(15), size=(1, b, L))]
    if dim:
        parts.append(rng.normal(0, 1.5, size=(1, b, L, dim)))
    if nucleotides:
        idx = rng.integers(0, 4, size=(1, b, L))
        idx[rng.uniform(size=idx.shape) < n_frac] = 4
        parts.append(np.eye(5)[idx])
    return np.concatenate(parts, axis=-1).astype(np.float32)


@pytest.fixture(autouse=True)
def broadcast_solve(monkeypatch):
    """jax 0.9's ``solve_triangular`` refuses batch axes that broadcast
    (1 against n), and the JAX MVN's full-covariance path passes such axes
    (one scale matrix for all positions), so it raises there. Broadcast
    them before the call: the same solves, for the JAX side of these
    tests only."""
    solve = jax.scipy.linalg.solve_triangular

    def broadcasting_solve(a, b, **kwargs):
        batch = jnp.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        return solve(jnp.broadcast_to(a, batch + a.shape[-2:]),
                     jnp.broadcast_to(b, batch + b.shape[-2:]), **kwargs)

    monkeypatch.setattr(jax.scipy.linalg, "solve_triangular", broadcasting_solve)


def _perturbed(params, seed, sd=0.4):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, sd, size=np.shape(x)).astype(np.float32),
        jax.device_get(params),
    )


def _load(module, params):
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return module


# ---------------------------------------------------------------------------
# bijectors and MvnMixture
# ---------------------------------------------------------------------------


def test_bijectors_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 10)).astype(np.float32)
    np.testing.assert_allclose(
        tbij.inverse_softplus(torch.tensor([0.3, 2.0, 40.0])).numpy(),
        np.asarray(jbij.inverse_softplus(jnp.asarray([0.3, 2.0, 40.0]))), **TOL,
    )
    for upper in (False, True):
        got = tbij.fill_triangular(torch.from_numpy(x), upper=upper)
        ref = np.asarray(jbij.fill_triangular(jnp.asarray(x), upper=upper))
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(tbij.fill_triangular_inverse(got, upper=upper).numpy(), x)
    with pytest.raises(ValueError, match="triangular"):
        tbij.fill_triangular(torch.zeros(7))
    jb, tb = jbij.DefaultDiagBijector(0.7), tbij.DefaultDiagBijector(0.7)
    assert tb.scale_diag_init == pytest.approx(jb.scale_diag_init, rel=1e-6)
    tril_t = tbij.FillScaleTriL(tb).forward(torch.from_numpy(x))
    tril_j = jbij.FillScaleTriL(jb).forward(jnp.asarray(x))
    np.testing.assert_allclose(tril_t.numpy(), np.asarray(tril_j), **TOL)
    np.testing.assert_allclose(tbij.FillScaleTriL(tb).inverse(tril_t).numpy(), x, rtol=1e-4, atol=1e-5)
    mean = rng.normal(size=(2, 4)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=(2, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tbij.make_kernel(mean, scale, tb).numpy(),
        np.asarray(jbij.make_kernel(mean, scale, jb)), **TOL,
    )
    np.testing.assert_allclose(
        tbij.make_kernel(mean, tril_t[0, :2], tb).numpy(),
        np.asarray(jbij.make_kernel(mean, np.asarray(tril_j[0, :2]), jb)), rtol=1e-4, atol=1e-5,
    )


@pytest.mark.parametrize("diag_only", [True, False], ids=["diag", "full"])
@pytest.mark.parametrize("components", [1, 3])
def test_mvn_mixture_matches_jax(diag_only, components):
    rng = np.random.default_rng(2)
    jm_, tm_ = (mod.MvnMixture(D, diag_only=diag_only, diag_bijector=bij.DefaultDiagBijector(0.8))
                for mod, bij in ((jmvn, jbij), (tmvn, tbij)))
    kernel = rng.normal(0, 0.3, size=(1, 5, components, jm_.num_params())).astype(np.float32)
    mix = rng.normal(size=(1, 5, components)).astype(np.float32) if components > 1 else None
    x = rng.normal(0, 1.5, size=(1, 7, D)).astype(np.float32)
    got = tm_.log_pdf(torch.from_numpy(kernel), torch.from_numpy(x),
                      None if mix is None else torch.from_numpy(mix))
    ref = jm_.log_pdf(jnp.asarray(kernel), jnp.asarray(x), None if mix is None else jnp.asarray(mix))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for name in ("component_expectations", "component_scale_diag", "component_covariances",
                 "regularization_l2_loss"):
        np.testing.assert_allclose(
            getattr(tm_, name)(torch.from_numpy(kernel)).numpy(),
            np.asarray(getattr(jm_, name)(jnp.asarray(kernel))), **TOL,
        )
    if mix is not None:
        np.testing.assert_allclose(
            tm_.expectation(torch.from_numpy(kernel), torch.from_numpy(mix)).numpy(),
            np.asarray(jm_.expectation(jnp.asarray(kernel), jnp.asarray(mix))), **TOL,
        )
        with pytest.raises(ValueError, match="mixture_kernel"):
            tm_.log_pdf(torch.from_numpy(kernel), torch.from_numpy(x))


# ---------------------------------------------------------------------------
# emitters
# ---------------------------------------------------------------------------

EMITTERS = [
    pytest.param(dict(emit_embeddings=True, embedding_dim=D), True, id="embed-diag"),
    pytest.param(dict(emit_embeddings=True, embedding_dim=D, full_covariance=True,
                      initial_variance=0.5, temperature=2.0), True, id="embed-full"),
    pytest.param(dict(emit_embeddings=True, embedding_dim=D, share_intron_parameters=False),
                 False, id="simple-embed-diag"),
    pytest.param(dict(onehot_lookup_kmers=True), True, id="lookup"),
    pytest.param(dict(trainable_nucleotides_at_exons=True), True, id="exon-nucs"),
    pytest.param(dict(trainable_nucleotides_at_exons=True, onehot_lookup_kmers=True,
                      emit_embeddings=True, embedding_dim=D, num_copies=2), True, id="all-k2"),
]


def _emitters(kwargs, gene_pred):
    if gene_pred:
        je = JaxEmissions(**CODONS, **kwargs)
        te = tm.GenePredEmissions(**CODONS, **kwargs, input_dim=15)
    else:
        je, te = JaxSimpleEmissions(**kwargs), tm.SimpleGenePredEmissions(**kwargs, input_dim=15)
    params = _perturbed(je.init_params(jax.random.PRNGKey(3), 15), 4)
    return je, params, _load(te, params)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("kwargs,gene_pred", EMITTERS)
def test_emissions_and_aux_loss_match_jax(kwargs, gene_pred, training):
    je, params, te = _emitters(kwargs, gene_pred)
    dim = kwargs.get("embedding_dim") or 0
    X = _inputs(5, dim=dim, nucleotides=gene_pred, n_frac=0.1)
    got = te.emissions(torch.from_numpy(X), training=training)
    ref = je.emissions({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(X), training=training)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(float(te.aux_loss().detach()), float(je.aux_loss(params)), **TOL)
    assert te.get_config() == {k: v for k, v in je.get_config().items()}
    assert type(te).from_config(te.get_config()).get_config() == te.get_config()


def test_embedding_shift_carries_no_gradient_through_the_max():
    """The per-position max of the log-density is detached: the gradient
    of the embedding kernel matches JAX's (``lax.stop_gradient``)."""
    je, params, te = _emitters(dict(emit_embeddings=True, embedding_dim=D), True)
    X = _inputs(6, dim=D)
    w = np.random.default_rng(7).normal(size=(1, 2, 40, 15)).astype(np.float32)

    def jax_obj(p):
        return jnp.sum(jnp.log(je.emissions(p, jnp.asarray(X), training=True)) * w)

    ref = jax.grad(jax_obj)({k: jnp.asarray(v) for k, v in params.items()})
    obj = (torch.log(te.emissions(torch.from_numpy(X), training=True)) * torch.from_numpy(w)).sum()
    got = torch.autograd.grad(obj, [te.emission_kernel, te.embedding_emission_kernel])
    for g, name in zip(got, ("emission_kernel", "embedding_emission_kernel")):
        scale = float(np.abs(ref[name]).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[name]), rtol=1e-4, atol=1e-5 * scale)


def test_codon_lookup_matches_contraction_and_keeps_class_gradients():
    lookup = tm.GenePredEmissions(**CODONS, onehot_lookup_kmers=True, input_dim=15)
    einsum = tm.GenePredEmissions(**CODONS, compute_kmers_in_bf16=False, input_dim=15)
    X = torch.from_numpy(_inputs(8, dim=0, n_frac=0.2)).requires_grad_(True)
    a, b = lookup.emissions(X), einsum.emissions(X)
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-6, atol=1e-12)
    ga, gb = (torch.autograd.grad(e.log().sum(), X)[0] for e in (a, b))
    np.testing.assert_allclose(ga[..., :15].numpy(), gb[..., :15].numpy(), rtol=1e-5, atol=1e-6)
    assert float(ga[..., 15:].abs().max()) == 0.0  # nucleotides index a gather


@pytest.mark.parametrize("share", [True, False], ids=["shared", "copied"])
def test_duplicate(share):
    je, params, te = _emitters(dict(emit_embeddings=True, embedding_dim=D,
                                    trainable_nucleotides_at_exons=True), True)
    copy = te.duplicate(share_kernels=share)
    jcopy, jparams = je.duplicate(params, share_kernels=share)
    assert copy.get_config() == te.get_config() == jcopy.get_config()
    X = torch.from_numpy(_inputs(9))
    np.testing.assert_array_equal(copy.emissions(X).detach().numpy(), te.emissions(X).detach().numpy())
    for (name, p), (_, p0) in zip(copy.named_parameters(), te.named_parameters()):
        assert (p is p0) == share, name
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jparams[name]))
    with torch.no_grad():
        te.embedding_emission_kernel.add_(1.0)
    moved = not torch.equal(copy.emissions(X), te.emissions(X))
    assert moved != share


# ---------------------------------------------------------------------------
# the experimental Dirichlet transition prior
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls_kwargs", [dict(), dict(k=2)], ids=["k1", "multi-k2"])
def test_experimental_prior_matches_jax(cls_kwargs):
    from hmm_layer_tpu import models as jm

    if cls_kwargs:
        jt = jm.GenePredMultiTransitions(use_experimental_prior=True, **cls_kwargs)
        tt = tm.GenePredMultiTransitions(use_experimental_prior=True,
                                         generator=torch.Generator().manual_seed(0), **cls_kwargs)
    else:
        jt, tt = JaxTransitions(use_experimental_prior=True), tm.GenePredTransitions(use_experimental_prior=True)
        # No noise at init_component_sd = 0: the port's own alpha is JAX's.
        np.testing.assert_allclose(tt.prior_alpha.numpy(), np.asarray(jt.make_prior_alpha(
            jax.random.PRNGKey(5))), **TOL)
    params = _perturbed(jt.init_params(jax.random.PRNGKey(1)), 2, sd=0.5)
    _load(tt, params)
    set_prior_alpha(tt, np.asarray(jt._prior_alpha()))
    assert tt.prior_alpha.shape == (1 + 6 * tt.k, 2)
    assert "prior_alpha" not in tt.state_dict()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    value, grads = jax.value_and_grad(lambda p: jt.prior_log_density(p).sum())(jp)
    prior = tt.prior_log_density()
    np.testing.assert_allclose(prior.detach().numpy(), np.asarray(jt.prior_log_density(jp)), rtol=1e-5, atol=1e-6)
    got = torch.autograd.grad(prior.sum(), [tt.transition_kernel])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(grads["transition_kernel"]),
                               rtol=1e-4, atol=1e-5 * float(np.abs(grads["transition_kernel"]).max()))
    assert tt.get_config() == jt.get_config()
    with pytest.raises(ValueError, match="shape"):
        set_prior_alpha(tt, np.ones((3, 2)))
    with pytest.raises(ValueError, match="experimental prior"):
        set_prior_alpha(tm.GenePredTransitions(), np.ones((7, 2)))


def test_prior_alpha_follows_the_generator():
    """With transition noise the concentration is drawn after the kernel,
    from the same generator, and ``reset_parameters`` redraws both."""
    def make(seed):
        return tm.GenePredTransitions(use_experimental_prior=True, init_component_sd=0.3,
                                      generator=torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    assert torch.equal(a.prior_alpha, b.prior_alpha) and not torch.equal(a.prior_alpha, c.prior_alpha)
    assert torch.isfinite(a.prior_log_density()).all()
    a.reset_parameters(torch.Generator().manual_seed(1))
    torch.testing.assert_close(a.prior_alpha, c.prior_alpha, rtol=0, atol=0)
    torch.testing.assert_close(a.transition_kernel, c.transition_kernel, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# a layer with every option: posterior, CE and MAP against JAX
# ---------------------------------------------------------------------------

LAYER_EMITTERS = [
    pytest.param(dict(full_covariance=False, onehot_lookup_kmers=True), id="diag-lookup"),
    pytest.param(dict(full_covariance=True), id="full-einsum"),
]


def _option_layers(pf, em_kwargs):
    kwargs = dict(emit_embeddings=True, embedding_dim=D, trainable_nucleotides_at_exons=True,
                  **em_kwargs)
    jl = JaxHMMLayer(JaxTransitions(use_experimental_prior=True),
                     JaxEmissions(**CODONS, **kwargs), parallel_factor=pf, num_seqs=20)
    params = _perturbed(jl.init_params(jax.random.PRNGKey(0), 15), 1, sd=0.3)
    tl = HMMLayer(tm.GenePredTransitions(use_experimental_prior=True),
                  tm.GenePredEmissions(**CODONS, **kwargs, input_dim=15),
                  parallel_factor=pf, num_seqs=20, device="cpu")
    load_jax_params(tl, params)
    set_prior_alpha(tl, np.asarray(jl.transitions._prior_alpha()))
    return jl, params, tl


def _check_grads(jax_fn, params, port_value, tl, rtol, atol):
    value, grads = jax.value_and_grad(jax_fn)(params)
    np.testing.assert_allclose(float(port_value.detach()), float(value), rtol=rtol)
    ref = params_from_jax(jax.device_get(grads))
    pars = dict(tl.named_parameters())
    got = torch.autograd.grad(port_value, list(pars.values()))
    for name, g in zip(pars, got):
        scale = float(ref[name].abs().max())
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=rtol, atol=atol * max(scale, 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("pf", [1, 4])
@pytest.mark.parametrize("em_kwargs", LAYER_EMITTERS)
def test_option_layer_matches_jax(pf, em_kwargs):
    jl, params, tl = _option_layers(pf, em_kwargs)
    X = _inputs(11, L=48, n_frac=0.05)
    Xj = jnp.asarray(X)
    lg_t = tl.state_posterior_log_probs(X)
    lg_j = jl.state_posterior_log_probs(params, Xj)
    np.testing.assert_allclose(lg_t.detach().numpy(), np.asarray(lg_j), rtol=1e-3, atol=2e-3)

    rng = np.random.default_rng(12)
    labels = rng.integers(0, 15, size=(2, 48))
    mask = (rng.uniform(size=(2, 48)) > 0.3).astype(np.float32)
    _check_grads(
        lambda p: jl.posterior_cross_entropy(p, Xj, jnp.asarray(labels), jnp.asarray(mask)),
        params, tl.posterior_cross_entropy(X, labels, label_mask=mask), tl, rtol=1e-4, atol=1e-5,
    )
    _check_grads(lambda p: jl.loss(p, Xj), params, tl.loss(X), tl, rtol=1e-4, atol=1e-5)
    config = tl.get_config()
    assert config == jl.get_config() or _configs_equal(config, jl.get_config())
    rebuilt = HMMLayer.from_config(config, device="cpu")
    assert _configs_equal(rebuilt.get_config(), config)


def _configs_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_configs_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_configs_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return a == b
