"""Port model families (hmm_layer_torch.models) against the JAX package on
the same parameters and inputs: transition matrices, emissions, end hints
and the edge-softmax helpers."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hmm_layer_tpu import models as jm
from hmm_layer_tpu.models import emission_utils as jeu
from hmm_layer_tpu.models import gene_pred_emissions as jgpe
from hmm_layer_tpu.models import transition_utils as jtu
from hmm_layer_torch import models as tm
from hmm_layer_torch.models import emission_utils as teu
from hmm_layer_torch.models import transition_utils as ttu


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


def _state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


# ---------------------------------------------------------------------------
# transitions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "cls_name,kwargs",
    [
        ("SimpleGenePredTransitions", {}),
        ("GenePredTransitions", {}),
        ("GenePredTransitions", {"num_models": 3, "initial_exon_len": 50}),
    ],
)
def test_default_init_and_matrices_match_jax(cls_name, kwargs):
    jt = getattr(jm, cls_name)(**kwargs)
    tt = getattr(tm, cls_name)(**kwargs)
    params = jt.init_params(jax.random.PRNGKey(0))
    for name, value in _state(tt).items():
        np.testing.assert_array_equal(value, np.asarray(params[name]))
    init_j, A_j = jt.matrices(params)
    init_t, A_t = tt.matrices()
    np.testing.assert_allclose(init_t.detach().numpy(), np.asarray(init_j), atol=1e-7, rtol=0)
    np.testing.assert_allclose(A_t.detach().numpy(), np.asarray(A_j), atol=1e-7, rtol=0)
    assert tt.get_config() == jt.get_config()


def test_trained_kernels_give_same_matrices():
    jt, tt = jm.GenePredTransitions(), tm.GenePredTransitions()
    rng = np.random.default_rng(0)
    params = {
        "transition_kernel": rng.normal(0, 2, size=23).astype(np.float32),
        "starting_distribution_kernel": rng.normal(0, 1, size=15).astype(np.float32),
    }
    tt.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    init_j, A_j = jt.matrices({k: jnp.asarray(v) for k, v in params.items()})
    init_t, A_t = tt.matrices()
    np.testing.assert_allclose(init_t.detach().numpy(), np.asarray(init_j), atol=1e-7, rtol=0)
    np.testing.assert_allclose(A_t.detach().numpy(), np.asarray(A_j), atol=1e-7, rtol=0)
    # The gene-pred A has exact zeros off the grammar's edges.
    assert (A_t.detach().numpy()[0] == 0).sum() == 15 * 15 - 23


def test_init_component_sd_draws_noise_on_intergenic_out_edges():
    t = tm.GenePredTransitions(init_component_sd=0.5, generator=torch.Generator().manual_seed(0))
    base = tm.GenePredTransitions()
    diff = (t.transition_kernel - base.transition_kernel).detach().numpy()
    out_edges = [j for j, e in enumerate(t.indices) if e[0] == 0 and e[1] != 0]
    assert np.all(diff[out_edges] != 0)
    assert np.all(np.delete(diff, out_edges) == 0)


def test_unported_transition_options_raise():
    """Every transition option is ported: ``sparse_forward`` (held against
    JAX in ``tests/test_torch_sparse.py``) and the experimental prior (in
    ``tests/test_torch_options.py``). The sparse engine refuses an edge
    list that is not on the host."""
    t = tm.GenePredTransitions(sparse_forward=True)
    assert t.get_config()["sparse_forward"] is True
    from hmm_layer_torch.ops import sparse

    with pytest.raises(TypeError, match="host array"):
        sparse.EdgePlan.cached(t.edge_indices.to("meta"))
    t = tm.GenePredTransitions(use_experimental_prior=True)
    assert t.get_config()["use_experimental_prior"] is True
    assert torch.isfinite(t.prior_log_density()).all()


@pytest.mark.parametrize("lead", [(), (3,)])
def test_edge_softmax_helpers_match_jax(lead):
    indices = jm.GenePredTransitions().indices
    rng = np.random.default_rng(1)
    values = rng.normal(0, 3, size=lead + (len(indices),)).astype(np.float32)
    values[..., 0] = -np.inf  # an edge whose logit is -inf
    got = ttu.sparse_edge_softmax(indices, torch.from_numpy(values), 15).numpy()
    ref = np.asarray(jtu.sparse_edge_softmax(indices, jnp.asarray(values), 15))
    np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)
    dense = ttu.dense_from_edge_probs(indices, torch.tensor(ref), 15)
    np.testing.assert_array_equal(
        dense.numpy(), np.asarray(jtu.dense_from_edge_probs(indices, jnp.asarray(ref), 15))
    )
    np.testing.assert_array_equal(
        ttu.gather_edge_probs(dense, indices).numpy(), ref
    )


def test_masked_row_softmax_all_minus_inf_row_stays_finite():
    indices = np.array([[0, 0], [0, 1], [1, 0]])
    values = np.array([-np.inf, -np.inf, 0.5], np.float32)
    got = ttu.masked_row_softmax_from_edges(indices, torch.from_numpy(values), 2).numpy()
    ref = np.asarray(jtu.masked_row_softmax_from_edges(indices, jnp.asarray(values), 2))
    np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)
    assert np.isfinite(got).all()


# ---------------------------------------------------------------------------
# emissions
# ---------------------------------------------------------------------------


def _inputs(rng, m, b, L, s, soft_nucleotides):
    cls = rng.dirichlet(np.ones(s), size=(m, b, L)).astype(np.float32)
    if soft_nucleotides:
        nuc = rng.dirichlet(np.ones(5), size=(m, b, L)).astype(np.float32)
    else:
        nuc = np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=(m, b, L))]
    return np.concatenate([cls, nuc], axis=-1)


def _kernel(rng, em, s):
    shape = (em.num_models, em.num_param_states, s)
    return rng.normal(0, 1, size=shape).astype(np.float32)


@pytest.mark.parametrize(
    "soft,bf16,kwargs",
    [
        (False, True, {}),
        (True, True, {}),
        (True, False, {}),
        (False, True, {"num_copies": 2, "share_intron_parameters": False}),
        (False, True, {"num_models": 2}),
    ],
)
def test_gene_pred_emissions_match_jax(soft, bf16, kwargs):
    rng = np.random.default_rng(2)
    je = jm.GenePredEmissions(**CODONS, compute_kmers_in_bf16=bf16, **kwargs)
    te = tm.GenePredEmissions(**CODONS, compute_kmers_in_bf16=bf16, input_dim=15, **kwargs)
    kernel = _kernel(rng, je, 15)
    te.load_state_dict({"emission_kernel": torch.from_numpy(kernel)})
    m = kwargs.get("num_models", 1)
    X = _inputs(rng, m, 2, 33, 15, soft)
    ref = np.asarray(je.emissions({"emission_kernel": jnp.asarray(kernel)}, jnp.asarray(X)))
    got = te.emissions(torch.from_numpy(X)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(te.codon_probs.numpy(), je.codon_probs)


@pytest.mark.parametrize("training", [True, False])
def test_gene_pred_emissions_pass_training_to_the_base_class(monkeypatch, training):
    """As the JAX model does (``hmm_layer_tpu/models/gene_pred_emissions.py``,
    ``GenePredEmissions.emissions``), the port hands ``training`` on to the
    base class's emissions."""
    seen = []
    base = tm.SimpleGenePredEmissions.emissions

    def spy(self, inputs, end_hints=None, training=False):
        seen.append(training)
        return base(self, inputs, end_hints=end_hints, training=training)

    monkeypatch.setattr(tm.SimpleGenePredEmissions, "emissions", spy)
    em = tm.GenePredEmissions(**CODONS, input_dim=15)
    X = _inputs(np.random.default_rng(4), 1, 2, 9, 15, False)
    em.emissions(torch.from_numpy(X), training=training)
    assert seen == [training]


def test_simple_emissions_with_end_hints_match_jax():
    rng = np.random.default_rng(3)
    je, te = jm.SimpleGenePredEmissions(), tm.SimpleGenePredEmissions()
    kernel = _kernel(rng, je, 7)
    te.load_state_dict({"emission_kernel": torch.from_numpy(kernel)})
    X = rng.dirichlet(np.ones(7), size=(1, 2, 12)).astype(np.float32)
    hints = rng.uniform(0, 1, size=(1, 2, 2, 7)).astype(np.float32)
    ref = np.asarray(
        je.emissions({"emission_kernel": jnp.asarray(kernel)}, jnp.asarray(X), end_hints=jnp.asarray(hints))
    )
    got = te.emissions(torch.from_numpy(X), end_hints=torch.from_numpy(hints))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=0)


def test_array_init_and_default_init_match_jax():
    rng = np.random.default_rng(4)
    full = rng.normal(size=(1, 15, 6)).astype(np.float32)
    for init in (0.0, 0.3, full):
        je = jm.GenePredEmissions(**CODONS, init=init)
        te = tm.GenePredEmissions(**CODONS, init=init, input_dim=6)
        ref = je.init_params(jax.random.PRNGKey(0), 6)["emission_kernel"]
        np.testing.assert_array_equal(_state(te)["emission_kernel"], np.asarray(ref))
    assert tm.GenePredEmissions(**CODONS).emission_kernel.shape == (1, 13, 15)


@pytest.mark.parametrize(
    "option", ["emit_embeddings", "trainable_nucleotides_at_exons", "onehot_lookup_kmers"]
)
def test_unported_emission_options_raise(option):
    """The three options are ported (held against JAX in
    ``tests/test_torch_options.py``): each builds, keeps its config and
    gives finite emissions; a missing or stray ``embedding_dim`` raises."""
    kwargs = {option: True}
    if option == "emit_embeddings":
        kwargs["embedding_dim"] = 4
        with pytest.raises(ValueError, match="embedding_dim"):
            tm.GenePredEmissions(**CODONS, emit_embeddings=True)
    em = tm.GenePredEmissions(**CODONS, **kwargs)
    assert em.get_config()[option] is True
    x = torch.rand(1, 2, 9, 15 + kwargs.get("embedding_dim", 0) + 5)
    assert torch.isfinite(em.emissions(x)).all()
    with pytest.raises(ValueError, match="embedding_dim"):
        tm.GenePredEmissions(**CODONS, embedding_dim=4)


@pytest.mark.parametrize(
    "codons",
    [[("ATG", 0.5)], [("ATGA", 1.0)], [("ATG", 1.5), ("TAA", -0.5)]],
    ids=["not-normalised", "not-a-triplet", "out-of-range"],
)
def test_codon_tables_are_validated(codons):
    with pytest.raises(ValueError):
        tm.GenePredEmissions(**{**CODONS, "start_codons": codons})
    np.testing.assert_array_equal(
        tm.make_codon_probs(CODONS["stop_codons"], pivot_left=False),
        jgpe.make_codon_probs(CODONS["stop_codons"], pivot_left=False),
    )


@pytest.mark.parametrize("per_chunk", [False, True])
def test_apply_end_hints_matches_jax(per_chunk):
    rng = np.random.default_rng(5)
    emit = rng.uniform(size=(2, 3, 12, 4)).astype(np.float32)
    shape = (2, 3, 4, 2, 4) if per_chunk else (2, 3, 2, 4)
    hints = rng.uniform(size=shape).astype(np.float32)
    ref = np.asarray(jeu.apply_end_hints(jnp.asarray(emit), jnp.asarray(hints)))
    emit_t = torch.from_numpy(emit)
    got = teu.apply_end_hints(emit_t, torch.from_numpy(hints))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert teu.apply_end_hints(emit_t, None) is emit_t


@pytest.mark.parametrize("shape", [(2, 3, 5, 2, 4), (2, 3, 12, 2, 4), (2, 3, 3, 4)])
def test_apply_end_hints_rejects_bad_shapes(shape):
    emit = torch.ones((2, 3, 12, 4))
    with pytest.raises(ValueError):
        teu.apply_end_hints(emit, torch.ones(shape))
