"""The port's profile-HMM family (``hmm_layer_torch.models``: Plan7
transitions, amino-acid emissions, priors, initializers, resize, length
adaptation, MSA output; the protein data path and the DP precision API)
against the JAX package on the same numpy inputs and the JAX params
carried across with ``load_jax_params``, at the tolerances of
``tests/test_profile.py``, ``test_resize.py``, ``test_adapt.py``,
``test_msa.py``, ``test_trained_priors.py`` and ``test_config_roundtrip.py``.

The MAP prior is compared at a looser tolerance than the log-likelihood:
its hit term is ``(alpha_single - 1) log(p_rf + p_t)`` with ``alpha_single
= 1e9``, so one float32 spacing of an edge probability (6e-8) moves it by
~60 nats, and its gradient with respect to the end kernels is a product
with ``1 - p_rf - p_t`` ~ 5e-5, computed to ~1e-3 in float32 in either
package.
"""

import filecmp
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hmm_layer_tpu import data as jdata
from hmm_layer_tpu.layer import HMMLayer as JHMMLayer
from hmm_layer_tpu.models import initializers as jinits
from hmm_layer_tpu.models import msa as jmsa
from hmm_layer_tpu.models import priors as jpriors
from hmm_layer_tpu.models import profile_adapt as jadapt
from hmm_layer_tpu.models import ProfileEmissions as JPE
from hmm_layer_tpu.models import ProfileTransitions as JPT
from hmm_layer_tpu.models.dirichlet import DirichletMixture as JDM
from hmm_layer_tpu.models.profile_emissions import TemperatureMode as JTemperatureMode
from hmm_layer_tpu.models.dirichlet import dirichlet_log_pdf as jdirichlet_log_pdf
from hmm_layer_tpu.training import select_models as jselect_models
from hmm_layer_tpu.utils import checkpoint as jckpt
from hmm_layer_torch import HMMLayer, Trainer, data, load_jax_params
from hmm_layer_torch import models as tm
from hmm_layer_torch.convert import params_from_jax
from hmm_layer_torch.models import initializers as inits
from hmm_layer_torch.models import priors
from hmm_layer_torch.models.dirichlet import DirichletMixture, dirichlet_log_pdf, save_mixture_model
from hmm_layer_torch.ops import recursion
from hmm_layer_torch.training import select_models
from hmm_layer_torch.utils import checkpoint as ckpt
from hmm_layer_torch.utils import substitution


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tiny CPU ops: the test workers
    share the cores, and per-op thread pools contending for them made
    these tests many times slower than one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KEY = jax.random.PRNGKey(42)
S = 26  # protein channels: 25 letters + the terminal symbol
EPS = 1e-16


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_layer(lengths, use_prior=True, structured=False, num_seqs=100, key=KEY):
    layer = JHMMLayer(
        JPT(lengths, structured_forward=structured),
        JPE(lengths),
        use_prior=use_prior,
        num_seqs=num_seqs,
    )
    return layer, jax.device_get(layer.init_params(key, input_dim=S))


def _port_layer(lengths, params, use_prior=True, structured=False, num_seqs=100):
    layer = HMMLayer(
        tm.ProfileTransitions(lengths, structured_forward=structured),
        tm.ProfileEmissions(lengths),
        use_prior=use_prior,
        num_seqs=num_seqs,
        device="cpu",
    )
    return load_jax_params(layer, params)


def _protein_batch(m, b, L, seed=0):
    """Dirichlet residue distributions over 26 channels, (m, b, L, 26)."""
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.ones(S), (m, b, L)).astype(np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if ref.size == 0:
        return 0.0
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# Transitions
# ---------------------------------------------------------------------------

LENGTH_CASES = [[1], [2], [5], [9], [4, 7, 3]]


@pytest.fixture(scope="module", params=LENGTH_CASES, ids=lambda l: "-".join(map(str, l)))
def transitions_pair(request):
    lengths = request.param
    jt = JPT(lengths)
    params = jax.device_get(jt.init_params(KEY))
    tt = tm.ProfileTransitions(lengths)
    tt.load_state_dict(params_from_jax(params))
    return jt, params, tt


class TestTransitions:
    def test_parameter_names_are_jax_tree_paths(self, transitions_pair):
        jt, params, tt = transitions_pair
        assert set(dict(tt.named_parameters())) == set(params_from_jax(params))

    def test_make_probs(self, transitions_pair):
        jt, params, tt = transitions_pair
        for jp, tp in zip(jt.make_probs(params), tt.make_probs()):
            assert list(jp) == list(tp)
            for name in jp:
                np.testing.assert_allclose(tp[name].detach(), _np(jp[name]), rtol=1e-5, atol=1e-7)

    def test_log_A_and_A(self, transitions_pair):
        jt, params, tt = transitions_pair
        np.testing.assert_allclose(tt.make_log_A().detach(), _np(jt.make_log_A(params)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tt.make_A().detach(), _np(jt.make_A(params)), rtol=1e-5, atol=1e-7)
        # rows stochastic, padding rows zero (JAX test_profile.py)
        A = tt.make_A().detach().numpy()
        for i, q in enumerate(tt.num_states):
            np.testing.assert_allclose(A[i, :q].sum(-1), 1.0, rtol=1e-4)
            assert np.all(A[i, q:] < 1e-10)

    def test_initial_distribution(self, transitions_pair):
        jt, params, tt = transitions_pair
        init = tt.make_initial_distribution().detach()
        np.testing.assert_allclose(init, _np(jt.make_initial_distribution(params)), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(init.sum(-1), 1.0, rtol=1e-4)
        init_m, A_m = tt.matrices()
        np.testing.assert_array_equal(init_m.detach(), init)
        np.testing.assert_array_equal(A_m.detach(), tt.make_A().detach())

    def test_make_log_A_sparse(self, transitions_pair):
        jt, params, tt = transitions_pair
        for (ji, jv), (ti, tv), (_, tp) in zip(
            jt.make_log_A_sparse(params), tt.make_log_A_sparse(), tt.make_A_sparse()
        ):
            np.testing.assert_array_equal(ti, np.asarray(ji))
            np.testing.assert_allclose(tv.detach(), _np(jv), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(tp.detach(), np.exp(_np(jv)), rtol=1e-5, atol=1e-7)

    def test_transition_prior(self, transitions_pair):
        jt, params, tt = transitions_pair
        jp = jt.prior(jt.make_probs(params), jt.make_flank_init_prob(params))
        tp = tt.prior(tt.make_probs(), tt.make_flank_init_prob())
        assert list(jp) == list(tp)
        for name in jp:
            # hit_prior: alpha_single = 1e9 times the log of a probability
            # near 1, so up to 4 float32 spacings (2^-24 each) of it
            atol = (tt.prior.alpha_single - 1) * 4 * 2.0**-24 if name == "hit_prior" else 1e-3
            np.testing.assert_allclose(tp[name].detach(), _np(jp[name]), rtol=1e-4, atol=atol)

    def test_minimum_length_gradients_finite(self):
        """L = 2 (no match-skip edges): the prior and the matrices have
        finite gradients (JAX test_profile.py::test_minimum_length_model)."""
        tt = tm.ProfileTransitions(2, generator=torch.Generator().manual_seed(0))
        init, A = tt.matrices()
        (A.sum() + init.sum() + tt.prior_log_density().sum()).backward()
        for name, p in tt.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), name

    def test_frozen_kernels(self):
        tt = tm.ProfileTransitions(5, frozen_kernels={"left_flank_loop": True})
        mask = tt.trainable_mask()
        # freezing a shared group's member freezes the shared kernel
        assert mask["kernels"][0]["right_flank_loop"] is False
        assert mask["kernels"][0]["match_to_match"] is True
        assert not tt.kernels[0]["right_flank_loop"].requires_grad


# ---------------------------------------------------------------------------
# Emissions, priors and artifacts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def emissions_pair():
    lengths = [4, 7]
    je = JPE(lengths, emission_init=jinits.random_normal_init(0.0, 0.5))
    params = jax.device_get(je.init_params(KEY, input_dim=S))
    te = tm.ProfileEmissions(lengths)
    te.load_state_dict(params_from_jax(params))
    return je, params, te


class TestEmissions:
    def test_make_B(self, emissions_pair):
        je, params, te = emissions_pair
        B = te.make_B().detach()
        np.testing.assert_allclose(B, _np(je.make_B(params)), rtol=1e-6, atol=1e-7)
        for i, q in enumerate(te.num_states):
            assert np.all(B[i, q:].numpy() == 0)
            assert B[i, q - 1, -1] == 1.0

    def test_emissions(self, emissions_pair):
        je, params, te = emissions_pair
        x = _protein_batch(2, 3, 9)
        np.testing.assert_allclose(
            te.emissions(_t(x)).detach(), _np(je.emissions(params, jnp.asarray(x))), rtol=1e-6, atol=1e-7
        )

    @pytest.mark.parametrize("P", [1, 3])
    def test_end_hints(self, emissions_pair, P):
        """Sequence-level and per-chunk border hints multiply the profile
        emissions as in JAX (test_end_hints.py::TestProfileChunkHints)."""
        je, params, te = emissions_pair
        rng = np.random.default_rng(11)
        x = _protein_batch(2, 2, 12, seed=11)
        hints = rng.uniform(0.2, 1.0, (2, 2, P, 2, te.max_num_states)).astype(np.float32)
        np.testing.assert_allclose(
            te.emissions(_t(x), end_hints=_t(hints)).detach(),
            _np(je.emissions(params, jnp.asarray(x), end_hints=jnp.asarray(hints))),
            rtol=1e-6,
            atol=1e-7,
        )

    def test_temperature_mode(self):
        assert tm.profile_emissions.TemperatureMode.from_string("cold_to_warm").value == 3
        assert [(m.name, m.value) for m in tm.profile_emissions.TemperatureMode] == [
            (m.name, m.value) for m in JTemperatureMode
        ]

    def test_amino_acid_prior(self, emissions_pair):
        je, params, te = emissions_pair
        np.testing.assert_allclose(
            te.prior_log_density().detach(), _np(je.prior_log_density(params)), rtol=1e-5
        )

    def test_frozen_insertions(self, emissions_pair):
        _, _, te = emissions_pair
        assert all(not p.requires_grad for p in te.insertion_kernel)
        assert all(p.requires_grad for p in te.emission_kernel)
        assert te.trainable_mask() == {"emission_kernel": [True, True], "insertion_kernel": [False, False]}

    def test_default_emission_init_equals_background(self):
        init = inits.make_default_emission_init()
        jinit = jinits.make_default_emission_init()
        np.testing.assert_array_equal(init(None, (4, 25)).numpy(), _np(jinit(KEY, (4, 25))))
        R, p = substitution.lg_matrix()
        from hmm_layer_tpu.utils import substitution as jsub

        jR, jp = jsub.lg_matrix()
        np.testing.assert_array_equal(R, jR)
        np.testing.assert_array_equal(p, jp)
        Q = substitution.make_rate_matrix(R, p)
        np.testing.assert_allclose(
            substitution.transition_probs(Q, np.float32(0.7)).numpy(),
            _np(jsub.transition_probs(Q, np.float32(0.7))),
            rtol=1e-5,
            atol=1e-6,
        )


class TestPriorsAndArtifacts:
    @pytest.mark.parametrize("name", ["amino_prior_9", "match_prior_1", "insert_prior_1", "delete_prior_1"])
    def test_artifacts_byte_equal(self, name):
        here = os.path.join(os.path.dirname(__file__), "..")
        assert filecmp.cmp(
            os.path.join(here, "hmm_layer_torch", "trained_priors", f"{name}.npz"),
            os.path.join(here, "hmm_layer_tpu", "trained_priors", f"{name}.npz"),
            shallow=False,
        )
        fd, jfd = priors.load_trained_prior(name), jpriors.load_trained_prior(name)
        np.testing.assert_array_equal(fd.alpha, jfd.alpha)
        np.testing.assert_array_equal(fd.mix, jfd.mix)

    def test_default_priors_use_trained_artifacts(self):
        assert priors.AminoAcidPrior().dirichlet.alpha.shape == (9, 20)
        tp = priors.ProfileHMMTransitionPrior()
        assert tp.match_dirichlet.alpha.shape == (1, 3)
        assert tp.insert_dirichlet.alpha.shape == (1, 2)

    def test_missing_artifact_falls_back(self):
        fd = priors.load_trained_prior("no_such_prior", [2.0, 3.0])
        np.testing.assert_array_equal(fd.alpha, [[2.0, 3.0]])
        with pytest.raises(FileNotFoundError):
            priors.load_trained_prior("no_such_prior")

    def test_dirichlet_log_pdf(self):
        rng = np.random.default_rng(1)
        p = rng.dirichlet(np.ones(20), 7).astype(np.float32)
        alpha = rng.uniform(0.5, 3.0, (3, 20)).astype(np.float32)
        q = rng.dirichlet(np.ones(3)).astype(np.float32)
        np.testing.assert_allclose(
            dirichlet_log_pdf(_t(p), _t(alpha), _t(q)).numpy(),
            _np(jdirichlet_log_pdf(p, alpha, q)),
            rtol=1e-5,
        )

    def test_dirichlet_mixture_loss_and_save(self, tmp_path):
        jdm = JDM(3, 20, number_of_examples=50)
        params = jax.device_get(jdm.init_params(KEY))
        dm = DirichletMixture(3, 20, number_of_examples=50)
        dm.load_state_dict(params_from_jax(params))
        p = np.random.default_rng(2).dirichlet(np.ones(20), 9).astype(np.float32)
        for training in (True, False):
            np.testing.assert_allclose(
                dm.loss(_t(p), training=training).item(),
                float(jdm.loss(params, jnp.asarray(p), training=training)),
                rtol=1e-5,
            )
        np.testing.assert_allclose(dm.expectation().detach(), _np(jdm.expectation(params)), rtol=1e-6)
        save_mixture_model(tmp_path / "mix.npz", dm)
        fd = priors.FixedDirichlet.from_params(tm.load_mixture_model(tmp_path / "mix.npz", 3, 20))
        np.testing.assert_allclose(fd.alpha, _np(jdm.make_alpha(params)), rtol=1e-6)


# ---------------------------------------------------------------------------
# The layer: objective, posterior, decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def profile_layers():
    """A mixed-length JAX profile layer (m = 3) with its params, the port's
    twin, and inputs (m, b, L, 26)."""
    lengths = [4, 7, 5]
    jl, params = _jax_layer(lengths)
    tl = _port_layer(lengths, params)
    x = _protein_batch(3, 4, 14, seed=3)
    return jl, params, tl, x


class TestLayer:
    def test_loglik_and_posterior(self, profile_layers):
        jl, params, tl, x = profile_layers
        ll = tl.log_likelihood(_t(x)).detach()
        np.testing.assert_allclose(ll, _np(jl.log_likelihood(params, jnp.asarray(x))), rtol=1e-5)
        lg = tl.state_posterior_log_probs(_t(x)).detach().numpy()
        jlg = _np(jax.jit(jl.state_posterior_log_probs)(params, jnp.asarray(x)))
        for i, q in enumerate(tl.transitions.num_states):
            np.testing.assert_allclose(lg[i, ..., :q], jlg[i, ..., :q], atol=2e-4)
            np.testing.assert_allclose(
                torch.logsumexp(torch.from_numpy(lg[i, ..., :q]), -1).numpy(), 0.0, atol=2e-3
            )

    def test_loss_and_gradients(self, profile_layers):
        jl, params, tl, x = profile_layers
        jloss, jgrads = jax.jit(jax.value_and_grad(jl.loss))(params, jnp.asarray(x))
        tl.zero_grad()
        loss = tl.loss(_t(x))
        loss.backward()
        # the ll part at the JAX suite's 1e-5; the prior's float32 hit term
        # sets the total's tolerance (module docstring)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-3)
        ref = params_from_jax(jax.device_get(jgrads))
        for name, p in tl.named_parameters():
            if p.requires_grad:
                assert _rel(p.grad, ref[name]) < 5e-3, name
            else:
                assert p.grad is None, name

    def test_loss_gradients_without_prior(self):
        lengths = [4, 7, 5]
        jl, params = _jax_layer(lengths, use_prior=False)
        tl = _port_layer(lengths, params, use_prior=False)
        x = _protein_batch(3, 4, 14, seed=4)
        jloss, jgrads = jax.jit(jax.value_and_grad(jl.loss))(params, jnp.asarray(x))
        loss = tl.loss(_t(x))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        ref = params_from_jax(jax.device_get(jgrads))
        for name, p in tl.named_parameters():
            if p.requires_grad:
                assert _rel(p.grad, ref[name]) < 1e-4, name

    def test_viterbi_valid_and_score_equal(self, profile_layers):
        jl, params, tl, x = profile_layers
        paths = tl.viterbi(_t(x)).numpy()
        jpaths = _np(jl.viterbi(params, jnp.asarray(x)))
        init, A = (t.detach().numpy() for t in tl.transitions.matrices())
        E = tl.emission_probs(_t(x)).detach().numpy()
        s, used = _path_score64(init, A, E, paths)
        js, _ = _path_score64(init, A, E, jpaths)
        assert used.all()
        np.testing.assert_allclose(s, js, rtol=1e-6)

    def test_chunked_parity(self):
        """parallel_factor 4 vs 1 at q <= 16 (JAX test_profile.py::test_chunked_parity)."""
        jl, params = _jax_layer([6], use_prior=False)
        t1 = _port_layer([6], params, use_prior=False)
        t4 = _port_layer([6], params, use_prior=False)
        t4.parallel_factor = 4
        x = _protein_batch(1, 2, 16, seed=5)
        np.testing.assert_allclose(t4.log_likelihood(_t(x)).detach(), t1.log_likelihood(_t(x)).detach(), rtol=1e-4)

    def test_trainer_step_moves_trainable_only(self, profile_layers):
        _, params, _, x = profile_layers
        tl = _port_layer([4, 7, 5], params)
        before = {n: p.detach().clone() for n, p in tl.named_parameters()}
        trainer = Trainer(tl)
        first = float(trainer.fit([_t(x)]))
        for name, p in tl.named_parameters():
            moved = not torch.equal(p.detach(), before[name])
            assert moved == p.requires_grad, name
        assert tl.loss(_t(x)).item() < first


def _path_score64(init, A, E, path):
    """float64 log score of each path (m, b), and whether it uses only
    transitions with A > 0."""
    m, b, L = path.shape
    mi = np.arange(m)[:, None, None]
    bi = np.arange(b)[None, :, None]
    ti = np.arange(L)[None, None, :]
    A64 = np.asarray(A, np.float64)
    lA = np.log(np.maximum(A64, EPS))
    score = np.log(np.maximum(np.asarray(init, np.float64)[np.arange(m)[:, None], path[..., 0]], EPS))
    score = score + np.log(np.maximum(np.asarray(E, np.float64)[mi, bi, ti, path], EPS)).sum(-1)
    prev, nxt = path[..., :-1], path[..., 1:]
    score = score + lA[mi, prev, nxt].sum(-1)
    return score, A64[mi, prev, nxt] > 0


# ---------------------------------------------------------------------------
# Resize, duplicate, selection
# ---------------------------------------------------------------------------

RKEY = jax.random.PRNGKey(7)


def _resize_pair(lengths, new_lengths, keep=None):
    jt, je = JPT(lengths), JPE(lengths, emission_init=jinits.random_normal_init(0.0, 0.5))
    tparams = jax.device_get(jt.init_params(KEY))
    eparams = jax.device_get(je.init_params(KEY, input_dim=S))
    tt, te = tm.ProfileTransitions(lengths), tm.ProfileEmissions(lengths)
    tt.load_state_dict(params_from_jax(tparams))
    te.load_state_dict(params_from_jax(eparams))
    jt2, jtp2 = jt.resize(tparams, new_lengths, RKEY, keep=keep)
    je2, jep2 = je.resize(eparams, new_lengths, RKEY, keep=keep)
    gen = torch.Generator().manual_seed(7)
    return (tt, te), (tt.resize(new_lengths, keep, gen), te.resize(new_lengths, keep, gen)), (jtp2, jep2)


class TestResize:
    def test_identity_bitwise(self):
        (tt, te), (tt2, te2), _ = _resize_pair([5], [5])
        for (n, p), (n2, p2) in zip(tt.named_parameters(), tt2.named_parameters()):
            assert n == n2
            assert torch.equal(p, p2), n
        for p, p2 in zip(te.parameters(), te2.parameters()):
            assert torch.equal(p, p2)

    @pytest.mark.parametrize(
        "lengths,new_lengths,keep",
        [
            ([6], [9], None),  # grow at the end
            ([8], [5], None),  # shrink at the end
            ([4], [5], [np.asarray([0, 1, -1, 2, 3])]),  # middle insertion
            ([4, 6], [6, 5], None),  # multi-model
        ],
        ids=["grow", "shrink", "middle", "multi"],
    )
    def test_kept_entries_equal_jax(self, lengths, new_lengths, keep):
        (tt, te), (tt2, te2), (jtp2, jep2) = _resize_pair(lengths, new_lengths, keep)
        assert tt2.lengths == new_lengths and te2.lengths == new_lengths
        keeps = tm.ProfileTransitions._resize_keep(lengths, new_lengths, keep)
        for i, (lo, k) in enumerate(zip(lengths, keeps)):
            for name, p in tt2.kernels[i].items():
                ref = np.asarray(jtp2["kernels"][i][name])
                kind = tm.ProfileTransitions._RESIZE_PART_KINDS.get(name)
                if kind is None:
                    np.testing.assert_array_equal(p.detach(), ref)
                    continue
                new_idx, _ = tm.ProfileTransitions._resize_entry_map(kind, k, lo)
                assert p.shape == ref.shape, name
                np.testing.assert_array_equal(p.detach().numpy()[new_idx], ref[new_idx], err_msg=name)
            rows = np.flatnonzero(k >= 0)
            np.testing.assert_array_equal(
                te2.emission_kernel[i].detach().numpy()[rows], np.asarray(jep2["emission_kernel"][i])[rows]
            )
            np.testing.assert_array_equal(te2.insertion_kernel[i].detach(), np.asarray(jep2["insertion_kernel"][i]))
        A = tt2.make_A().detach().numpy()
        for i, q in enumerate(tt2.num_states):
            np.testing.assert_allclose(A[i, :q].sum(-1), 1.0, rtol=1e-4)

    def test_bad_keep_and_counts(self):
        tt = tm.ProfileTransitions([4])
        with pytest.raises(ValueError, match="new lengths"):
            tt.resize([5, 6])
        with pytest.raises(ValueError, match="shape"):
            tt.resize([5], keep=[np.asarray([0, 1])])
        with pytest.raises(ValueError, match="strictly"):
            tt.resize([5], keep=[np.asarray([1, 0, -1, 2, 3])])

    def test_layer_resize_carries_settings(self):
        jl, params = _jax_layer([4])
        tl = _port_layer([4], params)
        tl.num_seqs = 77
        x = _protein_batch(1, 3, 12, seed=6)
        ll = tl.log_likelihood(_t(x)).detach()
        same = tl.resize([4], generator=torch.Generator().manual_seed(1))
        assert torch.equal(same.log_likelihood(_t(x)).detach(), ll)
        grown = tl.resize([6], generator=torch.Generator().manual_seed(1))
        assert grown.num_seqs == 77 and grown.use_prior and grown.device == tl.device
        assert grown.transitions.lengths == [6] and grown.emissions[0].lengths == [6]
        assert tl.transitions.kernels[0]["begin_to_match"].shape == (4,)
        loss = grown.loss(_t(x))
        loss.backward()
        assert torch.isfinite(loss)
        assert all(torch.isfinite(p.grad).all() for p in grown.parameters() if p.requires_grad)

    def test_gene_pred_layer_resize_raises(self):
        layer = HMMLayer(tm.SimpleGenePredTransitions(), tm.SimpleGenePredEmissions(), use_prior=False, device="cpu")
        with pytest.raises(NotImplementedError, match="profile-family"):
            layer.resize([8])

    def test_select_models_through_duplicate(self):
        lengths = [4, 7, 5]
        jl, params = _jax_layer(lengths)
        tl = _port_layer(lengths, params)
        jt2, jtp = jselect_models(jl.transitions, params["transitions"], [2, 0])
        je2, jep = jselect_models(jl.emissions[0], params["emissions"][0], [2, 0])
        t2 = select_models(tl.transitions, [2, 0])
        e2 = select_models(tl.emissions[0], [2, 0])
        assert t2.lengths == jt2.lengths == [5, 4] and e2.lengths == [5, 4]
        ref = params_from_jax(jax.device_get({"t": jtp, "e": jep}))
        got = {f"t.{n}": p for n, p in t2.named_parameters()}
        got.update({f"e.{n}": p for n, p in e2.named_parameters()})
        assert set(got) == set(ref)
        for name, p in got.items():
            np.testing.assert_array_equal(p.detach(), ref[name].numpy())
            assert p.requires_grad == ("insertion_kernel" not in name), name
        # copies, not the same tensors (share_kernels=False)
        assert t2.kernels[0]["begin_to_match"].data_ptr() != tl.transitions.kernels[2]["begin_to_match"].data_ptr()
        shared = tl.transitions.duplicate([1], share_kernels=True)
        assert shared.kernels[0]["begin_to_match"] is tl.transitions.kernels[1]["begin_to_match"]


# ---------------------------------------------------------------------------
# Configs, checkpoints, precision
# ---------------------------------------------------------------------------


class TestConfigsAndCheckpoints:
    def test_transitions_config_both_ways(self):
        custom = jinits.make_default_transition_init(MM=2.0, scale=0.05)
        jt = JPT([4, 6], transition_init=custom, frozen_kernels={"insert_to_insert": True})
        jconfig = json.loads(json.dumps(jt.get_config()))
        tt = tm.ProfileTransitions.from_config(jconfig)
        assert json.loads(json.dumps(tt.get_config())) == jconfig
        back = JPT.from_config(json.loads(json.dumps(tt.get_config())))
        params = jax.device_get(back.init_params(KEY))
        tt.load_state_dict(params_from_jax(params))
        assert not tt.kernels[0]["insert_to_insert"].requires_grad
        np.testing.assert_allclose(tt.make_A().detach(), _np(back.make_A(params)), rtol=1e-5, atol=1e-7)
        # the random initializers rebuilt from a JAX spec draw their torch
        # values with the spec's mean and scale
        mm = inits.init_from_config(jconfig["transition_init"][0]["insert_to_insert"])
        assert mm.spec == jconfig["transition_init"][0]["insert_to_insert"]

    def test_emissions_config_both_ways(self):
        je = JPE([4, 6], emission_init=jinits.make_default_emission_init(),
                 insertion_init=jinits.constant_init(0.1), frozen_insertions=False)
        jconfig = json.loads(json.dumps(je.get_config()))
        te = tm.ProfileEmissions.from_config(jconfig)
        assert json.loads(json.dumps(te.get_config())) == jconfig
        je2 = JPE.from_config(json.loads(json.dumps(te.get_config())))
        params = jax.device_get(je2.init_params(KEY, input_dim=S))
        # deterministic initializers: the port's own init equals JAX's
        np.testing.assert_allclose(te.make_B().detach(), _np(je2.make_B(params)), rtol=1e-6)
        assert te.insertion_kernel[0].requires_grad

    def test_layer_config_both_ways(self):
        jl, _ = _jax_layer([4, 6])
        config = json.loads(json.dumps(jl.get_config()))
        tl = HMMLayer.from_config(config, device="cpu")
        assert isinstance(tl.transitions, tm.ProfileTransitions)
        assert json.loads(json.dumps(tl.get_config())) == config
        JHMMLayer.from_config(json.loads(json.dumps(tl.get_config())))

    def test_unknown_initializer_kind_raises(self):
        with pytest.raises(ValueError, match="unknown initializer kind"):
            inits.init_from_config({"kind": "bogus"})
        with pytest.raises(ValueError, match="no serialization spec"):
            inits.init_to_config(lambda generator, shape: torch.zeros(shape))

    def test_checkpoints_both_ways(self, tmp_path):
        lengths = [4, 6]
        jl, params = _jax_layer(lengths)
        jckpt.save_checkpoint(str(tmp_path / "jax.npz"), params)
        tl = HMMLayer(tm.ProfileTransitions(lengths), tm.ProfileEmissions(lengths), device="cpu")
        ckpt.load_checkpoint(str(tmp_path / "jax.npz"), tl)
        ref = params_from_jax(params)
        for name, p in tl.named_parameters():
            np.testing.assert_array_equal(p.detach(), ref[name].numpy())
        ckpt.save_checkpoint(str(tmp_path / "port.npz"), tl)
        back = jckpt.load_checkpoint(str(tmp_path / "port.npz"), params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_precision_high_bit_equal_highest(self):
        jl, params = _jax_layer([4, 7, 5])
        tl = _port_layer([4, 7, 5], params)
        x = _t(_protein_batch(3, 2, 11, seed=8))
        with recursion.dp_precision("highest"):
            ref = tl.log_likelihood(x).detach()
        prev = recursion.set_dp_precision("high")
        try:
            assert torch.equal(tl.log_likelihood(x).detach(), ref)
            assert recursion.set_dp_precision("high") == "high"
        finally:
            recursion.set_dp_precision(prev)
        with pytest.raises(KeyError):
            recursion.set_dp_precision("bf16")


# ---------------------------------------------------------------------------
# Adaptation statistics, MSA rows, protein data
# ---------------------------------------------------------------------------


class TestAdaptAndMsa:
    @pytest.fixture(scope="class")
    def posterior(self):
        jl, params = _jax_layer([5, 3], use_prior=False)
        x = _protein_batch(2, 6, 10, seed=9)
        return jl, params, _np(jax.jit(jl.state_posterior_log_probs)(params, jnp.asarray(x))), x

    def test_match_statistics_and_proposals(self, posterior):
        jl, params, lg, _ = posterior
        mask = np.ones((6, 10))
        mask[:, 8:] = 0.0
        for i, Lm in enumerate([5, 3]):
            for seq_mask in (None, mask):
                occ, load = tm.match_statistics(lg[i], Lm, seq_mask=seq_mask)
                jocc, jload = jadapt.match_statistics(lg[i], Lm, seq_mask=seq_mask)
                np.testing.assert_array_equal(occ, jocc)
                np.testing.assert_array_equal(load, jload)
                for kw in ({}, {"min_occupancy": 0.6, "expand_threshold": 0.2}):
                    keep, n = tm.propose_keep(occ, load, **kw)
                    jkeep, jn = jadapt.propose_keep(jocc, jload, **kw)
                    np.testing.assert_array_equal(keep, jkeep)
                    assert n == jn

    def test_adapt_profile_layer_info(self, posterior):
        jl, params, _, x = posterior
        tl = _port_layer([5, 3], params, use_prior=False)
        new, info = tm.adapt_profile_layer(tl, _t(x), torch.Generator().manual_seed(0), min_occupancy=0.0)
        _, _, jinfo = jadapt.adapt_profile_layer(jl, params, jnp.asarray(x), RKEY, min_occupancy=0.0)
        for d, jd in zip(info, jinfo):
            assert d["old_length"] == jd["old_length"] and d["new_length"] == jd["new_length"]
            np.testing.assert_array_equal(d["keep"], jd["keep"])
        assert new.transitions.lengths == [d["new_length"] for d in info]

    def test_paths_to_msa_rows_equal(self, posterior):
        jl, params, _, x = posterior
        tl = _port_layer([5, 3], params, use_prior=False)
        paths = tl.viterbi(_t(x)).numpy()
        residues = x.argmax(-1)
        lens = np.asarray([10, 9, 7, 10, 3, 8])
        for i, Lm in enumerate([5, 3]):
            rows = tm.paths_to_msa(paths[i], residues[i], Lm, seq_lengths=lens)
            assert rows == jmsa.paths_to_msa(paths[i], residues[i], Lm, seq_lengths=lens)
            assert tm.msa_column_maps(rows) == jmsa.msa_column_maps(rows)
        true = tm.paths_to_msa(paths[0], residues[0], 5)
        assert tm.evaluate_msa(rows, true[: len(rows)]) == jmsa.evaluate_msa(rows, true[: len(rows)])
        assert tm.AMINO_ALPHABET == jmsa.AMINO_ALPHABET

    def test_encode_protein_and_pad_batches(self):
        seqs = ["MKLVAEQWRD", "mkxjB*", "ACDEFGHIKLMNPQRSTVWYBZXUO", "A"]
        for s in seqs:
            for add_terminal in (True, False):
                np.testing.assert_array_equal(
                    data.encode_protein(s, add_terminal=add_terminal),
                    jdata.encode_protein(s, add_terminal=add_terminal),
                )
            np.testing.assert_array_equal(data.encode_protein(s, "ACDE"), jdata.encode_protein(s, "ACDE"))
        enc = [data.encode_protein(s) for s in seqs]
        got = list(data.pad_batches(enc, 3))
        ref = list(jdata.pad_batches(enc, 3))
        assert len(got) == len(ref) == 2
        for (b, l), (jb, jl) in zip(got, ref):
            np.testing.assert_array_equal(b, jb)
            np.testing.assert_array_equal(l, jl)

    def test_padded_loglik_invariant(self):
        """The absorbing terminal state: a short sequence of a padded batch
        scores as it does alone (JAX test_data.py)."""
        jl, params = _jax_layer([4], use_prior=False)
        tl = _port_layer([4], params, use_prior=False)
        e_short, e_long = data.encode_protein("ARND"), data.encode_protein("ARNDCQEG")
        ((batch, _),) = data.pad_batches([e_short, e_long], batch_size=2)
        ll_pad = tl.log_likelihood(_t(batch[None])).detach()
        ll_ref = tl.log_likelihood(_t(e_short[None, None])).detach()
        np.testing.assert_allclose(float(ll_pad[0, 0]), float(ll_ref[0, 0]), rtol=1e-4)
        np.testing.assert_allclose(ll_pad, _np(jl.log_likelihood(params, jnp.asarray(batch[None]))), rtol=1e-5)

    def test_read_fasta_encoded_protein(self, tmp_path):
        path = tmp_path / "p.fa"
        path.write_text(">a x\nMKLV\nAE\n>b\nWRD\n")
        got = list(data.read_fasta_encoded(path, kind="protein"))
        ref = list(jdata.read_fasta_encoded(str(path), kind="protein"))
        assert [n for n, _ in got] == [n for n, _ in ref] == ["a", "b"]
        for (_, e), (_, je) in zip(got, ref):
            np.testing.assert_array_equal(e, je)
        with pytest.raises(ValueError, match="kind"):
            list(data.read_fasta_encoded(path, kind="rna"))
