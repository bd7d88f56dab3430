"""The port's structured Plan7 matvec (``hmm_layer_torch.ops.plan7``) and
the ``structured_forward`` route of ``HMMLayer`` against the JAX package
and the port's dense engine on the same params, at the tolerances of
``tests/test_plan7.py``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hmm_layer_tpu.layer import HMMLayer as JHMMLayer
from hmm_layer_tpu.models import ProfileEmissions as JPE
from hmm_layer_tpu.models import ProfileTransitions as JPT
from hmm_layer_tpu.ops import plan7 as jplan7
from hmm_layer_torch import HMMLayer, load_jax_params
from hmm_layer_torch import models as tm
from hmm_layer_torch.convert import params_from_jax
from hmm_layer_torch.ops import plan7, recursion


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tiny CPU ops: the test workers
    share the cores, and per-op thread pools contending for them made
    these tests many times slower than one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KEY = jax.random.PRNGKey(1)


def _pair(lengths, key=KEY):
    jt = JPT(lengths)
    params = jax.device_get(jt.init_params(key))
    tt = tm.ProfileTransitions(lengths)
    tt.load_state_dict(params_from_jax(params))
    return jt, params, tt


def _emissions(lengths, b, L, seed=0):
    rng = np.random.default_rng(seed)
    q = max(2 * l + 3 for l in lengths)
    E = rng.uniform(0.05, 1.0, (len(lengths), b, L, q)).astype(np.float32)
    for i, l in enumerate(lengths):
        E[i, :, :, 2 * l + 3 :] = 0.0
    return E


CASES = [([4], 12), ([4, 6], 24), ([7, 5, 6], 40)]


class TestMatvec:
    @pytest.mark.parametrize("lengths", [c[0] for c in CASES])
    def test_matvec_equals_dense(self, lengths):
        _, _, tt = _pair(lengths)
        A = tt.make_A().detach()
        rng = np.random.default_rng(3)
        alpha = rng.uniform(0.1, 1.0, (len(lengths), 2, tt.max_num_states)).astype(np.float32)
        for i, l in enumerate(lengths):
            alpha[i, :, 2 * l + 3 :] = 0.0
        r_ref = np.einsum("mbq,mqp->mbp", alpha, A.numpy())
        with torch.no_grad():
            r = plan7._matvec(plan7.structured_operator(tt), plan7.split_components(tt, torch.from_numpy(alpha)))
        for i, l in enumerate(lengths):
            got = np.concatenate(
                [
                    r["lf"][i, :, None],
                    r["m"][i, :, :l],
                    r["i"][i, :, : l - 1],
                    r["u"][i, :, None],
                    r["rf"][i, :, None],
                    r["t"][i, :, None],
                ],
                axis=-1,
            )
            np.testing.assert_allclose(got, r_ref[i, :, : 2 * l + 3], rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("lengths", [c[0] for c in CASES])
    def test_operator_equals_jax(self, lengths):
        jt, params, tt = _pair(lengths)
        jop = jplan7.structured_operator(jt, params)
        with torch.no_grad():
            op = plan7.structured_operator(tt)
        assert set(op) == set(jop)
        for name in jop:
            np.testing.assert_allclose(op[name], np.asarray(jop[name]), rtol=1e-5, atol=1e-7, err_msg=name)


class TestLogLikelihood:
    @pytest.mark.parametrize("lengths,L", CASES)
    def test_matches_jax_and_dense(self, lengths, L):
        jt, params, tt = _pair(lengths)
        E = _emissions(lengths, 3, L)
        with torch.no_grad():
            ll = plan7.structured_log_likelihood(tt, torch.from_numpy(E))
            ll_dense = recursion.log_likelihood(*tt.matrices(), torch.from_numpy(E))
        ll_jax = np.asarray(jplan7.structured_log_likelihood(jt, params, jnp.asarray(E)))
        np.testing.assert_allclose(ll, ll_jax, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(ll, ll_dense, rtol=1e-5, atol=1e-4)

    def test_grads_match_jax_and_dense(self):
        jt, params, tt = _pair([6, 8], jax.random.PRNGKey(2))
        E = _emissions([6, 8], 2, 16, seed=1)
        g_jax = params_from_jax(
            jax.device_get(jax.jit(jax.grad(lambda p: jplan7.structured_log_likelihood(jt, p, jnp.asarray(E)).mean()))(params))
        )
        names = [n for n, _ in tt.named_parameters()]
        pars = list(tt.parameters())
        g = torch.autograd.grad(plan7.structured_log_likelihood(tt, torch.from_numpy(E)).mean(), pars)
        g_dense = torch.autograd.grad(recursion.log_likelihood(*tt.matrices(), torch.from_numpy(E)).mean(), pars)
        for name, a, d in zip(names, g, g_dense):
            np.testing.assert_allclose(a, g_jax[name].numpy(), rtol=2e-3, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(a, d, rtol=2e-3, atol=1e-5, err_msg=name)


class TestLayerRoute:
    def _layers(self, lengths=(5, 7)):
        lengths = list(lengths)
        jl = JHMMLayer(JPT(lengths, structured_forward=True), JPE(lengths), use_prior=True, num_seqs=50)
        params = jax.device_get(jl.init_params(KEY, input_dim=26))
        layers = []
        for structured in (True, False):
            layer = HMMLayer(
                tm.ProfileTransitions(lengths, structured_forward=structured),
                tm.ProfileEmissions(lengths),
                use_prior=True,
                num_seqs=50,
                device="cpu",
            )
            layers.append(load_jax_params(layer, params))
        rng = np.random.default_rng(9)
        x = rng.dirichlet(np.ones(26), (len(lengths), 3, 14)).astype(np.float32)
        return jl, params, layers, x

    def test_layer_routes_structured(self, monkeypatch):
        _, _, (structured, dense), x = self._layers()
        calls = []
        orig = plan7.structured_log_likelihood
        monkeypatch.setattr(plan7, "structured_log_likelihood", lambda *a: (calls.append(1), orig(*a))[1])
        structured.log_likelihood(torch.from_numpy(x))
        assert calls, "the layer did not route through the structured path"
        dense.log_likelihood(torch.from_numpy(x))
        assert len(calls) == 1
        # a parallel factor above 1 falls through to the dense engine
        structured.parallel_factor = 2
        structured.log_likelihood(torch.from_numpy(x))
        assert len(calls) == 1

    def test_layer_loss_and_grads_parity(self):
        jl, params, (structured, dense), x = self._layers()
        losses, grads = [], []
        for layer in (structured, dense):
            pars = [p for p in layer.parameters() if p.requires_grad]
            loss = layer.loss(torch.from_numpy(x))
            losses.append(loss.item())
            grads.append(torch.autograd.grad(loss, pars))
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
        for a, b in zip(*grads):
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-5)
        # and the JAX structured route's loss (its prior's float32 hit term
        # sets the tolerance, as in tests/test_torch_profile.py)
        jloss = float(jax.jit(jl.loss)(params, jnp.asarray(x)))
        np.testing.assert_allclose(losses[0], jloss, rtol=2e-3)
