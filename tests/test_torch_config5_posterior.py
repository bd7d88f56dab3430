"""Config 5's posterior at full length is not normalised, in both packages.

At config 5 (``GenePredMultiTransitions(k=36)``, q = 505, with seeded
random weights as ``chip_smoke.py`` builds it) on the first sequence of
``chip_smoke.py``'s state-route input (L = 10,000), the engines' EPS
clamps (``clamp_min(alpha @ A, EPS)`` forward, ``clamp_min((E * beta) @
A.T, EPS)`` backward) give unreachable states mass that the two
directions count differently, so gamma exceeds 1 on some positions. The
sequential engine does so in the JAX package and in the port alike, and in
float64 as in float32: a property of the reference's arithmetic, not of
rounding and not of the port. ``chip_smoke.py`` phase 13 therefore holds
the state route at this length to the dense engine's answer (agreement),
not to a normalised posterior.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs

L = 10_000


@pytest.fixture(scope="module")
def config5():
    from hmm_layer_torch import HMMLayer, models

    gen = torch.Generator().manual_seed(cs.SEED + cs.SPARSE_K)
    layer = HMMLayer(
        models.GenePredMultiTransitions(k=cs.SPARSE_K, generator=gen, sparse_forward=False),
        models.GenePredEmissions(
            num_copies=cs.SPARSE_K, init=models.make_15_class_emission_kernel(num_copies=cs.SPARSE_K), **cs.CODONS
        ),
        use_prior=False,
        device="cpu",
    )
    with torch.no_grad():
        for p in layer.parameters():
            p.add_(0.5 * torch.randn(p.shape, generator=gen))
        X = cs.make_inputs(cs.SEED + 137, cs.SPARSE_B, cs.SPARSE_L, torch.device("cpu"))[:, :1, :L]
        init, A = layer.transitions.matrices()
        return init, A, layer.emission_probs(X)


def test_config5_sequential_posterior_matches_jax_and_exceeds_one(config5):
    import jax

    from hmm_layer_tpu.ops import recursion as JR
    from hmm_layer_torch.ops import recursion

    init, A, E = config5
    with torch.no_grad():
        lg32, ll32 = recursion.posterior(init, A, E, 1)
        lg64, ll64 = recursion.posterior(init.double(), A.double(), E.double(), 1)
    lg_j, ll_j = jax.jit(lambda i, a, e: JR.posterior(i, a, e, 1))(init.numpy(), A.numpy(), E.numpy())
    lg_j, ll_j = np.asarray(lg_j), np.asarray(ll_j)
    g32, g64, g_j = lg32.exp().numpy(), lg64.exp().numpy(), np.exp(lg_j)
    excess = {
        "port f32": (float(g32.max()), float(np.abs(np.log(g32.sum(-1))).max())),
        "port f64": (float(g64.max()), float(np.abs(np.log(g64.sum(-1))).max())),
        "jax f32": (float(g_j.max()), float(np.abs(np.log(g_j.sum(-1))).max())),
    }
    print(f"config 5, b=1, L={L}, sequential engine: (gamma max, |log sum gamma| max) {excess}; "
          f"loglik port f32 {ll32.item()}, f64 {ll64.item()}, jax f32 {ll_j.item()}")
    # The port is the reference on the same inputs: the same loglik, and
    # log gamma within a few float32 spacings of the log-scale at |loglik|
    # (2^-7 at ~1.1e5) where gamma >= 1e-3.
    np.testing.assert_allclose(ll32.numpy(), ll_j, rtol=1e-6)
    spacing = 2.0 ** (np.floor(np.log2(np.abs(ll_j).max())) - 23)
    big = g_j >= 1e-3
    np.testing.assert_allclose(lg32.numpy()[big], lg_j[big], rtol=0, atol=4 * spacing)
    # Not normalised in either package, nor in float64.
    for name, (g_max, lse) in excess.items():
        assert g_max > 10 and lse > 1, (name, excess)
