"""The port's auxiliary inference against the JAX package on the same
inputs: exact path sampling (FFBS) fed the same Gumbel noise, its
marginal, pair-frequency and structural-zero guarantees,
``HMMLayer.sample_paths``, Baum-Welch (``expected_statistics``,
``em_step``, the categorical step), the dense streaming filter, fixed-lag
Viterbi and fixed-lag smoother, the scan loops, the profiling utilities
and the lazy exports."""

import itertools
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hmm_layer_tpu import streaming as jstreaming
from hmm_layer_tpu.ops import em as jem
from hmm_layer_tpu.ops import sampling as jsampling
from hmm_layer_tpu.ops import scan as jscan
import hmm_layer_torch
from hmm_layer_torch import HMMLayer, streaming
from hmm_layer_torch import models as tm
from hmm_layer_torch.ops import em, recursion, sampling, scan
from hmm_layer_torch.utils import profiling
from oracle import posterior_np, random_hmm


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


def _hmm(seed, q, L, b, m=1, peaked=False, zeros=()):
    """(init (m, q), A (m, q, q), E (m, b, L, q)) float32 numpy; ``zeros``
    lists structural zeros (i, j) of every model's A."""
    rng = np.random.default_rng(seed)
    parts = [random_hmm(rng, q=q, L=L, b=b, peaked=peaked) for _ in range(m)]
    init, A, E = (np.stack([p[k] for p in parts]) for k in range(3))
    for i, j in zeros:
        A[:, i, j] = 0.0
    A = (A / A.sum(-1, keepdims=True)).astype(np.float32)
    return init, A, E


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [1, 4])
def test_paths_equal_jax_on_the_same_noise(P, monkeypatch):
    """Both packages drawing the same Gumbel noise, in JAX's shapes and
    order, sample the same paths."""
    init, A, E = _hmm(0, q=4, L=16, b=2, m=2, zeros=[(1, 3), (2, 0)])
    rng = np.random.default_rng(1)
    draws = []

    def jax_gumbel(key, shape, dtype=jnp.float32):
        draws.append(rng.gumbel(size=shape).astype(np.float32))
        return jnp.asarray(draws[-1])

    monkeypatch.setattr(jax.random, "gumbel", jax_gumbel)
    ref = np.asarray(jsampling.sample_posterior(
        *map(jnp.asarray, (init, A, E)), jax.random.PRNGKey(0), num_samples=5, parallel_factor=P))
    feed = iter(list(draws))

    def port_gumbel(shape, generator, device):
        g = next(feed)
        assert g.shape == tuple(shape)
        return torch.from_numpy(g).to(device)

    monkeypatch.setattr(sampling, "_gumbel", port_gumbel)
    got = sampling.sample_posterior(*_t(init, A, E), None, num_samples=5, parallel_factor=P)
    assert got.dtype == torch.int32 and got.shape == (2, 2, 5, 16)
    assert len(draws) == (1 if P == 1 else 2)
    np.testing.assert_array_equal(got.numpy(), ref)


def _marginals(paths, q):
    return np.eye(q)[paths.numpy()].mean(axis=2)[0, 0]  # (L, q)


@pytest.mark.parametrize("P", [1, 4])
def test_marginals_match_posterior(P):
    init, A, E = random_hmm(np.random.default_rng(2), q=3, L=8, b=1)
    S = 4000
    paths = sampling.sample_posterior(*_t(init[None], A[None], E[None]), torch.Generator().manual_seed(0),
                                      num_samples=S, parallel_factor=P)
    assert paths.shape == (1, 1, S, 8)
    gam, _ = posterior_np(init, A, E[0])
    np.testing.assert_allclose(_marginals(paths, 3), np.exp(gam), atol=4.5 / np.sqrt(S))


def test_pair_frequencies_match_xi():
    init, A, E = random_hmm(np.random.default_rng(3), q=3, L=6, b=1)
    _, xi_sum, _ = em.expected_statistics(*_t(init[None], A[None], E[None]))
    S = 4000
    paths = sampling.sample_posterior(*_t(init[None], A[None], E[None]), torch.Generator().manual_seed(1),
                                      num_samples=S, parallel_factor=2)[0, 0].numpy()
    counts = np.zeros((3, 3))
    for t in range(5):
        np.add.at(counts, (paths[:, t], paths[:, t + 1]), 1.0)
    np.testing.assert_allclose(counts / S, xi_sum[0].numpy(), atol=5 * np.sqrt(5) / np.sqrt(S))


@pytest.mark.parametrize("P", [1, 4])
def test_structural_zeros_never_sampled(P):
    init, A, E = _hmm(4, q=4, L=16, b=2)
    A[0, 1, :] = 0.0
    A[0, 1, 2] = 1.0  # state 1 can only go to state 2
    paths = sampling.sample_posterior(*_t(init, A, E), torch.Generator().manual_seed(2),
                                      num_samples=64, parallel_factor=P).numpy()
    assert np.all(paths[..., 1:][paths[..., :-1] == 1] == 2)


def test_boundary_masks_match_jax_and_are_exact():
    """A deterministic 3-cycle with chunk length 4 (coprime to the
    period): the masks equal JAX's, and every sampled path is the cycle."""
    q, L, P, b = 3, 16, 4, 2
    c = L // P
    A = np.zeros((1, q, q), np.float32)
    A[0, 0, 1] = A[0, 1, 2] = A[0, 2, 0] = 1.0
    init = np.zeros((1, q), np.float32)
    init[0, 0] = 1.0
    E = np.random.default_rng(5).uniform(0.2, 1.0, (1, b, L, q)).astype(np.float32)
    reach, fmask = sampling._boundary_masks(*_t(init, A), P, c)
    reach_j, fmask_j = jsampling._boundary_masks(jnp.asarray(init), jnp.asarray(A), P, c)
    np.testing.assert_array_equal(reach.numpy(), np.asarray(reach_j))
    np.testing.assert_array_equal(fmask.numpy(), np.asarray(fmask_j))
    paths = sampling.sample_posterior(*_t(init, A, E), torch.Generator().manual_seed(3),
                                      num_samples=16, parallel_factor=P).numpy()
    want = np.broadcast_to((np.arange(L) % q)[None, None, None], paths.shape)
    np.testing.assert_array_equal(paths, want)


@pytest.mark.parametrize("P", [1, 2])
def test_joint_path_distribution_exact(P):
    init, A, E = random_hmm(np.random.default_rng(6), q=2, L=4, b=1)
    probs = {}
    for path in itertools.product(range(2), repeat=4):
        p = init[path[0]] * E[0, 0, path[0]]
        for t in range(1, 4):
            p *= A[path[t - 1], path[t]] * E[0, t, path[t]]
        probs[path] = p
    Z = sum(probs.values())
    S = 6000
    paths = sampling.sample_posterior(*_t(init[None], A[None], E[None]), torch.Generator().manual_seed(4),
                                      num_samples=S, parallel_factor=P)[0, 0].numpy()
    counts = {}
    for row in map(tuple, paths):
        counts[row] = counts.get(row, 0) + 1
    for path, p in probs.items():
        assert abs(counts.get(path, 0) / S - p / Z) < 5 * np.sqrt(p / Z / S) + 1e-3, path


def test_layer_sample_paths_valid_and_reproducible():
    layer = HMMLayer(tm.GenePredTransitions(), tm.GenePredEmissions(**CODONS),
                     parallel_factor=4, device="cpu")
    rng = np.random.default_rng(7)
    cls = rng.dirichlet(np.ones(15), size=(1, 2, 48))
    nuc = np.eye(5)[rng.integers(0, 4, size=(1, 2, 48))]
    X = np.concatenate([cls, nuc], -1).astype(np.float32)
    a = layer.sample_paths(X, num_samples=6, generator=torch.Generator().manual_seed(8))
    b = layer.sample_paths(X, num_samples=6, generator=torch.Generator().manual_seed(8))
    assert a.shape == (1, 2, 6, 48) and torch.equal(a, b)
    init, A = (x.detach().numpy()[0] for x in layer.transitions.matrices())
    p = a.numpy()[0]
    assert (init[p[..., 0]] > 0).all()
    assert (A[p[..., :-1], p[..., 1:]] > 0).all()


# ---------------------------------------------------------------------------
# Baum-Welch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [1, 4])
def test_expected_statistics_match_jax(P):
    init, A, E = _hmm(9, q=4, L=32, b=3, m=2, zeros=[(0, 2)])
    gam_t, xi_t, ll_t = em.expected_statistics(*_t(init, A, E), parallel_factor=P)
    gam_j, xi_j, ll_j = jem.expected_statistics(*map(jnp.asarray, (init, A, E)), parallel_factor=P)
    np.testing.assert_allclose(gam_t.numpy(), np.asarray(gam_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xi_t.numpy(), np.asarray(xi_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-5)


@pytest.mark.parametrize("P", [1, 4])
def test_em_steps_match_jax_and_are_monotone(P):
    init, A, E = _hmm(10, q=4, L=32, b=3, zeros=[(0, 2)])
    it, At = _t(init, A)
    ij, Aj = jnp.asarray(init), jnp.asarray(A)
    Et, Ej = torch.from_numpy(E), jnp.asarray(E)
    lls = []
    for _ in range(3):
        it, At, ll_t = em.em_step(it, At, Et, parallel_factor=P, pseudocount=0.01)
        ij, Aj, ll_j = jem.em_step(ij, Aj, Ej, parallel_factor=P, pseudocount=0.01)
        np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(At.numpy(), np.asarray(Aj), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-5)
        lls.append(float(ll_t.sum()))
    assert all(b2 >= a2 - 1e-3 for a2, b2 in zip(lls, lls[1:])), lls
    np.testing.assert_allclose(At.sum(-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(it.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert float(At[0, 0, 2]) == 0.0  # structural zeros stay


def test_em_step_categorical_matches_jax():
    rng = np.random.default_rng(11)
    q, s, L, b = 3, 4, 20, 2
    init = rng.dirichlet(np.ones(q), size=1).astype(np.float32)
    A = rng.dirichlet(np.ones(q), size=(1, q)).astype(np.float32)
    B = rng.dirichlet(np.ones(s), size=(1, q)).astype(np.float32)
    x = np.eye(s, dtype=np.float32)[rng.integers(0, s, size=(1, b, L))]
    got = em.em_step_categorical(*_t(init, A, B, x), parallel_factor=4, pseudocount=0.1)
    ref = jem.em_step_categorical(*map(jnp.asarray, (init, A, B, x)), parallel_factor=4, pseudocount=0.1)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------


def test_streaming_filter_matches_jax_and_dense():
    init, A, E = _hmm(12, q=6, L=96, b=3)
    it, At, Et = _t(init, A, E)
    blocks = [(slice(0, 32), 4), (slice(32, 80), 4), (slice(80, 96), 1)]
    st = streaming.streaming_init(it, At, Et[:, :, blocks[0][0]], parallel_factor=4)
    sj = jstreaming.streaming_init(*map(jnp.asarray, (init, A, E[:, :, blocks[0][0]])), parallel_factor=4)
    for sl, pf in blocks[1:]:
        st = streaming.streaming_update(st, At, Et[:, :, sl], parallel_factor=pf)
        sj = jstreaming.streaming_update(sj, jnp.asarray(A), jnp.asarray(E[:, :, sl]), parallel_factor=pf)
    ll_ref = recursion.log_likelihood(it, At, Et)
    la_ref, _ = recursion.forward(it, At, Et)
    np.testing.assert_allclose(streaming.streaming_log_likelihood(st).numpy(), ll_ref.numpy(), rtol=1e-4)
    np.testing.assert_allclose(st.log_lik.numpy(), np.asarray(sj.log_lik), rtol=1e-5)
    f = streaming.streaming_filter_log_probs(st)
    np.testing.assert_allclose(f.numpy(), np.asarray(sj.log_filter), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f.numpy(), (la_ref[:, :, -1] - ll_ref[..., None]).numpy(), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(torch.logsumexp(f, -1).numpy(), 0.0, atol=1e-5)


def test_sparse_streaming_raises():
    """The sparse streams are ported (held against the whole sequence in
    ``tests/test_torch_sparse.py``); a malformed edge list raises."""
    for fn in (streaming.sparse_streaming_init, streaming.sparse_streaming_update):
        with pytest.raises(ValueError, match="n_edges, 2"):
            fn(None, np.zeros((3, 3), np.int64), None, torch.ones((1, 1, 2, 4)))


def _decode_streamed(mod, init, A, E, block, lag):
    L = E.shape[2]
    state, out = mod.streaming_viterbi_init(init, A, E[:, :, :block], lag)
    outs = [np.asarray(out)]
    for s in range(block, L, block):
        state, out = mod.streaming_viterbi_update(state, init, A, E[:, :, s : s + block])
        outs.append(np.asarray(out))
    outs.append(np.asarray(mod.streaming_viterbi_finalize(state, init, A)))
    return np.concatenate(outs, axis=-1)


@pytest.mark.parametrize("block,lag,peaked", [(24, 16, True), (12, 12, True), (16, 2, False)],
                         ids=["lag16", "first-block-equals-lag", "lag2"])
def test_streaming_viterbi_matches_jax(block, lag, peaked):
    init, A, E = _hmm(13, q=5, L=96 if lag == 16 else 48, b=2, peaked=peaked, zeros=[(0, 4), (2, 1)])
    streamed = _decode_streamed(streaming, *_t(init, A, E), block, lag)
    ref = _decode_streamed(jstreaming, *map(jnp.asarray, (init, A, E)), block, lag)
    np.testing.assert_array_equal(streamed, ref)
    assert (A[0][streamed[0, :, :-1], streamed[0, :, 1:]] > 0).all()
    if lag >= 12:  # survivors merge within the lag: the offline decode
        np.testing.assert_array_equal(streamed, recursion.viterbi(*_t(init, A, E)).numpy())
    with pytest.raises(ValueError, match="lag"):
        streaming.streaming_viterbi_init(*_t(init, A, E), lag=0)


@pytest.mark.parametrize("pf", [1, 4])
def test_streaming_smoother_matches_jax_and_truncated_offline(pf):
    """lag 3, blocks of 16 and 12: every window divides by 4 (16, and
    1 + 3 + 12 = 16 with the seam's pseudo-position) except the final 4."""
    init, A, E = _hmm(14, q=4, L=31, b=2)
    it, At, Et = _t(init, A, E)
    ij, Aj, Ej = map(jnp.asarray, (init, A, E))
    st, c0 = streaming.streaming_smoother_init(it, At, Et[:, :, :16], lag=3, parallel_factor=pf)
    sj, d0 = jstreaming.streaming_smoother_init(ij, Aj, Ej[:, :, :16], lag=3, parallel_factor=pf)
    st, c1 = streaming.streaming_smoother_update(st, At, Et[:, :, 16:28], parallel_factor=pf)
    sj, d1 = jstreaming.streaming_smoother_update(sj, Aj, Ej[:, :, 16:28], parallel_factor=pf)
    st, c2 = streaming.streaming_smoother_update(st, At, Et[:, :, 28:], parallel_factor=1)
    sj, d2 = jstreaming.streaming_smoother_update(sj, Aj, Ej[:, :, 28:], parallel_factor=1)
    tail = streaming.streaming_smoother_finalize(st, At, parallel_factor=pf)
    tail_j = jstreaming.streaming_smoother_finalize(sj, Aj, parallel_factor=pf)
    for got, ref in ((c0, d0), (c1, d1), (c2, d2), (tail, tail_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
    # Each commit is the offline posterior of the stream truncated at its
    # window's end; the tail is full smoothing.
    for got, end, lo in ((c0, 16, 0), (c1, 28, 13), (c2, 31, 25)):
        ref, _ = recursion.posterior(it, At, Et[:, :, :end])
        np.testing.assert_allclose(got.numpy(), ref[:, :, lo : lo + got.shape[2]].numpy(), atol=2e-4)
    np.testing.assert_allclose(tail.numpy(), ref[:, :, 28:].numpy(), atol=2e-4)
    ll28 = recursion.log_likelihood(it, At, Et[:, :, :28])
    np.testing.assert_allclose(st.log_lik.numpy(), ll28.numpy(), rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="must be > lag"):
        streaming.streaming_smoother_init(it, At, Et[:, :, :3], lag=3)


# ---------------------------------------------------------------------------
# scan loops
# ---------------------------------------------------------------------------


def _cells(W, U, lib):
    tanh = torch.tanh if lib is torch else jnp.tanh

    def fwd(x, h):
        h = tanh(x @ W + h @ U)
        return h, h

    def bwd(x, state):
        h, n = state["h"], state["n"]
        h = tanh(x @ U.T + 0.5 * h)
        return 2 * h, {"h": h, "n": n + 1}

    return fwd, bwd


@pytest.mark.parametrize("merge_mode", ["concat", "sum", "mul", "ave", None])
def test_scan_loops_match_jax(merge_mode):
    rng = np.random.default_rng(15)
    x = rng.normal(size=(2, 7, 3)).astype(np.float32)
    W = rng.normal(size=(3, 3)).astype(np.float32)
    U = rng.normal(size=(3, 3)).astype(np.float32) * 0.5
    h0 = np.zeros((2, 3), np.float32)
    tf, tb = _cells(*_t(W, U), torch)
    jf, jb = _cells(jnp.asarray(W), jnp.asarray(U), jnp)
    h0t, h0j = torch.from_numpy(h0), jnp.asarray(h0)
    bwd0 = ({"h": h0t, "n": torch.tensor(0)}, {"h": h0j, "n": jnp.asarray(0)})

    def check(got, ref):
        got_leaves = got if isinstance(got, (tuple, list)) else [got]
        ref_leaves = jax.tree.leaves(ref)
        flat = []
        stack = list(got_leaves)
        while stack:
            item = stack.pop(0)
            if isinstance(item, dict):
                stack = list(item.values()) + stack
            elif isinstance(item, (tuple, list)):
                stack = list(item) + stack
            else:
                flat.append(item)
        assert len(flat) == len(ref_leaves)
        for g, r in zip(flat, ref_leaves):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)

    check(scan.bidirectional_scan(tf, tb, torch.from_numpy(x), h0t, bwd0[0], merge_mode=merge_mode),
          jscan.bidirectional_scan(jf, jb, jnp.asarray(x), h0j, bwd0[1], merge_mode=merge_mode))
    if merge_mode == "concat":
        for kwargs in (dict(reverse=True), dict(return_sequences=False, return_state=True),
                       dict(reverse=True, return_sequences=False, time_axis=1)):
            check(scan.rnn_scan(tf, torch.from_numpy(x), h0t, **kwargs),
                  jscan.rnn_scan(jf, jnp.asarray(x), h0j, **kwargs))
        check(scan.bidirectional_scan(tf, tb, torch.from_numpy(x), h0t, bwd0[0], return_state=True),
              jscan.bidirectional_scan(jf, jb, jnp.asarray(x), h0j, bwd0[1], return_state=True))
    with pytest.raises(ValueError, match="merge_mode"):
        scan.bidirectional_scan(tf, tb, torch.from_numpy(x), h0t, bwd0[0], merge_mode="max")


# ---------------------------------------------------------------------------
# profiling and exports
# ---------------------------------------------------------------------------


def test_profiling_utilities_on_the_cpu(tmp_path):
    calls = []

    def fn(a, scale=1.0):
        calls.append(1)
        return {"out": (a * scale).sum(), "rest": [a]}

    seconds, result = profiling.timed(fn, torch.ones(3), scale=2.0, iters=3, warmup=2)
    assert seconds >= 0 and float(result["out"]) == 6.0 and len(calls) == 5
    synced = []
    profiling.timed(fn, torch.ones(3), sync=synced.append, iters=1, warmup=0)
    assert len(synced) == 1

    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages()
    with open(tmp_path / "tr" / "trace.json") as fh:
        assert "traceEvents" in json.load(fh)

    before = torch.is_anomaly_enabled()
    with profiling.debug_nans():
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan|NaN"):
            torch.sqrt(x).sum().backward()
    assert torch.is_anomaly_enabled() == before


def test_lazy_exports():
    for name, module in [("sample_posterior", sampling), ("em_step", em),
                         ("expected_statistics", em), ("rnn_scan", scan),
                         ("bidirectional_scan", scan)]:
        assert getattr(hmm_layer_torch, name) is getattr(module, name)
        assert getattr(hmm_layer_torch.ops, name) is getattr(module, name)
        assert name in hmm_layer_torch.__all__
    assert hmm_layer_torch.streaming is streaming
    assert hmm_layer_torch.set_prior_alpha is not None
