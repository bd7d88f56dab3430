"""The port's sparse edge-list engine (``hmm_layer_torch.ops.sparse``, the
sparse streaming filter and the ``sparse_forward`` routes of ``HMMLayer``)
against the JAX package on the same inputs and parameters, at the shapes
and tolerances of ``tests/test_sparse.py``, and against the port's dense
engine."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hmm_layer_tpu import streaming as jstreaming
from hmm_layer_tpu.layer import HMMLayer as JHMMLayer
from hmm_layer_tpu.models import GenePredMultiTransitions as JMulti
from hmm_layer_tpu.models import SimpleGenePredTransitions as JSimple
from hmm_layer_tpu.ops import sparse as jsparse
from hmm_layer_torch import HMMLayer, load_jax_params, streaming
from hmm_layer_torch import models as tm
from hmm_layer_torch.convert import params_from_jax
from hmm_layer_torch.ops import em, recursion, sparse
from hmm_layer_torch.models import transition_utils as ttu
from hmm_layer_torch.ops import sampling


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tiny CPU ops: the test workers
    share the cores, and per-op thread pools contending for them made
    these tests many times slower than one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KEY = jax.random.PRNGKey(0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _emissions(rng, m, b, L, q):
    return rng.uniform(0.05, 1.0, (m, b, L, q)).astype(np.float32)


def _port_transitions(jtrans, params, **kwargs):
    """The port's module of ``jtrans``'s class and size with JAX's params."""
    if isinstance(jtrans, JMulti):
        t = tm.GenePredMultiTransitions(k=jtrans.k, **kwargs)
    else:
        t = getattr(tm, type(jtrans).__name__)(**kwargs)
    t.load_state_dict(params_from_jax(params))
    return t


class Problem:
    """A JAX grammar with its params, the port's twin module and seeded
    emissions; numpy arrays and CPU tensors of init, A, the edge list and
    E."""

    def __init__(self, k=2, b=3, L=18, seed=1, simple=False):
        self.jt = JSimple() if simple else JMulti(k=k)
        self.params = self.jt.init_params(KEY if simple else jax.random.fold_in(KEY, seed))
        init, A = self.jt.matrices(self.params)
        self.indices, probs = self.jt.make_A_sparse(self.params)
        self.init, self.A, self.probs = (np.asarray(x) for x in (init, A, probs))
        self.q = self.jt.num_states
        self.E = _emissions(np.random.default_rng(seed), 1, b, L, self.q)

    def torch(self, *names):
        return tuple(_t(getattr(self, n)) for n in names)


def _leaf_grads(*tensors):
    return tuple(x.grad.numpy() for x in tensors)


def _compare(got, ref, rtol=5e-3):
    for a, b in zip(got, ref):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(b).max(), 1e-8)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


def _path_score(init, A, E, paths):
    """Joint float64 log-probability of paths (m, b, L) and whether every
    transition has A > 0."""
    init, A, E = (np.asarray(x, np.float64) for x in (init, A, E))
    paths = np.asarray(paths)
    m, b, L = paths.shape
    out, valid = np.zeros((m, b)), True
    for i in range(m):
        for j in range(b):
            p = paths[i, j]
            out[i, j] = (np.log(init[i, p[0]]) + np.log(E[i, j, np.arange(L), p]).sum()
                         + np.log(A[i, p[:-1], p[1:]]).sum())
            valid &= bool(np.all(A[i, p[:-1], p[1:]] > 0))
    return out, valid


# ---------------------------------------------------------------------------
# edge softmax and the edge plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jcls,kw", [(JSimple, {}), (JMulti, {"k": 3}), (JMulti, {"k": 36})])
def test_make_A_sparse_matches_jax(jcls, kw):
    jt = jcls(**kw)
    params = jt.init_params(KEY)
    t = _port_transitions(jt, params, sparse_forward=True)
    idx_j, p_j = jt.make_A_sparse(params)
    idx, p = t.make_A_sparse()
    assert isinstance(idx, np.ndarray)
    np.testing.assert_array_equal(idx, np.asarray(idx_j))
    assert tuple(p.shape) == (jt.num_models, jt.num_transitions)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_j), rtol=1e-6, atol=1e-7)
    _, lp_j = jt.make_log_A_sparse(params)
    _, lp = t.make_log_A_sparse()
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(lp_j), rtol=1e-6)
    # rows stochastic over their out-edges, equal to the dense matrix
    rows = idx[:, 0]
    sums = np.zeros(jt.num_states)
    np.add.at(sums, rows, p[0].detach().numpy())
    np.testing.assert_allclose(sums[np.unique(rows)], 1.0, rtol=1e-5)
    A = t.make_A()[0].detach().numpy()
    np.testing.assert_allclose(p[0].detach().numpy(), A[idx[:, 0], idx[:, 1]], rtol=1e-6, atol=1e-7)


def test_edge_plan_matches_jax_and_is_cached():
    idx = JMulti(k=3).make_transition_indices()
    plan, ref = sparse.EdgePlan.cached(idx), jsparse.EdgePlan.cached(idx)
    for name in ("indices", "src_d", "dst_d", "perm_d", "inv_d", "src_s", "dst_s", "perm_s"):
        np.testing.assert_array_equal(getattr(plan, name), getattr(ref, name))
    assert plan.n == ref.n
    assert sparse.EdgePlan.cached(np.array(idx, np.int32)) is plan
    assert sparse.EdgePlan.cached(torch.from_numpy(idx)) is plan
    assert plan == sparse.EdgePlan(idx) and hash(plan) == hash(sparse.EdgePlan(idx))
    dp = plan.on("cpu", 1 + 14 * 3)
    assert plan.on(torch.device("cpu"), 1 + 14 * 3) is dp
    # A tensor on a device other than the CPU is refused (reading a CUDA
    # one would synchronise the device on every call).
    with pytest.raises(TypeError, match="host array"):
        sparse.EdgePlan.cached(torch.empty((4, 2), dtype=torch.int64, device="meta"))


def test_matvec_matches_dense():
    pb = Problem(k=2)
    plan = sparse.EdgePlan.cached(pb.indices)
    y = _t(np.random.default_rng(0).uniform(size=(1, 3, pb.q)).astype(np.float32))
    A = _t(pb.A)
    for transpose, ref in ((False, y @ A.transpose(-1, -2)), (True, y @ A)):
        got = plan.matvec(_t(pb.probs), y, pb.q, transpose=transpose)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# recursions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def k2():
    """k = 2, b = 3, L = 18 with the JAX sparse results."""
    pb = Problem()

    @jax.jit
    def ref(init, probs, E):
        args = (init, pb.indices, probs, E)
        la, ll = jsparse.sparse_forward(*args)
        return {
            "la": la,
            "ll": ll,
            "lb": jsparse.sparse_backward(*args[1:]),
            "lg": jsparse.sparse_posterior(*args)[0],
            "ll_fast": jsparse.sparse_log_likelihood(*args),
            "paths": jsparse.sparse_viterbi(*args),
        }

    pb.ref = {k: np.asarray(v) for k, v in ref(pb.init, pb.probs, jnp.asarray(pb.E)).items()}
    return pb


def test_recursions_match_jax(k2):
    init, probs, E = k2.torch("init", "probs", "E")
    la, ll = sparse.sparse_forward(init, k2.indices, probs, E)
    np.testing.assert_allclose(la.numpy(), k2.ref["la"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ll.numpy(), k2.ref["ll"], rtol=1e-5)
    lb = sparse.sparse_backward(k2.indices, probs, E)
    np.testing.assert_allclose(lb.numpy(), k2.ref["lb"], rtol=2e-4, atol=2e-4)
    lg, ll2 = sparse.sparse_posterior(init, k2.indices, probs, E)
    np.testing.assert_allclose(lg.numpy(), k2.ref["lg"], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(ll2.numpy(), ll.numpy())
    ll3 = sparse.sparse_log_likelihood(init, k2.indices, probs, E)
    np.testing.assert_allclose(ll3.numpy(), k2.ref["ll_fast"], rtol=1e-5)


def test_recursions_match_dense_engine(k2):
    init, A, probs, E = k2.torch("init", "A", "probs", "E")
    la_d, ll_d = recursion.forward(init, A, E)
    la, ll = sparse.sparse_forward(init, k2.indices, probs, E)
    np.testing.assert_allclose(la.numpy(), la_d.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ll.numpy(), ll_d.numpy(), rtol=1e-5)
    lb = sparse.sparse_backward(k2.indices, probs, E)
    np.testing.assert_allclose(lb.numpy(), recursion.backward(init, A, E).numpy(), rtol=2e-4, atol=2e-4)
    for no_loglik in (False, True):
        lg, _ = sparse.sparse_posterior(init, k2.indices, probs, E, no_loglik=no_loglik)
        lg_d, _ = recursion.posterior(init, A, E, no_loglik=no_loglik)
        np.testing.assert_allclose(lg.numpy(), lg_d.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        sparse.sparse_log_likelihood(init, k2.indices, probs, E).numpy(),
        recursion.log_likelihood(init, A, E).numpy(), rtol=1e-5,
    )


def test_viterbi_matches_jax_and_dense(k2):
    init, A, probs, E = k2.torch("init", "A", "probs", "E")
    paths = sparse.sparse_viterbi(init, k2.indices, probs, E)
    assert paths.dtype == torch.int32 and tuple(paths.shape) == (1, 3, 18)
    s, valid = _path_score(k2.init, k2.A, k2.E, paths.numpy())
    s_j, _ = _path_score(k2.init, k2.A, k2.E, k2.ref["paths"])
    s_d, _ = _path_score(k2.init, k2.A, k2.E, recursion.viterbi(init, A, E).numpy())
    assert valid
    np.testing.assert_allclose(s, s_j, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s, s_d, rtol=1e-5, atol=1e-4)


def test_505_state_config5_matches_jax():
    """BASELINE config 5's state count: 1 + 14·36 = 505 states, 793 edges."""
    pb = Problem(k=36, b=2, L=12, seed=3)
    assert pb.q == 505 and len(pb.indices) == 793
    init, probs, E = pb.torch("init", "probs", "E")
    ll = sparse.sparse_log_likelihood(init, pb.indices, probs, E)
    ll_j, paths_j = jax.jit(lambda i, p, e: (jsparse.sparse_log_likelihood(i, pb.indices, p, e),
                                             jsparse.sparse_viterbi(i, pb.indices, p, e)))(
        pb.init, pb.probs, jnp.asarray(pb.E))
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_j), rtol=1e-4)
    paths = sparse.sparse_viterbi(init, pb.indices, probs, E).numpy()
    paths_j = np.asarray(paths_j)
    s, valid = _path_score(pb.init, pb.A, pb.E, paths)
    s_j, _ = _path_score(pb.init, pb.A, pb.E, paths_j)
    assert valid
    np.testing.assert_allclose(s, s_j, rtol=1e-5, atol=1e-4)


def test_forward_is_deterministic(k2):
    init, probs, E = k2.torch("init", "probs", "E")
    a = sparse.sparse_forward(init, k2.indices, probs, E)
    b = sparse.sparse_forward(init, k2.indices, probs, E)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# analytic gradients
# ---------------------------------------------------------------------------


def _grad_problem(L, seed):
    pb = Problem(k=1, b=2, L=L, seed=seed)
    return pb, (_t(pb.init), _t(pb.probs), _t(pb.E))


def _port_grads(fn, *args):
    leaves = [a.clone().requires_grad_() for a in args]
    fn(*leaves).backward()
    return _leaf_grads(*leaves)


@pytest.mark.parametrize("L", [40, 1200])
def test_loglik_grads_match_taped_and_jax(L):
    pb, args = _grad_problem(L, 11)

    def port(analytic):
        return lambda i, p, e: sparse.sparse_log_likelihood(i, pb.indices, p, e, analytic_vjp=analytic).sum()

    g_fast = _port_grads(port(True), *args)
    _compare(g_fast, _port_grads(port(False), *args))
    g_j = jax.jit(jax.grad(lambda i, p, e: jnp.sum(jsparse.sparse_log_likelihood(i, pb.indices, p, e)),
                           argnums=(0, 1, 2)))(pb.init, pb.probs, jnp.asarray(pb.E))
    _compare(g_fast, g_j)


@pytest.mark.parametrize("L", [40, 1200])
@pytest.mark.parametrize("no_loglik", [False, True])
def test_posterior_grads_match_taped_and_jax(L, no_loglik):
    pb, args = _grad_problem(L, 13)
    w = np.random.default_rng(17).uniform(0.0, 1.0, pb.E.shape).astype(np.float32)

    def port(analytic):
        def loss(i, p, e):
            lg, ll = sparse.sparse_posterior(i, pb.indices, p, e, no_loglik=no_loglik, analytic_vjp=analytic)
            return (lg * _t(w)).sum() + 0.25 * ll.sum()

        return loss

    def jloss(i, p, e):
        lg, ll = jsparse.sparse_posterior(i, pb.indices, p, e, no_loglik=no_loglik)
        return jnp.sum(lg * w) + 0.25 * jnp.sum(ll)

    g_fast = _port_grads(port(True), *args)
    _compare(g_fast, _port_grads(port(False), *args))
    _compare(g_fast, jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(pb.init, pb.probs, jnp.asarray(pb.E)))


def test_posterior_grads_match_dense_engine():
    """The CE gradient through the sparse analytic adjoint equals the one
    through the port's dense chunked analytic adjoint (an independent
    oracle), chained through each route's edge softmax."""
    t = tm.SimpleGenePredTransitions()
    rng = np.random.default_rng(23)
    E = _t(_emissions(rng, 1, 2, 64, t.num_states))
    onehot = _t(np.eye(t.num_states, dtype=np.float32)[rng.integers(0, t.num_states, (1, 2, 64))])
    init = t.make_initial_distribution().detach()
    kernel = t.transition_kernel.detach()
    idx = t.make_transition_indices()

    def dense(k, e):
        A = ttu.masked_row_softmax_from_edges(idx, k, t.num_states)[None]
        return -(recursion.posterior(init, A, e, 4)[0] * onehot).sum(-1).mean()

    def sparse_loss(k, e):
        p = ttu.sparse_edge_softmax(idx, k, t.num_states)[None]
        return -(sparse.sparse_posterior(init, idx, p, e)[0] * onehot).sum(-1).mean()

    _compare(_port_grads(sparse_loss, kernel, E), _port_grads(dense, kernel, E), rtol=2e-3)


def test_fast_primal_equals_taped_primal():
    pb, (init, probs, E) = _grad_problem(40, 11)
    ll_f = sparse.sparse_log_likelihood(init, pb.indices, probs, E)
    ll_t = sparse.sparse_log_likelihood(init, pb.indices, probs, E, analytic_vjp=False)
    assert torch.equal(ll_f, ll_t)
    lg_f, _ = sparse.sparse_posterior(init, pb.indices, probs, E)
    lg_t, _ = sparse.sparse_posterior(init, pb.indices, probs, E, analytic_vjp=False)
    assert torch.equal(lg_f, lg_t)


# ---------------------------------------------------------------------------
# memory modes: the blocked backward and the fused cross-entropy
# ---------------------------------------------------------------------------


def _labelled(L, seed, b=3):
    pb = Problem(k=2, b=b, L=L, seed=seed)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, pb.q, (1, b, L))
    mask = (rng.random((1, b, L)) > 0.3).astype(np.float32)
    return pb, labels, mask


def _scale_close(got, ref, atol):
    for a, b in zip(got, ref):
        scale = np.abs(np.asarray(b)).max() + 1e-9
        np.testing.assert_allclose(np.asarray(a) / scale, np.asarray(b) / scale, atol=atol)


@pytest.mark.parametrize("L,block,no_loglik", [(48, 12, False), (48, 12, True), (48, 48, False), (64, 8, False)])
def test_blocked_backward_matches_fast_path(L, block, no_loglik):
    pb, labels, _ = _labelled(L, 9)
    lab = _t(labels)[..., None]

    def ce(blk):
        def f(p, i, e):
            lg, ll = sparse.sparse_posterior(i, pb.indices, p, e, no_loglik=no_loglik, backward_block=blk)
            return -lg.gather(-1, lab).mean() + 0.3 * ll.mean()

        return f

    args = pb.torch("probs", "init", "E")
    leaves1 = [a.clone().requires_grad_() for a in args]
    v1 = ce(None)(*leaves1)
    v1.backward()
    leaves2 = [a.clone().requires_grad_() for a in args]
    v2 = ce(block)(*leaves2)
    v2.backward()
    assert v1.item() == v2.item()  # identical primal
    _scale_close(_leaf_grads(*leaves2), _leaf_grads(*leaves1), 5e-5)


def test_backward_block_errors_and_global_knob():
    pb, labels, _ = _labelled(48, 9)
    init, probs, E = pb.torch("init", "probs", "E")
    with pytest.raises(ValueError, match="divide"):
        sparse.sparse_posterior(init, pb.indices, probs, E, backward_block=13)
    with pytest.raises(ValueError, match="divide"):
        sparse.sparse_posterior_cross_entropy(init, pb.indices, probs, E, _t(labels), backward_block=13)
    with pytest.raises(ValueError, match="analytic_vjp"):
        sparse.sparse_posterior(init, pb.indices, probs, E, analytic_vjp=False, backward_block=6)
    prev, prev_j = sparse.set_sparse_posterior_block(12), jsparse.set_sparse_posterior_block(12)
    try:
        p = probs.clone().requires_grad_()
        lg, _ = sparse.sparse_posterior(init, pb.indices, p, E)
        assert lg.grad_fn.name().startswith("_SparsePosteriorBlocked")
        (-lg.gather(-1, _t(labels)[..., None]).mean()).backward()
        g_j = jax.jit(jax.grad(lambda pr: -jnp.mean(jnp.take_along_axis(
            jsparse.sparse_posterior(pb.init, pb.indices, pr, jnp.asarray(pb.E))[0],
            jnp.asarray(labels)[..., None], -1))))(pb.probs)
        _compare([p.grad.numpy()], [g_j], rtol=1e-4)
    finally:
        assert sparse.set_sparse_posterior_block(prev) == 12
        jsparse.set_sparse_posterior_block(prev_j)


@pytest.mark.parametrize("block,no_loglik,use_mask", [(None, False, False), (12, False, True), (12, True, False)])
def test_fused_ce_matches_unfused(block, no_loglik, use_mask):
    pb, labels, mask = _labelled(48, 11)
    lab = _t(labels)
    mk = _t(mask) if use_mask else None

    def unfused(p, i, e):
        lg, _ = sparse.sparse_posterior(i, pb.indices, p, e, no_loglik=no_loglik)
        ce = -lg.gather(-1, lab[..., None])[..., 0]
        return (ce * mk).sum() / mk.sum().clamp_min(1.0) if use_mask else ce.mean()

    def fused(p, i, e):
        return sparse.sparse_posterior_cross_entropy(
            i, pb.indices, p, e, lab, label_mask=mk, no_loglik=no_loglik, backward_block=block)

    args = pb.torch("probs", "init", "E")
    l1 = [a.clone().requires_grad_() for a in args]
    v1 = unfused(*l1)
    v1.backward()
    l2 = [a.clone().requires_grad_() for a in args]
    v2 = fused(*l2)
    v2.backward()
    assert abs(v1.item() - v2.item()) < 1e-6
    _scale_close(_leaf_grads(*l2), _leaf_grads(*l1), 5e-5)


def test_fused_ce_matches_jax():
    pb, labels, mask = _labelled(48, 11)
    v_j, g_j = jax.jit(jax.value_and_grad(
        lambda p, i, e: jsparse.sparse_posterior_cross_entropy(
            i, pb.indices, p, e, jnp.asarray(labels), label_mask=jnp.asarray(mask), backward_block=12),
        argnums=(0, 1, 2),
    ))(pb.probs, pb.init, jnp.asarray(pb.E))
    leaves = [a.clone().requires_grad_() for a in pb.torch("probs", "init", "E")]
    v = sparse.sparse_posterior_cross_entropy(
        leaves[1], pb.indices, leaves[0], leaves[2], _t(labels), label_mask=_t(mask), backward_block=12)
    v.backward()
    np.testing.assert_allclose(v.item(), float(v_j), rtol=1e-5)
    _compare(_leaf_grads(*leaves), g_j, rtol=1e-4)


@pytest.mark.parametrize("clamp_active", [False, True])
def test_fused_ce_mask_gradient(clamp_active):
    """The mask is a real operand: a soft mask gets the unfused formula's
    gradient, with sum(mask) > 1 and with the max(sum, 1) clamp active
    (sum(mask) <= 1, where the -ce/N term vanishes)."""
    pb = Problem(k=2, b=1 if clamp_active else 3, L=8 if clamp_active else 24, seed=0)
    rng = np.random.default_rng(0)
    lab = _t(rng.integers(0, pb.q, pb.E.shape[:3]))
    if clamp_active:
        mask = np.zeros(pb.E.shape[:3], np.float32)
        mask[0, 0, 2], mask[0, 0, 5] = 0.3, 0.2
    else:
        mask = rng.uniform(0.2, 1.0, pb.E.shape[:3]).astype(np.float32)
    init, probs, E = pb.torch("init", "probs", "E")

    def unfused(mk):
        lg, _ = sparse.sparse_posterior(init, pb.indices, probs, E)
        ce = -lg.gather(-1, lab[..., None])[..., 0]
        return (ce * mk).sum() / mk.sum().clamp_min(1.0)

    def fused(mk):
        return sparse.sparse_posterior_cross_entropy(
            init, pb.indices, probs, E, lab, label_mask=mk, backward_block=4)

    g1 = _port_grads(unfused, _t(mask))[0]
    g2 = _port_grads(fused, _t(mask))[0]
    assert np.abs(g1).max() > 0
    np.testing.assert_allclose(g2, g1, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def test_paths_equal_jax_on_the_same_noise(monkeypatch):
    """Both packages fed the same Gumbel noise sample the same paths. The
    JAX side runs without jit, so its scan calls ``jax.random.gumbel``
    once per step, in reverse t, after the draw for position L - 1."""
    pb = Problem(k=2, b=2, L=12, seed=5)
    S = 3
    rng = np.random.default_rng(1)
    draws = []

    def jax_gumbel(key, shape, dtype=jnp.float32):
        draws.append(rng.gumbel(size=shape).astype(np.float32))
        return jnp.asarray(draws[-1])

    monkeypatch.setattr(jax.random, "gumbel", jax_gumbel)
    with jax.disable_jit():
        ref = np.asarray(jsparse.sparse_sample_paths(
            pb.init, pb.indices, pb.probs, jnp.asarray(pb.E), KEY, num_samples=S))
    assert len(draws) == 12
    feed = iter(list(draws))

    def port_gumbel(shape, generator, device):
        g = next(feed)
        assert g.shape == tuple(shape)
        return torch.from_numpy(g).to(device)

    monkeypatch.setattr(sampling, "_gumbel", port_gumbel)
    got = sparse.sparse_sample_paths(*pb.torch("init"), pb.indices, *pb.torch("probs", "E"), None, S)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, 2, S, 12)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_never_samples_absent_or_zero_edges():
    pb = Problem(k=2, b=2, L=24, seed=5)
    probs = pb.probs.copy()
    dead = 3
    probs[:, dead] = 0.0
    paths = sparse.sparse_sample_paths(
        _t(pb.init), pb.indices, _t(probs), _t(pb.E), torch.Generator().manual_seed(2), 64).numpy()
    edge_ok = np.zeros((pb.q, pb.q), bool)
    edge_ok[pb.indices[:, 0], pb.indices[:, 1]] = True
    edge_ok[pb.indices[dead, 0], pb.indices[dead, 1]] = False
    assert edge_ok[paths[..., :-1].ravel(), paths[..., 1:].ravel()].all()
    assert (pb.init[0][paths[..., 0]] > 0).all()


def test_marginals_and_pairs_match_posterior():
    pb = Problem(k=1, b=1, L=8, seed=5)
    init, probs, E = pb.torch("init", "probs", "E")
    S = 3000
    paths = sparse.sparse_sample_paths(init, pb.indices, probs, E, torch.Generator().manual_seed(0), S)
    assert tuple(paths.shape) == (1, 1, S, 8)
    emp = np.eye(pb.q)[paths.numpy()].mean(axis=2)[0, 0]
    lg, _ = sparse.sparse_posterior(init, pb.indices, probs, E)
    np.testing.assert_allclose(emp, np.exp(lg.numpy())[0, 0], atol=4.5 / np.sqrt(S))
    _, xi_edge, _ = sparse.sparse_expected_statistics(init, pb.indices, probs, E)
    p = paths.numpy()[0, 0]
    counts = np.zeros((pb.q, pb.q))
    for t in range(7):
        np.add.at(counts, (p[:, t], p[:, t + 1]), 1.0)
    np.testing.assert_allclose(counts[pb.indices[:, 0], pb.indices[:, 1]] / S, xi_edge.numpy()[0],
                               atol=5 * np.sqrt(7) / np.sqrt(S))
    off = np.ones((pb.q, pb.q), bool)
    off[pb.indices[:, 0], pb.indices[:, 1]] = False
    assert counts[off].sum() == 0.0


# ---------------------------------------------------------------------------
# EM
# ---------------------------------------------------------------------------


def test_em_step_matches_jax_and_dense():
    pb = Problem(k=2, b=3, L=18, seed=7)
    init, A, probs, E = pb.torch("init", "A", "probs", "E")
    ini, w, ll = sparse.sparse_em_step(init, pb.indices, probs, E)
    (ini_j, w_j, ll_j), (gamma_j, xi_j, _) = jax.jit(
        lambda i, p, e: (jsparse.sparse_em_step(i, pb.indices, p, e),
                         jsparse.sparse_expected_statistics(i, pb.indices, p, e)))(
        pb.init, pb.probs, jnp.asarray(pb.E))
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_j), rtol=1e-5)
    np.testing.assert_allclose(ini.numpy(), np.asarray(ini_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-4, atol=1e-6)
    ini_d, A_d, ll_d = em.em_step(init, A, E)
    np.testing.assert_allclose(ll.numpy(), ll_d.numpy(), rtol=1e-5)
    np.testing.assert_allclose(ini.numpy(), ini_d.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(w.numpy()[0], A_d.numpy()[0, pb.indices[:, 0], pb.indices[:, 1]],
                               rtol=1e-4, atol=1e-6)
    gamma, xi, _ = sparse.sparse_expected_statistics(init, pb.indices, probs, E)
    np.testing.assert_allclose(gamma.numpy(), np.asarray(gamma_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(xi.numpy(), np.asarray(xi_j), rtol=1e-4, atol=1e-6)


def test_em_monotone_stochastic_and_zero_edges_stay_zero():
    pb = Problem(k=2, b=3, L=32, seed=7)
    init, probs, E = pb.torch("init", "probs", "E")
    lls = []
    for _ in range(5):
        init, probs, ll = sparse.sparse_em_step(init, pb.indices, probs, E)
        lls.append(float(ll.sum()))
    assert all(b >= a - 1e-3 for a, b in zip(lls, lls[1:])), lls
    sums = np.zeros(pb.q)
    np.add.at(sums, pb.indices[:, 0], probs.numpy()[0])
    np.testing.assert_allclose(sums[np.unique(pb.indices[:, 0])], 1.0, rtol=1e-5)
    np.testing.assert_allclose(init.sum(-1).numpy(), 1.0, rtol=1e-5)

    probs = pb.probs.copy()
    dead = 5
    probs[:, dead] = 0.0
    row = pb.indices[:, 0] == pb.indices[dead, 0]
    probs[:, row] /= probs[:, row].sum(-1, keepdims=True)
    _, w_new, _ = sparse.sparse_em_step(_t(pb.init), pb.indices, _t(probs), E)
    assert float(w_new[0, dead]) == 0.0


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [1, 16])
def test_sparse_streaming_matches_whole_sequence(block):
    pb = Problem(k=2, b=2, L=48, seed=3)
    init, probs, E = pb.torch("init", "probs", "E")
    ll_ref = sparse.sparse_log_likelihood(init, pb.indices, probs, E)
    la_ref, _ = sparse.sparse_forward(init, pb.indices, probs, E)
    state = streaming.sparse_streaming_init(init, pb.indices, probs, E[:, :, :block])
    for s0 in range(block, 48, block):
        state = streaming.sparse_streaming_update(state, pb.indices, probs, E[:, :, s0:s0 + block])
    np.testing.assert_allclose(streaming.streaming_log_likelihood(state).numpy(), ll_ref.numpy(), rtol=1e-4)
    np.testing.assert_allclose(streaming.streaming_filter_log_probs(state).numpy(),
                               (la_ref[:, :, -1] - ll_ref[..., None]).numpy(), atol=1e-4)
    if block == 16:

        @jax.jit
        def jax_stream(init, probs, E):
            js = jstreaming.sparse_streaming_init(init, pb.indices, probs, E[:, :, :16])
            for s0 in (16, 32):
                js = jstreaming.sparse_streaming_update(js, pb.indices, probs, E[:, :, s0:s0 + 16])
            return js

        js = jax_stream(pb.init, pb.probs, jnp.asarray(pb.E))
        np.testing.assert_allclose(state.log_lik.numpy(), np.asarray(js.log_lik), rtol=1e-5)
        np.testing.assert_allclose(state.log_filter.numpy(), np.asarray(js.log_filter), atol=1e-4)


# ---------------------------------------------------------------------------
# the layer's sparse routes
# ---------------------------------------------------------------------------


class _JaxRaw:
    def init_params(self, key, input_dim):
        return {}

    def emissions(self, p, x, end_hints=None, training=False):
        return x

    def prior_log_density(self, p):
        return jnp.zeros((1,))

    def aux_loss(self, p):
        return jnp.zeros(())


class _Raw(torch.nn.Module):
    """Emitter whose inputs are the emission probabilities."""

    def emissions(self, x, end_hints=None, training=False):
        return x

    def prior_log_density(self):
        return torch.zeros(1)

    def aux_loss(self):
        return torch.zeros(())

    def get_config(self):
        return {}


@pytest.fixture(scope="module")
def layers():
    """The JAX sparse layer, the port's sparse and dense layers on its
    params, the inputs and labels (k = 2, b = 2, L = 20)."""
    jt = JMulti(k=2, sparse_forward=True)
    jl = JHMMLayer(jt, _JaxRaw(), use_prior=False)
    params = jl.init_params(KEY, jt.num_states)
    rng = np.random.default_rng(2)
    x = _emissions(rng, 1, 2, 20, jt.num_states)
    labels = rng.integers(0, jt.num_states, (1, 2, 20))
    sl = HMMLayer(tm.GenePredMultiTransitions(k=2, sparse_forward=True), _Raw(), use_prior=False, device="cpu")
    dl = HMMLayer(tm.GenePredMultiTransitions(k=2), _Raw(), use_prior=False, device="cpu")
    for layer in (sl, dl):
        load_jax_params(layer, {"transitions": params["transitions"], "emissions": [{}]})
    return jl, params, sl, dl, x, labels


def test_layer_sparse_route_matches_jax_and_dense(layers, monkeypatch):
    jl, params, sl, dl, x, _ = layers
    calls = []
    orig = sparse.sparse_log_likelihood
    monkeypatch.setattr(sparse, "sparse_log_likelihood", lambda *a, **kw: (calls.append(1), orig(*a, **kw))[1])
    ll_j, lg_j, paths_j = jax.jit(lambda p, x: (jl.log_likelihood(p, x), jl.state_posterior_log_probs(p, x),
                                                jl.viterbi(p, x)))(params, jnp.asarray(x))
    with torch.no_grad():
        ll = sl.log_likelihood(x)
        assert calls, "the layer did not route through the sparse engine"
        np.testing.assert_allclose(ll.numpy(), np.asarray(ll_j), rtol=1e-5)
        np.testing.assert_allclose(ll.numpy(), dl.log_likelihood(x).numpy(), rtol=1e-5)
        lg = sl.state_posterior_log_probs(x)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(lg.numpy(), dl.state_posterior_log_probs(x).numpy(), rtol=2e-4, atol=2e-4)
        lg2, prior, aux = sl.state_posterior_log_probs(x, return_prior=True)
        assert torch.equal(lg2, lg) and tuple(prior.shape) == (1,) and float(aux) == 0.0
        init, A = (t.numpy() for t in dl.transitions.matrices())
        s, valid = _path_score(init, A, x, sl.viterbi(x).numpy())
        s_j, _ = _path_score(init, A, x, np.asarray(paths_j))
        assert valid
        np.testing.assert_allclose(s, s_j, rtol=1e-5, atol=1e-4)


def _layer_grads(layer, fn):
    layer.zero_grad()
    value = fn()
    value.backward()
    return value.item(), {n: p.grad.numpy().copy() for n, p in layer.named_parameters()}


def test_layer_loss_and_ce_grads_match_jax_and_dense(layers):
    jl, params, sl, dl, x, labels = layers
    jx = jnp.asarray(x)
    for objective in ("loss", "ce"):
        if objective == "loss":
            v_j, g_j = jax.jit(jax.value_and_grad(jl.loss))(params, jx)
            run = lambda layer: layer.loss(x)  # noqa: E731
        else:
            v_j, g_j = jax.jit(jax.value_and_grad(
                lambda p: jl.posterior_cross_entropy(p, jx, jnp.asarray(labels))))(params)
            run = lambda layer: layer.posterior_cross_entropy(x, labels)  # noqa: E731
        v, g = _layer_grads(sl, lambda: run(sl))
        v_d, g_d = _layer_grads(dl, lambda: run(dl))
        np.testing.assert_allclose(v, float(v_j), rtol=1e-5)
        np.testing.assert_allclose(v, v_d, rtol=1e-4)
        for name in g:
            ref = np.asarray(g_j["transitions"][name.split(".")[-1]])
            _compare([g[name]], [ref], rtol=2e-3)
            _compare([g[name]], [g_d[name]], rtol=2e-3)


def test_layer_sample_paths_and_config(layers):
    _, _, sl, dl, x, _ = layers
    paths = sl.sample_paths(x, num_samples=4, generator=torch.Generator().manual_seed(3))
    assert paths.dtype == torch.int32 and tuple(paths.shape) == (1, 2, 4, 20)
    _, valid = _path_score(*(t.detach().numpy() for t in dl.transitions.matrices()), x, paths[:, :, 0].numpy())
    assert valid
    config = sl.get_config()
    assert config["transitions"]["config"]["sparse_forward"] is True
    t2 = tm.GenePredMultiTransitions.from_config(config["transitions"]["config"])
    assert t2.sparse_forward is True and t2.k == 2


@pytest.mark.parametrize("cls,kw", [
    (tm.SimpleGenePredTransitions, {}), (tm.GenePredTransitions, {}), (tm.GenePredMultiTransitions, {"k": 3}),
])
def test_sparse_forward_grammars_build(cls, kw):
    t = cls(sparse_forward=True, **kw)
    idx, probs = t.make_A_sparse()
    assert t.sparse_forward and t.get_config()["sparse_forward"] is True
    assert tuple(probs.shape) == (1, len(idx)) and idx.shape == (t.num_transitions, 2)
