"""The port's multi-device routes (``hmm_layer_torch.parallel``, the mesh
routes of ``HMMLayer`` and ``Trainer(mesh)``) in one gloo world of four
CPU ranks, against the JAX sharded functions on the 8-virtual-device mesh
of ``tests/conftest.py`` on the same numpy inputs, at the tolerances of
``tests/test_sharding.py``.

The world runs once for the module (``hmm_layer_torch.parallel.launch``:
every collective and the whole run time out, so a divergent world fails
instead of hanging) and returns, from every rank, the results of every
case on the meshes ``{"seq": 4}``, ``{"state": 4}``, ``{"data": 2, "seq":
2}``, ``{"data": 2, "state": 2}`` and ``{"data": 4}``. This file imports
JAX only inside its fixtures: the ranks load it without JAX.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

EPS = 1e-16  # hmm_layer_torch.ops.semiring.EPS
WORLD = 4
MESHES = {
    "seq4": {"seq": 4},
    "state4": {"state": 4},
    "data2seq2": {"data": 2, "seq": 2},
    "data2state2": {"data": 2, "state": 2},
    "data4": {"data": 4},
}
SEQ_MESHES = ("seq4", "data2seq2")
STATE_MESHES = ("state4", "data2state2")
P_SEQ = 3  # rank-local factor: L / 4 = 24 and L / 2 = 48 divide by 3
P_STATE = 4
LAYER_PARTITIONS = {
    "data4": {"batch": "data"},
    "seq4": {"seq": "seq"},
    "data2seq2": {"batch": "data", "seq": "seq"},
    "state4": {"state": "state"},  # q = 7 is padded to 8
    "data2state2": {"batch": "data", "state": "state"},  # q = 7 is padded to 8
}


def _problem(q, seed, m=2, b=4, L=96):
    """init, A (a third of the off-diagonal entries exactly zero), E, and
    a posterior cotangent W, all float32."""
    rng = np.random.default_rng(seed)
    init = rng.dirichlet(np.ones(q), size=m)
    A = rng.dirichlet(np.ones(q), size=(m, q)) * (rng.uniform(size=(m, q, q)) > 0.3)
    A[:, np.arange(q), np.arange(q)] += 0.1
    A /= A.sum(-1, keepdims=True)
    E = rng.uniform(0.05, 1.0, size=(m, b, L, q))
    W = rng.normal(size=(m, b, L, q))
    return {k: v.astype(np.float32) for k, v in dict(init=init, A=A, E=E, W=W).items()}


SEQ_PROBLEM = functools.partial(_problem, 6, 0)
STATE_PROBLEM = functools.partial(_problem, 8, 1)


def _layer_inputs(seed=2, b=4, L=96):
    """Class probabilities of the simple gene-pred family (q = 7), labels
    and a label mask, as ``tests/test_layer_mesh.py`` feeds its layers."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.1, 1.0, size=(1, b, L, 7)).astype(np.float32)
    labels = rng.integers(0, 7, size=(1, b, L))
    mask = (rng.uniform(size=(1, b, L)) > 0.3).astype(np.float32)
    return x, labels, mask


def _gene_layer(sparse=False, **kwargs):
    """The simple gene-pred layer on the CPU, its parameters moved off
    their initial values by a fixed draw (the same on every rank)."""
    from hmm_layer_torch import HMMLayer
    from hmm_layer_torch.models import SimpleGenePredEmissions, SimpleGenePredTransitions

    layer = HMMLayer(
        SimpleGenePredTransitions(sparse_forward=sparse),
        SimpleGenePredEmissions(),
        num_seqs=100,
        parallel_factor=P_SEQ,
        device="cpu",
        **kwargs,
    )
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for p in layer.parameters():
            p += torch.as_tensor(rng.normal(0, 0.5, size=p.shape), dtype=p.dtype)
    return layer


def _grads(loss, tensors):
    return [g.numpy() for g in torch.autograd.grad(loss, tensors)]


def _np(x):
    return x.detach().numpy()


# ---------------------------------------------------------------------------
# The world: every case on every rank
# ---------------------------------------------------------------------------


def _seq_cases(mesh, data):
    from hmm_layer_torch.parallel import sharding as S

    pr = {k: torch.as_tensor(v) for k, v in SEQ_PROBLEM().items()}
    kw = dict(mesh=mesh, data_axis=data, local_parallel_factor=P_SEQ)
    out = {"ll": _np(S.seq_sharded_log_likelihood(pr["init"], pr["A"], pr["E"], **kw))}
    lg, ll = S.seq_sharded_posterior(pr["init"], pr["A"], pr["E"], **kw)
    out["lg"], out["post_ll"] = _np(lg), _np(ll)
    out["lg_nl"] = _np(S.seq_sharded_posterior(pr["init"], pr["A"], pr["E"], no_loglik=True, **kw)[0])
    out["path"] = S.seq_sharded_viterbi(pr["init"], pr["A"], pr["E"], **kw).numpy()
    xs = [pr[k].clone().requires_grad_() for k in ("init", "A", "E")]
    out["g_ll"] = _grads(S.seq_sharded_log_likelihood(*xs, **kw).sum(), xs)
    lg, ll = S.seq_sharded_posterior(*xs, **kw)
    out["g_post"] = _grads((lg * pr["W"]).sum() + ll.sum(), xs)
    lg, ll = S.seq_sharded_posterior(*xs, no_loglik=True, **kw)
    out["g_post_nl"] = _grads((lg * pr["W"]).sum() + ll.sum(), xs)
    return out


def _state_cases(mesh, data):
    from hmm_layer_torch.parallel import sharding as S

    pr = {k: torch.as_tensor(v) for k, v in STATE_PROBLEM().items()}
    kw = dict(mesh=mesh, data_axis=data)
    args = (pr["init"], pr["A"], pr["E"])
    out = {
        "ll_P1": _np(S.state_sharded_log_likelihood(*args, **kw)),
        f"ll_P{P_STATE}": _np(S.state_sharded_log_likelihood(*args, **kw, parallel_factor=P_STATE)),
    }
    lg, ll = S.state_sharded_posterior(*args, **kw)
    out["lg_P1"], out["post_ll_P1"] = _np(lg), _np(ll)
    out[f"lg_nl_P{P_STATE}"] = _np(
        S.state_sharded_posterior(*args, **kw, no_loglik=True, parallel_factor=P_STATE)[0]
    )
    out["path"] = S.state_sharded_viterbi(*args, **kw).numpy()
    xs = [pr[k].clone().requires_grad_() for k in ("init", "A", "E")]
    out["g_ll"] = _grads(S.state_sharded_log_likelihood(*xs, **kw).sum(), xs)
    lg, ll = S.state_sharded_posterior(*xs, **kw, parallel_factor=P_STATE)
    out["g_post"] = _grads((lg * pr["W"]).sum() + ll.sum(), xs)
    return out


def _raising(name):
    def call(*args, **kwargs):
        raise AssertionError(f"collectives.{name} was called")

    return call


@contextlib.contextmanager
def _no_gathers():
    """``collectives.gather`` and ``gather_rows`` raise inside the block:
    they make every output gather (and the gradient gather of a scattered
    ``E``) of the global mode."""
    from hmm_layer_torch.parallel import collectives as C

    saved = C.gather, C.gather_rows
    C.gather, C.gather_rows = _raising("gather"), _raising("gather_rows")
    try:
        yield
    finally:
        C.gather, C.gather_rows = saved


def _from_every_rank(x):
    """``x`` of every rank in rank order: the same list on every rank."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return out


def _local_cases(mesh, data, route):
    """The route's functions under ``local=True`` on this rank's blocks of
    the global cases' inputs (:func:`local_ranges`), the gathers forbidden
    (:func:`_no_gathers`); then one global call under the same ban, which
    must raise. Returned from every rank, so every rank holds the list."""
    from hmm_layer_torch.parallel import local_ranges
    from hmm_layer_torch.parallel import sharding as S

    pr = {k: torch.as_tensor(v) for k, v in (SEQ_PROBLEM() if route == "seq" else STATE_PROBLEM()).items()}
    r = local_ranges(mesh, route, pr["E"].shape, data_axis=data)
    E, W = pr["E"][r.index], pr["W"][r.index]
    out = {"ranges": tuple(r), "error": None}
    xs = [pr["init"].clone().requires_grad_(), pr["A"].clone().requires_grad_(), E.clone().requires_grad_()]

    def post_grads(fn, **kw):
        lg, ll = fn(*xs, **kw)
        return _grads((lg * W).sum() + ll.sum(), xs)

    try:
        with _no_gathers():
            if route == "seq":
                kw = dict(mesh=mesh, data_axis=data, local_parallel_factor=P_SEQ, local=True)
                out["ll"] = _np(S.seq_sharded_log_likelihood(pr["init"], pr["A"], E, **kw))
                lg, ll = S.seq_sharded_posterior(pr["init"], pr["A"], E, **kw)
                out["lg"], out["post_ll"] = _np(lg), _np(ll)
                out["lg_nl"] = _np(S.seq_sharded_posterior(pr["init"], pr["A"], E, no_loglik=True, **kw)[0])
                out["path"] = S.seq_sharded_viterbi(pr["init"], pr["A"], E, **kw).numpy()
                out["g_ll"] = _grads(S.seq_sharded_log_likelihood(*xs, **kw).sum(), xs)
                out["g_post"] = post_grads(S.seq_sharded_posterior, **kw)
                out["g_post_nl"] = post_grads(S.seq_sharded_posterior, no_loglik=True, **kw)
            else:
                kw = dict(mesh=mesh, data_axis=data, local=True)
                args = (pr["init"], pr["A"], E)
                out["ll_P1"] = _np(S.state_sharded_log_likelihood(*args, **kw))
                out[f"ll_P{P_STATE}"] = _np(S.state_sharded_log_likelihood(*args, **kw, parallel_factor=P_STATE))
                lg, ll = S.state_sharded_posterior(*args, **kw)
                out["lg_P1"], out["post_ll_P1"] = _np(lg), _np(ll)
                out[f"lg_nl_P{P_STATE}"] = _np(
                    S.state_sharded_posterior(*args, **kw, no_loglik=True, parallel_factor=P_STATE)[0]
                )
                out["path"] = S.state_sharded_viterbi(*args, **kw).numpy()
                out["g_ll"] = _grads(S.state_sharded_log_likelihood(*xs, **kw).sum(), xs)
                out["g_post"] = post_grads(S.state_sharded_posterior, **kw, parallel_factor=P_STATE)
    except AssertionError as e:
        out["error"] = str(e)
    try:
        with _no_gathers():
            if route == "seq":
                S.seq_sharded_log_likelihood(pr["init"], pr["A"], pr["E"], mesh, data_axis=data,
                                             local_parallel_factor=P_SEQ)
            else:
                S.state_sharded_log_likelihood(pr["init"], pr["A"], pr["E"], mesh, data_axis=data)
        out["global_error"] = None
    except AssertionError as e:
        out["global_error"] = str(e)
    return _from_every_rank(out)


def _data_cases(mesh):
    from hmm_layer_torch.ops import recursion
    from hmm_layer_torch.parallel import sharding as S

    pr = {k: torch.as_tensor(v) for k, v in SEQ_PROBLEM().items()}
    params = {"init": pr["init"].clone().requires_grad_(), "A": pr["A"].clone().requires_grad_()}
    fn = S.data_parallel_fn(
        lambda p, x: -recursion.log_likelihood(p["init"], p["A"], x, P_STATE).mean(), mesh
    )
    loss = fn(params, pr["E"])
    out = {"dp_loss": _np(loss), "dp_grads": _grads(loss, [params["init"], params["A"]])}
    em = S.data_parallel_em_step(pr["init"], pr["A"], pr["E"], mesh, parallel_factor=P_STATE, pseudocount=0.1)
    out["em"] = [x.numpy() for x in em]
    rng = np.random.default_rng(4)
    B = torch.as_tensor(rng.dirichlet(np.ones(4), size=(2, 6)), dtype=torch.float32)
    x = torch.as_tensor(np.eye(4)[rng.integers(0, 4, size=(2, 4, 96))], dtype=torch.float32)
    em = S.data_parallel_em_step_categorical(pr["init"], pr["A"], B, x, mesh, parallel_factor=P_STATE, pseudocount=0.1)
    out["em_cat"] = [t.numpy() for t in em]
    return out


def _layer_cases(mesh, partition, sparse=False, b=4):
    X, labels, mask = _layer_inputs(b=b)
    out = {}
    for name, layer in (("dense", _gene_layer(sparse)), ("mesh", _gene_layer(sparse, mesh=mesh, partition=partition))):
        with torch.no_grad():
            out[f"{name}_ll"] = _np(layer.log_likelihood(X))
            out[f"{name}_lg"] = _np(layer.state_posterior_log_probs(X))
            out[f"{name}_path"] = layer.viterbi(X).numpy()
        params = list(layer.parameters())
        out[f"{name}_g_ce"] = _grads(layer.posterior_cross_entropy(X, labels, mask), params)
        out[f"{name}_g_map"] = _grads(layer.loss(X), params)
        if name == "dense":
            with torch.no_grad():
                init, A = layer.transitions.matrices()
                out["init"], out["A"], out["E"] = _np(init), _np(A), _np(layer.emission_probs(X))
    return out


def _ragged_cases(mesh4, mesh22):
    """b = 6 over four data ranks (row blocks 2, 2, 1, 1): ``data_parallel_fn``
    against one process, and what each split that must divide raises."""
    from hmm_layer_torch.ops import recursion
    from hmm_layer_torch.parallel import sharding as S

    pr = {k: torch.as_tensor(v) for k, v in _problem(6, 0, b=6).items()}
    out = {}
    for name, mesh in (("one", None), ("mesh", mesh4)):
        params = {"init": pr["init"].clone().requires_grad_(), "A": pr["A"].clone().requires_grad_()}
        loss_fn = lambda p, x: -recursion.log_likelihood(p["init"], p["A"], x, P_STATE).mean()  # noqa: E731
        ll_fn = lambda p, x: recursion.log_likelihood(p["init"], p["A"], x, P_STATE)  # noqa: E731
        if mesh is not None:
            loss_fn, ll_fn = S.data_parallel_fn(loss_fn, mesh), S.data_parallel_fn(ll_fn, mesh)
        loss = loss_fn(params, pr["E"])
        out[f"{name}_loss"], out[f"{name}_grads"] = _np(loss), _grads(loss, [params["init"], params["A"]])
        out[f"{name}_ll"] = _np(ll_fn(params, pr["E"]))
    calls = {
        "shard_batch": lambda: S.shard_batch(pr["E"], mesh4),
        "state_route": lambda: S.state_sharded_log_likelihood(
            pr["init"], pr["A"], pr["E"][:, :5], mesh22, data_axis="data"
        ),
        "em_step": lambda: S.data_parallel_em_step(pr["init"], pr["A"], pr["E"], mesh4),
        "fewer_rows_than_ranks": lambda: _gene_layer(mesh=mesh4, partition={"batch": "data"}).log_likelihood(
            _layer_inputs(b=3)[0]
        ),
    }
    out["errors"] = {}
    for what, call in calls.items():
        try:
            call()
            out["errors"][what] = None
        except ValueError as e:
            out["errors"][what] = str(e)
    return out


def _trainer_cases(mesh, partition):
    """Two SGD steps on the CE objective: one device, and ``mesh`` (the
    layer's own partition, or ``Trainer(mesh=...)``'s data route)."""
    from hmm_layer_torch.training import Trainer

    X, labels, mask = _layer_inputs()
    sgd = functools.partial(torch.optim.SGD, lr=0.05)
    plain = _gene_layer()
    if partition is None:
        sharded, kwargs = _gene_layer(), dict(mesh=mesh)
    else:
        sharded, kwargs = _gene_layer(mesh=mesh, partition=partition), {}
    out = {}
    for name, layer, kw in (("plain", plain, {}), ("mesh", sharded, kwargs)):
        trainer = Trainer(
            layer, optimizer=sgd, loss_fn=lambda batch, _, l=layer: l.posterior_cross_entropy(batch, labels, mask), **kw
        )
        out[f"{name}_loss"] = float(trainer.fit([X] * 2, log_every=100))
        out[f"{name}_params"] = {k: _np(v) for k, v in layer.state_dict().items()}
    return out


def world_cases():
    """Every case of this file on this rank; run by each rank of the world."""
    from hmm_layer_torch.parallel import make_mesh

    meshes = {name: make_mesh(spec) for name, spec in MESHES.items()}
    out = {}
    for name in SEQ_MESHES:
        out[name] = _seq_cases(meshes[name], "data" if "data" in MESHES[name] else None)
    for name in STATE_MESHES:
        out[name] = _state_cases(meshes[name], "data" if "data" in MESHES[name] else None)
    for name in SEQ_MESHES + STATE_MESHES:
        route = "seq" if name in SEQ_MESHES else "state"
        out[f"local_{name}"] = _local_cases(meshes[name], "data" if "data" in MESHES[name] else None, route)
    out["data4"] = _data_cases(meshes["data4"])
    out["layer"] = {name: _layer_cases(meshes[name], part) for name, part in LAYER_PARTITIONS.items()}
    out["sparse_layer"] = _layer_cases(meshes["data4"], {"batch": "data"}, sparse=True)
    out["ragged_layer"] = {  # b = 6 rows over 4 ranks
        kind: _layer_cases(meshes["data4"], {"batch": "data"}, sparse=kind == "sparse", b=6)
        for kind in ("dense", "sparse")
    }
    out["ragged"] = _ragged_cases(meshes["data4"], meshes["data2state2"])
    out["trainer"] = {
        "data4": _trainer_cases(meshes["data4"], None),  # Trainer(mesh=...) adopts {"batch": "data"}
        "data2seq2": _trainer_cases(meshes["data2seq2"], LAYER_PARTITIONS["data2seq2"]),
    }
    return out


@pytest.fixture(scope="module")
def world():
    from hmm_layer_torch.parallel.launch import run_world

    return run_world(world_cases, WORLD, timeout_s=400)


@pytest.fixture(scope="module")
def results(world):
    return world[0]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# JAX references: one jit per mesh
# ---------------------------------------------------------------------------


def _jax_mesh(name):
    from hmm_layer_tpu.parallel import sharding as J

    return J.make_mesh(MESHES[name])


@functools.lru_cache(maxsize=None)
def _jax_seq(name):
    from functools import partial

    import jax
    import jax.numpy as jnp
    from hmm_layer_tpu.parallel import sharding as J

    mesh = _jax_mesh(name)
    kw = dict(data_axis="data" if "data" in MESHES[name] else None, local_parallel_factor=P_SEQ)
    pr = SEQ_PROBLEM()

    def f(init, A, E, W):
        ll = J.seq_sharded_log_likelihood(init, A, E, mesh, **kw)
        lg, post_ll = J.seq_sharded_posterior(init, A, E, mesh, **kw)
        lg_nl, _ = J.seq_sharded_posterior(init, A, E, mesh, no_loglik=True, **kw)
        path = J.seq_sharded_viterbi(init, A, E, mesh, **kw)
        g_ll = jax.grad(lambda *a: J.seq_sharded_log_likelihood(*a, mesh, **kw).sum(), argnums=(0, 1, 2))(init, A, E)

        def post_obj(*a, no_loglik=False):
            lg, ll = J.seq_sharded_posterior(*a, mesh, no_loglik=no_loglik, **kw)
            return jnp.sum(lg * W) + jnp.sum(ll)

        g_post = jax.grad(post_obj, argnums=(0, 1, 2))(init, A, E)
        g_post_nl = jax.grad(partial(post_obj, no_loglik=True), argnums=(0, 1, 2))(init, A, E)
        return dict(ll=ll, lg=lg, post_ll=post_ll, lg_nl=lg_nl, path=path, g_ll=g_ll, g_post=g_post,
                    g_post_nl=g_post_nl)

    out = jax.jit(f)(pr["init"], pr["A"], pr["E"], pr["W"])
    return jax.tree.map(np.asarray, out)


@functools.lru_cache(maxsize=None)
def _jax_state(name):
    import jax
    import jax.numpy as jnp
    from hmm_layer_tpu.parallel import sharding as J

    mesh = _jax_mesh(name)
    kw = dict(data_axis="data" if "data" in MESHES[name] else None)
    pr = STATE_PROBLEM()

    def f(init, A, E, W):
        out = {
            "ll_P1": J.state_sharded_log_likelihood(init, A, E, mesh, **kw),
            f"ll_P{P_STATE}": J.state_sharded_log_likelihood(init, A, E, mesh, **kw, parallel_factor=P_STATE),
        }
        out["lg_P1"], out["post_ll_P1"] = J.state_sharded_posterior(init, A, E, mesh, **kw)
        out[f"lg_nl_P{P_STATE}"] = J.state_sharded_posterior(
            init, A, E, mesh, **kw, no_loglik=True, parallel_factor=P_STATE
        )[0]
        out["path"] = J.state_sharded_viterbi(init, A, E, mesh, **kw)
        out["g_ll"] = jax.grad(
            lambda *a: J.state_sharded_log_likelihood(*a, mesh, **kw).sum(), argnums=(0, 1, 2)
        )(init, A, E)

        def post_obj(*a):
            lg, ll = J.state_sharded_posterior(*a, mesh, **kw, parallel_factor=P_STATE)
            return jnp.sum(lg * W) + jnp.sum(ll)

        out["g_post"] = jax.grad(post_obj, argnums=(0, 1, 2))(init, A, E)
        return out

    out = jax.jit(f)(pr["init"], pr["A"], pr["E"], pr["W"])
    return jax.tree.map(np.asarray, out)


def _path_score64(init, A, E, path):
    """float64 log score of each path (m, b), and whether each step uses a
    transition of A > 0."""
    init, A, E = (np.asarray(x, np.float64) for x in (init, A, E))
    m, b, L = path.shape
    mi, bi, ti = np.arange(m)[:, None, None], np.arange(b)[None, :, None], np.arange(L)[None, None, :]
    score = np.log(np.maximum(init[np.arange(m)[:, None], path[..., 0]], EPS))
    score = score + np.log(np.maximum(E[mi, bi, ti, path], EPS)).sum(-1)
    prev, nxt = path[..., :-1], path[..., 1:]
    score = score + np.log(np.maximum(A[mi, prev, nxt], EPS)).sum(-1)
    return score, A[mi, prev, nxt] > 0


def _assert_paths_equivalent(init, A, E, path, ref):
    """``path`` is valid (no A = 0 transition ``ref`` avoids) and scores
    as ``ref`` in float64 (rel 1e-6): float32 ties may split."""
    assert path.shape == ref.shape and path.dtype == np.int32
    score, used = _path_score64(init, A, E, path)
    ref_score, ref_used = _path_score64(init, A, E, ref)
    assert np.all(used | ~ref_used)
    np.testing.assert_allclose(score, ref_score, rtol=1e-6)


def _assert_grads(got, ref, rtol=2e-3, atol=2e-4):
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(r), rtol=rtol, atol=atol)


def _assert_grads_scaled(got, ref, atol=5e-4):
    for a, r in zip(got, ref):
        scale = max(np.abs(np.asarray(r)).max(), 1e-6)
        np.testing.assert_allclose(a / scale, np.asarray(r) / scale, atol=atol)


# ---------------------------------------------------------------------------
# Sequence routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SEQ_MESHES)
def test_seq_log_likelihood(results, name):
    np.testing.assert_allclose(results[name]["ll"], _jax_seq(name)["ll"], rtol=1e-4)


@pytest.mark.parametrize("name", SEQ_MESHES)
def test_seq_posterior(results, name):
    ref = _jax_seq(name)
    np.testing.assert_allclose(results[name]["post_ll"], ref["post_ll"], rtol=1e-4)
    np.testing.assert_allclose(results[name]["lg"], ref["lg"], rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("name", SEQ_MESHES)
def test_seq_posterior_no_loglik(results, name):
    np.testing.assert_allclose(results[name]["lg_nl"], _jax_seq(name)["lg_nl"], rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("name", SEQ_MESHES)
def test_seq_viterbi(results, name):
    pr = SEQ_PROBLEM()
    _assert_paths_equivalent(pr["init"], pr["A"], pr["E"], results[name]["path"], _jax_seq(name)["path"])


@pytest.mark.parametrize("name", SEQ_MESHES)
def test_seq_log_likelihood_grads(results, name):
    _assert_grads(results[name]["g_ll"], _jax_seq(name)["g_ll"])


@pytest.mark.parametrize("name", SEQ_MESHES)
@pytest.mark.parametrize("key", ["g_post", "g_post_nl"])
def test_seq_posterior_grads(results, name, key):
    _assert_grads_scaled(results[name][key], _jax_seq(name)[key])


# ---------------------------------------------------------------------------
# State routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", STATE_MESHES)
@pytest.mark.parametrize("P", [1, P_STATE])
def test_state_log_likelihood(results, name, P):
    np.testing.assert_allclose(results[name][f"ll_P{P}"], _jax_state(name)[f"ll_P{P}"], rtol=1e-4)


@pytest.mark.parametrize("name", STATE_MESHES)
def test_state_posterior(results, name):
    ref = _jax_state(name)
    np.testing.assert_allclose(results[name]["post_ll_P1"], ref["post_ll_P1"], rtol=1e-4)
    np.testing.assert_allclose(results[name]["lg_P1"], ref["lg_P1"], rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("name", STATE_MESHES)
def test_state_posterior_no_loglik_chunked(results, name):
    key = f"lg_nl_P{P_STATE}"
    np.testing.assert_allclose(results[name][key], _jax_state(name)[key], rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("name", STATE_MESHES)
def test_state_viterbi(results, name):
    pr = STATE_PROBLEM()
    _assert_paths_equivalent(pr["init"], pr["A"], pr["E"], results[name]["path"], _jax_state(name)["path"])


@pytest.mark.parametrize("name", STATE_MESHES)
def test_state_log_likelihood_grads(results, name):
    _assert_grads(results[name]["g_ll"], _jax_state(name)["g_ll"])


@pytest.mark.parametrize("name", STATE_MESHES)
def test_state_posterior_grads(results, name):
    _assert_grads_scaled(results[name]["g_post"], _jax_state(name)["g_post"])


# ---------------------------------------------------------------------------
# The rank-local mode of the state and sequence routes
# ---------------------------------------------------------------------------

LOCAL_OUTPUTS = {
    "seq": ("ll", "lg", "post_ll", "lg_nl", "path"),
    "state": ("ll_P1", f"ll_P{P_STATE}", "lg_P1", "post_ll_P1", f"lg_nl_P{P_STATE}", "path"),
}
LOCAL_GRADS = {"seq": ("g_ll", "g_post", "g_post_nl"), "state": ("g_ll", "g_post")}


def _block(x, ranges):
    """The block of a global result at a rank's ranges: (m, b, L, q)
    outputs, (m, b, L) paths, (m, b) logliks."""
    rows, positions, states = (slice(*r) for r in ranges)
    return x[(slice(None), rows, positions, states)[: x.ndim]]


def _route(name):
    return "seq" if name in SEQ_MESHES else "state"


@pytest.mark.parametrize("name", SEQ_MESHES + STATE_MESHES)
def test_local_mode_values_are_the_global_blocks(results, name):
    """Under ``local=True`` each rank's log gamma, logliks and paths are
    bit-equal to its block of the global mode's result (which the JAX
    parity tests above hold); the blocks tile the global result."""
    glob = results[name]
    for rank, loc in enumerate(results[f"local_{name}"]):
        assert loc["error"] is None, f"rank {rank}: {loc['error']}"
        for key in LOCAL_OUTPUTS[_route(name)]:
            np.testing.assert_array_equal(loc[key], _block(glob[key], loc["ranges"]), err_msg=f"rank {rank} {key}")
    covered = sum(np.prod([hi - lo for lo, hi in loc["ranges"]]) for loc in results[f"local_{name}"])
    assert covered == np.prod(glob["lg" if _route(name) == "seq" else "lg_P1"].shape[1:])


@pytest.mark.parametrize("name", SEQ_MESHES + STATE_MESHES)
def test_local_mode_gradients_are_the_global_blocks(results, name):
    """The gradient of each rank's ``E`` block is its block of the global
    gradient; those of ``init`` and ``A`` are the global ones, bit for bit."""
    glob = results[name]
    for rank, loc in enumerate(results[f"local_{name}"]):
        for key in LOCAL_GRADS[_route(name)]:
            (gi, gA, gE), (ri, rA, rE) = loc[key], glob[key]
            np.testing.assert_array_equal(gi, ri, err_msg=f"rank {rank} {key} init")
            np.testing.assert_array_equal(gA, rA, err_msg=f"rank {rank} {key} A")
            np.testing.assert_array_equal(gE, _block(rE, loc["ranges"]), err_msg=f"rank {rank} {key} E")


@pytest.mark.parametrize("name", SEQ_MESHES + STATE_MESHES)
def test_local_mode_never_gathers(results, name):
    """With ``collectives.gather`` and ``gather_rows`` made to raise, every
    local call above ran (no output or ``E`` gather), while a global call
    under the same ban raises."""
    for loc in results[f"local_{name}"]:
        assert loc["error"] is None, loc["error"]
        assert loc["global_error"] is not None and "collectives.gather" in loc["global_error"]


# ---------------------------------------------------------------------------
# Data parallelism and EM
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_data():
    import jax
    import jax.numpy as jnp
    from hmm_layer_tpu.ops import recursion as JR
    from hmm_layer_tpu.parallel import sharding as J

    mesh = _jax_mesh("data4")
    pr = SEQ_PROBLEM()
    rng = np.random.default_rng(4)
    B = rng.dirichlet(np.ones(4), size=(2, 6)).astype(np.float32)
    x = np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=(2, 4, 96))]

    def loss(p, E):
        return -JR.log_likelihood(p["init"], p["A"], E, P_STATE).mean()

    fn = J.data_parallel_fn(jax.value_and_grad(loss), mesh)
    params = {"init": jnp.asarray(pr["init"]), "A": jnp.asarray(pr["A"])}
    val, grads = fn(params, J.shard_batch(pr["E"], mesh))
    em = jax.jit(lambda *a: J.data_parallel_em_step(*a, mesh, parallel_factor=P_STATE, pseudocount=0.1))(
        pr["init"], pr["A"], pr["E"]
    )
    em_cat = jax.jit(
        lambda *a: J.data_parallel_em_step_categorical(*a, mesh, parallel_factor=P_STATE, pseudocount=0.1)
    )(pr["init"], pr["A"], B, x)
    return jax.tree.map(np.asarray, dict(val=val, grads=[grads["init"], grads["A"]], em=em, em_cat=em_cat))


def test_data_parallel_fn(results):
    ref = _jax_data()
    np.testing.assert_allclose(results["data4"]["dp_loss"], ref["val"], rtol=1e-5)
    _assert_grads(results["data4"]["dp_grads"], ref["grads"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("key", ["em", "em_cat"])
def test_data_parallel_em_steps(results, key):
    for got, ref in zip(results["data4"][key], _jax_data()[key]):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# HMMLayer(mesh, partition) and Trainer(mesh)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(LAYER_PARTITIONS))
def test_layer_mesh_matches_dense_layer(results, name):
    """At the tolerances of ``tests/test_layer_mesh.py``."""
    r = results["layer"][name]
    np.testing.assert_allclose(r["mesh_ll"], r["dense_ll"], rtol=2e-5)
    np.testing.assert_allclose(r["mesh_lg"], r["dense_lg"], rtol=2e-4, atol=2e-4)
    _assert_paths_equivalent(r["init"], r["A"], r["E"], r["mesh_path"], r["dense_path"])


@pytest.mark.parametrize("name", list(LAYER_PARTITIONS))
@pytest.mark.parametrize("objective", ["ce", "map"])
def test_layer_mesh_grads_match_dense_layer(results, name, objective):
    r = results["layer"][name]
    _assert_grads(r[f"mesh_g_{objective}"], r[f"dense_g_{objective}"], rtol=2e-3, atol=1e-5)


def test_layer_data_route_rows_equal_dense_layer(results):
    """The data route runs the dense engine on each rank's rows: the
    per-sequence outputs are the dense layer's on the same rows."""
    r = results["layer"]["data4"]
    np.testing.assert_allclose(r["mesh_ll"], r["dense_ll"], rtol=1e-6)
    np.testing.assert_array_equal(r["mesh_path"], r["dense_path"])


def test_dense_layer_matches_jax_engine(results):
    """The dense reference of the layer cases is the JAX engine's on the
    layer's own init, A and E."""
    import jax
    from hmm_layer_tpu.ops import recursion as JR

    r = results["layer"]["data4"]
    ll = jax.jit(lambda i, a, e: JR.log_likelihood(i, a, e, P_SEQ))(r["init"], r["A"], r["E"])
    np.testing.assert_allclose(r["dense_ll"], np.asarray(ll), rtol=1e-4)


def test_sparse_layer_data_route(results):
    r = results["sparse_layer"]
    np.testing.assert_allclose(r["mesh_ll"], r["dense_ll"], rtol=1e-5)
    np.testing.assert_allclose(r["mesh_lg"], r["dense_lg"], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(r["mesh_path"], r["dense_path"])
    _assert_grads_scaled(r["mesh_g_ce"], r["dense_g_ce"], atol=1e-5)
    _assert_grads_scaled(r["mesh_g_map"], r["dense_g_map"], atol=1e-5)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_layer_data_route_keeps_every_row(results, kind):
    """b = 6 over four data ranks: every row comes back, equal to the dense
    layer's, and the gradients are the whole batch's."""
    r = results["ragged_layer"][kind]
    assert r["mesh_ll"].shape == r["dense_ll"].shape == (1, 6)
    assert r["mesh_path"].shape == r["dense_path"].shape == (1, 6, 96)
    np.testing.assert_allclose(r["mesh_ll"], r["dense_ll"], rtol=1e-6)
    np.testing.assert_allclose(r["mesh_lg"], r["dense_lg"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(r["mesh_path"], r["dense_path"])
    _assert_grads_scaled(r["mesh_g_ce"], r["dense_g_ce"], atol=1e-5)
    _assert_grads_scaled(r["mesh_g_map"], r["dense_g_map"], atol=1e-5)


def test_data_parallel_fn_keeps_every_row(results):
    r = results["ragged"]
    assert r["mesh_ll"].shape == (2, 6)
    np.testing.assert_allclose(r["mesh_ll"], r["one_ll"], rtol=1e-6)
    np.testing.assert_allclose(r["mesh_loss"], r["one_loss"], rtol=1e-6)
    _assert_grads(r["mesh_grads"], r["one_grads"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "what, match",
    [
        ("shard_batch", "not divisible"),
        ("state_route", "not divisible"),
        ("em_step", "not divisible"),
        ("fewer_rows_than_ranks", "fewer rows than ranks"),
    ],
)
def test_splits_that_must_divide_raise(results, what, match):
    """The splits that JAX makes with ``shard_map`` or ``device_put`` raise
    on rows that do not divide, as JAX does; none drops a row."""
    err = results["ragged"]["errors"][what]
    assert err is not None and match in err, err


@pytest.mark.parametrize("name", ["data4", "data2seq2"])
def test_trainer_mesh_steps_match_single_device(results, name):
    r = results["trainer"][name]
    np.testing.assert_allclose(r["mesh_loss"], r["plain_loss"], rtol=1e-5)
    for key, value in r["plain_params"].items():
        np.testing.assert_allclose(r["mesh_params"][key], value, rtol=1e-5, atol=1e-6)


def test_every_rank_returns_the_global_result(world):
    """Every rank holds the same global results (the JAX functions return
    global arrays)."""
    first = world[0]

    def check(a, b, path):
        if isinstance(a, dict):
            for k in a:
                check(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                check(x, y, f"{path}/{i}")
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)

    for other in world[1:]:
        check(first, other, "")


# ---------------------------------------------------------------------------
# In-process checks (no process group: a one-rank mesh)
# ---------------------------------------------------------------------------


def test_make_mesh_needs_enough_ranks():
    from hmm_layer_torch.parallel import make_mesh

    assert make_mesh({"data": 1}).shape == {"data": 1}
    with pytest.raises(ValueError, match=r"needs 4 devices, have 1"):
        make_mesh({"data": 2, "seq": 2})


def test_partition_checks():
    from hmm_layer_torch.parallel import make_mesh

    mesh = make_mesh({"data": 1, "seq": 1})
    with pytest.raises(ValueError, match="without a `mesh`"):
        _gene_layer(partition={"batch": "data"})
    with pytest.raises(ValueError, match="unknown partition axes"):
        _gene_layer(mesh=mesh, partition={"rows": "data"})
    with pytest.raises(NotImplementedError, match="combined sequence"):
        _gene_layer(mesh=mesh, partition={"seq": "seq", "state": "data"})
    with pytest.raises(ValueError, match="not an axis of the mesh"):
        _gene_layer(mesh=mesh, partition={"state": "state"})
    layer = _gene_layer(mesh=mesh, partition={"seq": "seq"})
    X, _, _ = _layer_inputs()
    with pytest.raises(NotImplementedError, match="forward_recursion"):
        layer.forward_recursion(X)


@pytest.mark.parametrize("axis", ["seq"])
def test_sparse_layer_seq_and_state_partitions_raise(axis):
    """The sequence partition of a sparse layer raises, as in JAX (its
    state partition is served: ``test_sparse_layer_state_route_matches_engine``
    and ``tests/test_torch_sparse_sharding.py``)."""
    from hmm_layer_torch.parallel import make_mesh

    layer = _gene_layer(sparse=True, mesh=make_mesh({axis: 1}), partition={axis: axis})
    X, _, _ = _layer_inputs()
    with pytest.raises(NotImplementedError, match="sequence sharding"):
        layer.log_likelihood(X)


def test_sparse_layer_state_route_matches_engine():
    """On a one-rank mesh ``{"state": 1}`` the sparse layer's state route
    (the edge-sharded functions) equals the sparse engine's layer."""
    from hmm_layer_torch.parallel import make_mesh

    routed = _gene_layer(sparse=True, mesh=make_mesh({"state": 1}), partition={"state": "state"})
    single = _gene_layer(sparse=True)
    X, labels, mask = _layer_inputs()
    with torch.no_grad():
        torch.testing.assert_close(routed.log_likelihood(X), single.log_likelihood(X), rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(
            routed.state_posterior_log_probs(X), single.state_posterior_log_probs(X), rtol=1e-6, atol=1e-5
        )
        assert torch.equal(routed.viterbi(X), single.viterbi(X))
    for objective in (lambda lay: lay.loss(X), lambda lay: lay.posterior_cross_entropy(X, labels, mask)):
        got, ref = (_grads(objective(lay), list(lay.parameters())) for lay in (routed, single))
        _assert_grads_scaled(got, ref, atol=1e-5)


def test_one_rank_mesh_routes_match_dense():
    """Without a process group every collective is the identity: each
    route on a one-rank mesh equals the dense engine."""
    from hmm_layer_torch.ops import recursion
    from hmm_layer_torch.parallel import make_mesh
    from hmm_layer_torch.parallel import sharding as S

    pr = {k: torch.as_tensor(v) for k, v in SEQ_PROBLEM().items()}
    args = (pr["init"], pr["A"], pr["E"])
    ll = recursion.log_likelihood(*args)
    lg, _ = recursion.posterior(*args)
    mesh = make_mesh({"seq": 1, "state": 1})
    torch.testing.assert_close(S.seq_sharded_log_likelihood(*args, mesh, local_parallel_factor=3), ll, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(S.state_sharded_posterior(*args, mesh)[0], lg, rtol=1e-4, atol=1e-3)
