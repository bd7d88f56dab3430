"""The port's edge-sharded sparse routes (``hmm_layer_torch.parallel.
sparse_sharding`` and the ``state`` partition of a sparse ``HMMLayer``) in
one gloo world of four CPU ranks, against the JAX ``edge_sharded_*``
functions on the 8-virtual-device mesh of ``tests/conftest.py`` on the same
numpy inputs and parameters, at the tolerances of
``tests/test_layer_mesh.py``, and against the port's single-device sparse
layer.

The world runs once for the module (every collective and the whole run
time out) on the meshes ``{"state": 4}`` and ``{"data": 2, "state": 2}``:
``GenePredMultiTransitions(k=2, sparse_forward=True)`` (q = 29, padded to
32 over four state ranks and to 30 over two) and the simple family (q = 7)
with an identity emitter. This file imports JAX only inside its fixtures
and reference functions: the ranks load it without JAX.

The JAX references run in one child process, each quantity its own jitted
program (``tests/test_torch_sharding.py`` says why: concurrent sharded
scans in one program can make XLA:CPU's all-reduce rendezvous abort the
process).
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

WORLD = 4
MESHES = {"state4": {"state": 4}, "data2state2": {"data": 2, "state": 2}}
PARTITIONS = {"state4": {"state": "state"}, "data2state2": {"batch": "data", "state": "state"}}
FAMILIES = ("k2", "simple")
B, L = 4, 40


class IdentityEmitter(torch.nn.Module):
    """The port's counterpart of ``tests/test_layer_mesh.py``'s
    ``IdentityEmitter``: the inputs are the emission probabilities."""

    def emissions(self, inputs, end_hints=None, training=False):
        return inputs

    def prior_log_density(self):
        return torch.zeros(1)

    def aux_loss(self):
        return torch.zeros(())


@functools.lru_cache(maxsize=None)
def _problems():
    """Per family: the JAX transition parameters (numpy), init, the edge
    list and its probabilities, seeded emissions E (b = 4, L = 40), a
    posterior cotangent W, CE labels and a label mask."""
    import jax
    from hmm_layer_tpu.models import GenePredMultiTransitions, SimpleGenePredTransitions

    out = {}
    families = (GenePredMultiTransitions(k=2, sparse_forward=True), SimpleGenePredTransitions(sparse_forward=True))
    for seed, (family, jt) in enumerate(zip(FAMILIES, families)):
        params = jax.device_get(jt.init_params(jax.random.PRNGKey(seed)))
        indices, probs = jt.make_A_sparse(params)
        q = jt.num_states
        rng = np.random.default_rng(seed + 7)
        out[family] = {
            "params": params,
            "init": np.asarray(jt.make_initial_distribution(params), np.float32),
            "indices": np.asarray(indices),
            "probs": np.asarray(probs, np.float32),
            "E": rng.uniform(0.1, 1.0, (1, B, L, q)).astype(np.float32),
            "W": rng.normal(size=(1, B, L, q)).astype(np.float32),
            "labels": rng.integers(0, q, (1, B, L)),
            "mask": (rng.uniform(size=(1, B, L)) > 0.3).astype(np.float32),
        }
    return out


def _sparse_layer(family, pr, **kwargs):
    """A sparse layer of ``family`` on the CPU with the JAX parameters."""
    from hmm_layer_torch import HMMLayer
    from hmm_layer_torch.convert import params_from_jax
    from hmm_layer_torch.models import GenePredMultiTransitions, SimpleGenePredTransitions

    if family == "k2":
        t = GenePredMultiTransitions(k=2, sparse_forward=True)
    else:
        t = SimpleGenePredTransitions(sparse_forward=True)
    t.load_state_dict(params_from_jax(pr["params"]))
    return HMMLayer(t, IdentityEmitter(), use_prior=False, device="cpu", **kwargs)


CODONS = dict(
    start_codons=[("ATG", 1.0)],
    stop_codons=[("TAG", 0.34), ("TAA", 0.33), ("TGA", 0.33)],
    intron_begin_pattern=[("NGT", 0.99), ("NGC", 0.005), ("NAT", 0.005)],
    intron_end_pattern=[("AGN", 0.99), ("ACN", 0.01)],
)


def _gene_inputs(seed=11, q=29):
    """15 class probabilities and one-hot ACGTN (b = 4, L = 40), labels
    over the ``q`` states and a label mask."""
    rng = np.random.default_rng(seed)
    cls = rng.dirichlet(np.ones(15), size=(1, B, L))
    nuc = np.eye(5)[rng.integers(0, 5, size=(1, B, L))]
    x = np.concatenate([cls, nuc], axis=-1).astype(np.float32)
    return x, rng.integers(0, q, size=(1, B, L)), (rng.uniform(size=(1, B, L)) > 0.3).astype(np.float32)


def _gene_layer(**kwargs):
    """Config 5's layer family at k = 2 (q = 29): sparse-forward
    ``GenePredMultiTransitions`` and ``GenePredEmissions``, its parameters
    from fixed seeds (the same on every rank)."""
    from hmm_layer_torch import HMMLayer
    from hmm_layer_torch.models import GenePredEmissions, GenePredMultiTransitions, make_15_class_emission_kernel

    layer = HMMLayer(
        GenePredMultiTransitions(k=2, sparse_forward=True, generator=torch.Generator().manual_seed(0)),
        GenePredEmissions(num_copies=2, init=make_15_class_emission_kernel(num_copies=2), **CODONS),
        num_seqs=100,
        device="cpu",
        **kwargs,
    )
    rng = np.random.default_rng(12)
    with torch.no_grad():
        for p in layer.parameters():
            p += torch.as_tensor(rng.normal(0, 0.3, size=p.shape), dtype=p.dtype)
    return layer


def _grads(loss, tensors):
    return [g.numpy() for g in torch.autograd.grad(loss, tensors)]


def _np(x):
    return x.detach().numpy()


# ---------------------------------------------------------------------------
# The world: every case on every rank
# ---------------------------------------------------------------------------


def _function_cases(mesh, data, pr):
    from hmm_layer_torch.parallel import sparse_sharding as S

    init, probs, E, W = (torch.as_tensor(pr[k]) for k in ("init", "probs", "E", "W"))
    idx = pr["indices"]
    kw = dict(mesh=mesh, data_axis=data)
    out = {"ll": _np(S.edge_sharded_log_likelihood(init, idx, probs, E, **kw))}
    lg, ll = S.edge_sharded_posterior(init, idx, probs, E, **kw)
    out["lg"], out["post_ll"] = _np(lg), _np(ll)
    out["lg_nl"] = _np(S.edge_sharded_posterior(init, idx, probs, E, no_loglik=True, **kw)[0])
    out["path"] = S.edge_sharded_viterbi(init, idx, probs, E, **kw).numpy()
    xs = [x.clone().requires_grad_() for x in (init, probs, E)]
    out["g_ll"] = _grads(S.edge_sharded_log_likelihood(xs[0], idx, xs[1], xs[2], **kw).sum(), xs)
    for key, no_loglik in (("g_post", False), ("g_post_nl", True)):
        lg, ll = S.edge_sharded_posterior(xs[0], idx, xs[1], xs[2], no_loglik=no_loglik, **kw)
        out[key] = _grads((lg * W).sum() + ll.sum(), xs)
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


def _local_function_cases(mesh, data, pr):
    """:func:`_function_cases` under ``local=True`` on this rank's blocks
    (:func:`local_ranges`, route ``"edge"``), the gathers forbidden; then
    one global call under the same ban, which must raise. Returned from
    every rank, so every rank holds the list."""
    from hmm_layer_torch.parallel import local_ranges
    from hmm_layer_torch.parallel import sparse_sharding as S

    init, probs, E, W = (torch.as_tensor(pr[k]) for k in ("init", "probs", "E", "W"))
    idx = pr["indices"]
    r = local_ranges(mesh, "edge", E.shape, data_axis=data)
    E_l, W_l = E[r.index], W[r.index]
    kw = dict(mesh=mesh, data_axis=data, local=True)
    out = {"ranges": tuple(r), "error": None}
    try:
        with _no_gathers():
            out["ll"] = _np(S.edge_sharded_log_likelihood(init, idx, probs, E_l, **kw))
            lg, ll = S.edge_sharded_posterior(init, idx, probs, E_l, **kw)
            out["lg"], out["post_ll"] = _np(lg), _np(ll)
            out["lg_nl"] = _np(S.edge_sharded_posterior(init, idx, probs, E_l, no_loglik=True, **kw)[0])
            out["path"] = S.edge_sharded_viterbi(init, idx, probs, E_l, **kw).numpy()
            xs = [x.clone().requires_grad_() for x in (init, probs, E_l)]
            out["g_ll"] = _grads(S.edge_sharded_log_likelihood(xs[0], idx, xs[1], xs[2], **kw).sum(), xs)
            for key, no_loglik in (("g_post", False), ("g_post_nl", True)):
                lg, ll = S.edge_sharded_posterior(xs[0], idx, xs[1], xs[2], no_loglik=no_loglik, **kw)
                out[key] = _grads((lg * W_l).sum() + ll.sum(), xs)
    except AssertionError as e:
        out["error"] = str(e)
    try:
        with _no_gathers():
            S.edge_sharded_log_likelihood(init, idx, probs, E, mesh=mesh, data_axis=data)
        out["global_error"] = None
    except AssertionError as e:
        out["global_error"] = str(e)
    return _from_every_rank(out)


def _layer_cases(mesh, partition, family, pr):
    X = pr["E"]
    labels, mask = pr["labels"], pr["mask"]
    out = {}
    for name, layer in (("single", _sparse_layer(family, pr)),
                        ("mesh", _sparse_layer(family, pr, mesh=mesh, partition=partition))):
        with torch.no_grad():
            out[f"{name}_ll"] = _np(layer.log_likelihood(X))
            out[f"{name}_lg"] = _np(layer.state_posterior_log_probs(X))
            out[f"{name}_path"] = layer.viterbi(X).numpy()
        params = list(layer.parameters())
        out[f"{name}_g_map"] = _grads(layer.loss(X), params)
        out[f"{name}_g_ce"] = _grads(layer.posterior_cross_entropy(X, labels, mask), params)
    return out


def _trainer_case(mesh, partition, pr):
    """Two Trainer steps (Adam 1e-2, the MAP loss) of the mesh layer: the
    loss before and after, and the parameters every rank holds."""
    from hmm_layer_torch.training import Trainer

    layer = _sparse_layer("k2", pr, mesh=mesh, partition=partition)
    X = pr["E"]
    with torch.no_grad():
        before = float(layer.loss(X))
    Trainer(layer).fit([X] * 2, log_every=100)
    with torch.no_grad():
        after = float(layer.loss(X))
    return {"before": before, "after": after, "params": {k: _np(v) for k, v in layer.state_dict().items()}}


def _layer_local_cases(mesh, partition):
    """The sparse layer's state route in the rank-local mode against its
    global mode on the same rank and weights (config 5's family at k = 2):
    log gamma, logliks, paths, the CE and MAP values and gradients, the
    rank's block of E and every emitter call's output shape; then one SGD
    step (lr 0.05) of each objective in both modes. Returned from every
    rank."""
    from hmm_layer_torch.training import Trainer

    X, labels, mask = _gene_inputs()
    layer = _gene_layer(mesh=mesh, partition=partition)
    emitter, calls, shapes = layer.emissions[0], layer.emissions[0].emissions, []

    @functools.wraps(calls)
    def recording(*args, **kwargs):
        out = calls(*args, **kwargs)
        shapes.append(tuple(out.shape))
        return out

    out = {"global_shape": (1, B, L, layer.transitions.num_states)}
    out["ranges"] = tuple(layer.local_ranges(out["global_shape"]))
    params = list(layer.parameters())
    objectives = {"ce": lambda **kw: layer.posterior_cross_entropy(X, labels, mask, **kw),
                  "map": lambda **kw: layer.loss(X, **kw)}
    for mode, kw in (("global", {}), ("local", {"local": True})):
        if mode == "local":
            emitter.emissions = recording
        with torch.no_grad():
            out[f"{mode}_lg"] = _np(layer.state_posterior_log_probs(X, **kw))
            out[f"{mode}_ll"] = _np(layer.log_likelihood(X, **kw))
            out[f"{mode}_path"] = layer.viterbi(X, **kw).numpy()
            out[f"{mode}_E"] = _np(layer._inputs(X, None, False, local=True)[2] if kw else layer.emission_probs(X))
        for key, objective in objectives.items():
            value = objective(**kw)
            out[f"{mode}_{key}"], out[f"{mode}_g_{key}"] = float(value), _grads(value, params)
    del emitter.emissions
    out["emitter_shapes"] = sorted(set(shapes))
    sgd = functools.partial(torch.optim.SGD, lr=0.05)
    for mode, local in (("global", False), ("local", True)):
        for key in ("ce", "map"):
            trained = _gene_layer(mesh=mesh, partition=partition)
            if key == "map":
                loss_fn = lambda batch, i, l=trained, loc=local: l.loss(batch, indices=i, local=loc)  # noqa: E731
            else:
                loss_fn = lambda batch, _, l=trained, loc=local: l.posterior_cross_entropy(  # noqa: E731
                    batch, labels, mask, local=loc)
            Trainer(trained, optimizer=sgd, loss_fn=loss_fn).fit([X], log_every=100)
            out[f"step_{key}_{mode}"] = {k: _np(v) for k, v in trained.state_dict().items()}
    return _from_every_rank(out)


def _ragged_case(mesh, pr):
    """b = 3 rows over two data ranks: the state route splits rows that must
    divide, and raises."""
    layer = _sparse_layer("k2", pr, mesh=mesh, partition=PARTITIONS["data2state2"])
    try:
        layer.log_likelihood(pr["E"][:, :3])
    except ValueError as e:
        return str(e)
    return None


def world_cases(problems):
    """Every case of this file on this rank; run by each rank of the world."""
    from hmm_layer_torch.parallel import make_mesh

    meshes = {name: make_mesh(spec) for name, spec in MESHES.items()}
    out = {}
    for name, mesh in meshes.items():
        data = "data" if "data" in MESHES[name] else None
        out[name] = _function_cases(mesh, data, problems["k2"])
        out[f"local_{name}"] = _local_function_cases(mesh, data, problems["k2"])
        out[f"layer_{name}"] = {f: _layer_cases(mesh, PARTITIONS[name], f, problems[f]) for f in FAMILIES}
        out[f"trainer_{name}"] = _trainer_case(mesh, PARTITIONS[name], problems["k2"])
        out[f"layer_local_{name}"] = _layer_local_cases(mesh, PARTITIONS[name])
    out["ragged"] = _ragged_case(meshes["data2state2"], problems["k2"])
    return out


@pytest.fixture(scope="module")
def world():
    from hmm_layer_torch.parallel.launch import run_world

    return run_world(world_cases, WORLD, _problems(), timeout_s=300)


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


def _fetch(fn, *args):
    """``fn(*args)`` as its own jitted program, run and fetched (numpy)
    before the caller starts another."""
    import jax

    return jax.tree.map(np.asarray, jax.jit(fn)(*args))


@functools.lru_cache(maxsize=None)
def _jax_refs():
    """The JAX references of this file, made in one child process."""
    from test_torch_sharding import _jax_in_child

    return _jax_in_child(_jax_references)


def _jax_references():
    return {name: _jax_function_values(name) for name in MESHES}


def _jax_functions(name):
    return _jax_refs()[name]


def _jax_function_values(name):
    import jax
    import jax.numpy as jnp
    from hmm_layer_tpu.parallel import sharding as J
    from hmm_layer_tpu.parallel import sparse_sharding as JS

    mesh = J.make_mesh(MESHES[name])
    kw = dict(data_axis="data" if "data" in MESHES[name] else None)
    pr = _problems()["k2"]
    idx = pr["indices"]
    args = (pr["init"], pr["probs"], pr["E"])

    def post_obj(i, p, e, W, no_loglik):
        lg, ll = JS.edge_sharded_posterior(i, idx, p, e, mesh, no_loglik=no_loglik, **kw)
        return jnp.sum(lg * W) + jnp.sum(ll)

    out = {"ll": _fetch(lambda i, p, e: JS.edge_sharded_log_likelihood(i, idx, p, e, mesh, **kw), *args)}
    out["lg"], out["post_ll"] = _fetch(lambda i, p, e: JS.edge_sharded_posterior(i, idx, p, e, mesh, **kw), *args)
    out["lg_nl"] = _fetch(
        lambda i, p, e: JS.edge_sharded_posterior(i, idx, p, e, mesh, no_loglik=True, **kw)[0], *args
    )
    out["path"] = _fetch(lambda i, p, e: JS.edge_sharded_viterbi(i, idx, p, e, mesh, **kw), *args)
    out["g_ll"] = _fetch(jax.grad(
        lambda i, p, e: JS.edge_sharded_log_likelihood(i, idx, p, e, mesh, **kw).sum(), argnums=(0, 1, 2)), *args)
    for key, no_loglik in (("g_post", False), ("g_post_nl", True)):
        out[key] = _fetch(jax.grad(functools.partial(post_obj, no_loglik=no_loglik), argnums=(0, 1, 2)),
                          *args, pr["W"])
    return out


def _assert_grads_scaled(got, ref, atol):
    for a, r in zip(got, ref):
        scale = np.abs(np.asarray(r)).max() + 1e-9
        np.testing.assert_allclose(a / scale, np.asarray(r) / scale, atol=atol)


# ---------------------------------------------------------------------------
# The functions against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MESHES))
def test_edge_sharded_log_likelihood(results, name):
    np.testing.assert_allclose(results[name]["ll"], _jax_functions(name)["ll"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("key", ["lg", "lg_nl"])
def test_edge_sharded_posterior(results, name, key):
    ref = _jax_functions(name)
    np.testing.assert_allclose(results[name]["post_ll"], ref["post_ll"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(results[name][key], ref[key], atol=5e-5)


@pytest.mark.parametrize("name", list(MESHES))
def test_edge_sharded_viterbi(results, name):
    path = results[name]["path"]
    assert path.dtype == np.int32 and path.shape == (1, B, L)
    np.testing.assert_array_equal(path, _jax_functions(name)["path"])


@pytest.mark.parametrize("name", list(MESHES))
def test_edge_sharded_log_likelihood_grads(results, name):
    """The analytic Baum-Welch VJP: gradients of init, the edge
    probabilities and E."""
    _assert_grads_scaled(results[name]["g_ll"], _jax_functions(name)["g_ll"], atol=1e-4)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("key", ["g_post", "g_post_nl"])
def test_edge_sharded_posterior_grads(results, name, key):
    """The taped posterior's gradients, with and without ``no_loglik``."""
    _assert_grads_scaled(results[name][key], _jax_functions(name)[key], atol=1e-4)


# ---------------------------------------------------------------------------
# The rank-local mode
# ---------------------------------------------------------------------------


def _block(x, ranges):
    """The block of a global result at a rank's ranges: (m, b, L, q)
    outputs, (m, b, L) paths, (m, b) logliks."""
    rows, positions, states = (slice(*r) for r in ranges)
    return x[(slice(None), rows, positions, states)[: x.ndim]]


@pytest.mark.parametrize("name", list(MESHES))
def test_local_mode_values_are_the_global_blocks(results, name):
    """Under ``local=True`` each rank's log gamma (its real states, the pad
    cut), logliks and paths are bit-equal to its block of the global
    mode's result (which the JAX parity tests above hold)."""
    for rank, loc in enumerate(results[f"local_{name}"]):
        assert loc["error"] is None, f"rank {rank}: {loc['error']}"
        for key in ("ll", "lg", "post_ll", "lg_nl", "path"):
            np.testing.assert_array_equal(loc[key], _block(results[name][key], loc["ranges"]),
                                          err_msg=f"rank {rank} {key}")


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("key", ["g_ll", "g_post", "g_post_nl"])
def test_local_mode_gradients_are_the_global_blocks(results, name, key):
    """The gradient of each rank's ``E`` block is its block of the global
    gradient (through the Baum-Welch VJP for ``g_ll``, the taped scans for
    the posterior); those of ``init`` and the edge probabilities are the
    global ones, bit for bit."""
    for rank, loc in enumerate(results[f"local_{name}"]):
        (gi, gp, gE), (ri, rp, rE) = loc[key], results[name][key]
        np.testing.assert_array_equal(gi, ri, err_msg=f"rank {rank} init")
        np.testing.assert_array_equal(gp, rp, err_msg=f"rank {rank} edge_probs")
        np.testing.assert_array_equal(gE, _block(rE, loc["ranges"]), err_msg=f"rank {rank} E")


@pytest.mark.parametrize("name", list(MESHES))
def test_local_mode_never_gathers(results, name):
    """With ``collectives.gather`` and ``gather_rows`` made to raise, every
    local call ran, while a global call under the same ban raises."""
    for loc in results[f"local_{name}"]:
        assert loc["error"] is None, loc["error"]
        assert loc["global_error"] is not None and "collectives.gather" in loc["global_error"]


class _Mesh:
    """A stand-in for one rank of a mesh: its axis sizes and coordinates."""

    def __init__(self, shape, coords):
        self.shape, self.coords = shape, coords

    def index(self, axis):
        return self.coords[axis]


@pytest.mark.parametrize("b, n_data, q, n_state", [(4, 2, 29, 4), (6, 4, 29, 2), (3, 1, 5, 4), (8, 2, 32, 4)])
def test_local_ranges_follow_row_sizes_and_q_pad(b, n_data, q, n_state):
    """Rows in the blocks of ``row_sizes``; edge-route states in blocks of
    ``ShardedEdgePlan.q_local`` cut at ``q`` (a block past ``q`` is empty:
    the function pads it); the dense state route's equal blocks, raising
    where ``q`` does not divide; seq-route positions in ``row_sizes``
    blocks. The blocks tile the tensor."""
    from hmm_layer_torch.parallel import ShardedEdgePlan, local_ranges
    from hmm_layer_torch.parallel.collectives import row_sizes

    plan = ShardedEdgePlan(np.array([[0, q - 1]]), q, n_state)
    shape = (1, b, 40, q)
    rows = np.cumsum([0] + row_sizes(b, n_data))
    positions = np.cumsum([0] + row_sizes(40, n_state))
    for d in range(n_data):
        for k in range(n_state):
            mesh = _Mesh({"data": n_data, "state": n_state, "seq": n_state}, {"data": d, "state": k, "seq": k})
            edge = local_ranges(mesh, "edge", shape, data_axis="data")
            assert edge.rows == (rows[d], rows[d + 1]) and edge.positions == (0, 40)
            assert edge.states == (min(q, k * plan.q_local), min(q, (k + 1) * plan.q_local))
            seq = local_ranges(mesh, "seq", shape, data_axis="data")
            assert seq.positions == (positions[k], positions[k + 1]) and seq.states == (0, q)
            if q % n_state:
                with pytest.raises(ValueError, match="not divisible"):
                    local_ranges(mesh, "state", shape, data_axis="data")
            else:
                assert local_ranges(mesh, "state", shape).states == (k * q // n_state, (k + 1) * q // n_state)
                assert local_ranges(mesh, "state", shape).rows == (0, b)
    assert sum(min(q, (k + 1) * plan.q_local) - min(q, k * plan.q_local) for k in range(n_state)) == q
    with pytest.raises(ValueError, match="unknown route"):
        local_ranges(_Mesh({"state": 1}, {"state": 0}), "rows", shape)


# ---------------------------------------------------------------------------
# HMMLayer(mesh, partition={"state": ...}) and Trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("family", FAMILIES)
def test_layer_state_route_matches_single_device(results, name, family):
    """Log-likelihood, posterior and decode of the state route against the
    single-device sparse layer (``tests/test_layer_mesh.py``'s
    tolerances)."""
    r = results[f"layer_{name}"][family]
    np.testing.assert_allclose(r["mesh_ll"], r["single_ll"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r["mesh_lg"], r["single_lg"], atol=5e-5)
    np.testing.assert_array_equal(r["mesh_path"], r["single_path"])


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("objective", ["map", "ce"])
def test_layer_state_route_grads_match_single_device(results, name, family, objective):
    """MAP through the sharded Baum-Welch VJP, CE through the taped
    edge-sharded posterior; the single-device layer's CE is the fused
    analytic one."""
    r = results[f"layer_{name}"][family]
    _assert_grads_scaled(r[f"mesh_g_{objective}"], r[f"single_g_{objective}"], atol=1e-4)


@pytest.mark.parametrize("name", list(MESHES))
def test_trainer_trains_the_state_route(world, name):
    """Two Trainer steps lower the MAP loss, and every rank holds the same
    parameters."""
    r = world[0][f"trainer_{name}"]
    assert r["after"] < r["before"]
    for other in world[1:]:
        for key, value in r["params"].items():
            np.testing.assert_array_equal(other[f"trainer_{name}"]["params"][key], value)


# The tolerances of ``tests/test_torch_sharding.py``'s local-mode layer
# tests: E's block comes from matmuls of other shapes than the global
# mode's, so the two modes agree to float32 rounding, not bit for bit.
LOCAL_LG_TOL, LOCAL_GRAD_TOL = 1e-4, 5e-5


@pytest.mark.parametrize("name", list(MESHES))
def test_layer_local_mode_returns_the_global_blocks(results, name):
    """Under ``local=True`` each rank's log gamma (its real states: config
    5's column blocks of ``ceil(q / n)``, the last cut at q), logliks and
    paths are its block of the global layer call; E's block is the global
    E's, computed alone by the emitter (no call returned the global
    shape)."""
    for rank, r in enumerate(results[f"layer_local_{name}"]):
        rows, positions, states = r["ranges"]
        assert r["emitter_shapes"] == [(1, rows[1] - rows[0], L, states[1] - states[0])], r["emitter_shapes"]
        np.testing.assert_allclose(r["local_E"], _block(r["global_E"], r["ranges"]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(r["local_lg"], _block(r["global_lg"], r["ranges"]), rtol=0, atol=LOCAL_LG_TOL,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(r["local_ll"], _block(r["global_ll"], r["ranges"]), rtol=1e-6)
        np.testing.assert_array_equal(r["local_path"], _block(r["global_path"], r["ranges"]))


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("objective", ["ce", "map"])
def test_layer_local_mode_objectives_gradients_and_steps(results, name, objective):
    """The local objective is the whole batch's value, its parameter
    gradients the global mode's (within float32 rounding) and the same on
    every rank; one SGD step leaves every rank with the same parameters,
    the global mode's step within rtol 1e-5, atol 1e-6."""
    ranks = results[f"layer_local_{name}"]
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r[f"local_{objective}"], r[f"global_{objective}"], rtol=1e-6)
        _assert_grads_scaled(r[f"local_g_{objective}"], r[f"global_g_{objective}"], atol=LOCAL_GRAD_TOL)
        for got, first in zip(r[f"local_g_{objective}"], ranks[0][f"local_g_{objective}"]):
            np.testing.assert_array_equal(got, first)
        for key, value in r[f"step_{objective}_global"].items():
            np.testing.assert_allclose(r[f"step_{objective}_local"][key], value, rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(r[f"step_{objective}_local"][key], ranks[0][f"step_{objective}_local"][key])


def test_ragged_rows_raise(results):
    err = results["ragged"]
    assert err is not None and "not divisible" in err, err


def test_every_rank_returns_the_global_result(world):
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
# In-process checks (no process group: one-rank meshes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards, q_pad", [(1, 29), (2, 30), (4, 32), (8, 32)])
def test_plan_buckets_keep_the_single_device_edge_order(n_shards, q_pad):
    """Concatenated over the shards, the forward buckets are the
    single-device plan's destination order and the backward buckets its
    source order; each bucket's keys lie in its own state block."""
    from hmm_layer_torch.models import GenePredMultiTransitions
    from hmm_layer_torch.ops.sparse import EdgePlan
    from hmm_layer_torch.parallel import ShardedEdgePlan

    indices, _ = GenePredMultiTransitions(k=2, sparse_forward=True).make_A_sparse()
    plan = ShardedEdgePlan(indices, 29, n_shards)
    single = EdgePlan(indices)
    assert (plan.q_pad, plan.q_local) == (q_pad, q_pad // n_shards)
    np.testing.assert_array_equal(np.concatenate([b.sel for b in plan.fwd]), single.perm_d)
    np.testing.assert_array_equal(np.concatenate([b.sel for b in plan.bwd]), single.perm_s)
    for buckets, col in ((plan.fwd, 1), (plan.bwd, 0)):
        for d, bucket in enumerate(buckets):
            assert ((bucket.key >= 0) & (bucket.key < plan.q_local)).all()
            np.testing.assert_array_equal(bucket.key + d * plan.q_local, indices[bucket.sel, col])
            np.testing.assert_array_equal(bucket.other, indices[bucket.sel, 1 - col])


def test_plan_is_memoised_and_takes_host_indices_only():
    from hmm_layer_torch.models import GenePredMultiTransitions
    from hmm_layer_torch.parallel import ShardedEdgePlan

    indices, _ = GenePredMultiTransitions(k=2, sparse_forward=True).make_A_sparse()
    assert ShardedEdgePlan.cached(indices, 29, 4) is ShardedEdgePlan.cached(torch.as_tensor(indices), 29, 4)
    with pytest.raises(TypeError, match="host array"):
        ShardedEdgePlan.cached(torch.as_tensor(indices, device="meta"), 29, 4)
    with pytest.raises(ValueError, match="reach state 28"):
        ShardedEdgePlan(indices, 20, 2)


def test_state_route_sample_paths_raises():
    """``sample_paths`` (and the recursions the dense engine serves) have no
    state-sharded form, as in the JAX layer."""
    from hmm_layer_torch.parallel import make_mesh

    pr = _problems()["simple"]
    layer = _sparse_layer("simple", pr, mesh=make_mesh({"state": 1}), partition={"state": "state"})
    with pytest.raises(NotImplementedError, match="sample_paths"):
        layer.sample_paths(pr["E"])
    with pytest.raises(NotImplementedError, match="forward_recursion"):
        layer.forward_recursion(pr["E"])


def test_plans_first_used_in_inference_mode_serve_taped_gradients():
    """The index tensors of both plans (single-device and sharded) are made
    outside inference mode: a taped gradient after a first call in
    inference mode works and equals the single-device one."""
    from hmm_layer_torch.ops import sparse
    from hmm_layer_torch.parallel import edge_sharded_posterior, make_mesh

    pr = _problems()["simple"]
    mesh = make_mesh({"state": 1})
    indices = pr["indices"].copy()
    indices[[0, -1]] = indices[[-1, 0]]  # an edge order no other test has cached
    args = [torch.tensor(pr[k]) for k in ("init", "probs", "E")]
    with torch.inference_mode():
        sparse.sparse_posterior(args[0], indices, *args[1:], analytic_vjp=False)
        edge_sharded_posterior(args[0], indices, *args[1:], mesh)
    grads = []
    for fn in (lambda i, p, e: sparse.sparse_posterior(i, indices, p, e, analytic_vjp=False),
               lambda i, p, e: edge_sharded_posterior(i, indices, p, e, mesh)):
        xs = [x.clone().requires_grad_() for x in args]
        lg, ll = fn(*xs)
        grads.append(_grads((lg * torch.tensor(pr["W"])).sum() + ll.sum(), xs))
    for a, b in zip(*grads):
        np.testing.assert_array_equal(a, b)
