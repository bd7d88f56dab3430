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

The JAX references run in one child process (:func:`_jax_in_child`),
each quantity its own jitted program: XLA:CPU's in-process all-reduce
rendezvous keys on (run, devices, op id), and a program whose independent
sharded scans run at once (the forward and backward scans of one
posterior, or several functions in one program) can put two of its
all-reduces in one rendezvous (``Check failed: id < num_threads``); the
process then aborts or segfaults while its result is fetched. A child
that dies so is run again; the pytest worker goes on.
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
LOCAL_FAMILIES = ("simple", "k2")
LOCAL_TRAINERS = ("seq4", "data2state2", "data4")
JAX_LAYER_MESHES = ("data2seq2", "state4")  # the JAX layer references of the local blocks
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


CODONS = dict(
    start_codons=[("ATG", 1.0)],
    stop_codons=[("TAG", 0.34), ("TAA", 0.33), ("TGA", 0.33)],
    intron_begin_pattern=[("NGT", 0.99), ("NGC", 0.005), ("NAT", 0.005)],
    intron_end_pattern=[("AGN", 0.99), ("ACN", 0.01)],
)
K2_Q = 29  # GenePredMultiTransitions(k=2): 1 + 14 * 2 states


def _k2_inputs(seed=5, b=4, L=96):
    """15 class probabilities, one-hot ACGTN (a tenth N), labels over the
    29 states, a label mask and per-chunk end hints (8 chunks of 12)."""
    rng = np.random.default_rng(seed)
    cls = rng.dirichlet(np.ones(15), size=(1, b, L))
    nuc = np.eye(5)[np.where(rng.uniform(size=(1, b, L)) < 0.1, 4, rng.integers(0, 4, size=(1, b, L)))]
    x = np.concatenate([cls, nuc], axis=-1).astype(np.float32)
    labels = rng.integers(0, K2_Q, size=(1, b, L))
    mask = (rng.uniform(size=(1, b, L)) > 0.3).astype(np.float32)
    hints = rng.uniform(0.2, 1.0, size=(1, b, 8, 2, K2_Q)).astype(np.float32)
    return x, labels, mask, hints


def _k2_layer(**kwargs):
    """The multi-copy gene-pred layer (k = 2, q = 29; trainable exon
    nucleotides) on the CPU, its parameters drawn from fixed seeds (the
    same on every rank)."""
    from hmm_layer_torch import HMMLayer
    from hmm_layer_torch.models import GenePredEmissions, GenePredMultiTransitions, make_15_class_emission_kernel

    layer = HMMLayer(
        GenePredMultiTransitions(k=2, generator=torch.Generator().manual_seed(0)),
        GenePredEmissions(num_copies=2, init=make_15_class_emission_kernel(num_copies=2),
                          trainable_nucleotides_at_exons=True, **CODONS),
        num_seqs=100,
        parallel_factor=P_SEQ,
        device="cpu",
        **kwargs,
    )
    rng = np.random.default_rng(6)
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


@contextlib.contextmanager
def _emitter_shapes(layer, shapes):
    """Inside the block every emitter call of ``layer`` appends its
    output's shape to ``shapes``."""
    saved = [(em, em.emissions) for em in layer.emissions]

    def recording(call):
        @functools.wraps(call)
        def emissions(*args, **kwargs):
            out = call(*args, **kwargs)
            shapes.append(tuple(out.shape))
            return out

        return emissions

    for em, call in saved:
        em.emissions = recording(call)
    try:
        yield
    finally:
        for em, _ in saved:
            del em.emissions


def _layer_local_cases(mesh, partition, family="simple"):
    """The layer's rank-local mode (``local=True``) against its global mode
    on the same rank and weights: log gamma, logliks, paths, the CE and
    MAP values and their parameter gradients, and the rank's block of E;
    the shapes every emitter call of the local calls returned. Returned
    from every rank."""
    if family in ("simple", "sparse"):
        X, labels, mask = _layer_inputs()
        hints, layer = None, _gene_layer(family == "sparse", mesh=mesh, partition=partition)
    else:
        X, labels, mask, hints = _k2_inputs()
        layer = _k2_layer(mesh=mesh, partition=partition)
    q = layer.transitions.num_states
    out, shapes = {}, []
    with torch.no_grad():
        for key, call in (("lg", layer.state_posterior_log_probs), ("ll", layer.log_likelihood),
                          ("path", layer.viterbi)):
            out[key] = _np(call(X, end_hints=hints))
            with _emitter_shapes(layer, shapes):
                out[f"local_{key}"] = _np(call(X, end_hints=hints, local=True))
        out["E"] = _np(layer.emission_probs(X, end_hints=hints))
        with _emitter_shapes(layer, shapes):
            out["local_E"] = _np(layer._inputs(X, hints, False, local=True)[2])
    params = list(layer.parameters())
    for key, objective in (("ce", lambda **kw: layer.posterior_cross_entropy(X, labels, mask, end_hints=hints, **kw)),
                           ("map", lambda **kw: layer.loss(X, end_hints=hints, **kw))):
        value = objective()
        out[key], out[f"g_{key}"] = float(value), _grads(value, params)
        with _emitter_shapes(layer, shapes):
            value = objective(local=True)
        out[f"local_{key}"], out[f"local_g_{key}"] = float(value), _grads(value, params)
    out["ranges"] = tuple(layer.local_ranges((1, X.shape[1], X.shape[2], q)))
    out["global_shape"], out["emitter_shapes"] = (1, X.shape[1], X.shape[2], q), sorted(set(shapes))
    with torch.no_grad():
        init, A = layer.transitions.matrices()
        out["init"], out["A"] = _np(init), _np(A)
        out["params"] = {k: _np(v) for k, v in layer.state_dict().items()}
    return _from_every_rank(out)


def _trainer_local_cases(mesh, partition):
    """One SGD step (lr 0.05) of the CE objective and one of the MAP loss
    (``layer.loss``, the Trainer's default objective, through ``loss_fn``)
    in the rank-local mode and in the global mode, from the same weights:
    the parameters after each. Returned from every rank."""
    from hmm_layer_torch.training import Trainer

    X, labels, mask = _layer_inputs()
    sgd = functools.partial(torch.optim.SGD, lr=0.05)
    out = {}
    for mode, local in (("global", False), ("local", True)):
        layer = _gene_layer(mesh=mesh, partition=partition)
        Trainer(layer, optimizer=sgd, loss_fn=lambda batch, _, l=layer, loc=local: l.posterior_cross_entropy(
            batch, labels, mask, local=loc)).fit([X], log_every=100)
        out[f"ce_{mode}"] = {k: _np(v) for k, v in layer.state_dict().items()}
        layer = _gene_layer(mesh=mesh, partition=partition)
        Trainer(layer, optimizer=sgd, loss_fn=lambda batch, i, l=layer, loc=local: l.loss(
            batch, indices=i, local=loc)).fit([X], log_every=100)
        out[f"map_{mode}"] = {k: _np(v) for k, v in layer.state_dict().items()}
    return _from_every_rank(out)


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
    out["layer_local"] = {
        f"{name}-{family}": _layer_local_cases(meshes[name], part, family)
        for name, part in LAYER_PARTITIONS.items() for family in LOCAL_FAMILIES
    }
    out["layer_local"]["data4-sparse"] = _layer_local_cases(meshes["data4"], LAYER_PARTITIONS["data4"], "sparse")
    out["trainer_local"] = {name: _trainer_local_cases(meshes[name], LAYER_PARTITIONS[name]) for name in LOCAL_TRAINERS}
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


def _jax_in_child(fn, *args, attempts=3):
    """``fn(*args)`` in a fresh child process (spawned; it sets up JAX as
    ``tests/conftest.py`` does), run again when the child dies (XLA:CPU's
    rendezvous abort, see the module docstring), at most ``attempts``
    times; an exception in ``fn`` is raised here."""
    import concurrent.futures as cf
    import multiprocessing
    import warnings

    for attempt in range(1, attempts + 1):
        with cf.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
            try:
                return pool.submit(_in_child, fn, *args).result()
            except cf.process.BrokenProcessPool:
                warnings.warn(f"the JAX reference process died (attempt {attempt} of {attempts})")
    raise RuntimeError(f"the JAX reference process died {attempts} times")


def _in_child(fn, *args):
    import conftest  # noqa: F401 -- the 8-device CPU platform and the compilation cache

    return fn(*args)


@functools.lru_cache(maxsize=None)
def _jax_refs():
    """Every JAX reference of this file, made in one child process."""
    return _jax_in_child(_jax_references)


def _jax_references():
    params = {k: _np(v) for k, v in _gene_layer().state_dict().items()}
    return {
        "seq": {name: _jax_seq_values(name) for name in SEQ_MESHES},
        "state": {name: _jax_state_values(name) for name in STATE_MESHES},
        "data": _jax_data_values(),
        "layer": {name: _jax_layer_values(name, params) for name in JAX_LAYER_MESHES},
        "layer_params": params,
    }


def _jax_seq(name):
    return _jax_refs()["seq"][name]


def _jax_state(name):
    return _jax_refs()["state"][name]


def _jax_data():
    return _jax_refs()["data"]


def _jax_mesh(name):
    from hmm_layer_tpu.parallel import sharding as J

    return J.make_mesh(MESHES[name])


def _fetch(fn, *args):
    """``fn(*args)`` as its own jitted program, run and fetched (numpy)
    before the caller starts another (see the module docstring)."""
    import jax

    return jax.tree.map(np.asarray, jax.jit(fn)(*args))


def _jax_seq_values(name):
    from functools import partial

    import jax
    import jax.numpy as jnp
    from hmm_layer_tpu.parallel import sharding as J

    mesh = _jax_mesh(name)
    kw = dict(data_axis="data" if "data" in MESHES[name] else None, local_parallel_factor=P_SEQ)
    pr = SEQ_PROBLEM()
    args = (pr["init"], pr["A"], pr["E"])

    def post_obj(*a, no_loglik=False):
        lg, ll = J.seq_sharded_posterior(*a[:3], mesh, no_loglik=no_loglik, **kw)
        return jnp.sum(lg * a[3]) + jnp.sum(ll)

    out = {"ll": _fetch(lambda *a: J.seq_sharded_log_likelihood(*a, mesh, **kw), *args)}
    out["lg"], out["post_ll"] = _fetch(lambda *a: J.seq_sharded_posterior(*a, mesh, **kw), *args)
    out["lg_nl"] = _fetch(lambda *a: J.seq_sharded_posterior(*a, mesh, no_loglik=True, **kw)[0], *args)
    out["path"] = _fetch(lambda *a: J.seq_sharded_viterbi(*a, mesh, **kw), *args)
    out["g_ll"] = _fetch(
        jax.grad(lambda *a: J.seq_sharded_log_likelihood(*a, mesh, **kw).sum(), argnums=(0, 1, 2)), *args
    )
    out["g_post"] = _fetch(jax.grad(post_obj, argnums=(0, 1, 2)), *args, pr["W"])
    out["g_post_nl"] = _fetch(jax.grad(partial(post_obj, no_loglik=True), argnums=(0, 1, 2)), *args, pr["W"])
    return out


def _jax_state_values(name):
    import jax
    import jax.numpy as jnp
    from hmm_layer_tpu.parallel import sharding as J

    mesh = _jax_mesh(name)
    kw = dict(data_axis="data" if "data" in MESHES[name] else None)
    pr = STATE_PROBLEM()
    args = (pr["init"], pr["A"], pr["E"])

    def post_obj(*a):
        lg, ll = J.state_sharded_posterior(*a[:3], mesh, **kw, parallel_factor=P_STATE)
        return jnp.sum(lg * a[3]) + jnp.sum(ll)

    out = {
        "ll_P1": _fetch(lambda *a: J.state_sharded_log_likelihood(*a, mesh, **kw), *args),
        f"ll_P{P_STATE}": _fetch(
            lambda *a: J.state_sharded_log_likelihood(*a, mesh, **kw, parallel_factor=P_STATE), *args
        ),
    }
    out["lg_P1"], out["post_ll_P1"] = _fetch(lambda *a: J.state_sharded_posterior(*a, mesh, **kw), *args)
    out[f"lg_nl_P{P_STATE}"] = _fetch(
        lambda *a: J.state_sharded_posterior(*a, mesh, **kw, no_loglik=True, parallel_factor=P_STATE)[0], *args
    )
    out["path"] = _fetch(lambda *a: J.state_sharded_viterbi(*a, mesh, **kw), *args)
    out["g_ll"] = _fetch(
        jax.grad(lambda *a: J.state_sharded_log_likelihood(*a, mesh, **kw).sum(), argnums=(0, 1, 2)), *args
    )
    out["g_post"] = _fetch(jax.grad(post_obj, argnums=(0, 1, 2)), *args, pr["W"])
    return out


def _jax_layer_values(name, params):
    """The JAX layer with a mesh (``tests/test_layer_mesh.py``'s
    ``HMMLayer(mesh, partition)``) on the simple family's inputs, at the
    port layer's weights ``params`` (its ``state_dict``): log gamma and
    logliks, the global arrays."""
    from hmm_layer_tpu.layer import HMMLayer
    from hmm_layer_tpu.models import SimpleGenePredEmissions, SimpleGenePredTransitions

    tree = {"transitions": {}, "emissions": [{}]}
    for key, value in params.items():
        part, *rest = key.split(".")
        (tree["transitions"] if part == "transitions" else tree["emissions"][int(rest[0])])[rest[-1]] = value
    layer = HMMLayer(SimpleGenePredTransitions(), SimpleGenePredEmissions(), num_seqs=100, parallel_factor=P_SEQ,
                     mesh=_jax_mesh(name), partition=LAYER_PARTITIONS[name])
    X = _layer_inputs()[0]
    return {"lg": _fetch(layer.state_posterior_log_probs, tree, X), "ll": _fetch(layer.log_likelihood, tree, X)}


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
def test_state_log_likelihood(world, name, P):
    key = f"ll_P{P}"
    ref = _jax_state(name)[key]
    for rank, got in enumerate(r[name][key] for r in world):
        np.testing.assert_allclose(got, ref, rtol=1e-4, err_msg=(
            f"rank {rank}; every rank's {key}: {[r[name][key].tolist() for r in world]}; JAX: {ref.tolist()}"))


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


def _jax_data_values():
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
# The layer's rank-local mode
# ---------------------------------------------------------------------------

# ... and the sparse engine's data route (its state route: tests/test_torch_sparse_sharding.py)
LOCAL_CASES = [f"{name}-{family}" for name in LAYER_PARTITIONS for family in LOCAL_FAMILIES] + ["data4-sparse"]
# The local mode computes E's block with matmuls of other shapes than the
# global mode's (rows, positions or state columns cut), whose float32 sums
# may round differently in the last bit (CPU BLAS picks its kernel by
# shape), and sums the parameter gradients in another order: outputs are
# held to float32 rounding, not bit-equality.
LOCAL_LG_TOL = 1e-4  # log gamma, max abs (|log gamma| <= ~60 here)
LOCAL_GRAD_TOL = 5e-5  # parameter gradients, max abs over the largest


def _tile(blocks, shape, dtype):
    """The global array from every rank's block (``(ranges, block)``)."""
    out = np.full(shape, np.nan if np.issubdtype(dtype, np.floating) else -1, dtype)
    for ranges, block in blocks:
        index = tuple(slice(*r) for r in ranges)[: len(shape) - 1]
        out[(slice(None), *index)] = block
    return out


def _state_cut(ranges, q):
    rows, positions, (s0, s1) = ranges
    return rows, positions, (min(s0, q), min(s1, q))


@pytest.mark.parametrize("case", LOCAL_CASES)
def test_layer_local_mode_returns_the_global_blocks(results, case):
    """Each rank's ``local=True`` log gamma (its real states), logliks and
    paths are its block of the global layer call (the whole result under
    the data route, which gathers); the blocks tile the global result."""
    ranks = results["layer_local"][case]
    glob = ranks[0]
    q = glob["global_shape"][-1]
    data_route = case.startswith("data4")
    for rank, r in enumerate(ranks):
        rng = ((0, 4), (0, 96), (0, q)) if data_route else _state_cut(r["ranges"], q)
        np.testing.assert_allclose(r["local_lg"], _block(r["lg"], rng), rtol=0, atol=LOCAL_LG_TOL,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(r["local_ll"], _block(r["ll"], rng), rtol=1e-6, err_msg=f"rank {rank}")
        assert r["local_path"].shape == _block(r["path"], rng).shape
    if not data_route:
        lg = _tile([(_state_cut(r["ranges"], q), r["local_lg"]) for r in ranks], glob["lg"].shape, np.float32)
        path = _tile([(r["ranges"], r["local_path"]) for r in ranks], glob["path"].shape, np.int32)
        assert not np.isnan(lg).any() and (path >= 0).all()
    else:
        path = glob["local_path"]
    _assert_paths_equivalent(glob["init"], glob["A"], glob["E"], path, glob["path"])


@pytest.mark.parametrize("case", LOCAL_CASES)
def test_layer_local_mode_objectives_and_gradients(results, case):
    """The local CE and MAP values are the whole batch's on every rank, and
    the parameter gradients the global mode's, the same on every rank
    (the emitters' summed over the ranks, init's and A's from the sharded
    functions, not summed again)."""
    ranks = results["layer_local"][case]
    for rank, r in enumerate(ranks):
        for key in ("ce", "map"):
            np.testing.assert_allclose(r[f"local_{key}"], r[key], rtol=1e-6, err_msg=f"rank {rank} {key}")
            _assert_grads_scaled(r[f"local_g_{key}"], r[f"g_{key}"], atol=LOCAL_GRAD_TOL)
            for got, first in zip(r[f"local_g_{key}"], ranks[0][f"local_g_{key}"]):
                np.testing.assert_array_equal(got, first, err_msg=f"rank {rank} {key}")


@pytest.mark.parametrize("case", LOCAL_CASES)
def test_layer_local_emitters_compute_only_the_rank_block(results, case):
    """No emitter call of the local mode returned the global (m, b, L, q)
    shape: each returned the rank's block (rows, positions and real
    states; the codon factors' halo inside the emitter), equal to the
    global E's block, and under the state route the last ranks' pad states
    are zero columns of the block."""
    for rank, r in enumerate(results["layer_local"][case]):
        q = r["global_shape"][-1]
        rows, positions, states = _state_cut(r["ranges"], q)
        block = (1, rows[1] - rows[0], positions[1] - positions[0], states[1] - states[0])
        assert r["emitter_shapes"] == [block], (rank, r["emitter_shapes"], r["global_shape"])
        assert r["global_shape"] not in r["emitter_shapes"]
        width = block[-1]
        assert r["local_E"].shape == (*block[:3], r["ranges"][2][1] - r["ranges"][2][0])
        np.testing.assert_allclose(r["local_E"][..., :width], _block(r["E"], (rows, positions, states)),
                                   rtol=1e-6, atol=0, err_msg=f"rank {rank}")
        assert (r["local_E"][..., width:] == 0).all()


@pytest.mark.parametrize("name", JAX_LAYER_MESHES)
def test_layer_local_blocks_gathered_match_jax_layer(results, name):
    """The JAX layer with the same mesh and partition is the reference for
    the rank blocks gathered: log gamma and logliks, at the tolerances of
    the function parity tests above."""
    ranks = results["layer_local"][f"{name}-simple"]
    glob = ranks[0]
    q = glob["global_shape"][-1]
    lg = _tile([(_state_cut(r["ranges"], q), r["local_lg"]) for r in ranks], glob["lg"].shape, np.float32)
    ll = np.zeros_like(glob["ll"])
    for r in ranks:
        ll[:, slice(*r["ranges"][0])] = r["local_ll"]
    for key, value in _jax_refs()["layer_params"].items():  # the reference's weights are the ranks'
        np.testing.assert_array_equal(glob["params"][key], value)
    ref = _jax_refs()["layer"][name]
    np.testing.assert_allclose(ll, ref["ll"], rtol=1e-4)
    np.testing.assert_allclose(lg, ref["lg"], rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("name", LOCAL_TRAINERS)
@pytest.mark.parametrize("objective", ["ce", "map"])
def test_trainer_local_step_matches_global(results, name, objective):
    """One SGD step in the rank-local mode leaves every rank with the same
    parameters (bit-equal across the ranks), equal to the global mode's
    step within float32 rounding (rtol 1e-5, atol 1e-6)."""
    ranks = results["trainer_local"][name]
    for rank, r in enumerate(ranks):
        for key, value in r[f"{objective}_global"].items():
            np.testing.assert_allclose(r[f"{objective}_local"][key], value, rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {rank} {key}")
            np.testing.assert_array_equal(r[f"{objective}_local"][key], ranks[0][f"{objective}_local"][key])


# ---------------------------------------------------------------------------
# In-process checks (no process group: a one-rank mesh)
# ---------------------------------------------------------------------------


EMITTERS = {
    "k2_kmers": dict(family="gene", num_copies=2, trainable_nucleotides_at_exons=True),
    "k2_lookup": dict(family="gene", num_copies=2, onehot_lookup_kmers=True),
    "k1_float32_kmers": dict(family="gene", num_copies=1, compute_kmers_in_bf16=False),
    "simple_embeddings": dict(family="simple", num_copies=2, emit_embeddings=True, embedding_dim=3),
    "profile": dict(family="profile"),
}


def _emitter(kind):
    """An emitter of ``kind`` (:data:`EMITTERS`), its parameters moved off
    their initial values by a fixed draw, and its (1, 4, 96, s) inputs."""
    from hmm_layer_torch import models

    cfg = dict(EMITTERS[kind])
    family = cfg.pop("family")
    rng = np.random.default_rng(8)
    if family == "profile":
        em = models.ProfileEmissions([20])
        x = rng.dirichlet(np.ones(em.make_B().shape[-1] - 1), size=(1, 4, 96))
    elif family == "gene":
        em = models.GenePredEmissions(init=models.make_15_class_emission_kernel(num_copies=cfg["num_copies"]),
                                      **CODONS, **cfg)
        nuc = np.eye(5)[rng.integers(0, 5, size=(1, 4, 96))]
        x = np.concatenate([rng.dirichlet(np.ones(15), size=(1, 4, 96)), nuc], axis=-1)
    else:
        em = models.SimpleGenePredEmissions(**cfg, generator=torch.Generator().manual_seed(1))
        x = rng.uniform(0.1, 1.0, size=(1, 4, 96, em.num_states + cfg["embedding_dim"]))
    with torch.no_grad():
        for p in em.parameters():
            p += torch.as_tensor(rng.normal(0, 0.3, size=p.shape), dtype=p.dtype)
    return em, torch.as_tensor(x, dtype=torch.float32)


@pytest.mark.parametrize("kind", list(EMITTERS))
@pytest.mark.parametrize("hints", [None, "sequence", "chunks"])
def test_emitter_blocks_equal_the_global_emissions(kind, hints):
    """Every rank's block of the meshes of this file — seq blocks at both
    sequence ends and in the middle (the codon factors' two-position
    halo), state column blocks (the shared intron columns, the multi-copy
    factor columns, the last block cut at q) and row blocks — equals the
    global emissions' block, with sequence-level or per-chunk (8 chunks of
    12) end hints, within float32 rounding (the class products are
    matmuls of other shapes)."""
    from hmm_layer_torch.parallel.collectives import local_ranges

    class _Mesh:
        def __init__(self, shape, coords):
            self.shape, self.coords = shape, coords

        def index(self, axis):
            return self.coords[axis]

    em, x = _emitter(kind)
    with torch.no_grad():
        q = em.emissions(x).shape[-1]
        rng = np.random.default_rng(9)
        end_hints = None if hints is None else torch.as_tensor(
            rng.uniform(0.2, 1.0, size=(1, 4, 2, q) if hints == "sequence" else (1, 4, 8, 2, q)), dtype=torch.float32)
        full = em.emissions(x, end_hints=end_hints)
        seen = set()
        for spec in MESHES.values():
            axes = list(spec)
            for coords in np.ndindex(*spec.values()):
                mesh = _Mesh(spec, dict(zip(axes, coords)))
                data = "data" if "data" in spec else None
                for route in ("seq", "edge"):
                    if route == "seq" and "seq" not in spec or route == "edge" and "state" not in spec:
                        continue
                    r = local_ranges(mesh, route, full.shape, data_axis=data)
                    block = em.emissions(x, end_hints=end_hints, block=r)
                    assert block.shape == full[r.index].shape, (kind, r)
                    torch.testing.assert_close(block, full[r.index], rtol=1e-6, atol=0, msg=f"{kind} {tuple(r)}")
                    seen.add(tuple(r))
        assert ((0, 4), (0, 24), (0, q)) in seen and ((0, 4), (72, 96), (0, q)) in seen  # both ends


@pytest.mark.parametrize("kind", [k for k in EMITTERS if EMITTERS[k]["family"] != "profile"])
def test_gene_emitter_state_blocks_at_every_cut(kind):
    """Every state range ``[s0, s1)`` of a gene-pred emitter, cut anywhere
    (inside a copy run of the shared introns, the multi-copy codon
    classes and the exon factor), equals the global emissions' columns
    within float32 rounding."""
    em, x = _emitter(kind)
    with torch.no_grad():
        full = em.emissions(x)
        q = full.shape[-1]
        for s0 in range(q):
            for s1 in range(s0 + 1, q + 1):
                block = em.emissions(x, block=((0, 4), (0, 96), (s0, s1)))
                torch.testing.assert_close(block, full[..., s0:s1], rtol=1e-6, atol=0, msg=f"{kind} {(s0, s1)}")


def test_local_mode_needs_emitters_that_take_a_block():
    """An emitter whose ``emissions`` takes no ``block`` computes no block:
    ``emission_probs(block=...)`` raises and names the emitters."""
    from hmm_layer_torch import HMMLayer, models

    class Whole(torch.nn.Module):
        def emissions(self, inputs, end_hints=None, training=False):
            return inputs

    layer = HMMLayer(models.SimpleGenePredTransitions(), Whole(), device="cpu")
    x = torch.rand(1, 2, 6, 7)
    assert torch.equal(layer.emission_probs(x), x)
    with pytest.raises(NotImplementedError, match="Whole"):
        layer.emission_probs(x, block=((0, 2), (0, 6), (0, 7)))


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
