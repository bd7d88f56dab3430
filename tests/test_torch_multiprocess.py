"""Two processes over ``torch.distributed`` (gloo, on the CPU) take one
data-parallel training step, compared with one process taking it on the
whole batch (the port of ``tests/test_multiprocess.py``); and a world whose
ranks diverge fails within its time limit instead of hanging.

The ranks load this file without JAX (``hmm_layer_torch.parallel.launch``).
"""

import numpy as np
import pytest
import torch

LR = 0.1


def _problem():
    """The JAX test's problem: q = 5, b = 4, L = 32, one model."""
    rng = np.random.default_rng(0)
    q, b, L = 5, 4, 32
    init = rng.dirichlet(np.ones(q)).astype(np.float32)[None]
    A = rng.dirichlet(np.ones(q), size=q).astype(np.float32)[None]
    E = rng.uniform(0.1, 1.0, size=(1, b, L, q)).astype(np.float32)
    return init, A, E


def _dp_step(mesh):
    """One SGD step on the mean negative log-likelihood over ``mesh``'s
    ``data`` axis (``data_parallel_fn``); the one-rank mesh without a
    process group is the single-process run."""
    from hmm_layer_torch.ops import recursion
    from hmm_layer_torch.parallel import data_parallel_fn

    init, A, E = (torch.as_tensor(x) for x in _problem())
    params = {"init": init.clone().requires_grad_(), "A": A.clone().requires_grad_()}

    def loss(p, x):
        return -recursion.log_likelihood(p["init"], p["A"], x).mean()

    value = data_parallel_fn(loss, mesh)(params, E)
    grads = torch.autograd.grad(value, [params["init"], params["A"]])
    new = [(p - LR * g).detach().numpy() for p, g in zip((params["init"], params["A"]), grads)]
    return float(value.detach()), [g.numpy() for g in grads], new


def two_process_step():
    import torch.distributed as dist

    from hmm_layer_torch.parallel import make_mesh

    assert dist.get_world_size() == 2
    return _dp_step(make_mesh({"data": 2}))


def diverging_ranks():
    """Rank 0 waits in an all-reduce its peer never joins."""
    import torch.distributed as dist

    if dist.get_rank() == 0:
        dist.all_reduce(torch.ones(1))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_two_process_dp_step():
    from hmm_layer_torch.ops import recursion
    from hmm_layer_torch.parallel import make_mesh
    from hmm_layer_torch.parallel.launch import run_world

    results = run_world(two_process_step, 2, timeout_s=180)
    value, grads, new = _dp_step(make_mesh({"data": 1}))
    init, A, E = _problem()
    ref = -recursion.log_likelihood(torch.as_tensor(init), torch.as_tensor(A), torch.as_tensor(E)).mean()
    for v, g, n in results:
        assert abs(v - float(ref)) < 1e-4 * max(1.0, abs(float(ref)))
        np.testing.assert_allclose(v, value, rtol=1e-6)
        for a, b in zip(g, grads):
            assert np.all(np.isfinite(a))
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        for a, b in zip(n, new):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_diverging_world_fails_instead_of_hanging():
    from hmm_layer_torch.parallel.launch import run_world

    with pytest.raises((RuntimeError, TimeoutError)):
        run_world(diverging_ranks, 2, timeout_s=15)
