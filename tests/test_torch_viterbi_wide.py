"""The sequential decode at 64 < q <= 512 on the CPU: the plain versions of
K7c and K8c (``cuda_viterbi.maxplus_deltas_wide_plain`` and
``maxplus_backtrace_wide_plain``, which their wrappers take for CPU
tensors and ``recursion._viterbi_seq`` runs) path for path against a numpy
decode on the same log inputs, ties, and the routing of
``recursion.viterbi`` (CUDA tensors only take the kernels).

The kernels themselves run on the card: ``tests/test_torch_cuda.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hmm_layer_torch.ops import cuda_viterbi, recursion


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small CPU ops: the test workers
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hmm(seed, m, q, b, L):
    """init (m, q), A (m, q, q) with structural zeros, peaked E (m, b, L, q)."""
    rng = np.random.default_rng(seed)
    A = rng.dirichlet(np.ones(q) * 0.5, size=(m, q))
    A[:, :, q // 3] = 0.0
    A[:, q // 2, :] *= rng.random((m, q)) < 0.1
    A[:, q // 2, q // 2] += 1.0
    A /= A.sum(-1, keepdims=True)
    init = rng.dirichlet(np.ones(q), size=m)
    E = rng.dirichlet(np.ones(q) * 0.3, size=(m, b, L))
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32)) for x in (init, A, E)]


def _log_inputs(init, A, E):
    """log A, log E and delta0 as ``recursion._viterbi_wide_kernels`` makes them."""
    log_A = torch.log(recursion._clamped(A)).contiguous()
    log_E = torch.log(recursion._clamped(E)).contiguous()
    delta0 = (torch.log(recursion._clamped(init))[:, None, :] + log_E[:, :, 0]).contiguous()
    return log_A, log_E, delta0


def _numpy_paths(log_A, log_E, delta0):
    """The textbook float32 Viterbi in numpy: one rounded add a term, an
    exact max, the first index of the max, one rounded add of the
    emission."""
    log_A, log_E, delta = (x.numpy() for x in (log_A, log_E, delta0))
    m, b, L, q = log_E.shape
    back = np.zeros((m, b, max(L - 1, 0), q), np.int64)
    for t in range(1, L):
        terms = delta[..., :, None] + log_A[:, None]  # (m, b, k, j)
        back[:, :, t - 1] = terms.argmax(axis=-2)
        delta = terms.max(axis=-2) + log_E[:, :, t]
    state = delta.argmax(axis=-1)
    path = [state]
    for t in range(L - 2, -1, -1):
        state = np.take_along_axis(back[:, :, t], state[..., None], -1)[..., 0]
        path.append(state)
    return torch.from_numpy(np.stack(path[::-1], axis=-1).astype(np.int32))


def _wide_decode(init, A, E):
    """The kernels' glue on the CPU, where the wrappers run their plain versions."""
    bp, last = cuda_viterbi.maxplus_deltas_wide(*_log_inputs(init, A, E))
    return bp, last, cuda_viterbi.maxplus_backtrace_wide(bp, last)


@pytest.mark.parametrize("L", [1, 2, 37])
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("q", [65, 130, 505])
def test_wide_plain_versions_equal_the_sequential_scan(q, m, L):
    init, A, E = _hmm(q + 10 * m + L, m, q, 2, L)
    cuda_viterbi.reset_launches()
    bp, last, paths = _wide_decode(init, A, E)
    assert cuda_viterbi.LAUNCHES == {name: 0 for name in cuda_viterbi.LAUNCHES}
    assert bp.dtype == torch.uint16 and tuple(bp.shape) == (m, 2, L - 1, q)
    assert last.dtype == torch.float32 and tuple(last.shape) == (m, 2, q)
    assert paths.dtype == torch.int32 and tuple(paths.shape) == (m, 2, L)
    assert torch.equal(paths, _numpy_paths(*_log_inputs(init, A, E)))
    assert torch.equal(paths, recursion._viterbi_seq(init, A, E))


def test_wide_pointers_are_the_lowest_argmax_of_each_step():
    """bp[t - 1, j] is the lowest k maximising delta_{t-1}[k] + log A[k, j],
    with the deltas of the plain loop, and the last delta is its last."""
    init, A, E = _hmm(3, 2, 70, 3, 9)
    log_A, log_E, delta0 = _log_inputs(init, A, E)
    bp, last = cuda_viterbi.maxplus_deltas_wide_plain(log_A, log_E, delta0)
    delta = delta0
    for t in range(1, 9):
        terms = delta[..., :, None] + log_A[:, None]  # (m, b, k, j)
        best = terms.amax(dim=-2)
        lowest = (terms == best[..., None, :]).int().argmax(dim=-2)  # first True
        assert torch.equal(bp[:, :, t - 1].long(), lowest)
        delta = best + log_E[:, :, t]
    assert torch.equal(last, delta)


@pytest.mark.parametrize("q", [65, 505])
def test_wide_ties_take_the_lowest_state(q):
    """Two identical states (rows, columns, start and emissions of state
    k2 copied from k1 < k2) tie at every step, exactly: every pointer and
    the last state take k1, so no path visits k2; and a flat model takes
    state 0 throughout."""
    k1, k2 = 3, q - 2
    init, A, E = _hmm(q, 2, q, 3, 40)
    A[:, k2, :] = A[:, k1, :]
    A[:, :, k2] = A[:, :, k1]
    A /= A.sum(-1, keepdim=True)
    init[:, k2] = init[:, k1]
    E[..., k2] = E[..., k1]
    bp, _, paths = _wide_decode(init, A, E)
    assert not (bp == k2).any()
    assert not (paths == k2).any()
    assert torch.equal(paths, recursion._viterbi_seq(init, A, E))

    flat = torch.full((1, q), 1.0 / q), torch.full((1, q, q), 1.0 / q), torch.full((1, 2, 30, q), 0.5)
    bp, _, paths = _wide_decode(*flat)
    assert (bp == 0).all() and (paths == 0).all()
    assert torch.equal(paths, recursion._viterbi_seq(*flat))


def test_wide_route_predicate():
    """K7c/K8c are taken for CUDA tensors at 64 < q <= MAX_WIDE_Q only."""
    def on(device_is_cuda, q):
        return recursion._use_wide_viterbi_kernels(SimpleNamespace(is_cuda=device_is_cuda, shape=(1, 2, 9, q)))

    assert cuda_viterbi.MAX_WIDE_Q >= 512
    assert on(True, 65) and on(True, 505) and on(True, cuda_viterbi.MAX_WIDE_Q)
    assert not on(True, 64) and not on(True, cuda_viterbi.MAX_WIDE_Q + 1)
    assert not on(False, 130)


@pytest.mark.parametrize("q", [130, cuda_viterbi.MAX_WIDE_Q + 1])
def test_cpu_and_wide_q_route_to_the_sequential_scan(monkeypatch, q):
    """On the CPU, and above MAX_WIDE_Q, ``viterbi`` at P = 1 runs
    ``_viterbi_seq`` and never the wide glue."""
    calls = []
    seq = recursion._viterbi_seq

    def spy(*args):
        calls.append(args[2].shape[-1])
        return seq(*args)

    def refuse(*args):
        raise AssertionError("the wide kernels' glue ran")

    monkeypatch.setattr(recursion, "_viterbi_seq", spy)
    monkeypatch.setattr(recursion, "_viterbi_wide_kernels", refuse)
    init, A, E = _hmm(q, 1, q, 2, 5)
    paths = recursion.viterbi(init, A, E, parallel_factor=1)
    assert calls == [q] and tuple(paths.shape) == (1, 2, 5)


def test_wide_wrappers_refuse_other_devices():
    log_A = torch.zeros((1, 70, 70), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_viterbi.maxplus_deltas_wide(log_A, torch.zeros((1, 2, 5, 70), device="meta"),
                                         torch.zeros((1, 2, 70), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        cuda_viterbi.maxplus_backtrace_wide(torch.zeros((1, 2, 4, 70), dtype=torch.uint16, device="meta"),
                                            torch.zeros((1, 2, 70), device="meta"))
