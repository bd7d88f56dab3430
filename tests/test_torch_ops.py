"""Port ops (hmm_layer_torch.ops) against the JAX package on the same numpy
inputs: semiring primitives, k-mers and the recursions; plus the port's
import and dispatch rules."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hmm_layer_tpu.ops import kmer as jkmer
from hmm_layer_tpu.ops import recursion as jrec
from hmm_layer_tpu.ops import semiring as jsemi
from hmm_layer_torch.ops import kmer, recursion, semiring
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


ROOT = pathlib.Path(__file__).resolve().parent.parent


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


# ---------------------------------------------------------------------------
# semiring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape_x,shape_y", [((5, 7), (7, 3)), ((2, 3, 4, 6), (1, 3, 6, 6))])
def test_logmatmul_matches_jax(shape_x, shape_y):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 30, size=shape_x).astype(np.float32) - 500.0
    y = rng.normal(0, 30, size=shape_y).astype(np.float32) + 200.0
    ref = np.asarray(jsemi.logmatmul(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(semiring.logmatmul(*_t(x, y)).numpy(), ref, rtol=1e-6)


def test_logmatmul_handles_all_minus_inf_rows():
    x = np.array([[-np.inf, -np.inf], [0.0, 1.0]], np.float32)
    y = np.array([[0.0, -1.0], [2.0, -np.inf]], np.float32)
    ref = np.asarray(jsemi.logmatmul(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(semiring.logmatmul(*_t(x, y)).numpy(), ref, rtol=1e-6)


def test_logmatvec_and_log_normalize_match_jax():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(3, 4)).astype(np.float32)
    m = rng.normal(size=(3, 4, 5)).astype(np.float32)
    np.testing.assert_allclose(
        semiring.logmatvec(*_t(v, m)).numpy(),
        np.asarray(jsemi.logmatvec(jnp.asarray(v), jnp.asarray(m))),
        rtol=1e-6,
    )
    for got, ref in zip(semiring.log_normalize(*_t(m)), jsemi.log_normalize(jnp.asarray(m))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    assert semiring.EPS == jsemi.EPS and semiring.LOG_ZERO == jsemi.LOG_ZERO


# ---------------------------------------------------------------------------
# k-mers
# ---------------------------------------------------------------------------


def _nucleotides(rng, shape, soft):
    if soft:
        return rng.dirichlet(np.ones(5), size=shape).astype(np.float32)
    return np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=shape)]


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("pivot_left", [True, False])
@pytest.mark.parametrize("soft", [False, True])
def test_make_k_mers_matches_jax(k, pivot_left, soft):
    seq = _nucleotides(np.random.default_rng(k), (2, 11), soft)
    ref = np.asarray(jkmer.make_k_mers(jnp.asarray(seq), k, pivot_left))
    got_np = kmer.make_k_mers(seq, k, pivot_left)
    got_t = kmer.make_k_mers(torch.from_numpy(seq), k, pivot_left)
    assert isinstance(got_np, np.ndarray)
    np.testing.assert_array_equal(got_np, np.asarray(jkmer.make_k_mers(seq, k, pivot_left)))
    np.testing.assert_array_equal(got_t.numpy(), ref)


@pytest.mark.parametrize("soft", [False, True])
def test_make_k_mers_bf16_matches_jax_exactly(soft):
    seq = _nucleotides(np.random.default_rng(9), (3, 17), soft)
    for pivot_left in (True, False):
        ref = np.asarray(
            jkmer.make_k_mers(jnp.asarray(seq, jnp.bfloat16), 3, pivot_left)
        ).astype(np.float32)
        got = kmer.make_k_mers(torch.from_numpy(seq).to(torch.bfloat16), 3, pivot_left)
        np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("s", ["AAA", "ATG", "TAG", "NGT", "AGN", "ACN", "NNN", "GCTA"])
def test_encode_kmer_string_matches_jax(s):
    for pivot_left in (True, False):
        np.testing.assert_array_equal(
            kmer.encode_kmer_string(s, pivot_left),
            np.asarray(jkmer.encode_kmer_string(s, pivot_left)),
        )


# ---------------------------------------------------------------------------
# recursions
# ---------------------------------------------------------------------------


def _hmm(seed, q=5, L=40, b=2, m=1):
    rng = np.random.default_rng(seed)
    parts = [random_hmm(rng, q, L, b) for _ in range(m)]
    return tuple(np.stack(x) for x in zip(*parts))  # (m, q), (m, q, q), (m, b, L, q)


@pytest.mark.parametrize("P", [1, 4, 8])
def test_forward_backward_match_jax(P):
    init, A, E = _hmm(10, q=6, L=64, b=2, m=2)
    la_j, ll_j = jrec.forward(*map(jnp.asarray, (init, A, E)), parallel_factor=P)
    lb_j = jrec.backward(*map(jnp.asarray, (init, A, E)), parallel_factor=P)
    la_t, ll_t = recursion.forward(*_t(init, A, E), parallel_factor=P)
    lb_t = recursion.backward(*_t(init, A, E), parallel_factor=P)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=2e-4)
    np.testing.assert_allclose(la_t.numpy(), np.asarray(la_j), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(lb_t.numpy(), np.asarray(lb_j), rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("P", [1, 3, 11, 66])
@pytest.mark.parametrize("no_loglik", [False, True])
def test_posterior_and_loglik_match_jax(P, no_loglik):
    # L = 132 is divisible by 3, 11 and 66; P = 66 takes the log-depth
    # prefix-product regime of the boundary combine (P > 64).
    init, A, E = _hmm(11, q=9, L=132, b=2)
    args_j = tuple(map(jnp.asarray, (init, A, E)))
    lg_j, ll_j = jrec.posterior(*args_j, parallel_factor=P, no_loglik=no_loglik)
    lg_t, ll_t = recursion.posterior(*_t(init, A, E), parallel_factor=P, no_loglik=no_loglik)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=2e-4)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=1e-3, atol=2e-3)
    ll_only = recursion.log_likelihood(*_t(init, A, E), parallel_factor=P)
    np.testing.assert_allclose(
        ll_only.numpy(), np.asarray(jrec.log_likelihood(*args_j, parallel_factor=P)), rtol=2e-4
    )


def test_posterior_matches_oracle():
    init, A, E = _hmm(12, q=5, L=30, b=2)
    lg, ll = recursion.posterior(*_t(init, A, E), parallel_factor=5)
    for i in range(2):
        lg_np, ll_np = posterior_np(init[0], A[0], E[0, i])
        np.testing.assert_allclose(lg[0, i].numpy(), lg_np, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(ll[0, i].item(), ll_np, rtol=1e-4)


def test_indivisible_parallel_factor_raises():
    init, A, E = _hmm(13, q=4, L=10, b=1)
    with pytest.raises(ValueError, match="must divide"):
        recursion.posterior(*_t(init, A, E), parallel_factor=3)


def test_plain_path_differentiable_on_cpu():
    init, A, E = _hmm(14, q=5, L=24, b=2)
    E_t = torch.from_numpy(E).requires_grad_()
    ll = recursion.log_likelihood(*_t(init, A), E_t, parallel_factor=4)
    ll.sum().backward()
    g_j = jax.grad(lambda e: jrec.log_likelihood(jnp.asarray(init), jnp.asarray(A), e, 4).sum())(
        jnp.asarray(E)
    )
    scale = np.abs(np.asarray(g_j)).max()
    np.testing.assert_allclose(E_t.grad.numpy() / scale, np.asarray(g_j) / scale, atol=5e-4)


@pytest.mark.parametrize("L", [1, 64, 300, 600, 9999, 10007, 3069])
@pytest.mark.parametrize("q,m,for_viterbi", [(15, 1, False), (33, 1, False), (33, 2, False), (40, 1, True), (8, 1, True)])
def test_recommended_parallel_factor_matches_jax(L, q, m, for_viterbi):
    assert recursion.recommended_parallel_factor(L, q, m, for_viterbi) == (
        jrec.recommended_parallel_factor(L, q, m, for_viterbi)
    )


def test_kernels_only_for_cuda_tensors():
    E = torch.ones((1, 2, 8, 15))
    assert not recursion._use_kernels(E)
    assert not recursion._use_kernels(torch.ones((1, 2, 8, 17), device="meta"))


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------


def test_import_loads_no_jax_and_no_cuda():
    code = (
        "import sys, torch, hmm_layer_torch\n"
        "from hmm_layer_torch import layer, convert, models\n"
        "from hmm_layer_torch.ops import recursion, cuda_forward, _cuda_build\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(m.startswith('hmm_layer_tpu') for m in sys.modules)\n"
        "assert not torch.cuda.is_initialized(), 'CUDA initialised at import'\n"
        "assert not _cuda_build._libs, 'kernels loaded at import'\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert proc.returncode == 0, proc.stderr


def test_port_sources_never_import_jax():
    files = sorted((ROOT / "hmm_layer_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|hmm_layer_tpu)\b"
        r"|import_module\(\s*[\"'](jax|jaxlib|hmm_layer_tpu)\b",
        re.M,
    )
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
