"""The sequential log-likelihood at 64 < q <= 704: K2c and K3c
(``cuda_forward.sum_forward_wide`` and ``sum_backward_wide``) and their
plain versions.

On the CPU: the plain versions bit-equal to the loops that
``recursion._forward_seq`` and ``_backward_seq`` ran before they moved
there; the gate of ``recursion._LoglikSeq`` (CUDA float32 at
64 < q <= 704 takes the kernels, everything else the plain loop), the
passes it asks for (the log-likelihood alone forward, log alpha and log
beta in the VJP), and the wrappers' refusals.

On the card (``gpu``): the kernels against the plain versions, the
kernel route's log-likelihood and gradients against float64, and the
launches of one loss and backward. The file imports no JAX:
``python -m pytest --noconftest -q tests/test_torch_loglik_wide.py``.
"""

import math
import statistics
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hmm_layer_torch import HMMLayer
from hmm_layer_torch.ops import cuda_forward, recursion
from hmm_layer_torch.ops.semiring import EPS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small CPU ops: the test workers
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hmm(seed, m, q, b, L, device="cpu"):
    """init (m, q), A (m, q, q) with a dead column and a sparse row,
    E (m, b, L, q) in [0.05, 1) with a state that never emits."""
    rng = np.random.default_rng(seed)
    A = rng.dirichlet(np.ones(q) * 0.5, size=(m, q))
    A[:, :, q // 3] = 0.0
    A[:, q // 2, :] *= rng.random((m, q)) < 0.1
    A[:, q // 2, q // 2] += 1.0
    A /= A.sum(-1, keepdims=True)
    init = rng.dirichlet(np.ones(q), size=m)
    E = rng.uniform(0.05, 1.0, size=(m, b, L, q))
    E[..., q - 1] = 0.0
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device) for x in (init, A, E)]


def _clamped(x):
    return torch.clamp_min(x, EPS)


def _forward_loop(init, A, E):
    """``recursion._forward_seq`` as it was before its loop moved into
    ``cuda_forward.sum_forward_wide_plain``."""
    L = E.shape[2]
    s = _clamped(E[:, :, 0]) * _clamped(init)[:, None, :]
    z = s.sum(-1, keepdim=True)
    alpha, ll = s / z, torch.log(z[..., 0])
    outs = [torch.log(alpha) + ll[..., None]]
    for t in range(1, L):
        s = _clamped(E[:, :, t]) * _clamped(torch.matmul(alpha, A))
        z = s.sum(-1, keepdim=True)
        alpha, ll = s / z, ll + torch.log(z[..., 0])
        outs.append(torch.log(alpha) + ll[..., None])
    return torch.stack(outs, dim=2), ll


def _backward_loop(A, E):
    """``recursion._backward_seq`` as it was before its loop moved into
    ``cuda_forward.sum_backward_wide_plain``."""
    m, b, L, q = E.shape
    beta = torch.ones((m, b, q), dtype=E.dtype, device=E.device)
    ll = torch.zeros((m, b), dtype=E.dtype, device=E.device)
    A_T = A.transpose(-1, -2)
    outs = [torch.zeros_like(beta)]
    for t in range(L - 1, 0, -1):
        s = _clamped(torch.matmul(_clamped(E[:, :, t]) * beta, A_T))
        z = s.amax(-1, keepdim=True)
        beta, ll = s / z, ll + torch.log(z[..., 0])
        outs.append(torch.log(beta) + ll[..., None])
    return torch.stack(outs[::-1], dim=2)


# ---------------------------------------------------------------------------
# The CPU: plain versions, the gate, the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q,m,b,L", [(65, 2, 3, 17), (155, 1, 2, 9), (512, 1, 1, 4), (647, 1, 2, 3)])
def test_plain_passes_bit_equal_the_loops_they_replace(q, m, b, L):
    init, A, E = _hmm(q + L, m, q, b, L)
    la, ll = _forward_loop(init, A, E)
    la_p, ll_p = cuda_forward.sum_forward_wide_plain(init, A, E, True)
    none, ll_only = cuda_forward.sum_forward_wide_plain(init, A, E, False)
    assert torch.equal(la_p, la) and torch.equal(ll_p, ll)
    assert none is None and torch.equal(ll_only, ll)
    assert torch.equal(cuda_forward.sum_backward_wide_plain(A, E), _backward_loop(A, E))
    # The public passes and the wrappers on CPU tensors are the plain loops.
    assert all(torch.equal(x, y) for x, y in zip(recursion.forward(init, A, E), (la, ll)))
    assert torch.equal(recursion.backward(init, A, E), _backward_loop(A, E))
    assert torch.equal(cuda_forward.sum_forward_wide(init, A, E, False)[1], ll)
    assert torch.equal(cuda_forward.sum_backward_wide(A, E), _backward_loop(A, E))
    assert torch.equal(recursion.log_likelihood(init, A, E), ll)
    assert not any(cuda_forward.LAUNCHES[k] for k in ("sum_forward_wide", "sum_backward_wide"))


def test_wide_loglik_gate():
    """CUDA float32 at 64 < q <= 704 takes K2c and K3c (shared memory's cut
    to 512, the register cut above); other q, other types and CPU tensors
    the plain loop."""
    def on(is_cuda, q, dtype=torch.float32):
        return recursion._use_wide_loglik_kernels(SimpleNamespace(is_cuda=is_cuda, dtype=dtype, shape=(5, 64, 400, q)))

    assert (cuda_forward.MIN_WIDE_Q, cuda_forward.MAX_WIDE_Q) == (65, 704)
    assert on(True, 65) and on(True, 155) and on(True, 505) and on(True, 512)
    assert on(True, 513) and on(True, 639) and on(True, 647) and on(True, 704)
    assert not on(True, 64) and not on(True, 15) and not on(True, 705)
    assert not on(False, 155) and not on(True, 155, torch.float64) and not on(True, 155, torch.bfloat16)
    assert not on(False, 647) and not on(True, 647, torch.float64)


def _refuse(*args, **kwargs):
    raise AssertionError("a kernel wrapper ran")


@pytest.mark.parametrize("q", [40, 155, 513, 647, 705])
def test_cpu_tensors_take_the_plain_loop(monkeypatch, q):
    """On the CPU, at every q, the log-likelihood and its VJP run the plain
    loops and never a kernel wrapper."""
    monkeypatch.setattr(cuda_forward, "sum_forward_wide", _refuse)
    monkeypatch.setattr(cuda_forward, "sum_backward_wide", _refuse)
    init, A, E = _hmm(q, 1, q, 2, 5)
    A.requires_grad_()
    ll = recursion.log_likelihood(init, A, E)
    (g,) = torch.autograd.grad(ll.sum(), A)
    assert tuple(ll.shape) == (1, 2) and bool(torch.isfinite(g).all())


def test_loglik_asks_the_gated_passes_for_what_it_needs(monkeypatch):
    """Where the gate opens, the forward runs K2c for the log-likelihood
    alone and the VJP reruns it with log alpha, then K3c once; the result
    is the plain route's (here the spies run the plain versions)."""
    init, A, E = _hmm(7, 2, 70, 3, 11)
    for x in (init, A, E):
        x.requires_grad_()
    ll = recursion.log_likelihood(init, A, E)
    plain = [ll, *torch.autograd.grad((ll * torch.arange(1.0, 4.0)).sum(), (init, A, E))]

    calls = []

    def fwd(init_, A_, E_, write_alpha):
        calls.append(("K2c", write_alpha, E_.is_contiguous()))
        return cuda_forward.sum_forward_wide_plain(init_, A_, E_, write_alpha)

    def bwd(A_, E_):
        calls.append(("K3c", E_.is_contiguous()))
        return cuda_forward.sum_backward_wide_plain(A_, E_)

    monkeypatch.setattr(recursion, "_use_wide_loglik_kernels", lambda E: True)
    monkeypatch.setattr(cuda_forward, "sum_forward_wide", fwd)
    monkeypatch.setattr(cuda_forward, "sum_backward_wide", bwd)
    ll = recursion.log_likelihood(init, A, E)
    assert calls == [("K2c", False, True)]
    gated = [ll, *torch.autograd.grad((ll * torch.arange(1.0, 4.0)).sum(), (init, A, E))]
    assert calls == [("K2c", False, True), ("K2c", True, True), ("K3c", True)]
    assert all(torch.equal(x, y) for x, y in zip(gated, plain))
    # Non-contiguous emissions reach the passes contiguous.
    calls.clear()
    recursion.log_likelihood(init, A, E.detach().transpose(1, 2).contiguous().transpose(1, 2))
    assert calls == [("K2c", False, True)]


def test_wide_wrappers_refuse_what_they_cannot_take():
    """Shape, type and contiguity checks before the device's: meta tensors
    reach every check without a card."""
    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    init, A, E = t(2, 70), t(2, 70, 70), t(2, 3, 9, 70)
    fwd, bwd = cuda_forward.sum_forward_wide, cuda_forward.sum_backward_wide
    for q in (64, 705):
        with pytest.raises(ValueError, match="64 < q <= 704"):
            fwd(t(2, q), t(2, q, q), t(2, 3, 9, q), False)
        with pytest.raises(ValueError, match="64 < q <= 704"):
            bwd(t(2, q, q), t(2, 3, 9, q))
    # Past the old bound the checks reach the device's: a meta tensor has no kernel.
    for q in (513, 647, 704):
        with pytest.raises(ValueError, match="no kernel"):
            fwd(t(2, q), t(2, q, q), t(2, 3, 9, q), False)
        with pytest.raises(ValueError, match="no kernel"):
            bwd(t(2, q, q), t(2, 3, 9, q))
    with pytest.raises(ValueError, match=r"E must be \(m, b, L, q\)"):
        bwd(A, t(3, 9, 70))
    with pytest.raises(ValueError, match="A has shape"):
        fwd(init, t(1, 70, 70), E, True)
    with pytest.raises(ValueError, match="A has shape"):
        bwd(t(2, 70, 69), E)
    with pytest.raises(ValueError, match="init has shape"):
        fwd(t(2, 69), A, E, False)
    with pytest.raises(ValueError, match="empty input"):
        bwd(A, t(2, 3, 0, 70))
    with pytest.raises(TypeError, match="must be float32"):
        fwd(init, A, E.double(), False)
    with pytest.raises(TypeError, match="must be float32"):
        bwd(A.double(), E)
    with pytest.raises(ValueError, match="must be contiguous"):
        fwd(init, A, t(2, 9, 3, 70).transpose(1, 2), False)
    with pytest.raises(ValueError, match="must be contiguous"):
        bwd(A.transpose(1, 2), E)
    with pytest.raises(ValueError, match="is on cpu"):
        fwd(torch.zeros(2, 70), A, E, True)
    with pytest.raises(ValueError, match="no kernel"):
        fwd(init, A, E, True)
    with pytest.raises(ValueError, match="no kernel"):
        bwd(A, E)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _f32_log_bound(ll, steps):
    """8 standard deviations of ``steps`` float32 roundings (half a spacing
    at |loglik|): two float32 accumulations of ~equal terms may round apart
    at each add."""
    spacing = 2.0 ** (math.floor(math.log2(max(float(ll.abs().max()), 1.0))) - 23)
    return 8.0 * spacing * math.sqrt(2 * steps / 12)


# log alpha and log beta are a log-scale (ll's rounding, above) plus the log
# of a normalised carry. The carry's own float32 rounding, a few ulps of
# relative error that the filter forgets rather than compounds, is under
# 1e-4 in its log, the clamped floor (log EPS^2 ~ -74) included.
LOG_CARRY_ATOL = 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 2, 400])
@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("q", [65, 123, 155, 256, 505, 512, 513, 639, 647, 704])
def test_wide_sum_kernels_match_plain(cuda, q, m, b, L):
    """K2c's log-likelihood and log alpha and K3c's log beta against their
    plain versions on the card: q at the kernel's cuts (one block to
    q = 160, clusters of 2 at 256, of 8 at 505 and 512; above, the register
    cut: clusters of 6 at 513, of 7 at 639 and 647, of 8 at 704), b around
    its groups of 4 sequences, L = 1 and 2 and the profile cells'."""
    init, A, E = _hmm(q * L + 7 * b + m, m, q, b, L, cuda)
    cuda_forward.reset_launches()
    la, ll = cuda_forward.sum_forward_wide(init, A, E, True)
    none, ll_only = cuda_forward.sum_forward_wide(init, A, E, False)
    lb = cuda_forward.sum_backward_wide(A, E)
    torch.cuda.synchronize()
    assert cuda_forward.LAUNCHES["sum_forward_wide"] == 2 and cuda_forward.LAUNCHES["sum_backward_wide"] == 1
    la_p, ll_p = cuda_forward.sum_forward_wide_plain(init, A, E, True)
    lb_p = cuda_forward.sum_backward_wide_plain(A, E)
    assert none is None and torch.equal(ll_only, ll)
    assert la.shape == la_p.shape and lb.shape == lb_p.shape and ll.shape == ll_p.shape
    bound = _f32_log_bound(ll_p, L)
    torch.testing.assert_close(ll, ll_p, rtol=0, atol=bound)
    torch.testing.assert_close(la, la_p, rtol=0, atol=bound + LOG_CARRY_ATOL)
    torch.testing.assert_close(lb, lb_p, rtol=0, atol=bound + LOG_CARRY_ATOL)
    if L == 1:
        assert torch.equal(lb, torch.zeros_like(lb))


def _ll_and_grads(init, A, E, W):
    xs = [x.detach().clone().requires_grad_() for x in (init, A, E)]
    ll = recursion.log_likelihood(*xs)
    return [ll.detach(), *torch.autograd.grad((ll * W).sum(), xs)]


@pytest.mark.gpu
@pytest.mark.parametrize("q,L", [(123, 400), (155, 100), (505, 60), (647, 60)])
def test_wide_kernel_route_no_farther_from_float64(cuda, monkeypatch, q, L):
    """The kernel route's log-likelihood and gradients are as close to
    float64 as the plain loop's on the card: within twice its error (two
    float32 evaluations of the same sums in other orders err alike) plus
    the log-scale's rounding (ll) or 1e-5 of the gradient's largest
    entry."""
    init, A, E = _hmm(q + L, 2, q, 4, L, cuda)
    W = torch.linspace(0.5, 1.5, 8, device=cuda).reshape(2, 4)
    cuda_forward.reset_launches()
    kern = _ll_and_grads(init, A, E, W)
    assert cuda_forward.LAUNCHES["sum_forward_wide"] == 2 and cuda_forward.LAUNCHES["sum_backward_wide"] == 1
    ref = _ll_and_grads(init.double(), A.double(), E.double(), W.double())
    monkeypatch.setattr(recursion, "_use_wide_loglik_kernels", lambda E: False)
    plain = _ll_and_grads(init, A, E, W)
    assert cuda_forward.LAUNCHES["sum_forward_wide"] == 2
    for i, (k, p, r) in enumerate(zip(kern, plain, ref)):
        scale = 1.0 if i == 0 else float(r.abs().max())
        err_k = float((k.double() - r).abs().max()) / scale
        err_p = float((p.double() - r).abs().max()) / scale
        slack = _f32_log_bound(ref[0], L) if i == 0 else 1e-5
        assert err_k <= 2 * err_p + slack, (i, err_k, err_p)


@pytest.mark.gpu
@pytest.mark.parametrize("lengths,atol", [([60, 76], 1e-4), ([318, 322], None)])
def test_profile_loss_and_backward_launch_two_k2c_one_k3c(cuda, monkeypatch, lengths, atol):
    """A profile layer's MAP loss (q = 123 and 155, padded to 155; q = 639
    and 647, padded to 647) and its backward: K2c for the loss, K2c again
    and K3c once in the VJP, no plain loop, and gradients within the
    layer's float32 noise of the plain route's. The leaves are pushed back
    from the passes' VJP of the loss's own (init, A, E) and cotangent and
    held to the float64 VJP's leaves. The kernels' worst and median leaf
    (a leaf's largest gap over its largest entry: what the benchmark reads
    of a training step's gradient) are no farther than twice the plain
    route's, plus 1e-5. Each one-entry leaf (a flank or segment's loop and
    exit logits, the flank's start) is also held alone: its gap no more
    than twice the plain route's plus 1e-5 of the terms it sums (the
    double VJP's column of the leaf times the float64 cotangents). The
    flanks' shared loop and exit and the segment's are differences of
    terms up to ~210 times larger than themselves and keep their float32
    rounding, so over a leaf's own size the two float32 routes' gaps differ
    by up to 5x there, as the plain route's on the card and on the CPU
    differ by up to 6.5x on a leaf. At q = 155 the whole
    gradients also agree within ``atol`` of their largest entry; at
    q = 647 the leaves' float32 noise is larger than that on either route
    (the plain route on the card and on the CPU differ by up to 5e-4
    there)."""
    from hmm_layer_torch.models import ProfileEmissions, ProfileTransitions

    layer = HMMLayer(ProfileTransitions(lengths, generator=torch.Generator().manual_seed(0)),
                     ProfileEmissions(lengths, input_dim=26), use_prior=True, num_seqs=1000,
                     parallel_factor="auto", device=cuda)
    rng = np.random.default_rng(3)
    x = np.eye(26, dtype=np.float32)[rng.integers(0, 25, size=(8, 120))]
    X = torch.from_numpy(x).to(cuda)[None].expand(2, 8, 120, 26)
    pars = [p for p in layer.parameters() if p.requires_grad]
    seen = {}
    seq_passes, bw_stats = recursion._seq_passes, recursion._loglik_bw_stats

    def passes(init, A, E):
        seen.setdefault("inputs", (init, A, E))
        return seq_passes(init, A, E)

    def stats(init, A, E, la, lb, ll, ct):
        seen["ct"] = ct.detach()
        return bw_stats(init, A, E, la, lb, ll, ct)

    cuda_forward.reset_launches()
    with monkeypatch.context() as mp:
        mp.setattr(cuda_forward, "sum_forward_wide_plain", _refuse)
        mp.setattr(cuda_forward, "sum_backward_wide_plain", _refuse)
        mp.setattr(recursion, "_seq_passes", passes)
        mp.setattr(recursion, "_loglik_bw_stats", stats)
        grads = torch.autograd.grad(layer.loss(X), pars, retain_graph=True)
    torch.cuda.synchronize()
    assert cuda_forward.LAUNCHES == {"sum_chunk_summaries": 0, "sum_fwd_outputs": 0, "beta_bwd_outputs": 0,
                                     "sum_forward_wide": 2, "sum_backward_wide": 1}
    inputs, ct = seen["inputs"], seen["ct"]

    def leaves(dtype):
        vjp = _ll_and_grads(*(x.detach().to(dtype) for x in inputs), ct.to(dtype))[1:]
        return torch.autograd.grad(inputs, pars, grad_outputs=[g.float() for g in vjp], retain_graph=True)

    kern = leaves(torch.float32)
    ref = leaves(torch.float64)
    g64 = _ll_and_grads(*(x.detach().double() for x in inputs), ct.double())[1:]
    with monkeypatch.context() as mp:
        mp.setattr(recursion, "_use_wide_loglik_kernels", lambda E: False)
        plain = leaves(torch.float32)
        plain_grads = torch.autograd.grad(layer.loss(X), pars) if atol is not None else None
    errs = []
    for leaf, k, p, r in zip(pars, kern, plain, ref):
        scale = float(r.abs().max()) or 1.0
        gap_k, gap_p = float((k - r).abs().max()), float((p - r).abs().max())
        errs.append((gap_k / scale, gap_p / scale))
        if r.numel() == 1:
            us = [torch.zeros_like(x, requires_grad=True) for x in inputs]
            (col,) = torch.autograd.grad(inputs, leaf, grad_outputs=us, create_graph=True, retain_graph=True)
            column = torch.autograd.grad(col.sum(), us, allow_unused=True, retain_graph=True)
            terms = sum(float((g * c.double()).abs().sum()) for g, c in zip(g64, column) if c is not None)
            assert gap_k <= 2 * gap_p + 1e-5 * terms, (len(errs) - 1, gap_k, gap_p, terms)
    err_k, err_p = zip(*errs)
    assert max(err_k) <= 2 * max(err_p) + 1e-5, errs
    assert statistics.median(err_k) <= 2 * statistics.median(err_p) + 1e-5, errs
    if atol is not None:
        for a, b in zip(grads, plain_grads):
            scale = float(b.abs().max()) or 1.0
            np.testing.assert_allclose(a.cpu().numpy() / scale, b.cpu().numpy() / scale, atol=atol)
