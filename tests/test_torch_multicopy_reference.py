"""The multi-copy gene HMM (q = 1 + 14k) of the port against the
benchmark's plain float64 reference (``portbench/reference/
genepred_multicopy.py``, written from Tiberius's definition) on seeded
weights, at k = 2 and at config 5's k = 36: the edge list and the dense
``(init, A)``, the emissions, the decoded path's score against the
reference optimum, and a short contig through ``cli.decode_contig``. And
the sequential decode's spans: ``hmm.recursion.viterbi.deltas`` and
``.backtrace`` once each a call, under ``.paths``, with the paths
bit-equal with the profiler on and off.

Tolerances: the port computes in float32 and the reference in float64, so
the matrices agree to float32's rounding of a softmax (rtol 1e-6), the
emissions to a few roundings of a 15-term contraction and a product
(rtol 1e-5), and a decoded path scores within 1e-6 of the optimum relative
to the optimum's |score| (the engines' tie parity, ``recursion.viterbi``'s
docstring: ~1e-7).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hmm_layer_torch import cli
from hmm_layer_torch.models import GenePredMultiTransitions
from hmm_layer_torch.utils import profiling
from portbench.models import genepred_multicopy as fam
from portbench.reference import genepred_multicopy as ref
from portbench.reference import hmm

ROOT = Path(__file__).resolve().parent.parent
SEED = 2**31 + 23
CASES = [(2, 2, 300), (36, 1, 60)]  # (k, b, L)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(k):
    """The benchmark's configuration of config 5 with ``k`` copies."""
    cfg = json.loads((ROOT / "portbench" / "configs" / "tiberius-multicopy-q505.json").read_text())
    cfg["model"]["copies"] = k
    return cfg


def _setup(k):
    """The seeded weights, the port's layer on them, and the reference's
    float64 parameters."""
    cfg = _cfg(k)
    params = fam.make_params(cfg, SEED + k, "cpu")
    layer = fam.build_program(cfg, params, "cpu")
    return cfg, layer, {n: v.double() for n, v in params.items()}


def _inputs(b, L, seed=7):
    """(b, L, 20): Dirichlet(1) class probabilities, one-hot ACGT."""
    rng = np.random.default_rng(seed)
    cls = rng.dirichlet(np.ones(15), size=(b, L))
    nuc = np.eye(5)[rng.integers(0, 4, size=(b, L))]
    return np.concatenate([cls, nuc], -1).astype(np.float32)


@pytest.mark.parametrize("k,b,L", CASES)
def test_edges_and_dense_matrices_match_the_reference(k, b, L):
    _, layer, p64 = _setup(k)
    assert layer.transitions.num_states == ref.num_states(k)
    np.testing.assert_array_equal(layer.transitions.indices, ref.edges(k))
    assert len(ref.edges(k)) == 1 + 22 * k and len({tuple(e) for e in ref.edges(k)}) == 1 + 22 * k
    if k == 36:
        assert len(ref.edges(k)) == 793
    base = GenePredMultiTransitions(k=k, init_component_sd=0.0).make_transition_init()  # no noise
    np.testing.assert_allclose(base, ref.base_transition_logits(k), rtol=1e-6)
    with torch.no_grad():
        init, A = layer.transitions.matrices()
    init_r, A_r = ref.matrices(p64, k)
    np.testing.assert_allclose(init[0].double().numpy(), init_r.numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(A[0].double().numpy(), A_r.numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("k,b,L", CASES)
def test_emissions_match_the_reference(k, b, L):
    cfg, layer, p64 = _setup(k)
    x = _inputs(b, L)
    with torch.no_grad():
        E = layer.emission_probs(x[None])[0].double().numpy()
    E_r = ref.emissions(p64, torch.as_tensor(x, dtype=torch.float64), fam.codons(cfg), k).numpy()
    assert E.shape == (b, L, ref.num_states(k))
    np.testing.assert_allclose(E, E_r, rtol=1e-5, atol=0)


@pytest.mark.parametrize("k,b,L", CASES)
def test_decoded_path_scores_the_reference_optimum(k, b, L):
    cfg, layer, p64 = _setup(k)
    x = _inputs(b, L, seed=11)
    with torch.inference_mode():
        paths = layer.viterbi(x[None])[0].long()
    init, A = ref.matrices(p64, k)
    E = ref.emissions(p64, torch.as_tensor(x, dtype=torch.float64), fam.codons(cfg), k)
    best = hmm.viterbi_score(init, A, E)
    got = hmm.path_score(init, A, E, paths)
    assert torch.all(got <= best + 1e-9 * best.abs())
    assert torch.all(best - got <= 1e-6 * best.abs()), (best, got)


def test_a_short_contig_through_decode_contig():
    """Each window's kept positions: the port's own decode of that window,
    and within 1e-6 of the reference's optimum where they are pinned."""
    k, window, batch, overlap, n = 2, 200, 2, 16, 900
    cfg, layer, p64 = _setup(k)
    x = _inputs(1, n, seed=13)[0]
    with torch.inference_mode():
        track = cli.decode_contig(layer.viterbi, x[:, 15:], x[:, :15], window, batch, overlap, device="cpu")
    assert track.shape == (n,)
    init, A = ref.matrices(p64, k)
    stride = window - overlap
    starts = list(range(0, n - overlap, stride))
    assert len(starts) > batch  # two batches, the second with a fill window
    q = ref.num_states(k)
    for st in starts:
        end, lo = min(st + window, n), (st + overlap if st > 0 else st)
        win = np.zeros((window, 20), np.float32)
        win[:, :15] = 1.0 / 15.0
        win[: end - st] = x[st:end]
        with torch.inference_mode():
            own = layer.viterbi(win[None, None])[0, 0].numpy()
        np.testing.assert_array_equal(track[lo:end], own[lo - st : end - st])
        E = ref.emissions(p64, torch.as_tensor(win[None], dtype=torch.float64), fam.codons(cfg), k)
        allowed = torch.ones((1, window, q), dtype=torch.bool)
        allowed[0, lo - st : end - st] = False
        allowed[0, torch.arange(lo - st, end - st), torch.as_tensor(track[lo:end]).long()] = True
        best, pinned = hmm.viterbi_score(init, A, E), hmm.viterbi_score(init, A, E, allowed)
        assert float(best - pinned) <= 1e-6 * float(best.abs()), st


def test_the_sequential_decode_opens_its_two_spans_once_a_call():
    _, layer, _ = _setup(36)
    x = _inputs(2, 40, seed=17)[None]
    with torch.inference_mode():
        off = layer.viterbi(x)
    with profiling.span("hmm.test"):  # opened with the profiler off: ends the older session
        pass
    with torch.profiler.profile(), torch.inference_mode():
        on = [layer.viterbi(x) for _ in range(2)]
    records = profiling.recorded_spans()
    names = [r.name for r in records]
    for name in ("hmm.recursion.viterbi.paths", "hmm.recursion.viterbi.deltas", "hmm.recursion.viterbi.backtrace"):
        assert names.count(name) == 2, (name, names)
    for r in records:
        if r.name in ("hmm.recursion.viterbi.deltas", "hmm.recursion.viterbi.backtrace"):
            assert records[r.parent].name == "hmm.recursion.viterbi.paths"
    deltas = [r for r in records if r.name.endswith(".deltas")]
    walks = [r for r in records if r.name.endswith(".backtrace")]
    assert all(d.end_ns <= w.start_ns for d, w in zip(deltas, walks))
    for paths in on:
        assert torch.equal(paths, off)
