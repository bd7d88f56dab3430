"""The port's spans (``hmm_layer_torch.utils.profiling.span``) on the CPU:
nothing recorded and no profiler call with the profiler off; under
``profiling.trace()`` every stage span of a decode and of a MAP training
step, in the Chrome trace and in ``recorded_spans()`` with its parent;
sessions; a fixed number of spans a batch and a step, whatever the
positions, chunks and windows; and results bit-equal with the profiler on
and off."""

import ctypes.util
import functools
import json

import numpy as np
import pytest
import torch

from hmm_layer_torch import HMMLayer, Trainer, cli, data
from hmm_layer_torch.models import ProfileEmissions, ProfileTransitions
from hmm_layer_torch.ops import _cuda_build, recursion
from hmm_layer_torch.utils import profiling

# Each span of a decode and of a MAP step, with the span that encloses it
# (None: a root). A decode batch records the first group; a reverse strand's
# reverse complement one span.
DECODE_PARENTS = {
    "hmm.predict.windows": None,
    "hmm.predict.upload": "hmm.predict.windows",
    "hmm.predict.decode": None,
    "hmm.layer.viterbi": "hmm.predict.decode",
    "hmm.layer.transitions": "hmm.layer.viterbi",
    "hmm.layer.emissions": "hmm.layer.viterbi",
    "hmm.layer.inputs": "hmm.layer.emissions",
    "hmm.recursion.viterbi": "hmm.layer.viterbi",
    "hmm.recursion.viterbi.summaries": "hmm.recursion.viterbi",
    "hmm.recursion.viterbi.boundaries": "hmm.recursion.viterbi",
    "hmm.recursion.viterbi.paths": "hmm.recursion.viterbi",
    "hmm.predict.stitch": None,
    "hmm.data.revcomp": None,
}
STEP_PARENTS = {
    "hmm.train.step": None,
    "hmm.train.forward": "hmm.train.step",
    "hmm.layer.loss": "hmm.train.forward",
    "hmm.layer.transitions": "hmm.layer.loss",
    "hmm.layer.emissions": "hmm.layer.loss",
    "hmm.layer.inputs": ("hmm.layer.emissions", "hmm.layer.loss"),
    "hmm.recursion.loglik": "hmm.layer.loss",
    "hmm.layer.prior": "hmm.layer.loss",
    "hmm.train.backward": "hmm.train.step",
    "hmm.recursion.loglik_vjp": "hmm.train.backward",  # the CPU's backward runs on the calling thread
    "hmm.recursion.loglik.alphas": ("hmm.recursion.loglik", "hmm.recursion.loglik_vjp"),
    "hmm.recursion.loglik.betas": "hmm.recursion.loglik_vjp",
    "hmm.train.optimizer": "hmm.train.step",
    "hmm.train.log": None,
}
WINDOW, BATCH, OVERLAP = 200, 2, 8


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def contig():
    rng = np.random.default_rng(5)
    L = 700
    enc = data.encode_dna("".join(rng.choice(list("ACGT"), L)))
    cls = rng.dirichlet(np.ones(15), L).astype(np.float32)
    return enc, cls


def _decode(layer, enc, cls, window=WINDOW, strand="-"):
    with torch.inference_mode():
        enc = data.revcomp_onehot(enc) if strand == "-" else enc
        return cli.decode_contig(layer.viterbi, enc, cls, window, BATCH, OVERLAP)


def _profile_layer(L_models=(5, 7)):
    torch.manual_seed(0)
    return HMMLayer(ProfileTransitions(list(L_models)), ProfileEmissions(list(L_models), input_dim=26),
                    use_prior=True, num_seqs=100, device="cpu")


def _batch(L=20, b=3, m=2):
    gen = torch.Generator().manual_seed(1)
    x = torch.nn.functional.one_hot(torch.randint(0, 25, (b, L), generator=gen), 26).float()
    return x[None].expand(m, b, L, 26)


def _fit(layer, batches):
    trainer = Trainer(layer, optimizer=functools.partial(torch.optim.Adam, lr=0.05))
    return trainer.fit(batches)


def _annotations(log_dir):
    with open(log_dir / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation" and e["name"].startswith("hmm.")]


def _off_span():
    """A span opened with the profiler off: it ends the profiler session."""
    with profiling.span("hmm.test"):
        pass


def _check_parents(records, expected):
    for r in records:
        parent = None if r.parent is None else records[r.parent].name
        want = expected[r.name]
        assert parent in (want if isinstance(want, tuple) else (want,)), (r.name, parent)
        assert r.start_ns <= r.end_ns


def test_off_records_nothing_and_calls_no_profiler(contig, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)  # the name span enters
    profiling.clear_spans()
    assert profiling.span("hmm.a") is profiling.span("hmm.a")  # shared
    with profiling.span("hmm.a"):
        pass
    _decode(cli._gene_pred_layer(4, "cpu"), *contig)
    _fit(_profile_layer(), [_batch()])
    assert profiling.recorded_spans() == []


@pytest.mark.parametrize("strand", ["+", "-"])
def test_decode_spans_in_the_trace_and_the_records(contig, tmp_path, strand):
    layer = cli._gene_pred_layer(4, "cpu")
    _off_span()
    with profiling.trace(str(tmp_path)):
        _decode(layer, *contig, strand=strand)
    records = profiling.recorded_spans()
    names = set(DECODE_PARENTS) - ({"hmm.data.revcomp"} if strand == "+" else set())
    assert {r.name for r in records} == names
    assert set(_annotations(tmp_path)) == names
    assert sorted(_annotations(tmp_path)) == sorted(r.name for r in records)
    _check_parents(records, DECODE_PARENTS)


def test_map_step_spans_in_the_trace_and_the_records(tmp_path):
    layer = _profile_layer()
    _off_span()
    with profiling.trace(str(tmp_path)):
        _fit(layer, [_batch()])
    records = profiling.recorded_spans()
    assert {r.name for r in records} == set(STEP_PARENTS)
    assert sorted(_annotations(tmp_path)) == sorted(r.name for r in records)
    _check_parents(records, STEP_PARENTS)


def test_posterior_and_its_vjp_spans(tmp_path):
    rng = np.random.default_rng(2)
    init = torch.tensor(rng.dirichlet(np.ones(4), 1), dtype=torch.float32, requires_grad=True)
    A = torch.tensor(rng.dirichlet(np.ones(4), (1, 4)), dtype=torch.float32)
    E = torch.tensor(rng.uniform(0.1, 1.0, (1, 2, 12, 4)), dtype=torch.float32)
    _off_span()
    with profiling.trace(str(tmp_path)):
        log_gamma, _ = recursion.posterior(init, A, E, 4)
        log_gamma.sum().backward()
    names = [r.name for r in profiling.recorded_spans()]
    assert names == ["hmm.recursion.posterior", "hmm.recursion.posterior_vjp"]
    assert sorted(_annotations(tmp_path)) == sorted(names)


def test_cuda_load_spans_the_build_and_not_the_cached_lookup(monkeypatch, tmp_path):
    libc = ctypes.util.find_library("c")
    monkeypatch.setattr(_cuda_build, "_libs", {})
    monkeypatch.setattr(_cuda_build, "build", lambda name: libc)
    monkeypatch.setitem(_cuda_build.SIGNATURES, "libc", {"abs": [ctypes.c_int]})
    _off_span()
    with profiling.trace(str(tmp_path)):
        lib = _cuda_build.load("libc")
        assert _cuda_build.load("libc") is lib
    assert [r.name for r in profiling.recorded_spans()] == ["hmm.cuda.load"]
    assert lib.abs(-3) == 3


def test_a_new_session_clears_the_old_records(contig):
    layer = cli._gene_pred_layer(4, "cpu")
    _off_span()
    with torch.profiler.profile():
        _decode(layer, *contig)
    first = profiling.recorded_spans()
    with torch.profiler.profile():  # no span between the sessions: they merge
        with profiling.span("hmm.test"):
            pass
    assert profiling.recorded_spans()[: len(first)] == first
    _off_span()
    with torch.profiler.profile():
        with profiling.span("hmm.test"):
            pass
    assert [r.name for r in profiling.recorded_spans()] == ["hmm.test"]
    profiling.clear_spans()
    assert profiling.recorded_spans() == []


def _spans_a_batch(layer, enc, cls, window):
    _off_span()
    with torch.profiler.profile():
        _decode(layer, enc, cls, window)
    records = profiling.recorded_spans()
    batches = sum(r.name == "hmm.predict.decode" for r in records)
    assert batches >= 2
    # Less the strand's reverse complement.
    return (len(records) - 1) / batches


def test_spans_a_batch_and_a_step_stay_few_and_fixed(contig):
    enc, cls = contig
    counts = {_spans_a_batch(cli._gene_pred_layer(P, "cpu"), enc, cls, w) for P, w in ((4, 200), (5, 300), (10, 300))}
    assert len(counts) == 1 and counts.pop() <= 16
    steps = []
    for L in (12, 30):
        layer = _profile_layer()
        _off_span()
        with torch.profiler.profile():
            _fit(layer, [_batch(L), _batch(L)])
        records = profiling.recorded_spans()
        assert sum(r.name == "hmm.train.step" for r in records) == 2
        steps.append(len(records))
    assert steps[0] == steps[1] <= 2 * 24


def test_results_bit_equal_with_the_profiler_on_and_off(contig):
    layer = cli._gene_pred_layer(4, "cpu")
    off = _decode(layer, *contig)
    with torch.profiler.profile():
        on = _decode(layer, *contig)
    np.testing.assert_array_equal(on, off)
    layer_off, layer_on = _profile_layer(), _profile_layer()
    loss_off = _fit(layer_off, [_batch(), _batch(25)])
    with torch.profiler.profile():
        loss_on = _fit(layer_on, [_batch(), _batch(25)])
    assert torch.equal(loss_on, loss_off)
    for (name, p_on), p_off in zip(layer_on.named_parameters(), layer_off.parameters()):
        assert torch.equal(p_on, p_off), name
