"""The per-layer metrics that read the port's own spans: finite on the
tiny CPU ``--trace 1`` runs, their own time (on made-up records and on a
real decode's), and nothing where the window opened no span of the name."""

import json
import math

import numpy as np
import pytest
import torch

from hmm_layer_torch import cli, data
from hmm_layer_torch.utils import profiling
from portbench import run, spans

# The tiny cells of test_portbench_run.py, with two traced strands.
SMALL = {
    "profile-m5-train": {"config": {"shape": {"batch": 3, "length": 30}, "model": {"lengths": [5, 7]}},
                         "traffic": {"pool": 4, "trace_steps": 1}},
    "genepred-q15-predict": {"config": {"model": {"parallel_factor": 4}},
                             "traffic": {"contigs": 3, "min_bp": 6000, "max_bp": 15000, "window": 3000, "overlap": 16,
                                         "batch": 3, "trace_strands": 2, "check_block": 16}},
}
SEED = 2**31 + 11
MANIFEST = json.loads((run.ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = {
    m["name"]: m["workloads"] for m in MANIFEST["per_layer"] if m["source"] == "program_span"
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_six_span_metrics_in_the_manifest():
    assert sorted(SPAN_METRICS) == sorted([
        "windows_ms_per_batch.predict", "stitch_ms_per_batch.predict", "input_copy_ms_per_batch.predict",
        "forward_ms_per_step.train", "backward_ms_per_step.train", "optimizer_ms_per_step.train",
    ])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_span_metrics_finite_on_a_traced_run(cell, capsys):
    profiling.clear_spans()
    argv = ["--workload", cell, "--seed", str(SEED), "--seconds", "0.3", "--trace", "1"]
    assert run.main(argv, device="cpu", overrides=SMALL[cell]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["metrics"]
    mine = [name for name, cells in SPAN_METRICS.items() if cell in cells]
    assert len(mine) == 3
    for name in mine:
        value = metrics[name]["value"]
        assert math.isfinite(value) and value > 0, name


def _record(name, start, end, parent=None):
    return profiling.SpanRecord(name, start, end, parent)


def test_own_time_is_the_duration_less_the_childrens_union():
    records = [
        _record("a", 0, 100),
        _record("b", 10, 40, 0), _record("b", 30, 50, 0),  # overlapping children: union 10..50
        _record("c", 60, 70, 0),
        _record("d", 65, 68, 3),  # a grandchild counts only against its parent
    ]
    own = spans.seconds(records, own=True)
    assert own["a"] == pytest.approx((100 - 40 - 10) * 1e-9)
    assert own["b"] == pytest.approx(50e-9) and own["c"] == pytest.approx(7e-9) and own["d"] == pytest.approx(3e-9)
    assert spans.seconds(records)["a"] == pytest.approx(100e-9)


def _own_by_brute_force(records):
    """Own nanoseconds by name, from the instants each span covers."""
    out = {}
    for i, r in enumerate(records):
        covered = np.zeros(r.end_ns - r.start_ns, bool)
        for c in records:
            if c.parent == i:
                covered[max(c.start_ns, r.start_ns) - r.start_ns : min(c.end_ns, r.end_ns) - r.start_ns] = True
        out[r.name] = out.get(r.name, 0) + int((~covered).sum())
    return out


def _decode_records(monkeypatch, strand):
    """The records of one small decode of a strand, on an even host clock
    (which keeps the brute force small)."""
    rng = np.random.default_rng(5)
    enc = data.encode_dna("".join(rng.choice(list("ACGT"), 700)))
    cls = rng.dirichlet(np.ones(15), 700).astype(np.float32)
    clock = iter(range(0, 10**9, 1000))
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(clock))
    with profiling.span("hmm.test"):  # opened with the profiler off: ends the older session
        pass
    with torch.profiler.profile(), torch.inference_mode():
        enc = data.revcomp_onehot(enc) if strand == "-" else enc
        cli.decode_contig(cli._gene_pred_layer(4, "cpu").viterbi, enc, cls, 200, 2, 8)
    return profiling.recorded_spans()


def test_own_time_of_a_real_decode(monkeypatch):
    records = _decode_records(monkeypatch, "-")
    own, whole = spans.seconds(records, own=True), spans.seconds(records)
    for name, ns in _own_by_brute_force(records).items():
        assert own[name] == pytest.approx(ns * 1e-9, abs=1e-12)
    assert whole["hmm.predict.decode"] == pytest.approx(own["hmm.predict.decode"] + whole["hmm.layer.viterbi"])


def test_no_recorder_or_no_span_of_the_name_reads_nothing(monkeypatch):
    rec = {"trace": {"units": 2}}
    monkeypatch.delattr(profiling, "recorded_spans")
    assert spans.ms_per_unit(rec, "hmm.train.forward") is None
    monkeypatch.undo()
    profiling.clear_spans()
    assert spans.ms_per_unit(rec, "hmm.train.forward") is None
    _decode_records(monkeypatch, "+")  # a forward strand: no reverse complement to measure
    assert spans.ms_per_unit(rec, "hmm.data.revcomp") is None
    assert spans.ms_per_unit(rec, "hmm.predict.windows", own=True) > 0
