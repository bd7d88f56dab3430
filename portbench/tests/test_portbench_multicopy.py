"""The multi-copy decode cell (``genepred-q505-predict``) through whole
runs at a tiny size on the CPU (k = 2, q = 29, windows of 300): the last
line's shape, ``correct`` coming out false with the timed path broken
underneath, and the bfloat16 control reading worse than the program.

At this size the program's sequential float32 decode reads at most 0.0051
nats of ``path_gap_nats`` and the half-batch fault 3.1-8.9 nats (16 seeds),
so the tiny runs hold the number to 0.5; the cell's own limit is set at its
own size from the chip's readings (``portbench/controls_multicopy.py``)."""

import json
import math

import pytest
import torch

from portbench import controls_multicopy, run
from portbench.drivers.predict import windows_of

CELL = "genepred-q505-predict"
SMALL = {
    "config": {"model": {"copies": 2}},
    "traffic": {"contigs": 3, "min_bp": 1500, "max_bp": 4000, "window": 300, "overlap": 16, "batch": 3,
                "check_block": 16, "check_sample": 8},
    "limits": {"path_gap_nats": 0.5},
}
SEED = 2**31 + 7


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def last_line(capsys, trace=0, faults=()):
    argv = ["--workload", CELL, "--seed", str(SEED), "--seconds", "0.3", "--trace", str(trace)]
    assert run.main(argv, device="cpu", faults=faults, overrides=SMALL) == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_contracts_shape(trace, capsys):
    result, err = last_line(capsys, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    manifest = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    section = manifest["per_layer" if trace else "end_to_end"]
    allowed = {m["name"]: m["unit"] for m in section if CELL in m.get("workloads", [CELL])}
    if trace:
        assert sorted(allowed) == sorted(["kernels_per_batch.multicopy", "device_idle_pct.multicopy",
                                          "mfu_pct.multicopy", "window_fill_pct.multicopy"])
        assert "window_fill_pct.multicopy" in result["metrics"] and result["device"]["window_s"] > 0
    else:
        assert set(result["metrics"]) == set(allowed) == {"predict_bp_per_s", "setup_s"}
    assert set(result["metrics"]) <= set(allowed)
    for name, m in result["metrics"].items():
        assert m["unit"] == allowed[name] and math.isfinite(m["value"])
    line = err.strip().splitlines()[-1]
    assert line.startswith("check path_gap_nats: ") and result["checks"]["path_gap_nats"]["limit"] == 0.5


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
def test_a_broken_timed_path_is_not_correct(fault, capsys):
    result, _ = last_line(capsys, faults=(fault,))
    assert result["correct"] is False and result["failed"] > 0, result["checks"]


def test_the_check_judges_the_first_strand_whole_and_a_seeded_sample():
    cell = run.Cell(json.loads((run.ROOT / "BENCHMARK.json").read_text()), CELL)
    cell.cfg, cell.traffic = run._merge(cell.cfg, SMALL["config"]), run._merge(cell.traffic, SMALL["traffic"])
    r = controls_multicopy._program(cell, SEED, "cpu", 0.3)
    problems = r.distinct_tracks()
    rows = r.check_rows(problems)
    assert (problems[0][0], problems[0][1]) == tuple(r.answers[0][:2])
    first = [row for row in rows if row[0] == 0]

    def windows(track):
        return len(windows_of(len(track), r.window_len, r.overlap))

    assert len(first) == windows(problems[0][2])
    assert len(rows) - len(first) == min(8, sum(windows(p[2]) for p in problems[1:]))
    assert rows == r.check_rows(problems)  # the seed's draw


def test_the_bfloat16_control_reads_worse_than_the_program():
    cell = run.Cell(json.loads((run.ROOT / "BENCHMARK.json").read_text()), CELL)
    cell.cfg, cell.traffic = run._merge(cell.cfg, SMALL["config"]), run._merge(cell.traffic, SMALL["traffic"])
    out = controls_multicopy.readings(cell, 2**31 + 5, "cpu", 0.3, ["control"])
    limit = SMALL["limits"]["path_gap_nats"]
    assert out["program"]["path_gap_nats"] <= limit < out["control"]["path_gap_nats"]
    assert out["control_windows"]["over_1e-6"] > out["program_windows"]["over_1e-6"]
