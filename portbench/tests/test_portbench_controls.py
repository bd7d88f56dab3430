"""The controls at a size a test run holds, on the CPU: the reference put
in the program's place one precision step down reads worse than the
program on the numbers the cell compares (``portbench/controls.py`` reads
the same at the cells' own sizes on the card)."""

import json

import pytest
import torch

from portbench import controls, run

from test_portbench_run import SMALL


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cell(name):
    cell = run.Cell(json.loads((run.ROOT / "BENCHMARK.json").read_text()), name)
    cell.cfg = run._merge(cell.cfg, SMALL[name]["config"])
    cell.traffic = run._merge(cell.traffic, SMALL[name]["traffic"])
    return cell


def test_training_control_reads_worse_on_a_compared_number():
    cell = small_cell("profile-m5-train")
    out = controls.train_readings(cell, 2**31 + 5, "cpu", ["control", "half_batch"])
    compared = set(cell.limits)
    ratios = {k: out["control"][k] / max(out["program"][k], 1e-12) for k in compared}
    assert max(ratios.values()) >= 3.0, (out["program"], out["control"])
    fault = {k: out["half_batch"][k] / max(out["program"][k], 1e-12) for k in compared}
    assert max(fault.values()) >= 3.0, (out["program"], out["half_batch"])


def test_decode_control_reads_worse():
    cell = small_cell("genepred-q15-predict")
    out = controls.predict_readings(cell, 2**31 + 5, "cpu", ["control"])
    assert out["control"]["path_gap_nats"] > 3.0 * out["program"]["path_gap_nats"]
    assert out["control_windows"]["over_1e-6"] > out["program_windows"]["over_1e-6"]
