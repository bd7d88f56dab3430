"""On the card: each cell through the whole run at a reduced size (kernels
built, the profiler's device trace read), and the controls' readings at
that size. Skips where there is no CUDA device."""

import json

import pytest
import torch

from portbench import controls, run

from test_portbench_run import SMALL


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_run_on_the_card(cell, card, capsys):
    argv = ["--workload", cell, "--seed", "3", "--seconds", "1", "--trace", "1"]
    assert run.main(argv, overrides=SMALL[cell]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert "device_idle_pct." + ("predict" if "predict" in cell else "train") in result["metrics"]


@pytest.mark.gpu
def test_the_control_reads_above_the_program(card):
    cell = "profile-m5-train"
    manifest = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    c = run.Cell(manifest, cell)
    c.cfg = run._merge(c.cfg, SMALL[cell]["config"])
    c.traffic = run._merge(c.traffic, SMALL[cell]["traffic"])
    out = controls.train_readings(c, 5, card, ["control"])
    assert max(out["control"][k] / max(out["program"][k], 1e-12) for k in out["control"]) >= 3.0
