"""Whole runs of each cell at tiny sizes on the CPU (the look for a chip
skipped): the last line's shape, and ``correct`` coming out false with the
timed path broken underneath."""

import json
import math

import pytest
import torch

from portbench import run

SMALL = {
    "profile-m5-train": {"config": {"shape": {"batch": 3, "length": 30}, "model": {"lengths": [5, 7]}},
                         "traffic": {"pool": 4, "trace_steps": 1}},
    "genepred-q15-predict": {"config": {"model": {"parallel_factor": 4}},
                             "traffic": {"contigs": 3, "min_bp": 6000, "max_bp": 15000, "window": 3000, "overlap": 16,
                                         "batch": 3, "trace_strands": 1, "check_block": 16}},
}
FAULTS = {
    "profile-m5-train": ["state_unchanged", "half_batch"],
    "genepred-q15-predict": ["answer_altered", "half_batch"],
}
SEED = 2**31 + 7


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def last_line(cell, capsys, trace=0, faults=(), seed=SEED):
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", "0.3", "--trace", str(trace)]
    assert run.main(argv, device="cpu", faults=faults, overrides=SMALL[cell]) == 0
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    return result, err


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_contracts_shape(cell, trace, capsys):
    result, err = last_line(cell, capsys, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    manifest = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    section = manifest["per_layer" if trace else "end_to_end"]
    allowed = {m["name"]: m["unit"] for m in section if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) <= set(allowed)
    if not trace:
        assert set(result["metrics"]) == set(allowed)
    for name, m in result["metrics"].items():
        assert m["unit"] == allowed[name] and math.isfinite(m["value"])
    if trace:
        assert result["device"]["window_s"] > 0
        assert all(len(v) <= 10 for v in result["breakdown"].values())
    lines = err.strip().splitlines()[-len(result["checks"]):]
    for line, (name, c) in zip(lines, result["checks"].items()):
        assert line.startswith(f"check {name}: ") and c["value"] <= c["limit"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in sorted(FAULTS.items()) for f in fs])
def test_a_broken_timed_path_is_not_correct(cell, fault, capsys):
    result, _ = last_line(cell, capsys, faults=(fault,))
    assert result["correct"] is False, result["checks"]


def test_no_cuda_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "profile-m5-train", "--seed", "1", "--seconds", "1"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err


def test_a_directory_without_the_port_gives_no_result(tmp_path):
    import shutil
    import subprocess
    import sys

    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = ("import sys; sys.path.insert(0, '.'); from portbench import run; "
            "sys.exit(run.main(['--workload', 'profile-m5-train', '--seed', '1', '--seconds', '0.2'], "
            "device='cpu', root=__import__('pathlib').Path('.')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout == ""
