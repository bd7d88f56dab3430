"""What the benchmark may import: nothing of JAX or of the JAX package,
and the reference nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "hmm_layer_tpu"}


def top_level_imports(path: Path):
    """Top-level names of every import in a file, compared whole."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def harness_files():
    """Every module ``run.py`` can reach: all of the benchmark's files but
    its tests (drivers, families and readers are loaded by file)."""
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", harness_files(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_port_is_not_caught_by_a_prefix():
    names = top_level_imports(BENCH / "models" / "genepred.py")
    assert "hmm_layer_torch" in names and not names & FORBIDDEN
    assert "hmm_layer_torch".startswith("hmm_layer_t") and "hmm_layer_torch" not in FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "hmm_layer_torch" not in top_level_imports(path)
    assert "hmm_layer_torch" not in path.read_text()


@pytest.mark.parametrize("path", harness_files(), ids=lambda p: str(p.relative_to(BENCH)))
def test_reads_no_jax_benchmark_file(path):
    text = path.read_text()
    for name in ("benchmarks/", "bench.py", "BENCH_", "BASELINE", "__graft_entry__"):
        assert name not in text, name


def test_a_cpu_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh process, then ``sys.modules`` read."""
    code = (
        "import sys, json, torch; torch.set_num_threads(1); sys.path.insert(0, %r)\n"
        "from portbench import run\n"
        "rc = run.main(['--workload', 'profile-m5-train', '--seed', '5', '--seconds', '0.2'], device='cpu',\n"
        "    overrides={'config': {'shape': {'batch': 2, 'length': 20}, 'model': {'lengths': [5, 7]}},\n"
        "               'traffic': {'pool': 3}})\n"
        "print(json.dumps({'rc': rc, 'loaded': run.forbidden_modules()}))\n" % str(ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert '"rc": 0' in last and '"loaded": []' in last
