"""The port's package namespaces against the JAX package's: every name in
the ``__all__`` of ``hmm_layer_tpu``, ``.ops``, ``.utils``, ``.models`` and
``.parallel`` resolves in its ``hmm_layer_torch`` counterpart (but for the
idiom differences listed below, each with its reason), and importing the
port and reading those names loads no JAX and creates no CUDA context.
"""

import importlib
import json
import subprocess
import sys

import pytest

NAMESPACES = ("", ".ops", ".utils", ".models", ".parallel")

# JAX names with no port counterpart by design: name -> reason. Empty: every
# JAX name of the five namespaces has one.
IDIOM_DIFFERENCES: dict[str, dict[str, str]] = {ns: {} for ns in NAMESPACES}

# The names this package gained to match the JAX namespaces (read in a fresh
# process below).
NEW_NAMES = {
    "": ("set_dp_precision", "dp_precision", "__version__"),
    ".ops": (
        "ForwardResult", "forward", "backward", "posterior", "log_likelihood", "viterbi", "logmatmul",
        "logmatvec", "maxmatmul", "maxargmatvec", "log_normalize", "EPS", "LOG_ZERO", "em", "kmer",
        "plan7", "recursion", "sampling", "scan", "semiring",
    ),
    ".utils": ("bijectors", "checkpoint", "metrics", "profiling", "resilience", "substitution"),
    ".parallel": ("local_ranges", "LocalRanges"),
}


@pytest.mark.parametrize("ns", NAMESPACES)
def test_every_jax_name_resolves_in_the_port(ns):
    jax_ns = importlib.import_module(f"hmm_layer_tpu{ns}")
    port_ns = importlib.import_module(f"hmm_layer_torch{ns}")
    missing = [name for name in jax_ns.__all__
               if name not in IDIOM_DIFFERENCES[ns] and not hasattr(port_ns, name)]
    assert not missing, f"hmm_layer_torch{ns} lacks {missing}"
    assert set(jax_ns.__all__) - set(IDIOM_DIFFERENCES[ns]) <= set(port_ns.__all__)


def test_port_versions_and_aliases():
    import hmm_layer_tpu
    import hmm_layer_torch
    from hmm_layer_torch import ops
    from hmm_layer_torch.ops import recursion, semiring

    assert hmm_layer_torch.__version__ == hmm_layer_tpu.__version__ == "0.1.0"
    assert hmm_layer_torch.set_dp_precision is recursion.set_dp_precision
    assert ops.forward is hmm_layer_torch.forward is recursion.forward
    assert ops.EPS == semiring.EPS == 1e-16
    # The starting mode is pinned: what ran before in this process (the
    # align command, another test) may have left any mode set.
    with hmm_layer_torch.dp_precision("highest"):
        with hmm_layer_torch.dp_precision("high"):
            assert recursion._dp_mode == "high"
        assert recursion._dp_mode == "highest"


_PROBE = """
import importlib, json, sys
import torch
import hmm_layer_torch
names = NAMES
for ns, extra in names.items():
    mod = importlib.import_module("hmm_layer_torch" + ns)
    for name in list(getattr(mod, "__all__", ())) + list(extra):
        getattr(mod, name)
print(json.dumps({"jax": sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "hmm_layer_tpu"))),
                  "cuda_initialized": torch.cuda.is_initialized()}))
"""


@pytest.fixture(scope="module")
def fresh_import():
    """Import the port in a fresh process and read every name of its five
    namespaces, the new ones included."""
    names = {ns: list(NEW_NAMES.get(ns, ())) for ns in NAMESPACES}
    code = _PROBE.replace("NAMES", repr(names))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_import_loads_no_jax(fresh_import):
    assert fresh_import["jax"] == []


def test_port_import_creates_no_cuda_context(fresh_import):
    assert fresh_import["cuda_initialized"] is False
