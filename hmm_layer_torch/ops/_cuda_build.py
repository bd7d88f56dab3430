"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles each source into a shared library with a plain C
interface, for ``sm_90a`` (Hopper), into ``hmm_layer_torch/_build/``; the
file name carries a hash of the source and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. The library is loaded
with ``ctypes``. Nothing here runs at import: the first kernel launch calls
:func:`load`, and :func:`build_all` compiles every source at once (one
``nvcc`` process each, all started together). A missing ``nvcc`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..utils.profiling import span

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {
    "sum_product": _PKG / "csrc" / "sum_product.cu",
    "max_plus": _PKG / "csrc" / "max_plus.cu",
    "affine": _PKG / "csrc" / "affine.cu",
    "mxu": _PKG / "csrc" / "mxu.cu",
    "max_plus_wide": _PKG / "csrc" / "max_plus_wide.cu",
    "sum_product_wide": _PKG / "csrc" / "sum_product_wide.cu",
}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of every entry point: pointers and the stream as void*.
SIGNATURES = {
    "sum_product": {
        "hmm_sum_chunk_summaries": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "hmm_sum_fwd_outputs": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "hmm_beta_bwd_outputs": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "max_plus": {
        "hmm_maxplus_chunk_summaries": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "hmm_maxplus_deltas": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "hmm_maxplus_backtrace": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "hmm_maxplus_deltas_blocked": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "hmm_maxplus_backtrace_blocked": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "affine": {
        "hmm_affine_chunk_composites": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "hmm_affine_reverse_outputs": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "mxu": {
        "hmm_sum_chunk_summaries_mxu": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "max_plus_wide": {
        "hmm_maxplus_deltas_wide": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "hmm_maxplus_backtrace_wide": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "sum_product_wide": {
        "hmm_sum_forward_wide": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "hmm_sum_backward_wide": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on ``PATH``, else under the toolkit that
    PyTorch finds (``CUDA_HOME``); raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of hmm_layer_torch are built from csrc/ at first use"
    )


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def _compile(names) -> None:
    """Compile each source of ``names`` whose library for its hash is
    missing: one ``nvcc`` process per source, all started before any is
    waited for. Raises after all have ended if any failed."""
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, out, tmp, cmd, proc))
    failures = []
    for name, out, tmp, cmd, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(
                f"nvcc failed ({proc.returncode}) building {SOURCES[name].name}:\n"
                f"{' '.join(cmd)}\n{stdout}{stderr}"
            )
        else:
            os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    if failures:
        raise RuntimeError("\n".join(failures))


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for its hash exists."""
    _compile([name])
    return library_path(name)


def build_all() -> dict[str, Path]:
    """Compile every source in :data:`SOURCES` in parallel; their paths."""
    _compile(SOURCES)
    return {name: library_path(name) for name in SOURCES}


def load(name: str = "sum_product") -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with span("hmm.cuda.load"):
                lib = ctypes.CDLL(str(build(name)))
                for fn, argtypes in SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib
