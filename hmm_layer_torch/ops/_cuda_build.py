"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles each source into a shared library with a plain C
interface, for ``sm_90a`` (Hopper), into ``hmm_layer_torch/_build/``; the
file name carries a hash of the source and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. The library is loaded
with ``ctypes``. Nothing here runs at import: the first kernel launch calls
:func:`load`. A missing ``nvcc`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {"sum_product": _PKG / "csrc" / "sum_product.cu"}
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


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for its hash exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCES[name].name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def load(name: str = "sum_product") -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib
