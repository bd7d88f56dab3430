"""Native (C++) host-side data path: FASTA scanning and fused encoding
(port of ``hmm_layer_tpu/native``; the C++ source is the JAX package's,
byte for byte).

The byte-level work of reading FASTA files for the ``predict``, ``align``
and ``train`` commands — the newline-skipping record scan, the
whitespace-stripped extraction and the fused parse-to-one-hot — runs in
C++ (``fasta_io.cpp``) at memcpy speed.

* Bound with :mod:`ctypes`, like the port's CUDA libraries
  (:mod:`hmm_layer_torch.ops._cuda_build`).
* Compiled at first use with ``g++ -O3 -std=c++17 -shared -fPIC`` into
  ``hmm_layer_torch/_build/``, the file name keyed by a hash of the
  source, so an edited source is rebuilt and an unchanged one loaded.
* No silent fallback: a failed build or load raises with the compiler's
  message. ``data.read_fasta`` takes the Python parser only for ``.gz``
  input (gzip cannot be mmapped) and where ``HMM_NATIVE_IO=0`` opts out.

Importing this module compiles nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["build", "load", "FastaIndex"]

SOURCE = Path(__file__).resolve().parent / "fasta_io.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"fasta_io_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``fasta_io.cpp`` unless the library for its hash exists;
    its path. Raises ``RuntimeError`` with the compiler's output when the
    build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no g++ at all
        raise RuntimeError(f"native build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"native build failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def load() -> ctypes.CDLL:
    """The loaded scanner library, built first if needed; raises on a
    failed build or load."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, p8, pf = (
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_float),
            )
            pi64 = ctypes.POINTER(ctypes.c_int64)
            lib.hmm_fasta_scan.restype = i64
            lib.hmm_fasta_scan.argtypes = [p8, i64, pi64, pi64, pi64, pi64, pi64, i64]
            lib.hmm_fasta_extract.restype = i64
            lib.hmm_fasta_extract.argtypes = [p8, i64, i64, p8, p8]
            lib.hmm_fasta_extract_onehot.restype = i64
            lib.hmm_fasta_extract_onehot.argtypes = [p8, i64, i64, pf, i64, p8]
            _lib = lib
        return _lib


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


_IDENTITY_LUT = np.arange(256, dtype=np.uint8)


class FastaIndex:
    """mmap-backed random-access FASTA reader over the native scanner.

    Indexes all records in one C pass; sequences are materialised on
    demand (as cleaned strings, code arrays, or fused one-hot float
    arrays), so a genome-scale file costs O(#records) Python objects up
    front, not O(bytes).
    """

    def __init__(self, path):
        lib = load()
        self._lib = lib
        self._fh = open(path, "rb")
        try:
            # ACCESS_COPY (private copy-on-write) rather than ACCESS_READ:
            # ctypes.from_buffer needs a writable buffer, and nothing is
            # written, so no page is ever copied.
            self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_COPY)
            self._buf = (ctypes.c_uint8 * len(self._mm)).from_buffer(self._mm)
        except ValueError:  # a zero-length file cannot be mmapped
            self._mm = None
            self._buf = (ctypes.c_uint8 * 1)()
        n = len(self._mm) if self._mm is not None else 0
        null = ctypes.cast(None, ctypes.POINTER(ctypes.c_int64))
        count = lib.hmm_fasta_scan(self._buf, n, null, null, null, null, null, 0)
        cols = np.zeros((5, count), np.int64)
        if count:
            ptrs = [c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)) for c in cols]
            lib.hmm_fasta_scan(self._buf, n, *ptrs, count)
        self._seq_span = cols[2], cols[3]
        self.lengths = cols[4].copy()
        mv = memoryview(self._mm) if self._mm is not None else b""
        self.names = [
            bytes(mv[a:b]).decode("ascii", errors="replace") for a, b in zip(cols[0], cols[1])
        ]

    def __len__(self):
        return len(self.names)

    def codes(self, i: int, lut256: np.ndarray | None = None) -> np.ndarray:
        """(L,) uint8 sequence bytes of record ``i``, whitespace removed,
        mapped through ``lut256`` (identity by default: the raw bytes)."""
        lut = _IDENTITY_LUT if lut256 is None else np.ascontiguousarray(lut256, np.uint8)
        out = np.empty(int(self.lengths[i]), np.uint8)
        a, b = self._seq_span[0][i], self._seq_span[1][i]
        written = self._lib.hmm_fasta_extract(self._buf, int(a), int(b), _u8ptr(lut), _u8ptr(out))
        assert written == out.shape[0]
        return out

    def sequence(self, i: int) -> str:
        """Cleaned sequence string of record ``i`` (the Python parser's)."""
        return self.codes(i).tobytes().decode("ascii", errors="replace")

    def onehot(self, i: int, row_lut: np.ndarray) -> np.ndarray:
        """Fused parse and encode: (L, c) float32 rows of ``row_lut``
        (256, c) indexed by the record's sequence bytes."""
        lut = np.ascontiguousarray(row_lut, np.float32)
        c = lut.shape[1]
        out = np.empty((int(self.lengths[i]), c), np.float32)
        a, b = self._seq_span[0][i], self._seq_span[1][i]
        written = self._lib.hmm_fasta_extract_onehot(
            self._buf, int(a), int(b), lut.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), c, _u8ptr(out)
        )
        assert written == out.shape[0]
        return out

    def __iter__(self):
        for i, name in enumerate(self.names):
            yield name, self.sequence(i)

    def close(self):
        # Release the ctypes view before the mmap (else mmap.close raises
        # "exported pointers exist").
        self._buf = None
        if self._mm is not None:
            self._mm.close()
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
