"""The port's native FASTA reader (``hmm_layer_torch.native`` and the
native path of ``hmm_layer_torch.data``) against the JAX package's native
and Python paths on the hostile FASTA of ``tests/test_native.py``: the
records, the byte codes and the fused one-hot encodings are equal byte for
byte. ``.gz`` input and ``HMM_NATIVE_IO=0`` take the Python parser; a
source that does not compile makes the build raise (no silent fallback)."""

import gzip
import hashlib
import shutil
import sys

import numpy as np
import pytest

from hmm_layer_tpu import data as jdata
from hmm_layer_tpu import native as jnative
from hmm_layer_torch import data, native

TRICKY = (
    "garbage before the first header\n"
    "ACGT\n"
    ">seq1 a description here\n"
    "ACGTacgtNRYK\n"
    "\n"
    "MMWWSS\n"
    ">seq2\r\n"
    "AAAA\r\n"
    "CCCC\r\n"
    ">\n"
    "GGGG\n"
    ">  seq4 desc\n"
    "TT TT\n"
    ">seq5_no_trailing_newline\n"
    "ACGTN"
)


@pytest.fixture
def tricky_path(tmp_path):
    p = tmp_path / "tricky.fa"
    p.write_text(TRICKY)
    return p


def test_source_is_the_jax_packages():
    ours = native.SOURCE.read_bytes()
    theirs = open(jnative._SRC, "rb").read()
    assert hashlib.sha256(ours).digest() == hashlib.sha256(theirs).digest()


def test_records_equal_both_jax_paths(tricky_path):
    ours = list(data.read_fasta(tricky_path))
    assert ours == list(jdata._read_fasta_py(tricky_path))
    assert ours == list(jdata._read_fasta_native(jnative.FastaIndex(tricky_path)))
    assert [n for n, _ in ours] == ["seq1", "seq2", "", "seq4", "seq5_no_trailing_newline"]


def test_public_reader_takes_the_native_path(tricky_path, monkeypatch):
    idx = data._native_index(tricky_path)
    assert isinstance(idx, native.FastaIndex)
    idx.close()
    calls = []
    monkeypatch.setattr(data, "_read_fasta_py", lambda path: calls.append(path) or iter(()))
    assert len(list(data.read_fasta(tricky_path))) == 5
    assert calls == []


def test_codes_and_lengths_equal_jax(tricky_path):
    lut = np.full(256, 4, np.uint8)
    for j, ch in enumerate("ACGT"):
        lut[ord(ch)] = lut[ord(ch.lower())] = j
    with native.FastaIndex(tricky_path) as ours, jnative.FastaIndex(tricky_path) as theirs:
        np.testing.assert_array_equal(ours.lengths, theirs.lengths)
        assert ours.names == theirs.names
        for i in range(len(ours)):
            assert ours.codes(i).tobytes() == theirs.codes(i).tobytes()
            assert ours.codes(i, lut).tobytes() == theirs.codes(i, lut).tobytes()


@pytest.mark.parametrize("kind", ["dna", "protein"])
@pytest.mark.parametrize("add_terminal", [True, False])
def test_fused_encoding_equals_jax(tmp_path, tricky_path, kind, add_terminal):
    path = tricky_path
    if kind == "protein":
        path = tmp_path / "prot.fa"
        path.write_text(">p1\nARNDCQEGHILKMFPSTWYV\n>p2\nbzxuoJ*\n")
    ours = list(data.read_fasta_encoded(path, kind=kind, add_terminal=add_terminal))
    theirs = list(jdata.read_fasta_encoded(path, kind=kind, add_terminal=add_terminal))
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()
    for (name, enc), (_, seq) in zip(ours, jdata._read_fasta_py(path)):
        expect = jdata.encode_dna(seq) if kind == "dna" else jdata.encode_protein(seq, add_terminal=add_terminal)
        assert enc.tobytes() == expect.tobytes(), name


def test_gzip_takes_the_python_parser(tmp_path):
    p = tmp_path / "x.fa.gz"
    with gzip.open(p, "wt") as fh:
        fh.write(TRICKY)
    assert data._native_index(p) is None
    assert list(data.read_fasta(p)) == list(jdata._read_fasta_py(p))
    for (_, a), (_, b) in zip(data.read_fasta_encoded(p), jdata.read_fasta_encoded(p)):
        assert a.tobytes() == b.tobytes()


def test_opt_out_takes_the_python_parser(tricky_path, monkeypatch):
    native_records = list(data.read_fasta(tricky_path))
    monkeypatch.setattr(data, "_use_native_io", False)
    assert data._native_index(tricky_path) is None
    assert list(data.read_fasta(tricky_path)) == native_records


def test_opt_out_environment_variable(tricky_path, monkeypatch):
    """``HMM_NATIVE_IO=0`` (read at import, as in the JAX package)."""
    monkeypatch.setenv("HMM_NATIVE_IO", "0")
    monkeypatch.delitem(sys.modules, "hmm_layer_torch.data")
    import hmm_layer_torch.data as fresh

    try:
        assert fresh._use_native_io is False
        assert fresh._native_index(tricky_path) is None
        assert list(fresh.read_fasta(tricky_path)) == list(data.read_fasta(tricky_path))
    finally:
        sys.modules["hmm_layer_torch.data"] = data


def test_empty_and_headerless_files(tmp_path):
    empty = tmp_path / "empty.fa"
    empty.write_text("")
    assert list(data.read_fasta(empty)) == []
    junk = tmp_path / "junk.fa"
    junk.write_text("no header at all\nACGT\n")
    assert list(data.read_fasta(junk)) == []


def test_broken_source_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's message;
    nothing falls back to Python."""
    broken = tmp_path / "fasta_io.cpp"
    shutil.copy(native.SOURCE, broken)
    with open(broken, "a") as fh:
        fh.write("\nthis is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)native build failed.*error"):
        native.build()
    with pytest.raises(RuntimeError, match="native build failed"):
        list(data.read_fasta(tmp_path / "none.fa"))


def test_import_compiles_nothing():
    """Importing the port builds no library (the backend-free import)."""
    import subprocess

    code = (
        "import sys, hmm_layer_torch, hmm_layer_torch.data, hmm_layer_torch.native as n,"
        " hmm_layer_torch.parallel;"
        " assert n._lib is None; assert 'jax' not in sys.modules"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(native.SOURCE.parents[2]))
