"""Input pipeline: FASTA reading, DNA and protein encoding, batching (port
of ``hmm_layer_tpu/data.py``, pure Python).

* :func:`read_fasta` — streaming parser (plain or gzip).
* :func:`encode_dna` — (L, 5) one-hot over ACGTN with IUPAC ambiguity
  codes spread uniformly (the gene-pred emitters' nucleotide channels).
* :func:`encode_protein` — (L+1, 26) one-hot over :data:`PROTEIN_ALPHABET`
  plus the profile HMM's terminal symbol.
* :func:`revcomp` / :func:`revcomp_onehot` — reverse complement of a
  string or of its encoding.
* :func:`read_fasta_encoded` — ``(name, encoding)`` pairs from a file.
* :func:`window_batches` — fixed-shape sliding windows over long contigs,
  batched to ``(batch, window, channels)`` with their start positions.
* :func:`pad_batches` — ragged protein sequences batched with terminal
  padding.

Plain files are read by the native C++ scanner (:mod:`hmm_layer_torch.native`:
one mmap pass for the record boundaries, whitespace-stripped extraction and
the fused byte-to-one-hot encoding at memcpy speed); ``.gz`` files take the
Python parser, since gzip cannot be mmapped, and ``HMM_NATIVE_IO=0`` opts
out of the scanner. Both paths yield the same records and encodings. A
failed native build raises: there is no silent fallback.

Everything returns NumPy.
"""

from __future__ import annotations

import gzip
import os
from typing import Iterable, Iterator

import numpy as np

from .utils.profiling import span

__all__ = [
    "read_fasta",
    "read_fasta_encoded",
    "revcomp",
    "revcomp_onehot",
    "encode_dna",
    "encode_protein",
    "window_batches",
    "pad_batches",
    "PROTEIN_ALPHABET",
]

# HMM_NATIVE_IO=0 opts out of the C++ scanner (the JAX package's switch).
_use_native_io = os.environ.get("HMM_NATIVE_IO", "1") != "0"


def _native_index(path):
    """A native :class:`~hmm_layer_torch.native.FastaIndex` for ``path``,
    or None for gzip input and where ``HMM_NATIVE_IO=0``. A failed build
    or load raises."""
    if not _use_native_io or str(path).endswith(".gz"):
        return None
    from . import native

    return native.FastaIndex(path)


# learnMSA's amino-acid order: the 20 canonical residues, then B Z X U O.
PROTEIN_ALPHABET = "ARNDCQEGHILKMFPSTWYVBZXUO"

_DNA = "ACGT"
# IUPAC ambiguity codes -> the set of bases they may stand for.
_IUPAC = {
    "R": "AG", "Y": "CT", "S": "CG", "W": "AT", "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
}


def read_fasta(path) -> Iterator[tuple[str, str]]:
    """Yield ``(name, sequence)`` pairs; ``.gz`` files are read through
    gzip. The name is the header's first word; whitespace inside sequence
    lines is dropped. Plain files go through the native scanner."""
    idx = _native_index(path)
    if idx is not None:
        return _read_fasta_native(idx)
    return _read_fasta_py(path)


def _read_fasta_native(idx) -> Iterator[tuple[str, str]]:
    with idx:
        yield from idx


def _read_fasta_py(path) -> Iterator[tuple[str, str]]:
    opener = gzip.open if str(path).endswith(".gz") else open
    name, parts = None, []
    with opener(path, "rt") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(parts)
                name, parts = line[1:].split()[0] if len(line) > 1 else "", []
            else:
                parts.append("".join(line.split()))
    if name is not None:
        yield name, "".join(parts)


# Complement table covering ACGT + IUPAC ambiguity codes, both cases;
# anything else maps to N (matching encode_dna's unknown-byte handling).
_COMPLEMENT = {}
for _a, _b in (
    ("A", "T"), ("C", "G"), ("R", "Y"), ("K", "M"),
    ("B", "V"), ("D", "H"), ("S", "S"), ("W", "W"), ("N", "N"),
):
    _COMPLEMENT[_a], _COMPLEMENT[_b] = _b, _a
    _COMPLEMENT[_a.lower()], _COMPLEMENT[_b.lower()] = _b.lower(), _a.lower()
_REVCOMP_TABLE = str.maketrans({c: _COMPLEMENT.get(chr(c), "N") for c in range(128)})


def revcomp(seq: str) -> str:
    """Reverse complement of a DNA string (IUPAC-aware, case-preserving;
    unknown characters become ``N``)."""
    return seq.translate(_REVCOMP_TABLE)[::-1]


# Channel permutation realising complementation on ACGTN one-hot rows:
# A<->T, C<->G, N fixed; exact for the uniform IUPAC rows too.
_RC_PERM_DNA = np.array([3, 2, 1, 0, 4])


@span("hmm.data.revcomp")
def revcomp_onehot(encoded: np.ndarray) -> np.ndarray:
    """Reverse complement of an :func:`encode_dna` output: reverse the
    positions, permute the channels.
    ``revcomp_onehot(encode_dna(s)) == encode_dna(revcomp(s))`` exactly."""
    return np.ascontiguousarray(encoded[::-1, _RC_PERM_DNA])


def _dna_lut() -> np.ndarray:
    """(256, 5) byte -> channel-distribution lookup table."""
    lut = np.zeros((256, 5), np.float32)
    lut[:, 4] = 1.0  # default: treat unknown bytes as N
    for j, ch in enumerate(_DNA):
        for c in (ch, ch.lower()):
            lut[ord(c)] = 0.0
            lut[ord(c), j] = 1.0
    for code, bases in _IUPAC.items():
        if code == "N":
            continue
        row = np.zeros(5, np.float32)
        for bb in bases:
            row[_DNA.index(bb)] = 1.0 / len(bases)
        lut[ord(code)] = lut[ord(code.lower())] = row
    return lut


_DNA_LUT = _dna_lut()


def encode_dna(seq: str, dtype=np.float32) -> np.ndarray:
    """(L, 5) one-hot over ACGTN; IUPAC ambiguity codes spread uniformly
    over their bases; unknown and non-ASCII bytes become the 'N' channel."""
    idx = np.frombuffer(seq.encode("ascii", errors="replace"), np.uint8)
    return _DNA_LUT[idx].astype(dtype, copy=False)


def _protein_lut(alphabet: str) -> np.ndarray:
    s = len(alphabet) + 1
    lut = np.zeros((256, s), np.float32)
    # Unknown letters spread uniformly over the canonical channels (the
    # first min(20, len(alphabet)) entries of the given alphabet).
    n_canon = min(20, len(alphabet))
    lut[:, :n_canon] = 1.0 / n_canon
    for j, ch in enumerate(alphabet):
        for c in (ch.upper(), ch.lower()):
            lut[ord(c)] = 0.0
            lut[ord(c), j] = 1.0
    return lut


_PROTEIN_LUT = _protein_lut(PROTEIN_ALPHABET)


def encode_protein(
    seq: str, alphabet: str = PROTEIN_ALPHABET, add_terminal: bool = True, dtype=np.float32
) -> np.ndarray:
    """(L[+1], len(alphabet)+1) one-hot; unknown letters spread uniformly
    over the alphabet's canonical channels; the terminal symbol (last
    channel) is appended when ``add_terminal`` (profile-HMM convention)."""
    lut = _PROTEIN_LUT if alphabet == PROTEIN_ALPHABET else _protein_lut(alphabet)
    idx = np.frombuffer(seq.encode("ascii", errors="replace"), np.uint8)
    out = lut[idx].astype(dtype, copy=False)
    if add_terminal:
        term = np.zeros((1, out.shape[-1]), dtype)
        term[0, -1] = 1.0
        out = np.concatenate([out, term], axis=0)
    return out


def read_fasta_encoded(
    path, kind: str = "dna", alphabet: str = PROTEIN_ALPHABET, add_terminal: bool = True
) -> Iterator[tuple[str, np.ndarray]]:
    """Yield ``(name, encoded)`` pairs from a FASTA file. ``kind`` is
    ``"dna"`` (``(L, 5)`` ACGTN channels) or ``"protein"`` (``(L+1,
    len(alphabet)+1)`` with the terminal row appended when
    ``add_terminal``). Plain files take the native scanner's fused
    encoding (:meth:`~hmm_layer_torch.native.FastaIndex.onehot`), equal to
    the encoders' output."""
    if kind not in ("dna", "protein"):
        raise ValueError(f"kind must be 'dna' or 'protein', got {kind!r}")
    idx = _native_index(path)
    if idx is None:
        for name, seq in _read_fasta_py(path):
            if kind == "dna":
                yield name, encode_dna(seq)
            else:
                yield name, encode_protein(seq, alphabet, add_terminal)
        return
    if kind == "dna":
        lut = _DNA_LUT
    else:
        lut = _PROTEIN_LUT if alphabet == PROTEIN_ALPHABET else _protein_lut(alphabet)
    with idx:
        for i, name in enumerate(idx.names):
            out = idx.onehot(i, lut)  # fused: file bytes to channels, no string
            if kind == "protein" and add_terminal:
                term = np.zeros((1, out.shape[-1]), out.dtype)
                term[0, -1] = 1.0
                out = np.concatenate([out, term], axis=0)
            yield name, out


def window_batches(
    encoded: np.ndarray,
    window: int,
    batch_size: int,
    overlap: int = 0,
    pad_value: float = 0.0,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Slide fixed windows over one long encoded contig and batch them.

    Yields ``(batch (b, window, s), starts (b,))`` with the last window
    right-padded by ``pad_value`` and the last batch filled with padding
    windows of start ``-1``, so every batch has the same shape. ``overlap``
    gives chunk-border context (codon patterns at window edges).
    """
    if overlap >= window:
        raise ValueError(f"overlap={overlap} must be < window={window}")
    L, s = encoded.shape
    if L == 0:
        return
    stride = window - overlap
    buf, pos = [], []
    for st in range(0, max(L - overlap, 1), stride):
        chunk = encoded[st : st + window]
        if chunk.shape[0] < window:
            chunk = np.concatenate(
                [chunk, np.full((window - chunk.shape[0], s), pad_value, encoded.dtype)]
            )
        buf.append(chunk)
        pos.append(st)
        if len(buf) == batch_size:
            yield np.stack(buf), np.asarray(pos)
            buf, pos = [], []
    if buf:
        while len(buf) < batch_size:
            buf.append(np.full((window, s), pad_value, encoded.dtype))
            pos.append(-1)
        yield np.stack(buf), np.asarray(pos)


def pad_batches(
    encoded: Iterable[np.ndarray], batch_size: int, terminal_channel: int = -1
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Batch ragged sequences, padding with the terminal symbol.

    Yields ``(batch (batch_size, L_max, s), lengths (batch_size,))``; short
    sequences continue emitting the terminal symbol (the profile HMM's
    absorbing terminal state makes the padded loglik equal the unpadded
    one, learnMSA's convention). The final partial group is filled with
    all-terminal rows (``length == 0``), so the leading dimension is always
    ``batch_size``.
    """
    group = []
    for e in encoded:
        group.append(e)
        if len(group) == batch_size:
            yield _pad_group(group, batch_size, terminal_channel)
            group = []
    if group:
        yield _pad_group(group, batch_size, terminal_channel)


def _pad_group(group, batch_size, terminal_channel):
    s = group[0].shape[-1]
    L_max = max(g.shape[0] for g in group)
    batch = np.zeros((batch_size, L_max, s), group[0].dtype)
    batch[:, :, terminal_channel] = 1.0  # batch-fill rows stay all-terminal
    lengths = np.zeros((batch_size,), np.int32)
    for i, g in enumerate(group):
        batch[i] = 0.0
        batch[i, : g.shape[0]] = g
        batch[i, g.shape[0] :, terminal_channel] = 1.0
        lengths[i] = g.shape[0]
    return batch, lengths
