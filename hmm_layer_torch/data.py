"""Input pipeline: FASTA reading, DNA encoding, windowed batching (port of
``hmm_layer_tpu/data.py``, DNA side, pure Python).

* :func:`read_fasta` — streaming parser (plain or gzip).
* :func:`encode_dna` — (L, 5) one-hot over ACGTN with IUPAC ambiguity
  codes spread uniformly (the gene-pred emitters' nucleotide channels).
* :func:`revcomp` / :func:`revcomp_onehot` — reverse complement of a
  string or of its encoding.
* :func:`read_fasta_encoded` — ``(name, encoding)`` pairs from a file.
* :func:`window_batches` — fixed-shape sliding windows over long contigs,
  batched to ``(batch, window, channels)`` with their start positions.

Everything returns NumPy. The JAX package's native C++ FASTA scanner and
the protein encodings are not ported yet (ROADMAP Queue 1 items 10, 12):
this module always takes the Python path, which yields the same records.
"""

from __future__ import annotations

import gzip
from typing import Iterator

import numpy as np

__all__ = [
    "read_fasta",
    "read_fasta_encoded",
    "revcomp",
    "revcomp_onehot",
    "encode_dna",
    "window_batches",
]

_DNA = "ACGT"
# IUPAC ambiguity codes -> the set of bases they may stand for.
_IUPAC = {
    "R": "AG", "Y": "CT", "S": "CG", "W": "AT", "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
}


def read_fasta(path) -> Iterator[tuple[str, str]]:
    """Yield ``(name, sequence)`` pairs; ``.gz`` files are read through
    gzip. The name is the header's first word; whitespace inside sequence
    lines is dropped."""
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


def read_fasta_encoded(path) -> Iterator[tuple[str, np.ndarray]]:
    """Yield ``(name, encode_dna(sequence))`` pairs from a FASTA file (the
    JAX function with ``kind="dna"``; the protein encoding comes with the
    profile-HMM family, ROADMAP Queue 1 item 10)."""
    for name, seq in read_fasta(path):
        yield name, encode_dna(seq)


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
