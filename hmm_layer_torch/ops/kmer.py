"""k-mer encodings of one-hot ACGTN sequences (port of
``hmm_layer_tpu/ops/kmer.py``).

* ``N`` positions are spread uniformly over the 4 regular nucleotides.
* k-mers crossing the sequence boundary are padded with the uniform
  distribution.
* Output shape ``(..., L, 4**(k-1), 4)``: the last axis is the pivot base
  (leftmost if ``pivot_left`` else rightmost), the second-to-last axis
  enumerates the remaining ``k-1`` bases.
"""

from __future__ import annotations

import numpy as np
import torch

ALPHABET = "ACGT"


def make_k_mers(sequences, k: int, pivot_left: bool = True):
    """Map one-hot (..., L, 5) ACGTN sequences to k-mer tensors.

    A NumPy input stays NumPy (host-side constant tables built in emitter
    constructors); a tensor is computed with torch ops on its own device
    and dtype.
    """
    L = sequences.shape[-2]
    n = sequences.shape[-1] - 1  # alphabet size without N

    seq = sequences[..., :-1] + sequences[..., -1:] / n  # spread N uniformly
    pad_shape = tuple(seq.shape[:-2]) + (k - 1, n)
    if isinstance(sequences, np.ndarray):
        cat = np.concatenate
        pad = np.full(pad_shape, 1.0 / n, dtype=seq.dtype)
    else:
        cat = torch.cat
        pad = torch.full(pad_shape, 1.0 / n, dtype=seq.dtype, device=seq.device)

    if pivot_left:
        padded = cat([seq, pad], axis=-2)
        k_mers = padded[..., :L, None, :]
        iteration = range(1, k)
    else:
        padded = cat([pad, seq], axis=-2)
        k_mers = padded[..., k - 1 : L + k - 1, None, :]
        iteration = range(k - 2, -1, -1)

    for i in iteration:
        shift_i = padded[..., i : L + i, None, :, None]
        k_mers = k_mers[..., None, :] * shift_i
        width = 4**i if pivot_left else 4 ** (k - i - 1)
        k_mers = k_mers.reshape(tuple(k_mers.shape[:-3]) + (width, n))
    return k_mers


def encode_kmer_string(kmer: str, pivot_left: bool = True, alphabet: str = ALPHABET):
    """Encode a k-mer string (letters of ``alphabet`` + 'N') as a
    ``(4**(k-1), 4)`` NumPy probability table; Ns are uniform over the
    alphabet. With ``pivot_left``: AAA -> (0, 0), AAT -> (3, 0), TAA -> (0, 3).
    """
    full = alphabet + "N"
    idx = np.array([full.index(x) for x in kmer])
    one_hot = np.eye(len(full), dtype=np.float32)[idx]  # (k, 5)
    encoded = make_k_mers(one_hot[None], k=len(kmer), pivot_left=pivot_left)
    return encoded[0, 0] if pivot_left else encoded[0, -1]
