"""Gapped-MSA construction from profile-HMM Viterbi paths (port of
``hmm_layer_tpu/models/msa.py``; NumPy).

learnMSA's end deliverable is a multiple sequence alignment: each
sequence's most likely state path through the trained profile HMM is
mapped to alignment columns (match states = columns, deletions = gaps,
insert/flank/unannotated emissions = lowercase insertions between
columns), a post-processing step on the decode of
:meth:`~hmm_layer_torch.layer.HMMLayer.viterbi`.

Output format is HMMER/a2m-flavoured: one row per sequence; uppercase
residues in match columns, ``-`` for deletions, lowercase residues for
insertions padded column-wise with ``.`` so every row has equal length.
"""

from __future__ import annotations

import numpy as np

from ..data import PROTEIN_ALPHABET

# The learnMSA input-encoding order — the SAME table data.encode_protein
# one-hots with, so `argmax` of an encoded input decodes back to the
# original letter. (A previous alphabetical ordering here mismatched the
# encoder and printed wrong residue letters.) Out-of-range indices render
# as X.
AMINO_ALPHABET = PROTEIN_ALPHABET

__all__ = [
    "AMINO_ALPHABET",
    "paths_to_msa",
    "write_msa",
    "msa_column_maps",
    "evaluate_msa",
]


def paths_to_msa(
    paths,
    residues,
    model_length: int,
    alphabet: str = AMINO_ALPHABET,
    seq_lengths=None,
):
    """Render Viterbi state paths as a gapped multiple sequence alignment.

    Args:
      paths: ``(b, L)`` int array of decoded states for ONE profile model
        (implicit state order ``LEFT_FLANK, MATCH x Lm, INSERT x Lm-1,
        UNANNOTATED, RIGHT_FLANK, TERMINAL`` —
        ``models/profile_transitions.py``).
      residues: ``(b, L)`` int array of residue indices into ``alphabet``
        (e.g. ``argmax`` of the one-hot model input).
      model_length: ``Lm``, the number of match states.
      alphabet: string mapping residue index -> one-letter code.
      seq_lengths: optional ``(b,)`` true sequence lengths; positions at or
        beyond a sequence's length are ignored (padding).

    Returns:
      list of ``b`` equal-length strings. Match columns are uppercase (or
      ``-`` when the path skips the column via delete states); residues
      emitted by insert, flank, or unannotated states appear lowercase in
      inter-column insertion blocks padded with ``.``. A sequence whose
      path re-enters an earlier match column (multi-hit) has the extra
      hit's residues rendered as insertions after the last column reached.
    """
    paths = np.asarray(paths)
    residues = np.asarray(residues)
    if paths.ndim != 2 or paths.shape != residues.shape:
        raise ValueError(
            f"paths {paths.shape} and residues {residues.shape} must both "
            "be (batch, length)"
        )
    b, L = paths.shape
    Lm = int(model_length)
    terminal = 2 * Lm + 2
    lengths = (
        np.full(b, L) if seq_lengths is None else np.asarray(seq_lengths)
    )

    def letter(idx):
        return alphabet[idx] if 0 <= idx < len(alphabet) else "X"

    # Per sequence: match[j] (1-based) and insertion buckets inserts[j]
    # holding residues emitted between column j and j+1 (j=0: before the
    # first column; j=Lm: after the last).
    match_rows = []
    insert_rows = []
    for i in range(b):
        match = ["-"] * (Lm + 1)  # index 1..Lm used
        inserts = [""] * (Lm + 1)
        last = 0  # last match column reached (insertion anchor)
        for t in range(min(L, lengths[i])):
            s = int(paths[i, t])
            if s == terminal:
                break
            c = letter(int(residues[i, t]))
            if 1 <= s <= Lm and s > last:
                match[s] = c.upper()
                last = s
            elif Lm + 1 <= s <= 2 * Lm - 1 and s - Lm >= last:
                # INSERT k sits after column k. A valid single-hit path only
                # reaches I_k with k == last; the guard keeps a multi-hit
                # re-entry's insert residues anchored after the last column
                # reached so the row reads in sequence order.
                inserts[s - Lm] += c.lower()
            elif s == 2 * Lm + 1:  # RIGHT_FLANK
                inserts[Lm] += c.lower()
            else:
                # LEFT_FLANK (0), UNANNOTATED (2Lm), or a multi-hit
                # re-entry into an earlier match column: anchor after the
                # last column reached.
                inserts[last] += c.lower()
        match_rows.append(match)
        insert_rows.append(inserts)

    # Column-wise composition with per-block padding to the widest insert.
    rows = [""] * b
    for j in range(Lm + 1):
        width = max((len(insert_rows[i][j]) for i in range(b)), default=0)
        for i in range(b):
            rows[i] += insert_rows[i][j].ljust(width, ".")
            if j < Lm:
                rows[i] += match_rows[i][j + 1]
    return rows


def msa_column_maps(rows):
    """Per-row ``{residue_index: match_column}`` maps from a2m-style rows.

    The inverse view of :func:`paths_to_msa`'s convention: uppercase
    letters sit in match columns, ``-`` is a match column the sequence
    skips, lowercase letters and ``.`` are insertion positions (no
    column). Residue indices count ALL residues of the sequence
    (uppercase and lowercase), so the maps are comparable across
    alignments of the same sequences regardless of column layout.
    """
    maps = []
    for row in rows:
        col, res, m = 0, 0, {}
        for ch in row:
            if ch == "-":
                col += 1
            elif ch == ".":
                pass
            elif ch.isupper():
                m[res] = col
                res += 1
                col += 1
            else:  # lowercase insertion
                res += 1
        maps.append(m)
    return maps


def evaluate_msa(pred_rows, true_rows) -> dict:
    """Alignment accuracy of a predicted MSA against a planted truth.

    The learnMSA deliverable's quality metric: both alignments (same sequences, same order, any column layout) are
    reduced to aligned-residue-PAIR sets and scored like the standard
    SP/modeler pair (recall = sum-of-pairs score, precision = modeler
    score), plus the total-column (TC) score.

    Args:
      pred_rows / true_rows: equal-length lists of a2m-style rows
        (:func:`paths_to_msa` output or any alignment following the same
        uppercase/lowercase/gap convention).

    Returns:
      ``{"pairs": {tp, fp, fn, precision, recall, f1}, "column_score": c}``
      where pairs are ``((seq_i, res_i), (seq_j, res_j))`` co-aligned in a
      match column and ``column_score`` is the fraction of true columns
      (with ≥ 1 residue) whose exact residue set appears as a predicted
      column.
    """
    from .annotation import _metric_counts

    if len(pred_rows) != len(true_rows):
        raise ValueError(
            f"{len(pred_rows)} predicted rows vs {len(true_rows)} true rows"
        )

    def columns(rows):
        by_col = {}
        for i, m in enumerate(msa_column_maps(rows)):
            for res, col in m.items():
                by_col.setdefault(col, []).append((i, res))
        return by_col

    def pair_set(by_col):
        pairs = set()
        for members in by_col.values():
            for a in range(len(members)):
                for b in range(a + 1, len(members)):
                    pairs.add((members[a], members[b]))
        return pairs

    pred_cols, true_cols = columns(pred_rows), columns(true_rows)
    metrics = _metric_counts(pair_set(pred_cols), pair_set(true_cols))
    pred_sets = {frozenset(v) for v in pred_cols.values()}
    true_sets = [frozenset(v) for v in true_cols.values() if v]
    column_score = (
        sum(1 for c in true_sets if c in pred_sets) / len(true_sets)
        if true_sets
        else 0.0
    )
    return {"pairs": metrics, "column_score": column_score}


def write_msa(path, names, rows, width: int = 80):
    """Write alignment rows (from :func:`paths_to_msa`) as aligned FASTA.

    Counterpart of :func:`hmm_layer_torch.data.read_fasta`; one record per
    sequence, wrapped at ``width`` characters.
    """
    if len(names) != len(rows):
        raise ValueError(f"{len(names)} names for {len(rows)} rows")
    with open(path, "w") as f:
        for name, row in zip(names, rows):
            f.write(f">{name}\n")
            for k in range(0, len(row), width):
                f.write(row[k : k + width] + "\n")
