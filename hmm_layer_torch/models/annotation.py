"""Gene-structure annotation (GFF3) from gene-prediction Viterbi paths
(port of ``hmm_layer_tpu/models/annotation.py``; NumPy only, unchanged in
what it computes).

The gene-pred model family's deliverable is a genome annotation: the most
likely state path through the 15-state grammar mapped to gene, CDS and
intron intervals, as :meth:`~hmm_layer_torch.layer.HMMLayer.viterbi`
decodes it.

State semantics (from the grammar and the codon-pattern pivots in
:mod:`~hmm_layer_torch.models.gene_pred_emissions`):

* ``Ir`` — intergenic.
* ``I0-2`` — intron positions (phase = codon position interrupted).
* ``E0-2`` — exon position at codon position 0/1/2.
* ``START`` — first base of the start codon (left-pivot ``ATG`` window).
* ``EI0-2`` — LAST exon base before an intron (the left-pivot ``NGT``
  donor window constrains the two FOLLOWING bases); codon position
  ``(i+1) % 3``.
* ``IE0-2`` — FIRST exon base after an intron (the right-pivot ``AGN``
  acceptor window constrains the two PRECEDING bases); codon position
  ``(i+2) % 3``.
* ``STOP`` — last base of the stop codon (right-pivot stop window).

Coding positions are therefore ``{START, E*, EI*, IE*, STOP}`` and intron
positions are the ``I*`` runs between an ``EI``/``IE`` pair. GFF3 ``phase``
is computed from the codon position of a CDS segment's first base
(``phase = (3 - codon_pos) % 3``).

Both gene-pred grammars are supported: the 15-state / ``1+14k``-state
family and the 7-state / ``1+6k``-state simple family (no START/EI/IE/STOP
states; every coding state is an ``E``). Windows decoded at an offset into
a longer contig pass ``offset`` so coordinates land in contig space.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "GeneFeature",
    "classify_states",
    "flip_genes",
    "paths_to_genes",
    "genes_to_states",
    "genes_to_gff3",
    "write_gff3",
    "read_gff3",
    "evaluate_annotation",
]

# Row indices of the classification table.
INTERGENIC, INTRON, EXON, START, EI, IE, STOP = range(7)
_KIND_NAMES = ("Ir", "I", "E", "START", "EI", "IE", "STOP")


def classify_states(num_states: int, simple: bool | None = None):
    """Per-state ``(kind, codon_pos, copy)`` tables for a gene-pred grammar.

    Args:
      num_states: ``1 + 14k`` (full grammar) or ``1 + 6k`` (simple grammar).
      simple: force the simple grammar; by default inferred from
        ``num_states`` (``1+6k`` vs ``1+14k`` are ambiguous only at
        ``k≡0 (mod 7)`` multiples where both parse — there the full grammar
        wins and ``simple=True`` must be passed explicitly).

    Returns:
      ``(kind, codon_pos, copy)`` int arrays of shape ``(num_states,)``.
      ``codon_pos`` is -1 for non-coding states; for introns it carries the
      interrupted phase instead.
    """
    if simple is None:
        simple = (num_states - 1) % 14 != 0
    div = 6 if simple else 14
    if num_states < 1 + div or (num_states - 1) % div != 0:
        raise ValueError(
            f"num_states={num_states} is not 1+{div}k for any k >= 1"
        )
    k = (num_states - 1) // div
    kind = np.full(num_states, INTERGENIC, np.int32)
    codon_pos = np.full(num_states, -1, np.int32)
    copy = np.zeros(num_states, np.int32)

    def block(start, knd, pos_of):
        """Three k-wide phase blocks starting at ``start``."""
        for phase in range(3):
            sl = slice(start + phase * k, start + (phase + 1) * k)
            kind[sl] = knd
            codon_pos[sl] = pos_of(phase)
            copy[sl] = np.arange(k)

    block(1, INTRON, lambda i: i)
    block(1 + 3 * k, EXON, lambda i: i)
    if not simple:
        kind[1 + 6 * k : 1 + 7 * k] = START
        codon_pos[1 + 6 * k : 1 + 7 * k] = 0
        copy[1 + 6 * k : 1 + 7 * k] = np.arange(k)
        block(1 + 7 * k, EI, lambda i: (i + 1) % 3)
        block(1 + 10 * k, IE, lambda i: (i + 2) % 3)
        kind[1 + 13 * k :] = STOP
        codon_pos[1 + 13 * k :] = 2
        copy[1 + 13 * k :] = np.arange(k)
    return kind, codon_pos, copy


@dataclass
class GeneFeature:
    """One predicted gene: CDS segments and introns in contig coordinates.

    Coordinates are 0-based half-open internally; :func:`genes_to_gff3`
    renders the 1-based inclusive GFF3 convention. ``partial_5p`` /
    ``partial_3p`` flag genes truncated by the window (no START seen /
    no STOP seen).
    """

    start: int
    end: int
    cds: list = field(default_factory=list)  # [(start, end, phase)]
    introns: list = field(default_factory=list)  # [(start, end)]
    copy: int = 0
    partial_5p: bool = False
    partial_3p: bool = False
    strand: str = "+"


def paths_to_genes(
    path,
    num_states: int | None = None,
    offset: int = 0,
    length: int | None = None,
    simple: bool | None = None,
) -> list[GeneFeature]:
    """Extract gene structures from ONE decoded state path.

    Args:
      path: ``(L,)`` int array of Viterbi states (gene-pred state order).
      num_states: grammar size; default ``max(path) + 1`` rounded up to a
        valid ``1+14k`` (pass explicitly for small windows that never visit
        the last states).
      offset: contig coordinate of ``path[0]``.
      length: true (unpadded) window length; positions beyond it are
        ignored.
      simple: see :func:`classify_states`.

    Returns:
      list of :class:`GeneFeature`, in order of genomic start. A gene is a
      maximal run of non-intergenic states; its CDS segments are maximal
      runs of coding states, its introns the ``I`` runs between them.
    """
    path = np.asarray(path)
    if path.ndim != 1:
        raise ValueError(f"path must be 1-D, got shape {path.shape}")
    if length is not None:
        path = path[: int(length)]
    if num_states is None:
        hi = int(path.max(initial=0))
        num_states = 1 + 14 * max(1, -(-hi // 14))  # round up to 1+14k
    kind_tab, pos_tab, copy_tab = classify_states(num_states, simple=simple)
    kinds = kind_tab[path]
    genic = kinds != INTERGENIC
    if not genic.any():
        return []
    # Boundaries of maximal genic runs.
    edges = np.flatnonzero(np.diff(genic.astype(np.int8)))
    starts = ([0] if genic[0] else []) + list(edges[~genic[edges]] + 1)
    ends = list(edges[genic[edges]] + 1) + ([len(path)] if genic[-1] else [])

    genes = []
    coding = (kinds == EXON) | (kinds == START) | (kinds == EI) | \
        (kinds == IE) | (kinds == STOP)
    for g0, g1 in zip(starts, ends):
        gene = GeneFeature(
            start=offset + g0,
            end=offset + g1,
            copy=int(copy_tab[path[g0]]),
            partial_5p=kind_tab[path[g0]] != START,
            partial_3p=kind_tab[path[g1 - 1]] != STOP,
        )
        in_cds = coding[g0:g1]
        if not in_cds.any():  # window truncated inside an intron
            gene.introns.append((offset + g0, offset + g1))
            genes.append(gene)
            continue
        e = np.flatnonzero(np.diff(in_cds.astype(np.int8)))
        c_starts = ([0] if in_cds[0] else []) + list(e[~in_cds[e]] + 1)
        c_ends = list(e[in_cds[e]] + 1) + ([g1 - g0] if in_cds[-1] else [])
        for c0, c1 in zip(c_starts, c_ends):
            cp = int(pos_tab[path[g0 + c0]])
            phase = 0 if cp < 0 else (3 - cp) % 3
            gene.cds.append((offset + g0 + c0, offset + g0 + c1, phase))
        for i0, i1 in zip(c_ends[:-1], c_starts[1:]):
            gene.introns.append((offset + g0 + i0, offset + g0 + i1))
        # Intron runs touching the gene boundary (possible only for
        # window-truncated genes) are kept out of cds but recorded too.
        if c_starts and c_starts[0] > 0:
            gene.introns.insert(0, (offset + g0, offset + g0 + c_starts[0]))
        if c_ends and c_ends[-1] < g1 - g0:
            gene.introns.append((offset + g0 + c_ends[-1], offset + g1))
        genes.append(gene)
    return genes


def flip_genes(genes, contig_length: int) -> list[GeneFeature]:
    """Map genes decoded on a REVERSE-COMPLEMENTED contig back to forward
    coordinates (strand ``-``).

    The decoder sees the reverse complement, so a feature at revcomp
    half-open ``[s, e)`` sits at forward ``[Lc - e, Lc - s)``. GFF3 phase
    for minus-strand CDS is counted from the feature's strand-wise start
    (the higher forward coordinate) — exactly the phase already computed in
    revcomp space, so phases carry over unchanged. 5'/3' partial flags
    refer to the gene's own orientation and carry over too.
    """
    out = []
    for g in genes:
        Lc = int(contig_length)
        out.append(
            GeneFeature(
                start=Lc - g.end,
                end=Lc - g.start,
                cds=[(Lc - e, Lc - s, p) for s, e, p in reversed(g.cds)],
                introns=[(Lc - e, Lc - s) for s, e in reversed(g.introns)],
                copy=g.copy,
                partial_5p=g.partial_5p,
                partial_3p=g.partial_3p,
                strand="-",
            )
        )
    out.sort(key=lambda g: g.start)
    return out


def genes_to_states(
    genes,
    length: int,
    num_states: int = 15,
    offset: int = 0,
    simple: bool | None = None,
) -> np.ndarray:
    """Render gene structures back into a gene-pred STATE track — the exact
    inverse of :func:`paths_to_genes`.

    This is the label-generation step of supervised gene-prediction
    training: reference annotations become per-position state targets for
    a cross-entropy loss on the HMM posterior. The emitted track is always
    a *valid path* of the transition grammar
    (:class:`~hmm_layer_torch.models.gene_pred_transitions.GenePredTransitions`
    edge set).

    Args:
      genes: iterable of :class:`GeneFeature` on the **forward** strand of
        the coordinate system being labeled. Minus-strand genes must first
        be mapped to reverse-complement space with :func:`flip_genes`
        (an involution) and rendered against the reverse-complemented
        contig; passing a ``strand == "-"`` feature here raises.
      length: track length (window or contig).
      num_states: grammar size (``1+14k`` full / ``1+6k`` simple).
      offset: contig coordinate of track position 0.
      simple: see :func:`classify_states`.

    Returns:
      ``(length,)`` int32 state track (intergenic everywhere outside
      genes).

    Raises:
      ValueError: if a gene is inconsistent with the grammar (CDS phases
        that do not chain, a complete gene whose coding length is not a
        codon multiple, a 1-base CDS segment that would need to be both
        donor and acceptor, or an intron-only fragment whose phase is
        unknowable).
    """
    if simple is None:
        simple = (num_states - 1) % 14 != 0
    kind_tab, pos_tab, copy_tab = classify_states(num_states, simple=simple)
    state_of = {}
    for s in range(num_states):
        state_of[(int(kind_tab[s]), int(pos_tab[s]), int(copy_tab[s]))] = s
    k = int(copy_tab.max()) + 1

    track = np.zeros(int(length), np.int32)

    def put(pos, kind, codon_pos, copy):
        i = pos - offset
        if 0 <= i < len(track):
            track[i] = state_of[(kind, codon_pos, copy)]

    for g in genes:
        if getattr(g, "strand", "+") != "+":
            raise ValueError(
                "genes_to_states labels forward-strand coordinates; map "
                "minus-strand genes into reverse-complement space with "
                "flip_genes() and label the reverse-complemented contig"
            )
        copy = int(g.copy)
        if not 0 <= copy < k:
            raise ValueError(f"gene copy {copy} out of range for k={k}")
        cds = sorted(g.cds)
        introns = sorted(g.introns)
        if not cds:
            raise ValueError(
                f"gene [{g.start}, {g.end}) has introns but no CDS — its "
                "intron phase is unknowable; drop window-truncated "
                "fragments before labeling"
            )
        intron_starts = {s for s, _ in introns}
        intron_ends = {e for _, e in introns}

        # Codon positions chain across segments (introns do not consume
        # codon positions); each segment's recorded phase must agree.
        cp = (3 - int(cds[0][2])) % 3
        first_base = cds[0][0]
        last_base = cds[-1][1] - 1
        for s, e, phase in cds:
            if (3 - int(phase)) % 3 != cp:
                raise ValueError(
                    f"CDS phase {phase} at [{s}, {e}) does not chain with "
                    "the preceding segments (introns preserve codon "
                    "position)"
                )
            for pos in range(s, e):
                donor = pos == e - 1 and e in intron_starts
                acceptor = pos == s and s in intron_ends
                if donor and acceptor:
                    raise ValueError(
                        f"1-base CDS segment at {pos} is both intron donor "
                        "and acceptor — no such state in the grammar"
                    )
                if pos == first_base and not g.partial_5p and not simple:
                    if cp != 0:
                        raise ValueError(
                            "complete gene does not start at codon "
                            f"position 0 (got {cp})"
                        )
                    if donor:
                        raise ValueError(
                            "START immediately followed by an intron is "
                            "not in the grammar (START -> E1 only)"
                        )
                    put(pos, START, 0, copy)
                elif pos == last_base and not g.partial_3p and not simple:
                    if cp != 2:
                        raise ValueError(
                            "complete gene does not end at codon position "
                            f"2 (got {cp}; coding length must be a codon "
                            "multiple)"
                        )
                    if acceptor:
                        raise ValueError(
                            "STOP immediately preceded by an intron is "
                            "not in the grammar (IE -> E only)"
                        )
                    put(pos, STOP, 2, copy)
                elif donor and not simple:
                    put(pos, EI, cp, copy)
                elif acceptor and not simple:
                    put(pos, IE, cp, copy)
                else:
                    put(pos, EXON, cp, copy)
                cp = (cp + 1) % 3
        # Intron blocks are pinned by the flanking exon codon positions:
        # full grammar  E_i -> EI_i(pos i+1) -> I_i -> IE_i(pos i+2) -> E_i
        # simple        E_i(pos i) -> I_i -> E_{i+1}
        for s, e in introns:
            nxt = next((c for c in cds if c[0] == e), None)
            prv = next((c for c in cds if c[1] == s), None)
            if nxt is not None:
                cp_next = (3 - int(nxt[2])) % 3
                block = (cp_next + 1) % 3 if not simple else (cp_next + 2) % 3
            elif prv is not None:
                # Trailing intron of a window-truncated gene.
                seg_len = prv[1] - prv[0]
                cp_prev = ((3 - int(prv[2])) % 3 + seg_len - 1) % 3
                block = (cp_prev + 2) % 3 if not simple else cp_prev
            else:
                raise ValueError(
                    f"intron [{s}, {e}) touches no CDS segment of its gene"
                )
            for pos in range(s, e):
                put(pos, INTRON, block, copy)
    return track


def genes_to_gff3(
    genes,
    seqid: str,
    source: str = "hmm_layer_torch",
    gene_prefix: str = "gene",
    start_index: int = 1,
) -> list[str]:
    """Render :class:`GeneFeature` records as GFF3 lines (no header)."""
    lines = []
    for n, g in enumerate(genes, start=start_index):
        gid = f"{gene_prefix}{n}"
        attrs = [f"ID={gid}"]
        if g.copy:
            attrs.append(f"copy={g.copy}")
        if g.partial_5p:
            attrs.append("partial_5p=true")
        if g.partial_3p:
            attrs.append("partial_3p=true")

        def row(ftype, s, e, phase=".", parent=None, fid=None):
            a = []
            if fid:
                a.append(f"ID={fid}")
            if parent:
                a.append(f"Parent={parent}")
            return (
                f"{seqid}\t{source}\t{ftype}\t{s + 1}\t{e}\t.\t{g.strand}\t"
                f"{phase}\t" + ";".join(a or attrs)
            )

        lines.append(row("gene", g.start, g.end))
        lines.append(
            row("mRNA", g.start, g.end, parent=gid, fid=f"{gid}.t1")
        )
        for s, e, phase in g.cds:
            lines.append(row("CDS", s, e, phase=phase, parent=f"{gid}.t1"))
        for s, e in g.introns:
            lines.append(row("intron", s, e, parent=f"{gid}.t1"))
    return lines


def write_gff3(genes_by_seq, path, source: str = "hmm_layer_torch"):
    """Write ``{seqid: [GeneFeature, ...]}`` to a GFF3 file."""
    n = 0
    with open(path, "w") as fh:
        fh.write("##gff-version 3\n")
        for seqid, genes in genes_by_seq.items():
            for line in genes_to_gff3(
                genes, seqid, source=source, start_index=n + 1
            ):
                fh.write(line + "\n")
            n += len(genes)
    return n


def read_gff3(path) -> dict:
    """Parse a GFF3 file into ``{seqid: [GeneFeature, ...]}``.

    The inverse of :func:`write_gff3`, tolerant enough for external
    annotations (the supervised-training input): ``gene`` rows open a
    feature; ``CDS`` rows attach via ``Parent`` (through an ``mRNA``
    indirection or directly to the gene — only the first transcript of a
    gene is kept); explicit ``intron`` rows are honored, otherwise introns
    are derived from the gaps between CDS segments. Unknown feature types
    and other seq regions pass through silently. Coordinates convert from
    1-based inclusive to the 0-based half-open convention of
    :class:`GeneFeature`.
    """

    def attr_map(field):
        out = {}
        for part in field.strip().split(";"):
            if "=" in part:
                key, val = part.split("=", 1)
                out[key.strip()] = val.strip()
        return out

    genes = {}  # gene ID -> (seqid, GeneFeature, transcript_id | None)
    order = []  # (seqid, gene_id) in file order
    mrna_parent = {}  # transcript ID -> gene ID
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            cols = line.split("\t")
            if len(cols) != 9:
                continue
            seqid, _src, ftype, s, e, _score, strand, phase, attrs = cols
            s, e = int(s) - 1, int(e)  # -> 0-based half-open
            a = attr_map(attrs)
            if ftype == "gene":
                gid = a.get("ID", f"gene{len(genes) + 1}")
                genes[gid] = (
                    seqid,
                    GeneFeature(
                        start=s,
                        end=e,
                        copy=int(a.get("copy", 0)),
                        partial_5p=a.get("partial_5p") == "true",
                        partial_3p=a.get("partial_3p") == "true",
                        strand=strand if strand in "+-" else "+",
                    ),
                    None,
                )
                order.append((seqid, gid))
            elif ftype in ("mRNA", "transcript"):
                parent = a.get("Parent")
                if parent in genes:
                    mrna_parent[a.get("ID", parent + ".t")] = parent
            elif ftype in ("CDS", "intron"):
                parent = a.get("Parent", "")
                gid = mrna_parent.get(parent, parent)
                if gid not in genes:
                    continue
                seq_of, g, kept = genes[gid]
                if kept is None:
                    genes[gid] = (seq_of, g, parent)
                elif parent != kept:  # a second transcript: skip it
                    continue
                if ftype == "CDS":
                    g.cds.append((s, e, 0 if phase == "." else int(phase)))
                else:
                    g.introns.append((s, e))

    out = {}
    for seqid, gid in order:
        _, g, _ = genes[gid]
        g.cds.sort()
        g.introns.sort()
        if g.cds and not g.introns:
            g.introns = [
                (a_end, b_start)
                for (_, a_end, _), (b_start, _, _) in zip(g.cds, g.cds[1:])
                if b_start > a_end
            ]
        out.setdefault(seqid, []).append(g)
    return out


def _metric_counts(pred: set, true: set) -> dict:
    tp = len(pred & true)
    fp = len(pred - true)
    fn = len(true - pred)
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if precision + recall
        else 0.0
    )
    return {
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "precision": precision,
        "recall": recall,
        "f1": f1,
    }


def evaluate_annotation(pred_by_seq: dict, true_by_seq: dict) -> dict:
    """Burset–Guigó-style gene-prediction accuracy at three levels.

    Args:
      pred_by_seq / true_by_seq: ``{seqid: [GeneFeature, ...]}`` (e.g. from
        :func:`read_gff3` or :func:`paths_to_genes`).

    Returns:
      ``{"nucleotide": ..., "exon": ..., "gene": ...}``, each a dict of
      tp/fp/fn/precision/recall/f1. Nucleotide level counts coding bases;
      exon level counts exact CDS segments (coordinates AND phase must
      match); gene level counts genes whose full CDS structure matches
      exactly. Strands are compared separately (a minus-strand prediction
      never matches a plus-strand truth).
    """

    def collect(by_seq):
        nuc, exon, gene = set(), set(), set()
        for seqid, genes in by_seq.items():
            for g in genes:
                key = (seqid, g.strand)
                for s, e, phase in g.cds:
                    nuc.update((key, p) for p in range(s, e))
                    exon.add((key, s, e, int(phase)))
                gene.add((key, tuple(sorted(g.cds))))
        return nuc, exon, gene

    p_nuc, p_ex, p_gene = collect(pred_by_seq)
    t_nuc, t_ex, t_gene = collect(true_by_seq)
    return {
        "nucleotide": _metric_counts(p_nuc, t_nuc),
        "exon": _metric_counts(p_ex, t_ex),
        "gene": _metric_counts(p_gene, t_gene),
    }
