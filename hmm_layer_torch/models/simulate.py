"""Generative simulation: HMM sequence rollouts and synthetic genomes (port
of ``hmm_layer_tpu/models/simulate.py``; NumPy only, the same draws from
the same ``np.random.Generator``).

* :func:`sample_hmm_sequences` — generative rollout of any (init, A, B)
  HMM (states from the transition chain, symbols from the emission rows),
  used to plant a true profile HMM whose sampled paths define the true
  alignment (scored by :func:`hmm_layer_torch.models.msa.evaluate_msa`).
* :func:`simulate_genome` — a synthetic annotated contig: multiple genes
  with introns on BOTH strands, grammar-consistent nucleotides (ATG start,
  stop codon, GT..AG introns, no in-frame stop codons inside exons) and
  noisy class probabilities mimicking an upstream network — the input of
  the Tiberius-style ``predict`` workflow, scored by
  :func:`hmm_layer_torch.models.annotation.evaluate_annotation`.
* :func:`simulate_embeddings` — per-position embeddings from a planted
  per-class Gaussian, for the ``emit_embeddings`` emission mode.

Everything here is host-side NumPy (data generation, not device compute).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .annotation import GeneFeature, flip_genes, genes_to_states

__all__ = [
    "sample_hmm_sequences",
    "simulate_genome",
    "simulate_embeddings",
    "SimulatedGenome",
]


def simulate_embeddings(
    rng,
    track,
    dim: int = 8,
    separation: float = 3.0,
    spread: float = 1.0,
    num_classes: int = 15,
    means=None,
):
    """Per-position embedding vectors from a planted per-class Gaussian.

    The Tiberius-style ``emit_embeddings`` mode scores
    upstream-network embedding vectors with a trainable MVN mixture per
    state; proving it needs data whose embeddings carry class signal by
    construction. Class ``k``'s embeddings are drawn
    ``N(mu_k, spread² I)`` with the ``mu_k`` isotropic random directions
    of norm ``separation`` — the ratio ``separation/spread`` sets how
    informative the embedding channel is (Bayes error falls with it).

    Args:
        rng: ``np.random.Generator``.
        track: ``(L,)`` int per-position class labels (e.g.
            :func:`~hmm_layer_torch.models.annotation.genes_to_states`).
        means: optional fixed ``(num_classes, dim)`` means — pass the
            training draw's means when generating held-out data.

    Returns:
        (embeddings ``(L, dim)`` float32, means ``(num_classes, dim)``).
    """
    if means is None:
        means = rng.normal(size=(num_classes, dim))
        means = (
            means
            / np.linalg.norm(means, axis=-1, keepdims=True)
            * separation
        )
    means = np.asarray(means, np.float32)
    track = np.asarray(track)
    emb = means[track] + spread * rng.normal(size=(len(track), dim))
    return emb.astype(np.float32), means


def sample_hmm_sequences(
    init, A, B, rng, num_seqs: int, max_len: int, terminal_state=None
):
    """Generative rollout of one HMM: ``num_seqs`` (path, symbols) pairs.

    Args:
      init: ``(q,)`` initial state distribution.
      A: ``(q, q)`` transition matrix.
      B: ``(q, s)`` per-state symbol distributions.
      rng: ``np.random.Generator``.
      num_seqs: number of sequences to sample.
      max_len: hard length cap per sequence.
      terminal_state: optional absorbing state; the rollout stops *before*
        emitting from it (profile-HMM TERMINAL semantics — its one-hot
        "symbol" is the padding sentinel, not sequence content).

    Returns:
      list of ``(path, symbols)`` int arrays (equal length per pair,
      ≤ ``max_len``).
    """
    init = np.asarray(init, np.float64)
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    q = A.shape[0]
    init = init / init.sum()
    rows = A / np.maximum(A.sum(-1, keepdims=True), 1e-30)
    emit = B / np.maximum(B.sum(-1, keepdims=True), 1e-30)
    out = []
    for _ in range(num_seqs):
        path, symbols = [], []
        s = rng.choice(q, p=init)
        for _ in range(max_len):
            if terminal_state is not None and s == terminal_state:
                break
            path.append(s)
            symbols.append(rng.choice(emit.shape[-1], p=emit[s]))
            s = rng.choice(q, p=rows[s])
        out.append((np.asarray(path, np.int64), np.asarray(symbols, np.int64)))
    return out


# ---------------------------------------------------------------------------
# Synthetic annotated genome (Tiberius-style ground truth)
# ---------------------------------------------------------------------------

_NT = "ACGT"
_STOPS = {"TAA", "TAG", "TGA"}
_COMP = str.maketrans("ACGTN", "TGCAN")


def _revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def _random_codons(rng, n):
    """``n`` random codons, none of them stop codons."""
    out = []
    while len(out) < n:
        c = "".join(_NT[i] for i in rng.integers(0, 4, 3))
        if c not in _STOPS:
            out.append(c)
    return out


def _make_gene(rng, num_exons, exon_codons, intron_len):
    """One gene in its own (forward) orientation at local offset 0.

    Returns ``(seq, GeneFeature)``; coding = ATG + random non-stop codons
    + stop, split into ``num_exons`` exon segments with GT..AG introns.
    """
    n_codons = max(int(exon_codons), 2 + 2 * num_exons)
    stop = sorted(_STOPS)[rng.integers(0, 3)]
    coding = "ATG" + "".join(_random_codons(rng, n_codons - 2)) + stop
    total = len(coding)
    # Split points: keep every exon >= 6 bases so no segment is both donor
    # and acceptor and START/STOP never touch an intron (grammar rules).
    if num_exons > 1:
        while True:
            cuts = np.sort(rng.integers(6, total - 6, size=num_exons - 1))
            if len(cuts) == len(set(cuts)) and np.all(np.diff(cuts) >= 6):
                break
        bounds = [0, *cuts.tolist(), total]
    else:
        bounds = [0, total]

    seq_parts, cds, introns = [], [], []
    pos = 0  # local contig coordinate
    for k in range(num_exons):
        seg = coding[bounds[k] : bounds[k + 1]]
        cp = bounds[k] % 3  # codon position of the segment's first base
        cds.append((pos, pos + len(seg), (3 - cp) % 3))
        seq_parts.append(seg)
        pos += len(seg)
        if k < num_exons - 1:
            ilen = max(int(intron_len), 4)
            mid = "".join(_NT[i] for i in rng.integers(0, 4, ilen - 4))
            seq_parts.append("GT" + mid + "AG")
            introns.append((pos, pos + ilen))
            pos += ilen
    gene = GeneFeature(start=0, end=pos, cds=cds, introns=introns)
    return "".join(seq_parts), gene


def _shift(gene: GeneFeature, offset: int) -> GeneFeature:
    return GeneFeature(
        start=gene.start + offset,
        end=gene.end + offset,
        cds=[(s + offset, e + offset, p) for s, e, p in gene.cds],
        introns=[(s + offset, e + offset) for s, e in gene.introns],
        copy=gene.copy,
        partial_5p=gene.partial_5p,
        partial_3p=gene.partial_3p,
        strand=gene.strand,
    )


@dataclass
class SimulatedGenome:
    """Ground-truth bundle from :func:`simulate_genome`.

    ``genes`` are in forward-contig coordinates (strand ``+``/``-``);
    ``class_probs`` / ``class_probs_rc`` are the noisy ``(L, 15)`` state
    probabilities of the forward and reverse-complement readings (the
    upstream-network outputs a Tiberius-style decoder consumes).
    """

    seq: str
    genes: list = field(default_factory=list)
    class_probs: np.ndarray | None = None
    class_probs_rc: np.ndarray | None = None

    @property
    def length(self) -> int:
        return len(self.seq)

    def onehot(self) -> np.ndarray:
        """(L, 5) one-hot ACGTN encoding."""
        idx = np.frombuffer(self.seq.encode(), np.uint8)
        table = np.full(256, 4, np.int64)
        for i, ch in enumerate("ACGTN"[:4]):
            table[ord(ch)] = i
        return np.eye(5, dtype=np.float32)[table[idx]]


def simulate_genome(
    rng,
    num_genes: int = 6,
    mean_exons: float = 2.0,
    exon_codons: int = 24,
    intron_len: int = 30,
    intergenic_len: int = 120,
    noise: float = 0.3,
    both_strands: bool = True,
) -> SimulatedGenome:
    """Synthetic multi-gene contig with introns on both strands.

    Genes alternate strands when ``both_strands``; gene ``k`` is placed
    after an intergenic gap of ~``intergenic_len`` random bases. Class
    probabilities are a noisy one-hot of the true 15-state track of each
    strand reading: a ``noise/15`` uniform floor, plus ``1 - noise`` on
    the true class, plus i.i.d. ``Uniform(0, noise)`` per class,
    row-normalized (the same corruption model as the supervised-training
    tests), with minus-strand gene regions looking intergenic on the
    forward reading and vice versa — exactly the two-track input the
    Tiberius workflow feeds the HMM.
    """
    parts, placed = [], []  # sequence chunks; (strand, local_gene, offset)
    pos = 0
    for k in range(num_genes):
        gap = int(rng.integers(intergenic_len // 2, intergenic_len * 3 // 2))
        parts.append("".join(_NT[i] for i in rng.integers(0, 4, gap)))
        pos += gap
        n_ex = 1 + rng.poisson(max(mean_exons - 1.0, 0.0))
        seq_g, gene = _make_gene(rng, int(n_ex), exon_codons, intron_len)
        strand = "-" if (both_strands and k % 2 == 1) else "+"
        if strand == "+":
            parts.append(seq_g)
        else:
            parts.append(_revcomp(seq_g))
        placed.append((strand, gene, pos, len(seq_g)))
        pos += len(seq_g)
    tail = int(rng.integers(intergenic_len // 2, intergenic_len * 3 // 2))
    parts.append("".join(_NT[i] for i in rng.integers(0, 4, tail)))
    seq = "".join(parts)
    L = len(seq)

    genes = []
    for strand, gene, offset, glen in placed:
        if strand == "+":
            genes.append(_shift(gene, offset))
        else:
            # The gene reads forward in revcomp space at offset L-offset-glen;
            # flip_genes maps it back to forward coordinates with strand '-'.
            rc_feature = _shift(gene, L - offset - glen)
            genes.extend(flip_genes([rc_feature], L))
    genes.sort(key=lambda g: g.start)

    def _noisy_track(strand_genes):
        track = genes_to_states(strand_genes, L, num_states=15)
        probs = np.full((L, 15), noise / 15.0, np.float32)
        probs[np.arange(L), track] += 1.0 - noise
        probs += rng.uniform(0, noise, size=probs.shape).astype(np.float32)
        return probs / probs.sum(-1, keepdims=True)

    plus = [g for g in genes if g.strand == "+"]
    minus_fwd = []
    for g in genes:
        if g.strand == "-":
            (g_rc,) = flip_genes([g], L)  # involution -> revcomp space
            g_rc.strand = "+"
            minus_fwd.append(g_rc)
    return SimulatedGenome(
        seq=seq,
        genes=genes,
        class_probs=_noisy_track(plus),
        class_probs_rc=_noisy_track(minus_fwd),
    )
