"""Command-line entry point of the port: ``python -m hmm_layer_torch predict``.

``predict`` Viterbi-decodes DNA contigs through the 15-state gene-pred HMM
(optionally with upstream class probabilities and trained parameters) and
writes a GFF3 annotation, with the JAX package's arguments and defaults
(``python -m hmm_layer_tpu predict``). It runs on the GPU unless ``--cpu``
is given, and raises where there is no GPU. ``--params`` reads the
``.npz`` checkpoints that both packages write
(:mod:`~hmm_layer_torch.utils.checkpoint`).

The ``align``, ``train`` and ``evaluate`` commands are not ported yet
(ROADMAP Queue 1 items 8, 10, 12). Heavy imports happen inside the
commands, so ``import hmm_layer_torch.cli`` initialises no CUDA.
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main", "build_parser", "decode_contig"]

CODONS = dict(
    start_codons=[("ATG", 1.0)],
    stop_codons=[("TAG", 0.34), ("TAA", 0.33), ("TGA", 0.33)],
    intron_begin_pattern=[("NGT", 0.99), ("NGC", 0.005), ("NAT", 0.005)],
    intron_end_pattern=[("AGN", 0.99), ("ACN", 0.01)],
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="hmm_layer_torch",
        description="PyTorch/CUDA port of the differentiable HMM toolkit",
    )
    sub = ap.add_subparsers(dest="command", required=True)
    pr = sub.add_parser(
        "predict", help="annotate DNA contigs with the gene-prediction HMM"
    )
    pr.add_argument("-i", "--input", required=True, help="DNA FASTA")
    pr.add_argument("-o", "--output", required=True, help="GFF3 out")
    pr.add_argument("--class-probs", default=None,
                    help=".npz of per-contig (L, 15) class probabilities "
                         "from an upstream network (keys = contig names; "
                         "'<name>__rc' keys score the reverse strand)")
    pr.add_argument("--both-strands", action="store_true",
                    help="also decode the reverse complement and report "
                         "minus-strand genes")
    pr.add_argument("--params", default=None,
                    help="trained parameter checkpoint (.npz) to load")
    pr.add_argument("--window", type=int, default=1024,
                    help="decode window length over long contigs")
    pr.add_argument("--overlap", type=int, default=64)
    pr.add_argument("--batch", type=int, default=8)
    pr.add_argument("--parallel-factor", type=int, default=8)
    pr.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    return ap


def _gene_pred_layer(parallel_factor: int, device=None):
    """The 15-state layer ``predict`` decodes with: biological codon
    patterns and a smoothed-identity class kernel, so upstream class
    probabilities pass through to the matching states."""
    from .layer import HMMLayer
    from .models import GenePredEmissions, GenePredTransitions
    from .models.initializers import make_15_class_emission_kernel

    return HMMLayer(
        GenePredTransitions(),
        GenePredEmissions(**CODONS, init=make_15_class_emission_kernel()),
        parallel_factor=parallel_factor,
        device=device,
    )


def _class_probs_fn(npz_path):
    """Loader: contig name + length -> (L, 15) class probabilities.

    Without an upstream network's output it returns a mostly-intergenic
    prior (codon structure and transition geometry then carve out genes).
    """
    import numpy as np

    class_npz = np.load(npz_path) if npz_path else None

    def load(name, L, required=True):
        if class_npz is not None:
            if name not in class_npz.files:
                if required:
                    raise KeyError(
                        f"contig {name!r} missing from {npz_path} "
                        f"(has {class_npz.files})"
                    )
            else:
                arr = np.asarray(class_npz[name], np.float32)
                if arr.shape != (L, 15):
                    raise ValueError(
                        f"class probs for {name!r} have shape {arr.shape}, "
                        f"expected {(L, 15)}"
                    )
                return arr
        probs = np.full((L, 15), 0.02, np.float32)
        probs[:, 0] = 0.72
        return probs

    return load


def _window_cls(cls, st, window):
    """Class probabilities of the window starting at ``st``, padded with a
    uniform row past the contig's end (and entirely for a fill window)."""
    import numpy as np

    if st < 0:
        return np.full((window, 15), 1.0 / 15.0, np.float32)
    chunk = cls[st : st + window]
    if chunk.shape[0] < window:
        pad = np.full((window - chunk.shape[0], 15), 1.0 / 15.0, np.float32)
        chunk = np.concatenate([chunk, pad])
    return chunk


def decode_contig(viterbi_fn, enc, cls, window: int, batch: int, overlap: int):
    """The decoded state track (L,) int32 of one encoded contig.

    ``viterbi_fn`` maps inputs (1, batch, window, 20) to paths
    (1, batch, window) (``HMMLayer.viterbi``); windows overlap by
    ``overlap`` positions and each later window's first ``overlap``
    positions are taken from the window before it.
    """
    import numpy as np

    from . import data

    L = enc.shape[0]
    track = np.zeros(L, np.int32)
    for wins, starts in data.window_batches(enc, window, batch, overlap):
        cls_win = np.stack([_window_cls(cls, st, window) for st in starts])
        x = np.concatenate([cls_win, wins], axis=-1)[None]
        paths = np.asarray(viterbi_fn(x)[0].cpu())
        for i, st in enumerate(starts):
            if st < 0:
                continue
            end = min(st + window, L)
            lo = st + overlap if st > 0 else st
            track[lo:end] = paths[i, lo - st : end - st]
    return track


def _predict(args) -> int:
    import torch

    from . import data
    from .models import flip_genes, paths_to_genes, write_gff3
    from .utils import checkpoint as ckpt

    # One window length for every contig (short contigs are padded by
    # window_batches), a multiple of the chunk parallel factor.
    pf = max(1, args.parallel_factor)
    window = max(pf, args.window - args.window % pf)
    overlap = min(args.overlap, window - 1)

    layer = _gene_pred_layer(pf, "cpu" if args.cpu else None)
    if args.params:
        ckpt.load_checkpoint(args.params, layer)
    class_probs_for = _class_probs_fn(args.class_probs)

    def decode(enc, cls):
        return decode_contig(layer.viterbi, enc, cls, window, args.batch, overlap)

    genes_by_seq = {}
    with torch.inference_mode():
        for name, enc in data.read_fasta_encoded(args.input):
            L = enc.shape[0]
            genes = paths_to_genes(decode(enc, class_probs_for(name, L)), num_states=15)
            if args.both_strands:
                cls_rc = class_probs_for(f"{name}__rc", L, required=False)
                track_rc = decode(data.revcomp_onehot(enc), cls_rc)
                genes = genes + flip_genes(paths_to_genes(track_rc, num_states=15), L)
                genes.sort(key=lambda g: g.start)
            genes_by_seq[name] = genes
            print(f"{name}: L={L}, {len(genes)} genes")
    n = write_gff3(genes_by_seq, args.output)
    print(f"wrote {n} genes to {args.output}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "predict":
        return _predict(args)
    raise AssertionError(args.command)


if __name__ == "__main__":
    sys.exit(main())
