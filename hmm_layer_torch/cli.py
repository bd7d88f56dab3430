"""Command-line entry points of the port: ``python -m hmm_layer_torch
<command>``, with the JAX package's arguments and defaults
(``python -m hmm_layer_tpu <command>``).

* ``predict`` — Viterbi-decode DNA contigs through the 15-state gene-pred
  HMM (optionally with upstream class probabilities and trained
  parameters) and write a GFF3 annotation.
* ``train`` — supervised training of the gene-pred HMM against a reference
  GFF3 (posterior cross-entropy on state labels from
  :func:`~hmm_layer_torch.models.annotation.genes_to_states`) or
  unsupervised MAP training; writes a parameter checkpoint that
  ``predict --params`` reads.
* ``evaluate`` — nucleotide/exon/gene precision, recall and F1 of one GFF3
  against another.

``predict`` and ``train`` run on the GPU unless ``--cpu`` is given, and
raise where there is no GPU. Checkpoints are the ``.npz`` files that both
packages write (:mod:`~hmm_layer_torch.utils.checkpoint`). The ``align``
command is not ported yet (ROADMAP Queue 1 items 10, 12). Heavy imports
happen inside the commands, so ``import hmm_layer_torch.cli`` initialises
no CUDA.
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

    tr = sub.add_parser(
        "train", help="train the gene-prediction HMM on annotated contigs"
    )
    tr.add_argument("-i", "--input", required=True, help="DNA FASTA")
    tr.add_argument("-a", "--annotation", default=None,
                    help="reference GFF3 (required for --objective ce)")
    tr.add_argument("-o", "--output", required=True,
                    help="parameter checkpoint out (.npz; predict --params "
                         "loads it)")
    tr.add_argument("--objective", choices=("ce", "map"), default="ce",
                    help="ce = posterior cross-entropy vs annotation labels "
                         "(supervised); map = maximum a-posteriori "
                         "log-likelihood (unsupervised)")
    tr.add_argument("--class-probs", default=None,
                    help=".npz of per-contig (L, 15) class probabilities "
                         "(keys = contig names)")
    tr.add_argument("--both-strands", action="store_true",
                    help="also train on reverse-complemented contigs "
                         "labeled from minus-strand genes")
    tr.add_argument("--resume", default=None,
                    help="parameter checkpoint to start from")
    tr.add_argument("--steps", type=int, default=200)
    tr.add_argument("--lr", type=float, default=0.01)
    tr.add_argument("--window", type=int, default=512)
    tr.add_argument("--overlap", type=int, default=0)
    tr.add_argument("--batch", type=int, default=8)
    tr.add_argument("--parallel-factor", type=int, default=8)
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")

    ev = sub.add_parser(
        "evaluate", help="score a predicted GFF3 against a reference GFF3"
    )
    ev.add_argument("--pred", required=True, help="predicted GFF3")
    ev.add_argument("--truth", required=True, help="reference GFF3")
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


def _training_windows(enc, cls, track, window, batch, overlap, device):
    """Supervised window batches of one (possibly reverse-complemented)
    encoded contig: ``{"x", "labels", "mask"}`` on ``device``, the mask 1
    on the contig's positions and 0 on padding and fill windows."""
    import numpy as np
    import torch

    from . import data

    L = enc.shape[0]
    enc = np.concatenate([cls, enc], axis=-1)
    out = []
    for wins, starts in data.window_batches(enc, window, batch, overlap):
        labels = np.zeros(wins.shape[:2], np.int32)
        mask = np.zeros(wins.shape[:2], np.float32)
        for i, st in enumerate(starts):
            if st < 0:
                continue
            n = min(st + window, L) - st
            mask[i, :n] = 1.0
            if track is not None:
                labels[i, :n] = track[st : st + n]
        out.append({
            key: torch.from_numpy(value[None]).to(device)
            for key, value in (("x", wins), ("labels", labels), ("mask", mask))
        })
    return out


def _train(args) -> int:
    if args.objective == "ce" and not args.annotation:
        print("error: --objective ce requires -a/--annotation", file=sys.stderr)
        return 2

    import functools

    import torch

    from . import data
    from .models import flip_genes, genes_to_states, read_gff3
    from .training import Trainer
    from .utils import checkpoint as ckpt

    pf = max(1, args.parallel_factor)
    window = max(pf, args.window - args.window % pf)
    overlap = min(args.overlap, window - 1)
    layer = _gene_pred_layer(pf, "cpu" if args.cpu else None)
    class_probs_for = _class_probs_fn(args.class_probs)
    annot = read_gff3(args.annotation) if args.annotation else {}

    def windows_of(name, enc, genes):
        L = enc.shape[0]
        track = None if genes is None else genes_to_states(genes, L, num_states=15)
        cls = class_probs_for(name, L, required=False)
        return _training_windows(enc, cls, track, window, args.batch, overlap, layer.device)

    batches, skipped_minus = [], 0
    for name, enc in data.read_fasta_encoded(args.input):
        L = enc.shape[0]
        plus = minus = None
        if args.objective == "ce":
            # Window-truncated intron-only fragments cannot be labeled;
            # complete annotations never contain them.
            plus = [g for g in annot.get(name, []) if g.strand == "+"]
            minus = flip_genes([g for g in annot.get(name, []) if g.strand == "-"], L)
            for g in minus:
                g.strand = "+"  # now in reverse-complement forward coordinates
            if minus and not args.both_strands:
                skipped_minus += len(minus)
        batches.extend(windows_of(name, enc, plus))
        if args.both_strands:
            batches.extend(windows_of(f"{name}__rc", data.revcomp_onehot(enc), minus))
    if not batches:
        print(f"error: no sequences in {args.input}", file=sys.stderr)
        return 2
    if skipped_minus:
        print(f"note: {skipped_minus} minus-strand genes ignored "
              "(pass --both-strands to train on them)")

    if args.objective == "ce":
        def loss_fn(batch, indices):
            return layer.posterior_cross_entropy(
                batch["x"], batch["labels"], label_mask=batch["mask"]
            )
    else:
        def loss_fn(batch, indices):
            return layer.loss(batch["x"])

    trainer = Trainer(
        layer, optimizer=functools.partial(torch.optim.Adam, lr=args.lr), loss_fn=loss_fn
    )
    trainer.init(args.seed, input_dim=15)
    if args.resume:
        ckpt.load_checkpoint(args.resume, layer)

    def cycle(n_steps):
        step = 0
        while True:
            for b in batches:
                if step >= n_steps:
                    return
                yield b
                step += 1

    print(f"training ({args.objective}) on {len(batches)} window batches "
          f"(window={window}, batch={args.batch}) for {args.steps} steps ...")
    loss = trainer.fit(cycle(args.steps))
    ckpt.save_checkpoint(args.output, layer, step=args.steps)
    print(f"final loss {float(loss):.4f}; wrote {args.output}")
    return 0


def _evaluate(args) -> int:
    import json

    from .models import evaluate_annotation, read_gff3

    metrics = evaluate_annotation(read_gff3(args.pred), read_gff3(args.truth))
    print(json.dumps(metrics, indent=2))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "predict":
        return _predict(args)
    if args.command == "train":
        return _train(args)
    if args.command == "evaluate":
        return _evaluate(args)
    raise AssertionError(args.command)


if __name__ == "__main__":
    sys.exit(main())
