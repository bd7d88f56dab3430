"""Command-line entry points of the port: ``python -m hmm_layer_torch
<command>``, with the JAX package's arguments and defaults
(``python -m hmm_layer_tpu <command>``).

* ``align`` — train profile HMMs on a protein FASTA, keep the best model,
  Viterbi-align every sequence and write an aligned FASTA (learnMSA's
  ``-i/-o`` usage), with optional length-adaptation rounds.
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

``align``, ``predict`` and ``train`` run on the GPU unless ``--cpu`` is
given, and raise where there is no GPU. Checkpoints are the ``.npz`` files
that both packages write (:mod:`~hmm_layer_torch.utils.checkpoint`). Heavy
imports happen inside the commands, so ``import hmm_layer_torch.cli``
initialises no CUDA.
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

    al = sub.add_parser(
        "align", help="train profile HMMs on a protein FASTA and align it"
    )
    al.add_argument("-i", "--input", required=True, help="protein FASTA")
    al.add_argument("-o", "--output", required=True, help="aligned FASTA out")
    al.add_argument("--models", type=int, default=3,
                    help="candidate model count trained jointly")
    al.add_argument("--steps", type=int, default=100, help="training steps")
    al.add_argument("--batch", type=int, default=32)
    al.add_argument("--lr", type=float, default=0.05)
    al.add_argument("--model-length", type=int, default=None,
                    help="match-state count (default: from sequence lengths)")
    al.add_argument("--adapt-rounds", type=int, default=0,
                    help="learnMSA-style length-adaptation rounds: after "
                         "each round, low-occupancy match columns are "
                         "discarded and overloaded insertion sites become "
                         "new columns (param-preserving resize), then "
                         "training continues")
    al.add_argument("--expand-threshold", type=float, default=None,
                    help="insert load (residues/seq) above which an "
                         "insertion site grows new match columns during "
                         "adaptation. Default: auto — 1.0 for short "
                         "models, 0.35 for model length >= 64")
    al.add_argument("--precision", choices=("high", "highest"),
                    default="high",
                    help="DP precision mode (set_dp_precision); on the GPU "
                         "both compute in IEEE float32")
    al.add_argument("--seed", type=int, default=0)
    al.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")

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


# ---------------------------------------------------------------- align


def _model_lengths(seq_lengths, n_models: int, override):
    """learnMSA-style candidate lengths around ~0.8 x the median residue
    count."""
    if override is not None:
        base = int(override)
    else:
        base = int(round(0.8 * float(sorted(seq_lengths)[len(seq_lengths) // 2])))
    base = max(base, 2)
    half = (n_models - 1) // 2
    return [max(2, base - half + i) for i in range(n_models)]


def _align(args) -> int:
    """``align`` under ``--precision``, the caller's DP precision mode
    restored when it returns (``main`` also runs in-process, from tests and
    examples; the JAX CLI exits its process instead)."""
    from .ops.recursion import dp_precision

    with dp_precision(args.precision):
        return _align_in_mode(args)


def _align_in_mode(args) -> int:
    import functools

    import numpy as np
    import torch

    from . import data
    from .layer import HMMLayer
    from .models import (
        ProfileEmissions,
        ProfileTransitions,
        adapt_profile_layer,
        paths_to_msa,
        write_msa,
    )
    from .training import Trainer

    records = list(data.read_fasta(args.input))
    if not records:
        print(f"error: no sequences in {args.input}", file=sys.stderr)
        return 2
    names = [name for name, _ in records]
    encoded = [data.encode_protein(seq) for _, seq in records]  # L+1 rows
    seq_lens = [e.shape[0] - 1 for e in encoded]

    m = max(1, args.models)
    lengths = _model_lengths(seq_lens, m, args.model_length)
    input_dim = encoded[0].shape[-1]
    layer = HMMLayer(
        ProfileTransitions(lengths, generator=torch.Generator().manual_seed(args.seed)),
        ProfileEmissions(lengths, input_dim=input_dim),
        use_prior=True,
        num_seqs=len(records),
        device="cpu" if args.cpu else None,
    )
    device = layer.device
    optimizer = functools.partial(torch.optim.Adam, lr=args.lr)
    trainer = Trainer(layer, optimizer=optimizer)
    padded = [torch.from_numpy(b).to(device) for b, _ in data.pad_batches(encoded, args.batch)]

    def batches(n_steps, n_models=None):
        """Cycle the padded batches, broadcast over the model axis."""
        n_models = m if n_models is None else n_models
        step = 0
        while step < n_steps:
            for batch in padded:
                if step >= n_steps:
                    return
                yield batch[None].expand((n_models,) + tuple(batch.shape))
                step += 1

    # One padded batch holding every sequence: the adaptation posteriors
    # and the final decode (alignment columns are global).
    L_max = max(e.shape[0] for e in encoded)
    full = np.zeros((len(encoded), L_max, input_dim), np.float32)
    full[:, :, -1] = 1.0  # terminal padding
    for i, e in enumerate(encoded):
        full[i, : e.shape[0]] = e
    full_t = torch.from_numpy(full).to(device)

    print(
        f"aligning {len(records)} sequences: training {m} profile "
        f"models (lengths {lengths}) for {args.steps} steps ..."
    )
    final_steps = args.steps
    # At most steps-1 rounds, so that adaptation never exceeds the step
    # budget; the final phase gets the exact remainder.
    adapt_rounds = min(args.adapt_rounds, max(0, args.steps - 1))
    if adapt_rounds > 0:
        phase = max(1, args.steps // (adapt_rounds + 1))
        final_steps = args.steps - adapt_rounds * phase
        for r in range(adapt_rounds):
            trainer.fit(batches(phase))
            expand = args.expand_threshold
            if expand is None:
                expand = 0.35 if max(layer.transitions.lengths) >= 64 else 1.0
            layer, info = adapt_profile_layer(
                layer,
                full_t[None].expand((m,) + tuple(full_t.shape)),
                torch.Generator().manual_seed(args.seed + 1 + r),
                expand_threshold=expand,
            )
            lengths = layer.transitions.lengths
            print(
                f"adaptation round {r + 1}: lengths "
                f"{[d['old_length'] for d in info]} -> {lengths}"
            )
            trainer = Trainer(layer, optimizer=optimizer)

    result = trainer.fit_select(
        batches(final_steps),
        score_batches=batches(max(1, len(records) // args.batch + 1)),
        keep=1,
    )
    best = int(result.ranking[0])
    print(
        "per-model held-out loglik:",
        np.round(np.asarray(result.scores), 3),
        f"-> selected model {best} (length {lengths[best]})",
    )

    paths = result.layer.viterbi(full_t[None])[0].cpu().numpy()
    residues = np.argmax(full, axis=-1)
    rows = paths_to_msa(
        paths, residues, model_length=lengths[best], seq_lengths=np.asarray(seq_lens)
    )
    write_msa(args.output, names, rows)
    print(f"wrote {len(rows)} aligned rows ({len(rows[0])} columns) to {args.output}")
    return 0


# -------------------------------------------------------- gene-pred shared


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


def decode_contig(viterbi_fn, enc, cls, window: int, batch: int, overlap: int, device=None):
    """The decoded state track (L,) int32 of one encoded contig.

    ``viterbi_fn`` maps inputs (1, batch, window, 20) to paths
    (1, batch, window) (``HMMLayer.viterbi``); windows overlap by
    ``overlap`` positions and each later window's first ``overlap``
    positions are taken from the window before it. The windows and their
    padding are those of :func:`~hmm_layer_torch.data.window_batches`, with
    the class probabilities ``cls`` (L, 15) before the nucleotides ``enc``
    (L, 5) and a uniform class row past the contig's end. Each batch's
    inputs are put together on ``device`` (CUDA where there is a GPU, else
    the CPU, when ``None``): the batch's contiguous rows are copied there
    once and its overlapping windows cut from them as a strided view.
    Under a profiler each batch opens the spans ``hmm.predict.windows``
    (building its inputs) with the child ``hmm.predict.upload`` (the rows'
    copy to ``device``), ``hmm.predict.decode`` (``viterbi_fn`` and the
    paths' copy to the host) and ``hmm.predict.stitch``.
    """
    import numpy as np
    import torch

    from .utils.profiling import span

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    L = enc.shape[0]
    track = np.zeros(L, np.int32)
    if L == 0:
        return track
    stride = window - overlap
    all_starts = range(0, max(L - overlap, 1), stride)
    rows = (batch - 1) * stride + window
    pad = torch.tensor([1.0 / 15.0] * 15 + [0.0] * 5, dtype=torch.float32, device=device)
    for b0 in range(0, len(all_starts), batch):
        with span("hmm.predict.windows"):
            starts = list(all_starts[b0 : b0 + batch])
            real, st0 = len(starts), starts[0]
            n = min(L - st0, rows)
            buf = torch.empty((rows, 20), dtype=torch.float32, device=device)
            buf[n:] = pad
            with span("hmm.predict.upload"):
                buf[:n, :15] = torch.from_numpy(np.ascontiguousarray(cls[st0 : st0 + n], np.float32))
                buf[:n, 15:] = torch.from_numpy(np.ascontiguousarray(enc[st0 : st0 + n], np.float32))
            x = buf.as_strided((batch, window, 20), (stride * 20, 20, 1)).contiguous()
            x[real:] = pad  # fill windows are all padding; their view reaches the tail's rows
            starts += [-1] * (batch - real)
        with span("hmm.predict.decode"):
            paths = np.asarray(viterbi_fn(x[None])[0].cpu())
        with span("hmm.predict.stitch"):
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
        return decode_contig(layer.viterbi, enc, cls, window, args.batch, overlap, device=layer.device)

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
    if args.command == "align":
        return _align(args)
    if args.command == "predict":
        return _predict(args)
    if args.command == "train":
        return _train(args)
    if args.command == "evaluate":
        return _evaluate(args)
    raise AssertionError(args.command)


if __name__ == "__main__":
    sys.exit(main())
