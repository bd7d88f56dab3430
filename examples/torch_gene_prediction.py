"""End-to-end gene prediction over a FASTA file, on the PyTorch port.

The workflow of ``examples/gene_prediction.py`` on ``hmm_layer_torch``:

1. read contigs from FASTA (``hmm_layer_torch.data``),
2. encode nucleotides and produce per-position class probabilities (here a
   stub standing in for the upstream neural network),
3. window long contigs into fixed-shape batches,
4. decode the Viterbi path with the chunked engine (``HMMLayer``; on a GPU
   its CUDA kernels),
5. stitch window decodes into per-contig state tracks and report exon/intron
   intervals.

Run: python examples/torch_gene_prediction.py [fasta] [--window 1024]
[--batch 8] [--cpu] (with no FASTA a small random one is synthesized; the
GPU unless ``--cpu``).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hmm_layer_torch import HMMLayer, data  # noqa: E402
from hmm_layer_torch.models import GenePredEmissions, GenePredTransitions  # noqa: E402

STATE_NAMES = [
    "Ir", "I0", "I1", "I2", "E0", "E1", "E2",
    "START", "EI0", "EI1", "EI2", "IE0", "IE1", "IE2", "STOP",
]


def build_layer(parallel_factor: int, device, seed: int = 0) -> HMMLayer:
    emitter = GenePredEmissions(
        start_codons=[("ATG", 1.0)],
        stop_codons=[("TAG", 0.34), ("TAA", 0.33), ("TGA", 0.33)],
        intron_begin_pattern=[("NGT", 0.99), ("NGC", 0.005), ("NAT", 0.005)],
        intron_end_pattern=[("AGN", 0.99), ("ACN", 0.01)],
    )
    layer = HMMLayer(GenePredTransitions(), emitter, use_prior=False, parallel_factor=parallel_factor, device=device)
    layer.reset_parameters(torch.Generator().manual_seed(seed), input_dim=15)
    return layer.to(device)


def class_probabilities(nucs: np.ndarray) -> np.ndarray:
    """Stub for the upstream class-prediction network.

    Real deployments feed the 15 per-position class probabilities of a
    sequence model (e.g. Tiberius' CNN-LSTM); here a fixed mostly-intergenic
    prior keeps the example self-contained.
    """
    b, L = nucs.shape[:2]
    probs = np.full((b, L, 15), 0.02, np.float32)
    probs[..., 0] = 0.72  # intergenic prior
    return probs


@torch.inference_mode()
def decode_contig(layer, encoded, window, batch, overlap=0):
    """Viterbi-decode one contig through fixed windows; returns (L,) states."""
    L = encoded.shape[0]
    track = np.zeros(L, np.int32)
    for wins, starts in data.window_batches(encoded, window, batch, overlap):
        x = torch.as_tensor(np.concatenate([class_probabilities(wins), wins], axis=-1)[None], device=layer.device)
        paths = layer.viterbi(x)[0].cpu().numpy()  # (b, window)
        for i, st in enumerate(starts):
            if st < 0:
                continue
            end = min(st + window, L)
            # Keep the PREVIOUS window's decode in the overlap region — it
            # has left context there; this window's first `overlap`
            # positions restart from the initial distribution.
            lo = st + overlap if st > 0 else st
            track[lo:end] = paths[i, lo - st : end - st]
    return track


def intervals(track: np.ndarray):
    """Collapse a state track into (state_name, start, end) runs."""
    runs = []
    st = 0
    for t in range(1, len(track) + 1):
        if t == len(track) or track[t] != track[st]:
            runs.append((STATE_NAMES[track[st]], st, t))
            st = t
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("fasta", nargs="?", default=None)
    ap.add_argument("--window", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--parallel-factor", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")

    with tempfile.TemporaryDirectory(prefix="torch_gene_prediction_") as tmp:
        fasta = args.fasta
        if fasta is None:
            rng = np.random.default_rng(0)
            fasta = os.path.join(tmp, "synthetic.fa")
            with open(fasta, "w") as fh:
                fh.write(f">synthetic\n{''.join(rng.choice(list('ACGT'), size=4 * args.window))}\n")
            print(f"(no FASTA given — synthesized {fasta})")

        layer = build_layer(args.parallel_factor, device)
        for name, seq in data.read_fasta(fasta):
            track = decode_contig(layer, data.encode_dna(seq), args.window, args.batch)
            runs = intervals(track)
            coding = sum(e - s for st, s, e in runs if st.startswith("E"))
            print(f"{name}: L={len(seq)}, {len(runs)} state runs, {coding} coding positions")
            for state, s, e in runs[:10]:
                print(f"  {name}\t{state}\t{s}\t{e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
