"""learnMSA-style profile-HMM training workflow, end to end, on the PyTorch
port.

The workflow of ``examples/train_profile_msa.py`` on ``hmm_layer_torch``,
on the same synthetic protein-like data:

1. build n candidate profile models of different lengths (one per model on
   the engine's model axis), with Plan7 transitions + Dirichlet MAP priors,
   initialised from a ``torch.Generator``;
2. train them JOINTLY with the ``torch.optim`` Trainer (frozen insertions,
   metrics, periodic checkpoints);
3. rank the models by held-out log-likelihood and carve out the best one
   (``Trainer.fit_select``);
4. resume from the newest checkpoint (``utils.resilience``);
5. decode alignments of held-out sequences with the selected model
   (Viterbi state paths; match/insert/delete column labels).

Run: python examples/torch_train_profile_msa.py [--steps 30] [--cpu]
(the GPU unless ``--cpu``).
"""

from __future__ import annotations

import argparse
import copy
import functools
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hmm_layer_torch import HMMLayer, Trainer  # noqa: E402
from hmm_layer_torch.models import ProfileEmissions, ProfileTransitions, paths_to_msa  # noqa: E402
from hmm_layer_torch.utils import checkpoint as ckpt  # noqa: E402
from hmm_layer_torch.utils.resilience import latest_checkpoint  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--n-models", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--length", type=int, default=24)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")

    rng = np.random.default_rng(0)
    m, b, L = args.n_models, args.batch, args.length

    # Synthetic family: a conserved consensus with substitutions + indels.
    consensus = rng.integers(0, 20, size=12)

    def sample_sequence():
        seq = []
        for aa in consensus:
            r = rng.random()
            if r < 0.08:
                continue  # deletion
            seq.append(aa if rng.random() > 0.15 else rng.integers(0, 20))
            if rng.random() < 0.08:
                seq.append(rng.integers(0, 20))  # insertion
        while len(seq) < L:
            seq.append(rng.integers(0, 20))
        return seq[:L]

    def batch_onehot(n):
        idx = np.stack([sample_sequence() for _ in range(n)])
        x = torch.as_tensor(np.eye(26, dtype=np.float32)[idx], device=device)
        return x[None].expand(m, n, L, 26)

    lengths = [10, 12, 14][: args.n_models]
    layer = HMMLayer(ProfileTransitions(lengths), ProfileEmissions(lengths), use_prior=True, num_seqs=1000,
                     device=device)

    with tempfile.TemporaryDirectory(prefix="torch_profile_msa_") as ckpt_dir:
        trainer = Trainer(layer, optimizer=functools.partial(torch.optim.Adam, lr=5e-2),
                          checkpoint_dir=ckpt_dir, checkpoint_every=10)
        trainer.init(torch.Generator().manual_seed(0), input_dim=26)

        print(f"training {m} profile models (lengths {lengths}) jointly ...")
        result = trainer.fit_select(
            batches=(batch_onehot(b) for _ in range(args.steps)),
            score_batches=[batch_onehot(b)],
            keep=1,
            log_every=10,
        )
        best = int(result.ranking[0])
        print(f"held-out mean loglik per model: {np.round(result.scores, 2)}")
        print(f"selected model {best} (length {lengths[best]})")

        # Elastic recovery: resume the joint layer from the newest checkpoint.
        found = latest_checkpoint(ckpt_dir)
        if found:
            path, step = found
            ckpt.load_checkpoint(path, copy.deepcopy(trainer.layer))
            print(f"checkpoint resume ok: step {step} from {os.path.basename(path)}")

    # Decode held-out sequences with the selected single-model layer and
    # render the gapped alignment (match columns uppercase, deletions '-',
    # insertions lowercase padded with '.').
    x_test = batch_onehot(4)[best : best + 1]
    with torch.inference_mode():
        paths = result.layer.viterbi(x_test)[0].cpu().numpy()
    residues = np.argmax(x_test[0].cpu().numpy(), axis=-1)
    for i, row in enumerate(paths_to_msa(paths, residues, model_length=lengths[best])):
        print(f"seq {i}  {row}")
    print("done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
