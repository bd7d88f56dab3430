"""Train Dirichlet mixture priors of the profile-HMM family, on the PyTorch
port.

The workflow of ``examples/train_dirichlet_priors.py`` on
``hmm_layer_torch``, on the same synthetic data: an amino-acid mixture over
match emission columns and three transition mixtures (match/insert/delete
triples), each a :class:`hmm_layer_torch.models.DirichletMixture` fitted by
``torch.optim.Adam`` on ``DirichletMixture.loss`` (negative log-likelihood
plus the Dirichlet-process regulariser), initialised from a
``torch.Generator``.

The artifacts (``.npz`` in the JAX params' names, read back by
``models.load_mixture_model``) go to ``--out`` only — a new temporary
directory unless given. The priors the package loads by default are the
byte-identical copies in ``hmm_layer_torch/trained_priors/``; this script
never writes there.

Run: python examples/torch_train_dirichlet_priors.py [--steps 2000]
[--quick] [--out DIR] [--cpu] (the GPU unless ``--cpu``).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hmm_layer_torch.models import DirichletMixture  # noqa: E402
from hmm_layer_torch.models.dirichlet import save_mixture_model  # noqa: E402
from hmm_layer_torch.utils.substitution import lg_matrix  # noqa: E402

# (file name, component count) of each mixture, with its data.
PRIORS = (("amino_prior_9", 9), ("match_prior_1", 1), ("insert_prior_1", 1), ("delete_prior_1", 1))


def sample_amino_columns(rng, n):
    """Synthetic alignment-column AA distributions (20-dim).

    A mix of conserved columns (one dominant residue, sharp Dirichlet) and
    diffuse columns around the LG stationary frequencies — the two regimes
    real profile match columns fall into.
    """
    _, p_lg = lg_matrix()
    p_lg = np.asarray(p_lg, np.float64)
    p_lg = p_lg / p_lg.sum()
    cols = []
    for _ in range(n):
        if rng.uniform() < 0.6:
            # conserved: dominant residue drawn from background
            aa = rng.choice(20, p=p_lg)
            conc = rng.uniform(5.0, 40.0)
            alpha = 0.3 + 20.0 * p_lg
            alpha[aa] += conc
        else:
            # diffuse: background-shaped column
            conc = rng.uniform(2.0, 25.0)
            alpha = conc * 20.0 * p_lg + 0.2
        cols.append(rng.dirichlet(alpha))
    return np.clip(np.asarray(cols, np.float32), 1e-7, 1.0)


def sample_transition_triples(rng, n, kind):
    """Synthetic Plan7 transition distributions.

    match: (MM, MI, MD) — mostly continue, occasional gap open;
    insert: (IM, II) — insertions extend with moderate probability;
    delete: (DM, DD) — deletions similar.
    """
    out = []
    for _ in range(n):
        if kind == "match":
            gap = rng.beta(1.0, 12.0)  # gap-open mass
            mi = rng.uniform(0.2, 0.8)
            mean = np.asarray([1.0 - gap, gap * mi, gap * (1.0 - mi)])
        elif kind == "insert":
            ext = rng.beta(2.0, 3.0)  # insert-extend probability
            mean = np.asarray([1.0 - ext, ext])
        else:  # delete
            ext = rng.beta(2.0, 4.0)
            mean = np.asarray([1.0 - ext, ext])
        conc = rng.uniform(8.0, 60.0)
        out.append(rng.dirichlet(np.maximum(conc * mean, 0.05)))
    return np.clip(np.asarray(out, np.float32), 1e-7, 1.0)


def train_mixture(seed, data, num_components, steps, device, lr=0.05, log=print):
    model = DirichletMixture(
        num_components,
        data.shape[-1],
        use_dirichlet_process=True,
        number_of_examples=data.shape[0],
        generator=torch.Generator().manual_seed(seed),
    ).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    data = torch.as_tensor(data, device=device)
    for i in range(steps):
        opt.zero_grad()
        loss = model.loss(data, training=True)
        loss.backward()
        opt.step()
        if i % max(steps // 10, 1) == 0:
            log(f"  step {i}: loss {float(loss.detach()):.4f}")
    with torch.no_grad():
        log(f"  final: loss {float(model.loss(data, training=True)):.4f}")
    return model


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--samples", type=int, default=20000)
    parser.add_argument("--quick", action="store_true", help="tiny run for smoke tests")
    parser.add_argument("--out", default=None, help="output directory (default: a new temporary one)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    args = parser.parse_args(argv)
    if args.quick:
        args.steps, args.samples = 100, 500
    device = torch.device("cpu" if args.cpu else "cuda")
    out = args.out or tempfile.mkdtemp(prefix="torch_dirichlet_priors_")
    os.makedirs(out, exist_ok=True)

    rng = np.random.default_rng(42)
    data = {
        "amino_prior_9": sample_amino_columns(rng, args.samples),
        "match_prior_1": sample_transition_triples(rng, args.samples, "match"),
        "insert_prior_1": sample_transition_triples(rng, args.samples, "insert"),
        "delete_prior_1": sample_transition_triples(rng, args.samples, "delete"),
    }
    for i, (name, k) in enumerate(PRIORS):
        print(f"training {name} ({k} components, {data[name].shape[0]} samples)")
        model = train_mixture(i, data[name], k, args.steps, device)
        path = os.path.join(out, f"{name}.npz")
        save_mixture_model(path, model)
        with torch.no_grad():
            alpha = model.make_alpha().cpu().numpy()
            mix = model.make_mix().cpu().numpy()
        print(f"  saved {path}: alpha sums {np.sort(alpha.sum(-1))[:3]}..., mix {np.round(mix, 3)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
