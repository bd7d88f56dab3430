"""Distributed training of a sparse (edge-list) multi-copy gene model over a
mesh of ranks, on the PyTorch port.

The workflow of ``examples/train_sparse_multichip.py`` on
``hmm_layer_torch`` over ``torch.distributed`` (one process per rank,
spawned by ``hmm_layer_torch.parallel.launch.run_world``: NCCL with one GPU
a rank, gloo under ``--cpu`` or when ranks share a GPU):

* data parallel — the SPEED lever: the batch split over a ``data`` axis,
  each rank running the sparse engine on its rows, the gradients summed;
* the edge-sharded state route of ``HMMLayer`` (``partition={"state":
  ...}``): the recursions' forward/backward variables and the Viterbi
  backpointers during the scan are split over the ranks' state blocks. The
  layer keeps the global convention: every rank holds the whole emission
  tensor and gets the gathered outputs, so the layer's route does NOT cut
  every O(L·q) tensor to 1/n per rank;
* the CAPACITY lever: the edge-sharded functions with ``local=True``. Each
  rank builds only its block of the emissions (``parallel.local_ranges``)
  and gets back only its block of log gamma, its rows' log-likelihoods and
  paths: every O(L·q) tensor of the call is 1/n per rank, but the decode's
  gather of its int32 backpointers.

Run: python examples/torch_train_sparse_multichip.py [--world 2] [--k 4]
[--cpu] (the GPU unless ``--cpu``; q = 1 + 14k, k = 36 is config 5).
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class RawEmissions(torch.nn.Module):
    """Pass-through emitter: the inputs ARE per-state emission
    probabilities (stand-in for an upstream network head)."""

    def reset_parameters(self, input_dim=None, generator=None):
        pass

    def emissions(self, inputs, end_hints=None, training=False):
        return inputs

    def prior_log_density(self):
        return torch.zeros(1)

    def aux_loss(self):
        return torch.zeros(())


def rank_main(k: int, length: int, steps: int, device: str):
    """One rank's run; returns its lines to print and its checks."""
    import torch.distributed as dist

    from hmm_layer_torch import HMMLayer, Trainer
    from hmm_layer_torch.models import GenePredMultiTransitions
    from hmm_layer_torch.parallel import (
        edge_sharded_log_likelihood,
        edge_sharded_posterior,
        edge_sharded_viterbi,
        local_ranges,
        make_mesh,
    )

    n, rank = dist.get_world_size(), dist.get_rank()
    if device == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    trans = GenePredMultiTransitions(k=k, sparse_forward=True)
    q = trans.num_states
    rng = np.random.default_rng(0)
    adam = functools.partial(torch.optim.Adam, lr=1e-2)
    lines = [f"{n} ranks ({dist.get_backend()}, {device}), q={q}, {trans.num_transitions} edges"]

    # ---- data-parallel MAP training ---------------------------------------
    layer = HMMLayer(trans, RawEmissions(), use_prior=False, device=device,
                     mesh=make_mesh({"data": n}), partition={"batch": "data"})
    trainer = Trainer(layer, optimizer=adam)
    trainer.init(torch.Generator().manual_seed(0))
    x = torch.as_tensor(rng.uniform(0.05, 1.0, (1, 4 * n, length, q)).astype(np.float32), device=device)
    loss = trainer.fit([x] * steps, log_every=1)
    lines.append(f"data-parallel MAP loss: {float(loss):.3f}")

    # ---- the layer's edge-sharded state route: training + decode ----------
    smesh = make_mesh({"state": n})
    slayer = HMMLayer(GenePredMultiTransitions(k=k, sparse_forward=True), RawEmissions(), use_prior=False,
                      device=device, mesh=smesh, partition={"state": "state"})  # q pads to a multiple of n
    strainer = Trainer(slayer, optimizer=adam)
    strainer.init(torch.Generator().manual_seed(1))
    xs_host = rng.uniform(0.05, 1.0, (1, 4, length, q)).astype(np.float32)
    xs = torch.as_tensor(xs_host, device=device)
    sloss = strainer.fit([xs] * max(steps - 2, 1), log_every=1)
    with torch.inference_mode():
        paths = slayer.viterbi(xs)
        ll_route = slayer.log_likelihood(xs)
    lines.append(f"edge-sharded MAP loss: {float(sloss):.3f}; decoded states span "
                 f"[{int(paths.min())}, {int(paths.max())}]")

    # ---- the capacity lever: rank-local blocks in and out -----------------
    # The rank builds only its block of E (here cut from host data) and
    # gets back only its block of log gamma; init and the edge
    # probabilities stay global.
    with torch.no_grad():
        indices, probs = slayer.transitions.make_A_sparse()
        init = slayer.transitions.make_initial_distribution()
    r = local_ranges(smesh, "edge", xs.shape)
    E_l = torch.as_tensor(xs_host[r.index], device=device).requires_grad_()
    lg_l, ll_l = edge_sharded_posterior(init, indices, probs, E_l, smesh, local=True)
    loss_l = -edge_sharded_log_likelihood(init, indices, probs, E_l, smesh, local=True).mean()
    (g_E,) = torch.autograd.grad(loss_l, [E_l])
    path_l = edge_sharded_viterbi(init, indices, probs, E_l.detach(), smesh, local=True)
    same = bool(torch.equal(ll_l.detach(), ll_route)) and bool(torch.equal(path_l, paths))
    lines.append(f"rank {rank} local mode: E block {tuple(E_l.shape)} of {tuple(xs.shape)} (states "
                 f"{r.states[0]}..{r.states[1] - 1}), log gamma block {tuple(lg_l.shape)}, gradient block "
                 f"{tuple(g_E.shape)}; loglik and paths equal to the layer route's: {same}")
    return {"lines": lines, "same": same}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2, help="number of ranks (processes)")
    ap.add_argument("--k", type=int, default=4, help="gene-model copies: q = 1 + 14k")
    ap.add_argument("--length", type=int, default=256)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU under gloo (default: the GPU)")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds for the whole world")
    args = ap.parse_args(argv)

    from hmm_layer_torch.parallel.launch import run_world

    device = "cpu" if args.cpu else "cuda"
    backend = "nccl" if device == "cuda" and torch.cuda.device_count() >= args.world else "gloo"
    results = run_world(rank_main, args.world, args.k, args.length, args.steps, device, backend=backend,
                        timeout_s=args.timeout)
    print("\n".join(results[0]["lines"] + [r["lines"][-1] for r in results[1:]]))
    return 0 if all(r["same"] for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
