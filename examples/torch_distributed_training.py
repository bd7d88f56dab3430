"""Distributed training and decoding through the mesh-aware layer, on the
PyTorch port.

The workflow of ``examples/distributed_training.py`` on ``hmm_layer_torch``
over ``torch.distributed``, one process per rank:

1. spawn a world of ranks (``hmm_layer_torch.parallel.launch.run_world``:
   NCCL with one GPU a rank, gloo under ``--cpu`` or when ranks share a
   GPU) and build a mesh over them (``data`` x ``seq``),
2. construct ``HMMLayer(mesh=..., partition=...)`` — ``loss``,
   ``log_likelihood``, ``state_posterior_log_probs`` and ``viterbi`` then
   route through the sharded engine, with the MAP prior intact,
3. train with ``Trainer`` (every rank starts from rank 0's parameters and
   takes the same step with the whole-batch gradient),
4. decode posterior marginals and Viterbi paths with the same layer.

On several hosts, start one process per rank yourself and call
``hmm_layer_torch.parallel.init_distributed(...)`` with the rendezvous
address; nothing else changes.

Run: python examples/torch_distributed_training.py [--world 2] [--steps 10]
[--cpu] (the GPU unless ``--cpu``).
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

Q = 7  # the simple gene-prediction family


def rank_main(steps: int, batch: int, length: int, device: str):
    """One rank's run; returns the lines to print (the same on every rank)."""
    import torch.distributed as dist

    from hmm_layer_torch import HMMLayer, Trainer
    from hmm_layer_torch.models import SimpleGenePredEmissions, SimpleGenePredTransitions
    from hmm_layer_torch.parallel import make_mesh

    n = dist.get_world_size()
    seq_n = 2 if n % 2 == 0 else 1
    data_n = n // seq_n
    mesh = make_mesh({"data": data_n, "seq": seq_n})
    if device == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    lines = [f"mesh: data={data_n} seq={seq_n} over {n} ranks ({dist.get_backend()}, {device})"]

    layer = HMMLayer(
        SimpleGenePredTransitions(),
        SimpleGenePredEmissions(),
        use_prior=True,
        num_seqs=batch * steps,
        device=device,
        mesh=mesh,
        partition={"batch": "data", "seq": "seq"},
    )
    trainer = Trainer(layer, optimizer=functools.partial(torch.optim.Adam, lr=1e-2))
    trainer.init(torch.Generator().manual_seed(0), input_dim=Q)

    # Synthetic class-probability inputs; b must be divisible by the data
    # axis and L by the seq axis.
    b = -(-batch // data_n) * data_n
    L = -(-length // seq_n) * seq_n
    rng = np.random.default_rng(0)
    batches = [torch.as_tensor(rng.uniform(0.1, 1.0, (1, b, L, Q)).astype(np.float32), device=device)
               for _ in range(steps)]

    with torch.no_grad():
        loss0 = float(layer.loss(batches[0]))
    trainer.fit(batches, log_every=5)
    with torch.inference_mode():
        loss1 = float(layer.loss(batches[0]))
        lg = layer.state_posterior_log_probs(batches[0])
        paths = layer.viterbi(batches[0])
    lines.append(f"loss on batch 0: {loss0:.4f} -> {loss1:.4f} after {steps} sharded steps")
    lines.append(f"posterior {tuple(lg.shape)} finite={bool(torch.isfinite(lg).all())}; "
                 f"viterbi states in [0, {int(paths.max())}]")
    return {"lines": lines, "improved": loss1 < loss0}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--world", type=int, default=2, help="number of ranks (processes)")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--length", type=int, default=128)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU under gloo (default: the GPU)")
    parser.add_argument("--timeout", type=float, default=600.0, help="seconds for the whole world")
    args = parser.parse_args(argv)

    from hmm_layer_torch.parallel.launch import run_world

    device = "cpu" if args.cpu else "cuda"
    # NCCL takes one GPU a rank; ranks sharing a GPU (or the CPU) use gloo.
    backend = "nccl" if device == "cuda" and torch.cuda.device_count() >= args.world else "gloo"
    results = run_world(rank_main, args.world, args.steps, args.batch, args.length, device,
                        backend=backend, timeout_s=args.timeout)
    print("\n".join(results[0]["lines"]))
    return 0 if all(r["improved"] for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
