#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hmm_layer_torch``) on one GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs
one CUDA device and ``nvcc``, builds the kernels from ``hmm_layer_torch/
csrc`` and imports nothing of JAX. Phases, each printed as it ends:

1. Device: the card's name and power limit (``nvidia-smi``); full float32
   matmuls (no TF32).
2. Build: compiles the kernel sources (one ``nvcc`` each, ``sm_90a``, all
   started together) and reports seconds.
3. Kernels: K1–K3 and K6–K8 against their plain PyTorch versions on the
   card, at the shapes the flagship request gives them (gene-pred model,
   q=15, b=32, L=9999, parallel_factor "auto" = 33: c=303, R=1056); K6–K8
   must be bit-equal; median time over 20 samples (CUDA events), the plain
   version's time and the bound. K1–K8 are timed cold as well
   (each launch after 256 MB written to a scratch buffer, so that their
   inputs are not in the 50 MB L2; ``cold_ms`` in the kernels' record), and
   their bound shares are taken from that.
4. End to end: ``HMMLayer`` serves 3 requests of b=32, L=9999 through
   ``state_posterior_log_probs`` and ``log_likelihood``; the launch counts
   of that run, the checks (normalised posteriors, finite logliks, the
   same layer's plain path on the card, the sequential recursion on a
   small input) and ms/batch.
5. Where the time goes: the request split into its stages (host clock
   around each, synchronised), and ``torch.profiler``'s device busy time.
6. Decode: ``HMMLayer.viterbi`` serves 3 requests of b=32, L=9999; the
   launch counts of that run (K6, K7, K8 once per request), the paths
   against the layer's plain chunked route on the card (identical) and, on
   a small input, against the sequential decode (float64 path scores);
   ms/batch, the stage split and the profiler's device busy time.
7. Predict: ``python -m hmm_layer_torch predict`` in-process on ~1 Mbp of
   seeded contigs, both strands, window 9999, batch 32, parallel factor 33,
   with a seeded class-probability file and a checkpoint of the phase-4
   layer; the launch counts (K6–K8 once per window batch per strand), one
   contig's tracks against the plain route, the GFF3 read back, bp/s.
8. Training: a ``Trainer`` with Adam(1e-2) takes 5 steps of the posterior
   cross-entropy (labels: the layer's own Viterbi track, a label mask) and
   2 MAP steps at b=32, L=9999, P=33; ms/step, seqs/s, the launches of each
   step (CE: K1–K5 once; MAP: K1, K2, K3 once, C saved), the loss falling,
   every parameter moving. Gradients of every parameter: the kernel route
   against the plain route on the card at the flagship shape, and against
   float64 autograd through the sequential engine at b=2, L=1200. The
   stage split of one CE backward and the profiler's busy share. Then
   ``python -m hmm_layer_torch train`` in-process on phase 7's contigs,
   class probabilities and GFF3 (CE, both strands, window 9999, batch 32,
   P=33, 10 steps), bp/s, and ``predict --params`` on its checkpoint.
9. Multi-copy gene prediction: ``GenePredMultiTransitions(k=2)`` +
   ``GenePredEmissions(num_copies=2)`` (q=29) from the 15-class kernel,
   seeded random weights. K7b and K8b against their plain versions
   (bit-equal) at q=29 and q=57 (b=32, L=9999) on the decode's
   sequence-major layout, warm and cold, K7b beside its chain floor (a
   cycle model at the card's maximum SM clock); K9 against its plain
   version within a float32 accumulation bound at q=29 (b=32, P=33 and
   P=303) and q=127 (b=4, P=33), warm and cold. ``HMMLayer.viterbi``
   serves 3 requests (K7b, K8b once each per request; paths identical to
   the glue on the plain versions, valid and score-equal to the sequential
   decode), ms/batch and the profiler's busy share. Config 5 (k = 36,
   q = 505, b=32, L=9999): K7c's pointers and last delta bit-equal to its
   plain version and K8c's paths equal to its plain walk, warm and cold,
   beside their bounds; ``HMMLayer.viterbi`` serves 3 requests (K7c, K8c
   once each per request; paths identical to ``_viterbi_seq``'s),
   ms/batch and the profiler's busy share;
   ``HMMLayer.log_likelihood`` serves 3 requests with the K9 gate off,
   then on (K9 once per request, K1 never; equal to the gate-off result
   and, on a small input, to the sequential recursion), ms/batch for both,
   and the profiler's device busy time and K9 time of one gated request;
   one MAP ``loss`` step with the gate on (K9 once, finite gradients).
10. Options and auxiliary inference, at the flagship width on the phase-4
   inputs with seeded weights; each item prints its launches, checks and
   times. ``emit_embeddings`` (d = 32 seeded N(0, 1) embedding channels):
   3 posterior requests (K1–K3 once each; the plain route), the MVN's peak
   memory, 2 CE steps with the aux loss (K1–K5 once each, every parameter
   moving) and one full-covariance request against its plain route.
   ``onehot_lookup_kmers``: emissions against the 3-mer contraction on the
   same weights, 3 posterior requests beside the contraction path's.
   ``trainable_nucleotides_at_exons`` with ``use_experimental_prior``: 2
   MAP steps (K1–K3 once; finite prior, a nonzero nucleotide gradient).
   ``sample_paths``: S = 8 at q = 15 (K1 once a request; every start and
   transition valid), state frequencies of 1000 paths of one sequence
   against exp(log gamma), and S = 8 at q = 29 with the K9 gate on (K9
   once, K1 never). ``em_step``: 3 steps (K1–K3 once each, loglik not
   falling, stochastic rows; step 1 against the plain route). Streaming
   over 3 blocks of 3333 at P = 33: the filter (K1 once a block) against
   the whole sequence's log-likelihood, the smoother (lag 263) against the
   posterior of the sequence truncated at each window's end, the fixed-lag
   Viterbi (lag 256) valid; ms per block. The profiler's device busy time
   of one posterior with embeddings, one ``sample_paths``, one ``em_step``,
   the filter, the smoother and one fixed-lag Viterbi block.
11. The sparse edge-list engine (``ops/sparse.py``, no kernel of its own;
   every item checks that none of K1–K9 launched). Config 5:
   ``GenePredMultiTransitions(k=36, sparse_forward=True)`` +
   ``GenePredEmissions(num_copies=36)`` (q = 505, 793 edges), seeded
   weights, b=8, L=10,000, against a dense twin of the same parameters (the
   sequential engine at q > 64): 3 posterior + loglik requests
   (normalisation, log gamma and loglik against the twin, ms/batch of both,
   the profiler's busy share of one), one decode (valid, float64 score equal
   to the dense decode's), one MAP step, the fused CE against the unfused
   one (value, peak device memory; gradients at b=2, L=2000), two ``Trainer``
   CE steps (fused, block 1000), ``sample_paths`` (S = 4; S = 1000 on one
   sequence against exp(log gamma)), 3 ``sparse_em_step`` calls (step 1 against
   the dense ``em_step``), the sparse streaming filter over 4 blocks of 2,500
   and two bit-equal ``sparse_forward`` calls. The flagship (q = 15, b=32,
   L=9999) through ``GenePredTransitions(sparse_forward=True)`` against the
   K1–K3 posterior and the K6–K8 decode of the same weights, and its CE
   gradients against the dense chunked ones (b=2, L=1200). k = 1000 (q =
   14,001, 22,001 edges, b=2, L=2000): ``sparse_log_likelihood`` against the
   dense sequential engine (A: 784 MB), both timed.
12. The profile-HMM family (every item prints its launches of the
   kernels). K2c and K3c against their plain versions (within the float32
   log-scale bound) at the profile-m5-train cell's shape (config 4 below,
   q padded to 155, b=64, L=400), at the profile-m5-n320-train cell's
   (lengths 318-322, q padded to 647: the register cut) and at config 5's
   (q=505, b=32, L=9999), warm and cold, beside their bounds, K2c with and
   without log alpha, and one MAP loss and backward of config 4 and of the
   n320 family (K2c twice, K3c once each). Config 4
   (``benchmarks/profile_train_bench.py``):
   ``ProfileTransitions([60, 64, 68, 72, 76])`` + ``ProfileEmissions``
   (q up to 155), the port's default initializers from a seeded generator,
   ``use_prior``, ``num_seqs=1000``, ``parallel_factor="auto"`` (= 1), b=64,
   L=400, one-hot residues over 26 channels: 3 log-likelihood + posterior
   requests (log gamma normalised over each model's real states, the
   log-likelihood equal to ``structured_log_likelihood``; K2c once a
   log-likelihood and no other kernel),
   ``set_dp_precision("high")`` bit-equal to "highest", the structured
   route's loss and gradients against the dense route's, 5 ``Trainer``
   MAP steps with Adam(0.05) (K2c twice and K3c once a step, loss falling,
   every trainable parameter
   moving, the frozen insertion kernels not), gradients against float64
   autograd (m=2, b=4, L=100), and the q=155 model's decode (K7c and K8c
   once each; valid, float64 scores equal to a CPU copy's); ms/batch, ms/step and the profiler's busy
   share. Then ``python -m hmm_layer_torch align`` in-process on a planted
   family (Lm=24, 64 sequences): K7b and K8b once each in its final decode
   and no other kernel, the paths equal to the glue on the plain versions,
   every row its input, pairs F1 >= 0.9 against the planted truth; and
   ``align --adapt-rounds 2 --model-length 18`` (rows, F1).
13. The host side and the multi-device routes
   (``hmm_layer_torch.parallel`` on ``torch.distributed``). Predict's time
   split between reading phase 7's FASTA and the rest, the native C++
   reader against the Python one in paired runs (native, Python, Python,
   native; records equal), and a ``simulate_genome`` contig through
   ``predict`` scored by ``evaluate_annotation`` against its planted genes.
   The flagship's data route (``partition={"batch": "data"}``) at world 1
   under NCCL in this process and at world 2 on the shared card (gloo,
   spawned ranks with a hard time limit): 3 posteriors, a log-likelihood,
   3 decodes, a CE gradient and 2 SGD CE steps, each rank launching K1–K8
   (counted per rank), its results against the unsharded layer. The
   sequence and state routes, and the sparse layer's data route, at world
   1 under NCCL on a small input. The sequence route at world 3 (3,333
   positions a rank, local parallel factor 11): posteriors and decodes on
   plain ops, each CE backward launching K4 and K5 on every rank. Config
   5's state route (q = 505 padded to 506, b=8) at world 2 against the
   dense twin: posterior and log-likelihood on the chunked engine (P=40)
   at L=10,000, on the sequential engine cut to L=500, the decode cut to
   L=2,000. A probe of the collectives gloo takes on CUDA tensors (values
   checked). The sequence route is held to the unsharded layer on its
   plain route (K1–K8 off), whose arithmetic its primal shares. The
   edge-sharded sparse routes (``parallel/sparse_sharding.py``, no kernel
   of their own; every item checks that none of K1–K9 launched): the
   sparse flagship layer's ``{"state": "state"}`` route at world 1 under
   NCCL against the sparse engine (b=4, L=1200); config 5's sparse layer
   (q = 505 padded to 506, b=8) under ``{"state": 2}`` at world 2 on the
   shared card, L = 10,000 cut to 2,000 (the route's per-step
   collectives): a posterior, a log-likelihood and a decode (log gamma
   and loglik within the float32 bound of the sparse engine's, the decode
   valid with float64 scores equal to ``sparse_viterbi``'s), one MAP
   step's gradients and one taped CE gradient (cut to L = 1,000; each
   anchored in float64, the route's drift within 4x the sparse engine's);
   k = 1,000 (q = 14,001, b=2,
   L=2,000) through ``edge_sharded_log_likelihood`` and
   ``edge_sharded_posterior`` against ``sparse_log_likelihood`` /
   ``sparse_posterior``. Each call per rank: its ms, its device busy
   share (profiled on its first 200 positions) and peak device memory,
   beside the sparse engine's in this process. After the global calls
   each world makes the same calls under ``local=True``: through the
   functions on the rank's blocks (``parallel.local_ranges``), the seq
   route's posterior and CE step (K4 and K5 once each in its backward),
   the dense state route's chunked posterior and q = 14,001's posterior,
   each bit-equal to its block of the global one; through the layer
   (``HMMLayer.local_ranges``: its emitters compute only the rank's block
   of E), the seq route's posterior and CE step (K4 and K5 once each) and
   config 5's edge posterior, decode and MAP step, each held to its block
   of the layer's global call: bit-equal (log gamma, paths, the MAP loss,
   the MAP gradients of init, the edge probabilities and the E block; and
   q = 14,001's local posterior, log gamma and loglik), the CE value and
   the parameter gradients, sums in another order, within their float32
   bounds (the error and the bound printed; the MAP step's anchored in
   float64 as the global one's). Per rank each local call's ms and peak memory above the
   call's start beside the global call's (and the sparse engine's); the
   config-5 and q = 14,001 posteriors' local peaks must lie below the
   engine's, the local MAP step's below the layer's global one; the
   layer's edge posterior and MAP step timed global and local in turns on
   200 positions.
14. The examples: the five ``examples/torch_*.py`` at their default sizes
   on the card, started together (the mesh ones spawn two ranks sharing
   the card under gloo); each must exit 0 and print its line.
   ``python3 -c "import chip_smoke; chip_smoke.develop_phase13()"`` runs
   phases 1, 2, 7, 13 and 14 alone for development, and prints no
   result.

The second-to-last line is the JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from hmm_layer_torch.utils.cuda_timing import FLUSH_BYTES, cold_median_ms, median_ms

CODONS = dict(
    start_codons=[("ATG", 1.0)],
    stop_codons=[("TAG", 0.34), ("TAA", 0.33), ("TGA", 0.33)],
    intron_begin_pattern=[("NGT", 0.99), ("NGC", 0.005), ("NAT", 0.005)],
    intron_end_pattern=[("AGN", 0.99), ("ACN", 0.01)],
)
B, L, NUM_CLASSES, SEED = 32, 9999, 15, 0
PF = 33  # the flagship's parallel factor ("auto" at L = 9999)
N_REQUESTS = 3
EPS = 1e-16
PREDICT_CONTIGS = (400_000, 350_000, 250_000)  # ~1 Mbp
SOURCES = {
    "sum_chunk_summaries": "hmm_layer_torch/csrc/sum_product.cu",
    "sum_fwd_outputs": "hmm_layer_torch/csrc/sum_product.cu",
    "beta_bwd_outputs": "hmm_layer_torch/csrc/sum_product.cu",
    "maxplus_chunk_summaries": "hmm_layer_torch/csrc/max_plus.cu",
    "maxplus_deltas": "hmm_layer_torch/csrc/max_plus.cu",
    "maxplus_backtrace": "hmm_layer_torch/csrc/max_plus.cu",
    "affine_chunk_composites": "hmm_layer_torch/csrc/affine.cu",
    "affine_reverse_outputs": "hmm_layer_torch/csrc/affine.cu",
    "maxplus_deltas_blocked": "hmm_layer_torch/csrc/max_plus.cu",
    "maxplus_backtrace_blocked": "hmm_layer_torch/csrc/max_plus.cu",
    "sum_chunk_summaries_mxu": "hmm_layer_torch/csrc/mxu.cu",
    "maxplus_deltas_wide": "hmm_layer_torch/csrc/max_plus_wide.cu",
    "maxplus_backtrace_wide": "hmm_layer_torch/csrc/max_plus_wide.cu",
    "sum_forward_wide": "hmm_layer_torch/csrc/sum_product_wide.cu",
    "sum_backward_wide": "hmm_layer_torch/csrc/sum_product_wide.cu",
}
REPLACES = {
    "sum_chunk_summaries": "hmm_layer_tpu/ops/pallas_forward.py:112",
    "sum_fwd_outputs": "hmm_layer_tpu/ops/pallas_forward.py:239",
    "beta_bwd_outputs": "hmm_layer_tpu/ops/pallas_forward.py:292",
    "maxplus_chunk_summaries": "hmm_layer_tpu/ops/pallas_viterbi.py:151",
    "maxplus_deltas": "hmm_layer_tpu/ops/pallas_viterbi.py:353",
    "maxplus_backtrace": "hmm_layer_tpu/ops/pallas_viterbi.py:433",
    "affine_chunk_composites": "hmm_layer_tpu/ops/pallas_adjoint.py:93",
    "affine_reverse_outputs": "hmm_layer_tpu/ops/pallas_adjoint.py:170",
    "maxplus_deltas_blocked": "hmm_layer_tpu/ops/pallas_viterbi.py:279",
    "maxplus_backtrace_blocked": "hmm_layer_tpu/ops/pallas_viterbi.py:317",
    "sum_chunk_summaries_mxu": "hmm_layer_tpu/ops/pallas_mxu.py:147",
    # The JAX package's q > 64 sequential decode is lax.scan: no TPU kernel.
    "maxplus_deltas_wide": "none (hmm_layer_tpu/ops/recursion.py _viterbi_seq, lax.scan)",
    "maxplus_backtrace_wide": "none (hmm_layer_tpu/ops/recursion.py _viterbi_seq, lax.scan)",
    # ... and so are its sequential sum-product passes.
    "sum_forward_wide": "none (hmm_layer_tpu/ops/recursion.py _forward_seq, lax.scan)",
    "sum_backward_wide": "none (hmm_layer_tpu/ops/recursion.py _backward_seq, lax.scan)",
}
# The q <= 16 decode kernels; the blocked bodies K7b/K8b count separately.
DECODE_Q16 = ("maxplus_chunk_summaries", "maxplus_deltas", "maxplus_backtrace")
TRAIN_STEPS, MAP_STEPS, CLI_STEPS = 5, 2, 10
# Kernel-only launches per request: the posterior runs K1, K2 and K3 once,
# the log-likelihood K1 once more.
PER_REQUEST = {"sum_chunk_summaries": 2, "sum_fwd_outputs": 1, "beta_bwd_outputs": 1}
# The sequential passes at 64 < q <= 512 (K2c, K3c); no flagship call runs them.
SUM_WIDE_KEYS = ("sum_forward_wide", "sum_backward_wide")
# Kernels timed cold as well as warm in phases 3 and 9: K1's and K6's 19–20
# MB, K8's 21 MB, K2's, K3's and K7's 38 MB, K8b's 38 MB and K9's 41 MB (q=29)
# of inputs and outputs stay in the 50 MB L2 over back-to-back launches
# (K4's 117 MB, K5's 154 MB and K7b's 74 MB do not, and their cold times
# show that).
COLD = ("sum_chunk_summaries", "sum_fwd_outputs", "beta_bwd_outputs", "affine_chunk_composites",
        "affine_reverse_outputs", "maxplus_chunk_summaries", "maxplus_deltas", "maxplus_backtrace",
        "maxplus_deltas_blocked", "maxplus_backtrace_blocked", "sum_chunk_summaries_mxu",
        "maxplus_deltas_wide", "maxplus_backtrace_wide", "sum_forward_wide", "sum_backward_wide")
# K7b's chain floor, a model in SM cycles a step (not a measurement): the
# term's add, a ceil(log2 q)-deep max tree and the emission's add at 4
# cycles each, a shared-memory store and load of delta (30) and a barrier
# (20); at the card's maximum SM clock.
FLOAT_OP_CYCLES, SMEM_ROUND_TRIP_CYCLES, BARRIER_CYCLES = 4, 30, 20

# NVIDIA data-sheet peaks: (memory bytes/s, float32 non-tensor FLOP/s).
PEAKS = {
    "SXM": (3.35e12, 67e12),
    "PCIe": (2.0e12, 51e12),
    "NVL": (3.9e12, 60e12),
}


def log(msg):
    print(msg, flush=True)


def peaks_for(name):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, PEAKS[key]
    return "SXM", PEAKS["SXM"]


def cold_text(name, kern, rec):
    """For the kernels of COLD: their cold time (kept in ``rec`` as
    ``cold_ms``) and the bound's share of it."""
    if name not in COLD:
        return ""
    cold = rec["cold_ms"] = cold_median_ms(kern)
    return (f"; cold {cold:.4f} ms (median of 20 single launches after a {FLUSH_BYTES >> 20} MB "
            f"write), bound share {100 * rec['bound_ms'] / cold:.1f}% of the cold time")


def within(got, ref, rtol, atol, mask=None):
    """(max abs error, ok) of ``|got - ref| <= atol + rtol |ref|``."""
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if mask is not None:
        err, bad = err[mask], bad[mask]
    return float(err.max()), not bool(bad.any())


def f32_log_bound(ll, steps):
    """Rounding bound for a log value built by a float32 recursion.

    Log alpha and log beta carry a log-scale that sums one ``log z`` per
    step at the magnitude of the log-likelihood, so each sum rounds at the
    float32 spacing there. The bound is 8 standard deviations of the sum of
    ``steps`` such roundings (uniform within half a spacing), for the two
    directions together. At the flagship (|loglik| ~ 1.1e5, spacing 2^-7,
    303 steps) it is 0.44 nats; the JAX package's float32 engines drift the
    same way.
    """
    spacing = 2.0 ** (math.floor(math.log2(float(ll.abs().max()))) - 23)
    return 8.0 * spacing * math.sqrt(2 * steps / 12)


def make_inputs(seed, b, length, device):
    rng = np.random.default_rng(seed)
    cls = rng.dirichlet(np.ones(NUM_CLASSES), size=(1, b, length)).astype(np.float32)
    nucs = np.eye(5, dtype=np.float32)[rng.integers(0, 4, size=(1, b, length))]
    return torch.from_numpy(np.concatenate([cls, nucs], axis=-1)).to(device)


def seeded_layer(HMMLayer, transitions, emissions, seed, **kwargs):
    """A layer on the card with seeded random weights around its init:
    N(0, 0.5) added to every parameter, N(0, 0.1) to the embedding
    kernel."""
    layer = HMMLayer(transitions, emissions, parallel_factor="auto", **kwargs)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            sd = 0.1 if "embedding" in name else 0.5
            p.add_((sd * torch.randn(p.shape, generator=gen)).to(p.device))
    return layer


def build_layer(HMMLayer, models):
    """The flagship layer (q = 15) with seeded random weights."""
    return seeded_layer(HMMLayer, models.GenePredTransitions(),
                        models.GenePredEmissions(**CODONS), SEED, use_prior=False)


def kernel_phase(layer, X, recursion, cuda_forward, peak_bytes, peak_flops):
    """K1–K3 against their plain versions at the flagship shapes."""
    records = {}
    with torch.inference_mode():
        init, A = layer.transitions.matrices()
        A = A.contiguous()
        E = layer.emission_probs(X)
        m, b, length, q = E.shape
        P = recursion.recommended_parallel_factor(length, q, m)
        E_T = recursion._kernel_chunk_inputs(E, P)
        c, R = E_T.shape[1], E_T.shape[3]
        log(f"phase 3 shapes: m={m} q={q} b={b} L={length} P={P} c={c} R={R}")

        # K1, then the real boundary starts of K2/K3 from its plain result.
        C_plain = cuda_forward.sum_chunk_summaries_plain(A, E_T, P)
        C_kern = cuda_forward.sum_chunk_summaries(A, E_T, P)
        mask = C_plain >= C_plain.amax(-1, keepdim=True) - 30.0
        T, S, _ = recursion._boundary_values(init, C_plain.reshape(m, b, P, q, q).movedim(2, 0))
        R0_log = recursion._forward_boundary_starts(init, A, T)
        ll0 = torch.logsumexp(R0_log, -1)
        r0 = torch.exp(R0_log - ll0[..., None]).transpose(-1, -2).contiguous()
        S_flat = S.movedim(0, 2).reshape(m, R, q)
        ll0b = S_flat.amax(-1)
        beta0 = torch.exp(S_flat - ll0b[..., None]).transpose(-1, -2).contiguous()

        step_ops = (c - 1) * q * (2 * q + 4)  # FMA = 2; clamp, product, sum, divide
        e_bytes = 4 * m * c * q * R
        cases = {
            "sum_chunk_summaries": (
                lambda: cuda_forward.sum_chunk_summaries(A, E_T, P),
                lambda: cuda_forward.sum_chunk_summaries_plain(A, E_T, P),
                (C_kern, C_plain, 1e-5, 1e-3, mask),
                4 * m * q * q + e_bytes + 4 * m * R * q * q,
                m * R * q * step_ops,
            ),
            "sum_fwd_outputs": (
                lambda: cuda_forward.sum_fwd_outputs(A, E_T, r0, ll0),
                lambda: cuda_forward.sum_fwd_outputs_plain(A, E_T, r0, ll0),
                (cuda_forward.sum_fwd_outputs(A, E_T, r0, ll0),
                 cuda_forward.sum_fwd_outputs_plain(A, E_T, r0, ll0), 1e-5, 1e-2, None),
                4 * m * q * q + 2 * e_bytes + 4 * m * (q + 1) * R,
                m * R * step_ops,
            ),
            "beta_bwd_outputs": (
                lambda: cuda_forward.beta_bwd_outputs(A, E_T, beta0, ll0b),
                lambda: cuda_forward.beta_bwd_outputs_plain(A, E_T, beta0, ll0b),
                (cuda_forward.beta_bwd_outputs(A, E_T, beta0, ll0b),
                 cuda_forward.beta_bwd_outputs_plain(A, E_T, beta0, ll0b), 1e-5, 1e-2, None),
                4 * m * q * q + 2 * e_bytes + 4 * m * (q + 1) * R,
                m * R * step_ops,
            ),
        }
        failed = []
        for name, (kern, plain, (got, ref, rtol, atol, msk), nbytes, nops) in cases.items():
            torch.cuda.synchronize()
            err, ok = within(got, ref, rtol, atol, msk)
            records[name] = measure(name, kern, plain, err, nbytes, nops, peak_bytes, peak_flops)
            log(f"phase 3 {name}: {'ok' if ok else 'MISMATCH'} max_abs_err={err:.3e} "
                f"(rtol {rtol}, atol {atol}) {timing_text(records[name], nbytes, nops)}"
                f"{cold_text(name, kern, records[name])}")
            if not ok:
                failed.append(name)
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")
    return records, P


def measure(name, kern, plain, err, nbytes, nops, peak_bytes, peak_flops,
            reps=10, plain_samples=20):
    """The kernel's record: kernel ms (median of 20 samples of ``reps``
    launches), plain ms (``plain_samples`` samples of 1), and the bound from
    the bytes and operations of this call."""
    ms = median_ms(kern, samples=20, reps=reps)
    plain_ms = median_ms(plain, samples=plain_samples, reps=1, warmup=1)
    bytes_ms, ops_ms = 1e3 * nbytes / peak_bytes, 1e3 * nops / peak_flops
    return {
        "name": name,
        "route": "cuda",
        "source": SOURCES[name],
        "replaces": REPLACES[name],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def timing_text(rec, nbytes, nops):
    return (f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.3f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: {nbytes / 1e6:.1f} MB, "
            f"{nops / 1e9:.3f} G operations)")


def viterbi_kernel_phase(layer, X, recursion, cuda_viterbi, peak_bytes, peak_flops):
    """K6–K8 against their plain versions at the flagship decode shapes,
    on the starts and last states the decode's own glue gives them."""
    records = {}
    with torch.inference_mode():
        init, A = layer.transitions.matrices()
        E = layer.emission_probs(X)
        P = recursion.recommended_parallel_factor(E.shape[2], E.shape[3], E.shape[0], for_viterbi=True)
        log_init, log_A = torch.log(init.clamp_min(EPS)), torch.log(A.clamp_min(EPS)).contiguous()
        log_E_T = torch.log(recursion._kernel_chunk_inputs(E, P))
        m, c, q, R = log_E_T.shape
        b = R // P
        C_plain = cuda_viterbi.maxplus_chunk_summaries_plain(log_A, log_E_T, P)
        C_kern = cuda_viterbi.maxplus_chunk_summaries(log_A, log_E_T, P)
        C5 = C_plain.reshape(m, b, P, q, q).movedim(2, 0)
        j_end = recursion._boundary_backtrace(recursion._viterbi_boundaries(log_init, C5), C5)
        r0, last = recursion._conditional_viterbi_starts(log_init[:, None].expand(m, b, q), log_A, j_end)
        delta0 = (r0.transpose(-1, -2) + log_E_T[:, 0]).contiguous()
        last = last.to(torch.int32).contiguous()
        d_plain = cuda_viterbi.maxplus_deltas_plain(log_A, log_E_T, delta0)
        d_kern = cuda_viterbi.maxplus_deltas(log_A, log_E_T, delta0)
        s_plain = cuda_viterbi.maxplus_backtrace_plain(log_A, d_plain, last)
        s_kern = cuda_viterbi.maxplus_backtrace(log_A, d_plain, last)

        # Operations: one add and one max per (k, p) term of a step.
        step_ops = (c - 1) * 2 * q * q
        e_bytes = 4 * m * c * q * R
        a_bytes = 4 * m * q * q
        cases = {
            "maxplus_chunk_summaries": (
                lambda: cuda_viterbi.maxplus_chunk_summaries(log_A, log_E_T, P),
                lambda: cuda_viterbi.maxplus_chunk_summaries_plain(log_A, log_E_T, P),
                C_kern, C_plain, a_bytes + e_bytes + 4 * m * R * q * q, m * R * q * step_ops,
            ),
            "maxplus_deltas": (
                lambda: cuda_viterbi.maxplus_deltas(log_A, log_E_T, delta0),
                lambda: cuda_viterbi.maxplus_deltas_plain(log_A, log_E_T, delta0),
                d_kern, d_plain, a_bytes + 2 * e_bytes + 4 * m * q * R, m * R * step_ops,
            ),
            "maxplus_backtrace": (
                lambda: cuda_viterbi.maxplus_backtrace(log_A, d_plain, last),
                lambda: cuda_viterbi.maxplus_backtrace_plain(log_A, d_plain, last),
                s_kern, s_plain, a_bytes + e_bytes + 4 * m * R + 4 * m * c * R,
                m * R * (c - 1) * 2 * q,
            ),
        }
        failed = []
        for name, (kern, plain, got, ref, nbytes, nops) in cases.items():
            torch.cuda.synchronize()
            equal = torch.equal(got, ref)
            err = float((got.double() - ref.double()).abs().max())
            records[name] = measure(name, kern, plain, err, nbytes, nops, peak_bytes, peak_flops)
            log(f"phase 3 {name}: {'equal' if equal else 'MISMATCH'} max_abs_err={err:.3e} "
                f"(bit-equality required) {timing_text(records[name], nbytes, nops)}"
                f"{cold_text(name, kern, records[name])}")
            if not equal:
                failed.append(name)
    if failed:
        raise AssertionError(f"kernels differ from their plain versions: {failed}")
    return records


def ce_targets(layer, X):
    """Labels and label mask of a posterior-CE batch: the layer's own
    Viterbi track (grammar-valid states) and a mask that leaves the last
    1000 positions of every fourth sequence unannotated."""
    with torch.inference_mode():
        labels = layer.viterbi(X)[0].long()
    mask = torch.ones(labels.shape, device=labels.device)
    mask[::4, -1000:] = 0.0
    return labels.clone(), mask


def adjoint_inputs(layer, X, labels, mask, recursion):
    """(B2, U, V, S) of the flagship posterior-CE backward: the adjoint
    weights of a real posterior and the centred source of the CE
    cotangent, stacked as 2m models and laid out as K4/K5 take them."""
    with torch.inference_mode():
        init, A = layer.transitions.matrices()
        E = layer.emission_probs(X, training=True)
        m, b, length, q = E.shape
        P = recursion.recommended_parallel_factor(length, q, m)
        lg, ll, la = recursion._posterior_chunked_primal(init, A, E, P, False)
        _, lb, _ = recursion._posterior_vjp_residuals(False, (la, lg, ll))
        log_E = torch.log(E.clamp_min(EPS))
        gam = torch.exp(la + lb - ll[..., None, None])
        ct = -torch.nn.functional.one_hot(labels, q).to(E.dtype)[None] * (mask / mask.sum())[None, ..., None]
        src = ct - gam * ct.sum(-1)[..., None]
        f, gbar = recursion._forward_adjoint_weights(la, log_E)
        fp, gp, _, _ = recursion._backward_adjoint_weights(lb, log_E)
        B2 = torch.cat([A, A.transpose(-1, -2)], dim=0).contiguous()
        u2 = torch.cat([f, gp.flip(2)], dim=0)
        v2 = torch.cat([gbar, fp.flip(2)], dim=0)
        c2 = torch.cat([src, src.flip(2)], dim=0)
        U, V, S = (recursion._affine_lanes(x, P) for x in (u2, v2, c2))
    return B2, U, V, S, P, b


def adjoint_kernel_phase(layer, X, labels, mask, recursion, cuda_adjoint, peak_bytes, peak_flops):
    """K4–K5 against their plain versions at the shapes of the flagship
    posterior-CE backward (2m = 2 stacked models, c = 303, q = 15,
    R = 1056), on the real adjoint weights and source."""
    B2, U, V, S, P, b = adjoint_inputs(layer, X, labels, mask, recursion)
    m2, c, q, R = U.shape
    log(f"phase 3 adjoint shapes: 2m={m2} c={c} q={q} R={R} (b={b}, P={P})")
    records = {}
    with torch.inference_mode():
        comp_plain = cuda_adjoint.affine_chunk_composites_plain(B2, U, V, S)
        comp_kern = cuda_adjoint.affine_chunk_composites(B2, U, V, S)
        comp5 = comp_plain.reshape(m2, b, P, q, q + 1).movedim(2, 0)
        rights = recursion._affine_boundary_fold(comp5, torch.zeros_like(comp5[0, ..., 0]))
        x_right = rights.movedim(0, 2).reshape(m2, R, q).transpose(-1, -2).contiguous()
        x_plain = cuda_adjoint.affine_reverse_outputs_plain(B2, U, V, S, x_right)
        x_kern = cuda_adjoint.affine_reverse_outputs(B2, U, V, S, x_right)
        in_bytes = 3 * 4 * m2 * c * q * R + 4 * m2 * q * q
        cases = {
            "affine_chunk_composites": (
                lambda: cuda_adjoint.affine_chunk_composites(B2, U, V, S),
                lambda: cuda_adjoint.affine_chunk_composites_plain(B2, U, V, S),
                comp_kern, comp_plain, in_bytes + 4 * m2 * R * q * (q + 1),
                # per step and column: v*x (q), B @ (q*q FMAs), u* (q)
                m2 * R * (q + 1) * c * (2 * q * q + 2 * q),
            ),
            "affine_reverse_outputs": (
                lambda: cuda_adjoint.affine_reverse_outputs(B2, U, V, S, x_right),
                lambda: cuda_adjoint.affine_reverse_outputs_plain(B2, U, V, S, x_right),
                x_kern, x_plain, in_bytes + 4 * m2 * q * R + 4 * m2 * c * q * R,
                m2 * R * c * (2 * q * q + 3 * q),
            ),
        }
        failed = []
        for name, (kern, plain, got, ref, nbytes, nops) in cases.items():
            torch.cuda.synchronize()
            err, ok = within(got, ref, 1e-5, 1e-6)
            records[name] = measure(name, kern, plain, err, nbytes, nops, peak_bytes, peak_flops)
            log(f"phase 3 {name}: {'ok' if ok else 'MISMATCH'} max_abs_err={err:.3e} (rtol 1e-05, "
                f"atol 1e-06; |ref| max {float(ref.abs().max()):.3e}) "
                f"{timing_text(records[name], nbytes, nops)}{cold_text(name, kern, records[name])}")
            if not ok:
                failed.append(name)
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")
    return records


def e2e_phase(layer, recursion, cuda_forward, make):
    requests = [make(SEED + 1 + i, B, L) for i in range(N_REQUESTS)]
    with torch.inference_mode():
        layer.state_posterior_log_probs(requests[0])  # warm-up, not counted
        layer.log_likelihood(requests[0])
        torch.cuda.synchronize()

        cuda_forward.reset_launches()
        results, request_ms = [], []
        for X in requests:
            t0 = time.perf_counter()
            lg = layer.state_posterior_log_probs(X)
            ll = layer.log_likelihood(X)
            torch.cuda.synchronize()
            request_ms.append(1e3 * (time.perf_counter() - t0))
            results.append((lg, ll))
        launches = dict(cuda_forward.LAUNCHES)
        log(f"phase 4 launches over {N_REQUESTS} requests: {launches}")
        expected = {k: N_REQUESTS * PER_REQUEST.get(k, 0) for k in launches}
        if launches != expected:
            raise AssertionError(f"launch counts {launches}, expected {expected}")

        P = recursion.recommended_parallel_factor(L, 15, 1)
        for i, (X, (lg, ll)) in enumerate(zip(requests, results)):
            if tuple(lg.shape) != (1, B, L, 15) or tuple(ll.shape) != (1, B):
                raise AssertionError(f"request {i}: shapes {tuple(lg.shape)}, {tuple(ll.shape)}")
            if not (torch.isfinite(lg).all() and torch.isfinite(ll).all()):
                raise AssertionError(f"request {i}: non-finite output")
            init, A = layer.transitions.matrices()
            E = layer.emission_probs(X)
            lg_p, ll_p, _ = recursion._posterior_chunked_plain(init, A, E, P, False)
            bound = f32_log_bound(ll, L // P)
            norm_err = float(torch.logsumexp(lg, -1).abs().max())
            norm_plain = float(torch.logsumexp(lg_p, -1).abs().max())
            mass = lg_p.exp() >= 1e-3
            lg_err, lg_ok = within(lg, lg_p, 0.0, 2 * bound, mask=mass)
            g_err = float((lg.exp() - lg_p.exp()).abs().max())
            l_err, l_ok = within(ll, ll_p, 1e-5, 0.0)
            log(f"phase 4 request {i}: loglik {float(ll.mean()):.2f} mean, vs plain path max abs "
                f"{l_err:.3e} (rtol 1e-5); |logsumexp(log gamma)| max {norm_err:.3e} (plain path "
                f"{norm_plain:.3e}; bound {bound:.3f}); log gamma vs plain where gamma >= 1e-3: "
                f"max abs {lg_err:.3e} (bound {2 * bound:.3f}); gamma vs plain max abs {g_err:.3e}")
            if norm_err > bound or not lg_ok or not l_ok:
                raise AssertionError(f"request {i} disagrees with the plain path")

        # Small input against the sequential recursion (no chunks, no kernels).
        Xs = make(SEED + 99, 2, 600)
        init, A = layer.transitions.matrices()
        Es = layer.emission_probs(Xs)
        P_small = recursion.recommended_parallel_factor(600, 15, 1)
        lg_k, ll_k = recursion.posterior(init, A, Es, P_small)
        lg_s, ll_s = recursion.posterior(init, A, Es, 1)
        bound = f32_log_bound(ll_s, 600 // P_small) + f32_log_bound(ll_s, 600)
        s_err, s_ok = within(lg_k, lg_s, 0.0, bound, mask=lg_s.exp() >= 1e-3)
        ll_err, ll_ok = within(ll_k, ll_s, 2e-4, 0.0)
        log(f"phase 4 small input (b=2, L=600, P={P_small}) vs sequential: log gamma where "
            f"gamma >= 1e-3 max abs {s_err:.3e} (bound {bound:.3f}), loglik max abs {ll_err:.3e} "
            f"(rtol 2e-4)")
        if not (s_ok and ll_ok):
            raise AssertionError("small input disagrees with the sequential recursion")

        post_ms = []
        for X in requests * 3:
            t0 = time.perf_counter()
            layer.state_posterior_log_probs(X)
            torch.cuda.synchronize()
            post_ms.append(1e3 * (time.perf_counter() - t0))
    return launches, statistics.median(request_ms), statistics.median(post_ms), post_ms


def stage_phase(layer, X, recursion, cuda_forward):
    """One posterior request split into its stages, each synchronised."""
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
        return out

    with torch.inference_mode():
        for _ in range(2):  # second pass is the one kept
            stages.clear()
            init, A = timed("transition matrices", layer.transitions.matrices)
            E = timed("emissions (class einsum + 3-mer codon factor)", lambda: layer.emission_probs(X))
            m, b, length, q = E.shape
            P = recursion.recommended_parallel_factor(length, q, m)
            A = A.contiguous()
            E_T = timed("layout to (m, c, q, R)", lambda: recursion._kernel_chunk_inputs(E, P))
            C = timed("K1 sum_chunk_summaries", lambda: recursion._chunk_summaries_kernels(A, E_T, P, b))
            T, S, ll = timed("boundary fold (P logmatvec steps)", lambda: recursion._boundary_values(init, C))

            def starts():
                R0_log = recursion._forward_boundary_starts(init, A, T)
                ll0 = torch.logsumexp(R0_log, -1)
                r0 = torch.exp(R0_log - ll0[..., None]).transpose(-1, -2).contiguous()
                S_flat = S.movedim(0, 2).reshape(m, b * P, q)
                ll0b = S_flat.amax(-1)
                beta0 = torch.exp(S_flat - ll0b[..., None]).transpose(-1, -2).contiguous()
                return r0, ll0, beta0, ll0b

            r0, ll0, beta0, ll0b = timed("boundary starts", starts)
            la = timed("K2 sum_fwd_outputs", lambda: cuda_forward.sum_fwd_outputs(A, E_T, r0, ll0))
            lb = timed("K3 beta_bwd_outputs", lambda: cuda_forward.beta_bwd_outputs(A, E_T, beta0, ll0b))

            def combine():
                ll_lane = ll[..., None].expand(m, b, P).reshape(m, b * P)
                return recursion._lanes_to_mblq(la + lb - ll_lane[:, None, None, :], b)

            timed("posterior combine + layout to (m, b, L, q)", combine)
    total = sum(stages.values())
    for name, ms in stages.items():
        log(f"phase 5 stage {name}: {ms:.3f} ms ({100 * ms / total:.1f}%)")
    log(f"phase 5 stages total: {total:.3f} ms (synchronised after each stage)")

    profile_request("phase 5", lambda: layer.state_posterior_log_probs(X), "K1-K3",
                    ("outputs_kernel", "chunk_summaries_rows_kernel"))


def device_rows(prof):
    """The profiler's device kernels and copies (``key_averages()`` rows);
    the port's spans (``hmm.*``), which torch lists among the device rows
    too, are left out."""

    def annotation(e):
        return getattr(e, "is_user_annotation", False) or e.key.startswith("hmm.")

    return [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA") and not annotation(e)]


def profile_request(phase, request, label, ours_keys, inference=True):
    """``torch.profiler`` over one synchronised request (with autograd on
    unless ``inference``): device busy time against the wall time, and the
    time of the kernels named ``ours_keys``."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode() if inference else contextlib.nullcontext():
        request()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            request()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)

    def self_device_us(e):  # renamed from self_cuda_time_total in newer torch
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    rows = device_rows(prof)
    dev_us = {e.key: self_device_us(e) for e in rows if self_device_us(e) > 0}
    if not dev_us:
        log(f"{phase} profiler: no device time recorded (device busy share not measured)")
        return
    busy_ms = sum(dev_us.values()) / 1e3
    ours_ms = sum(v for k, v in dev_us.items() if any(o in k for o in ours_keys)) / 1e3
    n_kernels = sum(e.count for e in rows if self_device_us(e) > 0)
    log(f"{phase} profiler: one request {wall_ms:.3f} ms wall (profiled), device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), {n_kernels} device kernels; "
        f"{label} {ours_ms:.3f} ms, other kernels {busy_ms - ours_ms:.3f} ms")
    for key, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
        log(f"{phase} profiler top: {us / 1e3:.4f} ms  {key[:90]}")


def path_score64(init, A, E, path):
    """float64 log score of each path (m, b), and whether each transition
    the path takes has A > 0 (m, b, L-1)."""
    init, A, E = (x.double() for x in (init, A, E))
    path = path.long()
    m = path.shape[0]
    mi = torch.arange(m, device=path.device)[:, None, None]
    score = torch.log(init.clamp_min(EPS)[torch.arange(m, device=path.device)[:, None], path[..., 0]])
    score = score + torch.log(E.clamp_min(EPS)).gather(-1, path[..., None])[..., 0].sum(-1)
    prev, nxt = path[..., :-1], path[..., 1:]
    return score + torch.log(A.clamp_min(EPS))[mi, prev, nxt].sum(-1), A[mi, prev, nxt] > 0


def decode_phase(layer, recursion, cuda_viterbi, make):
    """``HMMLayer.viterbi`` serving 3 flagship requests, with its checks."""
    requests = [make(SEED + 11 + i, B, L) for i in range(N_REQUESTS)]
    with torch.inference_mode():
        layer.viterbi(requests[0])  # warm-up, not counted
        torch.cuda.synchronize()

        cuda_viterbi.reset_launches()
        paths = []
        for X in requests:
            paths.append(layer.viterbi(X))
        torch.cuda.synchronize()
        launches = dict(cuda_viterbi.LAUNCHES)
        log(f"phase 6 launches over {N_REQUESTS} decode requests: {launches}")
        expected = {k: N_REQUESTS if k in DECODE_Q16 else 0 for k in cuda_viterbi.LAUNCHES}
        if launches != expected:
            raise AssertionError(f"decode launch counts {launches}, expected {expected}")

        for i, (X, path) in enumerate(zip(requests, paths)):
            if tuple(path.shape) != (1, B, L) or path.dtype != torch.int32:
                raise AssertionError(f"request {i}: paths {path.dtype} {tuple(path.shape)}")
            if int(path.min()) < 0 or int(path.max()) >= NUM_CLASSES:
                raise AssertionError(f"request {i}: states out of range")
            init, A = layer.transitions.matrices()
            E = layer.emission_probs(X)
            P = layer._pf(E, for_viterbi=True)
            plain = recursion._viterbi_chunked_plain(init, A, E, P)
            same = torch.equal(path, plain)
            score, used = path_score64(init, A, E, path)
            log(f"phase 6 request {i}: paths {'identical to' if same else 'DIFFER FROM'} the plain "
                f"chunked route (P={P}); mean path score {float(score.mean()):.3f}; transitions "
                f"with A = 0: {int((~used).sum())}")
            if not same:
                raise AssertionError(f"request {i}: kernel route differs from the plain route")

        # Small input against the sequential decode (no chunks, no kernels).
        Xs = make(SEED + 98, 2, 600)
        init, A = layer.transitions.matrices()
        Es = layer.emission_probs(Xs)
        P_small = recursion.recommended_parallel_factor(600, NUM_CLASSES, 1, for_viterbi=True)
        chunked = recursion.viterbi(init, A, Es, P_small)
        seq = recursion.viterbi(init, A, Es, 1)
        s_k, used_k = path_score64(init, A, Es, chunked)
        s_s, used_s = path_score64(init, A, Es, seq)
        rel = float(((s_k - s_s).abs() / s_s.abs()).max())
        valid = bool(used_k[used_s.all(-1)].all())
        log(f"phase 6 small input (b=2, L=600, P={P_small}) vs sequential decode: float64 path "
            f"score max rel diff {rel:.3e} (limit 1e-6), positions differing "
            f"{int((chunked != seq).sum())}, A = 0 transitions avoided as the sequential path "
            f"avoids them: {valid}")
        if rel > 1e-6 or not valid:
            raise AssertionError("small input: chunked decode disagrees with the sequential decode")

        decode_ms = []
        for X in requests * 3:
            t0 = time.perf_counter()
            layer.viterbi(X)
            torch.cuda.synchronize()
            decode_ms.append(1e3 * (time.perf_counter() - t0))
    return launches, decode_ms


def decode_stage_phase(layer, X, recursion, cuda_viterbi):
    """One decode request split into its stages, each synchronised."""
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
        return out

    with torch.inference_mode():
        for _ in range(2):  # second pass is the one kept
            stages.clear()
            init, A = timed("transition matrices", layer.transitions.matrices)
            E = timed("emissions", lambda: layer.emission_probs(X))
            m, b, length, q = E.shape
            P = recursion.recommended_parallel_factor(length, q, m, for_viterbi=True)

            def log_layout():
                return (torch.log(init.clamp_min(EPS)), torch.log(A.clamp_min(EPS)).contiguous(),
                        torch.log(recursion._kernel_chunk_inputs(E, P)))

            log_init, log_A, log_E_T = timed("log + layout to (m, c, q, R)", log_layout)
            C_T = timed("K6 maxplus_chunk_summaries", lambda: cuda_viterbi.maxplus_chunk_summaries(
                log_A, log_E_T, P).reshape(m, b, P, q, q).movedim(2, 0))
            T = timed("boundary fold (P max-plus steps)", lambda: recursion._viterbi_boundaries(log_init, C_T))
            j_end = timed("boundary backtrace (P-1 steps)", lambda: recursion._boundary_backtrace(T, C_T))

            def starts():
                r0, last = recursion._conditional_viterbi_starts(
                    log_init[:, None].expand(m, b, q), log_A, j_end)
                return ((r0.transpose(-1, -2) + log_E_T[:, 0]).contiguous(),
                        last.to(torch.int32).contiguous())

            delta0, last = timed("conditional starts", starts)
            deltas = timed("K7 maxplus_deltas", lambda: cuda_viterbi.maxplus_deltas(log_A, log_E_T, delta0))
            states = timed("K8 maxplus_backtrace", lambda: cuda_viterbi.maxplus_backtrace(log_A, deltas, last))
            timed("layout to (m, b, L)", lambda: states.transpose(-1, -2).reshape(m, b, length).contiguous())
    total = sum(stages.values())
    for name, ms in stages.items():
        log(f"phase 6 stage {name}: {ms:.3f} ms ({100 * ms / total:.1f}%)")
    log(f"phase 6 stages total: {total:.3f} ms (synchronised after each stage)")
    profile_request("phase 6", lambda: layer.viterbi(X), "K6-K8",
                    ("chunk_summaries_kernel", "deltas_kernel", "backtrace_kernel"))


def predict_phase(layer, recursion, cuda_viterbi, tmp):
    """``predict`` end to end at full width on ~1 Mbp of seeded contigs,
    its files written to ``tmp``; returns (FASTA, class probabilities,
    GFF3)."""
    from hmm_layer_torch import cli, data
    from hmm_layer_torch.models import flip_genes, paths_to_genes, read_gff3
    from hmm_layer_torch.utils import checkpoint

    window, batch, pf, overlap = L, B, PF, 64
    rng = np.random.default_rng(SEED + 7)
    names = [f"ctg{i}" for i in range(len(PREDICT_CONTIGS))]
    t0 = time.perf_counter()
    fasta, npz = f"{tmp}/contigs.fa", f"{tmp}/class_probs.npz"
    ckpt, gff = f"{tmp}/params.npz", f"{tmp}/out.gff3"
    probs = {}
    with open(fasta, "w") as fh:
        for name, n in zip(names, PREDICT_CONTIGS):
            seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=n)].tobytes().decode()
            fh.write(f">{name}\n")
            for i in range(0, n, 80):
                fh.write(seq[i : i + 80] + "\n")
            for key in (name, f"{name}__rc"):
                probs[key] = rng.dirichlet(np.ones(NUM_CLASSES), size=n).astype(np.float32)
    np.savez(npz, **probs)
    del probs
    checkpoint.save_checkpoint(ckpt, layer)
    log(f"phase 7 inputs: {sum(PREDICT_CONTIGS)} bp in {len(names)} contigs, class "
        f"probabilities for both strands, checkpoint of the phase-4 layer "
        f"({time.perf_counter() - t0:.1f} s to write)")

    encoded = dict(data.read_fasta_encoded(fasta))
    n_batches = sum(len(list(data.window_batches(encoded[n], window, batch, overlap)))
                    for n in names)
    argv = ["predict", "-i", fasta, "-o", gff, "--class-probs", npz, "--params", ckpt,
            "--window", str(window), "--batch", str(batch), "--parallel-factor", str(pf),
            "--both-strands"]
    torch.cuda.synchronize()
    cuda_viterbi.reset_launches()
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError("predict returned non-zero")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_viterbi.LAUNCHES)
    expected = {k: 2 * n_batches if k in DECODE_Q16 else 0 for k in cuda_viterbi.LAUNCHES}
    log(f"phase 7 launches: {launches} ({n_batches} window batches per strand, both strands)")
    if launches != expected:
        raise AssertionError(f"predict launch counts {launches}, expected {expected}")

    genes = read_gff3(gff)
    n_genes = sum(len(g) for g in genes.values())

    # One contig again, kernel route and plain route, both strands.
    dlayer = checkpoint.load_checkpoint(ckpt, cli._gene_pred_layer(pf))
    cls_for = cli._class_probs_fn(npz)

    def plain_viterbi(x):
        init, A = dlayer.transitions.matrices()
        E = dlayer.emission_probs(x)
        return recursion._viterbi_chunked_plain(init, A, E, pf)

    name = names[-1]
    enc, n = encoded[name], len(encoded[name])
    with torch.inference_mode():
        kern_genes = []
        for strand, x, cls in (("+", enc, cls_for(name, n)),
                               ("-", data.revcomp_onehot(enc), cls_for(f"{name}__rc", n))):
            track = cli.decode_contig(dlayer.viterbi, x, cls, window, batch, overlap)
            track_plain = cli.decode_contig(plain_viterbi, x, cls, window, batch, overlap)
            if not np.array_equal(track, track_plain):
                raise AssertionError(f"{name} {strand}: kernel track differs from the plain route")
            found = paths_to_genes(track, num_states=NUM_CLASSES)
            kern_genes += found if strand == "+" else flip_genes(found, n)
    key = lambda g: (g.start, g.end, g.strand, tuple(g.cds), tuple(g.introns))  # noqa: E731
    if sorted(map(key, kern_genes)) != sorted(map(key, genes.get(name, []))):
        raise AssertionError(f"{name}: GFF3 genes differ from the decoded tracks")
    log(f"phase 7 {name}: tracks on both strands identical to the plain route; its "
        f"{len(kern_genes)} genes equal the GFF3's")
    bp = sum(PREDICT_CONTIGS)
    log(f"phase 7 predict: {bp} bp, both strands, {n_genes} genes in {wall:.3f} s: "
        f"{bp / wall:,.0f} bp/s (window {window}, batch {batch}, parallel factor {pf})")
    return fasta, npz, gff


def all_launches(cuda_forward, cuda_adjoint):
    return {**cuda_forward.LAUNCHES, **cuda_adjoint.LAUNCHES}


def reset_all(cuda_forward, cuda_adjoint):
    cuda_forward.reset_launches()
    cuda_adjoint.reset_launches()


def param_grads(layer, objective, X, labels=None, mask=None):
    pars = [p for p in layer.parameters() if p.requires_grad]
    if objective == "ce":
        value = layer.posterior_cross_entropy(X, labels, label_mask=mask)
    else:
        value = layer.loss(X)
    return value.detach(), torch.autograd.grad(value, pars)


def plain_route(recursion):
    """Context: the layer's recursions take their plain routes on the card
    (no K1–K5), for the route comparison."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = recursion._use_kernels, recursion._use_affine_kernels
        recursion._use_kernels = recursion._use_affine_kernels = lambda x: False
        try:
            yield
        finally:
            recursion._use_kernels, recursion._use_affine_kernels = saved

    return ctx()


def training_phase(layer, make, recursion, cuda_forward, cuda_adjoint, smi):
    """``Trainer`` steps of the posterior CE and of the MAP loss at the
    flagship shape, with their launch counts and checks. Returns the
    launches of the CE run."""
    import functools

    from hmm_layer_torch.training import Trainer

    X = make(SEED + 21, B, L)
    labels, mask = ce_targets(layer, X)
    batch = {"x": X, "labels": labels, "mask": mask}
    before = [p.detach().clone() for p in layer.parameters() if p.requires_grad]

    def ce_loss(batch, indices):
        return layer.posterior_cross_entropy(batch["x"], batch["labels"], label_mask=batch["mask"])

    adam = functools.partial(torch.optim.Adam, lr=1e-2)
    trainer = Trainer(layer, optimizer=adam, loss_fn=ce_loss)
    trainer.init_from_params()
    torch.cuda.synchronize()
    total = {}
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        reset_all(cuda_forward, cuda_adjoint)
        t0 = time.perf_counter()
        loss = trainer.fit([batch])
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        launches = all_launches(cuda_forward, cuda_adjoint)
        losses.append(float(loss))
        log(f"phase 8 CE step {i + 1}: loss {losses[-1]:.6f}, {step_ms[-1]:.3f} ms, launches {launches}")
        if any(v != (k not in SUM_WIDE_KEYS) for k, v in launches.items()):
            raise AssertionError(f"CE step {i + 1}: launch counts {launches}, expected 1 each of K1-K5")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    with torch.no_grad():
        after = float(ce_loss(batch, None))
    moved = [not torch.equal(p.detach(), p0) for p, p0 in
             zip([p for p in layer.parameters() if p.requires_grad], before)]
    med = statistics.median(step_ms[1:])
    log(f"phase 8 CE training: {med:.3f} ms/step median of steps 2-{TRAIN_STEPS} "
        f"{[round(t, 3) for t in step_ms]}, {B / (med / 1e3):.1f} seqs/s (b={B}, L={L}, P={PF}, "
        f"Adam 1e-2) on {smi}; loss {losses[0]:.6f} at step 1 -> {after:.6f} after step "
        f"{TRAIN_STEPS}; every trainable parameter moved: {all(moved)}")
    if not all(np.isfinite(losses + [after])) or not after < losses[0] or not all(moved):
        raise AssertionError("posterior-CE training: loss not finite, not falling, or a parameter did not move")

    map_trainer = Trainer(layer, optimizer=adam)
    map_trainer.init_from_params()
    map_ms = []
    for i in range(MAP_STEPS):
        reset_all(cuda_forward, cuda_adjoint)
        t0 = time.perf_counter()
        loss = map_trainer.fit([X])
        torch.cuda.synchronize()
        map_ms.append(1e3 * (time.perf_counter() - t0))
        launches = all_launches(cuda_forward, cuda_adjoint)
        log(f"phase 8 MAP step {i + 1}: loss {float(loss):.3f}, {map_ms[-1]:.3f} ms, launches {launches}")
        expected = {"sum_chunk_summaries": 1, "sum_fwd_outputs": 1, "beta_bwd_outputs": 1,
                    "sum_forward_wide": 0, "sum_backward_wide": 0,
                    "affine_chunk_composites": 0, "affine_reverse_outputs": 0}
        if launches != expected or not np.isfinite(float(loss)):
            raise AssertionError(f"MAP step {i + 1}: launch counts {launches}, expected {expected}")
    log(f"phase 8 MAP training: {map_ms[-1]:.3f} ms/step (step {MAP_STEPS}), "
        f"{B / (map_ms[-1] / 1e3):.1f} seqs/s")
    return total, X, labels, mask


def gradient_checks(layer, X, labels, mask, make, recursion):
    """Kernel-route gradients of every parameter against the plain route
    at the flagship shape, and against float64 autograd through the
    sequential engine at b=2, L=1200.

    Route limit: 1e-4 of the gradient's max, or, where larger, the largest
    difference between the two routes' posteriors gamma on the same input.
    Both routes carry log-scales of |loglik| (1.1e5 at L=9999, float32
    spacing 2^-7) that they round independently, so their gammas already
    differ by a few 1e-2 at the flagship (phase 4); the gradients are built
    from those gammas and cannot agree more closely.
    """
    names = [n for n, p in layer.named_parameters() if p.requires_grad]
    with torch.no_grad():
        lg_k = layer.state_posterior_log_probs(X)
        with plain_route(recursion):
            lg_p = layer.state_posterior_log_probs(X)
        d_gamma = float((lg_k.exp() - lg_p.exp()).abs().max())
    limit = max(1e-4, d_gamma)
    for objective in ("ce", "map"):
        v_k, g_k = param_grads(layer, objective, X, labels, mask)
        with plain_route(recursion):
            v_p, g_p = param_grads(layer, objective, X, labels, mask)
        rel = [float((a - r).abs().max() / r.abs().max()) for a, r in zip(g_k, g_p)]
        log(f"phase 8 gradients {objective} (b={B}, L={L}): kernel route vs plain route on the card, "
            f"max |diff| / max |plain| per parameter {dict(zip(names, [f'{x:.3e}' for x in rel]))} "
            f"(limit {limit:.3e}: max of 1e-4 and the routes' gamma difference); loss "
            f"{float(v_k):.6f} vs {float(v_p):.6f}")
        if max(rel) > limit:
            raise AssertionError(f"{objective}: kernel-route gradients differ from the plain route")

    # float64 oracle: the same float32 init, A and E, the sequential
    # recursion in float64, autograd back to the parameters.
    Xs = make(SEED + 31, 2, 1200)
    labels_s, mask_s = ce_targets(layer, Xs)
    pars = [p for p in layer.parameters() if p.requires_grad]
    init, A = layer.transitions.matrices()
    E = layer.emission_probs(Xs, training=True)
    lg, _ = recursion.posterior(init.double(), A.double(), E.double(), 1)
    ce = -torch.gather(lg, -1, labels_s[None, ..., None])[..., 0]
    g64 = torch.autograd.grad((ce * mask_s).sum() / mask_s.sum(), pars)
    _, g_k = param_grads(layer, "ce", Xs, labels_s, mask_s)
    with plain_route(recursion):
        _, g_p = param_grads(layer, "ce", Xs, labels_s, mask_s)
    err_k = [float((a - r).abs().max() / r.abs().max()) for a, r in zip(g_k, g64)]
    err_p = [float((a - r).abs().max() / r.abs().max()) for a, r in zip(g_p, g64)]
    limits = [max(5e-4, 1.25 * e + 1e-5) for e in err_p]
    log(f"phase 8 gradients ce (b=2, L=1200, P={layer._pf(E)}) vs float64 sequential autograd, "
        f"max |diff| / max |f64| per parameter: kernel route {[f'{x:.3e}' for x in err_k]}, plain "
        f"route {[f'{x:.3e}' for x in err_p]}; limit max(5e-4, 1.25 x plain route + 1e-5)")
    if any(e > lim for e, lim in zip(err_k, limits)):
        raise AssertionError("kernel-route gradients are further from float64 than the float32 bound")


def stage_clock(recursion, stage_of, stages):
    """Context: each function ``name`` of ``recursion`` in ``stage_of`` is
    wrapped with a synchronised host clock whose ms add up under
    ``stages[stage_of[name]]``; the originals are restored on exit."""
    import contextlib

    originals = {name: getattr(recursion, name) for name in stage_of}

    def wrap(name):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](*args, **kwargs)
            torch.cuda.synchronize()
            key = stage_of[name]
            stages[key] = stages.get(key, 0.0) + 1e3 * (time.perf_counter() - t0)
            return out

        return timed

    @contextlib.contextmanager
    def ctx():
        for name in stage_of:
            setattr(recursion, name, wrap(name))
        try:
            yield
        finally:
            for name, fn in originals.items():
                setattr(recursion, name, fn)

    return ctx()


def backward_stage_split(layer, X, labels, mask, recursion):
    """One posterior-CE backward split into its stages (each stage function
    of the analytic VJP timed, synchronised), then one MAP step's forward
    and backward likewise."""
    stage_of = {
        "_forward_adjoint_weights": "adjoint weights",
        "_backward_adjoint_weights": "adjoint weights",
        "_affine_kernel_lanes": "lane layout of u, v and the source (once, for K4 and K5)",
        "_affine_composites_kernels": "K4 affine_chunk_composites",
        "_affine_boundary_fold": "boundary fold (P affine steps)",
        "_affine_outputs_kernels": "K5 affine_reverse_outputs (with the x_right and output layouts)",
        "_posterior_analytic_vjp": "analytic VJP",
    }
    stages = {}
    pars = [p for p in layer.parameters() if p.requires_grad]
    for _ in range(2):  # second pass is the one kept
        stages.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = layer.posterior_cross_entropy(X, labels, label_mask=mask)
        torch.cuda.synchronize()
        forward_ms = 1e3 * (time.perf_counter() - t0)
        with stage_clock(recursion, stage_of, stages):
            t0 = time.perf_counter()
            torch.autograd.grad(loss, pars)
            torch.cuda.synchronize()
            backward_ms = 1e3 * (time.perf_counter() - t0)
    vjp = stages.pop("analytic VJP")
    inner = sum(stages.values())
    stages["gamma, centred source, stacking; gE, ginit and gA assembly"] = vjp - inner
    stages["CE, emission and transition backward (autograd)"] = backward_ms - vjp
    log(f"phase 8 forward (posterior CE, K1-K3): {forward_ms:.3f} ms")
    for name, ms in stages.items():
        log(f"phase 8 backward stage {name}: {ms:.3f} ms ({100 * ms / backward_ms:.1f}%)")
    log(f"phase 8 backward total: {backward_ms:.3f} ms (synchronised after each stage)")

    map_stage_of = {
        "_chunk_summaries_dispatch": "K1 sum_chunk_summaries (with layout)",
        "_loglik_from_C": "forward fold (P logmatvec steps)",
        "_boundary_values": "backward boundary fold (prefix and suffix)",
        "_outputs_kernels": "K2 + K3 (with boundary starts)",
        "_loglik_bw_stats": "Baum-Welch statistics (gE, ginit, gA)",
    }
    for _ in range(2):
        stages.clear()
        with stage_clock(recursion, map_stage_of, stages):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.autograd.grad(layer.loss(X), pars)
            torch.cuda.synchronize()
            map_ms = 1e3 * (time.perf_counter() - t0)
    stages["emissions, transitions, loss and autograd"] = map_ms - sum(stages.values())
    for name, ms in stages.items():
        log(f"phase 8 MAP stage {name}: {ms:.3f} ms ({100 * ms / map_ms:.1f}%)")
    log(f"phase 8 MAP forward + backward total: {map_ms:.3f} ms (synchronised after each stage)")


def train_cli_phase(fasta, npz, gff, cuda_forward, cuda_adjoint, tmp):
    """``python -m hmm_layer_torch train`` in-process on phase 7's files,
    then ``predict --params`` on the checkpoint it wrote."""
    from hmm_layer_torch import cli
    from hmm_layer_torch.models import flip_genes, genes_to_states, read_gff3, write_gff3

    window, batch, pf = L, B, PF
    out, pred = f"{tmp}/trained.npz", f"{tmp}/trained_pred.gff3"
    lengths = {f"ctg{i}": n for i, n in enumerate(PREDICT_CONTIGS)}

    def labelable(g, n):
        """Whether a state track can label ``g``: fragments cut at window
        borders (introns without CDS, CDS phases that do not chain) cannot."""
        if g.strand == "-":
            g = flip_genes([g], n)[0]
        try:
            genes_to_states([g], n, num_states=NUM_CLASSES)
        except ValueError:
            return False
        return True

    found = read_gff3(gff)
    genes = {name: [g for g in gs if labelable(g, lengths[name])] for name, gs in found.items()}
    gff = f"{tmp}/reference.gff3"
    write_gff3(genes, gff)
    log(f"phase 8 reference annotation: {sum(map(len, genes.values()))} of phase 7's "
        f"{sum(map(len, found.values()))} genes (the rest are window-border fragments)")
    argv = ["train", "-i", fasta, "-a", gff, "-o", out, "--class-probs", npz, "--objective", "ce",
            "--both-strands", "--window", str(window), "--batch", str(batch),
            "--parallel-factor", str(pf), "--steps", str(CLI_STEPS)]
    torch.cuda.synchronize()
    reset_all(cuda_forward, cuda_adjoint)
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError("train returned non-zero")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches(cuda_forward, cuda_adjoint)
    log(f"phase 8 train CLI launches: {launches} ({CLI_STEPS} steps)")
    if launches != {k: 0 if k in SUM_WIDE_KEYS else CLI_STEPS for k in launches}:
        raise AssertionError(f"train launch counts {launches}, expected {CLI_STEPS} each of K1-K5")
    bp = CLI_STEPS * batch * window
    log(f"phase 8 train CLI: {CLI_STEPS} steps of {batch} x {window} bp = {bp} bp in {wall:.3f} s "
        f"(whole command: FASTA, GFF3 and class probabilities read, windows and labels built): "
        f"{bp / wall:,.0f} bp/s")
    if cli.main(["predict", "-i", fasta, "-o", pred, "--class-probs", npz, "--params", out,
                 "--window", str(window), "--batch", str(batch), "--parallel-factor", str(pf)]) != 0:
        raise AssertionError("predict --params on the trained checkpoint returned non-zero")
    n_genes = sum(len(g) for g in read_gff3(pred).values())
    log(f"phase 8 predict --params {out.rsplit('/', 1)[-1]}: loaded, {n_genes} genes on the plus strands")


# ---------------------------------------------------------------------------
# 9. Multi-copy gene prediction (q = 1 + 14k)
# ---------------------------------------------------------------------------

MC_K = 2  # the multi-copy cell: k = 2 copies, q = 29
BLOCKED_KEYS = ("maxplus_deltas_blocked", "maxplus_backtrace_blocked")
WIDE_KEYS = ("maxplus_deltas_wide", "maxplus_backtrace_wide")
WIDE_K = 36  # config 5 and genepred-q505-predict: k = 36 copies, q = 505


def build_multicopy_layer(HMMLayer, models, k):
    """``GenePredMultiTransitions(k)`` + ``GenePredEmissions(num_copies=k)``
    from the 15-class kernel, random weights around that init (seeded)."""
    gen = torch.Generator().manual_seed(SEED + k)
    layer = HMMLayer(
        models.GenePredMultiTransitions(k=k, generator=gen),
        models.GenePredEmissions(num_copies=k, init=models.make_15_class_emission_kernel(num_copies=k),
                                 **CODONS),
        use_prior=False,
        parallel_factor="auto",
    )
    with torch.no_grad():
        for p in layer.parameters():
            p.add_((0.5 * torch.randn(p.shape, generator=gen)).to(p.device))
    return layer


def seq_decode_inputs(layer, X):
    """log A, log E (m, b, L, q), delta0 (m, b, q) of the sequential
    decode, as ``recursion._viterbi_seq_kernels`` builds them."""
    init, A = layer.transitions.matrices()
    E = layer.emission_probs(X)
    log_A = torch.log(A.clamp_min(EPS)).contiguous()
    log_E = torch.log(E.clamp_min(EPS)).contiguous()
    delta0 = (torch.log(init.clamp_min(EPS))[:, None, :] + log_E[:, :, 0]).contiguous()
    return log_A, log_E, delta0


def chain_floor_ms(steps, q, sm_mhz):
    """K7b's chain floor in ms: ``steps`` dependent steps of the cycle
    model above at ``sm_mhz``."""
    cycles = (FLOAT_OP_CYCLES * (2 + math.ceil(math.log2(q))) + SMEM_ROUND_TRIP_CYCLES
              + BARRIER_CYCLES)
    return steps * cycles / (sm_mhz * 1e3), cycles


def blocked_kernel_phase(layers, make, cuda_viterbi, peak_bytes, peak_flops, sm_mhz):
    """K7b and K8b against their plain versions (bit-equal) at b=32,
    L=9999, q=29 (recorded) and q=57, on the sequence-major layout of the
    decode. The plain versions loop 9,999 eager steps: 3 samples each."""
    records = {}
    for k, layer in layers.items():
        with torch.inference_mode():
            log_A, log_E, delta0 = seq_decode_inputs(layer, make(SEED + 40 + k, B, L))
            m, R, c, q = log_E.shape
            d_plain = cuda_viterbi.maxplus_deltas_seq_plain(log_A, log_E, delta0)
            d_kern = cuda_viterbi.maxplus_deltas_seq(log_A, log_E, delta0)
            last = d_plain[:, :, -1].argmax(dim=-1).to(torch.int32)
            s_plain = cuda_viterbi.maxplus_backtrace_seq_plain(log_A, d_plain, last)
            s_kern = cuda_viterbi.maxplus_backtrace_seq(log_A, d_plain, last)
            e_bytes, a_bytes = 4 * m * c * q * R, 4 * m * q * q
            cases = {
                "maxplus_deltas_blocked": (
                    lambda: cuda_viterbi.maxplus_deltas_seq(log_A, log_E, delta0),
                    lambda: cuda_viterbi.maxplus_deltas_seq_plain(log_A, log_E, delta0),
                    d_kern, d_plain, a_bytes + 2 * e_bytes + 4 * m * q * R, m * R * (c - 1) * 2 * q * q,
                ),
                "maxplus_backtrace_blocked": (
                    lambda: cuda_viterbi.maxplus_backtrace_seq(log_A, d_plain, last),
                    lambda: cuda_viterbi.maxplus_backtrace_seq_plain(log_A, d_plain, last),
                    s_kern, s_plain, a_bytes + e_bytes + 4 * m * R + 4 * m * c * R,
                    m * R * (c - 1) * 2 * q,
                ),
            }
            failed = []
            for name, (kern, plain, got, ref, nbytes, nops) in cases.items():
                torch.cuda.synchronize()
                equal = torch.equal(got, ref)
                err = float((got.double() - ref.double()).abs().max())
                rec = measure(name, kern, plain, err, nbytes, nops, peak_bytes, peak_flops,
                              reps=5, plain_samples=3)
                if q == 1 + 14 * MC_K:
                    records[name] = rec
                floor = ""
                if name == "maxplus_deltas_blocked":
                    floor_ms, cycles = chain_floor_ms(c - 1, q, sm_mhz)
                    floor = (f"; chain floor {floor_ms:.4f} ms ({c - 1} steps of {cycles} cycles at "
                             f"{sm_mhz} MHz, a model)")
                log(f"phase 9 {name} q={q} (b={R}, L={c}): {'equal' if equal else 'MISMATCH'} "
                    f"max_abs_err={err:.3e} (bit-equality required) {timing_text(rec, nbytes, nops)}"
                    f"{floor}{cold_text(name, kern, rec)}")
                if not equal:
                    failed.append(f"{name} q={q}")
        if failed:
            raise AssertionError(f"blocked kernels differ from their plain versions: {failed}")
    return records


def mxu_inputs(layer, X, recursion, P):
    """(A, E_S (m, c, R, q)) of a K9 call, as the gated log-likelihood lays
    them out ("auto" gives P = 33 at q = 29)."""
    _, A = layer.transitions.matrices()
    Ec, _ = recursion._split_chunks(layer.emission_probs(X).clamp_min(EPS), P)
    return A.contiguous(), Ec.transpose(1, 2).contiguous()


def mxu_kernel_phase(layers, make, recursion, cuda_mxu, peak_bytes, peak_flops):
    """K9 against its plain version at q=29 (b=32, P=33: recorded), at
    q=29 with short chunks (P=303, c=33: |C| small enough that the order of
    the sums shows) and at q=127 (b=4, P=33: A and two buffers of the
    operator take 192 KB of shared memory), warm and cold. Sums run in
    another order, so the limit is a float32 accumulation bound: on entries
    within 30 nats of their row's maximum, |kernel - plain| <= 2e-4 + the
    ``f32_log_bound`` of |C| over c steps."""
    records = {}
    for k, b, P in ((MC_K, B, PF), (MC_K, B, 303), (9, 4, PF)):
        with torch.inference_mode():
            A, E_S = mxu_inputs(layers[k], make(SEED + 45 + k, b, L), recursion, P)
            m, c, R, q = E_S.shape
            C_plain = cuda_mxu.sum_chunk_summaries_mxu_plain(A, E_S, P)
            C_kern = cuda_mxu.sum_chunk_summaries_mxu(A, E_S, P)
            torch.cuda.synchronize()
            mask = C_plain >= C_plain.amax(-1, keepdim=True) - 30.0
            atol = 2e-4 + f32_log_bound(C_plain[mask], c)
            err, ok = within(C_kern, C_plain, 0.0, atol, mask)
            name = "sum_chunk_summaries_mxu"
            nbytes = 4 * m * q * q + 4 * m * c * R * q + 4 * m * R * q * q
            nops = m * R * q * (c - 1) * q * (2 * q + 4)  # FMA = 2; clamp, product, sum, divide
            rec = measure(name, lambda: cuda_mxu.sum_chunk_summaries_mxu(A, E_S, P),
                          lambda: cuda_mxu.sum_chunk_summaries_mxu_plain(A, E_S, P),
                          err, nbytes, nops, peak_bytes, peak_flops, reps=5 if q < 64 else 2,
                          plain_samples=5)
            if (k, P) == (MC_K, PF):
                records[name] = rec
            kern = lambda: cuda_mxu.sum_chunk_summaries_mxu(A, E_S, P)  # noqa: E731
            log(f"phase 9 {name} q={q} (b={b}, P={P}, c={c}, R={R}): {'ok' if ok else 'MISMATCH'} "
                f"max_abs_err={err:.3e} (limit {atol:.3e} within 30 nats of the row max; |C| max "
                f"{float(C_plain.abs().max()):.1f}) {timing_text(rec, nbytes, nops)}"
                f"{cold_text(name, kern, rec)}")
            if not ok:
                raise AssertionError(f"K9 disagrees with its plain version at q={q}")
    return records


def plain_decode_wrappers(cuda_viterbi):
    """Context: the decode glue calls the plain versions on the card."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = cuda_viterbi.maxplus_deltas_seq, cuda_viterbi.maxplus_backtrace_seq
        cuda_viterbi.maxplus_deltas_seq = cuda_viterbi.maxplus_deltas_seq_plain
        cuda_viterbi.maxplus_backtrace_seq = cuda_viterbi.maxplus_backtrace_seq_plain
        try:
            yield
        finally:
            cuda_viterbi.maxplus_deltas_seq, cuda_viterbi.maxplus_backtrace_seq = saved

    return ctx()


def multicopy_decode_phase(layer, make, recursion, cuda_viterbi):
    """``HMMLayer.viterbi`` serving 3 multi-copy requests (q=29, b=32,
    L=9999): K7b and K8b once each per request, paths identical to the same
    glue on the plain versions, valid and score-equal to ``_viterbi_seq``."""
    q = 1 + 14 * MC_K
    requests = [make(SEED + 50 + i, B, L) for i in range(N_REQUESTS)]
    with torch.inference_mode():
        layer.viterbi(requests[0])  # warm-up, not counted
        torch.cuda.synchronize()

        cuda_viterbi.reset_launches()
        paths = [layer.viterbi(X) for X in requests]
        torch.cuda.synchronize()
        launches = dict(cuda_viterbi.LAUNCHES)
        log(f"phase 9 launches over {N_REQUESTS} multi-copy decode requests: {launches}")
        expected = {k: N_REQUESTS if k in BLOCKED_KEYS else 0 for k in cuda_viterbi.LAUNCHES}
        if launches != expected:
            raise AssertionError(f"multi-copy decode launch counts {launches}, expected {expected}")

        for i, (X, path) in enumerate(zip(requests, paths)):
            if tuple(path.shape) != (1, B, L) or path.dtype != torch.int32:
                raise AssertionError(f"request {i}: paths {path.dtype} {tuple(path.shape)}")
            if int(path.min()) < 0 or int(path.max()) >= q:
                raise AssertionError(f"request {i}: states out of range")
            init, A = layer.transitions.matrices()
            E = layer.emission_probs(X)
            with plain_decode_wrappers(cuda_viterbi):
                plain = recursion._viterbi_seq_kernels(init, A, E)
            seq = recursion._viterbi_seq(init, A, E)
            same = torch.equal(path, plain)
            s_k, used_k = path_score64(init, A, E, path)
            s_s, used_s = path_score64(init, A, E, seq)
            rel = float(((s_k - s_s).abs() / s_s.abs()).max())
            valid = bool(used_k[used_s.all(-1)].all())
            log(f"phase 9 request {i}: paths {'identical to' if same else 'DIFFER FROM'} the plain "
                f"versions' route; vs _viterbi_seq: float64 path score max rel diff {rel:.3e} "
                f"(limit 1e-6), positions differing {int((path != seq).sum())}, A = 0 transitions "
                f"avoided as the sequential path avoids them: {valid}")
            if not same or rel > 1e-6 or not valid:
                raise AssertionError(f"multi-copy request {i}: decode disagrees")

        decode_ms = []
        for X in requests * 3:
            t0 = time.perf_counter()
            layer.viterbi(X)
            torch.cuda.synchronize()
            decode_ms.append(1e3 * (time.perf_counter() - t0))
    return launches, decode_ms


def wide_kernel_phase(HMMLayer, models, make, recursion, cuda_viterbi, peak_bytes, peak_flops):
    """K7c and K8c against their plain versions (K7c's pointers and last
    delta bit-equal, K8c's paths equal) at config 5's decode (k = 36, q =
    505, b=32, L=9999, the genepred-q505-predict cell's batch), warm and
    cold, beside their bounds; then ``HMMLayer.viterbi`` serving 3 requests
    (K7c, K8c once each per request; paths equal to ``_viterbi_seq``'s on
    the card), ms/batch and the profiler's busy share."""
    layer = build_multicopy_layer(HMMLayer, models, WIDE_K)
    records = {}
    with torch.inference_mode():
        log_A, log_E, delta0 = seq_decode_inputs(layer, make(SEED + 70, B, L))
        m, R, c, q = log_E.shape
        bp, last = cuda_viterbi.maxplus_deltas_wide(log_A, log_E, delta0)
        bp_p, last_p = cuda_viterbi.maxplus_deltas_wide_plain(log_A, log_E, delta0)
        states = cuda_viterbi.maxplus_backtrace_wide(bp_p, last_p)
        states_p = cuda_viterbi.maxplus_backtrace_wide_plain(bp_p, last_p)
        torch.cuda.synchronize()
        bp_bytes, path_bytes = 2 * m * R * (c - 1) * q, 4 * m * R * c
        cases = {
            # Operations: one add and one max per (k, j) term of a step.
            "maxplus_deltas_wide": (
                lambda: cuda_viterbi.maxplus_deltas_wide(log_A, log_E, delta0),
                lambda: cuda_viterbi.maxplus_deltas_wide_plain(log_A, log_E, delta0),
                torch.equal(bp, bp_p) and torch.equal(last, last_p),
                4 * m * q * q + 4 * m * R * c * q + 4 * m * R * q + bp_bytes + 4 * m * R * q,
                m * R * (c - 1) * 2 * q * q,
            ),
            "maxplus_backtrace_wide": (
                lambda: cuda_viterbi.maxplus_backtrace_wide(bp_p, last_p),
                lambda: cuda_viterbi.maxplus_backtrace_wide_plain(bp_p, last_p),
                torch.equal(states, states_p),
                bp_bytes + 4 * m * R * q + path_bytes,
                m * R * (c - 1),
            ),
        }
        for name, (kern, plain, equal, nbytes, nops) in cases.items():
            rec = measure(name, kern, plain, 0.0 if equal else float("nan"), nbytes, nops, peak_bytes,
                          peak_flops, reps=1, plain_samples=1)
            records[name] = rec
            log(f"phase 9 {name} q={q} (b={R}, L={c}): {'equal' if equal else 'MISMATCH'} "
                f"(bit-equality required) {timing_text(rec, nbytes, nops)}{cold_text(name, kern, rec)}")
            if not equal:
                raise AssertionError(f"{name} differs from its plain version at q={q}")
        del bp, last, bp_p, last_p, log_E

        requests = [make(SEED + 71 + i, B, L) for i in range(N_REQUESTS)]
        layer.viterbi(requests[0])  # warm-up, not counted
        torch.cuda.synchronize()
        cuda_viterbi.reset_launches()
        paths = [layer.viterbi(X) for X in requests]
        torch.cuda.synchronize()
        launches = dict(cuda_viterbi.LAUNCHES)
        log(f"phase 9 launches over {N_REQUESTS} config 5 decode requests: {launches}")
        expect(launches, **{k: N_REQUESTS for k in WIDE_KEYS})
        for i, (X, path) in enumerate(zip(requests, paths)):
            init, A = layer.transitions.matrices()
            same = torch.equal(path, recursion._viterbi_seq(init, A, layer.emission_probs(X)))
            log(f"phase 9 config 5 request {i}: paths {'identical to' if same else 'DIFFER FROM'} _viterbi_seq's")
            if not same:
                raise AssertionError(f"config 5 request {i}: K7c + K8c paths differ from _viterbi_seq's")
        decode_ms = []
        for X in requests * 3:
            decode_ms.append(synced_ms(lambda: layer.viterbi(X))[1])
    med = statistics.median(decode_ms)
    log(f"phase 9 config 5 decode (q={q}): {med:.3f} ms/batch median of {len(decode_ms)} "
        f"[{min(decode_ms):.3f}, {max(decode_ms):.3f}], {B / (med / 1e3):.1f} seqs/sec (b={B}, L={L}, "
        f"sequential decode through K7c + K8c)")
    profile_request("phase 9 config 5 decode", lambda: layer.viterbi(requests[0]), "K7c-K8c",
                    ("deltas_wide_kernel", "backtrace_wide_"))
    return records, launches


def multicopy_loglik_phase(layer, make, recursion, cuda_mxu, cuda_forward):
    """``HMMLayer.log_likelihood`` serving 3 multi-copy requests with the
    K9 gate off (plain summaries), then on (K9 once per request, K1 never);
    the two against each other and, on a small input, against the
    sequential recursion; the profiler's device busy time and K9 time of
    one gated request; then one MAP ``loss`` step with the gate on."""
    requests = [make(SEED + 60 + i, B, L) for i in range(N_REQUESTS)]
    saved_gate = cuda_mxu.MXU_KERNELS

    def serve(n=3):
        times, out = [], []
        for X in requests * n:
            t0 = time.perf_counter()
            out.append(layer.log_likelihood(X))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return out[:N_REQUESTS], times

    try:
        with torch.inference_mode():
            cuda_mxu.MXU_KERNELS = False
            off, off_ms = serve()
            cuda_mxu.MXU_KERNELS = True
            layer.log_likelihood(requests[0])  # warm-up, not counted
            torch.cuda.synchronize()
            cuda_mxu.reset_launches()
            cuda_forward.reset_launches()
            on, _ = serve(1)
            launches = {**cuda_mxu.LAUNCHES, "sum_chunk_summaries": cuda_forward.LAUNCHES["sum_chunk_summaries"]}
            log(f"phase 9 launches over {N_REQUESTS} multi-copy loglik requests (gate on): {launches}")
            if launches != {"sum_chunk_summaries_mxu": N_REQUESTS, "sum_chunk_summaries": 0}:
                raise AssertionError(f"gated loglik launch counts {launches}")
            for i, (ll_on, ll_off) in enumerate(zip(on, off)):
                if tuple(ll_on.shape) != (1, B) or not torch.isfinite(ll_on).all():
                    raise AssertionError(f"request {i}: loglik {tuple(ll_on.shape)} or not finite")
                err, ok = within(ll_on, ll_off, 1e-5, 0.0)
                log(f"phase 9 request {i}: loglik {float(ll_on.mean()):.2f} mean, gate on vs off "
                    f"max abs {err:.3e} (rtol 1e-5)")
                if not ok:
                    raise AssertionError(f"request {i}: K9 loglik disagrees with the plain summaries")
            _, on_ms = serve()
            profile_request("phase 9 loglik (gate on)", lambda: layer.log_likelihood(requests[0]), "K9",
                            ("mxu_summary_kernel",))

            Xs = make(SEED + 97, 2, 600)
            init, A = layer.transitions.matrices()
            Es = layer.emission_probs(Xs)
            P_small = recursion.recommended_parallel_factor(600, Es.shape[-1], 1)
            ll_k = recursion.log_likelihood(init, A, Es, P_small)
            ll_s = recursion.log_likelihood(init, A, Es, 1)
            err, ok = within(ll_k, ll_s, 2e-4, 0.0)
            log(f"phase 9 small input (b=2, L=600, P={P_small}, gate on) vs sequential: loglik max "
                f"abs {err:.3e} (rtol 2e-4)")
            if not ok:
                raise AssertionError("small input: K9 loglik disagrees with the sequential recursion")

        pars = [p for p in layer.parameters() if p.requires_grad]
        X = requests[0]
        cuda_mxu.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = layer.loss(X)
        grads = torch.autograd.grad(loss, pars)
        torch.cuda.synchronize()
        map_ms = 1e3 * (time.perf_counter() - t0)
        k9 = cuda_mxu.LAUNCHES["sum_chunk_summaries_mxu"]
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        loss = float(loss.detach())
        log(f"phase 9 MAP loss step (gate on): loss {loss:.3f}, forward + backward "
            f"{map_ms:.3f} ms, K9 launches {k9} (C saved), every gradient finite: {finite}")
        if k9 != 1 or not finite or not math.isfinite(loss):
            raise AssertionError("multi-copy MAP step: K9 launches or gradients wrong")
    finally:
        cuda_mxu.MXU_KERNELS = saved_gate
    return launches, off_ms, on_ms



# ---------------------------------------------------------------------------
# 10. Options and auxiliary inference
# ---------------------------------------------------------------------------

EMB_DIM = 32  # embedding channels of phase 10 (the repo fixes no width)
SAMPLES, FREQ_SAMPLES = 8, 1000  # paths per request; paths of the frequency check
EM_STEPS, OPTION_STEPS = 3, 2
STREAM_BLOCK = L // 3  # 3333 = 33 x 101
# The smoother's windows hold 1 + lag + 3333 positions after the first (the
# seam's pseudo-position in front) and 1 + lag at the end: at lag 263 they
# are 3597 = 33 x 109 and 264 = 33 x 8, so every window takes the chunked
# route at P = 33 (at lag 256 all but the first would run sequentially).
SMOOTHER_LAG, VITERBI_LAG = 263, 256
K1_K3 = ("sum_chunk_summaries", "sum_fwd_outputs", "beta_bwd_outputs")
K1_K3_KEYS = ("outputs_kernel", "chunk_summaries_rows_kernel")  # their profiler names


def with_embeddings(X, seed):
    """The class channels, ``EMB_DIM`` seeded N(0, 1) embedding channels,
    the nucleotide channels."""
    gen = torch.Generator(device=X.device).manual_seed(seed)
    emb = torch.randn(X.shape[:-1] + (EMB_DIM,), generator=gen, device=X.device)
    return torch.cat([X[..., :NUM_CLASSES], emb, X[..., NUM_CLASSES:]], dim=-1)


def launches_of(cuda_forward, cuda_adjoint, cuda_mxu):
    return {**all_launches(cuda_forward, cuda_adjoint), **cuda_mxu.LAUNCHES}


def reset_phase10(cuda_forward, cuda_adjoint, cuda_mxu):
    reset_all(cuda_forward, cuda_adjoint)
    cuda_mxu.reset_launches()


def expect(launches, **want):
    """Fail unless ``launches`` holds ``want`` and zero for every other kernel."""
    wanted = {k: want.get(k, 0) for k in launches}
    if launches != wanted:
        raise AssertionError(f"launch counts {launches}, expected {wanted}")


def posterior_route_check(tag, layer, X, lg, recursion):
    """The phase-4 criteria: log gamma against the same layer's plain
    route where gamma >= 1e-3 within twice the float32 bound, and its
    normalisation within the bound of the plain route's own (emissions
    far below the engine's EPS clamp, as an MVN gives states far from a
    position's best one, keep log gamma from normalising in both routes
    and in the JAX package alike)."""
    with torch.inference_mode():
        init, A = layer.transitions.matrices()
        E = layer.emission_probs(X)
        P = layer._pf(E)
        with plain_route(recursion):
            lg_p, ll_p = recursion.posterior(init, A, E, P)
    bound = f32_log_bound(ll_p, E.shape[2] // P)
    err, ok = within(lg, lg_p, 0.0, 2 * bound, mask=lg_p.exp() >= 1e-3)
    norm = float(torch.logsumexp(lg, -1).abs().max())
    norm_p = float(torch.logsumexp(lg_p, -1).abs().max())
    log(f"phase 10 {tag}: log gamma vs plain route where gamma >= 1e-3 max abs {err:.3e} "
        f"(bound {2 * bound:.3f}); |logsumexp(log gamma)| max {norm:.3e} (plain route "
        f"{norm_p:.3e}; bound {bound:.3f} above the larger of 0 and the plain route's)")
    if not ok or norm > max(bound, norm_p + bound) or not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"{tag}: kernel route disagrees with the plain route")


def serve_posteriors(tag, layer, requests, counters):
    """One posterior per request (K1-K3 once each); ms per batch."""
    ms, out = [], []
    with torch.inference_mode():
        layer.state_posterior_log_probs(requests[0])  # warm-up, not counted
        torch.cuda.synchronize()
        for X in requests:
            reset_phase10(*counters)
            t0 = time.perf_counter()
            out.append(layer.state_posterior_log_probs(X))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            launches = launches_of(*counters)
            expect(launches, **{k: 1 for k in K1_K3})
    log(f"phase 10 {tag}: {len(requests)} posterior requests, launches {launches} each, "
        f"{statistics.median(ms):.3f} ms/batch median {[round(t, 3) for t in ms]}")
    return out, ms


def embedding_phase(HMMLayer, models, requests, recursion, counters, smi):
    """``emit_embeddings`` (d = 32): 3 posterior requests, 2 CE steps with
    the aux loss, one full-covariance request; the MVN's peak memory."""
    make_emb = lambda full: seeded_layer(  # noqa: E731
        HMMLayer, models.GenePredTransitions(),
        models.GenePredEmissions(**CODONS, emit_embeddings=True, embedding_dim=EMB_DIM,
                                 full_covariance=full, generator=torch.Generator().manual_seed(SEED)),
        SEED + 70, use_prior=False)
    layer = make_emb(False)
    Xs = [with_embeddings(X, SEED + 71 + i) for i, X in enumerate(requests)]
    out, ms = serve_posteriors("emit_embeddings (diagonal, d=32)", layer, Xs, counters)
    for i, (X, lg) in enumerate(zip(Xs, out)):
        posterior_route_check(f"emit_embeddings request {i}", layer, X, lg, recursion)
    profile_request("phase 10 emit_embeddings posterior", lambda: layer.state_posterior_log_probs(Xs[0]),
                    "K1-K3", K1_K3_KEYS)

    with torch.inference_mode():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        layer.emission_probs(Xs[0])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    log(f"phase 10 emit_embeddings emissions (b={B}, L={L}, 13 parameter states, d={EMB_DIM}): "
        f"peak {peak / 2**20:.1f} MiB above the inputs on {smi}")

    labels, mask = ce_targets(layer, Xs[0])
    pars = [p for p in layer.parameters() if p.requires_grad]
    before = [p.detach().clone() for p in pars]
    opt = torch.optim.Adam(pars, lr=1e-2)
    step_ms, losses = [], []
    for i in range(OPTION_STEPS):
        reset_phase10(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = layer.posterior_cross_entropy(Xs[0], labels, label_mask=mask)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        launches = launches_of(*counters)
        losses.append(float(loss.detach()))
        log(f"phase 10 emit_embeddings CE step {i + 1}: loss {losses[-1]:.6f} (aux "
            f"{float(layer.aux_loss().detach()):.6f}), {step_ms[-1]:.3f} ms, launches {launches}")
        expect(launches, **{k: 1 for k in K1_K3 + ("affine_chunk_composites", "affine_reverse_outputs")})
    moved = [not torch.equal(p.detach(), p0) for p, p0 in zip(pars, before)]
    log(f"phase 10 emit_embeddings CE: {step_ms[-1]:.3f} ms/step (step {OPTION_STEPS}); every "
        f"parameter moved: {all(moved)} ({len(pars)} parameters)")
    if not all(np.isfinite(losses)) or not all(moved):
        raise AssertionError("emit_embeddings CE: loss not finite or a parameter did not move")

    full = make_emb(True)
    with torch.inference_mode():
        full.state_posterior_log_probs(Xs[1])  # warm-up, not counted
        reset_phase10(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = full.state_posterior_log_probs(Xs[1])
        torch.cuda.synchronize()
        full_ms = 1e3 * (time.perf_counter() - t0)
        expect(launches_of(*counters), **{k: 1 for k in K1_K3})
    log(f"phase 10 emit_embeddings full covariance: one request {full_ms:.3f} ms, K1-K3 once")
    posterior_route_check("emit_embeddings full covariance", full, Xs[1], lg, recursion)
    return {"emb_post_ms": statistics.median(ms), "emb_ce_ms": step_ms[-1], "emb_full_ms": full_ms,
            "emb_peak_mib": peak / 2**20}


def lookup_phase(HMMLayer, models, requests, recursion, counters):
    """``onehot_lookup_kmers``: emissions against the 3-mer contraction on
    the same weights, posterior requests beside the contraction path's."""
    base = build_layer(HMMLayer, models)
    lookup = HMMLayer(models.GenePredTransitions(),
                      models.GenePredEmissions(**CODONS, onehot_lookup_kmers=True),
                      use_prior=False, parallel_factor="auto")
    lookup.load_state_dict(base.state_dict())
    with torch.inference_mode():
        E_l, E_c = lookup.emission_probs(requests[0]), base.emission_probs(requests[0])
    err, ok = within(E_l, E_c, 1e-5, 0.0)
    log(f"phase 10 onehot_lookup_kmers emissions vs the 3-mer contraction: max abs {err:.3e} "
        f"(rtol 1e-5: a 64-term float32 sum against a table lookup)")
    if not ok:
        raise AssertionError("onehot_lookup_kmers emissions disagree with the contraction path")
    out, ms = serve_posteriors("onehot_lookup_kmers", lookup, requests, counters)
    posterior_route_check("onehot_lookup_kmers request 0", lookup, requests[0], out[0], recursion)
    _, ms_c = serve_posteriors("3-mer contraction (same weights)", base, requests, counters)
    return {"lookup_post_ms": statistics.median(ms), "einsum_post_ms": statistics.median(ms_c)}


def option_map_phase(HMMLayer, models, requests, counters):
    """``trainable_nucleotides_at_exons`` with ``use_experimental_prior``:
    2 MAP ``loss`` steps."""
    layer = seeded_layer(
        HMMLayer, models.GenePredTransitions(use_experimental_prior=True),
        models.GenePredEmissions(**CODONS, trainable_nucleotides_at_exons=True),
        SEED + 80, use_prior=True, num_seqs=100 * B)
    pars = dict(layer.named_parameters())
    opt = torch.optim.Adam(pars.values(), lr=1e-2)
    name = "emissions.0.nuc_emission_kernel"
    for i in range(OPTION_STEPS):
        reset_phase10(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = layer.loss(requests[0])
        loss.backward()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        launches = launches_of(*counters)
        prior = float(layer.compute_prior(scaled=False).detach().sum())
        g = pars[name].grad
        nuc_ok = bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
        opt.step()
        log(f"phase 10 exon nucleotides + Dirichlet prior MAP step {i + 1}: loss {float(loss.detach()):.3f}, "
            f"prior {prior:.3f}, |grad {name}| max {float(g.abs().max()):.3e}, {step_ms:.3f} ms, "
            f"launches {launches}")
        expect(launches, **{k: 1 for k in K1_K3})
        if not (math.isfinite(prior) and math.isfinite(float(loss.detach())) and nuc_ok):
            raise AssertionError("option MAP step: prior or loss not finite, or no nucleotide gradient")
    return {"option_map_ms": step_ms}


def check_paths(tag, paths, init, A):
    """Every first state has init > 0 and every sampled transition A > 0."""
    p = paths[0].long()
    first = bool((init[0][p[..., 0]] > 0).all())
    trans = bool((A[0][p[..., :-1], p[..., 1:]] > 0).all())
    if not (first and trans):
        raise AssertionError(f"{tag}: a sampled path takes a zero-probability start or transition")
    return p


def sampling_phase(HMMLayer, models, requests, counters, cuda_mxu):
    """``sample_paths``: S = 8 at q = 15 (K1 once a request), the state
    frequencies of 1000 paths of one sequence against exp(log gamma), and
    S = 8 at q = 29 with the K9 gate on (K9 once, K1 never)."""
    layer = build_layer(HMMLayer, models)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    init, A = (x.detach() for x in layer.transitions.matrices())
    layer.sample_paths(requests[0], num_samples=SAMPLES, generator=gen)  # warm-up
    ms = []
    for i, X in enumerate(requests):
        reset_phase10(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = layer.sample_paths(X, num_samples=SAMPLES, generator=gen)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        launches = launches_of(*counters)
        expect(launches, sum_chunk_summaries=1)
        if tuple(paths.shape) != (1, B, SAMPLES, L):
            raise AssertionError(f"sample_paths shape {tuple(paths.shape)}")
        check_paths(f"sample_paths request {i}", paths, init, A)
    log(f"phase 10 sample_paths (q=15, S={SAMPLES}, b={B}, L={L}): launches {launches} each; every "
        f"start has init > 0 and every transition A > 0; {statistics.median(ms):.3f} ms/batch median "
        f"{[round(t, 3) for t in ms]}")
    profile_request("phase 10 sample_paths", lambda: layer.sample_paths(
        requests[0], num_samples=SAMPLES, generator=gen), "K1", ("chunk_summaries_rows_kernel",))

    X1 = requests[0][:, :1]
    with torch.inference_mode():
        paths = layer.sample_paths(X1, num_samples=FREQ_SAMPLES, generator=gen)[0, 0].long()  # (S, L)
        lg = layer.state_posterior_log_probs(X1)[0, 0]
        counts = torch.zeros((L, 15), device=paths.device).scatter_add_(
            1, paths.T.contiguous(), torch.ones(paths.T.shape, device=paths.device))
    err = float((counts / FREQ_SAMPLES - lg.exp()).abs().max())
    tol = 4.5 / math.sqrt(FREQ_SAMPLES)
    log(f"phase 10 sample_paths state frequencies of {FREQ_SAMPLES} paths of one sequence vs "
        f"exp(log gamma): max abs {err:.3e} (tolerance 4.5/sqrt(S) = {tol:.3f})")
    if err > tol:
        raise AssertionError("sampled state frequencies disagree with the posterior")

    mc = build_multicopy_layer(HMMLayer, models, MC_K)
    init, A = (x.detach() for x in mc.transitions.matrices())
    saved = cuda_mxu.MXU_KERNELS
    try:
        cuda_mxu.MXU_KERNELS = True
        mc.sample_paths(requests[0], num_samples=SAMPLES, generator=gen)  # warm-up
        reset_phase10(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = mc.sample_paths(requests[0], num_samples=SAMPLES, generator=gen)
        torch.cuda.synchronize()
        mc_ms = 1e3 * (time.perf_counter() - t0)
        launches = launches_of(*counters)
    finally:
        cuda_mxu.MXU_KERNELS = saved
    expect(launches, sum_chunk_summaries_mxu=1)
    check_paths("sample_paths q=29", paths, init, A)
    log(f"phase 10 sample_paths (q={1 + 14 * MC_K}, S={SAMPLES}, K9 gate on): launches {launches}; "
        f"every start and transition valid; {mc_ms:.3f} ms")
    return {"sample_ms": statistics.median(ms), "sample_q29_ms": mc_ms}


def em_phase(HMMLayer, models, requests, recursion, counters):
    """``em_step``: 3 steps on the flagship's init, A, E (K1-K3 once a
    step), the log-likelihood not falling, stochastic rows; step 1 against
    the plain route."""
    from hmm_layer_torch.ops import em

    layer = build_layer(HMMLayer, models)
    with torch.inference_mode():
        init, A = layer.transitions.matrices()
        E = layer.emission_probs(requests[0])
        P = layer._pf(E)
        with plain_route(recursion):
            g_p, _, _ = em.expected_statistics(init, A, E, P)
            ref = em.em_step(init, A, E, P)
        g_k, _, _ = em.expected_statistics(init, A, E, P)
        d_gamma = float((g_k - g_p).abs().max())
        lls, ms = [], []
        for i in range(EM_STEPS):
            reset_phase10(*counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new_init, new_A, ll = em.em_step(init, A, E, P)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            launches = launches_of(*counters)
            expect(launches, **{k: 1 for k in K1_K3})
            if i == 0:
                limit = max(1e-3, d_gamma)
                errs = [within(a, r, 0.0, limit)[0] for a, r in zip((new_init, new_A), ref[:2])]
                ll_err, ll_ok = within(ll, ref[2], 1e-5, 0.0)
                log(f"phase 10 em_step 1 vs plain route: init, A max abs {errs[0]:.3e}, {errs[1]:.3e} "
                    f"(limit {limit:.3e}: max of 1e-3 and the routes' gamma difference); loglik max abs "
                    f"{ll_err:.3e} (rtol 1e-5)")
                if max(errs) > limit or not ll_ok:
                    raise AssertionError("em_step disagrees with the plain route")
            lls.append(float(ll.double().sum()))
            tol = B * f32_log_bound(ll, L // P)
            rows = new_A.sum(-1)
            stochastic = bool(((rows - 1).abs() <= 1e-5).all()) and abs(float(new_init.sum()) - 1) <= 1e-5
            kept = bool((new_A[A == 0] == 0).all())
            log(f"phase 10 em_step {i + 1}: summed loglik {lls[-1]:.3f}, {ms[-1]:.3f} ms, launches "
                f"{launches}; rows stochastic {stochastic}, structural zeros kept {kept}")
            if not (stochastic and kept) or (i and lls[-1] < lls[-2] - tol):
                raise AssertionError(f"em_step {i + 1}: loglik fell (tolerance {tol:.3f}) or rows broke")
            init, A = new_init, new_A
    log(f"phase 10 em_step: {statistics.median(ms):.3f} ms/step median {[round(t, 3) for t in ms]}")
    profile_request("phase 10 em_step", lambda: em.em_step(init, A, E, P), "K1-K3", K1_K3_KEYS)
    return {"em_ms": statistics.median(ms)}


def streaming_phase(HMMLayer, models, requests, recursion, counters):
    """The sequence cut into 3 blocks of 3333 at P = 33: the filter (K1
    once a block) against the whole-sequence log-likelihood, the smoother
    (lag 263) against the posterior of the sequence truncated at each
    window's end, and the fixed-lag Viterbi (lag 256)."""
    from hmm_layer_torch import streaming

    layer = build_layer(HMMLayer, models)
    with torch.inference_mode():
        init, A = layer.transitions.matrices()
        E = layer.emission_probs(requests[0])
    blocks = [E[:, :, i:i + STREAM_BLOCK] for i in range(0, L, STREAM_BLOCK)]

    def run(tag, body, want):
        streaming.streaming_init(init, A, blocks[0], PF)  # warm-up
        reset_phase10(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = body()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / len(blocks)
        launches = launches_of(*counters)
        expect(launches, **want)
        log(f"phase 10 streaming {tag}: {ms:.3f} ms/block ({len(blocks)} blocks of {STREAM_BLOCK}), "
            f"launches {launches}")
        return out, ms

    def filt():
        st = streaming.streaming_init(init, A, blocks[0], PF)
        for blk in blocks[1:]:
            st = streaming.streaming_update(st, A, blk, PF)
        return st

    st, filter_ms = run("filter", filt, {"sum_chunk_summaries": len(blocks)})
    profile_request(f"phase 10 streaming filter ({len(blocks)} blocks)", filt, "K1",
                    ("chunk_summaries_rows_kernel",))
    with torch.inference_mode():
        ll_ref = recursion.log_likelihood(init, A, E, PF)
    err, ok = within(st.log_lik, ll_ref, 1e-4, 0.0)
    log(f"phase 10 streaming filter loglik vs the whole sequence: max abs {err:.3e} (rtol 1e-4)")
    if not ok:
        raise AssertionError("streaming filter loglik disagrees with the whole sequence")

    def smooth():
        st, c0 = streaming.streaming_smoother_init(init, A, blocks[0], SMOOTHER_LAG, PF)
        out = [c0]
        for blk in blocks[1:]:
            st, c = streaming.streaming_smoother_update(st, A, blk, PF)
            out.append(c)
        return out + [streaming.streaming_smoother_finalize(st, A, PF)]

    commits, smoother_ms = run(f"smoother (lag {SMOOTHER_LAG})", smooth,
                               {"sum_chunk_summaries": 8, "sum_fwd_outputs": 4, "beta_bwd_outputs": 4})
    lo = 0
    for k, got in enumerate(commits):
        end = min(L, (k + 1) * STREAM_BLOCK)
        with torch.inference_mode():
            ref, ll = recursion.posterior(init, A, E[:, :, :end], PF)
        ref = ref[:, :, lo:lo + got.shape[2]]
        ref = ref - torch.logsumexp(ref, -1, keepdim=True)
        bound = 2 * f32_log_bound(ll, end // PF)
        err, ok = within(got, ref, 0.0, bound, mask=ref.exp() >= 1e-3)
        p_err = float((got.exp() - ref.exp()).abs().max())
        log(f"phase 10 smoother commit {k} (positions {lo}-{lo + got.shape[2] - 1}) vs the posterior of "
            f"positions 0-{end - 1}: log marginal where >= 1e-3 max abs {err:.3e} (bound {bound:.3f}), "
            f"marginal max abs {p_err:.3e}")
        if not ok:
            raise AssertionError(f"smoother commit {k} disagrees with the truncated posterior")
        lo += got.shape[2]
    if lo != L:
        raise AssertionError(f"the smoother committed {lo} positions, not {L}")

    def decode():
        st, c0 = streaming.streaming_viterbi_init(init, A, blocks[0], VITERBI_LAG)
        out = [c0]
        for blk in blocks[1:]:
            st, c = streaming.streaming_viterbi_update(st, init, A, blk)
            out.append(c)
        return torch.cat(out + [streaming.streaming_viterbi_finalize(st, init, A)], dim=-1)

    profile_request(f"phase 10 streaming smoother (lag {SMOOTHER_LAG}, {len(blocks)} blocks)", smooth,
                    "K1-K3", K1_K3_KEYS)

    path, viterbi_ms = run(f"Viterbi (lag {VITERBI_LAG})", decode, {})
    if tuple(path.shape) != (1, B, L):
        raise AssertionError(f"streaming Viterbi shape {tuple(path.shape)}")
    check_paths("streaming Viterbi", path[:, :, None], init, A)
    with torch.inference_mode():
        agree = float((path == layer.viterbi(requests[0])).float().mean())
    log(f"phase 10 streaming Viterbi: every transition valid; agrees with the offline decode at "
        f"{100 * agree:.3f}% of positions")
    st_v, _ = streaming.streaming_viterbi_init(init, A, blocks[0], VITERBI_LAG)
    profile_request("phase 10 streaming Viterbi (one update block)",
                    lambda: streaming.streaming_viterbi_update(st_v, init, A, blocks[1]),
                    "kernels of the port (none)", ())
    return {"filter_ms": filter_ms, "smoother_ms": smoother_ms, "stream_viterbi_ms": viterbi_ms}


def options_phase(HMMLayer, models, make, recursion, counters, smi):
    """Phase 10 at the flagship width on the phase-4 inputs."""
    t0 = time.perf_counter()
    requests = [make(SEED + 1 + i, B, L) for i in range(N_REQUESTS)]
    cuda_mxu = counters[2]
    times = {}
    times.update(embedding_phase(HMMLayer, models, requests, recursion, counters, smi))
    times.update(lookup_phase(HMMLayer, models, requests, recursion, counters))
    times.update(option_map_phase(HMMLayer, models, requests, counters))
    times.update(sampling_phase(HMMLayer, models, requests, counters, cuda_mxu))
    times.update(em_phase(HMMLayer, models, requests, recursion, counters))
    times.update(streaming_phase(HMMLayer, models, requests, recursion, counters))
    log(f"phase 10 summary on {smi}: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    log(f"phase 10 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 11: the sparse edge-list engine
# ---------------------------------------------------------------------------

SPARSE_K, SPARSE_B, SPARSE_L = 36, 8, 10_000  # config 5: q = 505, 793 edges
SPARSE_BLOCK = 1000  # the fused CE's backward block
SPARSE_SAMPLES, SPARSE_STREAM_BLOCK = 4, 2500
WALL_K, WALL_B, WALL_L = 1000, 2, 2000  # q = 14,001, 22,001 edges


def kernel_counts(counters):
    """Launches of every kernel K1–K9 since the last reset."""
    out = {}
    for module in counters:
        out.update(module.LAUNCHES)
    return out


def reset_kernels(counters):
    for module in counters:
        module.reset_launches()


def no_kernels(tag, counters):
    """Fail if any of K1–K9 launched since the last reset."""
    launched = {k: v for k, v in kernel_counts(counters).items() if v}
    if launched:
        raise AssertionError(f"{tag}: launched {launched}; it must launch none of K1-K9")


def synced_ms(fn):
    """(result, ms) of ``fn()`` on the host clock, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def build_config5(HMMLayer, models, sparse_forward):
    """Config 5: ``GenePredMultiTransitions(k=36)`` + ``GenePredEmissions(
    num_copies=36)`` from the 15-class kernel, seeded random weights around
    that init as in phase 9."""
    gen = torch.Generator().manual_seed(SEED + SPARSE_K)
    layer = HMMLayer(
        models.GenePredMultiTransitions(k=SPARSE_K, generator=gen, sparse_forward=sparse_forward),
        models.GenePredEmissions(num_copies=SPARSE_K,
                                 init=models.make_15_class_emission_kernel(num_copies=SPARSE_K), **CODONS),
        use_prior=False,
        parallel_factor="auto",
    )
    with torch.no_grad():
        for p in layer.parameters():
            p.add_((0.5 * torch.randn(p.shape, generator=gen)).to(p.device))
    return layer


def edge_support(layer):
    """(init, dense A) of a sparse layer, for the path checks."""
    with torch.no_grad():
        idx, probs = layer.transitions.make_A_sparse()
        from hmm_layer_torch.models.transition_utils import dense_from_edge_probs

        A = dense_from_edge_probs(idx, probs, layer.transitions.num_states)
        return layer.transitions.make_initial_distribution(), A


def config5_posterior(layer, twin, requests, counters):
    """3 posterior + loglik requests on the sparse route, each held against
    the dense twin; no kernel may launch."""
    out = {}
    with torch.inference_mode():
        sparse_ms, dense_ms, lls, d_gamma = [], [], [], []
        for i, X in enumerate(requests):
            reset_kernels(counters)
            (lg, ll), ms = synced_ms(lambda: (layer.state_posterior_log_probs(X), layer.log_likelihood(X)))
            no_kernels(f"config 5 posterior request {i}", counters)
            sparse_ms.append(ms)
            lls.append(ll)
            init, A = twin.transitions.matrices()
            E = twin.emission_probs(X)
            (lg_d, ll_d), ms_d = synced_ms(lambda: recursion_posterior(twin, init, A, E))
            dense_ms.append(ms_d)
            bound = f32_log_bound(ll_d, SPARSE_L)
            norm = float(torch.logsumexp(lg, -1).abs().max())
            norm_d = float(torch.logsumexp(lg_d, -1).abs().max())
            lg_err, lg_ok = within(lg, lg_d, 0.0, 2 * bound, mask=lg_d.exp() >= 1e-3)
            ll_err, ll_ok = within(ll, ll_d, 1e-4, 0.0)
            d_gamma.append(float((lg.exp() - lg_d.exp()).abs().max()))
            log(f"phase 11 config 5 request {i}: loglik {float(ll.mean()):.2f} mean, vs the dense twin max abs "
                f"{ll_err:.3e} (rtol 1e-4); |logsumexp(log gamma)| max {norm:.3e} (dense twin {norm_d:.3e}, "
                f"bound {bound:.3f} + the twin's); log gamma vs dense where gamma >= 1e-3 max abs {lg_err:.3e} "
                f"(bound {2 * bound:.3f}); launches none; {ms:.3f} ms sparse, {ms_d:.3f} ms dense")
            if norm > bound + norm_d or not lg_ok or not ll_ok:
                raise AssertionError(f"config 5 request {i}: the sparse route disagrees with the dense twin")
    log(f"phase 11 config 5 posterior + loglik (q={lg.shape[-1]}, b={SPARSE_B}, L={SPARSE_L}): sparse "
        f"{statistics.median(sparse_ms):.3f} ms/batch median {[round(t, 3) for t in sparse_ms]}; dense "
        f"sequential twin (posterior, loglik from one forward) {statistics.median(dense_ms):.3f} ms/batch "
        f"{[round(t, 3) for t in dense_ms]}")
    profile_request("phase 11 config 5 sparse posterior", lambda: layer.state_posterior_log_probs(requests[0]),
                    "kernels of the port (none)", ())
    out["c5_posterior_ms"] = statistics.median(sparse_ms)
    out["c5_dense_posterior_ms"] = statistics.median(dense_ms)
    return out, lls, d_gamma


def recursion_posterior(twin, init, A, E):
    from hmm_layer_torch.ops import recursion

    return recursion.posterior(init, A, E, twin._pf(E))


def check_support(tag, paths, init, A):
    """Every first state has init > 0 and every transition is an edge with
    A > 0; paths (m, b, [S,] L)."""
    p = paths[0].long()
    if not (bool((init[0][p[..., 0]] > 0).all()) and bool((A[0][p[..., :-1], p[..., 1:]] > 0).all())):
        raise AssertionError(f"{tag}: a path leaves the edge support or starts where init = 0")


def config5_viterbi(layer, twin, X, counters):
    with torch.inference_mode():
        reset_kernels(counters)
        path, ms = synced_ms(lambda: layer.viterbi(X))
        no_kernels("config 5 viterbi", counters)
        path_d, ms_d = synced_ms(lambda: twin.viterbi(X))
        init, A = twin.transitions.matrices()
        E = twin.emission_probs(X)
        check_support("config 5 sparse decode", path, init, A)
        score, _ = path_score64(init, A, E, path)
        score_d, _ = path_score64(init, A, E, path_d)
        err, ok = within(score, score_d, 1e-5, 0.0)
        same = float((path == path_d).float().mean())
    log(f"phase 11 config 5 viterbi: every transition on an edge with A > 0; float64 path scores vs the dense "
        f"decode max abs {err:.3e} (rtol 1e-5; mean score {float(score.mean()):.2f}); paths equal at "
        f"{100 * same:.3f}% of positions; launches none; sparse {ms:.3f} ms/batch, dense sequential (K7c + K8c) "
        f"{ms_d:.3f}")
    if not ok:
        raise AssertionError("config 5 sparse decode scores below the dense decode")
    return {"c5_viterbi_ms": ms, "c5_dense_viterbi_ms": ms_d}, path


def masked_ce(lg, labels, mask):
    """The unfused CE: mask-weighted mean of -log gamma at the labels (b, L)."""
    ce = -torch.gather(lg, -1, labels.expand(lg.shape[:-1])[..., None])[..., 0]
    return (ce * mask).sum() / mask.sum().clamp_min(1.0)


def config5_training(layer, X, path, counters, sparse_ops, make):
    """One MAP step; the unfused CE's value, gradient and peak memory, then
    two Trainer CE steps (fused, blocked), the first of which gives the
    fused value and peak on the same parameters; the fused gradients
    against the unfused ones at b=2, L=2000."""
    import functools

    from hmm_layer_torch.training import Trainer

    pars = [p for p in layer.parameters() if p.requires_grad]
    names = [n for n, p in layer.named_parameters() if p.requires_grad]
    out = {}
    reset_kernels(counters)
    (loss, grads), ms = synced_ms(lambda: (lambda v: (v.detach(), torch.autograd.grad(v, pars)))(layer.loss(X)))
    no_kernels("config 5 MAP step", counters)
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    log(f"phase 11 config 5 MAP loss step: loss {float(loss):.3f}, gradients finite {finite}, {ms:.3f} ms "
        f"(forward + analytic backward); launches none")
    if not (finite and math.isfinite(float(loss))):
        raise AssertionError("config 5 MAP step: loss or gradients not finite")
    out["c5_map_ms"] = ms

    labels = path[0].long()
    mask = torch.ones(labels.shape, device=labels.device)
    mask[::4, -1000:] = 0.0

    def peak_of(fn):
        """(result, ms, peak device memory above what is allocated before)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        result, t = synced_ms(fn)
        return result, t, torch.cuda.max_memory_allocated() - base

    (ce_u, _), ms_u, peak_u = peak_of(lambda: (lambda v: (v.detach(), torch.autograd.grad(v, pars)))(
        masked_ce(layer.state_posterior_log_probs(X, training=True), labels, mask)))

    before = [p.detach().clone() for p in pars]
    batch = {"x": X, "labels": labels, "mask": mask}

    def ce_loss(batch, indices):
        return layer.posterior_cross_entropy(batch["x"], batch["labels"], label_mask=batch["mask"])

    trainer = Trainer(layer, optimizer=functools.partial(torch.optim.Adam, lr=1e-2), loss_fn=ce_loss)
    trainer.init_from_params()
    losses, step_ms = [], []
    prev = sparse_ops.set_sparse_posterior_block(SPARSE_BLOCK)
    try:
        for i in range(2):
            reset_kernels(counters)
            loss, ms, peak = peak_of(lambda: trainer.fit([batch]))
            no_kernels(f"config 5 Trainer CE step {i + 1}", counters)
            losses.append(float(loss))
            step_ms.append(ms)
            if i == 0:
                peak_f = peak
    finally:
        sparse_ops.set_sparse_posterior_block(prev)
    moved = [not torch.equal(p.detach(), p0) for p, p0 in zip(pars, before)]
    err, ok = within(torch.tensor(losses[0]), ce_u.cpu(), 1e-5, 0.0)
    log(f"phase 11 config 5 CE (b={SPARSE_B}, L={SPARSE_L}): fused (Trainer step 1) {losses[0]:.6f} vs unfused "
        f"{float(ce_u):.6f}, abs diff {err:.3e} (rtol 1e-5); peak device memory above what was allocated before: "
        f"fused + blocked Trainer step (block {SPARSE_BLOCK}) {peak_f / 2**20:.1f} MiB, unfused value + gradient "
        f"{peak_u / 2**20:.1f} MiB ({ms_u:.3f} ms)")
    log(f"phase 11 config 5 Trainer CE steps (fused, block {SPARSE_BLOCK}, Adam 1e-2): losses "
        f"{[round(v, 6) for v in losses]}, {[round(t, 3) for t in step_ms]} ms/step; every parameter moved: "
        f"{all(moved)}; launches none")
    if not ok or not peak_f < peak_u:
        raise AssertionError("fused CE: value differs from the unfused one, or its peak memory is not lower")
    if not (all(np.isfinite(losses)) and all(moved)):
        raise AssertionError("config 5 CE training: loss not finite or a parameter did not move")
    out.update(c5_ce_step_ms=step_ms[-1], c5_ce_unfused_ms=ms_u, c5_peak_fused_mib=peak_f / 2**20,
               c5_peak_unfused_mib=peak_u / 2**20)

    # Gradients of every parameter: fused (blocked) against unfused, b=2, L=2000.
    Xs = make(SEED + 131, 2, 2000)
    with torch.no_grad():
        lab_s = layer.viterbi(Xs)[0].long()
    mask_s = torch.ones(lab_s.shape, device=lab_s.device)
    mask_s[0, -500:] = 0.0
    g_fused = torch.autograd.grad(sparse_ops_ce(layer, sparse_ops, Xs, lab_s, mask_s, 500), pars)
    g_unfused = torch.autograd.grad(
        masked_ce(layer.state_posterior_log_probs(Xs, training=True), lab_s, mask_s), pars)
    rel = [float((a - r).abs().max() / r.abs().max().clamp_min(1e-30)) for a, r in zip(g_fused, g_unfused)]
    log(f"phase 11 config 5 CE gradients (b=2, L=2000, block 500) fused vs unfused, max |diff| / max "
        f"|unfused| per parameter {dict(zip(names, [f'{x:.3e}' for x in rel]))} (limit 1e-4)")
    if max(rel) > 1e-4:
        raise AssertionError("fused CE gradients differ from the unfused ones")
    return out


def sparse_ops_ce(layer, sparse_ops, X, labels, mask, block):
    init, (indices, probs), E, _, _ = layer._inputs(X, training=True)
    return sparse_ops.sparse_posterior_cross_entropy(init, indices, probs, E, labels, label_mask=mask,
                                                     backward_block=block)


def config5_sampling(layer, X, counters):
    init, A = edge_support(layer)
    gen = torch.Generator(device=X.device).manual_seed(SEED)
    reset_kernels(counters)
    paths, ms = synced_ms(lambda: layer.sample_paths(X, num_samples=SPARSE_SAMPLES, generator=gen))
    no_kernels("config 5 sample_paths", counters)
    if tuple(paths.shape) != (1, SPARSE_B, SPARSE_SAMPLES, SPARSE_L):
        raise AssertionError(f"config 5 sample_paths shape {tuple(paths.shape)}")
    check_support("config 5 sample_paths", paths, init, A)
    X1 = X[:, :1]
    with torch.inference_mode():
        many, ms1 = synced_ms(lambda: layer.sample_paths(X1, num_samples=FREQ_SAMPLES, generator=gen))
        check_support("config 5 sample_paths S=1000", many, init, A)
        p = many[0, 0].long()
        q = A.shape[-1]
        counts = torch.zeros((SPARSE_L, q), device=p.device).scatter_add_(
            1, p.T.contiguous(), torch.ones(p.T.shape, device=p.device))
        lg = layer.state_posterior_log_probs(X1)[0, 0]
    # log gamma is off its normalisation by up to the float32 bound at this
    # length (both engines; the request checks above), and the sampler draws
    # from the normalised posterior: compare with gamma normalised per position.
    norm = torch.logsumexp(lg, -1, keepdim=True)
    err = float((counts / FREQ_SAMPLES - (lg - norm).exp()).abs().max())
    tol = 4.5 / math.sqrt(FREQ_SAMPLES)
    log(f"phase 11 config 5 sample_paths: S={SPARSE_SAMPLES} over b={SPARSE_B} {ms:.3f} ms/batch, every start and "
        f"transition on the edge support; S={FREQ_SAMPLES} on one sequence {ms1:.3f} ms, state frequencies vs "
        f"exp(log gamma) normalised per position (|logsumexp(log gamma)| max {float(norm.abs().max()):.3e}) max "
        f"abs {err:.3e} (tolerance 4.5/sqrt(S) = {tol:.3f}); launches none")
    if err > tol:
        raise AssertionError("config 5 sampled state frequencies disagree with the posterior")
    return {"c5_sample_ms": ms, "c5_sample_1000_ms": ms1}


def config5_em(layer, twin, X, d_gamma, counters, sparse_ops):
    """3 ``sparse_em_step`` calls; step 1 against the dense ``em_step``
    (P = 1): within rtol 1e-4 / atol 1e-6 on the first 18 positions of 3
    sequences (the shape of the JAX package's test), and on the whole input
    within ``d_gamma``, the two engines' largest gamma difference on it
    (phase 11's request 0): at |loglik| ~ 1e5 both carry float32 log-scales
    rounded at 2^-7, and an EM update is a ratio of sums of gamma."""
    from hmm_layer_torch.ops import em

    with torch.inference_mode():
        init, (indices, probs), E, _, _ = layer._inputs(X)
        A = twin.transitions.make_A()
        src = torch.as_tensor(indices[:, 0], device=E.device)
        dst = torch.as_tensor(indices[:, 1], device=E.device)
        Es = E[:, :3, :18]
        got = sparse_ops.sparse_em_step(init, indices, probs, Es)
        ref = em.em_step(init, A, Es, 1)
        errs = [within(got[0], ref[0], 1e-4, 1e-6), within(got[1], ref[1][:, src, dst], 1e-4, 1e-6),
                within(got[2], ref[2], 1e-5, 0.0)]
        log(f"phase 11 config 5 sparse_em_step vs the dense em_step (P=1) on b=3, L=18: init, edge probs max abs "
            f"{errs[0][0]:.3e}, {errs[1][0]:.3e} (rtol 1e-4, atol 1e-6), loglik {errs[2][0]:.3e} (rtol 1e-5)")
        if not all(ok for _, ok in errs):
            raise AssertionError("sparse_em_step disagrees with the dense em_step on a short input")
        ref_init, ref_A, ref_ll = em.em_step(init, A, E, 1)
        lls, ms = [], []
        for i in range(EM_STEPS):
            reset_kernels(counters)
            (new_init, new_w, ll), t = synced_ms(lambda: sparse_ops.sparse_em_step(init, indices, probs, E))
            no_kernels(f"config 5 sparse_em_step {i + 1}", counters)
            ms.append(t)
            if i == 0:
                e_init, ok_init = within(new_init, ref_init, 1e-4, 1e-6)
                e_w, ok_w = within(new_w, ref_A[:, src, dst], 1e-4, 1e-6)
                e_ll, ok_ll = within(ll, ref_ll, 1e-5, 0.0)
                log(f"phase 11 config 5 sparse_em_step 1 vs the dense em_step (P=1), b={SPARSE_B}, L={SPARSE_L}: "
                    f"init max abs {e_init:.3e}, edge probs {e_w:.3e} (rtol 1e-4 / atol 1e-6: {ok_init and ok_w}; "
                    f"else within {d_gamma:.3e}, the engines' gamma difference), loglik {e_ll:.3e} (rtol 1e-5)")
                ok_init = ok_init or e_init <= d_gamma
                ok_w = ok_w or e_w <= d_gamma
                if not (ok_init and ok_w and ok_ll):
                    raise AssertionError("config 5 sparse_em_step disagrees with the dense em_step")
            lls.append(float(ll.double().sum()))
            rows = torch.zeros(A.shape[-1], dtype=torch.float64, device=E.device).index_add_(
                0, src, new_w[0].double())
            has_out = torch.zeros(A.shape[-1], dtype=torch.bool, device=E.device)
            has_out[src] = True
            stochastic = (bool(((rows[has_out] - 1).abs() <= 1e-5).all())
                          and abs(float(new_init.sum()) - 1) <= 1e-5)
            tol = SPARSE_B * f32_log_bound(ll, SPARSE_L)
            log(f"phase 11 config 5 sparse_em_step {i + 1}: summed loglik {lls[-1]:.3f}, {t:.3f} ms; rows "
                f"stochastic over the edge support {stochastic}; launches none")
            if not stochastic or (i and lls[-1] < lls[-2] - tol):
                raise AssertionError(f"config 5 sparse_em_step {i + 1}: loglik fell (tolerance {tol:.3f}) "
                                     "or rows broke")
            init, probs = new_init, new_w
    log(f"phase 11 config 5 sparse_em_step: {statistics.median(ms):.3f} ms/step median {[round(t, 3) for t in ms]}")
    return {"c5_em_ms": statistics.median(ms)}


def config5_streaming(layer, X, ll_whole, counters):
    from hmm_layer_torch import streaming

    with torch.inference_mode():
        init, (indices, probs), E, _, _ = layer._inputs(X)
        blocks = [E[:, :, s:s + SPARSE_STREAM_BLOCK] for s in range(0, SPARSE_L, SPARSE_STREAM_BLOCK)]
        reset_kernels(counters)

        def run():
            st = streaming.sparse_streaming_init(init, indices, probs, blocks[0])
            for blk in blocks[1:]:
                st = streaming.sparse_streaming_update(st, indices, probs, blk)
            return st

        st, ms = synced_ms(run)
        no_kernels("config 5 sparse streaming", counters)
    err, ok = within(st.log_lik, ll_whole, 1e-4, 0.0)
    log(f"phase 11 config 5 sparse streaming filter ({len(blocks)} blocks of {SPARSE_STREAM_BLOCK}): loglik vs "
        f"sparse_log_likelihood of the whole sequence max abs {err:.3e} (rtol 1e-4); "
        f"{ms / len(blocks):.3f} ms/block; launches none")
    if not ok:
        raise AssertionError("config 5 sparse streaming filter disagrees with the whole sequence")
    return {"c5_stream_ms_per_block": ms / len(blocks)}


def config5_determinism(layer, X, sparse_ops):
    with torch.inference_mode():
        init, (indices, probs), E, _, _ = layer._inputs(X)
        la, ll = sparse_ops.sparse_forward(init, indices, probs, E)
        la2, ll2 = sparse_ops.sparse_forward(init, indices, probs, E)
        equal = torch.equal(la, la2) and torch.equal(ll, ll2)
    log(f"phase 11 config 5 determinism: two identical sparse_forward calls bit-equal: {equal}")
    if not equal:
        raise AssertionError("sparse_forward is not deterministic on the card")


def flagship_sparse(HMMLayer, models, make, recursion, counters):
    """The flagship (q = 15, b = 32, L = 9999) through the sparse route,
    against the kernel route of the same weights."""
    out = {}
    dense = build_layer(HMMLayer, models)
    sp = seeded_layer(HMMLayer, models.GenePredTransitions(sparse_forward=True),
                      models.GenePredEmissions(**CODONS), SEED, use_prior=False)
    X = make(SEED + 1, B, L)
    with torch.inference_mode():
        dense.state_posterior_log_probs(X)  # warm-up, not counted
        reset_kernels(counters)
        (lg_k, ll_k), ms_k = synced_ms(lambda: (dense.state_posterior_log_probs(X), dense.log_likelihood(X)))
        launches = kernel_counts(counters)
        expect(launches, **PER_REQUEST)
        reset_kernels(counters)
        (lg, ll), ms = synced_ms(lambda: (sp.state_posterior_log_probs(X), sp.log_likelihood(X)))
        no_kernels("flagship sparse posterior", counters)
        bound = f32_log_bound(ll_k, L // PF) + f32_log_bound(ll_k, L)
        lg_err, lg_ok = within(lg, lg_k, 0.0, bound, mask=lg_k.exp() >= 1e-3)
        ll_err, ll_ok = within(ll, ll_k, 2e-4, 0.0)
        norm = float(torch.logsumexp(lg, -1).abs().max())
        log(f"phase 11 flagship through the sparse route (q=15, b={B}, L={L}): log gamma vs the kernel route "
            f"(K1-K3 once each: {launches}) where gamma >= 1e-3 max abs {lg_err:.3e} (bound {bound:.3f}: "
            f"sequential + chunked float32 bounds), loglik max abs {ll_err:.3e} (rtol 2e-4); |logsumexp(log "
            f"gamma)| max {norm:.3e}; posterior + loglik sparse {ms:.3f} ms/batch, kernel route {ms_k:.3f}")
        if not (lg_ok and ll_ok and norm <= bound):
            raise AssertionError("the flagship's sparse route disagrees with the kernel route")
        out.update(flagship_sparse_ms=ms, flagship_kernel_ms=ms_k)

        reset_kernels(counters)
        path_k, ms_vk = synced_ms(lambda: dense.viterbi(X))
        launches = kernel_counts(counters)
        expect(launches, **{k: 1 for k in DECODE_Q16})
        reset_kernels(counters)
        path, ms_v = synced_ms(lambda: sp.viterbi(X))
        no_kernels("flagship sparse decode", counters)
        init, A = dense.transitions.matrices()
        E = dense.emission_probs(X)
        check_support("flagship sparse decode", path, init, A)
        score, _ = path_score64(init, A, E, path)
        score_k, _ = path_score64(init, A, E, path_k)
        err, ok = within(score, score_k, 1e-5, 0.0)
        log(f"phase 11 flagship sparse decode: valid; float64 path scores vs the K6-K8 decode ({launches}) max "
            f"abs {err:.3e} (rtol 1e-5); sparse {ms_v:.3f} ms/batch, kernel route {ms_vk:.3f}")
        if not ok:
            raise AssertionError("the flagship's sparse decode scores differ from the K6-K8 decode")
        out.update(flagship_sparse_viterbi_ms=ms_v, flagship_kernel_viterbi_ms=ms_vk)

    # Gradients at b=2, L=1200: the sparse analytic posterior VJP against the
    # dense chunked analytic VJP (K4-K5 on the card), scale-normalised.
    Xs = make(SEED + 141, 2, 1200)
    with torch.no_grad():
        labels = dense.viterbi(Xs)[0].long()
    mask = torch.ones(labels.shape, device=labels.device)
    names = [n for n, p in dense.named_parameters() if p.requires_grad]
    grads = []
    for layer in (sp, dense):
        pars = [p for p in layer.parameters() if p.requires_grad]
        grads.append(torch.autograd.grad(masked_ce(layer.state_posterior_log_probs(Xs), labels, mask), pars))
    rel = [float((a - r).abs().max() / r.abs().max().clamp_min(1e-30)) for a, r in zip(*grads)]
    log(f"phase 11 flagship CE gradients (b=2, L=1200, dense P={recursion.recommended_parallel_factor(1200, 15, 1)}): sparse analytic vs dense "
        f"chunked analytic, max |diff| / max |dense| per parameter {dict(zip(names, [f'{x:.3e}' for x in rel]))} "
        f"(limit 2e-3)")
    if max(rel) > 2e-3:
        raise AssertionError("the flagship's sparse gradients differ from the dense chunked ones")
    return out


def wall_problem(models, device, length):
    """Phase 11's k = 1,000 problem (q = 14,001, 22,001 edges, b = 2) at
    ``length`` positions: (transitions, init, host indices, edge
    probabilities, E)."""
    t = models.GenePredMultiTransitions(k=WALL_K, generator=torch.Generator().manual_seed(SEED + WALL_K)).to(device)
    rng = np.random.default_rng(SEED + WALL_K)
    E = torch.from_numpy(rng.uniform(0.05, 1.0, (1, WALL_B, length, t.num_states)).astype(np.float32)).to(device)
    with torch.no_grad():
        indices, probs = t.make_A_sparse()
        return t, t.make_initial_distribution(), indices, probs, E


def dense_wall(models, recursion, sparse_ops, counters, device):
    """k = 1000 (q = 14,001, 22,001 edges), b = 2, L = 2000: the sparse
    log-likelihood against the dense sequential engine (A: 784 MB)."""
    t, init, indices, probs, E = wall_problem(models, device, WALL_L)
    q = t.num_states
    with torch.inference_mode():
        sparse_ops.sparse_log_likelihood(init, indices, probs, E[:, :, :8])  # plan on the card
        reset_kernels(counters)
        ll, ms = synced_ms(lambda: sparse_ops.sparse_log_likelihood(init, indices, probs, E))
        no_kernels("q=14001 sparse loglik", counters)
        A, ms_a = synced_ms(t.make_A)
        ll_d, ms_d = synced_ms(lambda: recursion.log_likelihood(init, A, E, 1))
    err, ok = within(ll, ll_d, 1e-4, 0.0)
    log(f"phase 11 past the dense wall (k={WALL_K}: q={q}, {len(indices)} edges, b={WALL_B}, L={WALL_L}): "
        f"sparse_log_likelihood vs the dense sequential engine max abs {err:.3e} (rtol 1e-4; loglik "
        f"{float(ll.mean()):.2f} mean); sparse {ms:.3f} ms, dense {ms_d:.3f} ms (+ {ms_a:.3f} ms to build the "
        f"{A.numel() * 4 / 2**20:.0f} MiB A)")
    if not ok:
        raise AssertionError("q=14001 sparse loglik disagrees with the dense engine")
    return {"wall_sparse_ms": ms, "wall_dense_ms": ms_d, "wall_build_A_ms": ms_a}


def sparse_phase(HMMLayer, models, make, recursion, counters, smi):
    """Phase 11: the sparse edge-list engine at config 5, the flagship
    through the sparse route, and q = 14,001."""
    from hmm_layer_torch.ops import sparse as sparse_ops

    t0 = time.perf_counter()
    layer = build_config5(HMMLayer, models, sparse_forward=True)
    twin = build_config5(HMMLayer, models, sparse_forward=False)
    twin.load_state_dict(layer.state_dict())
    q = layer.transitions.num_states
    log(f"phase 11 config 5: q={q}, {layer.transitions.num_transitions} edges, b={SPARSE_B}, L={SPARSE_L}; "
        f"dense twin parallel factor {recursion.recommended_parallel_factor(SPARSE_L, q, 1)} (sequential engine)")
    requests = [make(SEED + 111 + i, SPARSE_B, SPARSE_L) for i in range(N_REQUESTS)]
    times, lls, d_gamma = config5_posterior(layer, twin, requests, counters)
    more, path = config5_viterbi(layer, twin, requests[0], counters)
    times.update(more)
    times.update(config5_sampling(layer, requests[0], counters))
    times.update(config5_em(layer, twin, requests[0], d_gamma[0], counters, sparse_ops))
    times.update(config5_streaming(layer, requests[0], lls[0], counters))
    config5_determinism(layer, requests[0], sparse_ops)
    times.update(config5_training(layer, requests[0], path, counters, sparse_ops, make))
    del layer, twin, requests, lls, path
    times.update(flagship_sparse(HMMLayer, models, make, recursion, counters))
    times.update(dense_wall(models, recursion, sparse_ops, counters, make(SEED, 1, 1).device))
    log(f"phase 11 summary on {smi}: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    log(f"phase 11 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 12: the profile-HMM family and the align command
# ---------------------------------------------------------------------------

# Config 4 (benchmarks/profile_train_bench.py): 5 models, q up to 155.
PROFILE_LENGTHS = [60, 64, 68, 72, 76]
# learnMSA's own model lengths at ~400 residues (q = 639-647, padded to
# 647): the register cut of K2c/K3c, at config 4's batch and length.
N320_LENGTHS = [318, 319, 320, 321, 322]
PROFILE_B, PROFILE_L, PROFILE_S = 64, 400, 26
PROFILE_STEPS, PROFILE_LR = 5, 0.05  # align's default learning rate
# The planted family of benchmarks/msa_quality_bench.py.
PLANTED_LM, PLANTED_S, PLANTED_SEQS, ALIGN_STEPS = 24, 25, 64, 300
# Profiler names of the port's kernels K1-K9 (none should run in phase 12).
OUR_KERNEL_KEYS = ("chunk_summaries", "outputs_kernel", "affine_", "deltas", "backtrace", "mxu_summary",
                   "sum_wide_kernel")


def build_config4(HMMLayer, models, structured_forward=False, lengths=PROFILE_LENGTHS):
    """Config 4 (or its family at other model lengths) with the port's
    default initializers drawn from a seeded generator."""
    gen = torch.Generator().manual_seed(SEED + 4)
    return HMMLayer(
        models.ProfileTransitions(lengths, generator=gen, structured_forward=structured_forward),
        models.ProfileEmissions(lengths, input_dim=PROFILE_S),
        use_prior=True,
        num_seqs=1000,
        parallel_factor="auto",
    )


def profile_inputs(seed, b, length, m, device):
    """One-hot residues 0..24 over 26 channels, broadcast over the models."""
    rng = np.random.default_rng(seed)
    x = np.eye(PROFILE_S, dtype=np.float32)[rng.integers(0, 25, size=(b, length))]
    return torch.from_numpy(x).to(device)[None].expand(m, b, length, PROFILE_S)


def wide_sum_kernel_phase(HMMLayer, models, make, cuda_forward, peak_bytes, peak_flops):
    """K2c and K3c against their plain versions at the profile-m5-train
    cell's shape (config 4: m=5, q=155 padded, b=64, L=400; the records),
    at the profile-m5-n320-train cell's (n320: lengths 318-322, q=647
    padded, the register cut) and at config 5's (q=505, b=32, L=9999),
    warm and cold, beside their bounds; K2c with log alpha (the VJP's
    rerun) and without (the loss). Then one MAP loss and backward of
    config 4 and of n320: K2c twice, K3c once each. Returns (records,
    launches of config 4's step)."""
    records = {}
    c4 = build_config4(HMMLayer, models)
    n320 = build_config4(HMMLayer, models, lengths=N320_LENGTHS)
    profile_x = profile_inputs(SEED + 140, PROFILE_B, PROFILE_L, len(PROFILE_LENGTHS), c4.device)
    shapes = (
        ("config 4", c4, profile_x),
        ("n320", n320, profile_x),
        ("config 5", build_multicopy_layer(HMMLayer, models, WIDE_K), make(SEED + 141, B, L)),
    )
    for tag, layer, X in shapes:
        with torch.inference_mode():
            init, A = (x.contiguous() for x in layer.transitions.matrices())
            E = layer.emission_probs(X).contiguous()
            m, b, c, q = E.shape
            la, ll = cuda_forward.sum_forward_wide(init, A, E, True)
            ll_only = cuda_forward.sum_forward_wide(init, A, E, False)[1]
            lb = cuda_forward.sum_backward_wide(A, E)
            la_p, ll_p = cuda_forward.sum_forward_wide_plain(init, A, E, True)
            lb_p = cuda_forward.sum_backward_wide_plain(A, E)
            torch.cuda.synchronize()
            # ll: the log-scale's float32 rounding; log alpha and log beta
            # add their normalised carry's (1e-4 in its log).
            bound = f32_log_bound(ll_p, c)
            ll_err, ll_ok = within(ll, ll_p, 0.0, bound)
            la_err, la_ok = within(la, la_p, 0.0, bound + 1e-4)
            lb_err, lb_ok = within(lb, lb_p, 0.0, bound + 1e-4)
            ok = ll_ok and la_ok and lb_ok and torch.equal(ll, ll_only)
            log(f"phase 12 K2c/K3c {tag} (m={m}, q={q}, b={b}, L={c}) vs the plain versions: ll max abs {ll_err:.3e}, "
                f"log alpha {la_err:.3e}, log beta {lb_err:.3e} (bound {bound:.3e} + 1e-4 for the logs); K2c's ll "
                f"without log alpha bit-equal: {torch.equal(ll, ll_only)}")
            if not ok:
                raise AssertionError(f"K2c/K3c at {tag} disagree with their plain versions")
            del la, lb, la_p, lb_p
            # A pass: 2 q^2 operations a step and sequence (the padded q);
            # A and E in, log alpha or log beta out.
            nops = m * b * (c - 1) * 2 * q * q
            io = 4 * m * q * q + 4 * m * b * c * q
            reps = 10 if c < 1000 else 1
            cases = {
                "sum_forward_wide": (lambda: cuda_forward.sum_forward_wide(init, A, E, True),
                                     lambda: cuda_forward.sum_forward_wide_plain(init, A, E, True),
                                     ll_err, io + 4 * m * q + 4 * m * b * c * q + 4 * m * b),
                "sum_backward_wide": (lambda: cuda_forward.sum_backward_wide(A, E),
                                      lambda: cuda_forward.sum_backward_wide_plain(A, E),
                                      lb_err, io + 4 * m * b * c * q),
            }
            for name, (kern, plain, err, nbytes) in cases.items():
                rec = measure(name, kern, plain, err, nbytes, nops, peak_bytes, peak_flops, reps=reps,
                              plain_samples=1)
                log(f"phase 12 {name} {tag} (m={m}, q={q}, b={b}, L={c}): {timing_text(rec, nbytes, nops)}"
                    f"{cold_text(name, kern, rec)}")
                if tag == "config 4":
                    records[name] = rec
            ll_ms = median_ms(lambda: cuda_forward.sum_forward_wide(init, A, E, False), samples=20, reps=reps)
            log(f"phase 12 sum_forward_wide {tag} without log alpha (the loss's pass): {ll_ms:.4f} ms")
        del E
    for tag, layer in (("n320", n320), ("config 4", c4)):
        pars = [p for p in layer.parameters() if p.requires_grad]
        cuda_forward.reset_launches()
        grads = torch.autograd.grad(layer.loss(profile_x), pars)
        torch.cuda.synchronize()
        launches = dict(cuda_forward.LAUNCHES)
        log(f"phase 12 {tag} MAP loss and backward: launches {launches}")
        expect(launches, sum_forward_wide=2, sum_backward_wide=1)
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError(f"{tag} MAP step through K2c/K3c: gradients not finite")
    return records, launches


def config4_serving(layer, plan7, counters, make_x):
    """3 requests of log_likelihood and state_posterior_log_probs."""
    q = layer.transitions.num_states
    requests = [make_x(SEED + 120 + i) for i in range(N_REQUESTS)]
    with torch.inference_mode():
        layer.log_likelihood(requests[0])  # warm-up
        reset_kernels(counters)
        t_ll, t_post = [], []
        for i, X in enumerate(requests):
            ll, ms = synced_ms(lambda: layer.log_likelihood(X))
            t_ll.append(ms)
            lg, ms = synced_ms(lambda: layer.state_posterior_log_probs(X))
            t_post.append(ms)
            ll_s = plan7.structured_log_likelihood(layer.transitions, layer.emission_probs(X))
            err, ok = within(ll, ll_s, 1e-5, 1e-4)
            norm = max(float(torch.logsumexp(lg[k, ..., :qk], -1).abs().max()) for k, qk in enumerate(q))
            bound = f32_log_bound(ll, PROFILE_L)
            log(f"phase 12 config 4 request {i}: loglik {float(ll.mean()):.2f} mean, vs "
                f"structured_log_likelihood max abs {err:.3e} (rtol 1e-5, atol 1e-4); log gamma "
                f"normalisation over each model's real states max |logsumexp| {norm:.3e} (float32 bound "
                f"{bound:.3e})")
            if not ok or norm > bound or not bool(torch.isfinite(ll).all()):
                raise AssertionError(f"config 4 request {i}: loglik or posterior wrong")
        launches = kernel_counts(counters)
    log(f"phase 12 config 4 launches over {N_REQUESTS} loglik + posterior requests: {launches}")
    expect(launches, sum_forward_wide=N_REQUESTS)
    profile_request("phase 12 config 4 posterior", lambda: layer.state_posterior_log_probs(requests[0]),
                    "K1-K9", OUR_KERNEL_KEYS)
    return {"config4_loglik_ms": statistics.median(t_ll), "config4_posterior_ms": statistics.median(t_post)}


def config4_training(layer, counters, X):
    """5 MAP steps of a Trainer with Adam(0.05)."""
    import functools

    from hmm_layer_torch import Trainer

    before = {n: p.detach().clone() for n, p in layer.named_parameters()}
    trainer = Trainer(layer, optimizer=functools.partial(torch.optim.Adam, lr=PROFILE_LR))
    trainer.init_from_params()
    losses, step_ms = [], []
    for i in range(PROFILE_STEPS):
        reset_kernels(counters)
        loss, ms = synced_ms(lambda: trainer.fit([X]))
        losses.append(float(loss))
        step_ms.append(ms)
        log(f"phase 12 config 4 MAP step {i + 1}: loss {losses[-1]:.4f}, {ms:.3f} ms, launches "
            f"{kernel_counts(counters)}")
        expect(kernel_counts(counters), sum_forward_wide=2, sum_backward_wide=1)
    moved = {n: not torch.equal(p.detach(), before[n]) for n, p in layer.named_parameters()}
    wrong = [n for n, p in layer.named_parameters() if moved[n] != p.requires_grad]
    frozen = sorted({n.rsplit(".", 1)[0] for n, p in layer.named_parameters() if not p.requires_grad})
    med = statistics.median(step_ms[1:])
    log(f"phase 12 config 4 MAP training: {med:.3f} ms/step median of steps 2-{PROFILE_STEPS} "
        f"{[round(t, 3) for t in step_ms]}, {PROFILE_B / (med / 1e3):.1f} seqs/s; loss "
        f"{[round(v, 4) for v in losses]}; {sum(moved.values())} of {len(moved)} parameters moved, "
        f"the frozen ({frozen}) did not: {not wrong}")
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0] or wrong:
        raise AssertionError(f"config 4 training: losses {losses}, wrong movement {wrong}")
    opt = trainer.optimizer

    def step():
        opt.zero_grad()
        layer.loss(X).backward()
        opt.step()

    profile_request("phase 12 config 4 MAP step", step, "K2c-K3c", OUR_KERNEL_KEYS, inference=False)
    return {"config4_map_step_ms": med}


def config4_structured(HMMLayer, models, layer, X):
    """The structured route against the dense route on the same (initial)
    params. Run before training: the route's rank-one match-skip factors
    exp(MD - csDD) and exp(csDD + DM) leave the float32 range at Lm = 76
    once training sharpens the delete chain (the JAX package's factors
    overflow the same way)."""
    structured = build_config4(HMMLayer, models, structured_forward=True)
    structured.load_state_dict(layer.state_dict())
    out, vals, grads = {}, [], []
    for tag, lay in (("structured", structured), ("dense", layer)):
        pars = [p for p in lay.parameters() if p.requires_grad]

        def loss_and_grads():
            loss = lay.loss(X)
            return loss, torch.autograd.grad(loss, pars)

        loss_and_grads()  # warm-up
        (v, g), ms = synced_ms(loss_and_grads)
        vals.append(v.item())
        grads.append(g)
        out[f"config4_{tag}_step_ms"] = ms
    rel_v = abs(vals[0] - vals[1]) / abs(vals[1])
    worst = max(float(((a - b).abs() - (1e-5 + 2e-3 * b.abs())).max()) for a, b in zip(*grads))
    log(f"phase 12 config 4 structured route: loss {vals[0]:.6f} vs dense {vals[1]:.6f} (rel {rel_v:.3e}, "
        f"limit 1e-5); gradients within rtol 2e-3, atol 1e-5: {worst <= 0} (worst excess {worst:.3e}); "
        f"loss + gradient {out['config4_structured_step_ms']:.3f} ms structured, "
        f"{out['config4_dense_step_ms']:.3f} ms dense")
    if rel_v > 1e-5 or worst > 0:
        raise AssertionError("config 4: the structured route disagrees with the dense route")
    return out


def config4_float64(HMMLayer, layer, recursion, make_x):
    """Gradients of the log-likelihood (the analytic sequential VJP)
    against float64 autograd through the sequential engine, cut to m = 2,
    b = 4, L = 100; scale-normalised limit 5e-4."""
    from hmm_layer_torch.training import select_models

    small = HMMLayer(select_models(layer.transitions, [0, 1]), [select_models(layer.emissions[0], [0, 1])],
                     use_prior=False, parallel_factor="auto")
    X = make_x(SEED + 130)[:2, :4, :100]
    names = [n for n, p in small.named_parameters() if p.requires_grad]
    pars = [p for p in small.parameters() if p.requires_grad]
    g32 = torch.autograd.grad(-small.log_likelihood(X).mean(), pars)
    init, A = small.transitions.matrices()
    E = small.emission_probs(X)
    ll64 = recursion.log_likelihood(init.double(), A.double(), E.double(), 1, analytic_vjp=False)
    g64 = torch.autograd.grad(-ll64.mean(), pars)
    rel = [float((a - r).abs().max() / r.abs().max().clamp_min(1e-30)) for a, r in zip(g32, g64)]
    log(f"phase 12 config 4 gradients (m=2, b=4, L=100) vs float64 sequential autograd: max |diff| / "
        f"max |f64| over {len(names)} parameters {max(rel):.3e} (worst {names[rel.index(max(rel))]}; "
        f"limit 5e-4)")
    if max(rel) > 5e-4:
        raise AssertionError("config 4 gradients are off the float64 oracle")


def config4_precision(layer, recursion, X):
    with torch.inference_mode():
        ref = layer.log_likelihood(X)
        prev = recursion.set_dp_precision("high")
        try:
            high = layer.log_likelihood(X)
        finally:
            recursion.set_dp_precision(prev)
    same = torch.equal(ref, high)
    log(f"phase 12 set_dp_precision('high'): log-likelihood bit-equal to 'highest': {same}")
    if not same:
        raise AssertionError("dp precision 'high' changed the log-likelihood")


def config4_viterbi(HMMLayer, layer, counters, X):
    """The q = 155 model (select_models) decodes b=64, L=400: K7c and K8c
    once each; valid paths, float64 scores equal to the same decode on a
    CPU copy."""
    import copy

    from hmm_layer_torch.training import select_models

    sel = HMMLayer(select_models(layer.transitions, [4]), [select_models(layer.emissions[0], [4])],
                   use_prior=False, parallel_factor="auto")
    x1 = X[4:5]
    with torch.inference_mode():
        sel.viterbi(x1)  # warm-up
        reset_kernels(counters)
        paths, ms = synced_ms(lambda: sel.viterbi(x1))
        expect(kernel_counts(counters), **{k: 1 for k in WIDE_KEYS})
        init, A = sel.transitions.matrices()
        E = sel.emission_probs(x1)
        cpu = copy.deepcopy(sel).to("cpu")
        paths_cpu = cpu.viterbi(x1.cpu())
        s, used = path_score64(init, A, E, paths)
        s_cpu, _ = path_score64(init, A, E, paths_cpu.to(paths.device))
    q = sel.transitions.num_states[0]
    err, ok = within(s, s_cpu, 1e-5, 0.0)
    log(f"phase 12 config 4 decode (q={q}, b={PROFILE_B}, L={PROFILE_L}, sequential decode, K7c + K8c, "
        f"launches {kernel_counts(counters)}): valid {bool(used.all())}; float64 path scores vs the CPU "
        f"copy's decode max abs {err:.3e} (rtol 1e-5), positions differing {int((paths.cpu() != paths_cpu).sum())}; "
        f"{ms:.3f} ms/batch")
    if not ok or not bool(used.all()):
        raise AssertionError("config 4 decode invalid or off the CPU decode")
    return {"config4_viterbi_ms": ms}


def sample_hmm_sequences(init, A, B, rng, num_seqs, max_len, terminal_state):
    """Generative rollout of one HMM (a copy of the JAX package's
    ``models/simulate.py`` function): ``num_seqs`` (path, symbols) pairs,
    stopping before the terminal state."""
    init, A, B = (np.asarray(x, np.float64) for x in (init, A, B))
    q = A.shape[0]
    init = init / init.sum()
    rows = A / np.maximum(A.sum(-1, keepdims=True), 1e-30)
    emit = B / np.maximum(B.sum(-1, keepdims=True), 1e-30)
    out = []
    for _ in range(num_seqs):
        path, symbols = [], []
        s = rng.choice(q, p=init)
        for _ in range(max_len):
            if s == terminal_state:
                break
            path.append(s)
            symbols.append(rng.choice(emit.shape[-1], p=emit[s]))
            s = rng.choice(q, p=rows[s])
        out.append((np.asarray(path, np.int64), np.asarray(symbols, np.int64)))
    return out


def planted_family(models, rng):
    """The planted profile of ``tests/test_quality.py`` (one dominant
    residue per column, strong match advance, light flanks) and a sample of
    its sequences with their true alignment rows."""
    from hmm_layer_torch.models import initializers as inits

    Lm, S = PLANTED_LM, PLANTED_S
    motif = rng.integers(0, 20, Lm)
    logits = np.zeros((Lm, S), np.float32)
    logits[np.arange(Lm), motif] = 6.0
    b2m = np.full(Lm, -4.0)
    b2m[0] = 4.0
    const = {
        "begin_to_match": b2m, "match_to_match": 3.0, "match_to_insert": -3.0, "match_to_delete": -5.0,
        "match_to_end": -5.0, "insert_to_match": 3.0, "insert_to_insert": -2.0, "delete_to_match": 3.0,
        "delete_to_delete": -2.0, "left_flank_loop": -1.0, "left_flank_exit": 2.0, "right_flank_loop": -1.0,
        "right_flank_exit": 2.0, "end_to_terminal": 4.0, "end_to_right_flank": 0.0,
        "end_to_unannotated_segment": -4.0, "unannotated_segment_loop": -1.0, "unannotated_segment_exit": 2.0,
    }
    trans = models.ProfileTransitions([Lm], transition_init={k: inits.constant_init(v) for k, v in const.items()},
                                      flank_init=inits.constant_init(0.0))
    emit = models.ProfileEmissions([Lm], emission_init=[inits.constant_init(logits)], input_dim=S + 1)
    with torch.no_grad():
        init, A = (t[0].numpy() for t in trans.matrices())
        B_ = emit.make_B()[0].numpy()
    q = 2 * Lm + 3
    seqs = sample_hmm_sequences(init, A, B_, rng, PLANTED_SEQS, 4 * Lm, q - 1)
    lens = np.array([len(p) for p, _ in seqs])
    paths = np.full((len(seqs), lens.max() + 1), q - 1, np.int64)
    res = np.full(paths.shape, S, np.int64)
    for i, (p, s) in enumerate(seqs):
        paths[i, : len(p)] = p
        res[i, : len(s)] = s
    true_rows = models.paths_to_msa(paths, res, model_length=Lm, seq_lengths=lens)
    return ["".join(models.AMINO_ALPHABET[c] for c in s) for _, s in seqs], true_rows


def run_align(args, counters, recursion, tmp, tag):
    """``python -m hmm_layer_torch align`` in-process, the decode's inputs
    and paths captured; returns (rows, captured, launches, seconds)."""
    from hmm_layer_torch import cli, data

    captured = []
    original = recursion.viterbi

    def capture(init, A, E, parallel_factor=1):
        paths = original(init, A, E, parallel_factor)
        captured.append((init, A, E, paths))
        return paths

    out = f"{tmp}/{tag}.fa"
    recursion.viterbi = capture
    reset_kernels(counters)
    try:
        t0 = time.perf_counter()
        rc = cli.main(["align", *args, "-o", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        recursion.viterbi = original
    launches = kernel_counts(counters)
    if rc != 0 or len(captured) != 1:
        raise AssertionError(f"align {tag}: rc {rc}, {len(captured)} decodes")
    return [row for _, row in data.read_fasta(out)], captured[0], launches, wall


def check_rows(tag, rows, seqs):
    same_width = len({len(r) for r in rows}) == 1
    reproduce = all(r.replace("-", "").replace(".", "").upper() == s for r, s in zip(rows, seqs))
    if not (same_width and reproduce and len(rows) == len(seqs)):
        raise AssertionError(f"align {tag}: rows do not reproduce the input sequences")


def planted_align(models, recursion, cuda_viterbi, counters, tmp):
    """align on the planted family: K7b and K8b once each for the final
    decode, bit-equal to the glue on the plain versions; pairs F1 >= 0.9.
    Then 2 adaptation rounds from length 18."""
    seqs, true_rows = planted_family(models, np.random.default_rng(SEED))
    fasta = f"{tmp}/planted.fa"
    with open(fasta, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">p{i}\n{s}\n")
    log(f"phase 12 planted family: Lm={PLANTED_LM}, {len(seqs)} sequences of "
        f"{min(map(len, seqs))}-{max(map(len, seqs))} residues (at most {4 * PLANTED_LM})")
    base = ["-i", fasta, "--models", "3", "--steps", str(ALIGN_STEPS), "--batch", str(PLANTED_SEQS)]
    rows, (init, A, E, paths), launches, wall = run_align(base + ["--model-length", str(PLANTED_LM)],
                                                          counters, recursion, tmp, "align")
    q = A.shape[-1]
    log(f"phase 12 align launches (training {ALIGN_STEPS} steps, scoring, one decode at q={q}): {launches}")
    expect(launches, **{k: 1 for k in BLOCKED_KEYS})
    with torch.inference_mode(), plain_decode_wrappers(cuda_viterbi):
        plain = recursion._viterbi_seq_kernels(init, A, E)
    same = torch.equal(paths, plain)
    check_rows("planted", rows, seqs)
    mets = models.evaluate_msa(rows, true_rows)
    f1 = mets["pairs"]["f1"]
    log(f"phase 12 align: decode paths {'identical to' if same else 'DIFFER FROM'} the glue on the plain "
        f"versions; every row reproduces its input; pairs F1 {f1:.4f} (limit 0.9), column score "
        f"{mets['column_score']:.4f}; {wall:.3f} s wall, {ALIGN_STEPS / wall:.2f} steps/s (with scoring, "
        f"decode and output)")
    if not same or f1 < 0.9:
        raise AssertionError("align on the planted family: decode or F1 wrong")

    rows2, _, launches2, wall2 = run_align(
        ["-i", fasta, "--models", "3", "--steps", str(ALIGN_STEPS), "--batch", str(PLANTED_SEQS),
         "--model-length", "18", "--adapt-rounds", "2"], counters, recursion, tmp, "adapt")
    check_rows("adapt", rows2, seqs)
    mets2 = models.evaluate_msa(rows2, true_rows)
    log(f"phase 12 align --adapt-rounds 2 --model-length 18: launches {launches2}; every row reproduces "
        f"its input; pairs F1 {mets2['pairs']['f1']:.4f}, column score {mets2['column_score']:.4f}; "
        f"{wall2:.3f} s wall")
    return {"align_s": wall, "align_steps_per_s": ALIGN_STEPS / wall, "align_adapt_s": wall2}


def profile_phase(HMMLayer, models, recursion, cuda_viterbi, counters, smi):
    """Phase 12: config 4 serving, training, the structured route, the
    float64 gradients, the precision API and the q = 155 decode; then
    align on a planted family."""
    from hmm_layer_torch.ops import plan7

    t0 = time.perf_counter()
    layer = build_config4(HMMLayer, models)
    q = layer.transitions.num_states
    device = layer.device
    make_x = lambda seed: profile_inputs(seed, PROFILE_B, PROFILE_L, len(PROFILE_LENGTHS), device)  # noqa: E731
    log(f"phase 12 config 4: lengths {PROFILE_LENGTHS} (q {q}), b={PROFILE_B}, L={PROFILE_L}, parallel "
        f"factor {recursion.recommended_parallel_factor(PROFILE_L, max(q), len(q))}, use_prior, num_seqs 1000")
    times = config4_serving(layer, plan7, counters, make_x)
    X = make_x(SEED + 125)
    config4_precision(layer, recursion, X)
    times.update(config4_structured(HMMLayer, models, layer, X))
    times.update(config4_training(layer, counters, X))
    config4_float64(HMMLayer, layer, recursion, make_x)
    times.update(config4_viterbi(HMMLayer, layer, counters, X))
    del layer
    with tempfile.TemporaryDirectory() as tmp:
        times.update(planted_align(models, recursion, cuda_viterbi, counters, tmp))
    log(f"phase 12 summary on {smi}: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    log(f"phase 12 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 13. The host side and the multi-device routes
# ---------------------------------------------------------------------------

DATA_WORLD, SEQ_WORLD, STATE_WORLD = 2, 3, 2  # ranks sharing the one card (gloo)
WORLD_TIMEOUT_S = 300  # every collective of a spawned world, and the world's whole run
ROUTE_LR = 1e-3  # SGD for the route runs' two CE steps: parameters follow gradients linearly
# Config 5's state route: the chunked (border-split) engine at an explicit
# parallel factor over the whole L = 10,000; the layer's "auto" factor (1 at
# q > 64, tuned on a TPU) runs the sequential engine, whose two all-reduces
# a step through gloo take ~1.2 ms, so it and the decode (three a step) are
# cut in length (the time limit).
STATE_PF, STATE_SEQ_L, STATE_VIT_L = 40, 500, 2_000
SIM_GENES = 40
# Launches on each rank of the flagship data route: 3 posteriors + one
# log-likelihood (K1–K3, K1), 3 decodes (K6–K8), one CE gradient and 2 CE
# steps (K1–K5 each).
DATA_ROUTE_LAUNCHES = {
    "sum_chunk_summaries": 7, "sum_fwd_outputs": 6, "beta_bwd_outputs": 6,
    "affine_chunk_composites": 3, "affine_reverse_outputs": 3,
    "maxplus_chunk_summaries": 3, "maxplus_deltas": 3, "maxplus_backtrace": 3,
}
# ... of the sequence route (plain primal and decode, as in the JAX
# package): K4 and K5 once in each of its 3 CE backwards, nothing else.
SEQ_ROUTE_LAUNCHES = {"affine_chunk_composites": 3, "affine_reverse_outputs": 3}
# ... and of its CE step under local=True: K4 and K5 once each.
SEQ_LOCAL_CE_LAUNCHES = {"affine_chunk_composites": 1, "affine_reverse_outputs": 1}


def route_counters():
    from hmm_layer_torch.ops import cuda_adjoint, cuda_forward, cuda_mxu, cuda_viterbi

    return (cuda_forward, cuda_adjoint, cuda_viterbi, cuda_mxu)


def check_launches(tag, got, expected):
    want = {k: expected.get(k, 0) for k in got}
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want}")


def gloo_cuda_probe():
    """Rank body: which collectives the installed torch's gloo takes on
    CUDA tensors (each call made by every rank, in the same order)."""
    import torch.distributed as dist

    n, rank = dist.get_world_size(), dist.get_rank()
    x = torch.full((4,), float(rank + 1), device="cuda")
    gathered = torch.arange(1, n + 1, device="cuda", dtype=x.dtype).repeat_interleave(4)

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return bool((y == n * (n + 1) / 2).all())

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0)
        return bool((y == 1).all())

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        return bool((torch.cat(parts) == gathered).all())

    def all_gather_into_tensor():  # the one-buffer form collectives.all_gather takes
        from hmm_layer_torch.parallel.collectives import _gather_into

        y = torch.empty(n * 4, device="cuda")
        _gather_into()(y, x)
        return bool((y == gathered).all())

    # Point-to-point send/recv of a CUDA tensor under gloo aborts the
    # sending process (gloo::IoException "writev: Bad address", torch 2.11):
    # the collectives helper shifts through all-gathers and never sends;
    # its all-gathers gather into one flat buffer.
    out = {}
    for op in (all_reduce, broadcast, all_gather, all_gather_into_tensor):
        try:
            out[op.__name__] = "ok" if op() else "WRONG VALUES"
        except Exception as exc:  # noqa: BLE001 — the probe records any refusal
            out[op.__name__] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:120]}"
    return out


def route_result(layer, X, labels, mask, requests, decodes):
    """The timed calls of one rank on one route: posterior requests, one
    log-likelihood, decodes, one CE gradient and two SGD CE steps; its
    launches between them and the results (rank 0) as CPU tensors."""
    import functools

    import torch.distributed as dist
    from hmm_layer_torch.training import Trainer

    counters = route_counters()
    with torch.inference_mode():  # warm-up, not counted
        layer.state_posterior_log_probs(X)
        layer.viterbi(X)
    warm = torch.zeros(1, device=X.device, requires_grad=True)
    warm.grad = torch.zeros_like(warm)
    torch.optim.SGD([warm], lr=ROUTE_LR).step()  # the first optimizer step's one-off set-up
    torch.cuda.synchronize()
    reset_kernels(counters)
    out = {"rank": dist.get_rank(), "backend": dist.get_backend()}
    with torch.inference_mode():
        times = []
        for _ in range(requests):
            lg, ms = synced_ms(lambda: layer.state_posterior_log_probs(X))
            times.append(ms)
        out["post_ms"] = times
        ll, out["ll_ms"] = synced_ms(lambda: layer.log_likelihood(X))
        times = []
        for _ in range(decodes):
            path, ms = synced_ms(lambda: layer.viterbi(X))
            times.append(ms)
        out["decode_ms"] = times
    (loss, grads), out["grad_ms"] = synced_ms(lambda: param_grads(layer, "ce", X, labels, mask))
    trainer = Trainer(layer, optimizer=functools.partial(torch.optim.SGD, lr=ROUTE_LR),
                      loss_fn=lambda x, _: layer.posterior_cross_entropy(x, labels, label_mask=mask))
    steps = []
    for _ in range(2):
        step_loss, ms = synced_ms(lambda: trainer.fit([X], log_every=100))
        steps.append((float(step_loss), ms))
    out["steps"] = steps
    out["launches"] = kernel_counts(counters)
    if out["rank"] == 0:
        out.update(lg=lg.cpu(), ll=ll.cpu(), path=path.cpu(), loss=float(loss),
                   grads=[g.cpu() for g in grads],
                   params={k: v.detach().cpu() for k, v in layer.state_dict().items()})
    return out


def data_route_rank():
    """Rank body of the flagship's data route ({"batch": "data"})."""
    import torch.distributed as dist
    from hmm_layer_torch import HMMLayer, models
    from hmm_layer_torch.parallel import make_mesh

    X = make_inputs(SEED, B, L, torch.device("cuda"))
    dense = build_layer(HMMLayer, models)
    labels, mask = ce_targets(dense, X)
    del dense
    mesh = make_mesh({"data": dist.get_world_size()})
    layer = seeded_layer(HMMLayer, models.GenePredTransitions(), models.GenePredEmissions(**CODONS), SEED,
                         use_prior=False, mesh=mesh, partition={"batch": "data"})
    return route_result(layer, X, labels, mask, N_REQUESTS, N_REQUESTS)


def seq_route_rank(problem):
    """Rank body of the flagship's sequence route ({"seq": "seq"}): the
    layer's timed calls, then the route's functions on the caller's
    ``problem`` (its init, A, E, labels and mask) in float32 (K4/K5 in the
    CE backward, not counted) and in float64 (plain solves: the kernels
    are float32)."""
    import torch.distributed as dist
    from hmm_layer_torch import HMMLayer, models
    from hmm_layer_torch.ops import recursion
    from hmm_layer_torch.parallel import make_mesh
    from hmm_layer_torch.parallel import sharding as S

    X = make_inputs(SEED, B, L, torch.device("cuda"))
    dense = build_layer(HMMLayer, models)
    labels, mask = ce_targets(dense, X)
    del dense
    mesh = make_mesh({"seq": dist.get_world_size()})
    layer = seeded_layer(HMMLayer, models.GenePredTransitions(), models.GenePredEmissions(**CODONS), SEED,
                         use_prior=False, mesh=mesh, partition={"seq": "seq"})
    P_local = recursion.recommended_parallel_factor(L // mesh.shape["seq"], NUM_CLASSES, 1)
    out = route_result(layer, X, labels, mask, 2, 2)
    fns = (lambda i, a, e: S.seq_sharded_posterior(i, a, e, mesh, "seq", local_parallel_factor=P_local),
           lambda i, a, e: S.seq_sharded_log_likelihood(i, a, e, mesh, "seq", local_parallel_factor=P_local))
    args = [problem[k].cuda() for k in ("init", "A", "E", "labels", "mask")]
    out["f32"] = route_objectives(*fns, *args)
    with plain_route(recursion):
        out["f64"] = route_objectives(*fns, *[t.double() for t in args[:3]], *args[3:])
    if out["rank"] != 0:
        del out["f32"], out["f64"]
    out["local"] = seq_local_calls(mesh, P_local, *args)
    out["layer_local"] = layer_local_calls(layer, X, labels, mask)
    return out


def block_error(local, glob):
    """A local block against its block of the global result: max abs
    difference, and whether the two are bit-equal."""
    return {"max_abs": float((local - glob).abs().max()), "bit_equal": bool(torch.equal(local, glob))}


def layer_local_calls(layer, X, labels, mask):
    """Rank body part: the sequence route's layer posterior and CE step
    (the loss and its parameter gradients) in the global mode and under
    ``local=True`` (the emitters compute only the rank's positions of E,
    with the codon factors' halo; :func:`measured_call`). The local
    posterior against the global one's block (the parent holds it
    bit-equal: the emitters compute the same columns, the function's
    local mode the same arithmetic), the local CE value and gradients
    against the global ones (the parent holds them to float32 limits: the
    value is the sum of the ranks' partial sums, the emitters' gradients
    the sum of the ranks' shares, each in another order than the global
    mode's), and the local CE step's launches."""
    counters = route_counters()
    pars = [p for p in layer.parameters() if p.requires_grad]
    r = layer.local_ranges((*X.shape[:3], layer.transitions.num_states))
    ce = lambda **kw: grads_of(layer.posterior_cross_entropy(X, labels, label_mask=mask, **kw), pars)  # noqa: E731
    recs, errs = {}, {}
    lg, recs["layer posterior global"] = measured_call(lambda: layer.state_posterior_log_probs(X))
    lg_l, recs["layer posterior local"] = measured_call(lambda: layer.state_posterior_log_probs(X, local=True))
    errs["posterior"] = block_error(lg_l, lg[r.index])
    del lg, lg_l
    (loss, g), recs["layer CE step global"] = measured_call(ce, inference=False)
    reset_kernels(counters)
    (loss_l, g_l), recs["layer CE step local"] = measured_call(lambda: ce(local=True), inference=False)
    launches = kernel_counts(counters)
    errs["CE loss rel"] = float(abs(loss_l - loss) / abs(loss))
    errs["CE gradients"] = grad_drift(g_l, g)
    return {"records": recs, "errors": errs, "launches": launches, "ranges": tuple(r)}


def seq_local_calls(mesh, P_local, init, A, E, labels, mask):
    """Rank body part: the sequence route's posterior and CE step (the
    masked CE's gradients with respect to init, A and E), each as a global
    call on the whole E and then under ``local=True`` on this rank's block
    of positions (:func:`measured_call`); the local results against the
    global ones' blocks (bit-equal), and the local CE step's launches (K4
    and K5 once each in its backward)."""
    from hmm_layer_torch.parallel import local_ranges
    from hmm_layer_torch.parallel import sharding as S

    counters = route_counters()
    r = local_ranges(mesh, "seq", E.shape)
    E_l, pos = E[r.index].contiguous(), slice(*r.positions)
    total = mask.sum()

    def post(e, **kw):
        return S.seq_sharded_posterior(init, A, e, mesh, "seq", local_parallel_factor=P_local, **kw)

    def ce_step(e, lab, msk, **kw):
        xs = [t.detach().clone().requires_grad_() for t in (init, A, e)]
        lg, _ = S.seq_sharded_posterior(*xs, mesh, "seq", local_parallel_factor=P_local, **kw)
        ce = -(torch.gather(lg, -1, lab[None, ..., None])[..., 0] * msk).sum() / total
        return torch.autograd.grad(ce, xs)

    recs, equal = {}, {}
    (lg, ll), recs["posterior global"] = measured_call(lambda: post(E))
    (lg_l, ll_l), recs["posterior local"] = measured_call(lambda: post(E_l, local=True))
    equal["posterior"] = torch.equal(lg_l, lg[r.index]) and torch.equal(ll_l, ll)
    del lg, ll, lg_l, ll_l
    g, recs["CE step global"] = measured_call(lambda: ce_step(E, labels, mask), inference=False)
    reset_kernels(counters)
    g_l, recs["CE step local"] = measured_call(lambda: ce_step(E_l, labels[:, pos], mask[:, pos], local=True),
                                               inference=False)
    launches = kernel_counts(counters)
    equal["CE gradients"] = (torch.equal(g_l[0], g[0]) and torch.equal(g_l[1], g[1])
                             and torch.equal(g_l[2], g[2][r.index]))
    return {"records": recs, "equal": equal, "launches": launches, "ranges": tuple(r)}


def route_objectives(post, loglik, init, A, E, labels, mask):
    """The masked posterior CE and the summed log-likelihood of (init, A,
    E) through ``post`` and ``loglik``, with their gradients with respect
    to init, A and E; everything as float64 on the CPU."""
    xs = [t.detach().clone().requires_grad_() for t in (init, A, E)]
    lg, _ = post(*xs)
    ce = -(torch.gather(lg, -1, labels[None, ..., None])[..., 0] * mask).sum() / mask.sum()
    g_ce = torch.autograd.grad(ce, xs)
    ll = loglik(*xs)
    g_ll = torch.autograd.grad(ll.sum(), xs)
    cpu = lambda t: t.detach().double().cpu()  # noqa: E731
    return {"ce": float(ce.detach()), "ll": cpu(ll), "lg": cpu(lg),
            "g_ce": [cpu(g) for g in g_ce], "g_ll": [cpu(g) for g in g_ll]}


def objective_errors(got, ref):
    """Errors of :func:`route_objectives` results against a reference:
    loglik max rel, log gamma max abs where gamma >= 1e-3, CE rel, and
    each objective's gradients max abs over the largest (the worst of
    init, A, E)."""
    rel = lambda g, r: float((g - r).abs().max() / r.abs().max().clamp_min(1e-300))  # noqa: E731
    big = ref["lg"].exp() >= 1e-3
    return {
        "ll": float(((got["ll"] - ref["ll"]).abs() / ref["ll"].abs()).max()),
        "lg": float((got["lg"] - ref["lg"]).abs()[big].max()),
        "ce": abs(got["ce"] - ref["ce"]) / abs(ref["ce"]),
        "g_ce": max(rel(g, r) for g, r in zip(got["g_ce"], ref["g_ce"])),
        "g_ll": max(rel(g, r) for g, r in zip(got["g_ll"], ref["g_ll"])),
    }


# The sequence route in float64 against the unsharded plain engine in
# float64: the same sums up to their order, so they agree to float64
# rounding (1e-12 relative at b=4, L=1200 on the CPU); a wrong VJP or a
# boundary shift shows here at any size.
SEQ_F64_LIMITS = {"ll": 1e-10, "lg": 1e-6, "ce": 1e-9, "g_ce": 1e-7, "g_ll": 1e-7}
# In float32 every ordering of these sums drifts at this length (|loglik|
# ~1.1e5, 303 steps a chunk): the sequence route is held, per quantity, to
# within this multiple of the unsharded engine's own float32 drift (the
# larger of its kernel and plain routes' errors against float64).
F32_NOISE_FACTOR = 4.0


def layer_truth(layer, X, labels, mask, recursion):
    """The layer's CE loss and parameter gradients anchored in float64: the
    unsharded plain engine's float64 CE and its gradients with respect to
    init, A and E (:func:`route_objectives`) pulled back through the
    layer's own matrices and emissions (float32, whose rounding is ~1e-7),
    with the emissions in training mode as ``posterior_cross_entropy``
    takes them."""
    pars = [p for p in layer.parameters() if p.requires_grad]
    init, A = layer.transitions.matrices()
    E = layer.emission_probs(X, training=True)
    with plain_route(recursion):
        obj64 = route_objectives(lambda i, a, e: recursion.posterior(i, a, e, PF),
                                 lambda i, a, e: recursion.log_likelihood(i, a, e, PF),
                                 init.double(), A.double(), E.double(), labels, mask)
    aux, grads = pull_back(layer, pars, [init, A, E], obj64["g_ce"])
    return {"loss": obj64["ce"] + aux, "grads": grads}


def pull_back(layer, pars, outs, cts):
    """(the auxiliary loss, the parameter gradients) of ``layer`` from the
    cotangents ``cts`` of its ingredients ``outs`` (any dtype) plus its
    auxiliary loss's own gradient, through the layer's float32 Jacobian."""
    outs, cts = list(outs), [g.to(o.device, o.dtype) for g, o in zip(cts, outs)]
    aux = layer.aux_loss()
    if torch.is_tensor(aux) and aux.requires_grad:
        outs.append(aux)
        cts.append(torch.ones_like(aux))
    grads = torch.autograd.grad(outs, pars, grad_outputs=cts, allow_unused=True)
    return (float(aux.detach() if torch.is_tensor(aux) else aux),
            [torch.zeros_like(p) if g is None else g for g, p in zip(grads, pars)])


def grad_drift(grads, truth):
    """Gradients against a reference: max abs over the largest, the worst
    parameter."""
    return max(float((g.to(t.device) - t).abs().max() / t.abs().max().clamp_min(1e-12)) for g, t in zip(grads, truth))


def layer_drift(r, truth):
    """A layer's float32 CE loss (rel) and parameter gradients
    (:func:`grad_drift`) against :func:`layer_truth`."""
    return {"loss": abs(float(r["loss"]) - truth["loss"]) / abs(truth["loss"]),
            "grads": grad_drift(r["grads"], truth["grads"])}


def state_route_rank(b, length, pf, seq_length, vit_length):
    """Rank body of config 5's state route ({"state": "state"}; q = 505 is
    padded to a multiple of the axis): posterior and log-likelihood on the
    chunked engine (parallel factor ``pf``) over ``length`` and on the
    sequential engine over ``seq_length``, the decode over ``vit_length``;
    none of K1–K9 may launch."""
    import torch.distributed as dist
    from hmm_layer_torch import HMMLayer, models
    from hmm_layer_torch.parallel import make_mesh

    counters = route_counters()
    mesh = make_mesh({"state": dist.get_world_size()})
    layer = build_config5(HMMLayer, models, sparse_forward=False)
    layer.mesh, layer.partition = mesh, {"state": "state"}
    X = make_inputs(SEED + 137, b, length, torch.device("cuda"))
    reset_kernels(counters)
    out = {"rank": dist.get_rank(), "backend": dist.get_backend()}
    with torch.inference_mode():
        for P, n in ((pf, length), (1, seq_length)):
            layer.parallel_factor = P
            (out[f"lg_{P}"], out[f"ll_{P}"]), out[f"post_ms_{P}"] = synced_ms(
                lambda: (layer.state_posterior_log_probs(X[:, :, :n]), layer.log_likelihood(X[:, :, :n])))
        out["path"], out["decode_ms"] = synced_ms(lambda: layer.viterbi(X[:, :, :vit_length]))
    out["launches"] = kernel_counts(counters)
    for key in ("lg_1", f"lg_{pf}", "ll_1", f"ll_{pf}", "path"):
        out[key] = out[key].cpu() if out["rank"] == 0 else None
    out["local"] = state_local_calls(layer, X, mesh, pf)
    return out


def state_local_calls(layer, X, mesh, pf):
    """Rank body part: the dense state route's chunked posterior (parallel
    factor ``pf``) on the layer's padded ingredients, as a global call and
    under ``local=True`` on this rank's (rows, state columns) block
    (:func:`measured_call`); the local result against the global one's
    block (bit-equal)."""
    from hmm_layer_torch.parallel import local_ranges
    from hmm_layer_torch.parallel import sharding as S

    with torch.inference_mode():
        init, A, E, _, _ = layer._inputs(X)  # E padded to the state blocks
        init, A = layer._pad_transitions(init, A)
    r = local_ranges(mesh, "state", E.shape)
    E_l = E[r.index].contiguous()

    def post(e, **kw):
        return S.state_sharded_posterior(init, A, e, mesh, "state", parallel_factor=pf, **kw)

    recs = {}
    (lg, ll), recs["chunked posterior global"] = measured_call(lambda: post(E))
    (lg_l, ll_l), recs["chunked posterior local"] = measured_call(lambda: post(E_l, local=True))
    equal = {"chunked posterior": torch.equal(lg_l, lg[r.index]) and torch.equal(ll_l, ll)}
    return {"records": recs, "equal": equal, "ranges": tuple(r)}


def route_reference(layer, X, labels, mask, rows=None):
    """The unsharded layer's results on the same inputs and weights: the
    posterior, log-likelihood and decode, one CE gradient and two SGD CE
    steps."""
    import functools

    from hmm_layer_torch.training import Trainer

    with torch.inference_mode():
        ref = {"lg": layer.state_posterior_log_probs(X), "ll": layer.log_likelihood(X),
               "path": layer.viterbi(X)}
    ref["loss"], ref["grads"] = param_grads(layer, "ce", X, labels, mask)
    trainer = Trainer(layer, optimizer=functools.partial(torch.optim.SGD, lr=ROUTE_LR),
                      loss_fn=lambda x, _: layer.posterior_cross_entropy(x, labels, label_mask=mask))
    ref["steps"] = [float(trainer.fit([X], log_every=100)) for _ in range(2)]
    ref["params"] = {k: v.detach().clone() for k, v in layer.state_dict().items()}
    return ref


def compare_route(tag, got, ref, init, A, E, lg_tol, grad_tol, loss_tol):
    """Hold one route's rank-0 results to the unsharded layer's: loglik
    (rtol 1e-4), log gamma where gamma >= 1e-3 (max abs ``lg_tol``; gamma's
    own max abs is printed), decode (valid, float64 scores rel 1e-6), the
    CE loss (rel ``loss_tol``) and its gradients (max abs over the
    largest, ``grad_tol``), the parameters after two SGD steps (within
    twice the step times the gradient limit) and the steps' losses (rel
    ``loss_tol``, plus the first-order change that parameters apart by
    that limit can make: the gradients' L1 norm times it)."""
    dev = ref["lg"].device
    lg, ll, path = got["lg"].to(dev), got["ll"].to(dev), got["path"].to(dev)
    ll_err, ll_ok = within(ll, ref["ll"], 1e-4, 0.0)
    lg_err, lg_ok = within(lg, ref["lg"], 0.0, lg_tol, mask=ref["lg"].exp() >= 1e-3)
    g_err = float((lg.exp() - ref["lg"].exp()).abs().max())
    score, used = path_score64(init, A, E, path)
    score_ref, used_ref = path_score64(init, A, E, ref["path"])
    valid = bool((used | ~used_ref).all())
    s_err, s_ok = within(score, score_ref, 1e-6, 0.0)
    same = float((path == ref["path"]).float().mean())
    loss_err = abs(got["loss"] - float(ref["loss"])) / abs(float(ref["loss"]))
    grad_err = max(float((g.to(dev) - r).abs().max() / r.abs().max().clamp_min(1e-12))
                   for g, r in zip(got["grads"], ref["grads"]))
    step_err = max(abs(a - b) / abs(b) for (a, _), b in zip(got["steps"], ref["steps"]))
    par_err = max(float((got["params"][k].to(dev) - v).abs().max()) for k, v in ref["params"].items())
    par_tol = 2 * ROUTE_LR * grad_tol * max(float(r.abs().max()) for r in ref["grads"])
    step_tol = loss_tol + sum(float(r.abs().sum()) for r in ref["grads"]) * par_tol / min(map(abs, ref["steps"]))
    log(f"phase 13 {tag} vs the unsharded layer: loglik max abs {ll_err:.3e} (rtol 1e-4); log gamma where "
        f"gamma >= 1e-3 max abs {lg_err:.3e} (limit {lg_tol:.3g}), gamma max abs {g_err:.3e}; decode valid "
        f"{valid}, float64 scores max abs {s_err:.3e} (rtol 1e-6), paths equal at {100 * same:.3f}% of "
        f"positions; CE loss rel {loss_err:.2e} (limit {loss_tol}), gradients max abs / max {grad_err:.3e} "
        f"(limit {grad_tol}); SGD steps' losses rel {step_err:.2e} (limit {step_tol:.3e}), parameters max "
        f"abs {par_err:.3e} (limit {par_tol:.3e})")
    if not (ll_ok and lg_ok and valid and s_ok and loss_err <= loss_tol and grad_err <= grad_tol
            and step_err <= step_tol and par_err <= par_tol):
        raise AssertionError(f"{tag}: the route disagrees with the unsharded layer")
    return {"ll_err": ll_err, "lg_err": lg_err, "gamma_err": g_err, "grad_err": grad_err, "paths_equal": same}


def local_text(name, rec):
    return f"{name} {rec['ms']:.1f} ms, peak {rec['above_mib']:.1f} MiB above the call's start"


def report_local(tag, results):
    """Log each rank's global and rank-local calls (ms, peak memory above
    the call's start) and fail where a local result differs from its block
    of the global one."""
    for r in results:
        loc = r["local"]
        log(f"phase 13 {tag} rank {r['rank']}, global vs local=True (block rows, positions, states "
            f"{loc['ranges']}): " + "; ".join(local_text(k, v) for k, v in loc["records"].items())
            + f"; local bit-equal to the global blocks: {loc['equal']}")
    bad = [(r["rank"], k) for r in results for k, ok in r["local"]["equal"].items() if not ok]
    if bad:
        raise AssertionError(f"{tag}: local mode differs from the global mode's blocks: {bad}")


def report_layer_local(tag, results, limits):
    """Log each rank's layer calls global and under ``local=True`` (ms,
    peak memory above the call's start) and the local results' errors
    against the global ones, beside their limits; fail where the
    posterior is not bit-equal or an error passes its limit."""
    bad = []
    for r in results:
        loc = r["layer_local"]
        errs = loc["errors"]
        post = errs["posterior"]
        text = [f"posterior max abs {post['max_abs']:.3e}, bit-equal {post['bit_equal']} (must be)"]
        if not post["bit_equal"]:
            bad.append((r["rank"], "posterior"))
        for key, lim in limits.items():
            text.append(f"{key} {errs[key]:.3e} (limit {lim:.3e})")
            if not errs[key] <= lim:
                bad.append((r["rank"], key))
        log(f"phase 13 {tag} rank {r['rank']}, the layer global vs local=True (block rows, positions, states "
            f"{loc['ranges']}): " + "; ".join(local_text(k, v) for k, v in loc["records"].items())
            + "; local against global: " + ", ".join(text))
    if bad:
        raise AssertionError(f"{tag}: the layer's local mode differs from its global mode's blocks: {bad}")


def rank_times(tag, results):
    for r in results:
        med = statistics.median
        log(f"phase 13 {tag} rank {r['rank']} ({r['backend']}): launches {r['launches']}; posterior "
            f"{med(r['post_ms']):.3f} ms/batch median {[round(t, 3) for t in r['post_ms']]}, loglik "
            f"{r['ll_ms']:.3f}, decode {med(r['decode_ms']):.3f} median {[round(t, 3) for t in r['decode_ms']]}, "
            f"CE gradient {r['grad_ms']:.3f}, SGD CE steps {[round(ms, 3) for _, ms in r['steps']]} ms")


def routes_phase(HMMLayer, models, make, smi):
    """Phase 13 (a)–(c): the data, sequence and state routes."""
    import torch.distributed as dist
    from hmm_layer_torch.ops import recursion
    from hmm_layer_torch.parallel import init_distributed, launch, make_mesh

    t0 = time.perf_counter()
    X = make(SEED, B, L)
    dense = build_layer(HMMLayer, models)
    labels, mask = ce_targets(dense, X)
    with torch.inference_mode():
        init, A = dense.transitions.matrices()
        E = dense.emission_probs(X)
    ref = route_reference(dense, X, labels, mask)
    del dense
    summary = {}

    # (a) data route, world 1 under NCCL in this process
    init_distributed("nccl", init_method=f"tcp://localhost:{launch.free_port()}", world_size=1, rank=0,
                     timeout_s=WORLD_TIMEOUT_S)
    try:
        got = data_route_rank()
        rank_times("data route world 1", [got])
        check_launches("data route world 1", got["launches"], DATA_ROUTE_LAUNCHES)
        # The same kernels on the same rows: equal to the unsharded layer.
        summary["data_w1"] = compare_route("data route world 1 (NCCL)", got, ref, init, A, E, 0.0, 0.0, 0.0)

        # The sequence and state routes at world 1 under NCCL, small inputs.
        mesh = make_mesh({"seq": 1, "state": 1})
        small = make(SEED + 139, 4, 1200)
        for part in ({"seq": "seq"}, {"state": "state"}):
            routed = seeded_layer(HMMLayer, models.GenePredTransitions(), models.GenePredEmissions(**CODONS),
                                  SEED, use_prior=False, mesh=mesh, partition=part)
            plain = build_layer(HMMLayer, models)
            with torch.inference_mode():
                lg_r, ll_r = routed.state_posterior_log_probs(small), routed.log_likelihood(small)
                lg_p, ll_p = plain.state_posterior_log_probs(small), plain.log_likelihood(small)
                path_r, path_p = routed.viterbi(small), plain.viterbi(small)
                si, sA = plain.transitions.matrices()
                sE = plain.emission_probs(small)
            ll_err, ll_ok = within(ll_r, ll_p, 1e-4, 0.0)
            bound = 2 * f32_log_bound(ll_p, 1200)
            lg_err, lg_ok = within(lg_r, lg_p, 0.0, bound, mask=lg_p.exp() >= 1e-3)
            s_err, s_ok = within(path_score64(si, sA, sE, path_r)[0], path_score64(si, sA, sE, path_p)[0], 1e-6, 0.0)
            log(f"phase 13 {list(part)[0]} route world 1 (NCCL; b=4, L=1200): loglik max abs {ll_err:.3e} "
                f"(rtol 1e-4), log gamma where gamma >= 1e-3 max abs {lg_err:.3e} (bound {bound:.3f}), gamma "
                f"max abs {float((lg_r.exp() - lg_p.exp()).abs().max()):.3e}, decode float64 scores max abs "
                f"{s_err:.3e} (rtol 1e-6)")
            if not (ll_ok and lg_ok and s_ok):
                raise AssertionError(f"{part}: world-1 route disagrees with the dense layer")

        # The sparse layer's data route: the edge-list engine on the rank's rows.
        sparse = [seeded_layer(HMMLayer, models.GenePredTransitions(sparse_forward=True),
                               models.GenePredEmissions(**CODONS), SEED, use_prior=False, **kw)
                  for kw in ({"mesh": make_mesh({"data": 1}), "partition": {"batch": "data"}}, {})]
        with torch.inference_mode():
            outs = [(lay.state_posterior_log_probs(small), lay.viterbi(small)) for lay in sparse]
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        log(f"phase 13 sparse layer data route world 1 (NCCL; b=4, L=1200): posterior and decode "
            f"{'equal to' if same else 'DIFFER FROM'} the sparse layer without a mesh")
        if not same:
            raise AssertionError("the sparse layer's data route differs from its single-device route")
        edge_route_world1(HMMLayer, models, make_mesh, small, sparse[1])
    finally:
        dist.destroy_process_group()

    # Which collectives gloo takes on CUDA tensors: the shared-card worlds need all_reduce and all_gather.
    try:
        probe = launch.run_world(gloo_cuda_probe, 2, backend="gloo", timeout_s=60)[0]
    except (RuntimeError, TimeoutError) as exc:
        probe = f"the probe world failed: {str(exc)[-300:]}"
    log(f"phase 13 gloo on CUDA tensors (torch {torch.__version__}; values checked): {probe}")
    if not isinstance(probe, dict) or any(probe[k] != "ok" for k in ("all_reduce", "all_gather_into_tensor")):
        raise AssertionError("gloo refuses a collective the shared-card worlds use on CUDA tensors")

    # (a) data route, world 2 on the shared card
    results = launch.run_world(data_route_rank, DATA_WORLD, backend="gloo", timeout_s=WORLD_TIMEOUT_S)
    rank_times(f"data route world {DATA_WORLD}", results)
    for r in results:
        check_launches(f"data route rank {r['rank']}", r["launches"], DATA_ROUTE_LAUNCHES)
    bound = 2 * f32_log_bound(ref["ll"], L // PF)
    summary["data_w2"] = compare_route(f"data route world {DATA_WORLD} (gloo, shared card)", results[0], ref,
                                       init, A, E, bound, 1e-4, 1e-5)
    summary["data_w2_post_ms"] = statistics.median(results[0]["post_ms"])
    summary["data_w2_decode_ms"] = statistics.median(results[0]["decode_ms"])
    summary["data_w2_step_ms"] = results[0]["steps"][1][1]

    # (b) sequence route, world 3: 3,333 positions a rank. Its primal runs
    # the plain ops (as in JAX), and its CE backward K4/K5 (bit-equal to the
    # plain solves, phase 3). In float64 it is held to the unsharded plain
    # engine at float64 rounding; in float32 to F32_NOISE_FACTOR times the
    # float32 drift from float64 that the unsharded engine itself shows
    # here, for the functions and for the layer.
    problem = {"init": init.cpu(), "A": A.cpu(), "E": E.cpu(), "labels": labels.cpu(), "mask": mask.cpu()}
    dense_fns = (lambda i, a, e: recursion.posterior(i, a, e, PF),
                 lambda i, a, e: recursion.log_likelihood(i, a, e, PF))
    obj_kernel = route_objectives(*dense_fns, init, A, E, labels, mask)
    with plain_route(recursion):
        obj_plain = route_objectives(*dense_fns, init, A, E, labels, mask)
        obj64 = route_objectives(*dense_fns, init.double(), A.double(), E.double(), labels, mask)
        ref_plain = route_reference(build_layer(HMMLayer, models), X, labels, mask)
    truth = layer_truth(build_layer(HMMLayer, models), X, labels, mask, recursion)
    noise = {k: max(v, objective_errors(obj_plain, obj64)[k])
             for k, v in objective_errors(obj_kernel, obj64).items()}
    results = launch.run_world(seq_route_rank, SEQ_WORLD, problem, backend="gloo", timeout_s=WORLD_TIMEOUT_S)
    rank_times(f"seq route world {SEQ_WORLD}", results)
    for r in results:
        check_launches(f"seq route rank {r['rank']}", r["launches"], SEQ_ROUTE_LAUNCHES)
        check_launches(f"seq route rank {r['rank']} local CE step", r["local"]["launches"], SEQ_LOCAL_CE_LAUNCHES)
    report_local(f"seq route world {SEQ_WORLD} functions", results)
    summary.update({f"seq_w3_{k.replace(' ', '_')}_ms": v["ms"] for k, v in results[0]["local"]["records"].items()})
    got = results[0]
    err64 = objective_errors(got["f64"], obj64)
    err32 = objective_errors(got["f32"], obj64)
    fmt = lambda d: ", ".join(f"{k} {v:.3e}" for k, v in d.items())  # noqa: E731
    log(f"phase 13 seq route world {SEQ_WORLD} functions in float64 vs the unsharded plain engine in float64 "
        f"(loglik max rel, log gamma max abs where gamma >= 1e-3, CE rel, gradients max abs / max): "
        f"{fmt(err64)} (limits {fmt(SEQ_F64_LIMITS)})")
    log(f"phase 13 seq route world {SEQ_WORLD} functions in float32 vs float64: {fmt(err32)}; the unsharded "
        f"engine's own float32 drift (the larger of its kernel and plain routes): {fmt(noise)} (limits "
        f"{F32_NOISE_FACTOR:g}x)")
    if any(err64[k] > lim for k, lim in SEQ_F64_LIMITS.items()):
        raise AssertionError("the seq route in float64 disagrees with the unsharded engine")
    if any(err32[k] > F32_NOISE_FACTOR * noise[k] for k in noise):
        raise AssertionError("the seq route in float32 drifts more than the unsharded engine")
    summary["seq_w3_f64"], summary["seq_w3_f32"], summary["f32_noise"] = err64, err32, noise
    # The layer in float32 against its float64-anchored CE loss and
    # parameter gradients: the seq route's drift, held to F32_NOISE_FACTOR
    # times the larger of the unsharded layer's two routes' drift.
    drift = {name: layer_drift(r, truth) for name, r in (("kernel", ref), ("plain", ref_plain), ("seq", got))}
    layer_noise = {k: max(drift["kernel"][k], drift["plain"][k]) for k in ("loss", "grads")}
    log(f"phase 13 the layers' CE loss (rel) and parameter gradients (max abs / max) in float32 against "
        f"their float64-anchored values: " + "; ".join(f"{n} {fmt(d)}" for n, d in drift.items())
        + f" (seq limits {F32_NOISE_FACTOR:g}x the larger of kernel and plain)")
    if any(drift["seq"][k] > F32_NOISE_FACTOR * layer_noise[k] for k in layer_noise):
        raise AssertionError("the seq route's layer drifts more in float32 than the unsharded layer")
    summary["seq_w3_layer_drift"] = drift
    summary["seq_w3"] = compare_route(f"seq route world {SEQ_WORLD} (gloo, shared card; {L // SEQ_WORLD} "
                                      f"positions a rank) vs the plain route", got, ref_plain, init, A, E, bound,
                                      F32_NOISE_FACTOR * layer_noise["grads"], F32_NOISE_FACTOR * layer_noise["loss"])
    summary["seq_w3_post_ms"] = statistics.median(results[0]["post_ms"])
    summary["seq_w3_decode_ms"] = statistics.median(results[0]["decode_ms"])
    summary["seq_w3_step_ms"] = results[0]["steps"][1][1]
    limits = {"CE loss rel": F32_NOISE_FACTOR * layer_noise["loss"],
              "CE gradients": F32_NOISE_FACTOR * layer_noise["grads"]}
    report_layer_local(f"seq route world {SEQ_WORLD}", results, limits)
    for r in results:
        check_launches(f"seq route rank {r['rank']} layer local CE step", r["layer_local"]["launches"],
                       SEQ_LOCAL_CE_LAUNCHES)
    summary.update({f"seq_w3_{k.replace(' ', '_')}_ms": v["ms"] for k, v in results[0]["layer_local"]["records"].items()})
    del X, E, ref, ref_plain, obj_kernel, obj_plain, obj64, truth

    # (c) state route at config 5, world 2
    twin = build_config5(HMMLayer, models, sparse_forward=False)
    Xc = make(SEED + 137, SPARSE_B, SPARSE_L)

    with torch.inference_mode():
        (lg_d, ll_d), dense_ms = synced_ms(lambda: (twin.state_posterior_log_probs(Xc), twin.log_likelihood(Xc)))
        # The chunked route's reference is the dense chunked engine at the
        # same factor (as in the JAX suite): chunked and sequential engines
        # differ by the clamps of this sparse grammar's operators. At
        # L = 10,000 neither engine's gamma is normalised (the EPS clamps,
        # in float64 as in float32 and in the JAX engines alike:
        # tests/test_torch_config5_posterior.py), so the full-length check
        # is agreement with the reference engine, not a valid posterior.
        ti, tA = twin.transitions.matrices()
        lg_c, ll_c = recursion.posterior(ti, tA, twin.emission_probs(Xc), STATE_PF)
        short = Xc[:, :, :STATE_SEQ_L]
        lg_s, ll_s = twin.state_posterior_log_probs(short), twin.log_likelihood(short)
        path_d = twin.viterbi(Xc[:, :, :STATE_VIT_L])
        ci, cA = twin.transitions.matrices()
        cE = twin.emission_probs(Xc[:, :, :STATE_VIT_L])
    results = launch.run_world(state_route_rank, STATE_WORLD, SPARSE_B, SPARSE_L, STATE_PF, STATE_SEQ_L,
                               STATE_VIT_L, backend="gloo", timeout_s=WORLD_TIMEOUT_S)
    for r in results:
        check_launches(f"state route rank {r['rank']}", r["launches"], {})
        log(f"phase 13 state route rank {r['rank']} ({r['backend']}): launches none; chunked (P={STATE_PF}) "
            f"posterior + loglik {r[f'post_ms_{STATE_PF}']:.3f} ms (b={SPARSE_B}, L={SPARSE_L}); sequential "
            f"(P=1) {r['post_ms_1']:.3f} ms (L={STATE_SEQ_L}); decode {r['decode_ms']:.3f} ms (L={STATE_VIT_L})")
    report_local(f"state route world {STATE_WORLD} functions (P={STATE_PF}, L={SPARSE_L})", results)
    summary.update({f"state_w2_{k.replace(' ', '_')}_ms": v["ms"] for k, v in results[0]["local"]["records"].items()})
    got = results[0]
    checks = []
    ll_seq_err, ll_seq_ok = within(got[f"ll_{STATE_PF}"].cuda(), ll_d, 1e-4, 0.0)
    checks.append(ll_seq_ok)
    seq_gap = float((got[f"lg_{STATE_PF}"].cuda().exp() - lg_d.exp()).abs().max())
    for P, n, lg_ref, ll_ref, ref_name in ((STATE_PF, SPARSE_L, lg_c, ll_c, f"dense chunked engine (P={STATE_PF})"),
                                           (1, STATE_SEQ_L, lg_s, ll_s, "dense sequential twin")):
        bound = f32_log_bound(ll_ref, n)
        ll_err, ll_ok = within(got[f"ll_{P}"].cuda(), ll_ref, 1e-4, 0.0)
        lg_err, lg_ok = within(got[f"lg_{P}"].cuda(), lg_ref, 0.0, 2 * bound, mask=lg_ref.exp() >= 1e-3)
        checks += [ll_ok, lg_ok]
        norm = float(torch.logsumexp(lg_ref, -1).abs().max())
        log(f"phase 13 state route world {STATE_WORLD} (gloo, shared card; config 5, q=505 padded to "
            f"{-(-505 // STATE_WORLD) * STATE_WORLD}), P={P}, L={n}, vs the {ref_name}: loglik max "
            f"abs {ll_err:.3e} (rtol 1e-4), log gamma where gamma >= 1e-3 max abs {lg_err:.3e} (bound "
            f"{2 * bound:.3g}); the reference's own |logsumexp(log gamma)| max {norm:.3e}, gamma max "
            f"{float(lg_ref.exp().max()):.3e}")
    log(f"phase 13 state route P={STATE_PF} vs the dense sequential twin: loglik max abs {ll_seq_err:.3e} (rtol "
        f"1e-4), gamma max abs {seq_gap:.3e} (the chunked/sequential engine gap, not a limit)")
    score, used = path_score64(ci, cA, cE, got["path"].cuda())
    score_d, used_d = path_score64(ci, cA, cE, path_d)
    s_err, s_ok = within(score, score_d, 1e-6, 0.0)
    valid = bool((used | ~used_d).all())
    log(f"phase 13 state route decode (L={STATE_VIT_L}): valid {valid}, float64 scores vs the twin's max abs "
        f"{s_err:.3e} (rtol 1e-6); the twin's posterior + loglik {dense_ms:.3f} ms (L={SPARSE_L}, one process)")
    if not (all(checks) and s_ok and valid):
        raise AssertionError("config 5 state route disagrees with the dense twin")
    summary["state_w2_chunked_ms"] = got[f"post_ms_{STATE_PF}"]
    summary["state_w2_seq_ms"] = got["post_ms_1"]
    summary["state_w2_decode_ms"] = got["decode_ms"]
    summary["state_dense_ms"] = dense_ms
    log(f"phase 13 routes took {time.perf_counter() - t0:.1f} s")
    return summary


# ---------------------------------------------------------------------------
# Phase 13 (e): the edge-sharded sparse routes
# ---------------------------------------------------------------------------

# Config 5 under {"state": 2}: L = 10,000 cut to 2,000 for the time limit
# (each step of the route makes two collectives forward and two backward,
# ~1.4 ms each through gloo on the shared card; PERF.md §6), and to 1,000
# for the taped CE gradient (57 s a rank at 2,000: eight collectives a
# step, four of them in the autograd backward).
EDGE_WORLD, EDGE_L, EDGE_CE_L = 2, 2_000, 1_000
EDGE_TIMEOUT_S = 900  # the edge world's whole run (every collective as well)
# Each call's device busy share is profiled on its first BUSY_L positions:
# the work of a step does not depend on L, and the profiler's parse of the
# 10^5 kernels of a full-length call takes longer than the call.
BUSY_L = 200


def edge_route_world1(HMMLayer, models, make_mesh, X, single):
    """The sparse layer's state route at world 1 (NCCL, this process; one
    bucket holding every edge): posterior, log-likelihood, decode and MAP
    gradients against ``single``, the same weights on the sparse engine;
    none of K1–K9 may launch."""
    edge = seeded_layer(HMMLayer, models.GenePredTransitions(sparse_forward=True), models.GenePredEmissions(**CODONS),
                        SEED, use_prior=False, mesh=make_mesh({"state": 1}), partition={"state": "state"})
    counters = route_counters()
    outs = []
    for i, lay in enumerate((edge, single)):
        reset_kernels(counters)
        with torch.inference_mode():
            got = [lay.state_posterior_log_probs(X), lay.log_likelihood(X), lay.viterbi(X)]
        got += param_grads(lay, "map", X)[1]
        if i == 0:
            no_kernels("edge route world 1", counters)
        outs.append(got)
    bit = [torch.equal(a, b) for a, b in zip(*outs)]
    lg_err, lg_ok = within(outs[0][0], outs[1][0], 1e-6, 1e-5)
    ll_err, ll_ok = within(outs[0][1], outs[1][1], 1e-6, 0.0)
    g_err = grad_drift(outs[0][3:], outs[1][3:])
    log(f"phase 13 sparse layer state route world 1 (NCCL; edge-sharded functions; b={X.shape[1]}, L={X.shape[2]}) "
        f"vs the sparse engine: log gamma max abs {lg_err:.3e}, loglik max abs {ll_err:.3e}, paths equal "
        f"{bit[2]}, MAP gradients max abs / max {g_err:.3e} (limit 1e-5); bit-equal (posterior, loglik, decode, "
        f"gradients): {bit[:3] + [all(bit[3:])]}; launches none")
    if not (lg_ok and ll_ok and bit[2] and g_err <= 1e-5):
        raise AssertionError("the edge-sharded state route at world 1 differs from the sparse engine")


def measured_call(fn, inference=True):
    """(result, record) of one synchronised call: host-clock ms and the
    process's peak device memory during the call (absolute, and above what
    was allocated at its start)."""
    import contextlib

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.inference_mode() if inference else contextlib.nullcontext():
        out, ms = synced_ms(fn)
    peak = torch.cuda.max_memory_allocated()
    return out, {"ms": ms, "peak_mib": peak / 2**20, "above_mib": (peak - base) / 2**20}


def busy_share(fn, inference=True):
    """Device busy ms over the wall ms of one synchronised call under
    ``torch.profiler`` (device activity only), or None where the profiler
    records no device time."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.inference_mode() if inference else contextlib.nullcontext():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, ms = synced_ms(fn)
    rows = device_rows(prof)
    busy = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)) for e in rows) / 1e3
    return busy / ms if busy > 0 else None


def measure_calls(calls):
    """Each of ``calls`` (name -> (fn of a length, length, inference)) at
    its length (:func:`measured_call`), and its busy share on BUSY_L
    positions (:func:`busy_share`): (results, records)."""
    results, records = {}, {}
    for name, (fn, length, inference) in calls.items():
        results[name], records[name] = measured_call(lambda: fn(length), inference)
        records[name]["busy"] = busy_share(lambda: fn(BUSY_L), inference)
    return results, records


def call_text(name, rec):
    busy = "busy not measured" if rec["busy"] is None else f"busy {100 * rec['busy']:.1f}%"
    return (f"{name} {rec['ms']:.1f} ms, {busy}, peak {rec['peak_mib']:.1f} MiB "
            f"({rec['above_mib']:.1f} above the call's start)")


def grads_of(value, pars):
    return value.detach(), torch.autograd.grad(value, pars)


def edge_route_rank(lengths, labels, mask):
    """Rank body of the edge-sharded routes ({"state": world}): config 5's
    sparse layer (q = 505, b = 8, ``lengths["c5"]`` positions) serving a
    posterior, a log-likelihood and a decode, one MAP step's gradients and
    one taped CE gradient (``lengths["ce"]`` positions); then k = 1,000
    (q = 14,001, b = 2, ``lengths["wall"]``) through
    ``edge_sharded_log_likelihood`` and ``edge_sharded_posterior``.
    Each call timed and its busy share profiled (:func:`measure_calls`);
    none of K1–K9 may launch."""
    import torch.distributed as dist
    from hmm_layer_torch import HMMLayer, models
    from hmm_layer_torch.parallel import edge_sharded_log_likelihood, edge_sharded_posterior, make_mesh

    t0 = time.perf_counter()
    counters = route_counters()
    mesh = make_mesh({"state": dist.get_world_size()})
    device = torch.device("cuda")
    layer = build_config5(HMMLayer, models, sparse_forward=True)
    layer.mesh, layer.partition = mesh, {"state": "state"}
    X = make_inputs(SEED + 151, SPARSE_B, lengths["c5"], device)
    labels, mask = labels.to(device), mask.to(device)
    pars = [p for p in layer.parameters() if p.requires_grad]
    _, wall_init, wall_idx, wall_probs, wall_E = wall_problem(models, device, lengths["wall"])
    wall = lambda fn: lambda n: fn(wall_init, wall_idx, wall_probs, wall_E[:, :, :n], mesh)  # noqa: E731
    ingredient_grads = {}  # the MAP call's gradients of (init, edge probs, E), by length
    calls = {
        "posterior": (lambda n: layer.state_posterior_log_probs(X[:, :, :n]), lengths["c5"], True),
        "loglik": (lambda n: layer.log_likelihood(X[:, :, :n]), lengths["c5"], True),
        "decode": (lambda n: layer.viterbi(X[:, :, :n]), lengths["c5"], True),
        "map": (lambda n: with_ingredient_grads(layer, ingredient_grads.setdefault(n, {}),
                                                lambda: grads_of(layer.loss(X[:, :, :n]), pars)),
                lengths["c5"], False),
        "ce": (lambda n: grads_of(layer.posterior_cross_entropy(X[:, :, :n], labels[:, :n], label_mask=mask[:, :n]),
                                  pars), lengths["ce"], False),
        "wall_loglik": (wall(edge_sharded_log_likelihood), lengths["wall"], True),
        "wall_posterior": (wall(edge_sharded_posterior), lengths["wall"], True),
    }
    reset_kernels(counters)
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(), "setup_s": time.perf_counter() - t0}
    results, out["calls"] = measure_calls(calls)
    out["local"] = edge_local_calls(layer, X, mesh, results, ingredient_grads[lengths["c5"]],
                                    (wall_init, wall_idx, wall_probs, wall_E))
    out["launches"] = kernel_counts(counters)
    if out["rank"] == 0:
        cpu = lambda x: x.cpu() if torch.is_tensor(x) else [cpu(t) for t in x]  # noqa: E731
        out["results"] = {k: cpu(v) for k, v in results.items()}
    return out


def with_ingredient_grads(layer, store, fn):
    """``fn()`` with hooks that store the gradients of the sparse layer's
    ingredients (init, edge probabilities, and E or the rank's block of
    it, in the global and the rank-local mode alike: ``HMMLayer._inputs``)
    in ``store``."""
    original = layer._inputs

    def hooked(*args, **kwargs):
        out = original(*args, **kwargs)
        for name, t in {"init": out[0], "probs": out[1][1], "E": out[2]}.items():
            if t.requires_grad:
                t.register_hook(lambda g, name=name: store.__setitem__(name, g))
        return out

    layer._inputs = hooked
    try:
        return fn()
    finally:
        del layer._inputs


def edge_local_calls(layer, X, mesh, results, map_grads, wall):
    """Rank body part, after the global calls of :func:`edge_route_rank`:
    config 5's posterior, decode and MAP step (its loss and parameter
    gradients) through the layer under ``local=True`` — the emitter
    computes only the rank's column block of E, the edge-sharded functions
    take and return blocks — and q = 14,001's posterior through
    ``edge_sharded_posterior(local=True)`` on its block
    (:func:`measured_call`). Bit-equal to the global calls, as the
    functions' local mode is given the same E block: the posteriors' log
    gamma blocks (and q = 14,001's loglik), the decode's rows, the MAP
    loss and the MAP step's gradients of init, the edge probabilities and
    the E block (hooked in both modes, ``map_grads`` the global call's).
    The MAP step's parameter gradients go back to the parent, which holds
    them to the float32 bound: the backward sums over the multi-copy
    codon columns (``repeat_interleave``'s backward is an ``index_add_``,
    which CUDA runs with atomic adds) and over the ranks' shares have no
    fixed order. Then the layer's posterior and MAP step global and local
    in turns (global, local, local, global) on BUSY_L positions: the local
    over global time ratio, paired (single calls through gloo vary by tens
    of percent between machines)."""
    from hmm_layer_torch.parallel import edge_sharded_posterior, local_ranges

    pars = [p for p in layer.parameters() if p.requires_grad]
    r = layer.local_ranges((*X.shape[:3], layer.transitions.num_states))
    recs, errs, equal = {}, {}, {}
    lg_l, recs["posterior"] = measured_call(lambda: layer.state_posterior_log_probs(X, local=True))
    errs["posterior"] = block_error(lg_l, results["posterior"][r.index])
    equal["posterior"] = errs["posterior"]["bit_equal"]
    del lg_l
    path_l, recs["decode"] = measured_call(lambda: layer.viterbi(X, local=True))
    equal["decode"] = torch.equal(path_l, results["decode"][:, slice(*r.rows)])
    local_grads = {}
    (loss_l, g_l), recs["map"] = measured_call(
        lambda: with_ingredient_grads(layer, local_grads,
                                      lambda: grads_of(layer.loss(X, local=True), pars)), inference=False)
    equal["map loss"] = torch.equal(loss_l, results["map"][0])
    equal["map gradients of init, edge probs, E"] = (
        torch.equal(local_grads["init"], map_grads["init"]) and torch.equal(local_grads["probs"], map_grads["probs"])
        and torch.equal(local_grads["E"], map_grads["E"][r.index]))
    del local_grads
    w_init, w_idx, w_probs, w_E = wall
    rw = local_ranges(mesh, "edge", w_E.shape)
    wE_l = w_E[rw.index].contiguous()
    (wlg_l, wll_l), recs["wall_posterior"] = measured_call(
        lambda: edge_sharded_posterior(w_init, w_idx, w_probs, wE_l, mesh, local=True))
    wlg, wll = results["wall_posterior"]
    errs["wall_posterior"] = block_error(wlg_l, wlg[rw.index])
    equal["wall_posterior"] = errs["wall_posterior"]["bit_equal"] and torch.equal(wll_l, wll)
    del wlg_l, wll_l

    n = BUSY_L
    short = X[:, :, :n]
    pairs = {  # name: (global call, local call, inference)
        "posterior": (lambda: layer.state_posterior_log_probs(short),
                      lambda: layer.state_posterior_log_probs(short, local=True), True),
        "map": (lambda: grads_of(layer.loss(short), pars), lambda: grads_of(layer.loss(short, local=True), pars),
                False),
    }
    paired = {}
    for name, (glob, loc, inference) in pairs.items():
        ms = {"global": [], "local": []}
        with torch.inference_mode(inference):
            for which in ("global", "local", "local", "global"):
                ms[which].append(synced_ms(glob if which == "global" else loc)[1])
        paired[name] = {k: sum(v) / 2 for k, v in ms.items()}
    return {"records": recs, "errors": errs, "equal": equal, "ranges": tuple(r), "wall_ranges": tuple(rw),
            "paired": paired, "decode": path_l.cpu(), "map": (loss_l.cpu(), [g.cpu() for g in g_l])}


def sparse_truth(layer, X, objective64):
    """A sparse layer's objective and parameter gradients anchored in
    float64: ``objective64(init, indices, probs, E)`` of the single-device
    engine in float64 on the layer's own ingredients (training-mode
    emissions), its gradients pulled back through the layer's float32
    Jacobian (:func:`pull_back`), plus the auxiliary loss."""
    pars = [p for p in layer.parameters() if p.requires_grad]
    init, (indices, probs), E, _, _ = layer._inputs(X, training=True)
    xs = [t.detach().double().requires_grad_() for t in (init, probs, E)]
    value = objective64(xs[0], indices, xs[1], xs[2])
    aux, grads = pull_back(layer, pars, [init, probs, E], torch.autograd.grad(value, xs))
    return float(value.detach()) + aux, grads


def edge_routes_phase(HMMLayer, models, make, smi):
    """Phase 13 (e): config 5's sparse layer under {"state": 2} at world 2
    on the shared card (gloo, spawned ranks), and q = 14,001 through the
    edge-sharded functions, each against the single-device sparse engine on
    the card."""
    from hmm_layer_torch.ops import sparse as sparse_ops
    from hmm_layer_torch.parallel import launch

    t0 = time.perf_counter()
    counters = route_counters()
    single = build_config5(HMMLayer, models, sparse_forward=True)
    X = make(SEED + 151, SPARSE_B, EDGE_L)
    pars = [p for p in single.parameters() if p.requires_grad]
    with torch.inference_mode():
        path0 = single.viterbi(X)
    labels = path0[0].long()
    mask = torch.ones(labels.shape, device=labels.device)
    mask[::4, -EDGE_L // 4:] = 0.0

    def taped_ce(i, idx, p, e):
        n = e.shape[2]
        return masked_ce(sparse_ops.sparse_posterior(i, idx, p, e, analytic_vjp=False)[0], labels[:, :n], mask[:, :n])

    def taped_ce_layer(n):
        init, (idx, probs), E, _, _ = single._inputs(X[:, :, :n], training=True)
        return grads_of(taped_ce(init, idx, probs, E) + single.aux_loss(), pars)

    _, w_init, w_idx, w_probs, w_E = wall_problem(models, X.device, WALL_L)
    ref_calls = {
        "posterior": (lambda n: single.state_posterior_log_probs(X[:, :, :n]), EDGE_L, True),
        "loglik": (lambda n: single.log_likelihood(X[:, :, :n]), EDGE_L, True),
        "decode": (lambda n: single.viterbi(X[:, :, :n]), EDGE_L, True),
        "map": (lambda n: grads_of(single.loss(X[:, :, :n]), pars), EDGE_L, False),
        "ce": (taped_ce_layer, EDGE_CE_L, False),
        "wall_loglik": (lambda n: sparse_ops.sparse_log_likelihood(w_init, w_idx, w_probs, w_E[:, :, :n]), WALL_L,
                        True),
        "wall_posterior": (lambda n: sparse_ops.sparse_posterior(w_init, w_idx, w_probs, w_E[:, :, :n]), WALL_L,
                           True),
    }
    reset_kernels(counters)
    ref, ref_rec = measure_calls(ref_calls)
    no_kernels("the single-device sparse references", counters)
    t1 = time.perf_counter()
    truth = {"map": sparse_truth(single, X, lambda *a: -sparse_ops.sparse_log_likelihood(*a).mean()),
             "ce": sparse_truth(single, X[:, :, :EDGE_CE_L], taped_ce)}
    log(f"phase 13 edge routes: single-device references {t1 - t0:.1f} s, float64 anchors "
        f"{time.perf_counter() - t1:.1f} s")
    del w_E
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    lengths = {"c5": EDGE_L, "ce": EDGE_CE_L, "wall": WALL_L}
    results = launch.run_world(edge_route_rank, EDGE_WORLD, lengths, labels.cpu(), mask.cpu(), backend="gloo",
                               timeout_s=EDGE_TIMEOUT_S)
    log(f"phase 13 edge world of {EDGE_WORLD} ranks: {time.perf_counter() - t1:.1f} s")
    for r in results:
        check_launches(f"edge route rank {r['rank']}", r["launches"], {})
        log(f"phase 13 edge route rank {r['rank']} ({r['backend']}, world {EDGE_WORLD} on the shared card; "
            f"launches none; set-up {r['setup_s']:.1f} s): "
            + "; ".join(call_text(k, v) for k, v in r["calls"].items()))
    log(f"phase 13 single-device sparse engine on the card (the references; launches none; busy shares on "
        f"{BUSY_L} positions): "
        + "; ".join(call_text(k, v) for k, v in ref_rec.items()))
    got = {k: v for k, v in results[0]["results"].items()}
    dev = X.device
    checks = {}

    # Config 5: log-likelihood, log gamma, decode.
    lg, ll = got["posterior"].to(dev), got["loglik"].to(dev)
    bound = f32_log_bound(ref["loglik"], EDGE_L)
    ll_err, checks["c5 loglik"] = within(ll, ref["loglik"], 0.0, bound)
    lg_err, checks["c5 log gamma"] = within(lg, ref["posterior"], 0.0, 2 * bound, mask=ref["posterior"].exp() >= 1e-3)
    init, A = edge_support(single)
    with torch.inference_mode():
        E = single.emission_probs(X)
    path = got["decode"].to(dev)
    score, used = path_score64(init, A, E, path)
    score_ref, used_ref = path_score64(init, A, E, ref["decode"])
    s_err, s_ok = within(score, score_ref, 1e-6, 0.0)
    checks["c5 decode"] = s_ok and bool(used.all())
    for r in results:  # the layer's local decode: every rank holds its rows' paths, here every row
        path_l = r["local"]["decode"].to(dev)
        score_l, used_l = path_score64(init, A, E, path_l)
        err, ok = within(score_l, score_ref, 1e-6, 0.0)
        checks[f"rank {r['rank']} local decode"] = ok and bool(used_l.all())
        log(f"phase 13 edge route rank {r['rank']} layer decode local=True: valid {bool(used_l.all())}, float64 "
            f"scores max abs {err:.3e} (rtol 1e-6), paths equal to the global call's at "
            f"{100 * float((path_l == path).float().mean()):.3f}%")
    same = float((path == ref["decode"]).float().mean())
    q = single.transitions.num_states
    log(f"phase 13 edge route config 5 (q={q} padded to {-(-q // EDGE_WORLD) * EDGE_WORLD}, "
        f"{single.transitions.num_transitions} edges, b={SPARSE_B}, L={EDGE_L}, world {EDGE_WORLD}) vs the sparse "
        f"engine: loglik max abs {ll_err:.3e} "
        f"(bound {bound:.3g}), log gamma where gamma >= 1e-3 max abs {lg_err:.3e} (bound {2 * bound:.3g}); decode "
        f"valid {bool(used.all())}, float64 scores max abs {s_err:.3e} (rtol 1e-6), paths equal at {100 * same:.3f}%")

    # Config 5: MAP and taped CE gradients, each anchored in float64.
    for name, what in (("map", f"MAP step (analytic Baum-Welch VJP; L={EDGE_L})"),
                       ("ce", f"CE gradient (taped; L={EDGE_CE_L})")):
        (val, grads), (ref_val, ref_grads), (val64, grads64) = got[name], ref[name], truth[name]
        d_route, d_single = grad_drift(grads, grads64), grad_drift(ref_grads, grads64)
        loss_err = abs(float(val) - float(ref_val))
        apart = grad_drift(grads, ref_grads)
        checks[f"c5 {name}"] = d_route <= F32_NOISE_FACTOR * d_single and loss_err <= 2 * bound
        log(f"phase 13 edge route config 5 {what}: loss {float(val):.6f}, sparse engine {float(ref_val):.6f} (abs "
            f"diff {loss_err:.3e}, bound {2 * bound:.3g}), float64 {val64:.6f}; gradients max abs / max against "
            f"the float64 anchor {d_route:.3e}, the sparse engine's {d_single:.3e} (limit {F32_NOISE_FACTOR:g}x); "
            f"route vs sparse engine {apart:.3e}")
        if name == "map":
            for r in results:  # the layer's MAP step under local=True, held as the global one
                val_l, grads_l = r["local"]["map"]
                d_local, loss_l_err = grad_drift(grads_l, grads64), abs(float(val_l) - float(ref_val))
                checks[f"rank {r['rank']} local map"] = d_local <= F32_NOISE_FACTOR * d_single and loss_l_err <= 2 * bound
                log(f"phase 13 edge route rank {r['rank']} layer MAP step local=True: loss {float(val_l):.6f} (abs "
                    f"diff to the engine {loss_l_err:.3e}, to the global call {abs(float(val_l) - float(val)):.3e}; "
                    f"bound {2 * bound:.3g}); gradients max abs / max against the float64 anchor {d_local:.3e} "
                    f"(limit {F32_NOISE_FACTOR:g}x the engine's), against the global call's "
                    f"{grad_drift(grads_l, grads):.3e} (bit-equal "
                    f"{all(torch.equal(a, b) for a, b in zip(grads_l, grads))})")

    # q = 14,001: log-likelihood and posterior.
    wll, (wlg, wll2) = got["wall_loglik"].to(dev), [t.to(dev) for t in got["wall_posterior"]]
    rlg, rll = ref["wall_posterior"]
    wbound = f32_log_bound(ref["wall_loglik"], WALL_L)
    w_ll_err, checks["wall loglik"] = within(wll, ref["wall_loglik"], 0.0, wbound)
    w_ll2_err, checks["wall posterior loglik"] = within(wll2, rll, 0.0, wbound)
    w_lg_err, checks["wall log gamma"] = within(wlg, rlg, 0.0, 2 * wbound, mask=rlg.exp() >= 1e-3)
    log(f"phase 13 edge route past the dense wall (k={WALL_K}: q={w_init.shape[-1]} padded to "
        f"{-(-w_init.shape[-1] // EDGE_WORLD) * EDGE_WORLD}, {len(w_idx)} edges, b={WALL_B}, L={WALL_L}, world "
        f"{EDGE_WORLD}) vs sparse_log_likelihood / sparse_posterior: loglik max abs {w_ll_err:.3e} and {w_ll2_err:.3e} "
        f"(bound {wbound:.3g}), log gamma where gamma >= 1e-3 max abs {w_lg_err:.3e} (bound {2 * wbound:.3g})")
    checks.update(edge_local_report(results, ref_rec))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"edge-sharded routes disagree with the sparse engine: {failed}")
    log(f"phase 13 edge routes took {time.perf_counter() - t0:.1f} s (on {smi})")
    summary = {f"edge_w{EDGE_WORLD}_{k}_ms": v["ms"] for k, v in results[0]["calls"].items()}
    summary.update({f"edge_w{EDGE_WORLD}_local_{k}_ms": v["ms"] for k, v in results[0]["local"]["records"].items()})
    summary.update({f"edge_single_{k}_ms": v["ms"] for k, v in ref_rec.items()})
    return summary


def edge_local_report(results, ref_rec):
    """Per rank, each local call beside the rank's global call and the
    single-device engine's (ms, peak memory above the call's start), and
    the paired local/global times; the checks: the local results
    bit-equal to the global ones (:func:`edge_local_calls`), the config-5
    and q = 14,001 posteriors' local peaks below the engine's, and the
    local MAP step's peak below the layer's global one."""
    checks = {}
    for r in results:
        loc = r["local"]
        parts = []
        for name, rec in loc["records"].items():
            glob, eng = r["calls"][name], ref_rec[name]
            parts.append(f"{name} local {rec['ms']:.1f} ms / {rec['above_mib']:.1f} MiB, global "
                         f"{glob['ms']:.1f} / {glob['above_mib']:.1f}, engine {eng['ms']:.1f} / "
                         f"{eng['above_mib']:.1f} (local peak {rec['above_mib'] / eng['above_mib']:.3f}x the "
                         f"engine's, {rec['above_mib'] / glob['above_mib']:.3f}x global's; ms "
                         f"{rec['ms'] / glob['ms']:.3f}x global's)")
        errs = "; ".join(f"{k} log gamma max abs {e['max_abs']:.3e}" for k, e in loc["errors"].items())
        log(f"phase 13 edge route rank {r['rank']}, local=True on its state block {loc['ranges'][2]} (config 5 "
            f"through the layer; q = 14,001: the function, {loc['wall_ranges'][2]}), ms / peak MiB above the call's "
            f"start: " + "; ".join(parts) + f"; local against the global blocks: {errs}; bit-equal {loc['equal']}")
        log(f"phase 13 edge route rank {r['rank']}, the layer's global and local calls in turns (global, local, "
            f"local, global) on {BUSY_L} positions, mean ms: " + "; ".join(
                f"{name} global {p['global']:.1f}, local {p['local']:.1f} ({p['local'] / p['global']:.3f}x)"
                for name, p in loc["paired"].items()))
        for key, ok in loc["equal"].items():
            checks[f"rank {r['rank']} local {key} equal"] = ok
        for name in ("posterior", "wall_posterior"):
            checks[f"rank {r['rank']} local {name} peak below the engine's"] = (
                loc["records"][name]["above_mib"] < ref_rec[name]["above_mib"])
        checks[f"rank {r['rank']} local map peak below the global one"] = (
            loc["records"]["map"]["above_mib"] < r["calls"]["map"]["above_mib"])
    return checks


def native_reader_phase(fasta, npz, tmp, smi):
    """Phase 13 (d): predict's split between reading the FASTA and the
    rest, native reader against the Python one in paired runs (native,
    Python, Python, native), with equal records; then a simulated contig
    through predict, scored against its planted genes."""
    from hmm_layer_torch import cli, data
    from hmm_layer_torch.models import evaluate_annotation, read_gff3, simulate_genome

    def read_all(native):
        data._use_native_io = native
        try:
            return [(n, e.tobytes()) for n, e in data.read_fasta_encoded(fasta)]
        finally:
            data._use_native_io = True

    if read_all(True) != read_all(False):
        raise AssertionError("native and Python readers disagree")

    reader = data.read_fasta_encoded
    spent = []

    def timed_reader(*args, **kwargs):
        gen = reader(*args, **kwargs)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(gen)
            except StopIteration:
                spent.append(time.perf_counter() - t0)
                return
            spent.append(time.perf_counter() - t0)
            yield item

    argv = ["predict", "-i", fasta, "-o", f"{tmp}/native.gff3", "--class-probs", npz, "--params",
            f"{tmp}/params.npz", "--window", str(L), "--batch", str(B), "--parallel-factor", str(PF),
            "--both-strands"]
    runs = {True: [], False: []}
    data.read_fasta_encoded = timed_reader
    try:
        for native in (None, True, False, False, True):  # a warm-up run first, not counted
            data._use_native_io = native is not False
            spent.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if cli.main(argv) != 0:
                raise AssertionError("predict returned non-zero")
            torch.cuda.synchronize()
            if native is not None:
                runs[native].append((time.perf_counter() - t0, sum(spent)))
    finally:
        data.read_fasta_encoded = reader
        data._use_native_io = True
    bp = sum(PREDICT_CONTIGS)
    out = {}
    for native, name in ((True, "native"), (False, "python")):
        wall = statistics.mean(w for w, _ in runs[native])
        read = statistics.mean(r for _, r in runs[native])
        out[f"{name}_read_s"], out[f"{name}_wall_s"] = read, wall
        log(f"phase 13 predict with the {name} reader: {[(round(w, 4), round(r, 4)) for w, r in runs[native]]} "
            f"(wall s, reading s) -> reading {read:.4f} s of {wall:.4f} s ({100 * read / wall:.2f}%), "
            f"the rest {wall - read:.4f} s; {bp / wall:,.0f} bp/s")
    log(f"phase 13 native reader: records equal to the Python reader's; predict {out['python_wall_s'] / out['native_wall_s']:.3f}x "
        f"faster end to end, reading {out['python_read_s'] / out['native_read_s']:.1f}x faster, on {smi}")

    sim = simulate_genome(np.random.default_rng(SEED + 131), num_genes=SIM_GENES)
    sim_fa, sim_npz, sim_gff = f"{tmp}/sim.fa", f"{tmp}/sim.npz", f"{tmp}/sim.gff3"
    with open(sim_fa, "w") as fh:
        fh.write(">sim\n" + "".join(sim.seq[i : i + 80] + "\n" for i in range(0, sim.length, 80)))
    np.savez(sim_npz, sim=sim.class_probs, sim__rc=sim.class_probs_rc)
    if cli.main(["predict", "-i", sim_fa, "-o", sim_gff, "--class-probs", sim_npz, "--window", str(L),
                 "--batch", str(B), "--parallel-factor", str(PF), "--both-strands"]) != 0:
        raise AssertionError("predict on the simulated contig returned non-zero")
    scores = evaluate_annotation(read_gff3(sim_gff), {"sim": sim.genes})
    f1 = {level: round(scores[level]["f1"], 4) for level in ("nucleotide", "exon", "gene")}
    log(f"phase 13 simulate_genome contig ({sim.length} bp, {len(sim.genes)} planted genes on both strands) "
        f"through predict (the initial 15-class layer): F1 {f1} (nucleotide limit 0.85)")
    if f1["nucleotide"] < 0.85:
        raise AssertionError("predict's annotation of the simulated contig is below its limit")
    return out


# ---------------------------------------------------------------------------
# 14. The port's examples
# ---------------------------------------------------------------------------

# Each example at its default size on the card (the mesh ones at world 2:
# NCCL takes one card a rank, so on one card they run gloo), and a line of
# its output that shows it ran through.
EXAMPLES = {
    "torch_gene_prediction.py": ([], "synthetic: L=4096"),
    "torch_train_profile_msa.py": ([], "done."),
    "torch_distributed_training.py": ([], "sharded steps"),
    "torch_train_sparse_multichip.py": ([], "equal to the layer route's: True"),
    "torch_train_dirichlet_priors.py": (["--out", "{tmp}"], "saved"),
}
EXAMPLE_TIMEOUT_S = 600


def examples_phase(smi):
    """Phase 14: the five ``examples/torch_*.py`` as a user runs them
    (``python3 examples/<name>``, no ``--cpu``), started together; each
    must exit 0 and print its line. The Dirichlet one writes to a
    temporary directory."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1")  # nine processes share the host's cores
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, (args, _) in EXAMPLES.items():
            cmd = [sys.executable, os.path.join(root, "examples", name), *(a.format(tmp=tmp) for a in args)]
            procs[name] = (subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), time.perf_counter())
        failed = []
        for name, (proc, start) in procs.items():
            try:
                text, _ = proc.communicate(timeout=max(EXAMPLE_TIMEOUT_S - (time.perf_counter() - t0), 1))
            except subprocess.TimeoutExpired:
                proc.kill()
                text, _ = proc.communicate()
            lines = text.strip().splitlines()
            ok = proc.returncode == 0 and any(EXAMPLES[name][1] in line for line in lines)
            log(f"phase 14 examples/{name}: exit {proc.returncode} after {time.perf_counter() - start:.1f} s "
                f"(started with the others); last lines: {' | '.join(lines[-3:])}")
            if not ok:
                failed.append(name)
    log(f"phase 14 the five examples ran together in {time.perf_counter() - t0:.1f} s on {smi}")
    if failed:
        raise AssertionError(f"examples failed: {failed}")


def device_and_build(_cuda_build):
    """Phases 1 and 2: the card and its peaks, then every kernel built
    (one nvcc per source, all started together). Returns (kind, smi,
    peak_bytes, peak_flops)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    part, (peak_bytes, peak_flops) = peaks_for(kind)
    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls must run in full precision (no TF32)")
    log(f"phase 1 device: {kind} ({smi}); torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"peaks ({part} data sheet) {peak_bytes / 1e12:.2f} TB/s, {peak_flops / 1e12:.0f} TFLOP/s fp32; "
        f"float32 matmul precision highest, TF32 off")

    t0 = time.perf_counter()
    built = _cuda_build.build_all()
    for name in built:
        _cuda_build.load(name)
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(path.name for path in built.values())})")
    return kind, smi, peak_bytes, peak_flops


def develop_phase12():
    """Phases 1, 2 and phase 12's K2c/K3c checks alone, for development on
    the card: ``python3 -c "import chip_smoke; chip_smoke.develop_phase12()"``.
    Prints the phase's lines, not the kernel record: only ``main`` does."""
    from hmm_layer_torch import HMMLayer, models
    from hmm_layer_torch.ops import _cuda_build, cuda_forward

    _, _, peak_bytes, peak_flops = device_and_build(_cuda_build)
    make = lambda seed, b, length: make_inputs(seed, b, length, torch.device("cuda"))  # noqa: E731
    wide_sum_kernel_phase(HMMLayer, models, make, cuda_forward, peak_bytes, peak_flops)


def develop_phase13():
    """Phases 1, 2, 7, 13 and 14 alone, for development on the card:
    ``python3 -c "import chip_smoke; chip_smoke.develop_phase13()"``. It
    checks no kernel against its plain version and prints neither the
    kernel record nor the result line: only ``main`` does."""
    from hmm_layer_torch import HMMLayer, models
    from hmm_layer_torch.ops import _cuda_build, cuda_viterbi, recursion

    _, smi, _, _ = device_and_build(_cuda_build)
    make = lambda seed, b, length: make_inputs(seed, b, length, torch.device("cuda"))  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        fasta, npz, _ = predict_phase(build_layer(HMMLayer, models), recursion, cuda_viterbi, tmp)
        native_reader_phase(fasta, npz, tmp, smi)
    routes_phase(HMMLayer, models, make, smi)
    edge_routes_phase(HMMLayer, models, make, smi)
    examples_phase(smi)
    log("phase 13 development run passed (phases 1, 2, 7, 13 and 14 only; not a smoke result)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA device",
              file=sys.stderr)
        return 1
    try:
        from hmm_layer_torch import HMMLayer, models
        from hmm_layer_torch.ops import (
            _cuda_build,
            cuda_adjoint,
            cuda_forward,
            cuda_mxu,
            cuda_viterbi,
            recursion,
        )
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 1

    # 1. Device; 2. Build
    kind, smi, peak_bytes, peak_flops = device_and_build(_cuda_build)

    device = torch.device("cuda")
    make = lambda seed, b, length: make_inputs(seed, b, length, device)  # noqa: E731
    layer = build_layer(HMMLayer, models)
    X = make(SEED, B, L)

    # 3. Kernels against their plain versions
    records, P = kernel_phase(layer, X, recursion, cuda_forward, peak_bytes, peak_flops)
    records.update(viterbi_kernel_phase(layer, X, recursion, cuda_viterbi, peak_bytes, peak_flops))
    labels, mask = ce_targets(layer, X)
    records.update(adjoint_kernel_phase(layer, X, labels, mask, recursion, cuda_adjoint,
                                        peak_bytes, peak_flops))

    # 4. End to end
    launches, request_ms, post_ms, post_all = e2e_phase(layer, recursion, cuda_forward, make)
    log(f"phase 4 e2e: request (posterior + loglik) {request_ms:.3f} ms median; posterior "
        f"{post_ms:.3f} ms/batch median of {len(post_all)} [{min(post_all):.3f}, {max(post_all):.3f}], "
        f"{B / (post_ms / 1e3):.1f} seqs/sec (b={B}, L={L}, P={P}) on {smi}")

    # 5. Where the time goes
    stage_phase(layer, X, recursion, cuda_forward)

    # 6. Decode
    decode_launches, decode_ms = decode_phase(layer, recursion, cuda_viterbi, make)
    med = statistics.median(decode_ms)
    log(f"phase 6 decode: {med:.3f} ms/batch median of {len(decode_ms)} [{min(decode_ms):.3f}, "
        f"{max(decode_ms):.3f}], {B / (med / 1e3):.1f} seqs/sec (b={B}, L={L}, P={P}) on {smi}")
    decode_stage_phase(layer, X, recursion, cuda_viterbi)

    tmpdir = tempfile.TemporaryDirectory()  # phase 7's files, read again in phases 8 and 13
    tmp = tmpdir.name
    # 7. Predict
    fasta, npz, gff = predict_phase(layer, recursion, cuda_viterbi, tmp)

    # 8. Training
    t0 = time.perf_counter()
    train_launches, Xt, labels, mask = training_phase(
        layer, make, recursion, cuda_forward, cuda_adjoint, smi)
    gradient_checks(layer, Xt, labels, mask, make, recursion)
    backward_stage_split(layer, Xt, labels, mask, recursion)
    trainer_step = torch.optim.Adam([p for p in layer.parameters() if p.requires_grad], lr=1e-2)

    def ce_step():
        trainer_step.zero_grad()
        layer.posterior_cross_entropy(Xt, labels, label_mask=mask).backward()
        trainer_step.step()

    profile_request("phase 8", ce_step, "K1-K5",
                    ("outputs_kernel", "chunk_summaries_rows_kernel", "affine_"), inference=False)
    train_cli_phase(fasta, npz, gff, cuda_forward, cuda_adjoint, tmp)
    log(f"phase 8 took {time.perf_counter() - t0:.1f} s")

    # 9. Multi-copy gene prediction: k = 2 (q = 29) serving; k = 4 and 9
    # for the kernels' other shapes
    t0 = time.perf_counter()
    mc = {k: build_multicopy_layer(HMMLayer, models, k) for k in (MC_K, 4, 9)}
    sm_mhz = int(float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]))
    records.update(blocked_kernel_phase({MC_K: mc[MC_K], 4: mc[4]}, make, cuda_viterbi,
                                        peak_bytes, peak_flops, sm_mhz))
    records.update(mxu_kernel_phase(mc, make, recursion, cuda_mxu, peak_bytes, peak_flops))
    mc_decode_launches, mc_decode_ms = multicopy_decode_phase(mc[MC_K], make, recursion, cuda_viterbi)
    wide_records, wide_launches = wide_kernel_phase(HMMLayer, models, make, recursion, cuda_viterbi,
                                                    peak_bytes, peak_flops)
    records.update(wide_records)
    med = statistics.median(mc_decode_ms)
    log(f"phase 9 decode (q={1 + 14 * MC_K}): {med:.3f} ms/batch median of {len(mc_decode_ms)} "
        f"[{min(mc_decode_ms):.3f}, {max(mc_decode_ms):.3f}], {B / (med / 1e3):.1f} seqs/sec "
        f"(b={B}, L={L}, sequential decode through K7b + K8b) on {smi}")
    X_mc = make(SEED + 59, B, L)
    # K7b's kernel and K8b's three (tiles, borders, fill)
    profile_request("phase 9", lambda: mc[MC_K].viterbi(X_mc), "K7b-K8b",
                    ("deltas_blocked_kernel", "backtrace_blocked_"))
    mc_ll_launches, off_ms, on_ms = multicopy_loglik_phase(mc[MC_K], make, recursion, cuda_mxu, cuda_forward)
    P_mc = recursion.recommended_parallel_factor(L, 1 + 14 * MC_K, 1)
    log(f"phase 9 loglik (q={1 + 14 * MC_K}, b={B}, L={L}, P={P_mc}): gate off (plain summaries) "
        f"{statistics.median(off_ms):.3f} ms/batch median of {len(off_ms)} [{min(off_ms):.3f}, "
        f"{max(off_ms):.3f}]; gate on (K9) {statistics.median(on_ms):.3f} ms/batch median of "
        f"{len(on_ms)} [{min(on_ms):.3f}, {max(on_ms):.3f}] on {smi}")
    log(f"phase 9 took {time.perf_counter() - t0:.1f} s")

    # 10. Options and auxiliary inference
    options_phase(HMMLayer, models, make, recursion, (cuda_forward, cuda_adjoint, cuda_mxu), smi)

    # 11. The sparse edge-list engine
    counters = (cuda_forward, cuda_adjoint, cuda_viterbi, cuda_mxu)
    sparse_phase(HMMLayer, models, make, recursion, counters, smi)

    # 12. The profile-HMM family and align
    sum_records, sum_launches = wide_sum_kernel_phase(HMMLayer, models, make, cuda_forward, peak_bytes,
                                                      peak_flops)
    records.update(sum_records)
    profile_phase(HMMLayer, models, recursion, cuda_viterbi, counters, smi)

    # 13. The host side and the multi-device routes
    t0 = time.perf_counter()
    del layer, mc
    torch.cuda.empty_cache()
    times = native_reader_phase(fasta, npz, tmp, smi)
    tmpdir.cleanup()
    times.update(routes_phase(HMMLayer, models, make, smi))
    times.update(edge_routes_phase(HMMLayer, models, make, smi))
    log(f"phase 13 summary on {smi}: " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in times.items()))
    log(f"phase 13 took {time.perf_counter() - t0:.1f} s")

    # 14. The port's examples
    examples_phase(smi)

    launches.update({k: v for k, v in decode_launches.items() if k in DECODE_Q16})
    launches.update({k: train_launches[k] for k in cuda_adjoint.LAUNCHES})
    launches.update({k: mc_decode_launches[k] for k in BLOCKED_KEYS})
    launches.update({k: wide_launches[k] for k in WIDE_KEYS})
    launches.update({k: sum_launches[k] for k in SUM_WIDE_KEYS})
    launches["sum_chunk_summaries_mxu"] = mc_ll_launches["sum_chunk_summaries_mxu"]
    for name, rec in records.items():
        rec["launches"] = launches[name]
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
