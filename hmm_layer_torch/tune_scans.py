"""Tilings of the chunk scans K1–K8, the blocked decode K7b, K8b and the
16 < q <= 128 chunk summaries K9 on the card.

Run from the root of the repository on a machine with a CUDA device:
``python3 -m hmm_layer_torch.tune_scans [--kernels K9] [--compare DIR
...] [--compare-only] [--e2e] [--out DIR]``.

K1, K2, K3 (``csrc/sum_product.cu``), K4, K5 (``csrc/affine.cu``), K6, K7
and K8 (``csrc/max_plus.cu``) are built once per tiling: G chunk elements a
block, TS steps a staged tile, NB tiles in the ring and the step loop
unrolled U times, under the prefixes ``SUM_`` (K1), ``FWD_`` (K2), ``BWD_``
(K3), ``COMP_`` (K4), ``OUT_`` (K5), ``MPS_`` (K6), ``DELTA_`` (K7) and
``TRACE_`` (K8), e.g. ``-DBWD_TS=32``. K7b (``DBLK_``) has S threads per
state and TS steps a staged tile, K8b (``TBLK_``) T steps a backpointer
tile and G row groups a tiles block. K9 (``csrc/mxu.cu``, ``MXU_``) has a
TM x TN tile of the product a thread, TS steps a ring slot and G elements
a block at q <= 32. The package's own build uses the defaults in the
sources.
Tilings whose block exceeds 227 KB of shared memory (K9: at any padded
width) or 1,024 threads are left out.
``--kernels`` limits the sweep to some of the kernels. The ``nvcc``
processes run side by side, two for each CPU core, with ``-Xptxas -v``.
Each ``--compare DIR`` adds the four sources of another commit
(``DIR/sum_product.cu``, ``DIR/affine.cu``, ``DIR/max_plus.cu``,
``DIR/mxu.cu``) as variants of all eleven kernels, so that old and new
kernels are timed in the same process on the same card;
``--compare-only`` leaves the tilings out. Each variant runs at the
flagship shapes on seeded random inputs (m=1, c=303, q=15, R=1056, P=33;
K4, K5: 2m=2, the posterior VJP's stacked models; K7b, K8b: the
sequential decode's b=32, L=9999 at q=29 and q=57; K9: L=9999, P=33, so
c=303, at q=29 with b=32 and at q=127 with b=4), is held against the
plain version (K1 rtol 1e-5, atol 1e-3 where C lies within 30 nats of its
row's maximum; K2, K3 rtol 1e-5, atol 1e-2; K4, K5 rtol 1e-5, atol 1e-6;
K6, K7, K8, K7b, K8b bit-equal; K9, whose sums run in another order, rtol
= atol = 2e-4 where C lies within 30 nats of its row's maximum) and
against the package's own build (bit-equal or not), and is timed:

* warm: median of 20 samples of 10 back-to-back launches (CUDA events),
  the inputs then sit in the 50 MB L2;
* cold: 256 MB written to a scratch buffer before each single launch, CUDA
  events around that launch, median of 20.

With ``--e2e`` (and one ``--compare DIR``), the flagship gene-prediction
layer (q=15, b=32, L=9999, parallel factor "auto" = 33, random weights from
seed 0) then serves posterior, log-likelihood and Viterbi decode requests
and takes posterior cross-entropy and MAP steps (forward and backward, no
optimizer) with this build's kernels and with DIR's in turns: 40 rounds,
this build first and DIR first alternately (the libraries are loaded side by side and
swapped under the wrappers). The multi-copy layer of ``chip_smoke.py``
phase 9 (k=2, q=29, the same seed) serves decode requests (K7b and K8b),
log-likelihood requests and takes MAP steps in the same rounds, the last
two with the K9 gate (``cuda_mxu.MXU_KERNELS``) on around each call and
restored after it. Each call is timed with the host clock around a
synchronised call; the medians and the median paired difference are
printed. Then ``torch.profiler`` traces 3 gated q=29 log-likelihood
requests with each build, in turns, and the median device busy time and
K9 time of each build are printed.

It prints ptxas's registers and spills of each kernel, the longest run of
back-to-back ``SHFL`` instructions in each default kernel's SASS
(``cuobjdump``; the SASS is written to ``--out``), one line per variant and
kernel, the fastest variant of each kernel by cold time, and the card's
name and power limit. It exits non-zero without a card, or after the last
variant if any variant's launch failed or disagreed with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .ops import _cuda_build, cuda_adjoint, cuda_forward, cuda_mxu, cuda_viterbi
from .utils.cuda_timing import cold_median_ms, median_ms

CODONS = dict(
    start_codons=[("ATG", 1.0)],
    stop_codons=[("TAG", 0.34), ("TAA", 0.33), ("TGA", 0.33)],
    intron_begin_pattern=[("NGT", 0.99), ("NGC", 0.005), ("NAT", 0.005)],
    intron_end_pattern=[("AGN", 0.99), ("ACN", 0.01)],
)
# Each kernel: its source, its -D prefix, its C entry point and the kernel
# symbol ptxas and cuobjdump report.
KERNELS = {
    "K1": ("sum_product", "SUM", "hmm_sum_chunk_summaries", "chunk_summaries_rows_kernel"),
    "K2": ("sum_product", "FWD", "hmm_sum_fwd_outputs", "fwd_outputs_kernel"),
    "K3": ("sum_product", "BWD", "hmm_beta_bwd_outputs", "bwd_outputs_kernel"),
    "K4": ("affine", "COMP", "hmm_affine_chunk_composites", "affine_composites_kernel"),
    "K5": ("affine", "OUT", "hmm_affine_reverse_outputs", "affine_outputs_kernel"),
    "K6": ("max_plus", "MPS", "hmm_maxplus_chunk_summaries", "chunk_summaries_kernel"),
    "K7": ("max_plus", "DELTA", "hmm_maxplus_deltas", "deltas_kernel"),
    "K8": ("max_plus", "TRACE", "hmm_maxplus_backtrace", "backtrace_kernel"),
    "K7b": ("max_plus", "DBLK", "hmm_maxplus_deltas_blocked", "deltas_blocked_kernel"),
    "K8b": ("max_plus", "TBLK", "hmm_maxplus_backtrace_blocked", "backtrace_blocked_tiles_kernel"),
    "K9": ("mxu", "MXU", "hmm_sum_chunk_summaries_mxu", "mxu_summary_kernel"),
}
SOURCE_NAMES = tuple(dict.fromkeys(source for source, *_ in KERNELS.values()))
STAGED_PLANES = {"K4": 3, "K5": 3}  # u, v and s; the others stage one plane
KNOBS = ("G", "TS", "NB", "UNROLL")
# The blocked bodies' and K9's own knobs (the others take KNOBS).
KNOBS_OF = {"K7b": ("S", "TS"), "K8b": ("T", "G"), "K9": ("TM", "TN", "TS", "G")}
BLOCKED = ("K7b", "K8b")  # static shared memory (48 KB)
FLAGSHIP = tuple(k for k in KERNELS if k not in KNOBS_OF)  # K1–K8
_SCAN_GRID = [(4, 32, 2, 1)] + [(g, ts, nb, u) for g in (8, 16) for ts in (16, 32, 64)
                                for nb in (2, 3) for u in (1, 2, 4)]
# The knob values tried for each kernel ({-D suffix: value}).
TILINGS = {
    "K1": [dict(G=g, TS=ts, NB=nb, UNROLL=u) for g in (4, 8, 16) for ts in (16, 32, 64)
           for nb in (2, 3) for u in (1, 2)],
    "K2": [dict(zip(KNOBS, t)) for t in _SCAN_GRID],
    "K3": [dict(zip(KNOBS, t)) for t in _SCAN_GRID],
    # K4 reads its tiles as float4 words: G <= 8 (the swizzle keeps them whole).
    "K4": [dict(G=g, TS=ts, NB=nb, UNROLL=u) for g in (2, 4, 8) for ts in (8, 16, 32)
           for nb in (2, 3) for u in (1, 2, 4)],
    "K5": [dict(zip(KNOBS, t)) for t in [(4, 32, 2, 1)] + [
        (g, ts, nb, u) for g in (8, 16) for ts in (8, 16, 32) for nb in (2, 3, 4) for u in (1, 2)]],
    # K6 reads its tiles as float4 words, as K4 does: G <= 8.
    "K6": [dict(G=g, TS=ts, NB=nb, UNROLL=u) for g in (2, 4, 8) for ts in (8, 16, 32)
           for nb in (2, 3) for u in (1, 2)],
    "K7": [dict(zip(KNOBS, t)) for t in _SCAN_GRID],
    "K8": [dict(G=g, TS=ts, NB=nb, UNROLL=u) for g in (4, 8, 16) for ts in (16, 32, 64)
           for nb in (2, 3) for u in (1, 2)],
    # K7b: S lanes per state
    "K7b": [dict(S=s, TS=ts) for s in (1, 2, 4) for ts in (16, 32, 64)],
    "K8b": [dict(T=t, G=g) for t in (32, 64, 128) for g in (2, 4, 8)],
    # K9: a TM x TN tile of the product a thread, G elements a block at q <= 32
    "K9": [dict(TM=tm, TN=tn, TS=ts, G=g) for tm in (4, 8) for tn in (4, 8) for ts in (8, 16, 32)
           for g in (2, 4, 8)],
}
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
SHAPE = dict(c=303, q=15, R=1056, P=33)
BLOCKED_SHAPE = dict(b=32, L=9999, qs=(29, 57))
MXU_SHAPE = dict(L=9999, P=33, qb=((29, 32), (127, 4)))  # (q, b) of each K9 case
MXU_WIDTHS = (32, 64, 96, 128)  # K9's padded widths QP
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12  # H100 SXM data sheet (float32, no tensor cores)


def knobs_of(kernel):
    return KNOBS_OF.get(kernel, KNOBS)


def mxu_block(qp, knobs):
    """(threads, bytes of dynamic shared memory) of K9's block at padded
    width ``qp``: G elements at qp = 32, else one; NT = (qp / TN) (qp / TM)
    threads an element (TN = 12 at qp = 96); A, then for each element two
    buffers of M and two ring slots of TS steps."""
    tn = 12 if qp == 96 else knobs["TN"]
    g = knobs["G"] if qp == 32 else 1
    return g * (qp // tn) * (qp // knobs["TM"]), 4 * (qp * qp + g * (2 * qp * qp + 2 * knobs["TS"] * qp))


def block_shape(kernel, knobs):
    """(threads, bytes of shared memory) of a block of ``kernel`` built
    with ``knobs``: dynamic shared memory, or for K7b and K8b their static
    shared memory at q = 64 (K8b: its tiles block); K9: the most of each
    over its padded widths."""
    if kernel == "K9":
        return tuple(map(max, zip(*(mxu_block(qp, knobs) for qp in MXU_WIDTHS))))
    if kernel == "K7b":
        return 64 * knobs["S"], 4 * (2 * knobs["TS"] * 64 + 2 * 64)
    if kernel == "K8b":
        return knobs["G"] * 65, knobs["T"] * (4 * 64 + 80)
    g, ring = knobs["G"], knobs["NB"] * knobs["TS"] * knobs["G"] * 16
    return 16 * g, 4 * ring * STAGED_PLANES.get(kernel, 1)


def label(kernel, knobs):
    return " ".join([kernel] + [f"{'U' if k == 'UNROLL' else k}={v}" for k, v in knobs.items()])


def build_defaults():
    """{kernel: knobs} of the package's own build (the sources' #defines)."""
    out = {}
    for kernel, (name, prefix, _, _) in KERNELS.items():
        src = _cuda_build.SOURCES[name].read_text()
        out[kernel] = {k: int(re.search(rf"#define {prefix}_{k} (\d+)", src).group(1))
                       for k in knobs_of(kernel)}
    return out


def _variants(compare, grid=True, kernels=tuple(KERNELS)):
    """(label, source name, source path, -D flags, kernels it is run as) of
    every build."""
    out = []
    for kernel in kernels if grid else ():
        name, prefix = KERNELS[kernel][:2]
        for knobs in TILINGS[kernel]:
            threads, smem = block_shape(kernel, knobs)
            limit = 48 * 1024 if kernel in BLOCKED else SMEM_LIMIT  # static shared memory
            if smem > limit or threads > 1024:
                continue
            out.append((label(kernel, knobs), name, _cuda_build.SOURCES[name],
                        [f"-D{prefix}_{k}={v}" for k, v in knobs.items()], (kernel,)))
    for d in compare:
        for name in SOURCE_NAMES:
            runs = tuple(k for k in kernels if KERNELS[k][0] == name)
            if runs:
                out.append((f"{name} {d}", name, Path(d) / f"{name}.cu", [], runs))
    return out


def _build(variants, build_dir):
    """Compile every variant, two ``nvcc`` processes for each CPU core at a
    time; {label: (library, ptxas text)}."""
    build_dir.mkdir(parents=True, exist_ok=True)

    def compile_one(i):
        lab, _, src, defs, _ = variants[i]
        so = build_dir / f"v{i}.so"
        cmd = [_cuda_build.nvcc_path(), *_cuda_build.NVCC_FLAGS, "-Xptxas", "-v", *defs,
               "-o", str(so), str(src)]
        done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lab}:\n{done.stdout}")
        return lab, (so, done.stdout)

    with ThreadPoolExecutor(2 * (os.cpu_count() or 1)) as pool:
        return dict(pool.map(compile_one, range(len(variants))))


def _load(so, name):
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _cuda_build.SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _ptxas_lines(text, kernel):
    """ptxas's "Used ... registers" line of ``kernel`` and its spill line."""
    lines = text.splitlines()
    found = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            for follow in lines[i + 1 : i + 5]:
                if "spill" in follow or "Used" in follow:
                    found.append(follow.split("info    :")[-1].strip())
    return "; ".join(found)


def _sass_report(name, defs, kernel, out_dir):
    """The longest run of consecutive SHFL instructions in ``kernel``'s
    SASS (of the default tiling), the SASS written to ``out_dir``."""
    cuobjdump = shutil.which("cuobjdump") or str(Path(_cuda_build.nvcc_path()).with_name("cuobjdump"))
    cubin = out_dir / f"{name}.cubin"
    flags = [f for f in _cuda_build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_cuda_build.nvcc_path(), *flags, *defs, "-cubin", "-o", str(cubin),
                    str(_cuda_build.SOURCES[name])], check=True, capture_output=True)
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    (out_dir / f"{name}.sass").write_text(sass)
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and re.search(r"/\*[0-9a-f]{4}\*/", line):
            body.append(line)
    run = best = 0
    for line in body:
        run = run + 1 if "SHFL" in line else 0
        best = max(best, run)
    n_shfl = sum("SHFL" in line for line in body)
    return f"{kernel}: {n_shfl} SHFL in {len(body)} instructions, longest back-to-back run {best}"


def _bound(nbytes, nops):
    b, o = 1e3 * nbytes / PEAK_BYTES, 1e3 * nops / PEAK_FLOPS
    return (b, "bytes") if b >= o else (o, "operations")


def _blocked_cases(device, q):
    """K7b's and K8b's cases at the sequential decode's b=32, L=9999 and
    ``q``: seeded random log A (a structural zero column), emissions and
    start, sequence-major."""
    b, c = BLOCKED_SHAPE["b"], BLOCKED_SHAPE["L"]
    rng = np.random.default_rng(q)
    A = rng.dirichlet(np.ones(q), size=q)
    A[:, q // 2] = 0.0
    A /= A.sum(-1, keepdims=True)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)  # noqa: E731
    log_A = torch.log(t(A).clamp_min(1e-16))[None].contiguous()
    log_E = torch.log(t(rng.uniform(0.05, 1.0, size=(1, b, c, q))))
    delta0 = (t(rng.normal(-20.0, 5.0, size=(1, b, q))) + log_E[:, :, 0]).contiguous()
    deltas = cuda_viterbi.maxplus_deltas_seq_plain(log_A, log_E, delta0)
    last = deltas[:, :, -1].argmax(dim=-1).to(torch.int32)
    e_bytes, a_bytes = 4 * c * q * b, 4 * q * q
    return {
        "K7b": ((log_A, log_E, delta0), deltas, cuda_viterbi.maxplus_deltas_seq(log_A, log_E, delta0),
                0.0, 0.0, None, *_bound(a_bytes + 2 * e_bytes + 4 * q * b, b * (c - 1) * 2 * q * q),
                (1, c, q, b)),
        "K8b": ((log_A, deltas, last), cuda_viterbi.maxplus_backtrace_seq_plain(log_A, deltas, last),
                cuda_viterbi.maxplus_backtrace_seq(log_A, deltas, last), 0.0, 0.0, None,
                *_bound(a_bytes + e_bytes + 4 * b + 4 * c * b, b * (c - 1) * 2 * q), (1, c, q, b)),
    }


def _mxu_cases(device):
    """K9's cases at L=9999, P=33 (c=303) for each (q, b) of MXU_SHAPE:
    seeded random A (a structural zero column) and emissions E_S (m, c, R,
    q); rtol = atol = 2e-4 where C lies within 30 nats of its row's
    maximum."""
    P = MXU_SHAPE["P"]
    c = -(-MXU_SHAPE["L"] // P)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)  # noqa: E731
    out = []
    for q, b in MXU_SHAPE["qb"]:
        R = b * P
        rng = np.random.default_rng(q)
        A = rng.dirichlet(np.ones(q), size=(1, q))
        A[..., 1] = 0.0
        A, E_S = t(A / A.sum(-1, keepdims=True)), t(rng.uniform(0.05, 1.0, size=(1, c, R, q)))
        ref = cuda_mxu.sum_chunk_summaries_mxu_plain(A, E_S, P)
        out.append((f" q={q}", (
            (A, E_S), ref, cuda_mxu.sum_chunk_summaries_mxu(A, E_S, P), 2e-4, 2e-4,
            ref >= ref.amax(-1, keepdim=True) - 30.0,
            # FMA = 2; clamp, product, sum and scale one each
            *_bound(4 * q * q + 4 * c * R * q + 4 * R * q * q, R * q * (c - 1) * q * (2 * q + 4)),
            (1, c, q, R, P))))
    return out


def _flagship_cases(device):
    """K1–K8's cases (see :func:`_cases`) at the flagship shapes."""
    c, q, R, P = SHAPE["c"], SHAPE["q"], SHAPE["R"], SHAPE["P"]
    rng = np.random.default_rng(0)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)  # noqa: E731
    A, E_T = t(rng.dirichlet(np.ones(q), size=(1, q))), t(rng.uniform(0.05, 1.0, size=(1, c, q, R)))
    r0 = t(rng.dirichlet(np.ones(q), size=(1, R)).transpose(0, 2, 1))
    ll0 = t(rng.normal(-50.0, 10.0, size=(1, R)))
    beta0 = (r0 / r0.amax(1, keepdim=True)).contiguous()
    B = t(rng.dirichlet(np.ones(q), size=(2, q)))
    S = rng.normal(size=(2, c, q, R))
    U, V, S, xr = (t(rng.uniform(size=(2, c, q, R))), t(rng.uniform(size=(2, c, q, R))),
                   t(S - S.mean(2, keepdims=True)), t(rng.normal(size=(2, q, R))))
    bound = _bound

    log_A, log_E_T = torch.log(A.clamp_min(1e-16)).contiguous(), torch.log(E_T)
    delta0 = (t(rng.normal(-20.0, 5.0, size=(1, q, R))) + log_E_T[:, 0]).contiguous()
    last = torch.from_numpy(rng.integers(0, q, size=(1, R)).astype(np.int32)).to(device)
    deltas = cuda_viterbi.maxplus_deltas_plain(log_A, log_E_T, delta0)
    e_bytes, a_bytes = 4 * c * q * R, 4 * q * q
    C_ref = cuda_forward.sum_chunk_summaries_plain(A, E_T, P)
    return {
        "K1": ((A, E_T), C_ref, cuda_forward.sum_chunk_summaries(A, E_T, P),
               1e-5, 1e-3, C_ref >= C_ref.amax(-1, keepdim=True) - 30.0,
               # FMA = 2; clamp, product, sum and divide one each
               *bound(a_bytes + e_bytes + 4 * R * q * q, R * q * (c - 1) * q * (2 * q + 4)),
               (1, c, q, R, P)),
        "K2": ((A, E_T, r0, ll0), cuda_forward.sum_fwd_outputs_plain(A, E_T, r0, ll0),
               cuda_forward.sum_fwd_outputs(A, E_T, r0, ll0), 1e-5, 1e-2, None,
               *bound(a_bytes + 2 * e_bytes + 4 * (q + 1) * R, R * (c - 1) * q * (2 * q + 4)),
               (1, c, q, R)),
        "K3": ((A, E_T, beta0, ll0), cuda_forward.beta_bwd_outputs_plain(A, E_T, beta0, ll0),
               cuda_forward.beta_bwd_outputs(A, E_T, beta0, ll0), 1e-5, 1e-2, None,
               *bound(a_bytes + 2 * e_bytes + 4 * (q + 1) * R, R * (c - 1) * q * (2 * q + 4)),
               (1, c, q, R)),
        "K4": ((B, U, V, S), cuda_adjoint.affine_chunk_composites_plain(B, U, V, S),
               cuda_adjoint.affine_chunk_composites(B, U, V, S), 1e-5, 1e-6, None,
               # per step and column: q products v * x, q * q FMAs, q products u *
               *bound(2 * a_bytes + 3 * 2 * e_bytes + 2 * 4 * R * q * (q + 1),
                      2 * R * (q + 1) * c * (2 * q * q + 2 * q)),
               (2, c, q, R)),
        "K5": ((B, U, V, S, xr), cuda_adjoint.affine_reverse_outputs_plain(B, U, V, S, xr),
               cuda_adjoint.affine_reverse_outputs(B, U, V, S, xr), 1e-5, 1e-6, None,
               *bound(2 * a_bytes + 4 * 2 * e_bytes + 2 * 4 * q * R, 2 * R * c * (2 * q * q + 3 * q)),
               (2, c, q, R)),
        # K6–K8 bit-equal: the plain versions' rounded adds, exact maxes and
        # lowest-index argmax
        "K6": ((log_A, log_E_T), cuda_viterbi.maxplus_chunk_summaries_plain(log_A, log_E_T, P),
               cuda_viterbi.maxplus_chunk_summaries(log_A, log_E_T, P), 0.0, 0.0, None,
               # one add and one max per (k, p) term of a step, for each border state
               *bound(a_bytes + e_bytes + 4 * R * q * q, 2 * R * q * (c - 1) * q * q),
               (1, c, q, R, P)),
        "K7": ((log_A, log_E_T, delta0), cuda_viterbi.maxplus_deltas_plain(log_A, log_E_T, delta0),
               cuda_viterbi.maxplus_deltas(log_A, log_E_T, delta0), 0.0, 0.0, None,
               # one add and one max per (k, p) term of a step
               *bound(a_bytes + 2 * e_bytes + 4 * q * R, R * (c - 1) * 2 * q * q),
               (1, c, q, R)),
        "K8": ((log_A, deltas, last), cuda_viterbi.maxplus_backtrace_plain(log_A, deltas, last),
               cuda_viterbi.maxplus_backtrace(log_A, deltas, last), 0.0, 0.0, None,
               # deltas and last states in, int32 states out; an add and a compare per term
               *bound(a_bytes + e_bytes + 4 * R + 4 * c * R, R * (c - 1) * 2 * q),
               (1, c, q, R)),
    }


def _cases(device, kernels=tuple(KERNELS)):
    """{kernel: [(shape tag, (C arguments before the output, plain result,
    the package build's result, rtol, atol, mask, bound ms, bound_by, C
    shape arguments)), ...]} of ``kernels`` at the flagship shapes (K7b,
    K8b: the sequential decode's, one case for each q; K9: MXU_SHAPE's), on
    seeded random inputs; the output takes the plain result's shape and
    type."""
    out = {}
    if set(FLAGSHIP) & set(kernels):
        out = {kernel: [("", case)] for kernel, case in _flagship_cases(device).items()}
    if set(BLOCKED) & set(kernels):
        for q in BLOCKED_SHAPE["qs"]:
            for kernel, case in _blocked_cases(device, q).items():
                out.setdefault(kernel, []).append((f" q={q}", case))
    if "K9" in kernels:
        out["K9"] = _mxu_cases(device)
    return out


def _device_busy_ms(fn, symbol):
    """(device busy ms, ms of the kernels whose name holds ``symbol``) of
    one synchronised call of ``fn`` under ``torch.profiler``, after one
    call unprofiled."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def us(e):  # renamed from self_cuda_time_total in newer torch
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    rows = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return sum(map(us, rows)) / 1e3, sum(us(e) for e in rows if symbol in e.key) / 1e3


def _e2e(other, rounds=40):
    """Posterior, log-likelihood and decode (q=15 and the q=29 multi-copy)
    ms/batch, CE and MAP ms/step, and the q=29 log-likelihood and MAP step
    with the K9 gate on, with this build's kernel libraries and with
    ``other`` ({source name: library}), interleaved A, B, B, A."""
    from . import HMMLayer, models

    layer = HMMLayer(models.GenePredTransitions(), models.GenePredEmissions(**CODONS),
                     use_prior=False, parallel_factor="auto")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in layer.parameters():
            p.add_((0.5 * torch.randn(p.shape, generator=gen)).to(p.device))
    rng = np.random.default_rng(1)
    b, length = 32, 9999
    cls = rng.dirichlet(np.ones(15), size=(1, b, length)).astype(np.float32)
    nuc = np.eye(5, dtype=np.float32)[rng.integers(0, 4, size=(1, b, length))]
    X = torch.from_numpy(np.concatenate([cls, nuc], axis=-1)).cuda()
    with torch.inference_mode():
        labels = layer.viterbi(X)[0].long()
    labels = labels.clone()  # a normal tensor: autograd saves it
    mask = torch.ones(labels.shape, device=X.device)
    pars = [p for p in layer.parameters() if p.requires_grad]
    # chip_smoke.py phase 9's multi-copy layer (k=2, q=29; seed 0 + k)
    gen = torch.Generator().manual_seed(2)
    multi = HMMLayer(
        models.GenePredMultiTransitions(k=2, generator=gen),
        models.GenePredEmissions(num_copies=2, init=models.make_15_class_emission_kernel(num_copies=2),
                                 **CODONS),
        use_prior=False, parallel_factor="auto")
    with torch.no_grad():
        for p in multi.parameters():
            p.add_((0.5 * torch.randn(p.shape, generator=gen)).to(p.device))
    multi_pars = [p for p in multi.parameters() if p.requires_grad]
    own = {name: _cuda_build.load(name) for name in other}
    libs = {"this build": own, "compare": other}

    def posterior():
        with torch.inference_mode():
            layer.state_posterior_log_probs(X)

    def loglik():
        with torch.inference_mode():
            layer.log_likelihood(X)

    def decode():
        with torch.inference_mode():
            layer.viterbi(X)

    def ce_step():
        torch.autograd.grad(layer.posterior_cross_entropy(X, labels, label_mask=mask), pars)

    def map_step():
        torch.autograd.grad(layer.loss(X), pars)

    def decode_q29():
        with torch.inference_mode():
            multi.viterbi(X)

    def k9_gated(fn):
        """``fn`` with the K9 gate on around the call only."""
        def call():
            saved = cuda_mxu.MXU_KERNELS
            cuda_mxu.MXU_KERNELS = True
            try:
                fn()
            finally:
                cuda_mxu.MXU_KERNELS = saved
        return call

    @k9_gated
    def loglik_q29():
        with torch.inference_mode():
            multi.log_likelihood(X)

    @k9_gated
    def map_q29():
        torch.autograd.grad(multi.loss(X), multi_pars)

    calls = {"posterior": (posterior, "ms/batch"), "ce": (ce_step, "ms/step"),
             "map": (map_step, "ms/step"), "loglik": (loglik, "ms/batch"),
             "decode": (decode, "ms/batch"), "decode_q29": (decode_q29, "ms/batch"),
             "loglik_q29": (loglik_q29, "ms/batch"), "map_q29": (map_q29, "ms/step")}
    times = {v: {key: [] for key in calls} for v in libs}
    try:
        for i in range(rounds + 1):  # round 0 warms both up, untimed
            for v in (("this build", "compare") if i % 2 else ("compare", "this build")):
                _cuda_build._libs.update(libs[v])
                for key, (fn, _) in calls.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    if i:
                        times[v][key].append(1e3 * (time.perf_counter() - t0))
        busy = {v: [] for v in libs}  # (device busy ms, K9 ms) of profiled gated requests
        for i in range(6):
            v = ("this build", "compare")[i % 2]
            _cuda_build._libs.update(libs[v])
            busy[v].append(_device_busy_ms(loglik_q29, KERNELS["K9"][3]))
    finally:
        _cuda_build._libs.update(own)
    for key, (_, unit) in calls.items():
        a, b_ = times["this build"][key], times["compare"][key]
        diff = statistics.median(x - y for x, y in zip(a, b_))
        print(f"e2e {key}: this build {statistics.median(a):.3f} {unit} [{min(a):.3f}, {max(a):.3f}], "
              f"compare {statistics.median(b_):.3f} [{min(b_):.3f}, {max(b_):.3f}], median paired "
              f"difference {diff:+.3f} ({len(a)} pairs, b={b}, L={length})", flush=True)
    med = {v: [statistics.median(x) for x in zip(*busy[v])] for v in libs}
    print(f"e2e loglik_q29 profiled ({len(busy['compare'])} requests each): device busy this build "
          f"{med['this build'][0]:.3f} ms (K9 {med['this build'][1]:.3f}), compare {med['compare'][0]:.3f} "
          f"ms (K9 {med['compare'][1]:.3f}), difference {med['this build'][0] - med['compare'][0]:+.3f} ms",
          flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels", default=",".join(KERNELS),
                        help=f"comma-separated kernels to sweep (default: all of {','.join(KERNELS)})")
    parser.add_argument("--compare", action="append", default=[],
                        help="directory with another commit's sum_product.cu, affine.cu, max_plus.cu "
                             "and mxu.cu")
    parser.add_argument("--compare-only", action="store_true", help="time the --compare sources only")
    parser.add_argument("--e2e", action="store_true",
                        help="time the flagship posterior, log-likelihood and decode requests, the CE "
                             "and MAP steps and the q=29 multi-copy calls with this build and with --compare")
    parser.add_argument("--out", default=str(_cuda_build.BUILD_DIR / "tune"), help="directory for the SASS")
    args = parser.parse_args(argv)
    kernels = tuple(args.kernels.split(","))
    if not set(kernels) <= set(KERNELS):
        parser.error(f"--kernels takes some of {','.join(KERNELS)}")
    if args.e2e and len(args.compare) != 1:
        parser.error("--e2e takes exactly one --compare directory")
    if not torch.cuda.is_available():
        print("tune_scans: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = torch.device("cuda")
    variants = _variants(args.compare, grid=not args.compare_only, kernels=kernels)
    if args.e2e:  # the A/B run swaps whole libraries
        variants += [v for v in _variants(args.compare, grid=False) if v[0] not in {w[0] for w in variants}]
    built = _build(variants, _cuda_build.BUILD_DIR / "tune")
    for kernel in kernels:
        name, _, _, symbol = KERNELS[kernel]
        print(f"sass {_sass_report(name, [], symbol, out_dir)}", flush=True)

    cases = _cases(device, kernels)
    stream = torch.cuda.current_stream(device).cuda_stream
    failed, cold_of = [], {}
    for lab, name, _, defs, runs in variants:
        so, text = built[lab]
        lib = _load(so, name)
        for kernel, tag, case in ((k, tag, case) for k in runs if k in kernels for tag, case in cases[k]):
            ins, ref, own, rtol, atol, mask, bound, by, dims = case
            entry, symbol = getattr(lib, KERNELS[kernel][2]), KERNELS[kernel][3]
            out = torch.empty_like(ref)

            def fn(entry=entry, ins=ins, out=out, dims=dims):
                err = entry(*(x.data_ptr() for x in ins), out.data_ptr(), *dims, 0, stream)
                if err:
                    raise RuntimeError(f"{lab}: cudaError {err}")

            key = (lab if len(runs) == 1 else f"{kernel} {lab}") + tag
            try:
                fn()
            except RuntimeError as exc:  # a refused launch: the next variant still runs
                print(f"{key}: FAILED {exc}", flush=True)
                failed.append(key)
                continue
            torch.cuda.synchronize()
            got, exp = (out, ref) if mask is None else (out[mask], ref[mask])
            err = float((got - exp).abs().max())
            ok = bool(((got - exp).abs() <= atol + rtol * exp.abs()).all())
            warm, cold = median_ms(fn, reps=10), cold_median_ms(fn)
            cold_of[key] = cold
            print(f"{key}: {'ok' if ok else 'MISMATCH'} max_abs_err={err:.3e} (rtol {rtol}, atol {atol}), "
                  f"{'bit-equal to' if torch.equal(out, own) else 'differs from'} the package build; "
                  f"warm {warm:.4f} ms, cold {cold:.4f} ms; bound {bound:.4f} ms ({by}), cold bound "
                  f"share {100 * bound / cold:.1f}%; ptxas {_ptxas_lines(text, symbol)}", flush=True)
            if not ok:
                failed.append(key)
    for kernel in kernels:
        for tag, _ in cases[kernel]:
            mine = [k for k in cold_of if k.startswith(f"{kernel} ") and k.endswith(tag)]
            if mine:
                best = min(mine, key=cold_of.get)
                print(f"fastest {best}: cold {cold_of[best]:.4f} ms")
    print(f"build defaults {build_defaults()}; on {smi}")
    if args.e2e:
        d = args.compare[0]
        _e2e({name: _load(built[f"{name} {d}"][0], name) for name in SOURCE_NAMES})
    if failed:
        print(f"tune_scans: variants failed or disagree with the plain versions: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
