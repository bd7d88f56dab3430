"""Tile sizes of the output scans K2 and K5 on the card.

Run from the root of the repository on a machine with a CUDA device:
``python3 -m hmm_layer_torch.tune_scans [--compare DIR ...]
[--compare-only] [--e2e] [--out DIR]``.

K2 (``csrc/sum_product.cu``) and K5 (``csrc/affine.cu``) are built once per
tiling: G chunk elements a block, TS steps a staged tile, NB tiles in the
ring and the step loop unrolled U times (``-DFWD_G``, ``-DFWD_TS``,
``-DFWD_NB``, ``-DFWD_UNROLL`` and the ``OUT_`` names for K5; the package's
own build uses the defaults in the sources). Tilings whose ring exceeds a
block's 227 KB of shared memory are left out. All ``nvcc`` processes start
together, with ``-Xptxas -v``. Each ``--compare DIR`` adds the two sources of
another commit (``DIR/sum_product.cu``, ``DIR/affine.cu``) as variants, so
that old and new kernels are timed in the same process on the same card;
``--compare-only`` leaves the tilings out. Each variant runs at the
flagship shapes on seeded random inputs (K2: m=1, c=303, q=15, R=1056; K5:
2m=2, the posterior VJP's stacked models), is held against the plain
version (K2 rtol 1e-5, atol 1e-2; K5 rtol 1e-5, atol 1e-6) and against the
package's own build (bit-equal or not), and is timed:

* warm: median of 20 samples of 10 back-to-back launches (CUDA events),
  the inputs then sit in the 50 MB L2;
* cold: 256 MB written to a scratch buffer before each single launch, CUDA
  events around that launch, median of 20.

With ``--e2e`` (and one ``--compare DIR``), the flagship gene-prediction
layer (q=15, b=32, L=9999, parallel factor "auto" = 33, random weights from
seed 0) then serves posterior requests and takes posterior cross-entropy
steps (forward and backward, no optimizer) with this build's K2 and K5 and
with DIR's in turns: 40 rounds, this build first and DIR first alternately
(the two libraries are loaded side by side and swapped under the
wrappers). Each call is timed with the host clock around a synchronised
call; the medians and the median paired difference are printed.

It prints ptxas's registers and spills of each kernel, the longest run of
back-to-back ``SHFL`` instructions in each default kernel's SASS
(``cuobjdump``; the SASS is written to ``--out``), one line per variant, the
fastest tiling of each kernel by cold time, and the card's name and power
limit. It exits non-zero without a card or on any mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .ops import _cuda_build, cuda_adjoint, cuda_forward
from .utils.cuda_timing import cold_median_ms, median_ms

# (G, TS, NB, U) tried for each kernel; the words of a tile ring are
# NB * TS * G * 16 for K2 and three times that for K5 (u, v and s).
CODONS = dict(
    start_codons=[("ATG", 1.0)],
    stop_codons=[("TAG", 0.34), ("TAA", 0.33), ("TGA", 0.33)],
    intron_begin_pattern=[("NGT", 0.99), ("NGC", 0.005), ("NAT", 0.005)],
    intron_end_pattern=[("AGN", 0.99), ("ACN", 0.01)],
)
K2_TILINGS = [(4, 32, 2, 1)] + [(g, ts, nb, u) for g in (8, 16) for ts in (16, 32, 64)
                                for nb in (2, 3) for u in (1, 2, 4)]
K5_TILINGS = [(4, 32, 2, 1)] + [(g, ts, nb, u) for g in (8, 16) for ts in (8, 16, 32)
                                for nb in (2, 3, 4) for u in (1, 2)]
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
SHAPE = dict(c=303, q=15, R=1056)
PEAK_BYTES = 3.35e12  # H100 SXM data sheet


def _variants(compare, grid=True):
    """(label, source name, source path, -D flags) of every build."""
    out = []
    for kernel, name, prefix, arrays, tilings in (("K2", "sum_product", "FWD", 1, K2_TILINGS),
                                                  ("K5", "affine", "OUT", 3, K5_TILINGS)):
        for g, ts, nb, u in tilings if grid else []:
            if arrays * nb * ts * g * 16 * 4 > SMEM_LIMIT:
                continue
            out.append((f"{kernel} G={g} TS={ts} NB={nb} U={u}", name, _cuda_build.SOURCES[name],
                        [f"-D{prefix}_G={g}", f"-D{prefix}_TS={ts}", f"-D{prefix}_NB={nb}",
                         f"-D{prefix}_UNROLL={u}"]))
    for d in compare:
        out.append((f"K2 {d}", "sum_product", Path(d) / "sum_product.cu", []))
        out.append((f"K5 {d}", "affine", Path(d) / "affine.cu", []))
    return out


def _build(variants, build_dir):
    """Compile every variant in parallel; {label: (library, ptxas text)}."""
    build_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (label, _, src, defs) in enumerate(variants):
        so = build_dir / f"v{i}.so"
        cmd = [_cuda_build.nvcc_path(), *_cuda_build.NVCC_FLAGS, "-Xptxas", "-v", *defs,
               "-o", str(so), str(src)]
        jobs.append((label, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    built = {}
    for label, so, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{text}")
        built[label] = (so, text)
    return built


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


def _inputs(device):
    c, q, R = SHAPE["c"], SHAPE["q"], SHAPE["R"]
    rng = np.random.default_rng(0)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)  # noqa: E731
    k2 = [t(rng.dirichlet(np.ones(q), size=(1, q))), t(rng.uniform(0.05, 1.0, size=(1, c, q, R))),
          t(rng.dirichlet(np.ones(q), size=(1, R)).transpose(0, 2, 1)),
          t(rng.normal(-50.0, 10.0, size=(1, R)))]
    B = rng.dirichlet(np.ones(q), size=(2, q))
    S = rng.normal(size=(2, c, q, R))
    k5 = [t(B), t(rng.uniform(size=(2, c, q, R))), t(rng.uniform(size=(2, c, q, R))),
          t(S - S.mean(2, keepdims=True)), t(rng.normal(size=(2, q, R)))]
    return k2, k5


def _e2e(other, rounds=40):
    """Posterior ms/batch and CE ms/step with this build's K2/K5 libraries
    and with ``other`` ({source name: library}), interleaved A, B, B, A."""
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
    own = {name: _cuda_build.load(name) for name in other}
    libs = {"this build": own, "compare": other}

    def posterior():
        with torch.inference_mode():
            layer.state_posterior_log_probs(X)

    def ce_step():
        torch.autograd.grad(layer.posterior_cross_entropy(X, labels, label_mask=mask), pars)

    times = {v: {"posterior": [], "ce": []} for v in libs}
    try:
        for i in range(rounds + 1):  # round 0 warms both up, untimed
            for v in (("this build", "compare") if i % 2 else ("compare", "this build")):
                _cuda_build._libs.update(libs[v])
                for key, fn in (("posterior", posterior), ("ce", ce_step)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    if i:
                        times[v][key].append(1e3 * (time.perf_counter() - t0))
    finally:
        _cuda_build._libs.update(own)
    for key, unit in (("posterior", "ms/batch"), ("ce", "ms/step")):
        a, b_ = times["this build"][key], times["compare"][key]
        diff = statistics.median(x - y for x, y in zip(a, b_))
        print(f"e2e {key}: this build {statistics.median(a):.3f} {unit} [{min(a):.3f}, {max(a):.3f}], "
              f"compare {statistics.median(b_):.3f} [{min(b_):.3f}, {max(b_):.3f}], median paired "
              f"difference {diff:+.3f} ({len(a)} pairs, b={b}, L={length})", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--compare", action="append", default=[],
                        help="directory with another commit's sum_product.cu and affine.cu")
    parser.add_argument("--compare-only", action="store_true", help="time the --compare sources only")
    parser.add_argument("--e2e", action="store_true",
                        help="time the flagship posterior and CE step with this build and with --compare")
    parser.add_argument("--out", default=str(_cuda_build.BUILD_DIR / "tune"), help="directory for the SASS")
    args = parser.parse_args(argv)
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
    variants = _variants(args.compare, grid=not args.compare_only)
    built = _build(variants, _cuda_build.BUILD_DIR / "tune")
    for name, kernel, defs in (("sum_product", "fwd_outputs_kernel", []),
                               ("affine", "affine_outputs_kernel", [])):
        print(f"sass {_sass_report(name, defs, kernel, out_dir)}", flush=True)

    (A, E_T, r0, ll0), (B, U, V, S, xr) = _inputs(device)
    m, c, q, R = E_T.shape
    m2 = B.shape[0]
    ref2 = cuda_forward.sum_fwd_outputs_plain(A, E_T, r0, ll0)
    ref5 = cuda_adjoint.affine_reverse_outputs_plain(B, U, V, S, xr)
    # The package's own build: a variant bit-equal to it rounds as it does.
    own2 = cuda_forward.sum_fwd_outputs(A, E_T, r0, ll0)
    own5 = cuda_adjoint.affine_reverse_outputs(B, U, V, S, xr)
    bound2 = 1e3 * (4 * m * q * q + 2 * 4 * m * c * q * R + 4 * m * (q + 1) * R) / PEAK_BYTES
    bound5 = 1e3 * (4 * m2 * q * q + 4 * 4 * m2 * c * q * R + 4 * m2 * q * R) / PEAK_BYTES
    failed, cold_of = [], {}
    for label, name, _, _ in variants:
        so, text = built[label]
        lib = _load(so, name)
        out = torch.empty((m if name == "sum_product" else m2, c, q, R), device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        if name == "sum_product":
            kernel, ref, own, rtol, atol, bound = "fwd_outputs_kernel", ref2, own2, 1e-5, 1e-2, bound2

            def fn():
                err = lib.hmm_sum_fwd_outputs(A.data_ptr(), E_T.data_ptr(), r0.data_ptr(),
                                              ll0.data_ptr(), out.data_ptr(), m, c, q, R, 0, stream)
                if err:
                    raise RuntimeError(f"{label}: cudaError {err}")
        else:
            kernel, ref, own, rtol, atol, bound = "affine_outputs_kernel", ref5, own5, 1e-5, 1e-6, bound5

            def fn():
                err = lib.hmm_affine_reverse_outputs(B.data_ptr(), U.data_ptr(), V.data_ptr(),
                                                     S.data_ptr(), xr.data_ptr(), out.data_ptr(),
                                                     m2, c, q, R, 0, stream)
                if err:
                    raise RuntimeError(f"{label}: cudaError {err}")
        fn()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = bool(((out - ref).abs() <= atol + rtol * ref.abs()).all())
        warm, cold = median_ms(fn, reps=10), cold_median_ms(fn)
        cold_of[label] = cold
        print(f"{label}: {'ok' if ok else 'MISMATCH'} max_abs_err={err:.3e} (rtol {rtol}, atol {atol}), "
              f"{'bit-equal to' if torch.equal(out, own) else 'differs from'} the package build; "
              f"warm {warm:.4f} ms, cold {cold:.4f} ms; bound {bound:.4f} ms (bytes), cold bound "
              f"share {100 * bound / cold:.1f}%; ptxas {_ptxas_lines(text, kernel)}", flush=True)
        if not ok:
            failed.append(label)
    defaults = {f"{p}_{k}": re.search(rf"#define {p}_{k} (\d+)", _cuda_build.SOURCES[n].read_text()).group(1)
                for p, n in (("FWD", "sum_product"), ("OUT", "affine")) for k in ("G", "TS", "NB", "UNROLL")}
    for kernel in ("K2", "K5"):
        best = min((lab for lab in cold_of if lab.startswith(kernel)), key=cold_of.get)
        print(f"fastest {best}: cold {cold_of[best]:.4f} ms")
    print(f"build defaults {defaults}; on {smi}")
    if args.e2e:
        d = args.compare[0]
        _e2e({"sum_product": _load(built[f"K2 {d}"][0], "sum_product"),
              "affine": _load(built[f"K5 {d}"][0], "affine")})
    if failed:
        print(f"tune_scans: variants disagree with the plain versions: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
