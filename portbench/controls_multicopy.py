"""Readings that set the limit of ``correct`` in a multi-copy decode cell
(traffic kind ``predict_multicopy``), at the cell's own size.

    python3 portbench/controls_multicopy.py --workload <cell> --seeds <n> [<n> ...] [--seconds 15]
        [--what control half_batch]

For each seed it prints one JSON line with ``path_gap_nats`` as the cell's
check reads it (every window of the first strand decoded, and the seed's
sample of the other tracks' windows), from:

* ``program``: the program as the benchmark runs it, for ``--seconds`` of
  its timed loop;
* ``control``: the plain reference in the program's place, computed in
  bfloat16 (the rule of ``controls.py``: the decode's max-plus recursion is
  float32 work that no tensor core does, whose step below is bfloat16),
  decoding each judged window alone;
* ``half_batch``: the program with half of each window batch left out.

``controls.py`` reads the other cells; the benchmark's own runs run
neither. Its tiny-size twin is a test.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def reference_pins(r, problems, rows, prec):
    """The kept states of each judged window as the plain reference decodes
    the window alone in ``prec``."""
    import torch

    from portbench.reference import genepred_multicopy as ref

    p, init, A = r.reference_model(prec)
    k, codons = r.family.copies(r.cfg), r.family.codons(r.cfg)
    pins = []
    for b0, x in r.blocks(problems, rows):
        with torch.no_grad():
            paths = ref.viterbi_path(init, A, ref.emissions(p, x, codons, k, prec)).cpu().numpy()
        pins += [path[lo - st : hi - st] for (_, st, lo, hi), path in zip(rows[b0 : b0 + len(x)], paths)]
    return pins


def _program(cell, seed, device, seconds, faults=()):
    """The driver after ``seconds`` of its timed loop, the program freed."""
    import torch

    from portbench import controls

    r, _ = controls._setup(cell, seed, device, faults)
    r.window(seconds)
    r.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return r


def readings(cell, seed, device, seconds, what):
    from portbench.controls import _window_detail
    from portbench.reference.hmm import BF16

    unlimited = {"path_gap_nats": float("inf")}
    r = _program(cell, seed, device, seconds)
    out = {"program": {"path_gap_nats": r.check(unlimited)[0][0]["value"]}, "program_windows": _window_detail(r)}
    if "control" in what:
        problems = r.distinct_tracks()
        rows = r.check_rows(problems)
        gaps = r.gaps_of(problems, rows, reference_pins(r, problems, rows, BF16))
        out["control"] = {"path_gap_nats": max(gaps)}
        out["control_windows"] = _window_detail(r)
    if "half_batch" in what:
        h = _program(cell, seed, device, seconds, ("half_batch",))
        out["half_batch"] = {"path_gap_nats": h.check(unlimited)[0][0]["value"]}
        out["half_batch_windows"] = _window_detail(h)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--what", nargs="*", default=["control", "half_batch"])
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = run.Cell(manifest, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(cell, seed, "cuda", args.seconds, args.what)
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
