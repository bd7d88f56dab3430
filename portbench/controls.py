"""Readings that set the limits of ``correct``, at a cell's own size.

    python3 portbench/controls.py --workload <cell> --seeds <n> [<n> ...]

For each seed it prints one JSON line with the numbers that the cell's
check compares, read from:

* ``program``: the program as the benchmark runs it (its first three
  training steps, or one decode of every strand of the pool);
* ``control``: the plain reference put in the program's place, computed
  one precision step below the configuration's float32 for the work that
  the compared numbers rest on: TF32 products where that work is float32
  matrix products (the training cells: TF32 is what a tensor core would
  give them), bfloat16 where it is float32 arithmetic that no tensor core
  does (the decode's max-plus recursion of additions and maxima);
* ``half_batch`` (training cells): the program with half of each batch
  left out and the mean taken over the rest.

The benchmark's own runs do not run this; its tiny-size twin is a test.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _setup(cell, seed, device, faults=()):
    from portbench import run

    family = run.load_file(cell.family_path, "family_" + cell.cfg["family"])
    driver = run.load_file(cell.driver_path, "driver_" + cell.traffic["kind"])
    r = driver.Run(run.Context(cell, seed, device, family, run.Faults(faults)))
    r.setup()
    return r, driver


def _leaf_detail(prog, ref):
    """Sorted per-leaf gaps of the first gradient and of the change."""
    from portbench import checks

    leaves = sorted(ref["grad1"])
    g = checks.leaf_gaps(prog["grad1"], ref["grad1"], leaves)
    u = checks.leaf_gaps(prog["change"], ref["change"], leaves)
    out = {"grad": sorted(g.values()), "update": sorted(u.values()),
           "losses": [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]}
    if len(leaves) <= 8:
        out["grad_by_leaf"], out["update_by_leaf"] = g, u
    return out


def train_readings(cell, seed, device, what):
    from portbench import checks
    from portbench.reference.hmm import F64, TF32, Precision

    r, driver = _setup(cell, seed, device)
    r.release()
    loss_fn = r.family.reference_loss(r.cfg)
    steps = r.pool[: driver.FIRST_STEPS]
    ref = checks.adam_follow(loss_fn, r.params0, steps, r.trainable, r.traffic["lr"], F64)
    out = {"program": checks.training_readings(r.first, ref)[0], "program_leaves": _leaf_detail(r.first, ref)}
    if "control" in what:
        ctl = checks.adam_follow(loss_fn, r.params0, steps, r.trainable, r.traffic["lr"], TF32)
        out["control"] = checks.training_readings(ctl, ref)[0]
        out["control_leaves"] = _leaf_detail(ctl, ref)
    if "float32" in what:
        f32 = checks.adam_follow(loss_fn, r.params0, steps, r.trainable, r.traffic["lr"], Precision("float32"))
        out["float32"] = checks.training_readings(f32, ref)[0]
        out["float32_leaves"] = _leaf_detail(f32, ref)
    if "half_batch" in what:
        h, _ = _setup(cell, seed, device, faults=("half_batch",))
        h.release()
        out["half_batch"] = checks.training_readings(h.first, ref)[0]
        out["half_batch_leaves"] = _leaf_detail(h.first, ref)
    return out


def _reference_tracks(r, driver, device, prec, log_emission_dtype=None):
    """Every strand of the pool decoded by the plain reference in ``prec``
    (its log-emissions rounded to ``log_emission_dtype``, if given), window
    by window, stitched as ``decode_contig`` stitches."""
    import numpy as np
    import torch

    from portbench.reference import genepred as ref
    from portbench.reference import hmm

    p = {k: v.to(prec.dtype) for k, v in r.params0.items()}
    init, A = ref.matrices(p, prec)
    codons = r.family.codons(r.cfg)
    answers = []
    for i, strand in r.order:
        nuc, cls = r.strand_inputs(i, strand)
        wins = driver.windows_of(len(nuc), r.window_len, r.overlap)
        track = np.zeros(len(nuc), np.int32)
        block = r.traffic["check_block"]
        for b0 in range(0, len(wins), block):
            part = wins[b0 : b0 + block]
            x = np.stack([driver.window_inputs(nuc, cls, st, r.window_len) for st, _, _ in part])
            with torch.no_grad():
                E = ref.emissions(p, torch.as_tensor(x, device=device), codons, False, prec)
                paths = hmm.viterbi_path(init, A, E, log_emission_dtype).cpu().numpy()
            for (st, lo, hi), path in zip(part, paths):
                track[lo:hi] = path[lo - st : hi - st]
        answers.append((i, strand, track))
    return answers


def predict_readings(cell, seed, device, what):
    """``program``: one decode of every strand of the pool; ``control``: the
    reference in its place computed in bfloat16 (the decode's max-plus
    recursion is float32 work that no tensor core does, whose step below
    is bfloat16); witnesses: ``bf16_emissions`` (only the log-emissions in
    bfloat16, the rest float64), ``tf32`` (float32 with TF32 products),
    ``float32``, and ``program_p1`` (the program's sequential decode)."""
    import torch

    from portbench.reference.hmm import BF16, F64, TF32, Precision

    r, driver = _setup(cell, seed, device)
    with torch.inference_mode():
        for _ in range(len(r.order)):
            r._strand()
        if "program_p1" in what:
            program_answers = r.answers
            r.answers = []
            r.layer.parallel_factor = 1
            for _ in range(len(r.order)):
                r._strand()
            p1_answers, r.answers = r.answers, program_answers
    r.release()
    limits = {"path_gap_nats": float("inf")}
    out = {}

    def judge(name, answers):
        r.answers = answers
        out[name] = {"path_gap_nats": r.check(limits)[0][0]["value"]}
        out[name + "_windows"] = _window_detail(r)

    judge("program", r.answers)
    if "program_p1" in what:
        judge("program_p1", p1_answers)
    if "control" in what:
        judge("control", _reference_tracks(r, driver, device, BF16))
    if "bf16_emissions" in what:
        judge("bf16_emissions", _reference_tracks(r, driver, device, F64, torch.bfloat16))
    if "tf32" in what:
        judge("tf32", _reference_tracks(r, driver, device, TF32))
    if "float32" in what:
        judge("float32", _reference_tracks(r, driver, device, Precision("float32")))
    return out


def _window_detail(r):
    """The distribution of the per-window gaps of the last check."""
    import numpy as np

    g = np.sort(np.asarray(r.window_gaps))
    return {"windows": int(g.size), "sum": float(g.sum()), "mean": float(g.mean()),
            "over_1e-6": int((g > 1e-6).sum()), "over_1e-3": int((g > 1e-3).sum()),
            "over_1e-2": int((g > 1e-2).sum()), "over_0.1": int((g > 0.1).sum()),
            "top": [float(x) for x in g[-8:]], "q99": float(np.quantile(g, 0.99)),
            "q999": float(np.quantile(g, 0.999))}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--what", nargs="+", default=["control", "half_batch"])
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = run.Cell(manifest, args.workload)
    readings = train_readings if cell.traffic["kind"] == "train" else predict_readings
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(cell, seed, "cuda", args.what)
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
