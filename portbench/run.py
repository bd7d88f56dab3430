"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix, driver
and per-layer metrics are found by name: ``BENCHMARK.json`` names them,
``portbench/configs/<config>.json``, ``portbench/traffic/<mix>.json``,
``portbench/drivers/<kind>.py``, ``portbench/metrics/<metric>.py`` and
``portbench/limits/<cell>.json`` hold them.

The run sets up (weights and inputs from the seed, the port's layer, every
shape warmed up), measures for ``--seconds``, and with ``--trace 1`` then
profiles a fixed amount of the same work. Once the window has closed and
the peak memory is read, it frees the program and checks what the program
produced against the plain reference. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also close standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hmm_layer_tpu")


def _cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_file(path: Path, name: str):
    """A module from one file of the benchmark (names may hold dots)."""
    spec = importlib.util.spec_from_file_location("portbench_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


class Cell:
    """One workload of ``BENCHMARK.json`` and the files it names."""

    def __init__(self, manifest, name, root=ROOT):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
        self.name, self.spec = name, cells[name]
        bench = root / "portbench"
        self.cfg = json.loads((bench / "configs" / f"{self.spec['config']}.json").read_text())
        self.traffic = json.loads((bench / "traffic" / f"{self.spec['traffic']}.json").read_text())
        self.limits = json.loads((bench / "limits" / f"{name}.json").read_text())
        self.end_to_end = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"] if name in m.get("workloads", [name])]
        self.driver_path = bench / "drivers" / f"{self.traffic['kind']}.py"
        self.family_path = bench / "models" / f"{self.cfg['family']}.py"
        self.metric_paths = {m["name"]: bench / "metrics" / f"{m['name']}.py" for m in self.per_layer}


class Faults:
    """Breakages planted under the timed path, for the tests that see
    ``correct`` come out false; none in a benchmark run."""

    def __init__(self, names=()):
        self.names = set(names)

    def wrap_loss(self, loss_fn, layer):
        if "half_batch" not in self.names:
            return loss_fn
        import torch

        base = loss_fn or (lambda batch, indices: layer.loss(batch, indices=indices))

        def half(x):
            return x[:, : x.shape[1] // 2] if torch.is_tensor(x) else x

        def cut(batch, indices):
            if isinstance(batch, dict):
                return base({k: half(v) for k, v in batch.items()}, indices)
            return base(half(batch), indices)

        return cut

    def wrap_optimizer(self, optimizer):
        if "state_unchanged" not in self.names:
            return
        import torch

        step = optimizer.step

        def unchanged(*args, **kwargs):
            params = [p for g in optimizer.param_groups for p in g["params"]]
            saved = [p.detach().clone() for p in params]
            out = step(*args, **kwargs)
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
            return out

        optimizer.step = unchanged

    def wrap_viterbi(self, fn):
        if "answer_altered" in self.names:

            def altered(x):
                paths = fn(x).clone()
                t = paths.shape[-1] // 2
                paths[0, 0, t] = (paths[0, 0, t] + 1) % 15
                return paths

            return altered
        if "half_batch" in self.names:

            def half(x):
                b = x.shape[1]
                paths = fn(x[:, : b // 2])
                out = paths.new_zeros((paths.shape[0], b, paths.shape[2]))
                out[:, : b // 2] = paths
                return out

            return half
        return fn


class Context:
    def __init__(self, cell, seed, device, family, faults):
        self.cfg, self.traffic, self.seed, self.device = cell.cfg, cell.traffic, seed, device
        self.family, self.faults = family, faults

    def sync(self):
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def mark(self, what):
        """A set-up stage's end on standard error, synchronised, with the
        seconds since the process started."""
        self.sync()
        print(f"portbench: set-up: {what} done at {time.perf_counter() - T_START:.3f} s", file=sys.stderr)


def _card(device):
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _merge(base, extra):
    for k, v in extra.items():
        base[k] = _merge(dict(base.get(k, {})), v) if isinstance(v, dict) else v
    return base


def _finite(x):
    return x if x == x and abs(x) != float("inf") else 1.7976931348623157e308


def main(argv=None, device=None, faults=(), overrides=None, root=ROOT):
    """Run one cell; returns the exit code. ``device`` other than None
    skips the look for a chip, ``overrides`` ({"config": ..., "traffic":
    ...}) shrink the cell and ``faults`` plant breakages: the tests' tiny
    CPU runs."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cell = Cell(manifest, args.workload, root)
    for key, extra in (overrides or {}).items():
        attr = "cfg" if key == "config" else key
        setattr(cell, attr, _merge(getattr(cell, attr), extra))

    import torch

    if device is None:
        chips = cell.spec["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: the cell needs {chips} CUDA device(s); found {found}", file=sys.stderr)
            return 2
        device = "cuda"
    family = load_file(cell.family_path, "family_" + cell.cfg["family"])
    driver = load_file(cell.driver_path, "driver_" + cell.traffic["kind"])
    from portbench import tracing

    ctx = Context(cell, args.seed, device, family, Faults(faults))
    run = driver.Run(ctx)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_setup = time.perf_counter()
    ctx.mark("imports and the card")
    run.setup()
    setup_s = time.perf_counter() - T_START
    print(f"portbench: set-up {setup_s:.3f} s, of which the driver's {time.perf_counter() - t_setup:.3f} s",
          file=sys.stderr)
    window = run.window(args.seconds)
    print(f"portbench: window {json.dumps(window)}", file=sys.stderr)
    values = {"setup_s": setup_s, **window}
    trace = None
    if args.trace:
        trace = run.traced(lambda work: tracing.profile(work, device))
    card = _card(device)
    if torch.device(device).type == "cuda":
        card["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    run.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, detail = run.check(cell.limits)
    print(f"portbench: the check took {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    counts = run.counts()
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the benchmark measures the port alone", file=sys.stderr)
        return 3
    units = {m["name"]: m["unit"] for m in manifest["end_to_end"] + manifest["per_layer"]}
    if args.trace:
        rec = {"window": window, "trace": trace, "shape": family.shape_of(cell.cfg, cell.traffic),
               "device_name": card["kind"], "unit_ops": family.unit_ops(cell.cfg, cell.traffic)}
        metrics = {}
        for name, path in cell.metric_paths.items():
            value = load_file(path, "metric_" + name).read(rec)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        card["busy_s"], card["window_s"] = trace["busy_s"], trace["window_s"]
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    print(f"portbench: {args.workload} seed {args.seed}: card {_power_limit()}; check detail {json.dumps(detail)}")
    result = {"correct": all(n["value"] <= n["limit"] for n in numbers), **counts, "metrics": metrics,
              "device": card}
    if args.trace:
        result["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    result["checks"] = {n["name"]: {"value": _finite(n["value"]), "limit": n["limit"]} for n in numbers}
    for n in numbers:
        print(f"check {n['name']}: {n['value']!r} (limit {n['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
