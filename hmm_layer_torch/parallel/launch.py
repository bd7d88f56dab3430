"""Run a function on every rank of a local ``torch.distributed`` world.

:func:`run_world` starts ``world_size`` Python processes on this host,
each of which initialises its process group (``tcp://localhost``, a free
port), calls ``fn(*args)`` and returns its result to the caller, one per
rank. Every collective of the world is bounded by ``timeout_s`` and the
whole run by ``timeout_s`` too: ranks that diverge or hang are killed and
the call raises, so a world never hangs its caller.

``fn`` must be a module-level function of a file that imports cleanly in a
fresh process (it is loaded from its file). ``python -m
hmm_layer_torch.parallel.launch`` is the entry point of each rank.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

__all__ = ["run_world", "free_port"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _target(fn) -> str:
    module = sys.modules[fn.__module__]
    return f"{os.path.abspath(module.__file__)}:{fn.__qualname__}"


def run_world(fn, world_size: int, *args, backend: str = "gloo", timeout_s: float = 300.0, threads: int = 1):
    """``[fn(*args) on rank r for r in range(world_size)]``, each rank in its
    own process with an initialised process group of ``backend``.

    Raises ``RuntimeError`` with the failing ranks' output when a rank
    fails, ``TimeoutError`` (after killing every rank) when the world runs
    past ``timeout_s``.
    """
    from .. import __file__ as pkg_file

    repo = os.path.dirname(os.path.dirname(os.path.abspath(pkg_file)))
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="hmm_world_") as out:
        with open(os.path.join(out, "args.pkl"), "wb") as fh:
            pickle.dump(args, fh)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (repo, env.get("PYTHONPATH")) if p)
        procs = []
        for rank in range(world_size):
            cmd = [
                sys.executable, "-m", "hmm_layer_torch.parallel.launch",
                "--target", _target(fn), "--rank", str(rank), "--world", str(world_size),
                "--port", str(port), "--backend", backend, "--out", out,
                "--timeout", str(timeout_s), "--threads", str(threads),
            ]
            log = open(os.path.join(out, f"rank{rank}.log"), "w+")
            procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env), log))
        deadline = time.monotonic() + timeout_s
        try:
            for proc, _ in procs:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            for proc, _ in procs:
                proc.kill()
            for proc, _ in procs:
                proc.wait()
            raise TimeoutError(f"world of {world_size} ranks ran past {timeout_s}s:\n{_tails(procs)}") from None
        if any(proc.returncode != 0 for proc, _ in procs):
            raise RuntimeError(
                f"ranks exited with {[proc.returncode for proc, _ in procs]}:\n{_tails(procs)}"
            )
        results = []
        for rank in range(world_size):
            with open(os.path.join(out, f"rank{rank}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
        for _, log in procs:
            log.close()
        return results


def _tails(procs, n: int = 3000) -> str:
    parts = []
    for rank, (proc, log) in enumerate(procs):
        log.seek(0)
        parts.append(f"--- rank {rank} (exit {proc.returncode}) ---\n{log.read()[-n:]}")
    return "\n".join(parts)


def _load(target: str):
    path, name = target.rsplit(":", 1)
    spec = importlib.util.spec_from_file_location("_hmm_world_target", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    obj = module
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--target", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--backend", default="gloo")
    p.add_argument("--out", required=True)
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--threads", type=int, default=1)
    a = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from .sharding import init_distributed

    torch.set_num_threads(a.threads)
    init_distributed(
        a.backend, init_method=f"tcp://localhost:{a.port}", world_size=a.world, rank=a.rank, timeout_s=a.timeout
    )
    try:
        with open(os.path.join(a.out, "args.pkl"), "rb") as fh:
            args = pickle.load(fh)
        result = _load(a.target)(*args)
        with open(os.path.join(a.out, f"rank{a.rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main()
