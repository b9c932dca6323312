"""Spawn the ranks of a multi-process run on one host and collect what
each returns.

    handle = start_ranks("pkg.module:function", n_ranks, kwargs)
    results = handle.join()          # one result per rank, in rank order

Each rank is a fresh `python -m bifurcationkit.jl_tpu_torch.parallel.launch`
process that joins a gloo process group at `tcp://127.0.0.1:<port>` (a
free port picked here), calls `function(**kwargs)` and pickles its return
value.  The target is "module:function" or "path/to/file.py:function"; it
runs inside the initialised group.  `join` waits for all ranks and
raises, with the failing ranks' output, if any rank exits with another
code than 0 or the run outlasts `timeout` (then every rank is killed);
collectives time out after `timeout` seconds too, so a rank that is
left waiting does not hang the run.
"""
from __future__ import annotations

import datetime
import importlib
import importlib.util
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List

_REPO = Path(__file__).resolve().parents[3]


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """The processes of one run (`start_ranks`)."""

    def __init__(self, procs, outdir: tempfile.TemporaryDirectory,
                 timeout: float):
        self.procs, self._outdir, self.timeout = procs, outdir, timeout
        self._start = time.monotonic()

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def join(self) -> List[Any]:
        deadline = self._start + self.timeout
        try:
            while any(p.poll() is None for p in self.procs):
                if time.monotonic() > deadline or any(
                        p.poll() not in (None, 0) for p in self.procs):
                    break
                time.sleep(0.02)
        finally:
            self._kill()
        logs = [Path(self._outdir.name, f"rank{r}.log").read_text()
                for r in range(len(self.procs))]
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            self._outdir.cleanup()
            timed_out = time.monotonic() > deadline
            raise RuntimeError(
                f"ranks {bad} failed" + (" (timed out)" if timed_out else "")
                + "".join(f"\n--- rank {r} ---\n{logs[r][-4000:]}"
                          for r in bad))
        out = []
        for r in range(len(self.procs)):
            with open(Path(self._outdir.name, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        self._outdir.cleanup()
        return out


def start_ranks(target: str, n_ranks: int, kwargs: Dict[str, Any] = None,
                timeout: float = 120.0) -> Ranks:
    """Start `n_ranks` processes running `target(**kwargs)` (kwargs must
    pickle) in one gloo group; `Ranks.join` collects the results."""
    outdir = tempfile.TemporaryDirectory(prefix="bk_ranks_")
    with open(Path(outdir.name, "kwargs.pkl"), "wb") as f:
        pickle.dump(kwargs or {}, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p])
    env["OMP_NUM_THREADS"] = "1"
    addr = f"tcp://127.0.0.1:{free_port()}"
    procs = []
    for r in range(n_ranks):
        log = open(Path(outdir.name, f"rank{r}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "bifurcationkit.jl_tpu_torch.parallel.launch",
             target, str(r), str(n_ranks), addr, outdir.name, str(timeout)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(_REPO)))
        log.close()
    return Ranks(procs, outdir, timeout)


def _resolve(target: str):
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            Path(where).stem, where)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(where)
    return getattr(mod, name)


def _main(argv):
    target, rank, world, addr, outdir, timeout = argv
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=addr, rank=int(rank), world_size=int(world),
        timeout=datetime.timedelta(seconds=float(timeout)))
    try:
        with open(Path(outdir, "kwargs.pkl"), "rb") as f:
            kwargs = pickle.load(f)
        result = _resolve(target)(**kwargs)
        with open(Path(outdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1:])
