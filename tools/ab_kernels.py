#!/usr/bin/env python3
"""Time the port's two CUDA kernels from several copies of the package on
one card, in turns, so that two versions are compared on one machine.

    python3 tools/ab_kernels.py TREE [TREE ...]

Each TREE is a directory that holds `bifurcationkit/jl_tpu_torch` (a
checkout, or a `git archive` of one).  The trees are measured in the order
given and then in reverse (A B B A), each time in a process of its own
that imports the package from that tree and builds its kernels there.
Each process measures through the package's public calls, `dia_spmv(A, v)`
and `sh_jv(u, v, scal)`, in f32 and f64:

- at the paths' small shapes (DIA SpMV n = 256 with the Brusselator's
  offsets, SH J.v 151x100 K = 1): the wrapper's time (CUDA events over
  back-to-back calls), its host time (the host clock over calls with no
  sync) and the card's own time (torch.profiler);
- at the shapes that move megabytes (DIA SpMV 2^20 rows, SH J.v 151x100
  K = 60 and 1024x1024 K = 1, and its periodic closure at the periodic
  SH2d's 512x512 K = 1): the card's time warm, back to back on one
  set of inputs, and cold, in turn over copies of the inputs three times
  the L2 cache's size, so that each call reads from HBM.

Each device time follows as many unprofiled calls as it profiles, and each
process reads the card's clocks, power draw and temperature before and
after its measures.  It prints the card's name and power limit, then one
line per measure with the values of each tree in run order, and writes
every row to chiprun_out/ab_kernels.json.  It imports no JAX.
"""
import functools
import itertools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L2_BYTES = 50 * 2 ** 20    # the H100 SXM's L2 cache
BRUSS_OFFSETS = (-128, -1, 0, 1, 128)
BIG_OFFSETS = (-1024, -1, 0, 1, 1024)


def _time(torch, fn, reps):
    """Milliseconds per call on CUDA events over back-to-back calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _host_time(torch, fn, reps):
    """Milliseconds per call on the host clock over calls with no sync."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e3


def _device_time(torch, fn, name, calls=100):
    """Milliseconds per call of the kernels whose name holds `name`, from
    torch.profiler over `calls` calls, after as many unprofiled ones."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(calls):
        fn()
    for _ in range(3):          # the profiler now and then records no kernel
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [getattr(e, "self_device_time_total", None)
              or e.self_cuda_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and name in e.key]
        if us:
            return sum(us) / 1e3 / calls
    return None


def _smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


CLOCKS = "clocks.sm,clocks.mem,power.draw,temperature.gpu"


def _cold_copies(nbytes):
    return -(-3 * L2_BYTES // nbytes)


def _in_turn(fns):
    turn = itertools.cycle(fns)
    return lambda: next(turn)()


def measure(tree):
    """Every row of one tree, measured in this process."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from bifurcationkit.jl_tpu_torch.ops import sh_jv as sh_mod
    from bifurcationkit.jl_tpu_torch.ops.dia_spmv import dia_spmv
    from bifurcationkit.jl_tpu_torch.ops.sparse import DIAMatrix

    if not sh_mod.__file__.startswith(tree):
        raise RuntimeError(f"imported {sh_mod.__file__}, not from {tree}")
    dev = torch.device("cuda")

    def dia(n, offsets, dtype, seed):
        rng = np.random.default_rng(seed)
        data = torch.as_tensor(rng.standard_normal((len(offsets), n)),
                               dtype=dtype, device=dev)
        v = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
        nbytes = (sum(max(n - abs(o), 0) for o in offsets) + 2 * n) \
            * data.element_size()
        return functools.partial(dia_spmv, DIAMatrix(data, offsets), v), \
            nbytes

    def sh(shape, K, dtype, seed, closure="neumann"):
        rng = np.random.default_rng(seed)
        u = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                            device=dev)
        v = torch.as_tensor(rng.standard_normal((K,) + shape if K > 1
                                                else shape),
                            dtype=dtype, device=dev)
        scal = torch.tensor([-0.1, 1.3, 1.0 / 0.11, 1.0 / 0.07],
                            dtype=dtype, device=dev)
        nbytes = (1 + 2 * K) * shape[0] * shape[1] * u.element_size()
        return functools.partial(sh_mod.sh_jv, u, v, scal, closure), nbytes

    rows = [dict(kernel="-", case="clocks before", smi=_smi(CLOCKS))]
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for kernel, case, make in (
                ("dia_spmv", "n=256", lambda s: dia(256, BRUSS_OFFSETS,
                                                    dtype, s)),
                ("sh_jv", "151x100 K=1", lambda s: sh((151, 100), 1,
                                                      dtype, s))):
            fn, _ = make(7)
            rows.append(dict(kernel=kernel, case=case, dtype=name,
                             wrapper_ms=_time(torch, fn, 2000),
                             host_ms=_host_time(torch, fn, 2000),
                             device_ms=_device_time(torch, fn,
                                                    f"{kernel}_kernel")))
        for kernel, case, make in (
                ("dia_spmv", "n=2^20", lambda s: dia(1 << 20, BIG_OFFSETS,
                                                     dtype, s)),
                ("sh_jv", "151x100 K=60", lambda s: sh((151, 100), 60,
                                                       dtype, s)),
                ("sh_jv", "1024x1024 K=1", lambda s: sh((1024, 1024), 1,
                                                        dtype, s)),
                ("sh_jv", "periodic 512x512 K=1",
                 lambda s: sh((512, 512), 1, dtype, s, "periodic"))):
            fn, nbytes = make(7)
            copies = [make(100 + c)[0] for c in range(_cold_copies(nbytes))]
            key = f"{kernel}_kernel"
            rows.append(dict(kernel=kernel, case=case, dtype=name,
                             device_ms=_device_time(torch, fn, key),
                             device_cold_ms=_device_time(
                                 torch, _in_turn(copies), key),
                             cold_copies=len(copies)))
            del copies
            torch.cuda.empty_cache()
    rows.append(dict(kernel="-", case="clocks after", smi=_smi(CLOCKS)))
    return rows


def main(trees):
    trees = [os.path.abspath(t) for t in trees]
    smi = _smi("name,power.limit")
    runs = []
    for tree in trees + trees[::-1]:
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--measure", tree], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{tree} failed:\n{proc.stderr[-4000:]}")
        rows = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(dict(tree=os.path.relpath(tree, ROOT), rows=rows,
                         seconds=time.perf_counter() - t))
        print(f"[run] tree={runs[-1]['tree']} seconds={runs[-1]['seconds']:.1f}",
              flush=True)
    print(smi)
    order = [r["tree"] for r in runs]
    print("order: " + " ".join(order))
    for i, row in enumerate(runs[0]["rows"]):
        if "smi" in row:
            print(f"{row['case']} ({CLOCKS}): "
                  + " | ".join(r["rows"][i]["smi"] for r in runs))
        for key in row:
            if not key.endswith("_ms"):
                continue
            vals = [r["rows"][i][key] for r in runs]
            print(f"{row['kernel']} {row['case']} {row['dtype']} {key}: "
                  + " ".join("-" if x is None else f"{x * 1e3:.3f}"
                             for x in vals) + "  (us)")
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "ab_kernels.json"), "w") as f:
        json.dump(dict(smi=smi, runs=runs), f, indent=1)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2])))
    elif len(sys.argv) >= 2 and not sys.argv[1].startswith("-"):
        main(sys.argv[1:])
    else:
        sys.exit(__doc__)
