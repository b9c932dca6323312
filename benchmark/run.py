"""The benchmark of `bifurcationkit.jl_tpu_torch` on NVIDIA GPUs.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json from the root of a checkout: set-up, a
measured window of `--seconds`, then the comparison with the plain
reference that decides `correct`.  With `--trace 0` it reports the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics from a profiled
slice of the window.  The last line of standard output is one JSON object;
the last lines of standard error are the compared numbers and their
limits.  It exits non-zero, with no result, where there is no card or too
few, where the program cannot be imported, or where JAX or the JAX package
was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every cache the run writes stays inside the checkout, at fixed paths
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / ".bench_cache" / "nv"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      str(ROOT / ".bench_cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / ".bench_cache" / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
# one process with few threads: the host's BLAS and OpenMP pools only
# contend with the launching thread
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import guard, registry

    spec = registry.load_spec()
    reg = registry.Cell(spec, args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < reg.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"no result: the cell needs {reg.chips} CUDA device(s), "
              f"this machine has {have}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)

    from harness import runner

    seed = args.seed % 2 ** 63
    result, extra = runner.measure(reg, seed, args.seconds, bool(args.trace),
                                   device="cuda", t_process=T_PROCESS)
    for e in extra["errors"]:
        print(f"job failed:\n{e}", file=sys.stderr)
    for i, q in enumerate(extra["ctx"]["points"]):
        print(f"point {i} job {q['job']} step {q['step']} p {q['p']:.6f} "
              f"dt {q['dt']:.4f} newton {q['itnewton']} linear "
              f"{q['itlinear']} unstable {q['n_unstable'][0]} "
              f"special {[s['type'] for s in q['special']]}",
              file=sys.stderr)

    loaded = guard.forbidden_loaded(sys.modules)
    if loaded:
        print(f"no result: JAX or the JAX package is loaded: {loaded}",
              file=sys.stderr)
        return 4
    bad = guard.reference_imports_program(BENCH / "reference")
    if bad:
        print(f"no result: the reference imports the program: {bad}",
              file=sys.stderr)
        return 4

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": reg.chips, "memory_peak_bytes": int(extra["peak"])}
    tr = extra["ctx"]["trace"]
    if args.trace:
        if tr is None:
            print("no result: the traced slice did not close inside the "
                  "window", file=sys.stderr)
            return 5
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    out = dict(result)
    out["device"] = device
    if "breakdown" in out:
        out["breakdown"] = out.pop("breakdown")
    out["notes"] = extra["notes"]
    out["checks"] = runner.checks_field(extra["numbers"])
    print(f"notes: {json.dumps(extra['notes'])}", file=sys.stderr)
    runner.print_checks(extra["numbers"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
