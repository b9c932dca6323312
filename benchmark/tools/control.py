"""Readings for the limits of a cell's compared numbers: for each seed, a
short window of the cell at its own size, the program's numbers and the
control's (the reference in the next precision down put in the program's
place), one JSON line each, in one process.

    python3 benchmark/tools/control.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] [--out <file>] [--fault <name>]

`--fault` plants one of FAULTS in the program first, for the reading of a
fault at the cell's own size.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))


def _skip_bisection():
    """Detection keeps the step's end point as the located point."""
    from bifurcationkit.jl_tpu_torch.continuation import driver

    def located_at_the_step(it, state, verbose=False):
        return "guess", (min(state.p, state.p_old), max(state.p, state.p_old))

    driver.locate_bifurcation = located_at_the_step


def _skip_lobpcg():
    """The eigensolver returns the Ritz values of its start block."""
    import dataclasses

    from bifurcationkit.jl_tpu_torch.linalg.eig import LOBPCGEig

    orig = LOBPCGEig.__call__

    def skipped(self, *a, **kw):
        return orig(dataclasses.replace(self, maxiter=0, refine_iters=0),
                    *a, **kw)

    LOBPCGEig.__call__ = skipped


FAULTS = {"skip_bisection": _skip_bisection, "skip_lobpcg": _skip_lobpcg}


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return float(x) if hasattr(x, "dtype") else x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)

    import torch

    from harness import registry, runner

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    reg = registry.Cell(registry.load_spec(), args.workload)
    if args.fault:
        FAULTS[args.fault]()
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t = time.perf_counter()
        result, extra = runner.measure(reg, seed, args.seconds, False,
                                       device="cuda", with_control=True)
        line = json.dumps({
            "workload": args.workload, "seed": seed, "fault": args.fault,
            "correct": result["correct"], "metrics": result["metrics"],
            "program": runner.checks_field(extra["numbers"]),
            "control": runner.checks_field(extra["control"] or []),
            "notes": extra["notes"], "errors": extra["errors"],
            "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if out:
            full = json.dumps(_plain({"seed": seed, "fault": args.fault,
                                      "numbers": extra["numbers"],
                                      "control": extra["control"]}))
            out.write(line + "\n" + full + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
