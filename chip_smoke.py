#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`bifurcationkit/jl_tpu_torch`) once on one
NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, one line each (a failing phase raises and the script exits non-zero):

1. device: needs CUDA; prints the card's name and power limit;
2. build: compiles the SH J.v kernel (`csrc/sh_jv.cu`) with nvcc;
3. kernel vs plain: the kernel against its plain PyTorch version on the
   card, f64 and f32, at the flagship shape (K = 1, 2, 60), at 1024x1024
   and at a ragged 37x23;
4. main path: the SH2d-fronts flagship at 151x100 — Newton, then PALC
   through `ContIterable` (2 warm-up + 6 timed steps) and `continuation()`
   with bifurcation detection — with the kernel's launch count reset just
   before and read just after — and one profiled step (busy time, idle
   share, longest kernels);
5. check: the flagship's last point is a finite root of F, and a 60x40
   branch on the card matches the same branch on the CPU;
6. timing: the kernel, its plain version and its bound at the main path's
   shapes (CUDA events over back-to-back calls, and the card's own time
   per call from torch.profiler).

Then the nvidia-smi line, one JSON line listing the kernels, and the final
JSON line.  Full details go to chiprun_out/chip_smoke.json.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bifurcationkit.jl_tpu_torch as bk  # noqa: E402
from bifurcationkit.jl_tpu_torch import interop, models  # noqa: E402
from bifurcationkit.jl_tpu_torch.continuation.engine import (  # noqa: E402
    ContIterable)
from bifurcationkit.jl_tpu_torch.core.state import BorderedState  # noqa: E402
from bifurcationkit.jl_tpu_torch.ops import sh_jv as sh_jv_mod  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM3 3.35 TB/s; FP64 34 TFLOP/s and FP32
# 67 TFLOP/s outside the tensor cores (the J.v stencil uses none)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
NEWTON_TOL = 1e-7          # the continuation's Newton tolerance
OUT_DIR = os.path.join(ROOT, "chiprun_out")

DETAILS = {}


def phase(tag, **fields):
    DETAILS.setdefault(tag, []).append(fields)
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 1-2. device and build
# ---------------------------------------------------------------------------


def check_device():
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs an "
                           "NVIDIA GPU")
    card = smi_line()
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), smi=repr(card),
          torch=torch.__version__, cuda=torch.version.cuda)
    return card


def build():
    t0 = time.perf_counter()
    so = sh_jv_mod.build_library()
    sh_jv_mod._library()
    log = so.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          library=os.path.relpath(so, ROOT), ptxas=repr(ptxas))


# ---------------------------------------------------------------------------
# 3. kernel against its plain version
# ---------------------------------------------------------------------------


def _inputs(shape, K, dtype, seed):
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    u = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)
    v = torch.as_tensor(rng.standard_normal((K,) + shape), dtype=dtype,
                        device=dev)
    scal = torch.tensor([-0.1, 1.3, 1.0 / 0.11, 1.0 / 0.07], dtype=dtype,
                        device=dev)
    return u, v, scal


def compare_kernel():
    cases = [((151, 100), 1), ((151, 100), 2), ((151, 100), 60),
             ((1024, 1024), 1), ((37, 23), 1), ((37, 23), 3)]
    worst_main = 0.0
    for dtype in (torch.float64, torch.float32):
        for i, (shape, K) in enumerate(cases):
            u, v, scal = _inputs(shape, K, dtype, seed=i)
            out = sh_jv_mod.sh_jv(u, v if K > 1 else v[0], scal)
            torch.cuda.synchronize()
            ref = sh_jv_mod.sh_jv_plain(u, v if K > 1 else v[0], scal)
            abs_err = float((out - ref).abs().max())
            rel = abs_err / float(ref.abs().max())
            phase("compare", dtype=str(dtype).split(".")[-1],
                  shape=f"{shape[0]}x{shape[1]}", K=K, max_abs_err=abs_err,
                  max_rel_err=rel, tol=TOL[dtype])
            if not (rel < TOL[dtype]):
                raise AssertionError(f"sh_jv disagrees with its plain "
                                     f"version: {rel} >= {TOL[dtype]}")
            if shape == (151, 100):
                worst_main = max(worst_main, abs_err)
    return worst_main


# ---------------------------------------------------------------------------
# 4. the main path
# ---------------------------------------------------------------------------


def flagship_config(prob, max_steps):
    """bench.py's accelerator configuration of the SH2d-fronts flagship."""
    ls = bk.IterativeRefinement(
        inner=bk.GMRES(restart=40, maxiter=160, rtol=1e-5,
                       precond=prob.spectral_precond),
        refinements=4, rtol=1e-10)
    eig = bk.LOBPCGEig(maxiter=30, tol=3e-3, extra=8,
                       precond=lambda v: prob.spectral_precond(v, shift=1.0),
                       compute_dtype=torch.float32)
    cp = bk.ContinuationPar(
        ds=-0.005, dsmax=0.02, dsmin=1e-6, p_min=-0.8, p_max=0.2,
        max_steps=max_steps, nev=12, detect_bifurcation=3, detect_fold=True,
        save_eigenvectors=False,
        newton_options=bk.NewtonPar(tol=NEWTON_TOL, max_iterations=15,
                                    linsolver=ls, eigsolver=eig))
    return ls, cp


def main_path(card, warmup=2, timed=6, detect_steps=6):
    sh_jv_mod.sh_jv.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prob = models.swift_hohenberg_2d(Nx=151, Ny=100)      # on the card
    ls, cp = flagship_config(prob, warmup + timed + 2)
    sol = bk.newton(prob, bk.NewtonPar(tol=1e-8, max_iterations=25,
                                       linsolver=ls))
    torch.cuda.synchronize()
    if not sol.converged:
        raise AssertionError("Newton did not converge on the flagship")
    phase("newton", iterations=sol.itnewton, linear=sol.itlineartot,
          residual=float(sol.residuals[sol.itnewton]),
          seconds=round(time.perf_counter() - t0, 3))

    it = ContIterable(prob.re_make(u0=sol.u), bk.PALC(), cp)
    state = it.init_state()
    steps = []

    def step(kind):
        t = time.perf_counter()
        it.iterate(state)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if not state.converged:
            raise AssertionError(f"PALC step {state.step} did not converge")
        steps.append(dict(kind=kind, step=state.step, p=state.p,
                          n_unstable=state.n_unstable[0],
                          itnewton=state.itnewton, itlinear=state.itlinear,
                          seconds=dt))
        phase("palc", **steps[-1])

    for _ in range(warmup):
        step("warmup")
    for _ in range(timed):
        step("timed")
    timed_steps = [s for s in steps if s["kind"] == "timed"]
    warm = [s["seconds"] for s in timed_steps]
    steps_per_s = timed / sum(warm)
    breakdown(it, state, timed_steps)

    t1 = time.perf_counter()
    _, cp_det = flagship_config(prob, detect_steps)
    br = bk.continuation(prob.re_make(u0=sol.u), bk.PALC(), cp_det)
    torch.cuda.synchronize()
    branch = interop.branch_to_numpy(br)
    phase("continuation", steps=len(br) - 1,
          p=[float(x) for x in branch["p"]],
          n_unstable=[int(x) for x in branch["n_unstable"]],
          special=[(str(t), float(p)) for t, p in
                   zip(branch["sp_type"], branch["sp_p"])],
          seconds=round(time.perf_counter() - t1, 3))
    launches = sh_jv_mod.sh_jv.launches
    if launches <= 0:
        raise AssertionError("the main path never launched the sh_jv kernel")
    phase("main_path", steps_per_s=steps_per_s, warm_step_s=warm,
          sh_jv_launches=launches,
          peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
          card=repr(card))
    return prob, state, launches, steps_per_s


def _kernel_rows(prof):
    """(name, device microseconds, calls) of the CUDA kernels in a profile,
    longest first."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        rows.append((e.key, float(t), int(e.count)))
    return sorted(rows, key=lambda r: -r[1])


def _profile(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    return _kernel_rows(prof), wall


def breakdown(it, state, timed_steps):
    """Where one warm flagship step goes: corrector against eigensolve on
    the host clock, then one profiled step — the card's busy time and the
    longest kernels.  The profiler's own host work slows the step it
    traces, so `idle_share` divides that busy time by the median wall
    time of the unprofiled timed steps, and `idle_share_per_iteration`
    scales it to the timed steps' inner iteration counts first.  The
    share against the profiled step's own wall time is printed beside
    them, labelled as such."""
    kn, par = it.kernels, it._params()
    z, tau, ds = state.z, state.tau, state.ds
    z_pred = BorderedState(u=z.u + ds * tau.u, p=z.p + ds * tau.p)
    torch.cuda.synchronize()
    t = time.perf_counter()
    kn.palc_corrector(z_pred, z, tau, ds, par)
    torch.cuda.synchronize()
    t_corr = time.perf_counter() - t
    t = time.perf_counter()
    kn.eig(z.u, z.p, par, state.eig_seed)
    torch.cuda.synchronize()
    t_eig = time.perf_counter() - t

    rows, wall = _profile(lambda: it.iterate(state))
    if not state.converged:
        raise AssertionError("the profiled PALC step did not converge")
    busy = sum(r[1] for r in rows) * 1e-6
    sh = [r for r in rows if "sh_jv_kernel" in r[0]]
    step_s = float(np.median([s["seconds"] for s in timed_steps]))
    # the profiled step may take more inner iterations than a timed one:
    # scale its busy time per inner iteration to the timed steps' counts
    busy_per_it = busy / max(state.itlinear, 1)
    timed_busy = busy_per_it * sum(s["itlinear"] for s in timed_steps)
    timed_wall = sum(s["seconds"] for s in timed_steps)
    phase("breakdown", corrector_s=t_corr, eig_s=t_eig,
          median_timed_step_s=step_s, profiled_step_s=wall,
          profiled_itlinear=state.itlinear,
          median_timed_itlinear=float(np.median(
              [s["itlinear"] for s in timed_steps])),
          device_busy_s=busy if rows else "not measured",
          idle_share=(1 - busy / step_s) if rows else "not measured",
          idle_share_per_iteration=(1 - timed_busy / timed_wall) if rows
          else "not measured",
          idle_share_of_profiled_wall=(1 - busy / wall) if rows
          else "not measured",
          sh_jv_device_s=sum(r[1] for r in sh) * 1e-6,
          sh_jv_calls=sum(r[2] for r in sh), kernels=len(rows),
          launches=sum(r[2] for r in rows),
          top_kernels_ms=[(n[:70], round(us / 1e3, 3), c)
                          for n, us, c in rows[:8]])


# ---------------------------------------------------------------------------
# 5. checks on what came out
# ---------------------------------------------------------------------------


def check_outputs(prob, state):
    u = state.z.u
    if tuple(u.shape) != (151, 100) or not bool(torch.isfinite(u).all()):
        raise AssertionError("flagship state is not a finite 151x100 field")
    par = prob.set_lens_param(prob.params, state.z.p)
    res = float(torch.linalg.vector_norm(prob.F(u, par)))
    if not res <= NEWTON_TOL:
        raise AssertionError(f"flagship residual {res} above {NEWTON_TOL}")
    phase("check_flagship", residual=res, p=state.p)

    # the same small branch on the card and on the CPU (plain J.v)
    kw = dict(Nx=60, Ny=40, lx=8 * np.pi * 60 / 151,
              ly=4 * np.pi / np.sqrt(3) * 40 / 100)
    rows = {}
    for dev in ("cuda", "cpu"):
        p = models.swift_hohenberg_2d(device=dev, **kw)
        _, cp = flagship_config(p, 2)
        rows[dev] = interop.branch_to_numpy(
            bk.continuation(p, bk.PALC(), cp))
    dp = float(np.abs(rows["cuda"]["p"] - rows["cpu"]["p"]).max())
    same_n = bool(np.array_equal(rows["cuda"]["n_unstable"],
                                 rows["cpu"]["n_unstable"]))
    same_sp = list(rows["cuda"]["sp_type"]) == list(rows["cpu"]["sp_type"])
    phase("check_small_branch", max_abs_dp=dp, same_n_unstable=same_n,
          same_special_types=same_sp,
          special=[str(t) for t in rows["cuda"]["sp_type"]])
    if not (dp < 1e-8 and same_n and same_sp):
        raise AssertionError("60x40 branch on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# 6. timing
# ---------------------------------------------------------------------------


def _time(fn, reps):
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


def time_kernel():
    cases = []
    one = torch.zeros(1, device="cuda")
    launch_floor = _time(lambda: one.add_(0), 2000)
    for shape, K in (((151, 100), 1), ((151, 100), 60), ((1024, 1024), 1)):
        for dtype in (torch.float32, torch.float64):
            u, v, scal = _inputs(shape, K, dtype, seed=7)
            vv = v if K > 1 else v[0]
            reps = 2000 if shape == (151, 100) and K == 1 else 300

            def kern():
                return sh_jv_mod.sh_jv(u, vv, scal)

            def plain():
                return sh_jv_mod.sh_jv_plain(u, vv, scal)

            # in turns: kernel, plain, kernel, plain
            tk1, tp1 = _time(kern, reps), _time(plain, reps)
            tk2, tp2 = _time(kern, reps), _time(plain, reps)
            # the same calls' time on the card alone, from the profiler
            krows, _ = _profile(lambda: [kern() for _ in range(100)])
            prows, _ = _profile(lambda: [plain() for _ in range(100)])
            kdev = [r for r in krows if "sh_jv_kernel" in r[0]]
            N, M = shape
            nbytes = sh_jv_mod.sh_jv_bytes(N, M, K, u.element_size())
            flops = sh_jv_mod.sh_jv_flops(N, M, K)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dtype] * 1e3
            case = dict(dtype=str(dtype).split(".")[-1],
                        shape=f"{N}x{M}", K=K, ms=(tk1 + tk2) / 2,
                        plain_ms=(tp1 + tp2) / 2,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops else "operations",
                        launch_floor_ms=launch_floor,
                        device_ms=(sum(r[1] for r in kdev) / 1e3
                                   / sum(r[2] for r in kdev))
                        if kdev else "not measured",
                        plain_device_ms=sum(r[1] for r in prows) / 1e5
                        if prows else "not measured",
                        library="none: no single PyTorch call computes SH J.v")
            cases.append(case)
            phase("timing", **case)
    return cases


def main():
    card = check_device()
    build()
    max_abs_err = compare_kernel()
    prob, state, launches, steps_per_s = main_path(card)
    check_outputs(prob, state)
    cases = time_kernel()
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    head = next(c for c in cases
                if c["shape"] == "151x100" and c["K"] == 1
                and c["dtype"] == "float32")
    kernels = [{
        "name": "sh_jv", "route": "cuda",
        "source": "bifurcationkit/jl_tpu_torch/csrc/sh_jv.cu",
        "replaces": "bifurcationkit/jl_tpu/ops/pallas_sh.py:111",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,       # no single PyTorch call computes SH J.v
        "cases": cases,
    }]
    DETAILS["kernels"] = kernels
    DETAILS["steps_per_s"] = steps_per_s
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(DETAILS, f, indent=1, default=str)
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
