#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`bifurcationkit/jl_tpu_torch`) once on one
NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, one line each (a failing phase raises and the script exits non-zero):

1. device: needs CUDA; prints the card's name and power limit;
2. build: compiles both kernels, the SH J.v (`csrc/sh_jv.cu`) and the DIA
   SpMV (`csrc/dia_spmv.cu`), one nvcc process each, started together;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, f64 and f32 — SH J.v at the flagship shape (K = 1, 2, 20, 40,
   59, 60, 61: every batch size the flagship launches and around them),
   at 1024x1024, at a ragged 37x23, on grids with N or M in
   {1, 2, 3, 5} and on tiles ragged on both axes; DIA SpMV at the
   Brusselator path's shape (n = 256, offsets -128, -1, 0, 1, 128; K = 1
   and 8), at a ragged n, with offsets +-5000 on n = 20,000, with 5
   diagonals on 2^20 rows, at n of 1 to 3, with 12 and 32 diagonals, and
   on a matrix whose `data` is replaced after its first product (the
   product must read what the matrix holds at the call);
4. main paths, each with every kernel's launch count reset just before it
   and read just after:
   a. the SH2d-fronts flagship at 151x100 — Newton, then PALC through
      `ContIterable` (2 warm-up + 6 timed steps) and `continuation()` with
      bifurcation detection — and one profiled step (busy time, idle
      share, longest kernels); the `sh_jv` launches split by batch size;
   b. the Brusselator at 128 sites (256 unknowns) with its jacobian as a
      five-diagonal `DIAMatrix` — Newton from a perturbed guess, then PALC
      with GMRES and shift-invert Arnoldi sweeps that detect and bisect
      the Hopf point (at l = 0.5103642674 to 1e-8), with `p_max` cut just
      past it — and one profiled step;
5. check: the flagship's last point is a finite root of F, a 60x40 SH
   branch and a 32-site Brusselator branch on the card match the same
   branches on the CPU;
6. timing: each kernel, its plain version and its bound at the main
   paths' shapes: the wrapper's time (CUDA events over back-to-back
   calls), its host time per call (the host clock over calls with no
   sync), the card's own time per call from torch.profiler (back to back
   on the same inputs, and where a call moves 1 MiB or more also cold:
   taken in turn over copies of its inputs three times the L2 cache's
   size, so that each call reads from HBM), and the device floor (the
   profiler's time of a one-element `add_`); for SH J.v
   also through the operator the SH model's `jac_op` uses, for DIA SpMV
   also one cuSPARSE CSR matrix-vector product through PyTorch, timed as
   a yardstick only.  At K = 1 on the flagship grid and at the
   Brusselator path's shape the host time is split into its parts: the
   output's allocation, the ctypes call (with the CUDA launch in it), and
   the stream and device queries around it.

Then the nvidia-smi line, one JSON line listing the kernels, and the final
JSON line.  Full details go to chiprun_out/chip_smoke.json.
"""
import dataclasses
import functools
import itertools
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
from bifurcationkit.jl_tpu_torch.ops import (  # noqa: E402
    DIAMatrix, dia_spmv, nvcc)
from bifurcationkit.jl_tpu_torch.ops import sh_jv as sh_jv_mod  # noqa: E402
from bifurcationkit.jl_tpu_torch.ops.dia_spmv import (  # noqa: E402
    SOURCE as DIA_SOURCE, _c_offsets, _entry as dia_entry, dia_spmv_bytes,
    dia_spmv_flops, dia_spmv_plain)

# NVIDIA H100 SXM data sheet: HBM3 3.35 TB/s; FP64 34 TFLOP/s and FP32
# 67 TFLOP/s outside the tensor cores (neither kernel uses them)
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20    # the H100 SXM's L2 cache
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
NEWTON_TOL = 1e-7          # the continuation's Newton tolerance
OUT_DIR = os.path.join(ROOT, "chiprun_out")

DETAILS = {}


def phase(tag, **fields):
    DETAILS.setdefault(tag, []).append(fields)
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def smi_line(query="name,power.limit"):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# read beside the timing phases: device times follow the SM clock
CLOCKS = "clocks.sm,clocks.mem,power.draw,temperature.gpu"


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
    """One nvcc process per kernel source, started together."""
    t0 = time.perf_counter()
    libs = nvcc.build_libraries([sh_jv_mod.SOURCE, DIA_SOURCE])
    for so in libs:
        log = so.with_suffix(".log")
        ptxas = [ln.strip() for ln in log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln] \
            if log.exists() else []
        phase("build", seconds=round(time.perf_counter() - t0, 3),
              library=os.path.relpath(so, ROOT), ptxas=repr(ptxas))


def reset_launches():
    sh_jv_mod.sh_jv.launches = 0
    sh_jv_mod.sh_jv.launches_by_batch.clear()
    dia_spmv.launches = 0


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
    # the flagship grid at every batch size its path launches (GMRES's
    # K = 1, LOBPCG's 20, 40 and 60) and at 2, 59 and 61, and grids with N
    # or M in {1, 2, 3, 5} and tiles ragged on both axes
    cases = [((151, 100), 1), ((151, 100), 2), ((151, 100), 20),
             ((151, 100), 40), ((151, 100), 59), ((151, 100), 60),
             ((151, 100), 61), ((1024, 1024), 1),
             ((37, 23), 1), ((37, 23), 3), ((1, 1), 1), ((1, 7), 2),
             ((2, 5), 3), ((3, 130), 1), ((5, 2), 61), ((70, 1), 2),
             ((5, 3), 59), ((21, 130), 4), ((17, 65), 1)]
    worst_main, flagship_ks = 0.0, set()
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
                flagship_ks.add(K)
    return worst_main, flagship_ks


# (n, offsets, K): the Brusselator path's shape at K = 1 and 8, a ragged n,
# offsets far beyond any tile, 5 diagonals on 2^20 rows, n of 1 to 3, and
# more diagonals than one of the kernel's unrolled groups of 8 (12, and
# the most it takes, 32)
BRUSS_SITES = 128
PATH_OFFSETS = (-BRUSS_SITES, -1, 0, 1, BRUSS_SITES)
DIA_CASES = [(2 * BRUSS_SITES, PATH_OFFSETS, 1),
             (2 * BRUSS_SITES, PATH_OFFSETS, 8),
             (1000, (-37, -1, 0, 2, 999), 3),
             (20000, (-5000, -1, 0, 1, 5000), 1),
             (1 << 20, (-1024, -1, 0, 1, 1024), 1),
             (1, (0,), 1), (2, (-1, 0, 1), 2), (3, (-5, -2, 0, 1, 3), 1),
             (300, tuple(range(-6, 6)), 2),
             (777, tuple(range(-40, 40, 5)) + tuple(range(300, 1100, 50)), 3)]


def _dia_inputs(n, offsets, K, dtype, seed):
    """Random data, its out-of-band entries included, and K vectors."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    data = torch.as_tensor(rng.standard_normal((len(offsets), n)),
                           dtype=dtype, device=dev)
    v = torch.as_tensor(rng.standard_normal((K, n)), dtype=dtype, device=dev)
    return DIAMatrix(data, offsets), (v if K > 1 else v[0])


def compare_dia():
    worst_path = 0.0
    for dtype in (torch.float64, torch.float32):
        for i, (n, offsets, K) in enumerate(DIA_CASES):
            A, v = _dia_inputs(n, offsets, K, dtype, seed=10 + i)
            out = dia_spmv(A, v)
            torch.cuda.synchronize()
            ref = dia_spmv_plain(A, v)
            abs_err = float((out - ref).abs().max())
            rel = abs_err / float(ref.abs().max())
            phase("compare_dia", dtype=str(dtype).split(".")[-1], n=n,
                  offsets=list(offsets), K=K, max_abs_err=abs_err,
                  max_rel_err=rel, tol=TOL[dtype])
            if not (rel < TOL[dtype]):
                raise AssertionError(f"dia_spmv disagrees with its plain "
                                     f"version: {rel} >= {TOL[dtype]}")
            if n == 2 * BRUSS_SITES:
                worst_path = max(worst_path, abs_err)
    return max(worst_path, compare_dia_replaced())


def compare_dia_replaced():
    """A matrix at the path's shape whose `data` is replaced after its
    first product (on the matrix, by `dataclasses.replace`, in place, and
    by `data` of the other dtype): each product must be the plain one of
    what the matrix holds at the call."""
    worst = 0.0

    def check(how, M, w):
        out = M(w)
        torch.cuda.synchronize()
        ref = dia_spmv_plain(M, w)
        abs_err = float((out - ref).abs().max())
        rel = abs_err / float(ref.abs().max())
        tol = TOL[w.dtype]
        phase("compare_dia_replaced", dtype=str(w.dtype).split(".")[-1],
              replaced=how, max_abs_err=abs_err, max_rel_err=rel, tol=tol)
        if not (rel < tol):
            raise AssertionError(f"dia_spmv after its data was replaced "
                                 f"({how}): {rel} >= {tol}")
        return abs_err if w.dtype == torch.float64 else 0.0

    for dtype, other in ((torch.float64, torch.float32),
                         (torch.float32, torch.float64)):
        A, v = _dia_inputs(2 * BRUSS_SITES, PATH_OFFSETS, 1, dtype, seed=30)
        B, _ = _dia_inputs(2 * BRUSS_SITES, PATH_OFFSETS, 1, dtype, seed=31)
        A(v)
        object.__setattr__(A, "data", B.data.clone())
        worst = max(worst, check("set", A, v))
        worst = max(worst, check("dataclasses.replace",
                                 dataclasses.replace(A, data=2 * B.data), v))
        A.data.copy_(3 * B.data)
        worst = max(worst, check("in place", A, v))
        object.__setattr__(A, "data", A.data.to(other))
        worst = max(worst, check("other dtype", A, v.to(other)))
    return worst


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
    reset_launches()
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
    by_batch = dict(sorted(sh_jv_mod.sh_jv.launches_by_batch.items()))
    if launches <= 0:
        raise AssertionError("the main path never launched the sh_jv kernel")
    phase("main_path", steps_per_s=steps_per_s, warm_step_s=warm,
          sh_jv_launches=launches, sh_jv_launches_by_batch=by_batch,
          peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
          card=repr(card))
    return prob, state, launches, by_batch, steps_per_s


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


def _profiled_step(it, state, kernel, step_times):
    """One PALC step under torch.profiler after unprofiled steps that took
    `step_times` seconds: the card's busy time, its launches in all and of
    `kernel`, and the longest kernels.  The profiler's own host work slows
    the step it traces, so `idle_share` divides the busy time by the median
    unprofiled step; the share against the profiled step's own wall time is
    printed beside it, labelled as such.  Returns the fields and the busy
    seconds."""
    rows, wall = _profile(lambda: it.iterate(state))
    if not state.converged:
        raise AssertionError("the profiled PALC step did not converge")
    busy = sum(r[1] for r in rows) * 1e-6
    mine = [r for r in rows if f"{kernel}_kernel" in r[0]]
    step_s = float(np.median(step_times))
    missing = "not measured"
    return dict(
        median_unprofiled_step_s=step_s, profiled_step_s=wall, p=state.p,
        device_busy_s=busy if rows else missing,
        idle_share=(1 - busy / step_s) if rows else missing,
        idle_share_of_profiled_wall=(1 - busy / wall) if rows else missing,
        kernels=len(rows), launches=sum(r[2] for r in rows),
        **{f"{kernel}_calls": sum(r[2] for r in mine),
           f"{kernel}_device_s": sum(r[1] for r in mine) * 1e-6},
        top_kernels_ms=[(n[:70], round(us / 1e3, 3), c)
                        for n, us, c in rows[:8]]), busy if rows else None


def breakdown(it, state, timed_steps):
    """Where one warm flagship step goes: corrector against eigensolve on
    the host clock, then one profiled step (`_profiled_step`).  The
    profiled step may take more inner iterations than a timed one, so
    `idle_share_per_iteration` scales its busy time to the timed steps'
    inner iteration counts first."""
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

    fields, busy = _profiled_step(
        it, state, "sh_jv", [s["seconds"] for s in timed_steps])
    timed_wall = sum(s["seconds"] for s in timed_steps)
    timed_busy = None if busy is None else busy / max(state.itlinear, 1) \
        * sum(s["itlinear"] for s in timed_steps)
    phase("breakdown", corrector_s=t_corr, eig_s=t_eig,
          profiled_itlinear=state.itlinear,
          median_timed_itlinear=float(np.median(
              [s["itlinear"] for s in timed_steps])),
          idle_share_per_iteration=(1 - timed_busy / timed_wall)
          if busy is not None else "not measured", **fields)


# ---------------------------------------------------------------------------
# 4b. the Brusselator path: a DIA jacobian, shift-invert Arnoldi, Hopf
# ---------------------------------------------------------------------------

BRUSS_P_MAX = 0.55        # depth cut: the branch stops just past its Hopf
# the Hopf point of the 128-site branch, as the same code finds it on the CPU
BRUSS_HOPF_L = 0.5103642674


def brusselator_dia_jac_op(n):
    """User code: the Brusselator jacobian as a five-diagonal `DIAMatrix`
    (offsets -n, -1, 0, 1, n on the stacked (u, v) state), built on the
    state's device."""
    h = 1.0 / n

    def jac_op(uv, par):
        a, b, l = par["alpha"], par["beta"], par["l"]
        c1 = par["D1"] / (l ** 2 * h ** 2)
        c2 = par["D2"] / (l ** 2 * h ** 2)
        u, v = uv[:n], uv[n:]
        zero = torch.zeros_like(u)
        # rows whose neighbour lies in the other block couple to nothing
        idx = torch.arange(n, device=uv.device)
        first = (idx != 0).to(uv.dtype)
        last = (idx != n - 1).to(uv.dtype)
        data = torch.stack([
            torch.cat([zero, b - 2 * u * v]),                  # -n
            torch.cat([c1 * first, c2 * first]),               # -1
            torch.cat([-2 * c1 - (b + 1) + 2 * u * v, -2 * c2 - u * u]),
            torch.cat([c1 * last, c2 * last]),                 # +1
            torch.cat([u * u, zero]),                          # +n
        ])
        return DIAMatrix(data, (-n, -1, 0, 1, n))

    return jac_op


def brusselator_problem(n, device=None):
    prob = models.brusselator_1d(n=n, device=device)
    return prob.re_make(jac_op=brusselator_dia_jac_op(n))


def brusselator_config(n, max_steps=60):
    """The `ContinuationPar` of examples/brusselator.py:14-17 with a
    matrix-free GMRES and shift-invert Arnoldi; `p_max` cut to
    BRUSS_P_MAX."""
    ls = bk.GMRES(restart=2 * n, maxiter=4 * n, rtol=1e-11)
    eig = bk.ShiftInvertEig(
        sigma=0.0,
        eigsolver=bk.ArnoldiEig(which="LM", krylov_dim=30, restarts=3,
                                tol=1e-9),
        linsolver=bk.GMRES(restart=2 * n, maxiter=4 * n, rtol=1e-10))
    return bk.ContinuationPar(
        ds=0.01, dsmax=0.02, dsmin=1e-6, p_min=0.29, p_max=BRUSS_P_MAX,
        max_steps=max_steps, detect_bifurcation=3, nev=8, n_inversion=4,
        newton_options=bk.NewtonPar(tol=1e-9, linsolver=ls, eigsolver=eig))


def brusselator_path(card):
    n = BRUSS_SITES
    reset_launches()
    t0 = time.perf_counter()
    prob = brusselator_problem(n)                  # on the card
    cp = brusselator_config(n)
    rng = np.random.default_rng(0)
    guess = prob.u0 * torch.as_tensor(1 + 0.05 * rng.standard_normal(2 * n),
                                      device=prob.u0.device)
    sol = bk.newton(prob, cp.newton_options, x0=guess)
    torch.cuda.synchronize()
    if not sol.converged:
        raise AssertionError("Newton did not converge on the Brusselator")
    phase("bruss_newton", iterations=sol.itnewton, linear=sol.itlineartot,
          residual=float(sol.residuals[sol.itnewton]),
          seconds=round(time.perf_counter() - t0, 3))

    t1 = time.perf_counter()
    br = bk.continuation(prob.re_make(u0=sol.u), bk.PALC(), cp)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    launches = dia_spmv.launches
    for i in range(len(br)):
        phase("bruss_step", step=int(br["step"][i]), p=float(br.param[i]),
              n_unstable=int(br.n_unstable[i]),
              itnewton=int(br["itnewton"][i]),
              itlinear=int(br["itlinear"][i]))
    hopf = br.get_special_points("hopf")
    phase("bruss_continuation", steps=len(br) - 1,
          special=[(sp.type, sp.param, sp.status) for sp in br.specialpoint],
          seconds=seconds, total_seconds=time.perf_counter() - t0,
          dia_spmv_launches=launches,
          sh_jv_launches=sh_jv_mod.sh_jv.launches, card=repr(card))
    if not hopf or hopf[0].status != "converged":
        raise AssertionError("the Brusselator branch did not detect and "
                             "bisect a Hopf point")
    if not abs(hopf[0].param - BRUSS_HOPF_L) < 1e-8:
        raise AssertionError(f"the Hopf point moved: l = {hopf[0].param}, "
                             f"not {BRUSS_HOPF_L}")
    if launches <= 0:
        raise AssertionError("the Brusselator path never launched the "
                             "dia_spmv kernel")
    bruss_breakdown(prob.re_make(u0=sol.u), cp)
    return launches, seconds


def bruss_breakdown(prob, cp, unprofiled=2):
    """One profiled Brusselator step (`_profiled_step`) after `unprofiled`
    timed ones."""
    it = ContIterable(prob, bk.PALC(), cp)
    state = it.init_state()
    times = []
    for _ in range(unprofiled):
        t = time.perf_counter()
        it.iterate(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    fields, _ = _profiled_step(it, state, "dia_spmv", times)
    phase("bruss_breakdown", unprofiled_step_s=times, **fields)


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


def check_bruss_small(n=32):
    """The same Brusselator branch at 32 sites on the card (kernel) and on
    the CPU (plain version) agrees."""
    rows = {}
    threads = torch.get_num_threads()
    for dev in ("cuda", "cpu"):
        torch.set_num_threads(1)          # small tensors: threads contend
        rows[dev] = interop.branch_to_numpy(bk.continuation(
            brusselator_problem(n, dev), bk.PALC(), brusselator_config(n)))
        torch.set_num_threads(threads)
    same_len = len(rows["cuda"]["p"]) == len(rows["cpu"]["p"])
    dp = float(np.abs(rows["cuda"]["p"] - rows["cpu"]["p"]).max()) \
        if same_len else float("inf")
    same_n = same_len and bool(np.array_equal(rows["cuda"]["n_unstable"],
                                              rows["cpu"]["n_unstable"]))
    same_sp = list(rows["cuda"]["sp_type"]) == list(rows["cpu"]["sp_type"])
    phase("check_bruss_branch", sites=n, max_abs_dp=dp,
          same_n_unstable=same_n, same_special_types=same_sp,
          special=[(str(t), float(p)) for t, p in
                   zip(rows["cuda"]["sp_type"], rows["cuda"]["sp_p"])])
    if not (dp < 1e-8 and same_n and same_sp
            and "hopf" in list(rows["cuda"]["sp_type"])):
        raise AssertionError("32-site Brusselator branch on the card "
                             "disagrees with the CPU")


# ---------------------------------------------------------------------------
# 6. timing
# ---------------------------------------------------------------------------


def _time(fn, reps):
    """Milliseconds per call on CUDA events over back-to-back calls: the
    wrapper's time, the host's or the card's, whichever is longer."""
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


def _host_time(fn, reps):
    """Milliseconds per call on the host clock over calls with no sync:
    the host's share of a call."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e3


def _device_time(fn, name="", calls=100):
    """Milliseconds per call of fn on the card alone (torch.profiler): the
    summed time of the kernels whose name holds `name`, over `calls`
    calls."""
    for _ in range(3):          # the profiler now and then records no kernel
        rows, _ = _profile(lambda: [fn() for _ in range(calls)])
        mine = [r for r in rows if name in r[0]]
        if mine:
            return sum(r[1] for r in mine) / 1e3 / calls
    return "not measured"


def _cold_copies(nbytes):
    """Copies of a call's inputs that, called in turn, pass three times
    the L2 cache's size through it between two calls on the same copy,
    so that each call reads its inputs from HBM; 0 where a call moves
    under 1 MiB and its time is the launch's."""
    return 0 if nbytes < 2 ** 20 else -(-3 * L2_BYTES // nbytes)


def _in_turn(fns):
    """One call of the next of `fns` at each call."""
    turn = itertools.cycle(fns)
    return lambda: next(turn)()


def _bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _host_split(alloc, c_call, launch, wrapper, reps):
    """Where a wrapper's host time goes: the output's allocation, the
    ctypes call with the CUDA launch in it, the raw stream and device
    queries of `nvcc.launch` around it, and the rest (checks, counters,
    Python calls)."""
    t_alloc, t_call = _host_time(alloc, reps), _host_time(c_call, reps)
    t_launch, t_wrap = _host_time(launch, reps), _host_time(wrapper, reps)
    return dict(alloc_ms=t_alloc, c_call_ms=t_call,
                stream_and_device_ms=t_launch - t_call,
                checks_and_rest_ms=t_wrap - t_launch - t_alloc)


def device_floor():
    """The card's own time for a one-element `add_`: the least a kernel
    launch takes on this card, and the floor of every device time below."""
    one = torch.zeros(1, device="cuda")
    floor = dict(launch_floor_ms=_time(lambda: one.add_(0), 2000),
                 device_floor_ms=_device_time(lambda: one.add_(0)))
    phase("device_floor", clocks=smi_line(CLOCKS), **floor)
    return floor


def time_kernel(floor):
    cases = []
    for shape, K in (((151, 100), 1), ((151, 100), 60), ((1024, 1024), 1)):
        for dtype in (torch.float32, torch.float64):
            u, v, scal = _inputs(shape, K, dtype, seed=7)
            vv = v if K > 1 else v[0]
            op = sh_jv_mod.sh_jv_operator(u, scal)     # the jac_op route
            reps = 2000 if shape == (151, 100) and K == 1 else 300

            def kern():
                return sh_jv_mod.sh_jv(u, vv, scal)

            def oper():
                return op(vv)

            def plain():
                return sh_jv_mod.sh_jv_plain(u, vv, scal)

            # in turns: kernel, operator, plain, then again
            tk1, to1, tp1 = _time(kern, reps), _time(oper, reps), \
                _time(plain, reps)
            tk2, to2, tp2 = _time(kern, reps), _time(oper, reps), \
                _time(plain, reps)
            N, M = shape
            case = dict(dtype=str(dtype).split(".")[-1],
                        shape=f"{N}x{M}", K=K, ms=(tk1 + tk2) / 2,
                        operator_ms=(to1 + to2) / 2,
                        host_ms=_host_time(kern, reps),
                        operator_host_ms=_host_time(oper, reps),
                        device_ms=_device_time(kern, "sh_jv_kernel"),
                        plain_ms=(tp1 + tp2) / 2,
                        plain_device_ms=_device_time(plain),
                        **_bound(sh_jv_mod.sh_jv_bytes(N, M, K,
                                                       u.element_size()),
                                 sh_jv_mod.sh_jv_flops(N, M, K), dtype),
                        **floor,
                        library="none: no single PyTorch call computes SH J.v")
            copies = _cold_copies(sh_jv_mod.sh_jv_bytes(N, M, K,
                                                        u.element_size()))
            if copies:
                calls = []
                for c in range(copies):
                    uc, vc, sc = _inputs(shape, K, dtype, seed=100 + c)
                    calls.append(functools.partial(
                        sh_jv_mod.sh_jv, uc, vc if K > 1 else vc[0], sc))
                case.update(cold_copies=copies, device_cold_ms=_device_time(
                    _in_turn(calls), "sh_jv_kernel"))
            if K == 1 and shape == (151, 100):
                fn = sh_jv_mod._entry(dtype)
                out = torch.empty_like(vv)
                args = (u.data_ptr(), vv.data_ptr(), scal.data_ptr(),
                        out.data_ptr(), N, M, 1)
                stream = torch.cuda.current_stream().cuda_stream
                case["operator_host_split"] = _host_split(
                    lambda: torch.empty_like(vv), lambda: fn(*args, stream),
                    lambda: nvcc.launch(fn, u.get_device(), *args), oper,
                    reps)
            cases.append(case)
            phase("timing", **case)
    return cases


def _csr_of(A):
    """The same matrix as a PyTorch sparse CSR tensor (in-band entries
    only), for the cuSPARSE yardstick."""
    n = A.data.shape[1]
    i = torch.arange(n, device=A.data.device)
    rows, cols, vals = [], [], []
    for k, off in enumerate(A.offsets):
        j = i + off
        m = (j >= 0) & (j < n)
        rows.append(i[m])
        cols.append(j[m])
        vals.append(A.data[k][m])
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (n, n))
    return coo.coalesce().to_sparse_csr()


def time_dia(floor):
    cases = []
    for n, offsets in ((2 * BRUSS_SITES, PATH_OFFSETS),
                       (1 << 20, (-1024, -1, 0, 1, 1024))):
        for dtype in (torch.float32, torch.float64):
            A, v = _dia_inputs(n, offsets, 1, dtype, seed=7)
            csr = _csr_of(A)
            reps = 2000 if n < 4096 else 300

            def kern():
                return dia_spmv(A, v)

            def plain():
                return dia_spmv_plain(A, v)

            def library():
                return csr @ v

            ref = plain()
            lib_rel = float((library() - ref).abs().max() / ref.abs().max())
            # in turns: kernel, plain, library, then again
            tk1, tp1, tl1 = _time(kern, reps), _time(plain, reps), \
                _time(library, reps)
            tk2, tp2, tl2 = _time(kern, reps), _time(plain, reps), \
                _time(library, reps)
            case = dict(dtype=str(dtype).split(".")[-1], n=n,
                        offsets=list(offsets), K=1, ms=(tk1 + tk2) / 2,
                        host_ms=_host_time(kern, reps),
                        device_ms=_device_time(kern, "dia_spmv_kernel"),
                        plain_ms=(tp1 + tp2) / 2,
                        plain_device_ms=_device_time(plain),
                        library_ms=(tl1 + tl2) / 2,
                        library_host_ms=_host_time(library, reps),
                        library_device_ms=_device_time(library),
                        library="cuSPARSE CSR SpMV (torch sparse_csr @ v)",
                        library_max_rel_err=lib_rel,
                        **_bound(dia_spmv_bytes(n, offsets, 1,
                                                v.element_size()),
                                 dia_spmv_flops(n, offsets, 1), dtype),
                        **floor)
            copies = _cold_copies(dia_spmv_bytes(n, offsets, 1,
                                                 v.element_size()))
            if copies:
                kerns, libs = [], []
                for c in range(copies):
                    Ac, vc = _dia_inputs(n, offsets, 1, dtype, seed=100 + c)
                    kerns.append(functools.partial(dia_spmv, Ac, vc))
                    libs.append(functools.partial(torch.matmul, _csr_of(Ac),
                                                  vc))
                case.update(cold_copies=copies, device_cold_ms=_device_time(
                    _in_turn(kerns), "dia_spmv_kernel"),
                    library_device_cold_ms=_device_time(_in_turn(libs)))
            if n == 2 * BRUSS_SITES:
                fn, out = dia_entry(dtype), torch.empty_like(v)
                args = (A.data.data_ptr(), _c_offsets(offsets)[1],
                        len(offsets), v.data_ptr(), out.data_ptr(), n, 1)
                stream = torch.cuda.current_stream().cuda_stream
                case["host_split"] = _host_split(
                    lambda: torch.empty_like(v), lambda: fn(*args, stream),
                    lambda: nvcc.launch(fn, v.get_device(), *args), kern,
                    reps)
            cases.append(case)
            phase("timing_dia", **case)
    return cases


def main():
    card = check_device()
    build()
    max_abs_err, compared_ks = compare_kernel()
    dia_abs_err = compare_dia()
    prob, state, launches, by_batch, steps_per_s = main_path(card)
    unchecked = sorted(set(by_batch) - compared_ks)
    if unchecked:
        raise AssertionError(f"the flagship launched sh_jv at K = "
                             f"{unchecked}, which no compare case checks")
    dia_launches, bruss_seconds = brusselator_path(card)
    check_outputs(prob, state)
    check_bruss_small()
    floor = device_floor()
    cases = time_kernel(floor)
    dia_cases = time_dia(floor)
    phase("clocks_after_timing", clocks=smi_line(CLOCKS))
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    head = next(c for c in cases
                if c["shape"] == "151x100" and c["K"] == 1
                and c["dtype"] == "float32")
    # the Brusselator path runs in f64 at 256 unknowns
    dhead = next(c for c in dia_cases
                 if c["n"] == 2 * BRUSS_SITES and c["dtype"] == "float64")
    kernels = [{
        "name": "sh_jv", "route": "cuda",
        "source": "bifurcationkit/jl_tpu_torch/csrc/sh_jv.cu",
        "replaces": "bifurcationkit/jl_tpu/ops/pallas_sh.py:111",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,       # no single PyTorch call computes SH J.v
        "host_ms": head["host_ms"], "operator_ms": head["operator_ms"],
        "operator_host_ms": head["operator_host_ms"],
        "device_ms": head["device_ms"],
        "device_floor_ms": floor["device_floor_ms"],
        "launches_by_batch": by_batch,
        "cases": cases,
    }, {
        "name": "dia_spmv", "route": "cuda",
        "source": "bifurcationkit/jl_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "bifurcationkit/jl_tpu/ops/pallas_spmv.py:75",
        "launches": dia_launches, "max_abs_err": dia_abs_err,
        "ms": dhead["ms"], "plain_ms": dhead["plain_ms"],
        "bound_ms": dhead["bound_ms"], "bound_by": dhead["bound_by"],
        "library_ms": dhead["library_ms"],
        "host_ms": dhead["host_ms"], "device_ms": dhead["device_ms"],
        "device_floor_ms": floor["device_floor_ms"],
        "library_host_ms": dhead["library_host_ms"],
        "library_device_ms": dhead["library_device_ms"],
        "cases": dia_cases,
    }]
    DETAILS["kernels"] = kernels
    DETAILS["steps_per_s"] = steps_per_s
    DETAILS["brusselator_seconds"] = bruss_seconds
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
