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
   product must read what the matrix holds at the call); the SH J.v's
   periodic closure (`compare_periodic`) at 512x512 with every batch size
   the periodic SH2d launches and one past each, at the flagship grid and
   at odd and tiny grids; its halo-row closure (`compare_halo`, the row
   block of parallel/halo.py::sharded_sh_jv): 152x100 split into 2, 4
   and 8 row blocks, 37x23 into 3 and 6x23 into 3 blocks of 2 rows, each
   block given its neighbours' rows and the global-edge flags, against
   the whole-field Neumann kernel and the plain version of each block, at
   every batch size the `parallel` phase launches and one past it;
3b. `parallel`, the multi-device path (jl_tpu_torch/parallel): 2 ranks
   on the one card, spawned as processes of their own in one gloo group;
   gloo moves CPU tensors only, so halos, reductions and gathers go
   through pinned host buffers while every kernel and all compute stay on
   the card (no GPU-to-GPU collective is exercised). Each rank runs legs
   1-7 of the dry run (parallel/dryrun.py, after __graft_entry__.py::
   dryrun_multichip): the Brusselator Newton and PALC corrector (and one
   more on a secant tangent whose u-part is not zero), 3 SH2d
   steps with detection, the time-sharded COP solve and monodromy tree
   product of the Stuart-Landau PO (leg 3), at the flagship's 152x100
   the halo'd J.v against the single-device one (1e-10) and one
   continuation step with detection, every J.v through `sh_jv`'s halo
   closure (leg 4), the time-sharded PO-MA corrector solve of the
   zero-Hopf NS problem (leg 5), the Brusselator PO's COP solve on a
   2 x 1 time x space mesh and its space-sharded matrix-free trapezoid
   monodromy apply (leg 6), and the sharded matrix-free fold MA sigma
   system and Govaerts apply (leg 7); then the row-partitioned DIA SpMV
   at the Brusselator path's shape against the single-device kernel and
   the plain version (1e-12). A second spawn of 4 ranks on the card runs
   leg 6 on a real 2 x 2 mesh. The same legs on one device on the card:
   legs 1, 2, 4: p to 1e-8, the same detection counts, leg 1's states to
   1e-8; legs 3, 5-7 (and leg 6 at 2 x 2): every solution and apply to
   1e-8 relative, the same GMRES iterations, and neither kernel launched.
   Prints the seconds per leg, each spawn's start time, the Newton and
   GMRES iterations, the transport and the halo launches by (dtype, K);
   fails on a (dtype, K) that compare_halo does not check, or if a rank
   fails. compare_halo and parallel take at most 90 s together (printed);
4. main paths, each with every kernel's launch count reset just before it
   and read just after:
   a. the SH2d-fronts flagship at 151x100 — Newton, then PALC through
      `ContIterable` (2 warm-up + 4 timed steps) and `continuation()` with
      bifurcation detection up to the step just past the branch's first
      branch point (FLAGSHIP_BP_STEPS) — and one profiled step (busy
      time, idle share, longest kernels); the `sh_jv` launches split by
      batch size;
   b. `flagship_bp`: the matrix-free normal form at that branch point
      (examples/sh2d_fronts.py:106-131) through the kernel — its type,
      coefficients, seconds, `sh_jv` launches by batch size and GMRES
      iterations per bordered solve — held against the same normal form
      with J.v through the plain version to 1e-8; then branch switching
      there with the example's parameters, ABS_STEPS steps
      (`multicontinuation` where the kernel is 2d), every step converged to |F| <= 1e-7 and the first
      point off the primary branch;
   c. the Brusselator at 128 sites (256 unknowns) with its jacobian as a
      five-diagonal `DIAMatrix` — Newton from a perturbed guess, then PALC
      with GMRES and shift-invert Arnoldi sweeps that detect and bisect
      the Hopf point (at l = 0.5103642674 to 1e-8), with `p_max` cut just
      past it — and one profiled step;
   d. `bruss_hopf_nf`: the Hopf normal form there, matrix-free through
      the DIA kernel, dense, and matrix-free on the CPU from the same
      point: a and b card against CPU to 1e-8, omega to 1e-9, one subtype,
      a finite period;
   e. `flagship_fold`: the flagship branch continued (GMRES, no
      eigensolves) to the step just past its first fold
      (FLAGSHIP_FOLD_STEPS), then the matrix-free minimally augmented
      fold curve in nu there (examples/sh2d_fronts.py:143-176, bench.py's
      `ma_mf`): 1 warm and 2 timed steps through the kernel — steps/s,
      the anchors' bootstrap, extended solves and GMRES iterations per
      step, GMRES iterations per solve, `sh_jv` launches by batch size —
      then one more of the curve's own steps under torch.profiler (busy
      time, idle share, longest kernels); sigma recomputed with fresh
      random borders on and off the curve at its first, middle and last
      points; the first FOLD_PLAIN_STEPS steps again with J.v through the
      plain version,
      (nu, l) to 1e-8;
   f. `bruss_hopf_curve`: the matrix-free Hopf curve in beta from the
      128-site Brusselator's Hopf point (examples/brusselator.py:24-27,
      cut to BRUSS_HOPF_STEPS steps) through the DIA kernel, with the GH
      monitor on: every step converged, a host eig of the dense jacobian
      at 3 points with its critical pair on the imaginary axis at omega
      to 1e-6, and the same curve on the CPU: (beta, l, omega) to 1e-8;
      the first Lyapunov coefficient dense on the host at every point
      (the converged witness), matrix-free on the card and on the CPU at
      3 points to 1e-6 relative of it, and a GH or ZH label where, and
      only where, the witness changes sign;
   g. `po_cgl`: the cGL2d trapezoid periodic orbits of bench.py:620-700
      at full width (41x21, M = 51: 87,823 unknowns) with the bench's
      CPU-leg solvers (f64 throughout): the matrix-free Hopf normal form
      at the exact Hopf point and its predictor, the space-time spectral
      preconditioner, Floquet by `FloquetQaDMF(SubspaceEig)` over the
      matrix-free monodromy (a batched GMRES solve per slice); 1 warm and
      2 timed steps (steps/s, Newton and GMRES iterations, monodromy
      applications and inner matvecs per Floquet sweep), one more step
      under torch.profiler (`po_breakdown`), the launches of one
      application of each preconditioner and of the monodromy; checks:
      every step converged (Newton 1e-7, none retried), the last point's
      residual recomputed <= 1e-7, the period within 5 % of T0, the
      multipliers against the dense trapeze monodromy built on the card
      and eigensolved on the host: the two dominant ones of the bench's
      SubspaceEig, and all 8 of a SubspaceEig with 4 sweeps, 4 blocks and
      8 guard vectors from the same warm block, both ways, to 1e-4 (the
      bench's settings leave the rest of a cluster of multipliers near
      0.0102 unconverged); the trivial one within 1e-3 of 1; the same
      unstable count; neither kernel launched; then the same
      leg at 21x11 for 1 step on the card and on the CPU (`po_cgl_small`:
      (r, T) to 1e-7 relative, multipliers to 1e-5);
   h. `po_bruss`: the collocation periodic orbits of bench.py:373-438
      (BENCH_KIND=po) at full width: the 128-site Brusselator's Hopf
      point and its dense normal form (phases c and d), the predictor at
      ds 0.02, Collocation(Ntst=30, m=4) (30,977 unknowns), COPLS and
      COPBLS, FloquetColl through the engine's two-stage eig, f64; 1 warm
      and 3 timed steps (steps/s, Newton iterations, seconds per step in
      the per-node jacobians, stage 1, the external solve and the Floquet
      reduction plus host eig), one more under torch.profiler; checks:
      every step converged, the last residual recomputed <= 1e-7, the
      period within 5 % of 2 pi / omega, FloquetColl's 8 multipliers
      against the dense collocation monodromy to 1e-6 both ways, the
      trivial one within 1e-4 of 1, the same unstable count, neither
      kernel launched; then the leg at 32 sites (7,745 unknowns) for 3
      steps on the card and on the CPU ((l, T) to 1e-9 relative,
      multipliers to 1e-8) and FloquetGEV against FloquetColl to 1e-6 at
      16 sites;
   i. `po_bruss_shooting`: examples/brusselator_shooting.py at its 40
      sites: standard shooting (Shooting(M=3, 40 steps, rodas3), dense
      Newton with line search, 4 steps) on the card and the CPU ((l, T)
      to 1e-8 relative, multipliers to 1e-6), its first period within 0.1
      of 2 pi / omega, the Collocation(20, 4) + COP branch's periods
      within 1e-3; event-driven Poincare shooting from its last orbit
      (converged, period within 1e-3); the collocation orbit on
      Shooting(M=5, 150 steps) solved by `newton_po`, its matrix-free
      monodromy with J.v by `brusselator_dia_jac_op` (one `dia_spmv`
      launch per stage on the block's columns) against the same operator
      through torch.func.jvp and the dense monodromy to 1e-10 relative,
      FloquetQaDMF(SubspaceEig) on it against FloquetColl's 4 leading
      multipliers to 1e-4, the kernel's launches per application and,
      over one segment, their device time;
   j. `codim2_bt_pde`: the PDE Bogdanov-Takens model at 40x40 (3,200
      unknowns, f64), every plain J.v through dia_spmv (its Neumann
      Laplacian as one DIAMatrix, both fields in one launch): the branch
      in b1 to its fold, the matrix-free fold curve in b2 with the BT
      event, `get_normal_form_codim2` (matrix-free), `bt_unfolding` and
      the homoclinic predictor at the exact BT, `switch_codim2` to the
      matrix-free Hopf curve (6 steps, the last under torch.profiler);
      the exact geometry (b1 = b2^2/4, a = 1/40 = -b, K11 = [0, 2], the
      Hopf curve b1 = 0 with omega^2 = -b2), the forms again through
      dia_spmv_plain on the card and on the CPU to 1e-8;
   k. `codim2_zh_pde`: the fold-Hopf PDE at 32x32 (3,072 unknowns) the
      same way: the branch to its fold, the fold curve in a (p1 = 0) with
      the ZH event, its matrix-free form (G200 = 2/32, G110 = 1/32,
      G011 = 0), `switch_codim2` to the Hopf curve p1 = -a^2 at
      omega = 1, the form through the plain version and on the CPU;
   l. `po_bvam`: the BVAM period-doubling PDE of examples/pd_1d.py at its
      N = 100 (f64, its Neumann Laplacian one DIAMatrix through
      dia_spmv, both fields in one launch): Newton, the equilibrium
      branch in C (Hopf within 5e-3 of -0.867), the collocation PO branch
      (Collocation(30, 4), 24,201 unknowns, COP, FloquetColl) with >= 2
      PD points (the first within 2e-2 of -1.327; the dense monodromy's
      multiplier within 1e-2 of -1), `period_doubling_iooss` there (dense
      collocation operators; its peak memory), `pd_branch_switch` onto
      the period-2 branch (48,201 unknowns, 4 steps: halves differ by
      > 0.1, period within 0.2 of 2T) and the functional PD curve in D
      (24,202 unknowns, 3 steps: D moved by > 5e-4, FloquetColl's
      multiplier within 5e-2 of -1 at the last point), with seconds per
      part, Newton iterations and dia_spmv launches by rows (sh_jv none);
      one PD-curve step under torch.profiler (`po_bvam_breakdown`); the
      sigma gradient at the curve's first point against torch.func
      through the plain jacobian (1e-8, no launch under autodiff), the
      model's J.v through the kernel against the plain version (1e-12)
      and the Iooss form at the same PD recomputed with every J.v through
      the plain version (a and b3 to 1e-8);
   m. the model zoo (section 4m), each phase with the launch counts
      reset just before it and read just after, 240 s together at most
      (printed): `sh_periodic`, bench.py's BENCH_KIND=cuda_analog at its
      512x512 (262,144 unknowns, f64) on its accelerator branch — Newton
      to 5e-7, 2 warm + 4 timed PALC steps with LOBPCG detection, one
      profiled step, every J.v through `sh_jv`'s periodic closure (its
      launches by dtype and K; the Neumann closure never), the kernel at
      the Newton point against its plain version (f64 1e-12, f32 1e-5)
      and the FFT preconditioner as the exact inverse (1e-10);
      `check_sh_periodic`, test_sh_periodic.py's N = 64 on the card and
      the CPU (p to 1e-8, equal counts; the card's spectrum against
      ARPACK's shift-invert on the scipy.sparse assembly to 1e-5);
      `sh3d`, examples/sh3d.py at N = 22 for 8 steps (its first Newton on
      the CPU), and at N = 10 Newton and the dense spectrum card against
      CPU to 1e-8; `sh1d_snaking`, the flat branch at n = 200 with its
      five bifurcations at the exact thresholds to 2e-3 and its first 30
      steps against the CPU's (p to 1e-9, the same types); `wave`, the
      Nagumo front and the two-generator cGL pulse of test_wave_bvp.py
      (exact speeds, far fields, two zero modes) card against CPU to
      1e-9; `bvp`, the Duffing resonance curve (400 steps; its folds
      within 2e-2 of 0.7416 and 2.4608, t(1) = 1 to 1e-8; its first 6
      steps against the CPU's), the Bratu fold by `newton_fold` on
      collocation (card and CPU) and shooting within 5e-5 of
      3.513830719, the condensed BVP solve against the dense one to
      1e-10; `io_native`, branch files written and read back, a
      `BranchLog` round trip and the host converters of the compiled
      native library;
5. check: the flagship's last point is a finite root of F, a 60x40 SH
   branch and a 32-site Brusselator branch on the card match the same
   branches on the CPU, the matrix-free normal form at the 60x40
   branch's first bp on the card matches the CPU's to 1e-8, and small
   codim-2 curves (the cusp's fold curve dense and matrix-free, the exact
   Hopf curve of z' = (p + q + i) z - z|z|^2 matrix-free) on the card
   match the CPU's to 1e-9, as does the dense codim-2 family (Lorenz-84's
   ZH form and its switched fold curve, the CO model's BT and cusp forms
   and l2, the BT model's switched Hopf curve, the two-oscillator model's
   other Hopf curve, the quintic Bautin unfolding), coefficients to 1e-8;
   the two PDE phases and this one take at most 150 s together; then
   the small periodic-orbit codim-2 family (`check_small_po_codim2`) on
   the card against the CPU, curves to 1e-9 and coefficients to 1e-8:
   Lur'e's PD curve with the codim-3 monitor (gpd, cusp, R2), its PD
   switch on Collocation, Trapeze and Shooting and its return-map and
   Iooss forms; Freire's BP switch with NS and PD, the NS Iooss form and
   a 3-step NS curve; `switch_codim2_po` from the constructed Bautin and
   zero-Hopf models to their closed-form curves (1e-7, 1e-6) and from
   Lorenz-84's ZH; the BVAM flow at N = 10 with its dense Iooss form;
   po_bvam and this take at most 240 s together (printed);
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
   a yardstick only (SpMM at the codim-2 PDE shapes, K = 2 and 3, and at
   the BVAM path's, n = 100 with 240 and 400 rows).  At K = 1 on the
   flagship grid and at the Brusselator path's shape the host time is
   split into its parts: the output's allocation, the ctypes call (with
   the CUDA launch in it), and the stream and device queries around it;
   the SH J.v's periodic closure at 512x512 (K = 1 in f32 and f64, and
   LOBPCG's K = 15 in f32), beside the Neumann closure at the same
   shapes; its halo closure on a rank's block of the dry run's 152x100
   (76x100, K = 1, f32 and f64, the top a global edge and 2 halo rows
   below), beside the Neumann closure on the whole 152x100.

Then each part's seconds on the host clock (`wall`), the nvidia-smi line,
one JSON line listing the kernels (po_cgl and po_bruss launch neither:
their count is 0 in each kernel's `launches_by_phase`; po_bruss_shooting,
the codim-2 PDE phases and po_bvam launch dia_spmv only), and the final
JSON line.  Full details
go to chiprun_out/chip_smoke.json.
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
from bifurcationkit.jl_tpu_torch.codim2 import (  # noqa: E402
    minaug, minaug_mf)
from bifurcationkit.jl_tpu_torch.codim2.unfolding import (  # noqa: E402
    _codim2_point_context)
from bifurcationkit.jl_tpu_torch.continuation.engine import (  # noqa: E402
    ContIterable)
from bifurcationkit.jl_tpu_torch.core.state import BorderedState  # noqa: E402
from bifurcationkit.jl_tpu_torch.linalg import linear  # noqa: E402
from bifurcationkit.jl_tpu_torch.ops import (  # noqa: E402
    DIAMatrix, dia_spmv, nvcc)
from bifurcationkit.jl_tpu_torch.ops import sh_jv as sh_jv_mod  # noqa: E402
from bifurcationkit.jl_tpu_torch.ops.dia_spmv import (  # noqa: E402
    SOURCE as DIA_SOURCE, _c_offsets, _entry as dia_entry, dia_spmv_bytes,
    dia_spmv_flops, dia_spmv_plain)

# the wave and BVP fixtures of the JAX package's tests, in PyTorch
sys.path.insert(0, os.path.join(ROOT, "tests"))
from _bvp_wave_models import (  # noqa: E402
    BRATU_FOLD, bratu, cgl_pulse, duffing, nagumo)

# NVIDIA H100 SXM data sheet: HBM3 3.35 TB/s; FP64 34 TFLOP/s and FP32
# 67 TFLOP/s outside the tensor cores (neither kernel uses them)
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20    # the H100 SXM's L2 cache
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
NEWTON_TOL = 1e-7          # the continuation's Newton tolerance
# the step just past the flagship branch's first branch point, a 2d one
# at l = -0.2155085 on the H100; the example runs at most 60 steps
# (examples/sh2d_fronts.py)
FLAGSHIP_BP_STEPS = 11
# the step just past the first fold of the flagship branch continued
# with bench.py's CPU-leg settings (GMRES, no eigensolves): the fold at
# l = -0.2151245 (recorded at step 10) is detected after step 11 on the
# H100; the bench runs at most 60 steps
FLAGSHIP_FOLD_STEPS = 11
FOLD_WARM, FOLD_TIMED = 1, 2   # fold-curve steps (bench.py's ma_mf: 30)
# depth cuts for the 1,200 s limit (PR 11, beside the parallel phase): the
# aBS steps after the flagship's branch point (6 before), the fold curve's
# steps again through the plain J.v (2 before)
ABS_STEPS = 4
FOLD_PLAIN_STEPS = 1
CODIM2_TOL = 1e-8          # curves through a kernel against a reference
# depth cut of the Brusselator's Hopf curve (examples/brusselator.py runs
# it to beta = 10.5): 3 steps (6 until PR 9, 4 in PR 10), so that the
# script keeps its time limit; the dense-eig and l1 witnesses are taken at
# every point after the first (3 points, as at 4 steps)
BRUSS_HOPF_STEPS = 3
L1_RTOL = 1e-6             # l1 through a kernel against the dense witness
NF_KEYS = ("a01", "b11", "b20", "b30")
NF_INDICES = {"a01": 1, "b11": 2, "b20": 3, "b30": 4}
NF_RTOL = 1e-8             # normal-form coefficients, relative to max(|c|, 1)
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
    sh_jv_mod.sh_jv.launches_by_case.clear()
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


# the periodic closure: the 512x512 path at every (dtype, K) it launches
# (GMRES's K = 1; LOBPCG's blocks of 15 = 11 + 4 fields, its f32 sweeps
# on 3 blocks, 45, and its f64 Rayleigh-Ritz on 2, 30) and one past each,
# the
# flagship grid, and grids with N or M in {1, 2, 3, 5}, where the wrap
# meets itself inside the halo
PERIODIC_CASES = [((512, 512), 1), ((512, 512), 2), ((512, 512), 15),
                  ((512, 512), 16), ((512, 512), 30), ((512, 512), 31),
                  ((512, 512), 45), ((512, 512), 46),
                  ((151, 100), 1), ((151, 100), 15), ((37, 23), 3),
                  ((1, 1), 1), ((1, 7), 2), ((2, 5), 3), ((3, 130), 1),
                  ((5, 2), 15), ((70, 1), 2), ((21, 130), 4)]


def compare_periodic():
    """`sh_jv(..., closure="periodic")` against its plain version (the
    closure's own entry points) on the card, f64 and f32."""
    worst, path_cases = 0.0, set()
    for dtype in (torch.float64, torch.float32):
        for i, (shape, K) in enumerate(PERIODIC_CASES):
            u, v, scal = _inputs(shape, K, dtype, seed=50 + i)
            vv = v if K > 1 else v[0]
            out = sh_jv_mod.sh_jv(u, vv, scal, closure="periodic")
            torch.cuda.synchronize()
            ref = sh_jv_mod.sh_jv_plain(u, vv, scal, closure="periodic")
            abs_err = float((out - ref).abs().max())
            rel = abs_err / float(ref.abs().max())
            phase("compare_periodic", dtype=str(dtype).split(".")[-1],
                  shape=f"{shape[0]}x{shape[1]}", K=K, max_abs_err=abs_err,
                  max_rel_err=rel, tol=TOL[dtype])
            if not (rel < TOL[dtype]):
                raise AssertionError(f"sh_jv's periodic closure disagrees "
                                     f"with its plain version: {rel}")
            if shape == (SHP_N, SHP_N):
                worst = max(worst, abs_err)
                path_cases.add((str(dtype).split(".")[-1], K))
    return worst, path_cases


# (n, offsets, K): the Brusselator path's shape at K = 1 and 8, a ragged n,
# offsets far beyond any tile, 5 diagonals on 2^20 rows, n of 1 to 3, and
# more diagonals than one of the kernel's unrolled groups of 8 (12, and
# the most it takes, 32)
BRUSS_SITES = 128
PATH_OFFSETS = (-BRUSS_SITES, -1, 0, 1, BRUSS_SITES)
# the codim-2 PDE paths' shapes: the 40 x 40 BT model's Laplacian on its 2
# fields (n = 1,600, offsets 0, +-1, +-40) and the 32 x 32 fold-Hopf
# model's on its 3 (n = 1,024, offsets 0, +-1, +-32), one state or two
PDE_DIA = [(40 * 40, (0, 1, -1, 40, -40), 2),
           (32 * 32, (0, 1, -1, 32, -32), 3)]
# the BVAM path's (po_bvam, N = 100): one Laplacian on the 2 fields of
# each state; 400 rows (J.v on the identity's 200 columns: the per-node
# jacobians of COP, FloquetColl, the Iooss operators and the dense
# equilibrium jacobian), 240 (J.v at the 120 Gauss states of the sigma
# gradient), 242 (at the 121 nodes of the Iooss form)
BVAM_OFFSETS = (0, 1, -1)
BVAM_DIA_ROWS = (240, 242, 400)
BVAM_DIA = [(100, BVAM_OFFSETS, K) for K in BVAM_DIA_ROWS]
DIA_CASES = [(2 * BRUSS_SITES, PATH_OFFSETS, 1),
             (2 * BRUSS_SITES, PATH_OFFSETS, 8),
             *PDE_DIA, *[(n, off, 2 * K) for n, off, K in PDE_DIA],
             *BVAM_DIA,
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
            if n == 2 * BRUSS_SITES or (n, offsets) in [
                    c[:2] for c in PDE_DIA + BVAM_DIA]:
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


def main_path(card, warmup=2, timed=4, detect_steps=FLAGSHIP_BP_STEPS):
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
    if not any(sp.type in ("bp", "nd") for sp in br.specialpoint):
        raise AssertionError(f"the flagship met no branch point in "
                             f"{detect_steps} steps")
    launches = sh_jv_mod.launch_count()
    by_batch = sh_jv_mod.launches_by_batch()
    if launches <= 0:
        raise AssertionError("the main path never launched the sh_jv kernel")
    phase("main_path", steps_per_s=steps_per_s, warm_step_s=warm,
          sh_jv_launches=launches, sh_jv_launches_by_batch=by_batch,
          peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
          card=repr(card))
    return prob, ls, br, state, launches, by_batch, steps_per_s


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


def _profile(fn, cuda_only=False):
    """`fn` under torch.profiler: its CUDA kernel rows and its seconds.
    `cuda_only` records the card's activity alone, which is all the rows
    need: on a step of some 200,000 launches the host's op events cost the
    profiler's post-processing about 90 s."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if cuda_only else [
        ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    return _kernel_rows(prof), wall


def _busy_fields(rows, wall, kernel, step_times, p):
    """What one profiled step shows beside unprofiled steps that took
    `step_times` seconds: the card's busy time, its launches in all and of
    `kernel`, and the longest kernels.  The profiler's own host work slows
    the step it traces, so `idle_share` divides the busy time by the median
    unprofiled step; the share against the profiled step's own wall time is
    printed beside it, labelled as such.  Returns the fields and the busy
    seconds."""
    busy = sum(r[1] for r in rows) * 1e-6
    mine = [r for r in rows if f"{kernel}_kernel" in r[0]]
    step_s = float(np.median(step_times))
    missing = "not measured"
    return dict(
        median_unprofiled_step_s=step_s, profiled_step_s=wall, p=p,
        device_busy_s=busy if rows else missing,
        idle_share=(1 - busy / step_s) if rows else missing,
        idle_share_of_profiled_wall=(1 - busy / wall) if rows else missing,
        kernels=len(rows), launches=sum(r[2] for r in rows),
        **{f"{kernel}_calls": sum(r[2] for r in mine),
           f"{kernel}_device_s": sum(r[1] for r in mine) * 1e-6},
        top_kernels_ms=[(n[:70], round(us / 1e3, 3), c)
                        for n, us, c in rows[:8]]), busy if rows else None


def _profiled_step(it, state, kernel, step_times):
    """One PALC step under torch.profiler (`_busy_fields`), recording the
    card's activity alone (the rows need nothing else)."""
    rows, wall = _profile(lambda: it.iterate(state), cuda_only=True)
    if not state.converged:
        raise AssertionError("the profiled PALC step did not converge")
    return _busy_fields(rows, wall, kernel, step_times, state.p)


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
          sh_jv_launches=sh_jv_mod.launch_count(), card=repr(card))
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
    return launches, seconds, prob, br


def bruss_breakdown(prob, cp, unprofiled=1):
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
    rows, branches = {}, {}
    for dev in ("cuda", "cpu"):
        p = models.swift_hohenberg_2d(device=dev, **kw)
        _, cp = flagship_config(p, 2)
        branches[dev] = bk.continuation(p, bk.PALC(), cp)
        rows[dev] = interop.branch_to_numpy(branches[dev])
    dp = float(np.abs(rows["cuda"]["p"] - rows["cpu"]["p"]).max())
    same_n = bool(np.array_equal(rows["cuda"]["n_unstable"],
                                 rows["cpu"]["n_unstable"]))
    same_sp = list(rows["cuda"]["sp_type"]) == list(rows["cpu"]["sp_type"])
    phase("check_small_branch", max_abs_dp=dp, same_n_unstable=same_n,
          same_special_types=same_sp,
          special=[str(t) for t in rows["cuda"]["sp_type"]])
    if not (dp < 1e-8 and same_n and same_sp):
        raise AssertionError("60x40 branch on the card disagrees with the CPU")
    return branches


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
# 4c. normal forms and branch switching on both paths
# ---------------------------------------------------------------------------

class GmresLog:
    """Counts the port's GMRES solves by system size while active: the
    matvecs of each solve (`linalg/linear.py::_gmres_flat`)."""

    def __init__(self):
        self.solves = {}

    def __enter__(self):
        self._orig = linear._gmres_flat

        def logged(matvec, b, *args):
            out = self._orig(matvec, b, *args)
            self.solves.setdefault(int(b.shape[0]), []).append(int(out[2]))
            return out

        linear._gmres_flat = logged
        return self

    def __exit__(self, *exc):
        linear._gmres_flat = self._orig

    def iterations(self):
        """The matvecs of every solve so far."""
        return sum(sum(v) for v in self.solves.values())

    def summary(self, n):
        """Per system size (n + k: bordered with k borders; 2n + 2:
        bordered, complex; n and 2n: the Hopf form's plain solves): the
        solves and their iterations."""
        names = {n: "plain_n", 2 * n: "plain_2n",
                 2 * n + 2: "bordered_2n+2"}
        names.update({n + k: f"bordered_n+{k}" for k in range(1, 5)})
        return {names.get(k, str(k)): dict(
            solves=len(v), iterations=v, mean=float(np.mean(v)))
            for k, v in sorted(self.solves.items())}


def _rel_gap(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1.0)


def _nf_gaps(nf_a, nf_b):
    """Largest gap of each normal-form coefficient of two forms at one
    point, relative to max(max |c|, 1), in nf_a's kernel basis.  With
    zeta_b = zeta_a Q (Q = -1 or 1 in 1d) and zeta*_b = zeta*_a Q^-T, the
    reduced equation's output index maps back with Q and each input index
    with Q^-T."""
    a, b = interop.normal_form_to_numpy(nf_a), interop.normal_form_to_numpy(
        nf_b)
    Za = a["zeta"].reshape(len(a["zeta"]), -1)
    Q = np.linalg.pinv(Za) @ b["zeta"].reshape(len(b["zeta"]), -1)
    maps = [Q] + [np.linalg.inv(Q).T] * 3
    gaps = {}
    for k in NF_KEYS:
        shape = (len(Q),) * NF_INDICES[k]
        ca = np.reshape(a["nf"][k], shape)
        cb = np.reshape(b["nf"][k], shape)
        for M in maps[:NF_INDICES[k]]:
            # map the leading index and move it last: after every index,
            # the order is back
            cb = np.moveaxis(np.tensordot(M, cb, axes=([1], [0])), 0, -1)
        gaps[k] = float(np.max(np.abs(ca - cb)) / max(np.abs(ca).max(), 1.0))
    return gaps


def flagship_plain_jac_op(Nx=151, Ny=100, lx=8 * np.pi,
                          ly=2 * 2 * np.pi / np.sqrt(3)):
    """The flagship's J.v through the plain PyTorch version, not the
    kernel: the independent route the card's normal form is held against."""
    inv_h2 = [1.0 / (2 * lx / Nx) ** 2, 1.0 / (2 * ly / Ny) ** 2]

    def jac_op(u, par):
        dt = u.dtype
        scal = torch.stack([torch.as_tensor(par["l"], dtype=dt,
                                            device=u.device),
                            torch.as_tensor(par["nu"], dtype=dt,
                                            device=u.device)])
        scal = torch.cat([scal, torch.tensor(inv_h2, dtype=dt,
                                             device=u.device)])
        return lambda v: sh_jv_mod.sh_jv_plain(u, v, scal)

    return jac_op


def _abs_checks(prob, nf, branch, preds, max_steps):
    """The checks of one switched branch: every step converged with
    |F| <= NEWTON_TOL, and its first point lies off the primary branch —
    its offset from the branch point along the kernel, <x1 - x_bp, zeta*>
    (a vector for an Nd point), at least half the amplitude of the
    predictor it started from (the one nearest to it)."""
    sols = branch.gamma.sol
    res = [float(torch.linalg.vector_norm(prob.F(
        s_["x"], prob.set_lens_param(prob.params, s_["p"])))) for s_ in sols]
    zstar = nf.zeta_star if isinstance(nf.zeta_star, list) \
        else [nf.zeta_star]
    dx = sols[0]["x"].reshape(-1) - nf.x0
    offset = float(torch.linalg.vector_norm(torch.stack(
        [torch.dot(dx, z) for z in zstar])))
    pred = min(preds, key=lambda q: float(torch.linalg.vector_norm(
        sols[0]["x"].reshape(-1) - q["x1"])))
    amp = float(np.linalg.norm(np.atleast_1d(pred["amp"])))
    steps = len(branch.gamma) - 1
    fields = dict(steps=steps, p=[float(x) for x in branch.param],
                  residuals=res, offset=offset, amp=amp,
                  predictor_p=float(pred["p"]))
    if steps != max_steps:
        raise AssertionError(f"an aBS step failed: {steps} of {max_steps} "
                             f"converged ({fields})")
    if not max(res) <= NEWTON_TOL:
        raise AssertionError(f"aBS residuals above {NEWTON_TOL}: {res}")
    if not offset >= 0.5 * amp:
        raise AssertionError(f"the first aBS point lies on the primary "
                             f"branch: offset {offset} < amp/2 = {amp / 2}")
    return fields


def flagship_bp(card, prob, ls, br, **domain):
    """The flagship's branch-point leg (examples/sh2d_fronts.py:106-131):
    the matrix-free normal form at the branch's first branch point through
    the kernel, the same through the plain J.v, and branch switching there
    (`multicontinuation` where the kernel is 2d or more, as a user would)."""
    idx = next(i for i, sp in enumerate(br.specialpoint)
               if sp.type in ("bp", "nd"))
    sp = br.specialpoint[idx]
    n = prob.u0.numel()
    reset_launches()
    t0 = time.perf_counter()
    with GmresLog() as log:
        nf = bk.get_normal_form(br, idx, matrix_free=True)
        torch.cuda.synchronize()
    nf_s = time.perf_counter() - t0
    nf_launches = sh_jv_mod.launch_count()
    nf_by_batch = sh_jv_mod.launches_by_batch()
    coef = {k: (v if np.ndim(v) == 0 else np.round(v, 10).tolist())
            for k, v in interop.normal_form_to_numpy(nf)["nf"].items()
            if k in NF_KEYS + ("a02",)}
    phase("flagship_nf", point=idx, step=sp.step, type=type(nf).__name__,
          p=sp.param, delta=sp.delta, **coef, seconds=nf_s,
          sh_jv_launches=nf_launches, sh_jv_launches_by_batch=nf_by_batch,
          gmres=log.summary(n), card=repr(card))
    if nf_launches <= 0:
        raise AssertionError("the flagship normal form never launched sh_jv")

    # the same normal form with J.v through the plain version: a kernel
    # that is wrong on these call patterns (or a lost parameter tangent)
    # shows here
    t1 = time.perf_counter()
    plain = prob.re_make(jac_op=flagship_plain_jac_op(**domain))
    nf_plain = bk.get_normal_form(br, idx, prob=plain, matrix_free=True)
    torch.cuda.synchronize()
    gaps = _nf_gaps(nf, nf_plain)
    phase("flagship_nf_plain", seconds=time.perf_counter() - t1,
          type=type(nf_plain).__name__, max_rel_gap=max(gaps.values()),
          **{f"gap_{k}": v for k, v in gaps.items()}, rtol=NF_RTOL)
    if not (max(gaps.values()) <= NF_RTOL and type(nf_plain) is type(nf)):
        raise AssertionError(f"the flagship normal form through sh_jv "
                             f"differs from the plain J.v's: {gaps}")

    # branch switching with the example's parameters
    ds = -0.003
    cp_abs = bk.ContinuationPar(
        ds=-0.004, dsmax=0.01, dsmin=1e-7, p_min=-0.8, p_max=0.2,
        max_steps=ABS_STEPS, detect_bifurcation=0, detect_fold=False,
        newton_options=bk.NewtonPar(tol=NEWTON_TOL, max_iterations=20,
                                    linsolver=ls))
    nd = type(nf).__name__ == "NdBranchPoint"
    stamps = []

    def stamp(*args, **kwargs):
        """`finalise_solution` hook: the time each converged step ends."""
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    t2 = time.perf_counter()
    if nd:
        preds = bk.normal_forms.nd_branch_predictors(nf, ds)
        _, branches = bk.multicontinuation(
            br, idx, cp_abs, delta_p=ds, nf_kwargs={"matrix_free": True},
            finalise_solution=stamp)
    else:
        preds = [bk.predictor(nf, ds)]
        branches = [bk.continuation_from_bp(
            br, idx, cp_abs, delta_p=ds, nf_kwargs={"matrix_free": True},
            finalise_solution=stamp)]
    torch.cuda.synchronize()
    abs_s = time.perf_counter() - t2
    # the steps of each branch after its first: the intervals between the
    # hook's calls within a branch (a branch's steps are consecutive)
    per_branch = max(len(stamps) // max(len(branches), 1), 1)
    step_s = [b - a for i, (a, b) in enumerate(zip(stamps, stamps[1:]))
              if (i + 1) % per_branch]
    phase("flagship_abs_predictors", count=len(preds),
          p=[float(q["p"]) for q in preds],
          amp=[np.round(np.atleast_1d(q["amp"]), 8).tolist() for q in preds],
          branches=len(branches))
    if not branches:
        raise AssertionError("branch switching gave no branch")
    steps = 0
    for b in branches:
        fields = _abs_checks(prob, nf, b, preds, cp_abs.max_steps)
        steps += fields["steps"]
        phase("flagship_abs", **fields)
    launches = sh_jv_mod.launch_count()
    by_batch = sh_jv_mod.launches_by_batch()
    phase("flagship_bp", abs_seconds=abs_s, abs_steps=steps,
          abs_step_seconds=step_s, abs_median_step_s=float(np.median(step_s)),
          sh_jv_launches=launches, sh_jv_launches_by_batch=by_batch,
          seconds=time.perf_counter() - t0, card=repr(card))
    return launches, by_batch


def bruss_hopf_nf(card, prob, br):
    """The Hopf normal form at the 128-site Brusselator's Hopf point:
    matrix-free through the DIA kernel, dense (host eig of the jacobian),
    and matrix-free on the CPU (plain `dia_spmv`) from the same point."""
    n = prob.u0.numel()
    idx = next(i for i, sp in enumerate(br.specialpoint)
               if sp.type == "hopf")
    sp = br.specialpoint[idx]
    lam = sp.eigenvals[max(int(sp.ind_ev) - 1, 0)]
    omega, zeta = float(abs(np.imag(lam))), \
        sp.eigenvecs[:, max(int(sp.ind_ev) - 1, 0)]
    if np.imag(lam) < 0:
        zeta = torch.conj(zeta)
    # the unpreconditioned real-embedded system has 2n + 2 unknowns
    opts = dict(restart=2 * n + 2, maxiter=4 * (2 * n + 2))
    reset_launches()
    t0 = time.perf_counter()
    with GmresLog() as log:
        hp = bk.hopf_normal_form(prob, br, idx, matrix_free=True,
                                 gmres_opts=opts)
        torch.cuda.synchronize()
    mf_s = time.perf_counter() - t0
    launches = dia_spmv.launches
    t1 = time.perf_counter()
    hp_dense = bk.hopf_normal_form(prob, br, idx)
    dense_s = time.perf_counter() - t1
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # small tensors: threads contend
    t2 = time.perf_counter()
    hp_cpu = bk.normal_forms.hopf_normal_form_point(
        brusselator_problem(n // 2, "cpu"), sp.x.cpu(), sp.param,
        omega, zeta=zeta.cpu(), matrix_free=True, gmres_opts=opts)
    cpu_s = time.perf_counter() - t2
    torch.set_num_threads(threads)
    pred = bk.predictor(hp, 0.01)
    gaps = {k: _rel_gap(hp.nf[k], hp_cpu.nf[k]) for k in ("a", "b")}
    dense_gaps = {k: _rel_gap(hp.nf[k], hp_dense.nf[k]) for k in ("a", "b")}
    phase("bruss_hopf_nf", p=sp.param, omega=hp.omega,
          a=repr(hp.nf["a"]), b=repr(hp.nf["b"]), subtype=hp.subtype,
          gap_cpu=gaps, omega_gap_cpu=abs(hp.omega - hp_cpu.omega),
          gap_dense=dense_gaps, subtypes=[hp.subtype, hp_dense.subtype,
                                          hp_cpu.subtype],
          period=pred["period"], seconds_mf=mf_s, seconds_dense=dense_s,
          seconds_cpu=cpu_s, dia_spmv_launches=launches,
          gmres=log.summary(n), card=repr(card))
    if not max(gaps.values()) <= NF_RTOL:
        raise AssertionError(f"the Hopf normal form through dia_spmv "
                             f"differs from the CPU's: {gaps}")
    if not abs(hp.omega - hp_cpu.omega) <= 1e-9:
        raise AssertionError("the Hopf frequency differs from the CPU's")
    if not hp.subtype == hp_dense.subtype == hp_cpu.subtype:
        raise AssertionError("the Hopf subtypes disagree")
    if not (np.isfinite(pred["period"]) and pred["period"] > 0):
        raise AssertionError(f"bad Hopf predictor period {pred['period']}")
    if launches <= 0:
        raise AssertionError("the Hopf normal form never launched dia_spmv")
    return launches, hp_dense


def check_small_nf(branches):
    """The matrix-free normal form at the first bp of the 60x40 SH branch
    on the card (kernel) and on the CPU (plain version) agree."""
    nfs = {}
    for dev, br in branches.items():
        idx = next(i for i, sp in enumerate(br.specialpoint)
                   if sp.type == "bp")
        nfs[dev] = bk.get_normal_form(br, idx, matrix_free=True)
    gaps = _nf_gaps(nfs["cuda"], nfs["cpu"])
    phase("check_small_nf", type=type(nfs["cuda"]).__name__,
          **{f"gap_{k}": v for k, v in gaps.items()}, rtol=NF_RTOL)
    if not (max(gaps.values()) <= NF_RTOL
            and type(nfs["cuda"]) is type(nfs["cpu"])):
        raise AssertionError(f"60x40 normal form on the card disagrees with "
                             f"the CPU: {gaps}")


# ---------------------------------------------------------------------------
# 4e-f. codim-2 curves: the flagship's fold curve, the Brusselator's Hopf
# curve
# ---------------------------------------------------------------------------


class ExtSolveLog:
    """Counts the extended bordered solves of the minimally augmented
    functionals (`minaug_mf.solve_bordered_ext` and its complex twin)
    while active; GmresLog counts every GMRES solve, these included."""

    NAMES = ("solve_bordered_ext", "solve_bordered_ext_cplx")

    def __enter__(self):
        self.count = 0
        self._orig = {k: getattr(minaug_mf, k) for k in self.NAMES}

        def counted(fn):
            def wrapper(*args, **kwargs):
                self.count += 1
                return fn(*args, **kwargs)
            return wrapper

        for k, fn in self._orig.items():
            setattr(minaug_mf, k, counted(fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self._orig.items():
            setattr(minaug_mf, k, fn)


class StepStamps:
    """`finalise_solution` hook: the time each converged step ends and the
    engine's step count there (a step that failed and was retried with a
    smaller ds shows as a gap in the count), and at each stamp the running
    value of each of `counters` (name -> function).  With `profile_after`
    = k, the step after the k-th stamp runs under torch.profiler, from
    that stamp to the next: one of the curve's own steps, with its events
    and its update hook."""

    def __init__(self, counters=None, profile_after=None):
        self.t, self.steps, self.p = [], [], []
        self.counters = counters or {}
        self.counts = {k: [] for k in self.counters}
        self.profile_after = profile_after
        self._prof = None
        self.rows = self.profiled_s = None

    def __call__(self, z, tau, step, res, state=None, **kwargs):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            self.rows = _kernel_rows(self._prof)
            self.profiled_s = now - self.t[-1]
            self._prof = None
        self.t.append(now)
        self.steps.append(int(state.step) if state is not None else step)
        self.p.append(state.p if state is not None else None)
        for k, fn in self.counters.items():
            self.counts[k].append(fn())
        if len(self.t) == self.profile_after:
            from torch.profiler import ProfilerActivity, profile

            # the card's activity alone: the rows need nothing else
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()

    def per_step(self, name):
        """The counter's growth over each step after the first stamp."""
        return np.diff(self.counts[name]).tolist()

    def all_converged(self):
        return self.steps == list(range(1, len(self.steps) + 1))


def _timed_bootstrap(name):
    """Wrap `minaug_mf.<name>` to record its seconds (the anchors'
    bootstrap by bordered inverse iteration)."""
    orig = getattr(minaug_mf, name)
    took = []

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        took.append(time.perf_counter() - t)
        return out

    setattr(minaug_mf, name, wrapper)
    return orig, took


def fold_branch_config(prob, max_steps):
    """bench.py's CPU-leg settings of the flagship branch to its first
    fold (`ma_mf`): GMRES(40, 300, 1e-10) with the spectral
    preconditioner, no eigensolves, fold detection on."""
    ls = bk.GMRES(restart=40, maxiter=300, rtol=1e-10,
                  precond=prob.spectral_precond)
    return ls, bk.ContinuationPar(
        ds=-0.005, dsmax=0.02, dsmin=1e-6, p_min=-0.8, p_max=0.2,
        max_steps=max_steps, nev=4, detect_bifurcation=0, detect_fold=True,
        save_eigenvectors=False,
        newton_options=bk.NewtonPar(tol=NEWTON_TOL, max_iterations=15,
                                    linsolver=ls))


def fold_curve_config(prob, max_steps):
    """The `cp2` of examples/sh2d_fronts.py:150-164: GMRES(40, 400, 1e-9),
    Newton 1e-7."""
    return bk.ContinuationPar(
        ds=0.01, dsmax=0.02, dsmin=1e-6, p_min=0.5, p_max=2.0,
        max_steps=max_steps, detect_bifurcation=0, detect_fold=False,
        save_eigenvectors=False,
        newton_options=bk.NewtonPar(
            tol=NEWTON_TOL, max_iterations=20,
            linsolver=bk.GMRES(restart=40, maxiter=400, rtol=1e-9,
                               precond=prob.spectral_precond)))


def _fresh_sigma(maprob, precond, X, p2, p1, seed=5):
    """|sigma| of the fold functional at (x, p2, p1) from a bordered solve
    with fresh random borders: it vanishes where J is singular,
    whatever borders the corrector used."""
    n = maprob.n_inner
    inner = maprob.inner_prob
    rng = np.random.default_rng(seed)
    rb = torch.as_tensor(rng.standard_normal(n), device=X.device)
    rb = rb / torch.linalg.vector_norm(rb)
    gm = bk.GMRES(restart=40, maxiter=400, rtol=1e-8, atol=1e-12,
                  precond=minaug_mf.ext_precond(precond, n))
    par = maprob.inner_lens.set(maprob.outer_lens.set(inner.params, p2), p1)
    _, sig, _ = minaug_mf.solve_bordered_ext(
        minaug_mf._jd(inner, maprob.unravel_inner(X[:n]), par), rb, rb, gm)
    return abs(float(sig))


def flagship_fold(card):
    """The flagship's fold-curve leg: the branch to its first fold, then
    the matrix-free fold curve in nu through the kernel, checked by
    sigma with fresh borders and against the plain J.v's curve."""
    prob = models.swift_hohenberg_2d(Nx=151, Ny=100)      # on the card
    ls, cp = fold_branch_config(prob, FLAGSHIP_FOLD_STEPS)
    t0 = time.perf_counter()
    sol = bk.newton(prob, bk.NewtonPar(tol=1e-8, max_iterations=25,
                                       linsolver=ls))
    if not sol.converged:
        raise AssertionError("Newton did not converge on the flagship")
    br = bk.continuation(prob.re_make(u0=sol.u), bk.PALC(), cp)
    torch.cuda.synchronize()
    folds = br.get_special_points("fold")
    phase("flagship_fold_branch", steps=len(br) - 1,
          folds=[(sp.param, sp.step) for sp in folds],
          seconds=time.perf_counter() - t0)
    if not folds:
        raise AssertionError(f"the flagship met no fold in "
                             f"{FLAGSHIP_FOLD_STEPS} steps")
    idx = br.specialpoint.index(folds[0])
    n = prob.u0.numel()

    timed_end = FOLD_WARM + FOLD_TIMED
    steps = timed_end + 1          # and one profiled step after them
    reset_launches()
    orig, boot = _timed_bootstrap("bootstrap_fold_anchors")
    t1 = time.perf_counter()
    try:
        with GmresLog() as log, ExtSolveLog() as ext:
            stamps = StepStamps(
                counters={"gmres_iterations": log.iterations,
                          "extended_solves": lambda: ext.count},
                profile_after=timed_end)
            brf = bk.continuation_fold(
                br, idx, "nu", fold_curve_config(prob, steps),
                detect_codim2_bifurcation=2, jacobian_ma="minaug",
                finalise_solution=stamps)
            torch.cuda.synchronize()
    finally:
        minaug_mf.bootstrap_fold_anchors = orig
    seconds = time.perf_counter() - t1
    launches = sh_jv_mod.launch_count()
    by_batch = sh_jv_mod.launches_by_batch()
    timed = np.diff(stamps.t[FOLD_WARM - 1:timed_end])
    curve = interop.codim2_branch_to_numpy(brf)
    gm = log.summary(n)
    n_gmres = sum(v["solves"] for v in gm.values())
    phase("flagship_fold", fold_p=folds[0].param, fold_step=folds[0].step,
          steps=len(brf) - 1, nu=curve["param"].tolist(),
          l=curve["p1"].tolist(), special=list(curve["sp_type"]),
          steps_per_s=len(timed) / float(np.sum(timed)),
          timed_step_s=timed.tolist(), bootstrap_s=boot,
          gmres_iterations_by_step=stamps.per_step("gmres_iterations"),
          extended_solves_by_step=stamps.per_step("extended_solves"),
          seconds=seconds, extended_solves=ext.count,
          extended_solves_per_step=ext.count / max(len(brf) - 1, 1),
          gmres_solves=n_gmres, gmres=gm,
          gmres_iterations_per_solve=float(np.mean(
              [i for v in log.solves.values() for i in v])),
          sh_jv_launches=launches, sh_jv_launches_by_batch=by_batch,
          card=repr(card))
    if not (len(brf) - 1 == steps and stamps.all_converged()):
        raise AssertionError(f"a fold-curve step failed: engine steps "
                             f"{stamps.steps}")
    if launches <= 0:
        raise AssertionError("the fold curve never launched sh_jv")

    fold_breakdown(stamps, timed_end)

    # sigma with fresh random borders: ~0 on the curve, not off it
    maprob = brf.gamma.prob
    checks = []
    for k in (1, len(brf) // 2, len(brf) - 1):
        X = brf.gamma.sol[k]["x"]
        p2, p1 = float(curve["param"][k]), float(curve["p1"][k])
        on = _fresh_sigma(maprob, prob.spectral_precond, X, p2, p1)
        off = _fresh_sigma(maprob, prob.spectral_precond, X, p2, p1 + 0.03)
        checks.append(dict(point=k, sigma_on=on, sigma_off=off))
        if not (on < 1e-3 and on < 1e-2 * off):
            raise AssertionError(f"the fold curve is not on the fold at "
                                 f"point {k}: sigma {on} (off {off})")
    phase("flagship_fold_sigma", points=checks)

    # the first steps again with J.v through the plain version (no sh_jv
    # launch at all)
    t2 = time.perf_counter()
    plain = dataclasses.replace(
        br, prob=br.prob.re_make(jac_op=flagship_plain_jac_op()))
    reset_launches()
    brp = bk.continuation_fold(plain, idx, "nu",
                               fold_curve_config(prob, FOLD_PLAIN_STEPS),
                               detect_codim2_bifurcation=2,
                               jacobian_ma="minaug")
    torch.cuda.synchronize()
    plain_launches = sh_jv_mod.launch_count()
    cp_ = interop.codim2_branch_to_numpy(brp)
    k = len(cp_["param"])
    gap = max(float(np.max(np.abs(cp_["param"] - curve["param"][:k]))),
              float(np.max(np.abs(cp_["p1"] - curve["p1"][:k]))))
    phase("flagship_fold_plain", steps=k - 1, max_abs_gap=gap,
          tol=CODIM2_TOL, sh_jv_launches=plain_launches,
          seconds=time.perf_counter() - t2)
    if not (k == FOLD_PLAIN_STEPS + 1 and gap <= CODIM2_TOL
            and plain_launches == 0):
        raise AssertionError(f"the fold curve through sh_jv differs from "
                             f"the plain J.v's: {gap} ({k - 1} steps, "
                             f"{plain_launches} sh_jv launches)")
    return launches, by_batch


def fold_breakdown(stamps, timed_end):
    """Where a fold-curve step goes: the curve's own step after its timed
    ones, run under torch.profiler by `stamps` (the corrector, the events,
    and the update hook's re-anchoring), beside the timed steps.  The
    profiled step may take other GMRES iterations than a timed one, so
    `idle_share_per_iteration` scales its busy time to the timed steps'
    median iterations first."""
    if stamps.rows is None:
        raise AssertionError("the fold curve's profiled step did not run")
    timed = np.diff(stamps.t[FOLD_WARM - 1:timed_end])
    its = stamps.per_step("gmres_iterations")     # steps 2, 3, ...
    ext = stamps.per_step("extended_solves")
    timed_its = its[FOLD_WARM - 1:timed_end - 1]
    prof_it = its[timed_end - 1]
    fields, busy = _busy_fields(stamps.rows, stamps.profiled_s, "sh_jv",
                                timed, stamps.p[timed_end])
    it_s = float(np.median(timed_its))
    phase("fold_breakdown", step=timed_end + 1,
          timed_gmres_iterations=timed_its, gmres_iterations=prof_it,
          extended_solves=ext[timed_end - 1],
          idle_share_per_iteration=(
              1 - busy / prof_it * it_s / float(np.median(timed)))
          if busy is not None else "not measured", **fields)


def _dense_dia(A):
    """A DIAMatrix as a dense host matrix."""
    data = A.data.detach().cpu().numpy()
    n = data.shape[1]
    M = np.zeros((n, n))
    i = np.arange(n)
    for k, off in enumerate(A.offsets):
        j = i + off
        m = (j >= 0) & (j < n)
        M[i[m], j[m]] = data[k][m]
    return M


def bruss_hopf_config(n, steps):
    """The `cp2` of examples/brusselator.py:24-27 on the path's
    `ContinuationPar`, cut to `steps` steps."""
    return brusselator_config(n).replace(
        p_min=5.1, p_max=10.5, ds=0.01, detect_bifurcation=0,
        detect_fold=False, max_steps=steps)


def _cpu_branch_shim(br, idx, prob_cpu):
    """The Hopf point of a card branch, moved to the CPU with the CPU's
    problem, as a one-point branch."""
    sp = dataclasses.replace(
        br.specialpoint[idx], x=br.specialpoint[idx].x.cpu(),
        eigenvecs=br.specialpoint[idx].eigenvecs.cpu())
    return bk.ContResult(prob=prob_cpu, specialpoint=[sp])


def _hopf_curve(br, idx, n, steps, **kw):
    opts = dict(restart=2 * n + 2, maxiter=4 * (2 * n + 2))
    return bk.continuation_hopf(
        br, idx, "beta", bruss_hopf_config(n // 2, steps),
        detect_codim2_bifurcation=2, jacobian_ma="minaug", gmres_opts=opts,
        **kw)


def bruss_hopf_curve(card, prob, br):
    """The matrix-free Hopf curve in beta from the 128-site Brusselator's
    Hopf point, through the DIA kernel, against a dense host eig and the
    same curve on the CPU."""
    n = prob.u0.numel()
    idx = next(i for i, sp in enumerate(br.specialpoint)
               if sp.type == "hopf")
    reset_launches()
    stamps = StepStamps()
    t0 = time.perf_counter()
    with GmresLog() as log, ExtSolveLog() as ext:
        brh = _hopf_curve(br, idx, n, BRUSS_HOPF_STEPS,
                          finalise_solution=stamps)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dia_spmv.launches
    curve = interop.codim2_branch_to_numpy(brh)
    step_s = np.diff(stamps.t)
    phase("bruss_hopf_curve", steps=len(brh) - 1,
          beta=curve["param"].tolist(), l=curve["p1"].tolist(),
          omega=curve["omega"].tolist(), special=list(curve["sp_type"]),
          seconds=seconds, step_s=step_s.tolist(),
          median_step_s=float(np.median(step_s)),
          extended_solves=ext.count, gmres=log.summary(n),
          dia_spmv_launches=launches, card=repr(card))
    if not (len(brh) - 1 == BRUSS_HOPF_STEPS and stamps.all_converged()):
        raise AssertionError(f"a Hopf-curve step failed: engine steps "
                             f"{stamps.steps}")
    if launches <= 0:
        raise AssertionError("the Hopf curve never launched dia_spmv")

    # the critical pair of the dense jacobian, on the host
    maprob = brh.gamma.prob
    jac = brusselator_dia_jac_op(n // 2)
    eig_checks = []
    for k in range(1, len(brh)):
        X = brh.gamma.sol[k]["x"]
        par = maprob.inner_lens.set(maprob.outer_lens.set(
            prob.params, float(curve["param"][k])), X[n])
        vals = np.linalg.eigvals(_dense_dia(jac(X[:n], par)))
        om = float(curve["omega"][k])
        i = int(np.argmin(np.abs(vals - 1j * om)))
        eig_checks.append(dict(point=k, re=float(vals[i].real),
                               im_gap=float(abs(vals[i].imag - om))))
        if not (abs(vals[i].real) <= 1e-6 and abs(vals[i].imag - om)
                <= 1e-6):
            raise AssertionError(f"no critical pair at i omega at point "
                                 f"{k}: {vals[i]} against {om}")

    # the same curve on the CPU (plain dia_spmv)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # small tensors: threads contend
    t1 = time.perf_counter()
    cpu_prob = brusselator_problem(n // 2, "cpu")
    brc = _hopf_curve(_cpu_branch_shim(br, idx, cpu_prob), 0, n,
                      BRUSS_HOPF_STEPS)
    cpu_s = time.perf_counter() - t1
    cc = interop.codim2_branch_to_numpy(brc)
    k = len(cc["param"])
    gap = max(float(np.max(np.abs(cc[key] - curve[key][:k])))
              for key in ("param", "p1", "omega")) \
        if k == len(curve["param"]) else np.inf
    # l1 along the curve: dense on the host (a direct eigendecomposition
    # and direct solves: the converged witness) at every point, and at 3
    # points matrix-free on the card (through the kernel) and on the CPU
    # from the card's points, with the same borders
    cpu_mp = brc.gamma.prob
    cpu_par = {key: (v.cpu() if isinstance(v, torch.Tensor) else v)
               for key, v in maprob.params.items()}
    cpu_par["_inner"] = cpu_mp.params["_inner"]
    l1_card = minaug_mf.make_l1_kernel_mf(maprob)
    l1_cpu = minaug_mf.make_l1_kernel_mf(cpu_mp)
    l1_dense = minaug._make_l1_kernel(cpu_mp)
    dense = []
    for k in range(len(brh)):
        par = cpu_mp.set_lens_param(cpu_par, float(curve["param"][k]))
        dense.append(float(l1_dense(brh.gamma.sol[k]["x"].cpu(),
                                    par["_inner"])))
    l1_gaps = []
    for k in range(1, len(brh)):
        p2 = float(curve["param"][k])
        X = brh.gamma.sol[k]["x"]
        a = float(l1_card(X, maprob.set_lens_param(maprob.params, p2)))
        b = float(l1_cpu(X.cpu(), cpu_mp.set_lens_param(cpu_par, p2)))
        l1_gaps.append(dict(point=k, l1=a, l1_dense=dense[k],
                            rel_gap_dense=_rel(a, dense[k]),
                            rel_gap_cpu=_rel(a, b)))
    torch.set_num_threads(threads)
    # a GH or ZH label where, and only where, the witness changes sign
    sign_changes = int(np.sum(np.diff(np.sign(dense)) != 0))
    labels = [k for k in curve["sp_type"] if k in ("gh", "zh")]
    phase("bruss_hopf_curve_check", eig=eig_checks, cpu_seconds=cpu_s,
          max_abs_gap_cpu=gap, tol=CODIM2_TOL, l1_dense=dense,
          l1=l1_gaps, l1_rtol=L1_RTOL, l1_sign_changes=sign_changes,
          gh_zh_labels=labels)
    if not gap <= CODIM2_TOL:
        raise AssertionError(f"the Hopf curve on the card differs from the "
                             f"CPU's: {gap}")
    if not max(max(g["rel_gap_dense"], g["rel_gap_cpu"])
               for g in l1_gaps) <= L1_RTOL:
        raise AssertionError(f"l1 on the card differs from the dense "
                             f"witness or the CPU's: {l1_gaps}")
    if len(labels) != sign_changes:
        raise AssertionError(f"GH/ZH labels {labels} where the dense l1 "
                             f"changes sign {sign_changes} times")
    return launches


def _rel(a, b):
    return abs(a - b) / max(abs(a), abs(b))


def _small_models(dev):
    """The small codim-2 cases on `dev`: the cusp model, the Hopf normal
    form z' = (p + q + i) z - z|z|^2."""
    d = dict(dtype=torch.float64, device=dev)

    def cusp(u, par):
        return u ** 3 + par["p1"] * u + par["p2"]

    def hopf(u, par):
        x, y = u[0], u[1]
        mu = par["p"] + par["q"]
        r2 = x * x + y * y
        return torch.stack([mu * x - y - x * r2, x + mu * y - y * r2])

    def par(**kw):
        return {k: torch.tensor(v, **d) for k, v in kw.items()}

    return (bk.BifurcationProblem(cusp, u0=torch.tensor([1.0], **d),
                                  params=par(p1=-1.0, p2=0.0), lens="p2"),
            bk.BifurcationProblem(hopf, u0=torch.zeros(2, **d),
                                  params=par(p=-0.5, q=0.0), lens="p"))


def _small_cp(**kw):
    base = dict(ds=0.01, dsmax=0.05, dsmin=1e-5, p_min=-1.0, p_max=1.0,
                max_steps=20, detect_bifurcation=0, detect_fold=True,
                nev=2, n_inversion=4,
                newton_options=bk.NewtonPar(tol=1e-10, max_iterations=30))
    base.update(kw)
    return bk.ContinuationPar(**base)


def check_small_codim2():
    """Small codim-2 curves on the card against the CPU: the cusp's fold
    curve (dense and matrix-free) and the exact Hopf curve (matrix-free),
    then the dense codim-2 family (`check_small_codim2_family`);
    `bruss_hopf_curve` holds the matrix-free Hopf curve through the DIA
    kernel against the CPU at full width."""
    curves, seconds = {}, {}
    threads = torch.get_num_threads()
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        torch.set_num_threads(1)          # small tensors: threads contend
        cusp, hopf = _small_models(dev)
        brc = bk.continuation(cusp, bk.PALC(), _small_cp())
        ic = next(i for i, sp in enumerate(brc.specialpoint)
                  if sp.type == "fold")
        cp2 = _small_cp(ds=0.05, dsmax=0.2, p_min=-1.2, p_max=0.3,
                        max_steps=20, detect_fold=False)
        brh = bk.continuation(hopf, bk.PALC(), _small_cp(
            detect_bifurcation=3, detect_fold=False, max_steps=15))
        ih = next(i for i, sp in enumerate(brh.specialpoint)
                  if sp.type == "hopf")
        curves[dev] = {
            "cusp_dense": bk.continuation_fold(
                brc, ic, "p1", cp2, detect_codim2_bifurcation=2),
            "cusp_mf": bk.continuation_fold(
                brc, ic, "p1", cp2, detect_codim2_bifurcation=2,
                jacobian_ma="minaug"),
            "hopf_mf": bk.continuation_hopf(
                brh, ih, "q", _small_cp(ds=0.02, p_min=-0.8, p_max=0.8,
                                        max_steps=8, detect_fold=False),
                detect_codim2_bifurcation=0, jacobian_ma="minaug"),
        }
        torch.set_num_threads(threads)
        seconds[dev] = time.perf_counter() - t0
    for name in curves["cuda"]:
        a = interop.codim2_branch_to_numpy(curves["cuda"][name])
        b = interop.codim2_branch_to_numpy(curves["cpu"][name])
        same_len = len(a["param"]) == len(b["param"])
        gap = max(float(np.max(np.abs(a[k] - b[k])))
                  for k in ("param", "p1", "omega") if k in a) \
            if same_len else np.inf
        same_sp = list(a["sp_type"]) == list(b["sp_type"])
        phase("check_small_codim2", curve=name, steps=len(a["param"]) - 1,
              max_abs_gap=gap, same_special_types=same_sp,
              special=list(a["sp_type"]), seconds=seconds)
        if not (gap <= 1e-9 and same_sp):
            raise AssertionError(f"the {name} curve on the card differs "
                                 f"from the CPU's: {gap}, {same_sp}")
    check_small_codim2_family()


# ---------------------------------------------------------------------------
# 4j. codim2_bt_pde / codim2_zh_pde: matrix-free codim-2 normal forms,
#     unfoldings and switching at the PDE models' full width, every plain
#     J.v through dia_spmv
# ---------------------------------------------------------------------------

# test_minaug_mf.py:670-749 at its 40 x 40 (3,200 unknowns); depth cut: the
# branch starts at (b1, b2) = (0.05, 0.6), near its fold at b1 = 0.09, so
# the fold curve meets the BT within 6 steps (the JAX test starts at
# (0.5, 2.0): 25 branch and 20 curve steps more)
BT_N = 40
BT_START = dict(b1=0.05, b2=0.6)
BT_CURVE_STEPS = 6
BT_HOPF_STEPS = 6
# test_minaug_mf.py:471-534 at its 32 x 32 (3,072 unknowns), from the upper
# branch s = +sqrt(-p1) at p1 = -0.05 and from a = -0.2: the first state
# past the fold then has s < 0 and the fold curve is the constant mode's,
# p1 = 0 exactly (from the JAX test's lower-branch start both packages
# follow the mode-1 fold curve p1 = -0.0156); 3 curve steps meet the ZH
FH_N = 32
FH_START = dict(p1=-0.05, a=-0.2)
FH_CURVE_STEPS = 3
FH_HOPF_STEPS = 6
PDE_RTOL = 1e-8            # kernel against plain, card against CPU
CODIM2_BUDGET_S = 150      # the two PDE phases and check_small_codim2


def _pde_ls(prob):
    return bk.GMRES(restart=40, maxiter=300, rtol=1e-10,
                    precond=prob.spectral_precond)


def bt_pde_model(device, **kw):
    return models.bogdanov_takens_2d(Nx=BT_N, Ny=BT_N, device=device,
                                     **BT_START, **kw)


def fh_pde_model(device, **kw):
    prob = models.fold_hopf_interaction_2d(Nx=FH_N, Ny=FH_N, device=device,
                                           **FH_START, **kw)
    u0 = prob.u0.clone()
    u0[0] = np.sqrt(-FH_START["p1"])
    return prob.re_make(u0=u0)


class _Parts:
    """Seconds of consecutive parts on the host clock, the card
    synchronised at each boundary."""

    def __init__(self, device):
        self.device, self.s = device, {}
        _sync(device)
        self.t = time.perf_counter()

    def __call__(self, name):
        _sync(self.device)
        now = time.perf_counter()
        self.s[name] = now - self.t
        self.t = now


def _nearest(gamma, kind):
    idx = [i for i, sp in enumerate(gamma.specialpoint) if sp.type == kind]
    if not idx:
        raise AssertionError(f"no {kind} point on the curve: "
                             f"{[sp.type for sp in gamma.specialpoint]}")
    return min(idx, key=lambda i: abs(float(gamma.specialpoint[i].param)))


def bt_pde_leg(device, stamps=None):
    """The flow of test_minaug_mf.py:670-749: the equilibrium branch in b1
    to its fold, the matrix-free fold curve in b2 with the BT event,
    `get_normal_form_codim2` (routed matrix-free), `bt_unfolding` and the
    homoclinic predictor at the exact BT, and `switch_codim2` to the
    matrix-free Hopf curve."""
    prob = bt_pde_model(device)
    ls = _pde_ls(prob)
    parts = _Parts(device)
    br = bk.continuation(prob, bk.PALC(), bk.ContinuationPar(
        ds=0.01, dsmax=0.02, dsmin=1e-6, p_min=0.0, p_max=1.5, max_steps=12,
        detect_bifurcation=0, detect_fold=True,
        newton_options=bk.NewtonPar(tol=1e-9, max_iterations=25,
                                    linsolver=ls)))
    parts("branch_s")
    ifold = next(i for i, sp in enumerate(br.specialpoint)
                 if sp.type == "fold")
    # the quarter domain's stiffness puts the MA residual floor near 3e-8
    # (test_minaug_mf.py:722-723)
    cp2 = bk.ContinuationPar(
        ds=-0.1, dsmax=0.2, dsmin=1e-6, p_min=-2.5, p_max=2.5,
        max_steps=BT_CURVE_STEPS, detect_bifurcation=0, detect_fold=False,
        newton_options=bk.NewtonPar(tol=1e-7, max_iterations=30,
                                    linsolver=ls))
    brf = bk.continuation_fold(br, ifold, "b2", cp2,
                               detect_codim2_bifurcation=2,
                               jacobian_ma="minaug")
    parts("fold_curve_s")
    ibt = _nearest(brf.gamma, "bt")
    nf = bk.get_normal_form_codim2(brf, ibt)
    parts("normal_form_s")
    x0 = torch.zeros_like(prob.u0)
    par0 = {k: torch.zeros_like(v) for k, v in prob.params.items()}
    unf = bk.bt_unfolding(prob, x0, par0, bk.as_lens("b1"),
                          bk.as_lens("b2"), matrix_free=True)
    hom = bk.predictor_homoclinic_bt(unf, 0.05)
    parts("unfolding_s")
    kw = {} if stamps is None else {"finalise_solution": stamps}
    brh = bk.switch_codim2(brf, ibt, cp2.replace(ds=-0.05, dsmax=0.1,
                                                 max_steps=BT_HOPF_STEPS),
                           detect_codim2_bifurcation=0, **kw)
    parts("switch_s")
    return dict(prob=prob, br=br, brf=brf, ibt=ibt, nf=nf, unf=unf, hom=hom,
                brh=brh, parts=parts.s)


def _bt_forms(prob, x, params, seed):
    """The BT form at a curve's point (as `get_normal_form_codim2` takes
    it: matrix-free, seeded with the curve's anchor) and the unfolding at
    the exact BT, on `prob`'s device: a, b, K10, K11, K2."""
    nf = bk.bt_normal_form(prob, x, params, matrix_free=True, seed=seed)
    dev = prob.u0.device
    par0 = {k: torch.zeros_like(v) for k, v in prob.params.items()}
    unf = bk.bt_unfolding(prob, torch.zeros_like(prob.u0), par0,
                          bk.as_lens("b1"), bk.as_lens("b2"),
                          matrix_free=True)
    out = {"curve_a": nf.nf["a"], "curve_b": nf.nf["b"]}
    out.update({k: torch.as_tensor(unf[k]).to(dev) for k in
                ("a", "b", "K10", "K11", "K2")})
    return out


def _form_gaps(got, ref):
    """Largest gap of each coefficient, relative to max(|c|, 1)."""
    gaps = {}
    for k, r in ref.items():
        a = torch.as_tensor(got[k]).cpu().to(torch.complex128)
        b = torch.as_tensor(r).cpu().to(torch.complex128)
        gaps[k] = float((a - b).abs().max() / max(float(b.abs().max()),
                                                   1.0))
    return gaps


def _cpu(tree):
    return {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


def codim2_bt_pde(card):
    """`bogdanov_takens_2d` at 40 x 40 on the card (f64, every plain J.v
    through dia_spmv), held to its exact geometry, the kernel against the
    plain version and the card against the CPU."""
    reset_launches()
    stamps = StepStamps(profile_after=BT_HOPF_STEPS - 1)
    t0 = time.perf_counter()
    with GmresLog() as log:
        leg = bt_pde_leg("cuda", stamps=stamps)
    seconds = time.perf_counter() - t0
    launches = dia_spmv.launches
    sh_launches = sh_jv_mod.launch_count()
    prob, brf, brh, unf = leg["prob"], leg["brf"], leg["brh"], leg["unf"]
    n = prob.u0.numel()
    s = 1.0 / BT_N
    tf = interop.codim2_branch_to_numpy(brf)
    th = interop.codim2_branch_to_numpy(brh)
    a, b = leg["nf"].nf["a"], leg["nf"].nf["b"]
    bt_sp = brf.gamma.specialpoint[leg["ibt"]]
    K11 = unf["K11"].cpu().numpy()
    checks = dict(
        fold_curve_gap=float(np.max(np.abs(tf["p1"] - tf["param"] ** 2 / 4))),
        bt_b2=float(bt_sp.param), curve_a=a, curve_b=b,
        exact_a_gap=abs(unf["a"] - s), exact_b_gap=abs(unf["b"] + s),
        K11=K11.tolist(), hopf_points=len(th["param"]),
        hopf_min_b2=float(np.min(th["param"])),
        hopf_b1_gap=float(np.max(np.abs(th["p1"]))),
        hopf_omega2_gap=float(np.max(np.abs(th["omega"] ** 2
                                            + th["param"]))),
        homoclinic_finite=bool(torch.all(torch.isfinite(
            leg["hom"]["orbit"](0.3)))))
    phase("codim2_bt_pde", unknowns=n, seconds=seconds, parts=leg["parts"],
          branch_steps=len(leg["br"]) - 1, fold_curve_steps=len(brf) - 1,
          hopf_steps=len(brh) - 1, special=list(tf["sp_type"]),
          fold_curve_itnewton=np.asarray(brf.gamma["itnewton"]).tolist(),
          hopf_itnewton=np.asarray(brh.gamma["itnewton"]).tolist(),
          gmres=log.summary(n), dia_spmv_launches=launches,
          sh_jv_launches=sh_launches, card=repr(card), **checks)
    ok = (checks["fold_curve_gap"] <= 1e-6 and abs(checks["bt_b2"]) < 5e-2
          and a * b < 0 and abs(abs(a) - s) < 0.1 * s
          and checks["exact_a_gap"] <= 1e-10
          and checks["exact_b_gap"] <= 1e-10
          and np.max(np.abs(K11 - [0.0, 2.0])) <= 1e-8
          and checks["hopf_points"] >= 5 and checks["hopf_min_b2"] < -0.2
          and checks["hopf_b1_gap"] <= 1e-6
          and checks["hopf_omega2_gap"] <= 1e-6
          and checks["homoclinic_finite"]
          and getattr(brh.gamma.prob, "ma_mf", False))
    if not ok:
        raise AssertionError(f"codim2_bt_pde: exact geometry fails: {checks}")
    if launches <= 0 or sh_launches != 0:
        raise AssertionError(f"codim2_bt_pde launched dia_spmv {launches} "
                             f"and sh_jv {sh_launches} times")
    _pde_breakdown("codim2_bt_pde_breakdown", stamps, BT_HOPF_STEPS)

    # the same forms at the same points through the plain version on the
    # card, and on the CPU (plain, one thread)
    _, _, x, params, _, _ = _codim2_point_context(brf, leg["ibt"])
    seed = brf.gamma.prob.params["_b"]
    card_f = {"curve_a": a, "curve_b": b,
              **{k: unf[k] for k in ("a", "b", "K10", "K11", "K2")}}
    t1 = time.perf_counter()
    plain = _bt_forms(bt_pde_model("cuda", spmv=dia_spmv_plain), x, params,
                      seed)
    plain_s = time.perf_counter() - t1
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    t1 = time.perf_counter()
    cpu = _bt_forms(bt_pde_model("cpu"), x.cpu(), _cpu(params), seed.cpu())
    cpu_s = time.perf_counter() - t1
    torch.set_num_threads(threads)
    gp, gc = _form_gaps(card_f, plain), _form_gaps(card_f, cpu)
    phase("codim2_bt_pde_check", plain_gaps=gp, cpu_gaps=gc, tol=PDE_RTOL,
          plain_seconds=plain_s, cpu_seconds=cpu_s)
    if not max(list(gp.values()) + list(gc.values())) <= PDE_RTOL:
        raise AssertionError(f"the BT forms through the kernel differ from "
                             f"the plain version's or the CPU's: {gp} {gc}")
    return launches


def _pde_breakdown(tag, stamps, steps):
    """One step of a switched matrix-free Hopf curve under torch.profiler
    (the step after stamp `steps - 1`) beside its unprofiled steps:
    launches, busy time, idle share and dia_spmv's share of the busy
    time."""
    if stamps.rows is None:
        raise AssertionError(f"{tag}: the profiled step did not run")
    timed = np.diff(stamps.t[:steps - 1])
    fields, busy = _busy_fields(stamps.rows, stamps.profiled_s, "dia_spmv",
                                timed, stamps.p[steps - 1])
    share = (fields["dia_spmv_device_s"] / busy) if busy else "not measured"
    phase(tag, step=steps, dia_spmv_share_of_busy=share, **fields)


def fh_pde_leg(device, stamps=None):
    """The flow of test_minaug_mf.py:471-534: the branch to its fold, the
    matrix-free fold curve in a with the ZH event (the inner spectrum by a
    128-wide Arnoldi: the default width carries about 0.2 of real-part
    bias here), `get_normal_form_codim2` at the ZH (matrix-free), and
    `switch_codim2` to the matrix-free Hopf curve."""
    prob = fh_pde_model(device)
    ls = _pde_ls(prob)
    parts = _Parts(device)
    br = bk.continuation(prob, bk.PALC(), bk.ContinuationPar(
        ds=0.02, dsmax=0.03, dsmin=1e-6, p_min=-0.3, p_max=0.3, max_steps=10,
        detect_bifurcation=0, detect_fold=True,
        newton_options=bk.NewtonPar(tol=1e-9, max_iterations=25,
                                    linsolver=ls)))
    parts("branch_s")
    ifold = next(i for i, sp in enumerate(br.specialpoint)
                 if sp.type == "fold")
    brf = bk.continuation_fold(br, ifold, "a", bk.ContinuationPar(
        ds=0.05, dsmax=0.1, dsmin=1e-6, p_min=-0.8, p_max=0.8,
        max_steps=FH_CURVE_STEPS, detect_bifurcation=2, nev=6,
        n_inversion=4, newton_options=bk.NewtonPar(
            tol=1e-9, max_iterations=25, linsolver=ls,
            eigsolver=bk.ArnoldiEig(which="LR", krylov_dim=128, restarts=8,
                                    tol=1e-6))),
        detect_codim2_bifurcation=2, jacobian_ma="minaug")
    parts("fold_curve_s")
    izh = _nearest(brf.gamma, "zh")
    nf = bk.get_normal_form_codim2(brf, izh)
    parts("normal_form_s")
    kw = {} if stamps is None else {"finalise_solution": stamps}
    brh = bk.switch_codim2(brf, izh, bk.ContinuationPar(
        ds=0.05, dsmax=0.1, dsmin=1e-6, p_min=-0.8, p_max=0.8,
        max_steps=FH_HOPF_STEPS, detect_bifurcation=0, detect_fold=False,
        newton_options=bk.NewtonPar(tol=1e-9, max_iterations=25,
                                    linsolver=ls)),
        detect_codim2_bifurcation=0, **kw)
    parts("switch_s")
    return dict(prob=prob, br=br, brf=brf, izh=izh, nf=nf, brh=brh,
                parts=parts.s)


def _zh_coefs(pt):
    """G200, G011, G110 aligned to q0 with a positive mean (they flip
    together with q0's sign), and omega."""
    sgn = float(torch.sign(torch.sum(pt.zeta[0])))
    return {"G200": sgn * pt.nf["G200"], "G011": sgn * pt.nf["G011"],
            "G110": sgn * pt.nf["G110"], "omega": pt.omega}


def codim2_zh_pde(card):
    """`fold_hopf_interaction_2d` at 32 x 32 on the card through dia_spmv,
    held to its exact geometry, the kernel against the plain version and
    the card against the CPU."""
    reset_launches()
    t0 = time.perf_counter()
    with GmresLog() as log:
        leg = fh_pde_leg("cuda")
    seconds = time.perf_counter() - t0
    launches = dia_spmv.launches
    sh_launches = sh_jv_mod.launch_count()
    prob, brf, brh = leg["prob"], leg["brf"], leg["brh"]
    n = prob.u0.numel()
    tf = interop.codim2_branch_to_numpy(brf)
    th = interop.codim2_branch_to_numpy(brh)
    zh_sp = brf.gamma.specialpoint[leg["izh"]]
    card_f = _zh_coefs(leg["nf"])
    exact = {"G200": 2.0 / FH_N, "G011": 0.0, "G110": 1.0 / FH_N}
    checks = dict(
        fold_curve_max_abs_p1=float(np.max(np.abs(tf["p1"]))),
        zh_a=float(zh_sp.param), forms=card_f,
        exact_gaps={k: abs(abs(card_f[k]) - g) for k, g in exact.items()},
        hopf_points=len(th["param"]),
        hopf_gap=float(np.max(np.abs(th["p1"] + th["param"] ** 2))),
        hopf_omega_gap=float(np.max(np.abs(th["omega"] - 1.0))))
    phase("codim2_zh_pde", unknowns=n, seconds=seconds, parts=leg["parts"],
          branch_steps=len(leg["br"]) - 1, fold_curve_steps=len(brf) - 1,
          hopf_steps=len(brh) - 1, special=list(tf["sp_type"]),
          fold_curve_itnewton=np.asarray(brf.gamma["itnewton"]).tolist(),
          hopf_itnewton=np.asarray(brh.gamma["itnewton"]).tolist(),
          gmres=log.summary(n), dia_spmv_launches=launches,
          sh_jv_launches=sh_launches, card=repr(card), **checks)
    ok = (checks["fold_curve_max_abs_p1"] <= 1e-8
          and abs(checks["zh_a"]) < 0.12
          and max(checks["exact_gaps"].values()) <= 1e-8
          and checks["hopf_points"] >= 4 and checks["hopf_gap"] <= 1e-8
          and checks["hopf_omega_gap"] <= 1e-9
          and getattr(brh.gamma.prob, "ma_mf", False))
    if not ok:
        raise AssertionError(f"codim2_zh_pde: exact geometry fails: {checks}")
    if launches <= 0 or sh_launches != 0:
        raise AssertionError(f"codim2_zh_pde launched dia_spmv {launches} "
                             f"and sh_jv {sh_launches} times")

    _, _, x, params, _, _ = _codim2_point_context(brf, leg["izh"])
    t1 = time.perf_counter()
    plain = _zh_coefs(bk.zh_normal_form(
        fh_pde_model("cuda", spmv=dia_spmv_plain), x, params,
        matrix_free=True))
    plain_s = time.perf_counter() - t1
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    t1 = time.perf_counter()
    cpu = _zh_coefs(bk.zh_normal_form(fh_pde_model("cpu"), x.cpu(),
                                      _cpu(params), matrix_free=True))
    cpu_s = time.perf_counter() - t1
    torch.set_num_threads(threads)
    gp, gc = _form_gaps(card_f, plain), _form_gaps(card_f, cpu)
    phase("codim2_zh_pde_check", plain_gaps=gp, cpu_gaps=gc, tol=PDE_RTOL,
          plain_seconds=plain_s, cpu_seconds=cpu_s)
    if not max(list(gp.values()) + list(gc.values())) <= PDE_RTOL:
        raise AssertionError(f"the ZH form through the kernel differs from "
                             f"the plain version's or the CPU's: {gp} {gc}")
    return launches


# the dense codim-2 family of check_small_codim2: Lorenz-84's zero-Hopf and
# its fold curve, the CO model's BT, cusp and Hopf curve, the BT model's
# Hopf curve from its BT, the two-oscillator model's other Hopf curve, the
# quintic Bautin model's unfolding (tests/_codim2_models.py, tests/
# test_torch_switch_codim2.py, tests/test_torch_co_tm.py)
L84_START = ({"a": 0.25, "b": 4.0, "G": 1.6, "F": 1.64},
             [1.18467, -0.013138, 0.337135, 0.0])


def _small_bt_model(dev):
    """x' = y, y' = b1 + b2 x + x^2 - x y, on its fold branch at
    (b1, b2) = (0.05, 0.6), near its fold at b1 = 0.09."""
    d = dict(dtype=torch.float64, device=dev)

    def F(u, par):
        return torch.stack([u[1], par["b1"] + par["b2"] * u[0]
                            + u[0] * u[0] - u[0] * u[1]])

    return bk.BifurcationProblem(
        F, u0=torch.tensor([-0.1, 0.0], **d),
        params={"b1": torch.tensor(0.05, **d), "b2": torch.tensor(0.6, **d)},
        lens="b1")


def _small_hh_model(dev):
    """Two oscillators with quadratic couplings: pair 1 on b1 = 0
    (omega 0.9), pair 2 on b2 + 0.4 b1 = 0 (omega 1.7)."""
    d = dict(dtype=torch.float64, device=dev)

    def F(u, par):
        x1, y1, x2, y2 = u[0], u[1], u[2], u[3]
        ua1, ua2 = x1 * x1 + y1 * y1, x2 * x2 + y2 * y2
        m1 = par["b1"] - 0.5 * ua1 - 1.0 * ua2
        m2 = par["b2"] + 0.4 * par["b1"] - 2.0 * ua1 - 1.5 * ua2
        q1r = 0.3 * (x1 * x2 - y1 * y2) + 0.1 * (x2 * x1 + y2 * y1)
        q1i = 0.3 * (x1 * y2 + y1 * x2) + 0.1 * (y2 * x1 - x2 * y1)
        q2r = 0.2 * (x1 * x1 - y1 * y1) + 0.15 * (x1 * x2 + y1 * y2)
        q2i = 0.2 * (2 * x1 * y1) + 0.15 * (y1 * x2 - x1 * y2)
        return torch.stack([m1 * x1 - 0.9 * y1 + q1r, m1 * y1 + 0.9 * x1 + q1i,
                            m2 * x2 - 1.7 * y2 + q2r,
                            m2 * y2 + 1.7 * x2 + q2i])

    return bk.BifurcationProblem(
        F, u0=torch.zeros(4, **d),
        params={"b1": torch.tensor(-0.06, **d),
                "b2": torch.tensor(-0.07, **d)}, lens="b1")


def _small_quintic(dev):
    """z' = (p1 + 1.3 i) z + (p2 + 0.4 i) z|z|^2 + (-2 + 0.1 i) z|z|^4."""
    d = dict(dtype=torch.float64, device=dev)

    def F(u, par):
        x, y = u[0], u[1]
        zz = x * x + y * y
        cr = par["p1"] + par["p2"] * zz - 2.0 * zz * zz
        ci = 1.3 + 0.4 * zz + 0.1 * zz * zz
        return torch.stack([cr * x - ci * y, cr * y + ci * x])

    return bk.BifurcationProblem(
        F, u0=torch.zeros(2, **d),
        params={"p1": torch.tensor(0.0, **d), "p2": torch.tensor(0.0, **d)},
        lens="p1")


def _first_of(gamma, kind):
    return next(i for i, sp in enumerate(gamma.specialpoint)
                if sp.type == kind)


def _small_family(dev):
    """The dense codim-2 cases on `dev`: (curves, coefficients)."""
    nt = lambda **kw: bk.NewtonPar(**kw)               # noqa: E731
    curves, coef = {}, {}
    # Lorenz-84: the Hopf curve in G from its branch's Hopf point, the
    # zero-Hopf that the GH test finds, its normal form, and the fold
    # curve through it
    par, u0 = L84_START
    l84 = models.lorenz84(params=par, device=dev).re_make(
        u0=torch.tensor(u0, dtype=torch.float64, device=dev))
    br = bk.continuation(l84, bk.PALC(), bk.ContinuationPar(
        ds=-0.005, dsmax=0.01, dsmin=1e-6, p_min=-1.0, p_max=5.0,
        max_steps=4, detect_bifurcation=3, nev=4, n_inversion=6,
        newton_options=nt(tol=1e-10, max_iterations=30)))
    cp2 = bk.ContinuationPar(
        ds=0.01, dsmax=0.03, dsmin=1e-6, p_min=0.0001, p_max=1.75,
        max_steps=4, detect_bifurcation=0, detect_fold=False,
        max_bisection_steps=4, newton_options=nt(tol=1e-9,
                                                 max_iterations=30))
    brh = bk.continuation_hopf(br, _first_of(br, "hopf"), "G", cp2,
                               detect_codim2_bifurcation=2)
    izh = _first_of(brh.gamma, "zh")
    _, inner, x, params, _, _ = _codim2_point_context(brh, izh)
    zh = bk.zh_normal_form(inner, x, params)
    coef["lorenz84_zh"] = _zh_coefs(zh)
    curves["lorenz84_hopf"] = brh
    curves["lorenz84_zh_fold"] = bk.switch_codim2(
        brh, izh, cp2.replace(max_steps=4))
    # CO: the fold curve in k from the branch's first fold both ways, its
    # BT (k up) and cusp (k down) forms, and l2 at a point of its Hopf curve
    co = models.co_oxidation(device=dev)
    brc = bk.continuation(co, bk.PALC(), bk.ContinuationPar(
        ds=0.002, dsmax=0.005, dsmin=1e-6, p_min=0.95, p_max=1.06,
        max_steps=60, detect_bifurcation=3, nev=3, n_inversion=6,
        max_bisection_steps=25, newton_options=nt(tol=1e-10)))
    ifold = next(i for i, sp in enumerate(brc.specialpoint)
                 if sp.type in ("fold", "bp"))
    for name, ds, dsmax, kind in (("co_fold_up", 0.02, 0.08, "bt"),
                                  ("co_fold_down", -0.005, 0.02, "cusp")):
        brf = bk.continuation_fold(brc, ifold, "k", bk.ContinuationPar(
            ds=ds, dsmax=dsmax, dsmin=1e-7, p_min=0.0, p_max=1.0,
            max_steps=10, detect_bifurcation=0, detect_fold=False,
            n_inversion=8, newton_options=nt(tol=1e-9, max_iterations=30)),
            detect_codim2_bifurcation=2)
        curves[name] = brf
        pt = bk.get_normal_form_codim2(brf, _first_of(brf.gamma, kind))
        coef[f"co_{kind}"] = dict(pt.nf)
    ih = _first_of(brc, "hopf")
    brch = bk.continuation_hopf(brc, ih, "k", bk.ContinuationPar(
        ds=-0.001, dsmax=0.02, dsmin=1e-6, p_min=0.0, p_max=2.8,
        max_steps=4, detect_bifurcation=0, detect_fold=False,
        newton_options=nt(tol=1e-9, max_iterations=30)),
        detect_codim2_bifurcation=0)
    curves["co_hopf"] = brch
    _, inner, x, params, _, _ = _codim2_point_context(
        brch, _first_of(brch.gamma, "endpoint"))
    gh = bk.bautin_normal_form(inner, x, params)
    coef["co_bautin"] = {k: gh.nf[k] for k in ("l1", "l2")}
    # the BT model: the fold curve to its BT, then the Hopf curve
    btm = _small_bt_model(dev)
    cpb = dict(dsmin=1e-5, nev=2, n_inversion=4,
               newton_options=nt(tol=1e-10, max_iterations=30))
    brb = bk.continuation(btm, bk.PALC(), bk.ContinuationPar(
        ds=0.01, dsmax=0.02, p_min=0.0, p_max=1.5, max_steps=12,
        detect_bifurcation=2, detect_fold=True, **cpb))
    cpf = bk.ContinuationPar(ds=-0.1, dsmax=0.2, p_min=-2.5, p_max=2.5,
                             max_steps=8, detect_bifurcation=0,
                             detect_fold=False, **cpb)
    brbf = bk.continuation_fold(brb, _first_of(brb, "fold"), "b2", cpf,
                                detect_codim2_bifurcation=2)
    curves["bt_model_hopf"] = bk.switch_codim2(
        brbf, _first_of(brbf.gamma, "bt"), cpf.replace(ds=-0.05,
                                                       max_steps=8))
    # the two-oscillator model: the first Hopf curve to its HH, then the
    # other Hopf curve
    hh = _small_hh_model(dev)
    brq = bk.continuation(hh, bk.PALC(), bk.ContinuationPar(
        ds=0.02, dsmax=0.05, dsmin=1e-6, p_min=-0.5, p_max=0.4, max_steps=6,
        detect_bifurcation=3, nev=4, n_inversion=6,
        newton_options=nt(tol=1e-10)))
    cph = bk.ContinuationPar(
        ds=0.02, dsmax=0.05, dsmin=1e-6, p_min=-0.5, p_max=0.5, max_steps=3,
        detect_bifurcation=3, nev=4, n_inversion=4, detect_fold=False,
        tol_stability=1e-6, newton_options=nt(tol=1e-10, max_iterations=25))
    brq2 = bk.continuation_hopf(brq, _first_of(brq, "hopf"), "b2", cph,
                                detect_codim2_bifurcation=2)
    curves["hh_other_hopf"] = bk.switch_codim2(
        brq2, _first_of(brq2.gamma, "hh"),
        cph.replace(max_steps=5, detect_bifurcation=0))
    # the quintic Bautin model: the unfolding and the fold-of-PO predictor
    qb = _small_quintic(dev)
    nf = bk.bautin_unfolding(qb, torch.zeros_like(qb.u0), qb.params,
                             bk.as_lens("p1"), bk.as_lens("p2"))
    pred = bk.predictor_fold_po(nf, 0.1)
    coef["quintic_bautin"] = {
        **{k: nf[k] for k in ("l1", "l2", "g110", "g101", "g210", "g201",
                              "omega")},
        "alpha0": float(nf["alpha"][0]), "alpha1": float(nf["alpha"][1]),
        "fold_po_p1": pred["p1"], "fold_po_p2": pred["p2"]}
    return curves, coef


def check_small_codim2_family():
    """The dense codim-2 family on the card against the CPU: curves to
    1e-9, coefficients to 1e-8 relative to max(|c|, 1)."""
    results, seconds = {}, {}
    threads = torch.get_num_threads()
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        torch.set_num_threads(1)          # small tensors: threads contend
        results[dev] = _small_family(dev)
        torch.set_num_threads(threads)
        _sync(dev)
        seconds[dev] = time.perf_counter() - t0
    (cc, fc), (cp_, fp_) = results["cuda"], results["cpu"]
    worst_curve, worst_coef = 0.0, 0.0
    for name in cc:
        a = interop.codim2_branch_to_numpy(cc[name])
        b = interop.codim2_branch_to_numpy(cp_[name])
        same = (len(a["param"]) == len(b["param"])
                and list(a["sp_type"]) == list(b["sp_type"]))
        gap = max(float(np.max(np.abs(a[k] - b[k])))
                  for k in ("param", "p1", "omega") if k in a) \
            if same else np.inf
        worst_curve = max(worst_curve, gap)
        phase("check_small_codim2", curve=name, steps=len(a["param"]) - 1,
              max_abs_gap=gap, special=list(a["sp_type"]),
              kind=cc[name].gamma.prob.ma_kind, seconds=seconds)
    for name in fc:
        gaps = _form_gaps(fc[name], fp_[name])
        worst_coef = max(worst_coef, max(gaps.values()))
        phase("check_small_codim2_form", case=name,
              coefficients={k: (complex(v) if isinstance(v, complex)
                                else float(v)) for k, v in fc[name].items()},
              rel_gaps=gaps, tol=PDE_RTOL)
    if not (worst_curve <= 1e-9 and worst_coef <= PDE_RTOL):
        raise AssertionError(f"the dense codim-2 family on the card differs "
                             f"from the CPU's: curves {worst_curve}, "
                             f"coefficients {worst_coef}")


# ---------------------------------------------------------------------------
# 4l. po_bvam: periodic-orbit codim-2 on the BVAM period-doubling PDE
# ---------------------------------------------------------------------------

# examples/pd_1d.py at its default N = 100 (state (2, N)): Collocation
# (Ntst=30, m=4), 24,201 PO unknowns; the period-2 branch on
# Collocation(60, 4), 48,201; the functional PD curve in D, 24,202
BVAM_N = 100
BVAM_HOPF, BVAM_HOPF_TOL = -0.867, 5e-3     # test_pd1d.py's windows
BVAM_PD, BVAM_PD_TOL = -1.327, 2e-2
BVAM_SMALL_N = 10           # card against CPU, dense Iooss on both
BVAM_SWITCH_STEPS = 4
BVAM_CURVE_STEPS = 3
BVAM_BUDGET_S = 240         # po_bvam and check_small_po_codim2 together
SIGMA_GRAD_RTOL = 1e-8      # closed form against torch.func (plain route)
PO_RTOL = 1e-8              # coefficients card against CPU
PO_CURVE_TOL = 1e-9         # curves card against CPU


def bvam_model(device, N=BVAM_N, **kw):
    return models.bvam_1d(N=N, device=device, **kw)


def bvam_leg(device, N=BVAM_N, iooss=True, switch_steps=BVAM_SWITCH_STEPS,
             curve_steps=BVAM_CURVE_STEPS, stamps=None, spmv=None):
    """The flow of test_pd1d.py at N: Newton on the Turing pattern, the
    equilibrium branch in C (nev = 21, Hopf near C = -0.867),
    `continuation_hopf_po(use_cop=True)` with FloquetColl to the PD
    cascade, `period_doubling_iooss` at the first PD (the dense
    collocation operators), `pd_branch_switch` (4 steps on the doubled
    mesh) and the functional PD curve in D (3 steps from D = 0.08)."""
    kw = {} if spmv is None else {"spmv": spmv}
    prob = bvam_model(device, N, **kw)
    parts = _Parts(device)
    sol = bk.newton(prob, bk.NewtonPar(tol=1e-9, max_iterations=100))
    if not bool(sol.converged):
        raise AssertionError("bvam: Newton on the Turing pattern failed")
    parts("newton_s")
    cp = bk.ContinuationPar(ds=-0.001, dsmax=0.051, dsmin=1e-5, p_min=-1.8,
                            p_max=0.0, max_steps=40, detect_bifurcation=3,
                            nev=21, n_inversion=10,
                            newton_options=bk.NewtonPar(tol=1e-9,
                                                        max_iterations=25))
    br = bk.continuation(prob.re_make(u0=sol.u), bk.PALC(), cp)
    parts("equilibria_s")
    ih = next(i for i, sp in enumerate(br.specialpoint) if sp.type == "hopf")
    cpo = bk.ContinuationPar(ds=0.01, dsmax=0.015, dsmin=1e-4, p_min=-1.8,
                             p_max=0.0, max_steps=40, detect_bifurcation=3,
                             n_inversion=6, tol_stability=1e-4,
                             newton_options=bk.NewtonPar(
                                 tol=1e-8, max_iterations=20,
                                 eigsolver=bk.FloquetColl()))
    brpo = bk.continuation_hopf_po(br, ih, cpo, bk.Collocation(Ntst=30, m=4),
                                   use_cop=True)
    parts("po_branch_s")
    pds = [i for i, sp in enumerate(brpo.gamma.specialpoint)
           if sp.type == "pd"]
    if not pds:
        raise AssertionError(f"bvam: no PD on the PO branch: "
                             f"{[sp.type for sp in brpo.gamma.specialpoint]}")
    ipd = pds[0]
    out = dict(prob=prob, sol=sol, br=br, ih=ih, brpo=brpo, pds=pds,
               ipd=ipd)
    if iooss:
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        out["iooss"] = bk.period_doubling_iooss(brpo, ipd)
        parts("iooss_s")
        if torch.device(device).type == "cuda":
            out["iooss_peak_bytes"] = torch.cuda.max_memory_allocated()
    cpd = brpo.gamma.contparams.replace(
        ds=-0.005, max_steps=switch_steps, detect_bifurcation=0,
        save_sol_every_step=1,
        newton_options=bk.NewtonPar(tol=1e-9, max_iterations=40,
                                    linesearch=True))
    out["br2"] = bk.pd_branch_switch(brpo, ipd, cpd, ampfactor=0.02,
                                     use_cop=True)
    parts("pd_switch_s")
    cp2 = bk.ContinuationPar(
        ds=2e-3, dsmax=5e-3, dsmin=1e-7, p_min=0.05, p_max=0.12,
        max_steps=curve_steps, detect_bifurcation=0, detect_event=0,
        save_sol_every_step=1,
        newton_options=bk.NewtonPar(tol=1e-7, max_iterations=30))
    kwc = {} if stamps is None else {"finalise_solution": stamps}
    out["brc"] = bk.continuation_pd(brpo, ipd, "D", cp2, detect_codim3=0,
                                    **kwc)
    parts("pd_curve_s")
    out["parts"] = parts.s
    return out


def _bvam_pd_curve_floquet(brpo, brc):
    """FloquetColl at the PD curve's last point, on the inner orbit."""
    po_prob = brpo.gamma.prob
    maprob = brc.gamma.prob
    sol = brc.gamma.sol[-1]
    Y = torch.as_tensor(sol["x"])
    nX = po_prob.u0.shape[0]
    par = maprob.set_lens_param(maprob.params, float(sol["p"]))
    po_par = {k: v for k, v in par.items() if k not in ("_a", "_b")}
    po_par["_inner"] = bk.as_lens(po_prob.prob_vf.lens).set(
        par["_inner"], float(Y[nX]))
    blocks = bk.collocation_block_jacobian(po_prob.disc, po_prob.prob_vf,
                                           Y[:nX], po_par)
    expo, _, _, _ = bk.FloquetColl()(blocks, 4)
    return np.exp(expo.cpu().numpy())


def _bvam_checks(leg):
    """test_pd1d.py's checks on a BVAM leg, as numbers and one verdict."""
    br, brpo, ipd = leg["br"], leg["brpo"], leg["ipd"]
    sp = brpo.gamma.specialpoint[ipd]
    po_prob = brpo.gamma.prob
    hopf = float(br.specialpoint[leg["ih"]].param)
    M = po_prob.disc.monodromy(po_prob.prob_vf, torch.as_tensor(sp.x),
                               po_prob.set_lens_param(po_prob.params,
                                                      sp.param))
    mult = np.linalg.eigvals(M.cpu().numpy())
    orb = bk.get_periodic_orbit(leg["br2"], 0)
    half = orb["u"].shape[0] // 2
    tab = leg["brc"].gamma._table()
    mu_curve = _bvam_pd_curve_floquet(brpo, leg["brc"])
    c = dict(hopf=hopf, pd=[float(brpo.gamma.specialpoint[i].param)
                            for i in leg["pds"]],
             pd_multiplier_gap=float(np.min(np.abs(mult + 1.0))),
             halves_gap=float(np.abs(orb["u"][:half]
                                     - orb["u"][half:2 * half]).max()),
             period2=orb["period"], period1=float(sp.x[-1]),
             curve_points=len(tab["param"]),
             curve_D_span=float(np.ptp(tab["param"])),
             curve_p1_jump=float(np.max(np.abs(np.diff(tab["p1"])))),
             curve_multiplier_gap=float(np.min(np.abs(mu_curve + 1.0))))
    ok = (len(c["pd"]) >= 2 and c["pd_multiplier_gap"] < 1e-2
          and c["halves_gap"] > 0.1
          and abs(c["period2"] - 2 * c["period1"]) < 0.2
          and c["curve_points"] >= 3 and c["curve_D_span"] > 5e-4
          and c["curve_p1_jump"] < 0.1 and c["curve_multiplier_gap"] < 5e-2)
    return c, ok


def _trel(a, b):
    """max |a - b| over max |b|, for tensors."""
    return float((a - b).abs().max() / b.abs().max())


class SpmvBatches:
    """`spmv` for a model: `dia_spmv` (the kernel, which counts its own
    launches) recording each product's batch of rows."""

    def __init__(self):
        self.by_rows = {}

    def __call__(self, A, v):
        k = int(v.shape[0]) if v.dim() == 2 else 1
        self.by_rows[k] = self.by_rows.get(k, 0) + 1
        return dia_spmv(A, v)


def po_bvam(card):
    """The BVAM period-doubling PDE at N = 100 on the card (f64, every J.v
    through dia_spmv): test_pd1d.py's flow and checks at full width, the
    Iooss form's peak memory, the PD curve's sigma gradient against
    torch.func through the plain version, one profiled PD-curve step
    (`po_bvam_breakdown`)."""
    reset_launches()
    batches = SpmvBatches()
    stamps = StepStamps(profile_after=BVAM_CURVE_STEPS - 1)
    t0 = time.perf_counter()
    leg = bvam_leg("cuda", stamps=stamps, spmv=batches)
    seconds = time.perf_counter() - t0
    launches = dia_spmv.launches
    by_rows = dict(sorted(batches.by_rows.items()))
    sh_launches = sh_jv_mod.launch_count()
    checks, ok = _bvam_checks(leg)
    brpo, brc = leg["brpo"], leg["brc"]
    iooss = leg["iooss"].nf
    po_n = brpo.gamma.prob.u0.numel()
    windows = (abs(checks["hopf"] - BVAM_HOPF) <= BVAM_HOPF_TOL
               and abs(checks["pd"][0] - BVAM_PD) <= BVAM_PD_TOL)
    phase("po_bvam", N=BVAM_N, po_unknowns=po_n,
          period2_unknowns=leg["br2"].gamma.prob.u0.numel(),
          curve_unknowns=brc.gamma.prob.u0.numel(), seconds=seconds,
          parts=leg["parts"], special=[sp.type for sp in
                                       brpo.gamma.specialpoint],
          po_itnewton=np.asarray(brpo.gamma["itnewton"]).tolist(),
          switch_itnewton=np.asarray(leg["br2"].gamma["itnewton"]).tolist(),
          curve_itnewton=np.asarray(brc.gamma["itnewton"]).tolist(),
          iooss_a=iooss["a"], iooss_b3=iooss["b3"],
          iooss_peak_bytes=leg.get("iooss_peak_bytes"),
          windows_ok=windows, dia_spmv_launches=launches,
          dia_spmv_launches_by_rows=by_rows,
          sh_jv_launches=sh_launches, card=repr(card), **checks)
    if not (ok and windows):
        raise AssertionError(f"po_bvam: checks fail: {checks}")
    if launches <= 0 or sh_launches != 0:
        raise AssertionError(f"po_bvam launched dia_spmv {launches} and "
                             f"sh_jv {sh_launches} times")
    _pde_breakdown("po_bvam_breakdown", stamps, BVAM_CURVE_STEPS)

    # the sigma gradient at the curve's first point against torch.func
    # through the plain jacobian of F; the model's J.v through the kernel
    # against the plain version at the phase's batch shapes
    maprob = brc.gamma.prob
    Y, par = maprob.u0, maprob.params
    n0 = dia_spmv.launches
    J = maprob.jac(Y, par)
    n1 = dia_spmv.launches
    t1 = time.perf_counter()
    ref = bk.periodic.codim2.po_sigma_autodiff(maprob, Y, par)
    autodiff_s = time.perf_counter() - t1
    autodiff_launches = dia_spmv.launches - n1
    grad_gap = max(_trel(J.sig_X, ref[0]), _trel(J.sig_p1, ref[1]))
    prob = leg["prob"]
    dev, N = prob.u0.device, prob.u0.shape[-1]
    plain = bvam_model(dev, N, spmv=dia_spmv_plain)
    g = torch.Generator().manual_seed(6)
    u = torch.randn((2, N), generator=g, dtype=torch.float64).to(dev)
    jv_gap = 0.0
    for k in sorted(batches.by_rows):
        v = torch.randn((max(k // 2, 1), 2, N), generator=g,
                        dtype=torch.float64).to(dev)
        jv_gap = max(jv_gap, _trel(prob.jac_op(u, prob.params)(v),
                                   plain.jac_op(u, plain.params)(v)))
    # the Iooss form at the same PD point with every J.v through the
    # plain version (a and b3 to PO_RTOL relative to max(|c|, 1))
    sp = brpo.gamma.specialpoint[leg["ipd"]]
    po_prob = brpo.gamma.prob
    pf = po_prob.set_lens_param(po_prob.params, sp.param)
    plain_vf, _ = bk.periodic.orbits._flat_vector_field(plain)
    n2 = dia_spmv.launches
    t2 = time.perf_counter()
    ref_nf = bk.periodic.normal_forms._pd_iooss_core(
        po_prob.disc, plain_vf, po_prob.n_vf, torch.as_tensor(sp.x),
        pf["_inner"], pf["_mesh"])
    iooss_plain_s = time.perf_counter() - t2
    iooss_gap = max(abs(float(iooss[k]) - float(ref_nf[k]))
                    / max(abs(float(ref_nf[k])), 1.0) for k in ("a", "b3"))
    phase("po_bvam_check", sigma_grad_rel_gap=grad_gap,
          sigma_grad_tol=SIGMA_GRAD_RTOL, autodiff_s=autodiff_s,
          autodiff_dia_launches=autodiff_launches,
          closed_form_dia_launches=n1 - n0, jac_op_rel_gap=jv_gap,
          iooss_plain_a=float(ref_nf["a"]),
          iooss_plain_b3=float(ref_nf["b3"]), iooss_rel_gap=iooss_gap,
          iooss_tol=PO_RTOL, iooss_plain_s=iooss_plain_s,
          iooss_plain_dia_launches=dia_spmv.launches - n2)
    if not (grad_gap <= SIGMA_GRAD_RTOL and jv_gap <= 1e-12
            and autodiff_launches == 0 and n1 > n0
            and iooss_gap <= PO_RTOL and dia_spmv.launches == n2):
        raise AssertionError(f"po_bvam: sigma gradient {grad_gap}, J.v "
                             f"{jv_gap} or the Iooss form {iooss_gap} off")
    return launches, by_rows


def _analytic_models(dev):
    """The constructed Bautin and zero-Hopf models of test_po_switch.py
    (real arithmetic) with their start points."""
    om, c1, l5, c2 = 1.3, 0.4, -2.0, 0.1
    omz, a, b, cr, ci, dr, di = 1.5, 1.0, -1.0, 0.5, 0.3, -1.0, 0.2

    def bautin(u, par):
        x, y = u[0], u[1]
        zz = x * x + y * y
        return torch.stack([
            par["p1"] * x - om * y + zz * (par["p2"] * x - c1 * y)
            + zz * zz * (l5 * x - c2 * y),
            par["p1"] * y + om * x + zz * (par["p2"] * y + c1 * x)
            + zz * zz * (l5 * y + c2 * x)])

    def zh(u, par):
        x, p, q = u[0], u[1], u[2]
        zz = p * p + q * q
        return torch.stack([
            par["p1"] + a * x * x + b * zz,
            par["p2"] * p - omz * q + x * (cr * p - ci * q)
            + zz * (dr * p - di * q),
            par["p2"] * q + omz * p + x * (cr * q + ci * p)
            + zz * (dr * q + di * p)])

    def make(F, u0, **pars):
        return bk.BifurcationProblem(
            F, u0=torch.tensor(u0, dtype=torch.float64, device=dev),
            params={k: torch.tensor(v, dtype=torch.float64, device=dev)
                    for k, v in pars.items()}, lens="p1")

    return (make(bautin, [0.0, 0.0], p1=-0.05, p2=-0.3), l5,
            make(zh, [-0.3, 0.0, 0.0], p1=-0.09, p2=0.05))


# the switched PO curves of the constructed models: 3 steps (4 until PR 10)
ANALYTIC_STEPS = 3


def _analytic_switch(prob, cp_kw, cp2_kw, kind, eps, steps):
    cp = bk.ContinuationPar(newton_options=bk.NewtonPar(tol=1e-10),
                            detect_bifurcation=3, nev=3, n_inversion=4,
                            **cp_kw)
    br = bk.continuation(prob, bk.PALC(), cp)
    i = next(k for k, sp in enumerate(br.specialpoint) if sp.type == "hopf")
    brh = bk.continuation_hopf(br, i, "p2", bk.ContinuationPar(
        detect_bifurcation=0, detect_fold=False,
        newton_options=bk.NewtonPar(tol=1e-10, max_iterations=30),
        **cp2_kw), detect_codim2_bifurcation=2)
    cand = [k for k, sp in enumerate(brh.gamma.specialpoint)
            if sp.type in ("zh", "gh") and abs(sp.param) < 0.05]
    cp3 = bk.ContinuationPar(
        ds=0.002, dsmax=0.01 if kind == "gh" else 0.005, dsmin=1e-8,
        p_min=0.0001, p_max=0.3, max_steps=steps, detect_bifurcation=0,
        detect_event=0, newton_options=bk.NewtonPar(tol=1e-8,
                                                    max_iterations=30))
    return bk.switch_codim2_po(brh, cand[0], cp3,
                               disc=bk.Collocation(Ntst=30, m=4), eps=eps,
                               detect_codim3=0, as_type=kind)


def _small_po_family(dev):
    """The small PO codim-2 family on `dev`: curve tables (numpy) and
    coefficients (numbers), for the card against the CPU."""
    from bifurcationkit.jl_tpu_torch.periodic import codim2 as pc2

    curves, coefs, secs = {}, {}, {}
    t = time.perf_counter()
    # Lur'e: the PO branch to its PD, the PD curve with the codim-3
    # monitor, the PD switch on the three discretizations, the PRM form
    prob = models.lure(alpha=1.2, beta=1.0, device=dev)
    br = bk.continuation(prob, bk.PALC(tangent=bk.Bordered()),
                         bk.ContinuationPar(
                             ds=-0.01, dsmax=0.02, dsmin=1e-6, p_min=0.9,
                             p_max=1.4, max_steps=120, detect_bifurcation=3,
                             nev=3, n_inversion=6,
                             newton_options=bk.NewtonPar(tol=1e-10)))
    ih = next(i for i, s in enumerate(br.specialpoint) if s.type == "hopf")
    br_po = bk.continuation_hopf_po(br, ih, bk.ContinuationPar(
        ds=-0.01, dsmax=0.03, dsmin=1e-7, p_min=0.2, p_max=1.05,
        max_steps=100, detect_bifurcation=3, nev=3, n_inversion=4,
        max_bisection_steps=15, tol_stability=1e-4,
        newton_options=bk.NewtonPar(tol=1e-9, max_iterations=25)),
        disc=bk.Collocation(Ntst=25, m=4), delta_p=-0.01)
    ipd = next(i for i, s in enumerate(br_po.gamma.specialpoint)
               if s.type == "pd")
    events = []
    brpd = bk.continuation_pd(br_po, ipd, "beta", bk.ContinuationPar(
        ds=0.02, dsmax=0.05, dsmin=1e-6, p_min=0.8, p_max=1.4, max_steps=3,
        detect_bifurcation=0, detect_fold=False,
        newton_options=bk.NewtonPar(tol=1e-9, max_iterations=15)),
        detect_codim3=1, nf_flow_steps=60,
        finalise_solution=lambda *a, state=None, **k: events.append(
            state.event_values[0]))
    curves["lure_pd_curve"] = brpd
    coefs["lure_gpd_cusp_r2"] = np.asarray(events[-1], dtype=float)
    nfp = bk.get_normal_form(br_po, ipd, flow_steps=60)
    coefs["lure_prm_c"] = nfp.nf["c"]
    coefs["lure_iooss_b3"] = bk.period_doubling_iooss(br_po, ipd).nf["b3"]
    cp_sw = bk.ContinuationPar(ds=-0.01, dsmax=0.02, dsmin=1e-7, p_min=0.2,
                               p_max=1.05, max_steps=2, detect_bifurcation=0,
                               detect_fold=False,
                               newton_options=bk.NewtonPar(
                                   tol=1e-8, max_iterations=30,
                                   linesearch=True))
    sp = br_po.gamma.specialpoint[ipd]
    curves["lure_pd_switch_coll"] = bk.pd_branch_switch(
        br_po, ipd, cp_sw, ampfactor=0.05, delta_p=-0.005)
    nodes, T1 = sp.x[:-1].reshape(-1, 3), float(sp.x[-1])
    par_pd = prob.set_lens_param(prob.params, float(sp.param))
    for name, disc, X0 in (
            ("trapeze", bk.Trapeze(M=nodes.shape[0]), None),
            ("shooting", bk.Shooting(M=3, steps_per_segment=40,
                                     method="rk4"), None)):
        if name == "trapeze":
            X0 = disc.pack(nodes, T1)
        else:
            idx = [int(round(f * (nodes.shape[0] - 1)))
                   for f in np.linspace(0, 1, 3, endpoint=False)]
            X0 = disc.pack(nodes[idx], T1)
        sol, _ = bk.newton_po(prob, disc, X0, params=par_pd,
                              options=bk.NewtonPar(tol=1e-9,
                                                   max_iterations=30))
        brd = bk.continuation_po(prob, disc, sol.u, bk.ContinuationPar(
            ds=-0.004, dsmax=0.006, dsmin=1e-8, p_min=0.2, p_max=1.05,
            max_steps=4, detect_bifurcation=3, nev=3, n_inversion=4,
            tol_stability=1e-3, newton_options=bk.NewtonPar(
                tol=1e-8, max_iterations=30)), params=par_pd)
        k = next(i for i, s in enumerate(brd.gamma.specialpoint)
                 if s.type == "pd")
        X2, _ = pc2.pd_doubled_guess(brd.gamma.prob,
                                     brd.gamma.specialpoint[k], 0.05)
        coefs[f"lure_pd_guess_{name}_norm"] = float(
            torch.linalg.vector_norm(X2))
        curves[f"lure_pd_switch_{name}"] = bk.pd_branch_switch(
            brd, k, cp_sw, ampfactor=0.05, delta_p=-0.005)
    secs["lure"] = time.perf_counter() - t

    # Freire: the BP switch, NS and PD on the switched branch, the NS
    # Iooss form, a 3-step NS curve
    t = time.perf_counter()
    fprob = models.freire(device=dev)
    fbr = bk.continuation(fprob, bk.PALC(), bk.ContinuationPar(
        ds=0.01, dsmax=0.05, dsmin=1e-6, p_min=-1.0, p_max=-0.55,
        max_steps=200, detect_bifurcation=3, nev=3, n_inversion=8,
        newton_options=bk.NewtonPar(tol=1e-10)))
    fih = next(i for i, s in enumerate(fbr.specialpoint) if s.type == "hopf")
    fpo = bk.continuation_hopf_po(fbr, fih, bk.ContinuationPar(
        ds=-0.001, dsmax=0.01, dsmin=1e-8, p_min=-0.7, p_max=-0.4,
        max_steps=20, detect_bifurcation=3, nev=4, n_inversion=6,
        max_bisection_steps=15, tol_stability=1e-4,
        newton_options=bk.NewtonPar(tol=1e-9, max_iterations=25)),
        disc=bk.Collocation(Ntst=30, m=4), delta_p=0.001, use_cop=True)
    ibp = next(i for i, s in enumerate(fpo.gamma.specialpoint)
               if s.type == "bp" and abs(s.param + 0.587) < 2e-3)
    fbr2 = bk.bp_po_branch_switch(fpo, ibp, bk.ContinuationPar(
        ds=-0.001, dsmax=0.005, dsmin=1e-8, p_min=-0.7, p_max=-0.4,
        max_steps=16, detect_bifurcation=3, nev=4, n_inversion=6,
        tol_stability=1e-4, newton_options=bk.NewtonPar(
            tol=1e-8, max_iterations=30)), ampfactor=0.01, delta_p=-0.001,
        use_cop=True)
    curves["freire_switched"] = fbr2
    types = [s.type for s in fbr2.gamma.specialpoint]
    if not ("ns" in types and "pd" in types):
        raise AssertionError(f"freire: switched branch has {types}")
    ins = types.index("ns")
    nsf = bk.neimark_sacker_iooss(fbr2, ins)
    coefs["freire_ns_iooss_a"], coefs["freire_ns_iooss_d"] = \
        nsf.nf["a"], nsf.nf["d"]
    curves["freire_ns_curve"] = bk.continuation_ns(
        fbr2, ins, "beta", bk.ContinuationPar(
            ds=1e-3, dsmax=3e-3, dsmin=1e-8, p_min=0.3, p_max=0.7,
            max_steps=3, detect_bifurcation=0, detect_event=0,
            newton_options=bk.NewtonPar(tol=1e-7, max_iterations=30)),
        detect_codim3=0)
    secs["freire"] = time.perf_counter() - t

    # switch_codim2_po on the constructed models (closed-form curves)
    t = time.perf_counter()
    bprob, l5, zprob = _analytic_models(dev)
    curves["gh_fold_po"] = _analytic_switch(
        bprob, dict(ds=0.005, dsmax=0.01, dsmin=1e-7, p_min=-0.06,
                    p_max=0.05, max_steps=60),
        dict(ds=0.02, dsmax=0.04, dsmin=1e-7, p_min=-0.4, p_max=0.02,
             max_steps=30), "gh", 0.07, ANALYTIC_STEPS)
    curves["zh_ns"] = _analytic_switch(
        zprob, dict(ds=0.005, dsmax=0.01, dsmin=1e-7, p_min=-0.1,
                    p_max=-0.001, max_steps=100),
        dict(ds=-0.005, dsmax=0.01, dsmin=1e-7, p_min=-0.02, p_max=0.2,
             max_steps=30), "zh", 0.08, ANALYTIC_STEPS)
    tg = curves["gh_fold_po"].gamma._table()
    tz = curves["zh_ns"].gamma._table()
    coefs["gh_curve_gap"] = float(np.max(np.abs(
        np.asarray(tg["p1"]) - np.asarray(tg["param"]) ** 2 / (4 * l5))))
    coefs["zh_curve_gap"] = float(np.max(np.abs(
        np.asarray(tz["p1"]) - 2 * np.asarray(tz["param"])
        + 4 * np.asarray(tz["param"]) ** 2)))
    secs["analytic"] = time.perf_counter() - t

    # Lorenz-84: its ZH on the Hopf curve in G (cut just past it, at
    # G = 1.75) to the NS curve, 2 steps (test_po_switch.py:225-268 runs
    # 8; 3 until PR 10); the direct MA start collapses onto the trivial
    # multiplier there
    # and the on-branch fallback delivers the curve
    t = time.perf_counter()
    lz = models.lorenz84(device=dev)
    lbr = bk.continuation(lz, bk.PALC(), bk.ContinuationPar(
        ds=0.01, dsmax=0.04, dsmin=1e-6, p_min=-1.0, p_max=5.0,
        max_steps=300, detect_bifurcation=3, nev=4, n_inversion=6,
        newton_options=bk.NewtonPar(tol=1e-10, max_iterations=30)))
    lih = next(i for i, s_ in enumerate(lbr.specialpoint)
               if s_.type == "hopf")
    lbh = bk.continuation_hopf(lbr, lih, "G", bk.ContinuationPar(
        ds=0.01, dsmax=0.03, dsmin=1e-6, p_min=0.0001, p_max=1.75,
        max_steps=100, detect_bifurcation=0, detect_fold=False,
        newton_options=bk.NewtonPar(tol=1e-9, max_iterations=30)),
        detect_codim2_bifurcation=2)
    izh = next(i for i, s_ in enumerate(lbh.gamma.specialpoint)
               if s_.type == "zh")
    lns = bk.switch_codim2_po(lbh, izh, bk.ContinuationPar(
        ds=-0.003, dsmax=0.01, dsmin=1e-9, p_min=0.5, p_max=2.5,
        max_steps=2, detect_bifurcation=0, detect_event=0,
        newton_options=bk.NewtonPar(tol=1e-8, max_iterations=40)),
        disc=bk.Collocation(Ntst=40, m=4), eps=0.15, detect_codim3=0)
    curves["lorenz84_ns"] = lns
    mult = bk.po_codim2_test_values(lns, -1)["multipliers"]
    coefs["lorenz84_ns_unit_gap"] = float(np.min(np.abs(np.abs(
        mult[np.abs(mult.imag) > 1e-6]) - 1.0)))
    secs["lorenz84"] = time.perf_counter() - t

    # BVAM at N = 10: the slice's flow with the dense Iooss
    t = time.perf_counter()
    leg = bvam_leg(dev, N=BVAM_SMALL_N, switch_steps=2, curve_steps=2)
    curves["bvam_po"] = leg["brpo"]
    curves["bvam_pd_curve"] = leg["brc"]
    coefs["bvam_iooss_a"] = leg["iooss"].nf["a"]
    coefs["bvam_iooss_b3"] = leg["iooss"].nf["b3"]
    secs["bvam_small"] = time.perf_counter() - t
    _sync(dev)
    return curves, coefs, secs


def _table_gap(a, b):
    """The largest gap of the comparable columns of two branch tables,
    inf when their lengths or special points differ."""
    ta, tb = a.gamma._table(), b.gamma._table()
    if len(ta["param"]) != len(tb["param"]) or \
            [s.type for s in a.gamma.specialpoint] != \
            [s.type for s in b.gamma.specialpoint]:
        return np.inf
    return max(float(np.max(np.abs(np.asarray(ta[k], dtype=complex)
                                   - np.asarray(tb[k], dtype=complex))))
               for k in ("param", "p1", "period", "theta") if k in ta)


def check_small_po_codim2():
    """The small PO codim-2 family on the card against the CPU: curves to
    1e-9, coefficients to 1e-8 relative to max(|c|, 1); the analytic PO
    curves to 1e-7 (fold of cycles) and 1e-6 (NS); Lorenz-84's NS
    curve's complex multipliers on the unit circle to 1e-8."""
    out, seconds = {}, {}
    threads = torch.get_num_threads()
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        torch.set_num_threads(1)
        out[dev] = _small_po_family(dev)
        torch.set_num_threads(threads)
        seconds[dev] = time.perf_counter() - t0
    (cc, fc, sc), (cp_, fp_, sp_) = out["cuda"], out["cpu"]
    worst_curve = 0.0
    for name in cc:
        gap = _table_gap(cc[name], cp_[name])
        worst_curve = max(worst_curve, gap)
        phase("check_small_po_codim2", curve=name,
              steps=len(cc[name].gamma) - 1, max_abs_gap=gap,
              special=[s.type for s in cc[name].gamma.specialpoint])
    gaps = {k: float(np.max(np.abs(np.asarray(fc[k]) - np.asarray(fp_[k]))
                            / np.maximum(np.abs(np.asarray(fp_[k])), 1.0)))
            for k in fc if not k.endswith("_gap")}
    phase("check_small_po_codim2_coefficients",
          coefficients={k: (v.tolist() if isinstance(v, np.ndarray)
                            else complex(v) if isinstance(v, complex)
                            else float(v)) for k, v in fc.items()},
          rel_gaps=gaps, seconds=seconds, parts={"cuda": sc, "cpu": sp_})
    analytic = (fc["gh_curve_gap"] <= 1e-7 and fc["zh_curve_gap"] <= 1e-6
                and fp_["gh_curve_gap"] <= 1e-7
                and fp_["zh_curve_gap"] <= 1e-6
                and fc["lorenz84_ns_unit_gap"] <= 1e-8
                and fp_["lorenz84_ns_unit_gap"] <= 1e-8)
    if not (worst_curve <= PO_CURVE_TOL and max(gaps.values()) <= PO_RTOL
            and analytic):
        raise AssertionError(
            f"the small PO codim-2 family: curves {worst_curve}, "
            f"coefficients {gaps}, analytic {fc['gh_curve_gap']} "
            f"{fc['zh_curve_gap']}")


# ---------------------------------------------------------------------------
# 4g. po_cgl: cGL2d trapezoid periodic orbits, matrix-free Floquet
# ---------------------------------------------------------------------------

# bench.py:620-700: 41x21 grid, 1,722 vector-field unknowns, M = 51 slices,
# 87,823 unknowns; depth cut to 1 warm + 2 timed steps (the bench's 2 + 5)
PO_NX, PO_NY, PO_M = 41, 21, 51
PO_WARM, PO_TIMED = 1, 2   # 3 timed steps until PR 10
PO_SMALL = (21, 11)           # examples/cgl2d.py:24, card against CPU
PO_FLOQUET_TOL = 1e-4         # SubspaceEig against the dense monodromy
# the witness solve's SubspaceEig (the bench's: sweeps 2, blocks 3, extra 4)
PO_WITNESS_EIG = dict(sweeps=4, krylov_blocks=4, extra=8, tol=1e-6)
PO_SMALL_RTOL, PO_SMALL_MU = 1e-7, 1e-5


class BlockLog:
    """Counts the batched GMRES solves (`linear._gmres_block`) while
    active: calls, columns and matvecs per column.  In the PO path each
    call is one slice of a matrix-free monodromy application."""

    def __init__(self):
        self.calls = self.columns = self.matvecs = 0

    def __enter__(self):
        self._orig = linear._gmres_block

        def logged(matvec_block, B, *args):
            out = self._orig(matvec_block, B, *args)
            self.calls += 1
            self.columns += int(B.shape[0])
            self.matvecs += int(np.sum(out[2]))
            return out

        linear._gmres_block = logged
        return self

    def __exit__(self, *exc):
        linear._gmres_block = self._orig

    def snapshot(self):
        return (self.calls, self.columns, self.matvecs)


def _cgl_hopf(Nx, Ny):
    """The exact Hopf point of the trivial state: r* = -lambda_1(Delta)
    and omega = nu (bench.py:643-648)."""
    hx, hy = 2 * np.pi / Nx, np.pi / Ny
    return -(2 * (np.cos(np.pi / (Nx + 1)) - 1) / hx ** 2
             + 2 * (np.cos(np.pi / (Ny + 1)) - 1) / hy ** 2)


def po_cgl_leg(device, Nx, Ny, max_steps, M=PO_M):
    """bench.py's po_cgl set-up with its CPU-leg solver settings (f64
    throughout): the matrix-free Hopf normal form at the exact Hopf point,
    its predictor, `Trapeze(M)`, the space-time spectral preconditioner at
    T0, GMRES(30, 300, 1e-9); the monodromy's slice solves GMRES(20, 80,
    1e-6) with the slice preconditioner; FloquetQaDMF over SubspaceEig;
    a `ContIterable` after its first point."""
    from bifurcationkit.jl_tpu_torch.normal_forms.codim1 import (
        hopf_normal_form_point, hopf_predictor)
    from bifurcationkit.jl_tpu_torch.periodic.orbits import (
        _po_contparams, periodic_orbit_problem)
    from bifurcationkit.jl_tpu_torch.periodic.trapezoid import (
        slice_spectral_precond)

    base = models.cgl2d(Nx=Nx, Ny=Ny, r=0.1, c3=1.0, device=device)
    n = 2 * Nx * Ny
    r_star = _cgl_hopf(Nx, Ny)
    omega = float(base.params["nu"])
    hp = hopf_normal_form_point(
        base, torch.zeros((2, Nx, Ny), dtype=torch.float64, device=device),
        r_star, omega, matrix_free=True)
    pred = hopf_predictor(hp, 0.02)
    disc = bk.Trapeze(M=M)
    T0 = float(pred["period"])
    X0 = disc.generate_solution(pred["orbit"], T0, n)
    blocks, to_m, from_m = base.po_spectral_data(r_star)
    pre = disc.spectral_precond(n, blocks, to_m, from_m, T0, device=device)
    mono_pre = slice_spectral_precond(blocks, to_m, from_m,
                                      T0 / (M - 1) / 2.0, device=device)
    po = periodic_orbit_problem(
        base, disc, X0, params=base.set_lens_param(base.params,
                                                   float(pred["p"])),
        floquet="qad_mf", floquet_linsolver=bk.GMRES(
            restart=20, maxiter=80, rtol=1e-6, precond=mono_pre))
    cp = _po_contparams(bk.ContinuationPar(
        ds=0.005, dsmax=0.02, dsmin=1e-8, p_min=0.0, p_max=2.5,
        max_steps=max_steps, nev=8, detect_bifurcation=2,
        tol_stability=1e-3, save_eigenvectors=False,
        newton_options=bk.NewtonPar(
            tol=NEWTON_TOL, max_iterations=20,
            linsolver=bk.GMRES(restart=30, maxiter=300, rtol=1e-9,
                               precond=pre),
            eigsolver=bk.FloquetQaDMF(eigsolver=bk.SubspaceEig(
                sweeps=2, krylov_blocks=3, extra=4, tol=1e-6)))))
    it = ContIterable(po, bk.PALC(), cp, kind="PeriodicOrbitCont")
    state = it.init_state(x0=X0)
    return dict(it=it, state=state, po=po, disc=disc, n=n, T0=T0,
                pre=pre, mono_pre=mono_pre, hp=hp, X0=X0)


def _po_step(leg):
    """One PALC step; fails unless it converged to the Newton tolerance
    at the next engine step (a failed step would be retried smaller)."""
    it, state = leg["it"], leg["state"]
    step0 = state.step
    it.iterate(state)
    if not (state.converged and state.res <= NEWTON_TOL
            and state.step == step0 + 1):
        raise AssertionError(f"PO step {state.step} failed: converged "
                             f"{state.converged}, residual {state.res}")
    return dict(step=state.step, p=state.p,
                T=float(state.z.u[-1]), itnewton=state.itnewton,
                itlinear=state.itlinear, n_unstable=state.n_unstable[0],
                multipliers=np.exp(state.eigvals).tolist())


def _launches(fn, reps=1):
    """The CUDA kernels one call of `fn` launches and its seconds, over
    `reps` calls after a warm one (a short profile can miss the first
    kernels it should record)."""
    fn()
    rows, wall = _profile(lambda: [fn() for _ in range(reps)],
                          cuda_only=True)
    return sum(r[2] for r in rows) / reps, wall / reps


def po_cgl(card):
    """The full-width periodic-orbit path: the cGL2d trapeze branch at
    87,823 unknowns with matrix-free Floquet, timed, profiled and checked
    (residual, period, Floquet against the dense monodromy, card against
    CPU at 21x11).  It launches neither hand kernel."""
    reset_launches()
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    leg = po_cgl_leg(dev, PO_NX, PO_NY, PO_WARM + PO_TIMED + 2)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n, M, disc = leg["n"], PO_M, leg["disc"]
    steps, times = [], []
    with BlockLog() as blog:
        for k in range(PO_WARM + PO_TIMED):
            before = blog.snapshot()
            t = time.perf_counter()
            rec = _po_step(leg)
            torch.cuda.synchronize()
            rec["seconds"] = time.perf_counter() - t
            after = blog.snapshot()
            # one Floquet sweep per step: its slice solves, block columns
            # and inner GMRES matvecs
            rec["monodromy_applications"] = (after[0] - before[0]) / (M - 1)
            rec["monodromy_columns"] = (after[1] - before[1]) / (M - 1)
            rec["monodromy_gmres_matvecs"] = after[2] - before[2]
            rec["kind"] = "warmup" if k < PO_WARM else "timed"
            steps.append(rec)
            phase("po_cgl_step", **rec)
            if k >= PO_WARM:
                times.append(rec["seconds"])
    state, it, po = leg["state"], leg["it"], leg["po"]
    parts = {"setup": setup_s, "steps": time.perf_counter() - t0 - setup_s}
    # one more step under torch.profiler
    t1 = time.perf_counter()
    rows, wall = _profile(lambda: _po_step(leg), cuda_only=True)
    parts["profiled_step"] = time.perf_counter() - t1
    fields, busy = _busy_fields(rows, wall, "sh_jv", times, state.p)
    phase("po_breakdown", step=state.step, itnewton=state.itnewton,
          itlinear=state.itlinear, **fields)
    # launches of one application of each preconditioner and of the
    # monodromy on a Floquet block
    t1 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(1)
    v = torch.randn(M * n + 1, dtype=torch.float64, device=dev,
                    generator=gen)
    pre_launches, _ = _launches(lambda: leg["pre"](v), reps=3)
    blk = torch.randn((12, n), dtype=torch.float64, device=dev,
                      generator=gen)
    slice_launches, _ = _launches(lambda: leg["mono_pre"](blk), reps=3)
    par = it.prob.set_lens_param(it._params(), state.p)
    op = po.eig_jacobian(state.z.u, par)
    with BlockLog() as one:
        mono_launches, mono_s = _launches(lambda: op.block(blk))
    parts["launch_counts"] = time.perf_counter() - t1
    # the last point: residual recomputed, period, Floquet against the
    # dense monodromy
    res = float(torch.linalg.vector_norm(po.F(state.z.u, par)))
    periods = [s["T"] for s in steps] + [float(state.z.u[-1])]
    t1 = time.perf_counter()
    Mn = disc.monodromy(po.prob_vf, state.z.u, par)
    torch.cuda.synchronize()
    dense_build_s = time.perf_counter() - t1
    dense = np.linalg.eigvals(Mn.cpu().numpy())
    dense_s = time.perf_counter() - t1
    del Mn
    # the bench's SubspaceEig settings converge the two dominant
    # multipliers only (at 41x21 a cluster of more than 12 multipliers
    # lies within 6e-4 of 0.0102; the solver's own flag says so); a
    # SubspaceEig with more sweeps and guard vectors from the same warm
    # block is held to the dense monodromy on all 8, both ways
    mu = np.exp(state.eigvals)
    top = dense[np.argsort(-np.abs(dense))[:len(mu)]]
    witness = bk.FloquetQaDMF(eigsolver=bk.SubspaceEig(**PO_WITNESS_EIG))
    t1 = time.perf_counter()
    expo_w, _, cv_w, _ = witness(op, len(mu), v0=state.eig_seed)
    parts["witness_subspace_eig"] = time.perf_counter() - t1
    mu_w = np.exp(expo_w.cpu().numpy())
    gaps = [float(np.min(np.abs(dense - m))) for m in mu_w] + \
        [float(np.min(np.abs(mu_w - d))) for d in top]
    bench_gaps = [float(np.min(np.abs(dense - m))) for m in mu]
    tol_s = it.contparams.tol_stability
    dense_unstable = int(np.sum(np.log(np.abs(dense)) > tol_s))
    trivial = float(np.min(np.abs(mu - 1.0)))
    launches = {"sh_jv": sh_jv_mod.launch_count(),
                "dia_spmv": dia_spmv.launches}
    timed = [s for s in steps if s["kind"] == "timed"]
    phase("po_cgl", unknowns=M * n + 1, vf_unknowns=n, slices=M,
          setup_s=setup_s, steps_per_s=len(times) / float(np.sum(times)),
          timed_step_s=times,
          newton_iterations=[s["itnewton"] for s in timed],
          gmres_iterations=[s["itlinear"] for s in timed],
          monodromy_applications_per_sweep=[
              s["monodromy_applications"] for s in steps],
          monodromy_gmres_matvecs_per_sweep=[
              s["monodromy_gmres_matvecs"] for s in steps],
          precond_launches=pre_launches,
          slice_precond_launches_12_columns=slice_launches,
          monodromy_launches_12_columns=mono_launches,
          monodromy_profiled_s=mono_s,
          # `_launches` applies it twice (a warm call, then the profiled)
          monodromy_slice_matvecs_12_columns=one.matvecs / 2,
          p=[s["p"] for s in steps] + [state.p], T=periods, T0=leg["T0"],
          residual=res, multipliers=[complex(m) for m in mu],
          converged_eig=state.converged_eig, dense_gaps_bench=bench_gaps,
          dense_top=[complex(d) for d in top],
          witness_multipliers=[complex(m) for m in mu_w],
          witness_converged=cv_w, dense_gaps=gaps, trivial_gap=trivial,
          n_unstable=state.n_unstable[0], dense_n_unstable=dense_unstable,
          dense_build_s=dense_build_s, dense_eig_s=dense_s,
          parts_s=parts,
          kernel_launches=launches,
          peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
          card=repr(card))
    if not res <= NEWTON_TOL:
        raise AssertionError(f"po_cgl: the last point's residual {res}")
    if not max(abs(T / leg["T0"] - 1) for T in periods) <= 0.05:
        raise AssertionError(f"po_cgl: the period left 5 % of T0: "
                             f"{periods} against {leg['T0']}")
    if not (max(gaps) <= PO_FLOQUET_TOL and max(bench_gaps[:2])
            <= PO_FLOQUET_TOL and trivial <= 1e-3
            and state.n_unstable[0] == dense_unstable):
        raise AssertionError(f"po_cgl: SubspaceEig's multipliers against "
                             f"the dense monodromy: gaps {gaps}, the "
                             f"bench settings' {bench_gaps}, trivial "
                             f"{trivial}, n_unstable {state.n_unstable[0]} "
                             f"against {dense_unstable}")
    if any(launches.values()):
        raise AssertionError(f"po_cgl launched a kernel: {launches}")
    po_cgl_small()
    return launches


def po_cgl_small(steps=1):
    """The same leg at 21x11 on the card and on the CPU, from the same
    random start of SubspaceEig (drawn on the CPU): (r, T) to 1e-7
    relative, the multipliers to 1e-5."""
    out = {}
    for dev in (torch.device("cuda"), torch.device("cpu")):
        t = time.perf_counter()
        leg = po_cgl_leg(dev, *PO_SMALL, steps + 1)
        recs = [_po_step(leg) for _ in range(steps)]
        out[dev.type] = (recs, time.perf_counter() - t)
    (gpu, gpu_s), (cpu, cpu_s) = out["cuda"], out["cpu"]
    rel = max(max(abs(a[k] - b[k]) / abs(b[k]) for k in ("p", "T"))
              for a, b in zip(gpu, cpu))
    mu_gap = max(float(np.max(np.abs(np.asarray(a["multipliers"])
                                     - np.asarray(b["multipliers"]))))
                 for a, b in zip(gpu, cpu))
    phase("po_cgl_small", grid=f"{PO_SMALL[0]}x{PO_SMALL[1]}", steps=steps,
          max_rel_gap_pT=rel, max_multiplier_gap=mu_gap, card_s=gpu_s,
          cpu_s=cpu_s, p=[a["p"] for a in gpu], T=[a["T"] for a in gpu])
    if not (rel <= PO_SMALL_RTOL and mu_gap <= PO_SMALL_MU):
        raise AssertionError(f"po_cgl at {PO_SMALL}: the card differs from "
                             f"the CPU: (r, T) {rel}, multipliers {mu_gap}")


# ---------------------------------------------------------------------------
# 4h. po_bruss: collocation periodic orbits with COP and FloquetColl
# (bench.py:373-438, BENCH_KIND=po) at full width
# ---------------------------------------------------------------------------

# the 128-site Brusselator (256 unknowns) on Collocation(Ntst=30, m=4):
# 121 x 256 + 1 = 30,977 unknowns; depth cut to 1 warm + 3 timed steps
# (the bench's 2 + 4)
POB_NTST, POB_M = 30, 4
POB_WARM, POB_TIMED = 1, 3
POB_SMALL = 32             # the round-5 bench's recorded size: 7,745
POB_SMALL_STEPS = 3
POB_GEV = 16               # FloquetGEV's host QZ on N = 30 x 32 = 960
POB_FLOQUET_TOL = 1e-6     # FloquetColl against the dense witness
POB_SMALL_RTOL, POB_SMALL_MU = 1e-9, 1e-8


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class PartTimer:
    """Seconds spent in named functions while active: each call's own
    time (a part that runs inside another counts for the inner one only),
    the card synchronised at every boundary.  `targets` are (name, owner,
    attribute) triples; a name may cover several functions."""

    def __init__(self, targets, device="cuda"):
        self.targets, self.device = targets, device
        self.seconds = {name: 0.0 for name, _, _ in targets}
        self.calls = {name: 0 for name, _, _ in targets}
        self._stack = []

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            _sync(self.device)
            t = time.perf_counter()
            self._stack.append(0.0)
            try:
                return fn(*args, **kwargs)
            finally:
                _sync(self.device)
                elapsed = time.perf_counter() - t
                self.seconds[name] += elapsed - self._stack.pop()
                self.calls[name] += 1
                if self._stack:
                    self._stack[-1] += elapsed
        return wrapped

    def __enter__(self):
        self._orig = [(owner, attr, getattr(owner, attr))
                      for _, owner, attr in self.targets]
        for (name, owner, attr), (_, _, fn) in zip(self.targets, self._orig):
            setattr(owner, attr, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self._orig:
            setattr(owner, attr, fn)


def _cop_parts(device="cuda"):
    """The four parts of a collocation step: the per-node jacobians, COP
    stage 1, the external solve, and FloquetColl's reduction plus its
    host eig."""
    from bifurcationkit.jl_tpu_torch.periodic import cop

    return PartTimer([("node_jacobians", cop, "slice_jacobians"),
                      ("stage1", cop, "_stage1"),
                      ("external_solve", cop, "_external_system"),
                      ("floquet", bk.FloquetColl, "device_reduce"),
                      ("floquet", bk.FloquetColl, "host_eig")], device)


def po_bruss_leg(device, sites, hp, max_steps):
    """bench.py's BENCH_KIND=po set-up (f64, its CPU leg): the Hopf
    predictor at ds 0.02 from `hp`, Collocation(Ntst=30, m=4), COPLS and
    COPBLS, FloquetColl through the engine's two-stage eig; a
    `ContIterable` after its first point.  The model is the batched
    Brusselator: its closed-form J.v gives the per-node jacobians."""
    from bifurcationkit.jl_tpu_torch.normal_forms.codim1 import (
        hopf_predictor)
    from bifurcationkit.jl_tpu_torch.periodic.orbits import (
        _po_contparams, periodic_orbit_problem)

    prob = models.brusselator_1d(n=sites, device=device, batched=True)
    disc = bk.Collocation(Ntst=POB_NTST, m=POB_M)
    pred = hopf_predictor(hp, 0.02)
    n = 2 * sites
    X0 = disc.generate_solution(pred["orbit"], float(pred["period"]), n,
                                device=device)
    po = periodic_orbit_problem(
        prob, disc, X0, params=prob.set_lens_param(prob.params,
                                                   float(pred["p"])),
        use_cop=True, floquet="coll")
    cp = _po_contparams(bk.ContinuationPar(
        ds=0.01, dsmax=0.02, dsmin=1e-6, p_min=0.29, p_max=0.75,
        max_steps=max_steps, nev=8, detect_bifurcation=2,
        tol_stability=1e-3, save_eigenvectors=False,
        newton_options=bk.NewtonPar(tol=NEWTON_TOL, max_iterations=20,
                                    linsolver=bk.COPLS(),
                                    eigsolver=bk.FloquetColl())))
    it = ContIterable(po, bk.PALC(bls=bk.COPBLS()), cp,
                      kind="PeriodicOrbitCont")
    state = it.init_state(x0=X0)
    return dict(it=it, state=state, po=po, disc=disc, n=n,
                T_hopf=2 * np.pi / hp.omega)


def _floquet_witness(leg):
    """At the leg's last point: the collocation residual recomputed, the
    dense witness's multipliers (`Collocation.monodromy`: interval maps by
    dense solves, their sequential product, a host eig) against
    FloquetColl's, both ways, the trivial multiplier's gap and the
    unstable counts."""
    it, state, po, disc = leg["it"], leg["state"], leg["po"], leg["disc"]
    par = it.prob.set_lens_param(it._params(), state.p)
    res = float(torch.linalg.vector_norm(po.F(state.z.u, par)))
    t = time.perf_counter()
    Mn = disc.monodromy(po.prob_vf, state.z.u, par)
    dense = np.linalg.eigvals(Mn.cpu().numpy())
    witness_s = time.perf_counter() - t
    mu = np.exp(state.eigvals)
    top = dense[np.argsort(-np.abs(dense))[:len(mu)]]
    gaps = [float(np.min(np.abs(dense - m))) for m in mu] + \
        [float(np.min(np.abs(mu - d))) for d in top]
    tol_s = it.contparams.tol_stability
    return dict(residual=res, multipliers=[complex(m) for m in mu],
                dense_top=[complex(d) for d in top], floquet_gaps=gaps,
                trivial_gap=float(np.min(np.abs(mu - 1.0))),
                n_unstable=state.n_unstable[0],
                dense_n_unstable=int(np.sum(np.log(np.abs(dense)) > tol_s)),
                witness_s=witness_s), par


def po_bruss(card, hp):
    """The collocation PO path at full width: the 128-site Brusselator's
    Hopf branch on Collocation(Ntst=30, m=4), 30,977 unknowns, timed by
    parts, profiled and checked (residual, period, FloquetColl against the
    dense witness, card against CPU at 32 sites).  It launches neither
    hand kernel."""
    reset_launches()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    leg = po_bruss_leg(dev, BRUSS_SITES, hp, POB_WARM + POB_TIMED + 2)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps, times = [], []
    for k in range(POB_WARM + POB_TIMED):
        with _cop_parts() as parts:
            t = time.perf_counter()
            rec = _po_step(leg)
            torch.cuda.synchronize()
            rec["seconds"] = time.perf_counter() - t
        rec["parts_s"] = dict(parts.seconds)
        rec["parts_calls"] = dict(parts.calls)
        rec["kind"] = "warmup" if k < POB_WARM else "timed"
        steps.append(rec)
        phase("po_bruss_step", **rec)
        if k >= POB_WARM:
            times.append(rec["seconds"])
    state = leg["state"]
    t1 = time.perf_counter()
    rows, wall = _profile(lambda: _po_step(leg), cuda_only=True)
    profiled_s = time.perf_counter() - t1
    fields, _ = _busy_fields(rows, wall, "dia_spmv", times, state.p)
    phase("po_bruss_breakdown", step=state.step, itnewton=state.itnewton,
          **fields)
    check, _ = _floquet_witness(leg)
    periods = [s["T"] for s in steps] + [float(state.z.u[-1])]
    launches = {"sh_jv": sh_jv_mod.launch_count(),
                "dia_spmv": dia_spmv.launches}
    timed = [s for s in steps if s["kind"] == "timed"]
    n = leg["n"]
    unknowns = (POB_NTST * POB_M + 1) * n + 1
    phase("po_bruss", unknowns=unknowns, vf_unknowns=n, Ntst=POB_NTST,
          m=POB_M, setup_s=setup_s,
          steps_per_s=len(times) / float(np.sum(times)), timed_step_s=times,
          newton_iterations=[s["itnewton"] for s in timed],
          parts_s_per_timed_step={
              k: float(np.mean([s["parts_s"][k] for s in timed]))
              for k in timed[0]["parts_s"]},
          p=[s["p"] for s in steps] + [state.p], T=periods,
          T_hopf=leg["T_hopf"], profiled_step_wall_s=profiled_s,
          kernel_launches=launches,
          peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
          card=repr(card), **check)
    if unknowns != 30977:
        raise AssertionError(f"po_bruss runs {unknowns} unknowns")
    if not check["residual"] <= NEWTON_TOL:
        raise AssertionError(f"po_bruss: the last point's residual "
                             f"{check['residual']}")
    if not max(abs(T / leg["T_hopf"] - 1) for T in periods) <= 0.05:
        raise AssertionError(f"po_bruss: the period left 5 % of 2 pi / "
                             f"omega: {periods} against {leg['T_hopf']}")
    if not (max(check["floquet_gaps"]) <= POB_FLOQUET_TOL
            and check["trivial_gap"] <= 1e-4
            and check["n_unstable"] == check["dense_n_unstable"]):
        raise AssertionError(f"po_bruss: FloquetColl against the dense "
                             f"witness: {check}")
    if any(launches.values()):
        raise AssertionError(f"po_bruss launched a kernel: {launches}")
    po_bruss_small()
    return launches


def _bruss_hopf_cpu(sites):
    """The Hopf point and its dense normal form on the CPU: a dense
    Brusselator branch (bench.py:390-398's settings)."""
    prob = models.brusselator_1d(n=sites, device="cpu")
    br = bk.continuation(prob, bk.PALC(), bk.ContinuationPar(
        ds=0.01, dsmax=0.02, dsmin=1e-6, p_min=0.29, p_max=0.8,
        max_steps=120, detect_bifurcation=3, nev=8, n_inversion=4,
        newton_options=bk.NewtonPar(tol=1e-9)))
    idx = next(i for i, sp in enumerate(br.specialpoint)
               if sp.type == "hopf")
    return bk.hopf_normal_form(prob, br, idx)


def po_bruss_small():
    """The same leg at 32 sites (7,745 unknowns) for 3 steps on the card
    and on the CPU from one Hopf normal form: (l, T) to 1e-9 relative,
    the multipliers to 1e-8.  Then the third route at 16 sites (the host
    QZ of the 32-site pencil, N = 1,920, takes minutes): FloquetGEV on the
    card's interval maps against FloquetColl to 1e-6."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # small tensors: threads contend
    try:
        hp = _bruss_hopf_cpu(POB_SMALL)
        out = {}
        for dev in (torch.device("cuda"), torch.device("cpu")):
            t = time.perf_counter()
            leg = po_bruss_leg(dev, POB_SMALL, hp, POB_SMALL_STEPS + 1)
            recs = [_po_step(leg) for _ in range(POB_SMALL_STEPS)]
            out[dev.type] = (recs, time.perf_counter() - t)
        hp_gev = _bruss_hopf_cpu(POB_GEV)
    finally:
        torch.set_num_threads(threads)
    (gpu, gpu_s), (cpu, cpu_s) = out["cuda"], out["cpu"]
    rel = max(max(abs(a[k] - b[k]) / abs(b[k]) for k in ("p", "T"))
              for a, b in zip(gpu, cpu))
    mu_gap = max(float(np.max(np.abs(np.asarray(a["multipliers"])
                                     - np.asarray(b["multipliers"]))))
                 for a, b in zip(gpu, cpu))
    # the third route: FloquetGEV's pencil on the same interval maps
    t = time.perf_counter()
    leg = po_bruss_leg(torch.device("cuda"), POB_GEV, hp_gev, 2)
    _po_step(leg)
    it, state, po, disc = leg["it"], leg["state"], leg["po"], leg["disc"]
    par = it.prob.set_lens_param(it._params(), state.p)
    expo_g, _, _, _ = bk.FloquetGEV()(
        disc.interval_maps(po.prob_vf, state.z.u, par), 8)
    gev_s = time.perf_counter() - t
    mu_c = np.exp(state.eigvals)
    mu_g = np.exp(expo_g.cpu().numpy())
    gev_gap = max(float(np.min(np.abs(mu_g - m))) for m in mu_c)
    phase("po_bruss_small", sites=POB_SMALL, steps=POB_SMALL_STEPS,
          unknowns=(POB_NTST * POB_M + 1) * 2 * POB_SMALL + 1,
          max_rel_gap_pT=rel, max_multiplier_gap=mu_gap, card_s=gpu_s,
          cpu_s=cpu_s, p=[a["p"] for a in gpu], T=[a["T"] for a in gpu],
          gev_sites=POB_GEV, gev_gap=gev_gap, gev_s=gev_s)
    if not (rel <= POB_SMALL_RTOL and mu_gap <= POB_SMALL_MU):
        raise AssertionError(f"po_bruss at {POB_SMALL} sites: the card "
                             f"differs from the CPU: (l, T) {rel}, "
                             f"multipliers {mu_gap}")
    if not gev_gap <= POB_FLOQUET_TOL:
        raise AssertionError(f"po_bruss at {POB_GEV} sites: FloquetGEV "
                             f"differs from FloquetColl by {gev_gap}")


# ---------------------------------------------------------------------------
# 4i. po_bruss_shooting: flows, standard and Poincare shooting, and the
# matrix-free monodromy through dia_spmv (examples/brusselator_shooting.py)
# ---------------------------------------------------------------------------

SH_SITES = 40              # the example's own size: 80 unknowns
SH_STEPS = 4               # the example's 15 branch steps cut to 4 (at 3
                           # the Poincare Newton from the last orbit fails)
SH_RTOL, SH_MU = 1e-8, 1e-6
SH_MF_RTOL = 1e-10         # the MF monodromy against its references
# 4 block applications of the operator (the witness settings of po_cgl
# take 7 for the same 1e-7 gap on the CPU rehearsal)
SH_MF_EIG = dict(sweeps=2, krylov_blocks=3, extra=4, tol=1e-8)


def _bruss_branch(device, sites):
    """The example's equilibrium branch (dense solvers, nev 12) on the
    batched Brusselator."""
    return bk.continuation(
        models.brusselator_1d(n=sites, device=device, batched=True),
        bk.PALC(), bk.ContinuationPar(
            ds=0.01, dsmax=0.02, dsmin=1e-6, p_min=0.29, p_max=0.8,
            max_steps=120, detect_bifurcation=3, nev=12, n_inversion=4,
            newton_options=bk.NewtonPar(tol=1e-9)))


def _shooting_cp(linesearch=True):
    return bk.ContinuationPar(
        ds=0.01, dsmax=0.03, dsmin=1e-6, p_min=0.29, p_max=0.75,
        max_steps=SH_STEPS, detect_bifurcation=2, nev=8,
        tol_stability=1e-3, newton_options=bk.NewtonPar(
            tol=NEWTON_TOL, max_iterations=25, linesearch=linesearch))


def shooting_leg(device, sites=SH_SITES):
    """The example's standard-shooting branch (Shooting(M=3,
    steps_per_segment=40, method="rodas3"), dense Newton with line search)
    from the Hopf point; its first period against 2 pi / omega."""
    t = time.perf_counter()
    br = _bruss_branch(device, sites)
    ih = next(i for i, sp in enumerate(br.specialpoint)
              if sp.type == "hopf")
    br_po = bk.continuation_hopf_po(
        br, ih, _shooting_cp(), delta_p=0.02,
        disc=bk.Shooting(M=3, steps_per_segment=40, method="rodas3"))
    ev = np.asarray(br.specialpoint[ih].eigenvals)
    omega = abs(float(np.imag(ev[np.argmin(np.abs(ev.real))])))
    return dict(br=br, ih=ih, br_po=br_po, omega=omega,
                seconds=time.perf_counter() - t)


def po_bruss_shooting(card):
    """examples/brusselator_shooting.py at 40 sites on the card: standard
    shooting (card against CPU, against collocation), Poincare shooting,
    and the matrix-free shooting monodromy with its J.v through dia_spmv
    (against the torch.func route, the dense monodromy and FloquetColl)."""
    reset_launches()
    dev = torch.device("cuda")
    leg = shooting_leg(dev)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # small tensors: threads contend
    try:
        leg_cpu = shooting_leg(torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)
    a = interop.po_branch_to_numpy(leg["br_po"])
    b = interop.po_branch_to_numpy(leg_cpu["br_po"])
    same_len = len(a["param"]) == len(b["param"])
    rel = max(float(np.max(np.abs(a[k] - b[k]) / np.abs(b[k])))
              for k in ("param", "period")) if same_len else float("inf")
    mu_gap = max(float(np.max(np.abs(np.exp(x) - np.exp(y))))
                 for x, y in zip(a["floquet"], b["floquet"]))
    T_hopf = 2 * np.pi / leg["omega"]
    # the same branch by collocation + COP (no line search)
    t = time.perf_counter()
    br_cl = bk.continuation_hopf_po(
        leg["br"], leg["ih"], _shooting_cp(linesearch=False),
        delta_p=0.02, disc=bk.Collocation(Ntst=20, m=4), use_cop=True)
    coll_s = time.perf_counter() - t
    c = interop.po_branch_to_numpy(br_cl)
    lo = max(a["param"].min(), c["param"].min())
    hi = min(a["param"].max(), c["param"].max())
    ps = np.linspace(lo, hi, 5)
    oa, oc = np.argsort(a["param"]), np.argsort(c["param"])
    coll_gap = float(np.max(np.abs(
        np.interp(ps, a["param"][oa], a["period"][oa])
        - np.interp(ps, c["param"][oc], c["period"][oc])))) \
        if hi > lo else float("inf")
    phase("po_bruss_shooting_branch", sites=SH_SITES, steps=SH_STEPS,
          p=a["param"].tolist(), T=a["period"].tolist(),
          n_unstable=a["n_unstable"].tolist(), card_s=leg["seconds"],
          cpu_s=leg_cpu["seconds"], max_rel_gap_pT=rel,
          max_multiplier_gap=mu_gap, T_hopf=T_hopf,
          collocation_gap=coll_gap, collocation_s=coll_s)
    if not (same_len and rel <= SH_RTOL and mu_gap <= SH_MU):
        raise AssertionError(f"po_bruss_shooting: the card's branch "
                             f"differs from the CPU's: (l, T) {rel}, "
                             f"multipliers {mu_gap}")
    if not abs(a["period"][0] - T_hopf) <= 0.1:
        raise AssertionError(f"po_bruss_shooting: first period "
                             f"{a['period'][0]} against {T_hopf}")
    if not coll_gap <= 1e-3:
        raise AssertionError(f"po_bruss_shooting: shooting and collocation "
                             f"periods differ by {coll_gap}")
    poincare = _poincare_from(leg, dev)
    mf = _mf_monodromy(br_cl, dev)
    launches = {"sh_jv": sh_jv_mod.launch_count(),
                "dia_spmv": dia_spmv.launches}
    phase("po_bruss_shooting", kernel_launches=launches, card=repr(card),
          **poincare, **mf)
    if launches["sh_jv"] or launches["dia_spmv"] <= 0:
        raise AssertionError(f"po_bruss_shooting: launches {launches}")
    return launches


def _poincare_from(leg, dev):
    """Event-driven Poincare shooting (PoincareShooting(M=1,
    steps_per_segment=150, method="rodas3")) Newton from the branch's last
    orbit (examples/brusselator_shooting.py): converged, and its period
    (`period_par`) within 1e-3 of standard shooting's."""
    orb = bk.get_periodic_orbit(leg["br_po"], -1)
    prob = models.brusselator_1d(n=SH_SITES, device=dev, batched=True)
    psh = bk.PoincareShooting(M=1, steps_per_segment=150, method="rodas3",
                              event_driven=True)
    u = orb["u"]
    X0 = psh.generate_solution(
        lambda t: u[int(t / (2 * np.pi) * (u.shape[0] - 1))],
        float(orb["period"]), 2 * SH_SITES, device=dev)
    t = time.perf_counter()
    sol, po = bk.newton_po(prob, psh, X0,
                           params=prob.set_lens_param(prob.params, orb["p"]),
                           options=bk.NewtonPar(tol=1e-8, max_iterations=30))
    T = float(psh.period_par(po.prob_vf, sol.u, po.params))
    out = dict(poincare_converged=sol.converged,
               poincare_newton=sol.itnewton, poincare_T=T,
               poincare_T_gap=abs(T - orb["period"]),
               poincare_s=time.perf_counter() - t)
    if not (sol.converged and out["poincare_T_gap"] <= 1e-3):
        raise AssertionError(f"po_bruss_shooting: Poincare shooting {out}")
    return out


def _mf_monodromy(br_cl, dev):
    """test_floquet_mf.py:77-129 at 40 sites: the collocation orbit's last
    point interpolated onto Shooting(M=5, steps_per_segment=150) (dopri5)
    and solved by `newton_po`; its matrix-free monodromy with J.v by
    `brusselator_dia_jac_op` (one dia_spmv launch per stage on the block's
    columns) against the same operator through torch.func.jvp and the
    dense `Shooting.monodromy` to 1e-10 relative, and
    FloquetQaDMF(SubspaceEig) on it against FloquetColl's 4 leading
    multipliers to 1e-4."""
    from bifurcationkit.jl_tpu_torch.periodic.cop import (
        collocation_block_jacobian)

    gam = br_cl.gamma
    disc_c = gam.prob.disc
    Xc, p_at = gam.sol[-1]["x"], float(gam.sol[-1]["p"])
    par_c = gam.prob.set_lens_param(gam.prob.params, p_at)
    expo_c, _, _, _ = bk.FloquetColl()(collocation_block_jacobian(
        disc_c, gam.prob.prob_vf, Xc, par_c), 4)
    mult_c = np.sort(np.abs(np.exp(expo_c.cpu().numpy())))[::-1]
    n = 2 * SH_SITES
    nodes, T = disc_c.split(Xc, n)
    disc = bk.Shooting(M=5, steps_per_segment=150)
    X0 = disc.generate_solution(
        lambda t: disc_c.interpolate(nodes, par_c["_mesh"],
                                     (t / (2 * np.pi)) % 1.0),
        float(T), n, device=dev)
    inner = par_c["_inner"]
    vf = models.brusselator_1d(n=SH_SITES, device=dev,
                               batched=True).re_make(params=inner)
    t = time.perf_counter()
    sol, po = bk.newton_po(vf, disc, X0, options=bk.NewtonPar(
        tol=1e-10, max_iterations=25))
    newton_s = time.perf_counter() - t
    if not sol.converged:
        raise AssertionError("po_bruss_shooting: the M = 5 shooting Newton "
                             "did not converge")
    plain = models.brusselator_1d(n=SH_SITES, device=dev).re_make(
        params=inner)
    op_vf = plain.re_make(jac_op=brusselator_dia_jac_op(SH_SITES))
    op = disc.monodromy_operator(op_vf, sol.u, po.params)
    V = torch.as_tensor(np.random.default_rng(4).standard_normal((8, n)),
                        device=dev)
    before = dia_spmv.launches
    t = time.perf_counter()
    got = op.block(V)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t
    per_application = dia_spmv.launches - before
    # the kernel's device time: one segment's variational flow under the
    # profiler (the application's 5 segments differ only in their states;
    # profiling all of its ~200,000 kernels costs the profiler's
    # post-processing about 40 s)
    u, T = disc.split(sol.u, n)
    seg = disc._flow(op_vf)
    rows, _ = _profile(lambda: seg.jvp(u[0], inner, T / disc.M, V),
                       cuda_only=True)
    mine = [r for r in rows if "dia_spmv_kernel" in r[0]]
    t = time.perf_counter()
    ref_ad = disc.monodromy_operator(plain, sol.u, po.params).block(V)
    ad_s = time.perf_counter() - t
    Mn = disc.monodromy(vf, sol.u, po.params)
    scale = float(torch.abs(ref_ad).max())
    gap_ad = float(torch.abs(got - ref_ad).max()) / scale
    gap_dense = float(torch.abs(got - V @ Mn.T).max()) / scale
    t = time.perf_counter()
    expo, _, cv, _ = bk.FloquetQaDMF(eigsolver=bk.SubspaceEig(
        **SH_MF_EIG))(op, 4)
    eig_s = time.perf_counter() - t
    mult = np.sort(np.abs(np.exp(expo.cpu().numpy())))[::-1]
    out = dict(mf_newton=sol.itnewton, mf_newton_s=newton_s,
               mf_dia_launches_per_application=per_application,
               mf_dia_device_s_one_segment=sum(r[1] for r in mine) * 1e-6,
               mf_dia_calls_one_segment=sum(r[2] for r in mine),
               mf_kernels_one_segment=sum(r[2] for r in rows),
               mf_device_busy_s_one_segment=sum(r[1] for r in rows) * 1e-6,
               mf_application_s=apply_s, mf_torch_func_s=ad_s,
               mf_gap_torch_func=gap_ad, mf_gap_dense=gap_dense,
               mf_multipliers=mult.tolist(),
               floquet_coll_multipliers=mult_c.tolist(),
               mf_floquet_gap=float(np.max(np.abs(mult - mult_c))),
               mf_subspace_converged=cv, mf_eig_s=eig_s)
    if not (gap_ad <= SH_MF_RTOL and gap_dense <= SH_MF_RTOL):
        raise AssertionError(f"po_bruss_shooting: the MF monodromy through "
                             f"dia_spmv: {out}")
    if not out["mf_floquet_gap"] <= 1e-4:
        raise AssertionError(f"po_bruss_shooting: FloquetQaDMF against "
                             f"FloquetColl: {out}")
    if per_application <= 0:
        raise AssertionError("po_bruss_shooting: the MF monodromy never "
                             "launched dia_spmv")
    return out


# ---------------------------------------------------------------------------
# 4m. the periodic SH2d of bench.py's BENCH_KIND=cuda_analog at 512x512
# through sh_jv's periodic closure, SH3d, the SH1d snaking branch,
# travelling waves, generic BVPs, branch files and the native library
# ---------------------------------------------------------------------------

SHP_N = 512                # bench.py:272-331: 262,144 unknowns, f64
SHP_WARM, SHP_TIMED = 2, 4
SHP_NEWTON_TOL = 5e-7      # bench.py:302-306 (the TPU's f64-emulation floor)
SHP_SMALL = 64             # test_sh_periodic.py's N: card against CPU
SHP_SMALL_STEPS = 3
ARPACK_ATOL = 1e-5         # test_sh_periodic.py's LOBPCG against ARPACK
SH3D_N, SH3D_STEPS = 22, 8     # examples/sh3d.py: 146 steps cut to 8
SH3D_SMALL = 10            # test_sh3d.py's N: card against CPU
# the card's Newton from the example's doubled guess follows the CPU's
# residuals to this over its first iterations (the port and the JAX
# package on one CPU: 1.1e-8 after 8 iterations, test_torch_sh3d.py)
SH3D_SAME_ITS, SH3D_SAME_RTOL = 8, 1e-6
SH1D_CPU_STEPS = 30        # the CPU's share of the flat branch
WAVE_TOL = 1e-9            # card against CPU
BVP_TOL = 1e-9
DUFFING_CPU_STEPS = 6
# the Bratu fold by shooting: test_wave_bvp.py's M = 6 segments with 10
# dopri5 steps each, not 80 (the fold moves by 1e-10; forward AD through
# the flow costs an eighth), from lam = 3.4, not 0.5 (5 steps to the fold,
# not 17)
BRATU_SHOOTING = bk.BVPShooting(M=6, steps_per_segment=10)
BRATU_SHOOTING_LAM0 = 3.4
ZOO_BUDGET_S = 240         # the phases of section 4m together


def shp_config(prob, max_steps):
    """bench.py's accelerator configuration of cuda_analog
    (bench.py:288-321)."""
    ls = bk.IterativeRefinement(
        inner=bk.GMRES(restart=16, maxiter=64, rtol=1e-4,
                       precond=prob.spectral_precond),
        refinements=4, rtol=1e-8)
    eig = bk.LOBPCGEig(maxiter=8, tol=3e-3, extra=4,
                       precond=lambda v: prob.spectral_precond(v, shift=1.0),
                       compute_dtype=torch.float32)
    cp = bk.ContinuationPar(
        ds=-0.005, dsmax=0.007, dsmin=1e-6, p_min=-1.0, p_max=0.005,
        max_steps=max_steps, nev=11, detect_bifurcation=3, detect_fold=True,
        save_eigenvectors=False,
        newton_options=bk.NewtonPar(tol=1e-6, max_iterations=15,
                                    linsolver=ls, eigsolver=eig))
    return ls, cp


def _shp_launches():
    """sh_jv's launches so far by closure, dtype and K."""
    return {f"{c}/{d}/K={k}": n for (c, d, k), n in
            sorted(sh_jv_mod.sh_jv.launches_by_case.items())}


def _shp_checks(prob, u):
    """At the Newton point of the 512x512 run: the kernel's periodic J.v
    against `sh_jv_plain(closure="periodic")` at K = 1 and 15 in f64 and
    f32, and the FFT preconditioner as the exact inverse of the linear
    part.  The launches made here compare the kernel with its plain
    version: the counts are put back as they were."""
    saved = dict(sh_jv_mod.sh_jv.launches_by_case)
    try:
        return _shp_compare(prob, u)
    finally:
        sh_jv_mod.sh_jv.launches_by_case.clear()
        sh_jv_mod.sh_jv.launches_by_case.update(saved)


def _shp_compare(prob, u):
    rng = np.random.default_rng(11)
    hx2 = (2 * 16 * np.pi / SHP_N) ** 2          # the model's default box
    hy2 = (2 * 4 * np.pi * 2 / np.sqrt(3) / SHP_N) ** 2
    out = {}
    for dtype in (torch.float64, torch.float32):
        uu = u.to(dtype).contiguous()
        scal = torch.tensor([-0.15, 1.3, 1 / hx2, 1 / hy2], dtype=dtype,
                            device=u.device)
        for K in (1, 15):
            v = torch.as_tensor(rng.standard_normal((K,) + tuple(u.shape)),
                                dtype=dtype, device=u.device)
            vv = v if K > 1 else v[0]
            got = sh_jv_mod.sh_jv(uu, vv, scal, closure="periodic")
            torch.cuda.synchronize()
            ref = sh_jv_mod.sh_jv_plain(uu, vv, scal, closure="periodic")
            rel = float((got - ref).abs().max() / ref.abs().max())
            out[f"{str(dtype).split('.')[-1]}/K={K}"] = rel
            if not rel <= TOL[dtype]:
                raise AssertionError(f"sh_periodic: the periodic kernel "
                                     f"disagrees with its plain version: "
                                     f"{rel} > {TOL[dtype]}")
    v = torch.as_tensor(rng.standard_normal(tuple(u.shape)),
                        device=u.device)
    zero = {"l": torch.zeros((), dtype=u.dtype, device=u.device),
            "nu": torch.zeros((), dtype=u.dtype, device=u.device)}
    Lv = prob.F(v, zero) + v ** 3                # the linear part of F
    inv_err = float((prob.spectral_precond(Lv - v, shift=1.0) - v)
                    .abs().max())
    if not inv_err <= 1e-10:
        raise AssertionError(f"sh_periodic: the FFT preconditioner is not "
                             f"the exact inverse: {inv_err}")
    return out, inv_err


def sh_periodic(card):
    """bench.py's cuda_analog_steps_per_s at N = 512 on its accelerator
    branch: Newton, 2 warm + 4 timed PALC steps with LOBPCG detection,
    one profiled step; every J.v through sh_jv's periodic closure."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prob = models.swift_hohenberg_periodic_2d(Nx=SHP_N, Ny=SHP_N)
    ls, cp = shp_config(prob, SHP_WARM + SHP_TIMED + 2)
    sol = bk.newton(prob, bk.NewtonPar(tol=SHP_NEWTON_TOL, max_iterations=25,
                                       linsolver=ls))
    torch.cuda.synchronize()
    if not sol.converged:
        raise AssertionError("Newton did not converge on the periodic SH2d")
    newton_launches = _shp_launches()
    phase("sh_periodic_newton", unknowns=SHP_N * SHP_N,
          iterations=sol.itnewton, linear=sol.itlineartot,
          residuals=[float(r) for r in sol.residuals[:sol.itnewton + 1]],
          seconds=time.perf_counter() - t0, sh_jv=newton_launches)

    it = ContIterable(prob.re_make(u0=sol.u), bk.PALC(), cp)
    state = it.init_state()
    res = bk.ContResult(prob=prob, contparams=cp)
    it.save(res, state)
    steps = []

    def step(kind):
        step0 = state.step
        t = time.perf_counter()
        it.iterate(state)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if not (state.converged and state.step == step0 + 1):
            raise AssertionError(f"sh_periodic step {state.step} failed or "
                                 f"was retried")
        it.save(res, state)
        steps.append(dict(kind=kind, step=state.step, p=state.p,
                          residual=float(state.res),
                          n_unstable=state.n_unstable[0],
                          itnewton=state.itnewton, itlinear=state.itlinear,
                          seconds=dt))
        phase("sh_periodic_palc", **steps[-1])

    for _ in range(SHP_WARM):
        step("warmup")
    for _ in range(SHP_TIMED):
        step("timed")
    timed = [s for s in steps if s["kind"] == "timed"]
    steps_per_s = SHP_TIMED / sum(s["seconds"] for s in timed)
    path_launches = _shp_launches()
    launches = sh_jv_mod.launch_count()
    fields, _ = _profiled_step(it, state, "sh_jv",
                               [s["seconds"] for s in timed])
    it.save(res, state)
    phase("sh_periodic_breakdown", **fields)
    launches_all = sh_jv_mod.launch_count()
    by_case = _shp_launches()
    neumann = sum(n for k, n in by_case.items() if k.startswith("neumann"))
    if launches <= 0 or neumann:
        raise AssertionError(f"sh_periodic launched sh_jv {launches} times, "
                             f"the Neumann closure {neumann} times")
    ks = {(d, k) for (c, d, k) in sh_jv_mod.sh_jv.launches_by_case}
    checks, inv_err = _shp_checks(prob, sol.u)
    phase("sh_periodic", steps_per_s=steps_per_s,
          warm_step_s=[s["seconds"] for s in timed],
          itnewton=[s["itnewton"] for s in timed],
          itlinear=[s["itlinear"] for s in timed],
          sh_jv_launches=launches_all, sh_jv_launches_timed=launches,
          sh_jv_by_case=by_case, sh_jv_by_case_before_profile=path_launches,
          kernel_vs_plain=checks, precond_inverse_err=inv_err,
          peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
          card=repr(card))
    return dict(prob=prob, branch=res, launches=launches_all, ks=ks,
                by_case=dict(sh_jv_mod.sh_jv.launches_by_case),
                steps_per_s=steps_per_s)


def _shp_sparse(u, l, N=SHP_SMALL, nu=1.3):
    """test_sh_periodic.py's independent scipy.sparse assembly of the
    periodic FD jacobian at (u, l)."""
    import scipy.sparse as sp

    lx, ly = 16 * np.pi, 4 * np.pi * 2 / np.sqrt(3)

    def d2p(n, h2):
        D = sp.diags([np.ones(n - 1), -2.0 * np.ones(n), np.ones(n - 1)],
                     [-1, 0, 1]).tolil()
        D[0, -1] = D[-1, 0] = 1.0
        return (D / h2).tocsr()

    L2 = (sp.kron(d2p(N, (2 * lx / N) ** 2), sp.eye(N))
          + sp.kron(sp.eye(N), d2p(N, (2 * ly / N) ** 2)))
    L1 = sp.eye(N * N) + L2
    un = u.reshape(-1)
    return ((-(L1 @ L1)) + sp.diags(l + 2 * nu * un - 3 * un * un)).tocsc()


def shp_small_leg(device, steps=SHP_SMALL_STEPS):
    """test_sh_periodic.py's continuation at N = 64: Newton, then PALC with
    LOBPCG detection (f32 sweeps, f64 refine).  The corrector stops at
    1e-9, not the test's 1e-7: the state on the full box at this width
    has up to 64 unstable modes, and two runs that stop at 1e-7 on f32
    Krylov iterates summed in another order differed by 4.5e-7 in p on
    an H100 against the CPU, above the 1e-8 the comparison holds."""
    prob = models.swift_hohenberg_periodic_2d(Nx=SHP_SMALL, Ny=SHP_SMALL,
                                              device=device)
    sol = bk.newton(prob, bk.NewtonPar(
        tol=1e-10, max_iterations=30, linsolver=bk.GMRES(
            restart=40, maxiter=300, rtol=1e-11,
            precond=prob.spectral_precond)))
    if not sol.converged:
        raise AssertionError(f"periodic SH2d Newton on {device} failed")
    ls = bk.IterativeRefinement(
        inner=bk.GMRES(restart=40, maxiter=160, rtol=1e-5,
                       precond=prob.spectral_precond),
        refinements=4, rtol=1e-9)
    eig = bk.LOBPCGEig(maxiter=30, tol=3e-3, extra=8,
                       precond=lambda v: prob.spectral_precond(v, shift=1.0),
                       compute_dtype=torch.float32)
    cp = bk.ContinuationPar(
        ds=-0.005, dsmax=0.007, dsmin=1e-6, p_min=-1.0, p_max=0.005,
        max_steps=steps, nev=11, detect_bifurcation=3,
        save_eigenvectors=False,
        newton_options=bk.NewtonPar(tol=1e-9, max_iterations=15,
                                    linsolver=ls, eigsolver=eig))
    return sol, bk.continuation(prob.re_make(u0=sol.u), bk.PALC(), cp)


def check_sh_periodic():
    """The N = 64 leg on the card and on the CPU: p to 1e-8 with equal
    stability counts; the card's last spectrum against ARPACK's
    shift-invert on the scipy.sparse assembly."""
    import scipy.sparse.linalg as spla

    out = {}
    for dev in ("cuda", "cpu"):
        t = time.perf_counter()
        sol, br = shp_small_leg(dev)
        out[dev] = (sol, br, interop.branch_to_numpy(br),
                    time.perf_counter() - t)
    a, b = out["cuda"][2], out["cpu"][2]
    dp = float(np.abs(a["p"] - b["p"]).max()) \
        if len(a["p"]) == len(b["p"]) else float("inf")
    same_n = bool(np.array_equal(a["n_unstable"], b["n_unstable"]))
    du = float((out["cuda"][0].u.cpu() - out["cpu"][0].u).abs().max())
    br = out["cuda"][1]
    vals = np.sort(np.asarray(br.eig[-1]["eigenvals"]).real)[::-1]
    x = br.sol[-1]["x"].detach().cpu().numpy()
    ref = np.sort(spla.eigsh(_shp_sparse(x, float(br.sol[-1]["p"])), k=8,
                             sigma=1.0, which="LM")[0])[::-1]
    gap = float(np.abs(vals[:6] - ref[:6]).max())
    phase("check_sh_periodic", N=SHP_SMALL, steps=len(a["p"]) - 1,
          newton_gap=du, max_abs_dp=dp, same_n_unstable=same_n,
          arpack_gap=gap, card_s=out["cuda"][3], cpu_s=out["cpu"][3])
    if not (dp <= 1e-8 and same_n and du <= 1e-8 and gap <= ARPACK_ATOL):
        raise AssertionError(f"periodic SH2d at N = {SHP_SMALL}: card "
                             f"against CPU dp {dp}, counts {same_n}, Newton "
                             f"{du}; ARPACK gap {gap}")


def sh3d_config(prob, max_steps):
    """examples/sh3d.py's accelerator branch."""
    ls = bk.IterativeRefinement(
        inner=bk.GMRES(restart=40, maxiter=160, rtol=1e-5,
                       precond=prob.spectral_precond),
        refinements=4, rtol=1e-10)
    eig = bk.LOBPCGEig(maxiter=30, tol=3e-3, extra=8,
                       precond=lambda v: prob.spectral_precond(v, shift=1.0),
                       compute_dtype=torch.float32)
    cp = bk.ContinuationPar(
        ds=-0.001, dsmax=0.005, dsmin=1e-4, p_min=-0.1, p_max=0.15,
        max_steps=max_steps, detect_bifurcation=3, nev=15, n_inversion=4,
        newton_options=bk.NewtonPar(tol=1e-9, max_iterations=15,
                                    linsolver=ls, eigsolver=eig))
    return ls, cp


def _sh3d_root(N, device, u0=None, tol=1e-9, max_iterations=80):
    """Newton on SH3d at N with the example's f64 GMRES and its DCT
    preconditioner, from `u0` (default the example's doubled guess)."""
    prob = models.swift_hohenberg_3d(N=N, device=device)
    u0 = prob.u0 * 2.0 if u0 is None else u0.to(prob.u0.device)
    sol = bk.newton(prob.re_make(u0=u0), bk.NewtonPar(
        tol=tol, max_iterations=max_iterations, linsolver=bk.GMRES(
            restart=40, maxiter=200, rtol=1e-10,
            precond=prob.spectral_precond)))
    if not sol.converged:
        raise AssertionError(f"SH3d Newton did not converge at N = {N} on "
                             f"{device}")
    return prob, sol


def sh3d(card):
    """examples/sh3d.py at N = 22 (10,648 unknowns) on its accelerator
    branch, 8 steps; then Newton and the dense spectrum at N = 10 on the
    card against the CPU.

    The example's first Newton, from its doubled guess, wanders some 40-50
    iterations through a delicate basin, and where it ends depends on the
    rounding of every iterate: on the CPU the port and the JAX package
    agree to 2e-12 after one iteration, the gap grows tenfold every few
    iterations, and they reach different roots of the same F
    (test_torch_sh3d.py).  So the card runs that Newton on its own, and
    its residuals must follow the CPU's over the first SH3D_SAME_ITS
    iterations to SH3D_SAME_RTOL; where it ends is printed, not checked.
    The branch starts from the CPU's root perturbed by 1e-2 (seeded):
    the card's Newton from there must meet the CPU's from the same start
    to 1e-8.  At N = 10 both devices likewise start from one perturbed
    root and must meet."""
    t0 = time.perf_counter()
    prob_cpu, sol_cpu = _sh3d_root(SH3D_N, "cpu")
    t1 = time.perf_counter()
    prob = models.swift_hohenberg_3d(N=SH3D_N)
    ls_g = bk.GMRES(restart=40, maxiter=200, rtol=1e-10,
                    precond=prob.spectral_precond)
    own = bk.newton(prob.re_make(u0=prob.u0 * 2.0),
                    bk.NewtonPar(tol=1e-9, max_iterations=80,
                                 linsolver=ls_g))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res_card = [float(r) for r in own.residuals[:own.itnewton + 1]]
    res_cpu = [float(r) for r in sol_cpu.residuals[:sol_cpu.itnewton + 1]]
    follow = max(abs(a - b) / b for a, b in
                 zip(res_card[:SH3D_SAME_ITS + 1], res_cpu))
    phase("sh3d_doubled_guess", N=SH3D_N, cpu_its=sol_cpu.itnewton,
          cpu_u_max=float(sol_cpu.u.abs().max()), cpu_s=t1 - t0,
          card_converged=bool(own.converged), card_its=own.itnewton,
          card_u_max=float(own.u.abs().max()), card_s=t2 - t1,
          card_residuals=res_card, cpu_residuals=res_cpu,
          residual_gap_first_its=follow, first_its=SH3D_SAME_ITS)
    if not (len(res_card) > SH3D_SAME_ITS and follow <= SH3D_SAME_RTOL):
        raise AssertionError(f"SH3d: the card's Newton from the doubled "
                             f"guess leaves the CPU's within "
                             f"{SH3D_SAME_ITS} iterations: {follow}")
    start = sol_cpu.u + 1e-2 * torch.as_tensor(
        np.random.default_rng(9).standard_normal(sol_cpu.u.shape))
    _, sol_cpu2 = _sh3d_root(SH3D_N, "cpu", u0=start)
    t3 = time.perf_counter()
    prob, sol = _sh3d_root(SH3D_N, "cuda", u0=start)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    root_gap = float((sol.u.cpu() - sol_cpu2.u).abs().max())
    if not root_gap <= 1e-8:
        raise AssertionError(f"SH3d: the card's root from the perturbed "
                             f"start is {root_gap} from the CPU's")
    ls, cp = sh3d_config(prob, SH3D_STEPS)
    stamps = StepStamps()
    br = bk.continuation(prob.re_make(u0=sol.u),
                         bk.PALC(tangent=bk.Bordered()), cp,
                         finalise_solution=stamps)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    if not (stamps.all_converged() and len(br) == SH3D_STEPS + 1):
        raise AssertionError(f"SH3d: steps {stamps.steps}, {len(br)} rows")
    _, root = _sh3d_root(SH3D_SMALL, "cpu")
    start = root.u + 1e-2 * torch.as_tensor(np.random.default_rng(8)
                                            .standard_normal(root.u.shape))
    small = {}
    for dev in ("cuda", "cpu"):
        p, s = _sh3d_root(SH3D_SMALL, dev, u0=start)
        n = SH3D_SMALL ** 3
        J = p.jac_op(s.u, p.params)(torch.eye(n, dtype=s.u.dtype,
                                              device=s.u.device)
                                    .reshape(n, *s.u.shape)).reshape(n, n)
        small[dev] = (s.u.cpu(), torch.linalg.eigvalsh(J).cpu(), s.itnewton)
    du = float((small["cuda"][0] - small["cpu"][0]).abs().max())
    dl = float((small["cuda"][1] - small["cpu"][1]).abs().max())
    phase("sh3d", N=SH3D_N, unknowns=SH3D_N ** 3,
          perturbed_start_its=[sol.itnewton, sol_cpu2.itnewton],
          card_newton_s=t4 - t3, root_gap=root_gap,
          u_max=float(sol.u.abs().max()), steps=len(br) - 1,
          branch_s=t5 - t4, steps_per_s=(len(br) - 1) / (t5 - t4),
          p=[float(x) for x in br.param],
          n_unstable=[int(x) for x in br.n_unstable],
          special=[(sp.type, float(sp.param)) for sp in br.specialpoint],
          small_N=SH3D_SMALL,
          small_newton_its=[small[d][2] for d in ("cuda", "cpu")],
          small_newton_gap=du, small_eig_gap=dl,
          small_s=time.perf_counter() - t5)
    if not (du <= 1e-8 and dl <= 1e-8):
        raise AssertionError(f"SH3d at N = {SH3D_SMALL}: card against CPU "
                             f"Newton {du}, eigenvalues {dl}")


def sh1d_thresholds(n=200, l_dom=6.0):
    """The flat branch's exact bifurcations (1 + mu_k)^2 < 1, mu_k the
    Dirichlet second difference's eigenvalues (test_sh1d_snaking.py)."""
    h = 2 * l_dom / n
    mu = -(4 / h ** 2) * np.sin(np.arange(1, n + 1) * np.pi
                                / (2 * (n + 1))) ** 2
    lam = np.sort((1 + mu) ** 2)
    return lam[lam < 1.0]


def sh1d_leg(device, max_steps=120):
    """examples/shpde_snaking.py's flat branch (test_sh1d_snaking.py's
    fixture)."""
    prob = models.swift_hohenberg_1d(device=device)
    cp = bk.ContinuationPar(ds=0.01, dsmax=0.01, dsmin=1e-4, p_min=-1.0,
                            p_max=1.0, max_steps=max_steps,
                            detect_bifurcation=3, nev=20, n_inversion=4,
                            newton_options=bk.NewtonPar(tol=1e-8,
                                                        max_iterations=30))
    return bk.continuation(prob, bk.PALC(), cp)


def sh1d_snaking():
    """The whole flat branch at n = 200 on the card: its five bifurcations
    at the exact thresholds to 2e-3 (test_sh1d_snaking.py); its first
    SH1D_CPU_STEPS steps on the CPU: p to 1e-9, the same types."""
    t = time.perf_counter()
    br = sh1d_leg("cuda")
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    br_cpu = sh1d_leg("cpu", SH1D_CPU_STEPS)
    cpu_s = time.perf_counter() - t
    bps = sorted(float(sp.param) for sp in br.specialpoint
                 if sp.type == "bp")
    gold = sh1d_thresholds()
    gap = float(np.abs(np.asarray(bps) - gold).max()) \
        if len(bps) == len(gold) else float("inf")
    a, b = interop.branch_to_numpy(br), interop.branch_to_numpy(br_cpu)
    k = len(b["p"])
    dp = float(np.abs(a["p"][:k] - b["p"]).max())
    cut = [(str(t_), float(p)) for t_, p in zip(a["sp_type"], a["sp_p"])
           if p <= b["p"][-1] and t_ != "endpoint"]
    ref = [(str(t_), float(p)) for t_, p in zip(b["sp_type"], b["sp_p"])
           if t_ != "endpoint"]
    same = [t_ for t_, _ in cut] == [t_ for t_, _ in ref] and all(
        abs(x[1] - y[1]) <= 1e-9 for x, y in zip(cut, ref))
    phase("sh1d_snaking", n=200, steps=len(br) - 1, bps=bps,
          threshold_gap=gap, card_s=card_s, cpu_steps=k - 1, cpu_s=cpu_s,
          max_abs_dp=dp, same_special=same, special_cpu=ref)
    if not (gap <= 2e-3 and dp <= 1e-9 and same):
        raise AssertionError(f"sh1d: thresholds {gap}, card against CPU "
                             f"dp {dp}, special points {same}")
    return br


def wave_leg(device):
    """The Nagumo front at n = 256 and the two-generator cGL pulse at
    n = 128 (mu = 0, 0.1, 0.2) of test_wave_bvp.py."""
    dev = torch.device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=dev)

    F, ddx, u_exact, c = nagumo(torch)
    prob = bk.BifurcationProblem(F, u0=t(u_exact), params={"a": t(0.25)},
                                 lens="a")
    tw = bk.travelling_wave_problem(prob, ddx, speeds0=[-c])
    front = bk.newton(tw, bk.NewtonPar(tol=1e-8, max_iterations=30))
    F, T1, T2, a = cgl_pulse(torch, torch.roll)
    n = a.shape[0]
    uk, sk = np.stack([a, np.zeros(n)]), np.array([0.0, -1.0])
    pulses = []
    for mu in (0.0, 0.1, 0.2):
        par = {"r": t(-0.1), "nu": t(1.0), "mu": t(mu)}
        p = bk.BifurcationProblem(F, u0=torch.zeros((2, n), dtype=torch.float64,
                                                    device=dev),
                                  params=par, lens="r")
        twc = bk.travelling_wave_problem(p, (T1, T2), u0=t(uk),
                                         speeds0=t(sk))
        s = bk.newton(twc, bk.NewtonPar(tol=1e-10, max_iterations=50))
        pulses.append((s, twc))
        X = s.u.cpu().numpy()
        uk, sk = X[:2 * n].reshape(2, n), X[-2:]
    return dict(front=front, c=c, pulses=pulses, a=a)


def wave():
    """Gold values of test_wave_bvp.py on the card, card against CPU to
    1e-9."""
    legs, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t = time.perf_counter()
        legs[dev] = wave_leg(dev)
        secs[dev] = time.perf_counter() - t
    g, cpu = legs["cuda"], legs["cpu"]
    sols = [g["front"]] + [s for s, _ in g["pulses"]]
    if not all(s.converged for s in sols):
        raise AssertionError("a wave Newton did not converge on the card")
    X = g["front"].u.cpu().numpy()
    speed_gap = abs(X[-1] + g["c"])
    far = max(abs(X[0]), abs(X[-2] - 1.0))
    n = g["a"].shape[0]
    X0 = g["pulses"][0][0].u.cpu().numpy()
    X2, tw2 = g["pulses"][2][0].u, g["pulses"][2][1]
    w = np.sort(np.abs(np.linalg.eigvals(
        tw2.eig_jacobian(X2, tw2.params).cpu().numpy())))
    X2 = X2.cpu().numpy()
    gap = max(float((a.u.cpu() - b.u).abs().max()) for a, b in zip(
        sols, [cpu["front"]] + [s for s, _ in cpu["pulses"]]))
    phase("wave", front_speed=float(X[-1]), speed_gap=speed_gap,
          far_field_gap=far, pulse_speeds_mu0=X0[-2:].tolist(),
          pulse_speeds_mu02=X2[-2:].tolist(), zero_modes=w[:3].tolist(),
          card_vs_cpu=gap, card_s=secs["cuda"], cpu_s=secs["cpu"])
    if not (speed_gap < 2e-4 and far < 1e-2 and abs(X0[-2]) < 1e-10
            and abs(X0[-1] + 1.0) < 1e-10
            and abs(np.abs(X0[:n]).max() - g["a"].max()) < 1e-3
            and abs(X2[-2]) < 1e-10 and -1.0 < X2[-1] < -0.9
            and w[0] < 1e-8 and w[1] < 1e-8 and w[2] > 0.05
            and gap <= WAVE_TOL):
        raise AssertionError("wave: a gold value or the CPU's root missed")


def _bratu_prob(device, disc, lam=0.5):
    model = bratu(bk, torch)
    X0 = bk.discretize(model, disc, lambda t: np.array([
        0.1 * t * (1 - t), 0.1 * (1 - 2 * t)]), 2, device=device)
    return bk.bvp_problem(model, disc, X0, {"lam": torch.tensor(
        lam, dtype=torch.float64, device=device)}, "lam", n=2)


def bratu_fold_leg(device, disc, lam0=0.5):
    """test_wave_bvp.py::test_bratu_fold: the branch from lam0 (the
    test's 0.5) to its fold, stopped at the step that detects it, refined
    by `newton_fold`."""
    prob = _bratu_prob(device, disc, lam0)
    sol = bk.newton(prob, bk.NewtonPar(tol=1e-10))
    cp = bk.ContinuationPar(ds=0.05, dsmax=0.2, dsmin=1e-5, p_min=0.01,
                            p_max=4.0, max_steps=120, detect_bifurcation=0,
                            detect_fold=True,
                            newton_options=bk.NewtonPar(tol=1e-9))

    def past_fold(z, tau, step, res, **kw):
        return not any(sp.type == "fold" for sp in res.specialpoint)

    br = bk.continuation(prob.re_make(u0=sol.u), bk.PALC(), cp,
                         finalise_solution=past_fold)
    idx = next(i for i, sp in enumerate(br.specialpoint)
               if sp.type == "fold")
    solf = bk.newton_fold(br, idx)
    return br, solf


def _two_folds(z, tau, step, res, **kw):
    """finalise hook: stop once the branch has met two folds."""
    return sum(sp.type == "fold" for sp in res.specialpoint) < 2


def duffing_leg(device, max_steps=400):
    """test_bvp_oscillator.py's resonance curve, Ntst = 40, m = 5, to its
    second fold: the branch meets the 0.7416 fold first and the 2.4608
    one after turning (dsmax 0.1, not the test's 0.05: the same folds to
    1e-5 in 154 steps, not 300, on the CPU)."""
    model = duffing(bk, torch)
    disc = bk.BVPCollocation(Ntst=40, m=5)
    X0 = bk.discretize(model, disc, lambda t: np.array([0.0, 0.0, t]),
                       3, device=device)
    prob = bk.bvp_problem(model, disc, X0, {"lam": torch.tensor(
        3.0, dtype=torch.float64, device=device)}, "lam", n=3)
    sol = bk.newton(prob, bk.NewtonPar(tol=1e-10, max_iterations=30))
    cp = bk.ContinuationPar(ds=-0.01, dsmax=0.1, dsmin=1e-5, p_min=0.5,
                            p_max=10.05, max_steps=max_steps,
                            detect_bifurcation=0, detect_fold=True,
                            newton_options=bk.NewtonPar(tol=1e-10,
                                                        max_iterations=20))
    return bk.continuation(prob.re_make(u0=sol.u), bk.PALC(), cp,
                           finalise_solution=_two_folds)


def bvp():
    """The Duffing resonance curve on the card (its primary folds within
    2e-2 of 0.7416 and 2.4608, t(1) = 1 to 1e-8), its first steps on the
    CPU; the Bratu fold by collocation and by shooting refined by
    `newton_fold` within 5e-5 of 3.513830719, card against CPU; the COP
    solve against the dense one."""
    out = {}
    t = time.perf_counter()
    br = duffing_leg("cuda")
    out["duffing_s"] = time.perf_counter() - t
    folds = sorted(float(sp.param) for sp in br.specialpoint
                   if sp.type == "fold")
    u = br.get_solx(0).reshape(-1, 3)
    t1_gap = abs(float(u[-1, 2]) - 1.0)
    cpu = interop.branch_to_numpy(duffing_leg("cpu", DUFFING_CPU_STEPS))
    duff_dp = float(np.abs(interop.branch_to_numpy(br)["p"][:len(cpu["p"])]
                           - cpu["p"]).max())
    ok = (len(folds) >= 2 and abs(folds[-1] - 2.4608) < 2e-2
          and abs(folds[0] - 0.7416) < 2e-2 and t1_gap < 1e-8
          and duff_dp <= BVP_TOL)
    # the fold by collocation on the card and the CPU, by shooting on the
    # card (on the CPU its nested forward AD through the flow takes
    # minutes), with the shooting Newton at lam = 1 card against CPU
    fold_vals = {}
    for name, disc, lam0, devs in (
            ("collocation", bk.BVPCollocation(Ntst=15, m=4), 0.5,
             ("cuda", "cpu")),
            ("shooting", BRATU_SHOOTING, BRATU_SHOOTING_LAM0, ("cuda",))):
        vals = []
        for dev in devs:
            t = time.perf_counter()
            brb, solf = bratu_fold_leg(dev, disc, lam0)
            if not solf.converged:
                raise AssertionError(f"newton_fold on Bratu ({name}, {dev})")
            vals.append(float(solf.u[-1]))
            out[f"bratu_{name}_{dev}_s"] = time.perf_counter() - t
        fold_vals[name] = vals
        ok = ok and abs(vals[0] - BRATU_FOLD) < 5e-5 \
            and abs(vals[0] - vals[-1]) <= BVP_TOL
    roots = [bk.newton(_bratu_prob(dev, BRATU_SHOOTING, 1.0),
                       bk.NewtonPar(tol=1e-10)) for dev in ("cuda", "cpu")]
    shoot_gap = float((roots[0].u.cpu() - roots[1].u).abs().max())
    ok = ok and all(r.converged for r in roots) and shoot_gap <= BVP_TOL
    # the condensed solve against the dense one, on the card
    prob = _bratu_prob("cuda", bk.BVPCollocation(Ntst=12, m=4), lam=1.0)
    from bifurcationkit.jl_tpu_torch.bvp import (bvp_block_jacobian,
                                                 bvp_cop_solve)
    disc, X = bk.BVPCollocation(Ntst=12, m=4), prob.u0
    blocks = bvp_block_jacobian(disc, bratu(bk, torch), X, prob.params, 2)
    J = prob.jacobian(X, prob.params)
    rhs = torch.as_tensor(np.random.default_rng(3).standard_normal(
        X.shape[0]), device=X.device)
    ref = torch.linalg.solve(J, rhs)
    cop_gap = float((bvp_cop_solve(blocks, rhs) - ref).abs().max()
                    / ref.abs().max())
    ok = ok and cop_gap <= 1e-10
    phase("bvp", duffing_steps=len(br) - 1, duffing_folds=folds,
          t1_gap=t1_gap, duffing_cpu_steps=len(cpu["p"]) - 1,
          duffing_max_abs_dp=duff_dp, bratu_folds=fold_vals,
          shooting_newton_gap=shoot_gap, cop_vs_dense=cop_gap, **out)
    if not ok:
        raise AssertionError("bvp: a gold value or the CPU's result missed")


def io_native(shp_branch, sh1d_branch):
    """Branches saved and loaded back (the 512x512 periodic run's table
    and spectra, the SH1d branch with its special points and solutions),
    a BranchLog round trip, and the host converters of the compiled
    library."""
    import tempfile

    from bifurcationkit.jl_tpu_torch import native

    if not native.loaded():
        raise AssertionError("the port's native library did not build")
    out = {}
    os.makedirs(OUT_DIR, exist_ok=True)   # a fresh checkout has none yet
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as d:
        for name, br in (("sh_periodic", shp_branch), ("sh1d", sh1d_branch)):
            path = bk.save_branch(br, os.path.join(d, name))
            back = bk.load_branch(path)
            same = (np.array_equal(back.param, br.param)
                    and [(s.type, s.param) for s in back.specialpoint]
                    == [(s.type, float(s.param)) for s in br.specialpoint]
                    and len(back.eig) == len(br.eig)
                    and all(np.array_equal(a["eigenvals"], b["eigenvals"])
                            for a, b in zip(back.eig, br.eig))
                    and all(torch.equal(a["x"], b["x"]) for a, b in
                            zip(back.sol, br.sol)))
            out[name] = dict(rows=len(back), special=len(back.specialpoint),
                             sols=len(back.sol), same=same,
                             mib=os.path.getsize(path) / 2 ** 20)
        log = native.BranchLog(os.path.join(d, "log.bin"), 4)
        rows = np.random.default_rng(4).standard_normal((5, 4))
        for i, r in enumerate(rows):
            log.append(i, r)
        log.close()
        steps, vals = native.BranchLog.read(os.path.join(d, "log.bin"), 4)
        log_ok = np.array_equal(steps, np.arange(5)) and \
            np.array_equal(vals, rows)
    import scipy.sparse as sp

    S = sp.diags([1.0, -2.0, 1.0, 0.5], [-1, 0, 1, 64],
                 shape=(4096, 4096)).tocsr()
    data, offs = native.csr_to_dia_arrays(S.indptr, S.indices, S.data)
    ell, cols = native.csr_to_ell_arrays(S.indptr, S.indices, S.data)
    conv_ok = offs == (-1, 0, 1, 64) and ell.shape == (4096, 4) and \
        float(np.abs(data[1] + 2.0).max()) == 0.0
    phase("io_native", library=os.path.basename(str(
        native.library_path())), branches=out, branch_log=log_ok,
        converters=conv_ok)
    if not (all(v["same"] for v in out.values()) and log_ok and conv_ok):
        raise AssertionError("io_native: a round trip or a converter "
                             "failed")


# ---------------------------------------------------------------------------
# 3b, 4n. the multi-device path (jl_tpu_torch/parallel)
# ---------------------------------------------------------------------------

PARALLEL_RANKS = 2
MESH_2D = (2, 2)           # the second spawn's time x space mesh (4 ranks)
PARALLEL_BUDGET_S = 90     # compare_halo and parallel together
# (shape, row blocks) of compare_halo: the dry run's 152 x 100 (leg 4) in
# 2, 4 and 8 blocks, a ragged 37 x 23 in 3, and 6 x 23 in 3 blocks of 2
# rows; each at every batch size of HALO_KS
HALO_SPLITS = [((152, 100), 2), ((152, 100), 4), ((152, 100), 8),
               ((37, 23), 3), ((6, 23), 3)]
# every K at which the parallel phase launches the halo closure (K = 1:
# F, GMRES and Arnoldi apply J to one field) and one past it; `parallel`
# fails on a (dtype, K) it launched that is not here
HALO_KS = (1, 2)


def compare_halo():
    """`sh_jv_halo` on row blocks of a field, each given its neighbours'
    rows and the global-edge flags, against the whole-field Neumann kernel
    and against the plain version of each block, f64 and f32."""
    worst, checked = 0.0, set()
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for i, (shape, nb) in enumerate(HALO_SPLITS):
            bounds = [int(b) for b in np.linspace(0, shape[0], nb + 1).round()]
            for K in HALO_KS:
                u, v, scal = _inputs(shape, K, dtype, seed=80 + i)
                vv = v if K > 1 else v[0]
                out = sh_jv_mod.sh_jv_by_blocks(u, vv, scal, bounds)
                whole = sh_jv_mod.sh_jv(u, vv, scal)
                torch.cuda.synchronize()
                plain = sh_jv_mod.sh_jv_by_blocks(
                    u, vv, scal, bounds, fn=sh_jv_mod.sh_jv_halo_plain)
                err_plain = float((out - plain).abs().max())
                err_whole = float((out - whole).abs().max())
                rel_plain = err_plain / float(plain.abs().max())
                rel_whole = err_whole / float(whole.abs().max())
                phase("compare_halo", dtype=name,
                      shape=f"{shape[0]}x{shape[1]}", blocks=nb, K=K,
                      max_abs_err=err_plain, max_rel_err=rel_plain,
                      max_rel_err_whole=rel_whole, tol=TOL[dtype])
                if not (rel_plain < TOL[dtype] and rel_whole < TOL[dtype]):
                    raise AssertionError(
                        f"sh_jv's halo closure disagrees: {rel_plain} "
                        f"(plain), {rel_whole} (whole-field kernel)")
                worst = max(worst, err_plain)
                checked.add((name, K))
    return worst, checked


def parallel_rank(n_ranks, t_spawn):
    """One rank of the `parallel` phase, in a process of its own that
    `parallel` spawns: dry-run legs 1-7 on the card, then the
    row-partitioned DIA SpMV at the Brusselator path's shape against the
    single-device product.  Returns the rank's numbers, with the seconds
    from the spawn to the rank's start."""
    started = time.time() - t_spawn
    from bifurcationkit.jl_tpu_torch.parallel import (
        dryrun, full_state, make_mesh, sharded_dia_spmv)

    torch.cuda.set_device(0)
    mesh = make_mesh((1, n_ranks), device="cuda")
    out = dryrun.dryrun_multichip(n_ranks, "cuda", mesh=mesh)
    A, v = _dia_inputs(2 * BRUSS_SITES, PATH_OFFSETS, 1, torch.float64,
                       seed=90)
    dia_spmv.launches = 0
    got = full_state(sharded_dia_spmv(mesh, A, v), mesh)
    launches = dia_spmv.launches
    ref, plain = A.matvec(v), dia_spmv_plain(A, v)
    torch.cuda.synchronize()
    out["dia"] = dict(n=2 * BRUSS_SITES, offsets=list(PATH_OFFSETS),
                      launches=launches,
                      max_abs_err=float((got - ref).abs().max()),
                      max_abs_err_plain=float((got - plain).abs().max()),
                      scale=float(ref.abs().max()))
    out["device"] = torch.cuda.get_device_name(0)
    out["start_s"] = started
    return out


def parallel_rank_2d(nt, ns, t_spawn):
    """One rank of the `parallel` phase's second spawn: dry-run leg 6 on a
    real (nt, ns) time x space mesh of nt ns ranks on the one card."""
    started = time.time() - t_spawn
    from bifurcationkit.jl_tpu_torch.parallel import dryrun

    torch.cuda.set_device(0)
    out = dryrun.dryrun_mesh2d(nt, ns, "cuda")
    out["device"] = torch.cuda.get_device_name(0)
    out["start_s"] = started
    return out


def _rel(a, b):
    """||a - b|| / ||b||, the dry run's relative error."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# per new leg: the arrays held to one device on the card to 1e-8 relative
# (the JAX dry run's bound) and the counts that must equal one device's
NEW_LEG_CHECKS = {
    "leg3": (("x", "M"), ()),
    "leg5": (("x", "u_po"), ("newton_it",)),
    "leg6": (("x", "monodromy_apply"), ("gmres_it",)),
    "leg7": (("v", "w", "apply", "sigma"),
             ("sigma_gmres_matvecs", "adjoint_gmres_matvecs"))}


def _check_new_leg(r, leg, got, ref, launches):
    """Leg 3, 5, 6 or 7 of rank r against one device: within 1e-8, the
    same iteration counts, no kernel launched.  Returns its row."""
    arrays, counts = NEW_LEG_CHECKS[leg]
    gaps = {k: _rel(got[k], ref[k]) for k in arrays}
    row = dict(rel_err=gaps, launches=launches,
               **{k: got[k] for k in counts})
    bad = {k: g for k, g in gaps.items() if not g <= 1e-8}
    bad.update({k: (got[k], ref[k]) for k in counts if got[k] != ref[k]})
    if any(launches.values()):
        bad["launches"] = launches
    if bad:
        raise AssertionError(f"rank {r}: {leg} against one device on the "
                             f"card: {bad}")
    return row


def parallel():
    """The multi-device path on the one card: PARALLEL_RANKS ranks spawned
    as processes of their own (gloo, halos and reductions through pinned
    host buffers; every kernel and all compute on the card), legs 1-7 of
    the dry run (leg 4 at 152 x 100, leg 6 on its 2 x 1 time x space
    mesh) and the sharded DIA SpMV; then a second spawn of 4 ranks runs
    leg 6 on a 2 x 2 mesh; then the same legs single-device on the card.
    Checks: every rank converged; leg 4's halo'd J.v within 1e-10 of the
    single-device one; each of legs 1, 2 and 4's p within 1e-8 of the
    single device's, the same detection counts, leg 1's states, its
    secant tangent and the secant corrector's p within 1e-8; legs 3 and
    5-7 (and leg 6 at 2 x 2) within 1e-8 relative of one device's, with
    the same GMRES iterations and no kernel launched; the DIA product
    within 1e-12 of the single-device kernel's and of the plain version
    (relative to its max); the halo closure and dia_spmv launched on
    every rank.  Returns (halo launches by (dtype, K) over the ranks,
    dia_spmv launches over the ranks)."""
    from bifurcationkit.jl_tpu_torch.parallel import dryrun, launch

    here = os.path.join(ROOT, "chip_smoke.py")
    t0 = time.perf_counter()
    ranks = launch.start_ranks(
        f"{here}:parallel_rank", PARALLEL_RANKS,
        dict(n_ranks=PARALLEL_RANKS, t_spawn=time.time()), timeout=240)
    res = ranks.join()
    t_ranks = time.perf_counter() - t0
    nt, ns = MESH_2D
    t0 = time.perf_counter()
    ranks = launch.start_ranks(
        f"{here}:parallel_rank_2d", nt * ns,
        dict(nt=nt, ns=ns, t_spawn=time.time()), timeout=240)
    res_2d = ranks.join()
    t_ranks_2d = time.perf_counter() - t0
    reset_launches()
    single = dryrun.single_device(PARALLEL_RANKS, "cuda")
    single_launches = sh_jv_mod.launch_count()
    single_2d = dryrun.leg6_mesh2d(None, torch.device("cuda"), nt, ns)
    halo, dia_launches = {}, 0
    for r, out in enumerate(res):
        for key, n in out["halo_launches"].items():
            halo[key] = halo.get(key, 0) + n
        dia_launches += out["dia"]["launches"]
        legs = {}
        for leg in ("leg1", "leg2", "leg4"):
            got, ref = out[leg], single[leg]
            p_got = got["palc_p"] if leg == "leg1" else got["p"]
            p_ref = ref["palc_p"] if leg == "leg1" else ref["p"]
            legs[leg] = dict(seconds=out["seconds"][leg], p=p_got,
                             p_single=p_ref, p_gap=abs(p_got - p_ref),
                             launches=out["launches"][leg])
            if leg == "leg1":
                # the Newton state, the dry run's corrector (its tangent's
                # u-part zero) and the corrector on the secant tangent
                # whose u-part is not
                gaps = {key: float(np.max(np.abs(got[key] - ref[key])))
                        for key in ("u_newton", "u_palc", "tau_u_secant",
                                    "u_secant")}
                gaps.update({key: abs(got[key] - ref[key])
                             for key in ("secant_tau_p", "secant_p")})
                legs[leg].update(newton_it=got["newton_it"],
                                 newton_gmres_it=got["newton_gmres_it"],
                                 palc_it=got["palc_it"],
                                 palc_gmres_it=got["palc_gmres_it"],
                                 secant_it=got["secant_it"],
                                 secant_gmres_it=got["secant_gmres_it"],
                                 secant_p=got["secant_p"],
                                 secant_p_single=ref["secant_p"],
                                 newton_it_single=ref["newton_it"],
                                 gaps=gaps)
                bad = {k: g for k, g in gaps.items() if not g <= 1e-8}
                if bad:
                    raise AssertionError(f"rank {r}: leg 1's states are "
                                         f"not within 1e-8 of one "
                                         f"device's: {bad}")
            else:
                legs[leg].update(
                    itnewton=got["itnewton"], itlinear=got["itlinear"],
                    n_unstable=got["n_unstable"],
                    n_unstable_single=ref["n_unstable"],
                    converged_eig=got["converged_eig"])
                if got["n_unstable"] != ref["n_unstable"]:
                    raise AssertionError(
                        f"rank {r}: {leg}'s detection counts "
                        f"{got['n_unstable']} != {ref['n_unstable']}")
            if not abs(p_got - p_ref) <= 1e-8:
                raise AssertionError(f"rank {r}: {leg}'s p {p_got} is not "
                                     f"within 1e-8 of one device's {p_ref}")
        for leg in NEW_LEG_CHECKS:
            legs[leg] = dict(seconds=out["seconds"][leg], **_check_new_leg(
                r, leg, out[leg], single[leg], out["launches"][leg]))
        dia = out["dia"]
        if not (max(dia["max_abs_err"], dia["max_abs_err_plain"])
                <= 1e-12 * max(dia["scale"], 1.0)) or dia["launches"] < 1:
            raise AssertionError(f"rank {r}: sharded dia_spmv {dia}")
        if not out["halo_launches"]:
            raise AssertionError(f"rank {r} launched no halo closure")
        phase("parallel_rank", spawn=1, rank=r, device=out["device"],
              transport=out["transport"], start_s=out["start_s"],
              jv_rel_err=out["leg4"]["jv_rel_err"], legs=legs,
              halo_launches=out["halo_launches"], dia=dia)
    for r, out in enumerate(res_2d):
        row = _check_new_leg(r, "leg6", out["leg6"], single_2d,
                             out["launches"]["leg6"])
        phase("parallel_rank", spawn=2, rank=r, device=out["device"],
              transport=out["transport"], start_s=out["start_s"],
              mesh=f"{nt}x{ns} (time x space)",
              legs={"leg6": dict(seconds=out["seconds"]["leg6"], **row)})
    phase("parallel", ranks=PARALLEL_RANKS, seconds_ranks=t_ranks,
          ranks_2d=nt * ns, mesh_2d=f"{nt}x{ns}",
          seconds_ranks_2d=t_ranks_2d,
          halo_launches=halo, dia_launches=dia_launches,
          single_device_sh_jv_launches=single_launches,
          gpu_to_gpu_collective="none: one card; gloo moves host copies")
    return halo, dia_launches


HALO_TIMING = (76, 100)    # rank 0's block of 152 x 100 over 2 ranks


def time_halo(floor):
    """The halo closure on a rank's block (its top the global edge, the 2
    rows below it from the next rank), K = 1, f64 and f32, beside the
    whole-field Neumann kernel at 152 x 100."""
    cases = []
    B, M = HALO_TIMING
    for dtype in F32_64:
        u, v, scal = _inputs((B, M), 1, dtype, seed=7)
        vv = v[0]
        bot = _inputs((2, M), 1, dtype, seed=8)[1][0]

        def kern():
            return sh_jv_mod.sh_jv_halo(u, vv, None, bot, scal, True, False)

        def plain():
            return sh_jv_mod.sh_jv_halo_plain(u, vv, None, bot, scal, True,
                                              False)

        tk1, tp1 = _time(kern, 1000), _time(plain, 1000)
        tk2, tp2 = _time(kern, 1000), _time(plain, 1000)
        case = dict(closure="halo", dtype=str(dtype).split(".")[-1],
                    shape=f"{B}x{M}", K=1, halo_rows=2, ms=(tk1 + tk2) / 2,
                    host_ms=_host_time(kern, 1000),
                    device_ms=_device_time(kern, "sh_jv_kernel"),
                    graph_ms=_graph_time(kern), plain_ms=(tp1 + tp2) / 2,
                    plain_device_ms=_device_time(plain),
                    **_bound(sh_jv_mod.sh_jv_halo_bytes(
                        B, M, 1, u.element_size(), halo_rows=2),
                        sh_jv_mod.sh_jv_flops(B, M, 1), dtype),
                    **floor,
                    library="none: no single PyTorch call computes SH J.v")
        cases.append(case)
        phase("timing_halo", **case)
    return cases + time_kernel(floor, [((2 * B, M), 1, F32_64)])


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
    """Milliseconds per call of fn on the card alone (torch.profiler), over
    the kernels whose name holds `name`: for each, the mean of its
    recorded events times the events a call launches (its count over
    `calls`, rounded).  The H100's profiler drops a few kernel events of
    a profile (mostly 7 or 8, now and then up to all of them), so a sum
    over `calls` calls reads low; the mean over the events it kept does
    not.  A kernel whose count lies more than 10 % from a whole multiple
    of `calls` is retried, and after three such profiles the time is
    "not measured"."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        rows, _ = _profile(lambda: [fn() for _ in range(calls)])
        per = [(us, c, round(c / calls)) for n, us, c in rows if name in n]
        if per and all(k >= 1 and abs(c - k * calls) <= 0.1 * k * calls
                       for _, c, k in per):
            return sum(us / c * k for us, c, k in per) / 1e3
        phase("device_time_retry", kernel=name or "all", calls=calls,
              recorded=sum(c for _, c, _ in per))
    return "not measured"


def _graph_time(fn, calls=50, reps=10):
    """Milliseconds per call of fn on the card without the profiler:
    `calls` calls captured in one CUDA graph, its replays timed by two
    CUDA events.  The graph launches its kernels from the card, back to
    back, so a kernel longer than the graph's own gap between kernels
    reads its device time plus that gap."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


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
                 device_floor_ms=_device_time(lambda: one.add_(0)),
                 graph_floor_ms=_graph_time(lambda: one.add_(0)))
    phase("device_floor", clocks=smi_line(CLOCKS), **floor)
    return floor


F32_64 = (torch.float32, torch.float64)
# (shape, K, dtypes) of each closure's timing rows: the flagship's and the
# periodic SH2d path's shapes
SH_TIMING = [((151, 100), 1, F32_64), ((151, 100), 60, F32_64),
             ((1024, 1024), 1, F32_64)]
SHP_TIMING = [((SHP_N, SHP_N), 1, F32_64),
              ((SHP_N, SHP_N), 15, (torch.float32,))]


def time_kernel(floor, rows=SH_TIMING, closure="neumann"):
    cases = []
    for shape, K, dtypes in rows:
        for dtype in dtypes:
            u, v, scal = _inputs(shape, K, dtype, seed=7)
            vv = v if K > 1 else v[0]
            # the jac_op route
            op = sh_jv_mod.sh_jv_operator(u, scal, closure)
            reps = 2000 if shape == (151, 100) and K == 1 else 300

            def kern():
                return sh_jv_mod.sh_jv(u, vv, scal, closure)

            def oper():
                return op(vv)

            def plain():
                return sh_jv_mod.sh_jv_plain(u, vv, scal, closure)

            # in turns: kernel, operator, plain, then again
            tk1, to1, tp1 = _time(kern, reps), _time(oper, reps), \
                _time(plain, reps)
            tk2, to2, tp2 = _time(kern, reps), _time(oper, reps), \
                _time(plain, reps)
            N, M = shape
            case = dict(closure=closure, dtype=str(dtype).split(".")[-1],
                        shape=f"{N}x{M}", K=K, ms=(tk1 + tk2) / 2,
                        operator_ms=(to1 + to2) / 2,
                        host_ms=_host_time(kern, reps),
                        operator_host_ms=_host_time(oper, reps),
                        device_ms=_device_time(kern, "sh_jv_kernel"),
                        graph_ms=_graph_time(kern),
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
                        sh_jv_mod.sh_jv, uc, vc if K > 1 else vc[0], sc,
                        closure))
                case.update(cold_copies=copies, device_cold_ms=_device_time(
                    _in_turn(calls), "sh_jv_kernel"),
                    graph_cold_ms=_graph_time(_in_turn(calls)))
            if K == 1 and shape == (151, 100) and closure == "neumann":
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
    f32_64 = (torch.float32, torch.float64)
    for n, offsets, K, dtypes in (
            (2 * BRUSS_SITES, PATH_OFFSETS, 1, f32_64),
            (1 << 20, (-1024, -1, 0, 1, 1024), 1, f32_64),
            *[(n, off, K, (torch.float64,)) for n, off, K in PDE_DIA],
            *[(n, off, K, (torch.float64,)) for n, off, K in BVAM_DIA
              if K in (240, 400)]):
        for dtype in dtypes:
            A, v = _dia_inputs(n, offsets, K, dtype, seed=7)
            csr = _csr_of(A)
            reps = 2000 if n < 4096 else 300

            def kern():
                return dia_spmv(A, v)

            def plain():
                return dia_spmv_plain(A, v)

            def library():
                # SpMV, or SpMM on the K vectors as columns
                return csr @ v if K == 1 else (csr @ v.T).T

            ref = plain()
            lib_rel = float((library() - ref).abs().max() / ref.abs().max())
            # in turns: kernel, plain, library, then again
            tk1, tp1, tl1 = _time(kern, reps), _time(plain, reps), \
                _time(library, reps)
            tk2, tp2, tl2 = _time(kern, reps), _time(plain, reps), \
                _time(library, reps)
            case = dict(dtype=str(dtype).split(".")[-1], n=n,
                        offsets=list(offsets), K=K, ms=(tk1 + tk2) / 2,
                        host_ms=_host_time(kern, reps),
                        device_ms=_device_time(kern, "dia_spmv_kernel"),
                        graph_ms=_graph_time(kern),
                        plain_ms=(tp1 + tp2) / 2,
                        plain_device_ms=_device_time(plain),
                        library_ms=(tl1 + tl2) / 2,
                        library_host_ms=_host_time(library, reps),
                        library_device_ms=_device_time(library),
                        library="cuSPARSE CSR SpMV (torch sparse_csr @ v)"
                        if K == 1 else "cuSPARSE CSR SpMM (torch sparse_csr"
                        " @ v.T)",
                        library_max_rel_err=lib_rel,
                        **_bound(dia_spmv_bytes(n, offsets, K,
                                                v.element_size()),
                                 dia_spmv_flops(n, offsets, K), dtype),
                        **floor)
            copies = _cold_copies(dia_spmv_bytes(n, offsets, K,
                                                 v.element_size()))
            if copies:
                kerns, libs = [], []
                for c in range(copies):
                    Ac, vc = _dia_inputs(n, offsets, K, dtype, seed=100 + c)
                    kerns.append(functools.partial(dia_spmv, Ac, vc))
                    libs.append(functools.partial(torch.matmul, _csr_of(Ac),
                                                  vc))
                case.update(cold_copies=copies, device_cold_ms=_device_time(
                    _in_turn(kerns), "dia_spmv_kernel"),
                    graph_cold_ms=_graph_time(_in_turn(kerns)),
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


WALL_S = {}
ZOO_PHASES = ("sh_periodic", "check_sh_periodic", "sh3d", "sh1d_snaking",
                  "wave", "bvp", "io_native")


def zoo(card, periodic_cases):
    """The phases of section 4m, each with the launch counts reset just
    before it and read just after; the periodic SH2d must launch sh_jv
    only at (dtype, K) that compare_periodic checks.  Returns the
    sh_periodic results and the launches of each kernel by phase."""
    by_phase = {"sh_jv": {}, "dia_spmv": {}}

    def run(name, fn, *args):
        reset_launches()
        out = walled(name, fn, *args)
        by_phase["sh_jv"][name] = sh_jv_mod.launch_count()
        by_phase["dia_spmv"][name] = dia_spmv.launches
        return out

    shp = run("sh_periodic", sh_periodic, card)
    unchecked = sorted(shp["ks"] - periodic_cases)
    if unchecked:
        raise AssertionError(f"sh_periodic launched sh_jv at {unchecked}, "
                             f"which no compare_periodic case checks")
    run("check_sh_periodic", check_sh_periodic)
    run("sh3d", sh3d, card)
    br1 = run("sh1d_snaking", sh1d_snaking)
    run("wave", wave)
    run("bvp", bvp)
    run("io_native", io_native, shp["branch"], br1)
    quiet = {k: v for k, v in by_phase["sh_jv"].items()
             if k not in ("sh_periodic", "check_sh_periodic") and v}
    if quiet or any(by_phase["dia_spmv"].values()):
        raise AssertionError(f"a phase of section 4m launched a kernel it "
                             f"does not use: {by_phase}")
    secs = sum(WALL_S[k] for k in ZOO_PHASES)
    phase("zoo_budget", seconds=secs, budget_s=ZOO_BUDGET_S,
          within_budget=secs <= ZOO_BUDGET_S)
    return shp, by_phase


def walled(name, fn, *args):
    """Run one part of the script, keeping its seconds on the host clock
    in WALL_S."""
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    WALL_S[name] = time.perf_counter() - t
    return out


def main():
    t0 = time.perf_counter()
    card = check_device()
    walled("build", build)
    max_abs_err, compared_ks = walled("compare", compare_kernel)
    periodic_abs_err, periodic_cases = walled("compare_periodic",
                                              compare_periodic)
    dia_abs_err = walled("compare_dia", compare_dia)
    halo_abs_err, halo_checked = walled("compare_halo", compare_halo)
    halo_by_case, parallel_dia = walled("parallel", parallel)
    unchecked = sorted({(d, int(k)) for d, k in (
        key.split("/K=") for key in halo_by_case)} - halo_checked)
    if unchecked:
        raise AssertionError(f"the parallel phase launched sh_jv's halo "
                             f"closure at {unchecked}, which no "
                             f"compare_halo case checks")
    par_s = WALL_S["compare_halo"] + WALL_S["parallel"]
    phase("parallel_budget", seconds=par_s, budget_s=PARALLEL_BUDGET_S,
          within_budget=par_s <= PARALLEL_BUDGET_S)
    prob, ls, br, state, launches, by_batch, steps_per_s = walled(
        "main_path", main_path, card)
    sh_phases = {"main_path": launches,
                 "parallel": sum(halo_by_case.values())}
    bp_launches, bp_by_batch = walled("flagship_bp", flagship_bp, card,
                                      prob, ls, br)
    fold_launches, fold_by_batch = walled("flagship_fold", flagship_fold,
                                          card)
    sh_phases.update(flagship_bp=bp_launches, flagship_fold=fold_launches)
    launches = sum(sh_phases.values())
    for more in (bp_by_batch, fold_by_batch):
        for K, c in more.items():
            by_batch[K] = by_batch.get(K, 0) + c
    by_batch = dict(sorted(by_batch.items()))
    unchecked = sorted(set(by_batch) - compared_ks)
    if unchecked:
        raise AssertionError(f"the flagship launched sh_jv at K = "
                             f"{unchecked}, which no compare case checks")
    dia_launches, bruss_seconds, bprob, bbr = walled(
        "brusselator_path", brusselator_path, card)
    nf_launches, bruss_hp = walled("bruss_hopf_nf", bruss_hopf_nf, card,
                                   bprob, bbr)
    dia_phases = {
        "parallel": parallel_dia,
        "brusselator_path": dia_launches, "bruss_hopf_nf": nf_launches,
        "bruss_hopf_curve": walled("bruss_hopf_curve", bruss_hopf_curve,
                                   card, bprob, bbr)}
    po_launches = walled("po_cgl", po_cgl, card)
    pob_launches = walled("po_bruss", po_bruss, card, bruss_hp)
    posh_launches = walled("po_bruss_shooting", po_bruss_shooting, card)
    dia_phases["po_bruss_shooting"] = posh_launches["dia_spmv"]
    dia_launches = sum(dia_phases.values())
    walled("check_small_nf", lambda: check_small_nf(
        check_outputs(prob, state)))
    walled("check_bruss_small", check_bruss_small)
    dia_phases["codim2_bt_pde"] = walled("codim2_bt_pde", codim2_bt_pde,
                                         card)
    dia_phases["codim2_zh_pde"] = walled("codim2_zh_pde", codim2_zh_pde,
                                         card)
    dia_launches = sum(dia_phases.values())
    walled("check_small_codim2", check_small_codim2)
    codim2_s = sum(WALL_S[k] for k in ("codim2_bt_pde", "codim2_zh_pde",
                                       "check_small_codim2"))
    phase("codim2_budget", seconds=codim2_s, budget_s=CODIM2_BUDGET_S,
          within_budget=codim2_s <= CODIM2_BUDGET_S)
    dia_phases["po_bvam"], bvam_rows = walled("po_bvam", po_bvam, card)
    unchecked = sorted(set(bvam_rows) - set(BVAM_DIA_ROWS))
    if unchecked:
        raise AssertionError(f"po_bvam launched dia_spmv on {unchecked} "
                             f"rows, which no compare case checks")
    dia_launches = sum(dia_phases.values())
    walled("check_small_po_codim2", check_small_po_codim2)
    po2_s = WALL_S["po_bvam"] + WALL_S["check_small_po_codim2"]
    phase("po_codim2_budget", seconds=po2_s, budget_s=BVAM_BUDGET_S,
          within_budget=po2_s <= BVAM_BUDGET_S)
    shp, zoo_phases = zoo(card, periodic_cases)
    sh_phases["sh_periodic"] = zoo_phases["sh_jv"]["sh_periodic"]
    launches = sum(sh_phases.values())
    floor = device_floor()
    cases = walled("time_kernel", time_kernel, floor)
    periodic_timing = walled("time_periodic", time_kernel, floor,
                             SHP_TIMING, "periodic")
    halo_timing = walled("time_halo", time_halo, floor)
    dia_cases = walled("time_dia", time_dia, floor)
    phase("clocks_after_timing", clocks=smi_line(CLOCKS))
    phase("wall", seconds=WALL_S, total_s=time.perf_counter() - t0)
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
        # the periodic-orbit and codim-2 PDE paths launch no sh_jv
        # (checked); of the phases of section 4m, sh_periodic (the
        # periodic closure) and its check do
        "launches_by_phase": {**sh_phases, "po_cgl": po_launches["sh_jv"],
                              "po_bruss": pob_launches["sh_jv"],
                              "po_bruss_shooting": posh_launches["sh_jv"],
                              "codim2_bt_pde": 0, "codim2_zh_pde": 0,
                              "po_bvam": 0, **zoo_phases["sh_jv"]},
        "cases": cases,
        "periodic": {
            "entry_points": ["sh_jv_periodic_f32", "sh_jv_periodic_f64"],
            "max_abs_err": periodic_abs_err,
            "sh_periodic_launches_by_case": {
                f"{d}/K={k}": n for (c, d, k), n in sorted(
                    shp["by_case"].items())},
            "steps_per_s": shp["steps_per_s"],
            "cases": periodic_timing},
        "halo": {
            "entry_points": ["sh_jv_halo_f32", "sh_jv_halo_f64"],
            "max_abs_err": halo_abs_err,
            "launches_by_phase": {"parallel": sh_phases["parallel"]},
            "launches_by_case": halo_by_case,
            "cases": halo_timing},
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
        # po_cgl and po_bruss launch none (checked); po_bruss_shooting's
        # matrix-free monodromy, the codim-2 PDE paths and po_bvam do
        # (checked)
        "launches_by_phase": {**dia_phases,
                              "po_cgl": po_launches["dia_spmv"],
                              "po_bruss": pob_launches["dia_spmv"],
                              **zoo_phases["dia_spmv"]},
        "po_bvam_launches_by_rows": dict(sorted(bvam_rows.items())),
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
