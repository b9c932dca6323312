"""The multi-device dry run of the port, modelled on the JAX package's
`__graft_entry__.py::dryrun_multichip`: its seven legs, each on states,
blocks or intervals split over the ranks of a mesh axis, with the solver
stack run rank-locally (inside `use_mesh` where it reduces over a state's
blocks, mesh and axis passed explicitly where it gathers).

* leg 1: the tiny Brusselator (8 sites a rank) split by sites over
  `space`, Newton from the perturbed homogeneous state, then one PALC
  corrector step (the JAX dry run's, its tangent's u-part zero) and one
  more with a secant tangent off a seeded direction, whose u-part is not;
* leg 2: SH2d at (4 ranks) x 12 split by rows, 3 continuation steps with
  detection and the f32 Arnoldi stability sweep;
* leg 3: the Stuart-Landau collocation PO at Collocation(2 ranks, 3):
  the COP solve with the intervals split over `time`
  (`parallel/cop.py`), and the monodromy tree product of each rank's
  interval maps (`ops.sharded_monodromy`);
* leg 4: SH2d at the flagship's resolution, 152 x 100 (151 rows do not
  divide): the halo'd J.v against the single-device one, then one
  continuation step with detection on the row-sharded trivial branch,
  every J.v through `sharded_sh_jv`;
* leg 5: the zero-Hopf ODE's PO at Collocation(2 ranks, 4) by
  `newton_po`, then one solve of the functional PO-MA corrector of its
  Neimark-Sacker problem on time-split COP blocks
  (`cop.POMinAugLSSharded`, complex borders);
* leg 6: a (nt, ns) time x space mesh: the Brusselator PO's COP solve
  with its blocks placed over both axes, gathered over `space` and
  solved over `time`, and the matrix-free trapezoid monodromy apply
  (FloquetQaDMF's operator, block GMRES) on a state split by sites over
  `space`, on the batched `brusselator_1d_sharded`;
* leg 7: the matrix-free fold MA problem of the Brusselator (8 sites a
  rank): its sigma system, a replicated scalar tail on a head split by
  sites, by the nested GMRES sigma and adjoint solves, and one Govaerts
  operator apply, on the sharded model's closed-form derivatives.

`dryrun_multichip(n_ranks, device)` runs inside already initialised ranks
(`launch.start_ranks("bifurcationkit.jl_tpu_torch.parallel.dryrun:"
"dryrun_multichip", n)` spawns them) and returns, on every rank, the
legs' numbers as plain Python values; `dryrun_mesh2d(nt, ns)` runs leg 6
alone on any (nt, ns) mesh (2 x 2 on 4 ranks splits both axes).  Each leg
with its mesh None runs the same work on one device with the unsharded
models (`single_device`), to compare against.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from .. import resolve_device
from ..interop import state_to_mesh
from ..continuation.algorithms import PALC
from ..codim2.minaug_mf import fold_ma_problem_mf
from ..continuation.engine import ContIterable
from ..core.params import ContinuationPar, NewtonPar
from ..core.problem import BifurcationProblem
from ..core.state import BorderedState, tree_axpy
from ..linalg.eig import ArnoldiEig
from ..linalg.linear import GMRES
from ..models.equilibria import brusselator_1d, stuart_landau
from ..models.sh import swift_hohenberg_2d
from ..ops import sh_jv as sh_ops
from ..ops.dia_spmv import dia_spmv
from ..ops.sh_jv import sh_jv
from ..periodic.codim2 import POMinAugLS, _po_ma_problem_functional
from ..periodic.collocation import Collocation
from ..periodic.cop import (collocation_block_jacobian, cop_interval_maps,
                            cop_solve)
from ..periodic.floquet import monodromy_from_maps
from ..periodic.orbits import newton_po, periodic_orbit_problem
from ..periodic.trapezoid import Trapeze
from .cop import (POMinAugLSSharded, cop_solve_sharded, place_blocks_2d,
                  shard_blocks, shard_from_2d)
from .halo import sharded_sh_jv_local
from .mesh import full_state, local_block, make_mesh, transport, use_mesh
from .models import brusselator_1d_sharded, swift_hohenberg_2d_sharded
from .ops import sharded_monodromy

FLAGSHIP_ROWS, FLAGSHIP_COLS = 152, 100
LX, LY = 8 * np.pi, 2 * 2 * np.pi / np.sqrt(3)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _scope(mesh):
    return contextlib.nullcontext() if mesh is None else use_mesh(mesh)


def leg1_secant_direction(n_sites: int) -> np.ndarray:
    """The seeded state offset whose secant gives leg 1's second corrector
    its tangent (the homogeneous state solves the Brusselator at every l,
    so a secant of two solutions has no u-part)."""
    return np.random.default_rng(5).standard_normal(2 * n_sites)


def leg1_brusselator(mesh, device, n_ranks: int) -> dict:
    """Newton from the perturbed state, then one PALC corrector step with
    the dry run's tangent (u-part zero), then one with the secant tangent
    from the solution to it moved by 1e-2 along the seeded direction
    (`leg1_secant_direction`) and in p; the states come back in the
    global layout [u; v]."""
    n_sites = 8 * n_ranks
    # one device: the model with its closed-form J.v, as the sharded one
    prob = (brusselator_1d(n=n_sites, device=device, batched=True)
            if mesh is None
            else brusselator_1d_sharded(mesh, n=n_sites, device=device))
    p0 = 0.3
    cp = ContinuationPar(
        ds=1e-2, dsmax=5e-2, dsmin=1e-7, p_min=0.25, p_max=0.8, max_steps=3,
        detect_bifurcation=0, detect_fold=False,
        newton_options=NewtonPar(
            tol=1e-8, max_iterations=12,
            linsolver=GMRES(restart=160, maxiter=320, rtol=1e-10)))
    it = ContIterable(prob, PALC(), cp)
    u_glob = np.concatenate([np.full(n_sites, 2.0), np.full(n_sites, 2.725)])
    u_glob = u_glob + 1e-2 * np.sin(np.arange(2 * n_sites) * 0.1)
    w_glob = leg1_secant_direction(n_sites)

    def put(x):
        return (torch.tensor(x, device=device) if mesh is None else
                state_to_mesh(x.reshape(2, -1), mesh, dim=1).reshape(-1))

    u0 = put(u_glob)
    kn = it.kernels
    with _scope(mesh):
        u_conv, cv, itn, itl, res = kn.newton_fixed(u0, kn.as_p(p0),
                                                    prob.params)
        assert cv, f"sharded Newton did not converge (res={res})"
        z = BorderedState(u=u_conv, p=kn.as_p(p0))
        tau = BorderedState(u=torch.zeros_like(u_conv),
                            p=kn.as_p(1.0 / np.sqrt(0.5)))
        ds = kn.as_p(1e-3)
        z_pred = BorderedState(u=tree_axpy(ds, tau.u, z.u), p=z.p + ds * tau.p)
        z_new, cv2, itn2, itl2, res2 = kn.palc_corrector(z_pred, z, tau, ds,
                                                         prob.params)
        assert cv2, f"sharded PALC corrector failed (res={res2})"
        z_b = BorderedState(u=tree_axpy(kn.as_p(1e-2), put(w_glob), u_conv),
                            p=kn.as_p(p0 + 1e-2))
        tau_s = kn.secant_tangent(z_b, z, ds)
        z_pred = BorderedState(u=tree_axpy(ds, tau_s.u, z.u),
                               p=z.p + ds * tau_s.p)
        z_sec, cv3, itn3, itl3, res3 = kn.palc_corrector(z_pred, z, tau_s,
                                                         ds, prob.params)
        _sync(device)
        assert cv3, f"sharded secant PALC corrector failed (res={res3})"

    def glob(x):
        return (x if mesh is None else
                full_state(x.reshape(2, -1), mesh, dim=1).reshape(-1)
                ).cpu().numpy()

    return {"newton_it": int(itn), "newton_gmres_it": int(itl),
            "newton_res": float(res), "palc_it": int(itn2),
            "palc_gmres_it": int(itl2), "palc_res": float(res2),
            "palc_p": float(z_new.p), "secant_it": int(itn3),
            "secant_gmres_it": int(itl3), "secant_res": float(res3),
            "secant_p": float(z_sec.p), "secant_tau_p": float(tau_s.p),
            "u_newton": glob(u_conv), "u_palc": glob(z_new.u),
            "u_secant": glob(z_sec.u), "tau_u_secant": glob(tau_s.u)}


def _sh_contpar(max_steps, eig, restart, maxiter, rtol, tol, max_it):
    return ContinuationPar(
        ds=-5e-3, dsmax=2e-2, dsmin=1e-7, p_min=-0.8, p_max=0.2,
        max_steps=max_steps, nev=4, detect_bifurcation=3, detect_fold=True,
        newton_options=NewtonPar(
            tol=tol, max_iterations=max_it,
            linsolver=GMRES(restart=restart, maxiter=maxiter, rtol=rtol),
            eigsolver=eig))


def _steps(it, n_steps: int, device) -> dict:
    """init_state + n_steps iterates; the step's numbers."""
    state = it.init_state()
    counts = [int(state.n_unstable[0])]
    for _ in range(n_steps):
        it.iterate(state)
        counts.append(int(state.n_unstable[0]))
    _sync(device)
    return {"converged": bool(state.converged), "p": float(state.p),
            "n_unstable": counts, "itnewton": int(state.itnewton),
            "itlinear": int(state.itlinear),
            "eigvals": np.asarray(state.eigvals),
            "converged_eig": bool(state.converged_eig)}


def _leg4_contpar():
    eig = ArnoldiEig(which="LR", krylov_dim=12, restarts=1, tol=1e-2,
                     compute_dtype=torch.float32)
    return _sh_contpar(1, eig, 40, 80, 1e-8, 1e-6, 8)


def _sh(mesh, device, rows, cols):
    if mesh is None:
        return swift_hohenberg_2d(Nx=rows, Ny=cols, device=device)
    return swift_hohenberg_2d_sharded(mesh, Nx=rows, Ny=cols, device=device)


def leg2_sh(mesh, device, n_ranks: int) -> dict:
    """3 continuation steps with detection on the trivial SH2d branch."""
    sh = _sh(mesh, device, 4 * n_ranks, 12)
    eig = ArnoldiEig(which="LR", krylov_dim=16, restarts=2, tol=1e-3,
                     compute_dtype=torch.float32)
    cp = _sh_contpar(3, eig, 80, 400, 1e-8, 1e-6, 12)
    it = ContIterable(sh.re_make(u0=torch.zeros_like(sh.u0)), PALC(), cp)
    with _scope(mesh):
        out = _steps(it, 3, device)
    assert out["converged"], "sharded SH2d continuation step failed"
    assert out["n_unstable"][-1] >= 0, "detection did not run"
    return out


def leg4_fields(rows: int, device, dtype=torch.float64):
    """Leg 4's u, v and scal: seeded fields on the flagship's domain."""
    rng = np.random.default_rng(3)
    u = torch.tensor(rng.standard_normal((rows, FLAGSHIP_COLS)), dtype=dtype,
                     device=device)
    v = torch.tensor(rng.standard_normal((rows, FLAGSHIP_COLS)), dtype=dtype,
                     device=device)
    hx2 = float((2 * LX / rows) ** 2)
    hy2 = float((2 * LY / FLAGSHIP_COLS) ** 2)
    scal = torch.tensor([-0.1, 1.3, 1.0 / hx2, 1.0 / hy2], dtype=dtype,
                        device=device)
    return u, v, scal


def leg4_flagship(mesh, device, rows: int = FLAGSHIP_ROWS) -> dict:
    """The halo'd J.v against the single-device one, then one continuation
    step with detection on the row-sharded trivial branch (with mesh=None:
    the step alone, on one device)."""
    if mesh is None:
        sh = swift_hohenberg_2d(Nx=rows, Ny=FLAGSHIP_COLS, device=device)
        it = ContIterable(sh.re_make(u0=torch.zeros_like(sh.u0)), PALC(),
                          _leg4_contpar())
        return _steps(it, 1, device)
    u, v, scal = leg4_fields(rows, device)
    jv_ref = sh_jv(u, v, scal)
    jv_loc = sharded_sh_jv_local(mesh, local_block(mesh, u),
                                 local_block(mesh, v), scal)
    jv_sh = full_state(jv_loc, mesh)
    err_jv = float(torch.max(torch.abs(jv_sh - jv_ref))
                   / torch.clamp_min(torch.max(torch.abs(jv_ref)), 1e-300))
    assert err_jv < 1e-10, f"halo'd SH J.v mismatch ({err_jv:.2e})"
    sh = _sh(mesh, device, rows, FLAGSHIP_COLS)
    it = ContIterable(sh.re_make(u0=torch.zeros_like(sh.u0)), PALC(),
                      _leg4_contpar())
    with use_mesh(mesh):
        out = _steps(it, 1, device)
    assert out["converged"], "flagship-resolution sharded step failed"
    out["jv_rel_err"] = err_jv
    return out


# ---------------------------------------------------------------------------
# leg 3: the time-sharded COP solve and the monodromy tree product
# ---------------------------------------------------------------------------


def _stuart_landau_cop(device, n_ranks: int):
    """Leg 3's problem: the Stuart-Landau collocation PO at
    Collocation(Ntst = 2 ranks, m = 3), its block jacobian at the guess
    and the seeded rhs."""
    prob = stuart_landau(r=0.5, mu=0.2, nu=0.5, c3=1.0, c5=0.0,
                         device=device)
    disc = Collocation(Ntst=2 * n_ranks, m=3)
    period = 2 * np.pi / abs(0.2 - 0.5 * 0.5)

    def orbit(t):
        return np.array([np.sqrt(0.5) * np.cos(-t),
                         np.sqrt(0.5) * np.sin(-t)])

    X0 = disc.generate_solution(orbit, period, 2, device=device)
    po = periodic_orbit_problem(prob, disc, X0)
    blocks = collocation_block_jacobian(disc, prob, X0, po.params)
    rhs = torch.tensor(np.random.default_rng(0).standard_normal(
        X0.shape[0]), device=device)
    return blocks, rhs


def leg3_cop(tmesh, device, n_ranks: int) -> dict:
    """The COP solve of the Stuart-Landau PO's block jacobian with its
    intervals split over the `time` ranks (`cop_solve_sharded`), and the
    monodromy from each rank's own interval maps (`sharded_monodromy`);
    with tmesh=None, `cop_solve` and `monodromy_from_maps(..., "assoc")`
    on one device."""
    blocks, rhs = _stuart_landau_cop(device, n_ranks)
    if tmesh is None:
        x = cop_solve(blocks, rhs)
        M = monodromy_from_maps(cop_interval_maps(blocks), method="assoc")
    else:
        sh = shard_blocks(blocks, tmesh, "time")
        x = cop_solve_sharded(sh, rhs)
        M = sharded_monodromy(cop_interval_maps(sh.blocks), tmesh, "time")
    _sync(device)
    return {"x": x.cpu().numpy(), "M": M.cpu().numpy()}


# ---------------------------------------------------------------------------
# leg 5: the time-sharded functional PO-MA corrector solve
# ---------------------------------------------------------------------------

ZH_OMEGA = 1.5


def zero_hopf(device) -> BifurcationProblem:
    """Leg 5's zero-Hopf normal-form ODE (x, Re z, Im z) continued in p1
    (`__graft_entry__.py`'s F_zh, in real arithmetic)."""
    def F(u, par):
        x, zr, zi = u[0], u[1], u[2]
        zz = zr * zr + zi * zi
        p2 = par["p2"]
        dx = par["p1"] + x * x - zz
        dzr = (p2 * zr - ZH_OMEGA * zi + x * (0.5 * zr - 0.3 * zi)
               - zz * (zr + 0.2 * zi))
        dzi = (p2 * zi + ZH_OMEGA * zr + x * (0.5 * zi + 0.3 * zr)
               + zz * (0.2 * zr - zi))
        return torch.stack([dx, dzr, dzi])

    dev = resolve_device(device)
    par = {k: torch.tensor(v, dtype=torch.float64, device=dev)
           for k, v in (("p1", 0.02488), ("p2", 0.012766))}
    return BifurcationProblem(F, u0=torch.zeros(3, dtype=torch.float64,
                                                device=dev),
                              params=par, lens="p1")


def leg5_borders(n_ranks: int):
    """Leg 5's complex borders a, b over the BC-operator space (Ntst m n
    collocation rows + n boundary rows), drawn from default_rng(5):
    Re a, Im a, Re b, Im b."""
    nb = 2 * n_ranks * 4 * 3 + 3
    re_a, im_a, re_b, im_b = np.random.default_rng(5).standard_normal(
        (4, nb))
    return re_a + 1j * im_a, re_b + 1j * im_b


def leg5_po_ma(tmesh, device, n_ranks: int, borders=None) -> dict:
    """The zero-Hopf PO at Collocation(Ntst = 2 ranks, m = 4) by
    `newton_po` to 1e-9, the NS kind of the functional PO-MA problem in
    p2, its jacobian at Y = [orbit; 0.02488; 0.48] with the complex
    `borders` (default `leg5_borders`), then one `POMinAugLS` solve of a
    seeded rhs with the COP blocks split over the `time` ranks
    (`POMinAugLSSharded`; one device with tmesh=None)."""
    disc = Collocation(Ntst=2 * n_ranks, m=4)
    r5 = np.sqrt(2.0) * 0.08

    def orbit(t):
        return np.array([r5 * r5, r5 * np.cos(t), r5 * np.sin(t)])

    X0 = disc.generate_solution(orbit, 2 * np.pi / ZH_OMEGA, 3,
                                device=device)
    sol, po = newton_po(zero_hopf(device), disc, X0,
                        options=NewtonPar(tol=1e-9, max_iterations=30))
    assert sol.converged, "leg 5: the zero-Hopf orbit did not converge"
    maprob, _ = _po_ma_problem_functional(po, "p2", "ns")
    a, b = leg5_borders(n_ranks) if borders is None else borders
    par = dict(po.params)
    par["_a"] = torch.tensor(a, dtype=torch.complex128, device=device)
    par["_b"] = torch.tensor(b, dtype=torch.complex128, device=device)
    Y = torch.cat([sol.u, torch.tensor([0.02488, 0.48], dtype=sol.u.dtype,
                                       device=device)])
    jac = maprob.jac(Y, par)
    rhs = torch.tensor(np.random.default_rng(9).standard_normal(
        Y.shape[0]), device=device)
    if tmesh is None:
        x = POMinAugLS()(jac, rhs)[0]
    else:
        jac = dataclasses.replace(jac, blocks=shard_blocks(jac.blocks, tmesh,
                                                           "time"))
        x = POMinAugLSSharded()(jac, rhs)[0]
    _sync(device)
    return {"x": x.cpu().numpy(), "newton_it": int(sol.itnewton),
            "u_po": sol.u.cpu().numpy()}


# ---------------------------------------------------------------------------
# leg 6: the time x space mesh
# ---------------------------------------------------------------------------


def mesh2d_shape(n_ranks: int):
    """(nt, ns) of leg 6's time x space mesh, by the JAX dry run's rule."""
    nt = 4 if n_ranks % 4 == 0 and n_ranks >= 4 else n_ranks
    return nt, max(n_ranks // nt, 1)


class _CountingSolver:
    """A block solver that records each call's iterations per row."""

    def __init__(self, ls):
        self.ls, self.iterations = ls, []

    def solve_block(self, op_block, rhs):
        X, cv, it = self.ls.solve_block(op_block, rhs)
        self.iterations.append([int(i) for i in it])
        return X, cv, it


def leg6_mesh2d(mesh2, device, nt: int, ns: int) -> dict:
    """The Brusselator's PO on 4 ns sites: the COP solve of its
    Collocation(Ntst = 2 nt, m = 3) block jacobian with the blocks placed
    on the (time, space) mesh as the JAX dry run places them
    (`place_blocks_2d`: interval rows over `time`, collocation rows over
    `space`), each rank's intervals gathered over `space` and solved over
    `time`; then the matrix-free trapezoid monodromy apply
    (`Trapeze(M = 4 nt).monodromy_operator`, FloquetQaDMF's operator,
    plain GMRES) on v split by sites over `space`, every `time` row of
    the mesh running the same apply.  mesh2=None: both on one device."""
    n_sites = 4 * ns
    n6 = 2 * n_sites
    vf = brusselator_1d(n=n_sites, device=device, batched=True)
    base = vf.u0.cpu().numpy()

    def orbit(t):
        return base + 0.05 * np.cos(t) * np.sin(
            np.pi * (np.arange(n6) + 1) / (n6 + 1))

    disc = Collocation(Ntst=2 * nt, m=3)
    X0 = disc.generate_solution(orbit, 5.0, n6, device=device)
    po = periodic_orbit_problem(vf, disc, X0)
    blocks = collocation_block_jacobian(disc, vf, X0, po.params)
    rhs = torch.tensor(np.random.default_rng(6).standard_normal(
        X0.shape[0]), device=device)
    trap = Trapeze(M=4 * nt)
    Xt = trap.generate_solution(orbit, 5.0, n6, device=device)
    v = np.random.default_rng(7).standard_normal(n6)
    ls = _CountingSolver(GMRES(restart=30, maxiter=120, rtol=1e-9))
    if mesh2 is None:
        x = cop_solve(blocks, rhs)
        pot = periodic_orbit_problem(vf, trap, Xt)
        op = trap.monodromy_operator(vf, Xt, pot.params, linsolver=ls)
        out = op(torch.tensor(v, device=device))
    else:
        sh = shard_from_2d(place_blocks_2d(blocks, mesh2), mesh2)
        x = cop_solve_sharded(sh, rhs)
        vf_sh = brusselator_1d_sharded(mesh2, n=n_sites, device=device,
                                       batched=True)

        def sites(y):
            return local_block(mesh2, y.reshape(y.shape[:-1] + (2, n_sites)),
                               "space", y.dim()).reshape(y.shape[:-1] + (-1,))

        u, T = trap.split(Xt, n6)
        Xt_loc = trap.pack(sites(u), T)
        with use_mesh(mesh2, axis="space"):
            pot = periodic_orbit_problem(vf_sh, trap, Xt_loc)
            op = trap.monodromy_operator(vf_sh, Xt_loc, pot.params,
                                         linsolver=ls)
            out_loc = op(sites(torch.tensor(v, device=device)))
        out = full_state(out_loc.reshape(2, -1), mesh2, "space",
                         dim=1).reshape(-1)
    _sync(device)
    return {"nt": nt, "ns": ns, "x": x.cpu().numpy(),
            "monodromy_apply": out.cpu().numpy(),
            "gmres_it": ls.iterations}


# ---------------------------------------------------------------------------
# leg 7: the sharded matrix-free codim-2 bordered solves
# ---------------------------------------------------------------------------


def _count_products(prob: BifurcationProblem, counts: dict):
    """`prob` with its J.v and J^T.v products counted into counts["jv"]
    and counts["jtv"]: in the MA's extended solves, each GMRES matvec is
    one product."""
    def counted(key, make):
        def outer(u, par):
            op = make(u, par)

            def inner(w):
                counts[key] += 1
                return op(w)

            return inner

        return outer

    new = dataclasses.replace(
        prob, jac_op=counted("jv", prob.jacobian_operator),
        jac_adjoint=counted("jtv", lambda u, par: (
            lambda w: prob.dFt(u, par, w))))
    for k, val in vars(prob).items():
        if k not in {f.name for f in dataclasses.fields(prob)}:
            object.__setattr__(new, k, val)
    return new


def leg7_fold_mf(mesh, device, n_ranks: int) -> dict:
    """The fold MA problem of `brusselator_1d(n = 8 ranks)` in (l, beta)
    (`fold_ma_problem_mf`) at the homogeneous state plus seeded noise and
    p1 = 0.31, borders a = b a seeded unit vector: `anchors_kernel`'s
    (v, w, sigma), its nested GMRES sigma and adjoint solves, then one
    Govaerts operator apply (`jac_op(X, par)(d)`, dp = 0.7), the draws in
    the JAX dry run's order.  With a mesh the state is split by sites over
    `space` and the model is `brusselator_1d_sharded` (closed-form
    adjoint, pairing gradient and parameter derivatives); with mesh=None
    the one-device `brusselator_1d`, whose derivatives come by AD.
    Vectors come back in the global layout [u; v (; tail)]."""
    n_sites = 8 * n_ranks
    n7 = 2 * n_sites
    vf = (brusselator_1d(n=n_sites, device=device) if mesh is None
          else brusselator_1d_sharded(mesh, n=n_sites, device=device))
    counts = {"jv": 0, "jtv": 0}
    ma = fold_ma_problem_mf(_count_products(vf, counts), vf.lens, "beta")
    rng = np.random.default_rng(11)
    u_glob = np.concatenate([np.full(n_sites, 2.0),
                             np.full(n_sites, 5.45 / 2.0)])
    x = u_glob + 0.05 * rng.standard_normal(n7)
    a = rng.standard_normal(n7)
    a = a / np.linalg.norm(a)
    dx = rng.standard_normal(n7)

    def put(y):
        return (torch.tensor(y, device=device) if mesh is None else
                state_to_mesh(y.reshape(2, -1), mesh, dim=1).reshape(-1))

    def glob(y):
        return (y if mesh is None else
                full_state(y.reshape(2, -1), mesh, dim=1).reshape(-1)
                ).cpu().numpy()

    def with_tail(head, t):
        return torch.cat([head, torch.tensor([t], dtype=head.dtype,
                                             device=head.device)])

    X, d = with_tail(put(x), 0.31), with_tail(put(dx), 0.7)
    par = {**ma.params, "_a": put(a), "_b": put(a)}
    with _scope(mesh):
        v, w, sig = ma.anchors_kernel(X, par)
        products = dict(counts)
        ap = ma.jac_op(X, par)(d)
    _sync(device)
    return {"v": glob(v), "w": glob(w), "sigma": float(sig),
            "apply": np.concatenate([glob(ap[:-1]), ap[-1:].cpu().numpy()]),
            "sigma_gmres_matvecs": products["jv"],
            "adjoint_gmres_matvecs": products["jtv"]}


# ---------------------------------------------------------------------------
# the dry run and its one-device reference
# ---------------------------------------------------------------------------


def single_device(n_ranks: int, device=None,
                  flagship_rows: int = FLAGSHIP_ROWS) -> dict:
    """The legs' work on one device with the unsharded models: what
    `dryrun_multichip(n_ranks, ...)` is compared with."""
    device = resolve_device(device)
    return {"leg1": leg1_brusselator(None, device, n_ranks),
            "leg2": leg2_sh(None, device, n_ranks),
            "leg3": leg3_cop(None, device, n_ranks),
            "leg4": leg4_flagship(None, device, flagship_rows),
            "leg5": leg5_po_ma(None, device, n_ranks),
            "leg6": leg6_mesh2d(None, device, *mesh2d_shape(n_ranks)),
            "leg7": leg7_fold_mf(None, device, n_ranks)}


def kernel_launches() -> dict:
    """The hand-written kernels' launches so far in this process: `sh_jv`
    (every closure) and `dia_spmv`."""
    return {"sh_jv": sh_ops.launch_count(), "dia_spmv": dia_spmv.launches}


def _timed(out: dict, leg: str, fn):
    """Run one leg into out[leg], with its seconds and the kernels it
    launched."""
    k0, t0 = kernel_launches(), time.perf_counter()
    out[leg] = fn()
    out["seconds"][leg] = time.perf_counter() - t0
    out["launches"][leg] = {k: n - k0[k] for k, n in kernel_launches().items()}


def _halo_launches() -> dict:
    return {f"{dt}/K={k}": n
            for (closure, dt, k), n in sh_ops.sh_jv.launches_by_case.items()
            if closure == "halo"}


def dryrun_multichip(n_ranks: int, device=None,
                     flagship_rows: int = FLAGSHIP_ROWS,
                     mesh=None) -> dict:
    """Legs 1-7 over the ranks of the initialised default group (each
    rank on `device`: the card unless "cpu"): legs 1, 2 and 4 on a
    1 x n_ranks ("branch", "space") mesh (`mesh`, or one made here), legs
    3 and 5 on a (n_ranks,) ("time",) mesh, leg 6 on the (nt, ns)
    ("time", "space") mesh of `mesh2d_shape`, leg 7 on the first mesh.
    Returns this rank's numbers (seconds per leg, the legs' results, the
    kernels each leg launched, the halo-closure launches of `sh_jv` by
    dtype and batch, the transport)."""
    device = resolve_device(device)
    if mesh is None:
        mesh = make_mesh((1, n_ranks), ("branch", "space"),
                         device=device.type)
    tmesh = make_mesh((n_ranks,), ("time",), device=device.type)
    nt, ns = mesh2d_shape(n_ranks)
    mesh2 = make_mesh((nt, ns), ("time", "space"), device=device.type)
    sh_ops.sh_jv.launches_by_case.clear()
    out = {"transport": transport(mesh), "seconds": {}, "launches": {}}
    for leg, fn in ((1, lambda: leg1_brusselator(mesh, device, n_ranks)),
                    (2, lambda: leg2_sh(mesh, device, n_ranks)),
                    (3, lambda: leg3_cop(tmesh, device, n_ranks)),
                    (4, lambda: leg4_flagship(mesh, device, flagship_rows)),
                    (5, lambda: leg5_po_ma(tmesh, device, n_ranks)),
                    (6, lambda: leg6_mesh2d(mesh2, device, nt, ns)),
                    (7, lambda: leg7_fold_mf(mesh, device, n_ranks))):
        _timed(out, f"leg{leg}", fn)
    out["halo_launches"] = _halo_launches()
    return out


def dryrun_mesh2d(nt: int, ns: int, device=None) -> dict:
    """Leg 6 alone on a (nt, ns) ("time", "space") mesh over the ranks of
    the initialised default group (nt ns of them): the 2 x 2 mesh of 4
    ranks is the shape that splits both axes.  Returns this rank's leg,
    its seconds and the kernels it launched."""
    device = resolve_device(device)
    mesh2 = make_mesh((nt, ns), ("time", "space"), device=device.type)
    out = {"transport": transport(mesh2), "seconds": {}, "launches": {}}
    _timed(out, "leg6", lambda: leg6_mesh2d(mesh2, device, nt, ns))
    return out
