"""The multi-device dry run of the port, modelled on the JAX package's
`__graft_entry__.py::dryrun_multichip`: legs 1, 2 and 4 of it, each on a
state row-partitioned over the `space` ranks, with the solver stack run
rank-locally inside `use_mesh` (`mesh.py`).

* leg 1: the tiny Brusselator (8 sites a rank), Newton from the perturbed
  homogeneous state, then one PALC corrector step (the JAX dry run's,
  its tangent's u-part zero) and one more with a secant tangent off a
  seeded direction, whose u-part is not;
* leg 2: SH2d at (4 ranks) x 12, 3 continuation steps with detection and
  the f32 Arnoldi stability sweep;
* leg 4: SH2d at the flagship's resolution, 152 x 100 (151 rows do not
  divide): the halo'd J.v against the single-device one, then one
  continuation step with detection on the row-sharded trivial branch,
  every J.v through `sharded_sh_jv`.

`dryrun_multichip(n_ranks, device)` runs inside already initialised ranks
(`launch.start_ranks("bifurcationkit.jl_tpu_torch.parallel.dryrun:"
"dryrun_multichip", n)` spawns them) and returns, on every rank, the
legs' numbers as plain Python values.  Each leg with `mesh=None` runs the
same work on one device with the unsharded models (`single_device`), to
compare against.  Legs 3 and 5-7 (the time-sharded COP and
monodromy tree product, the sharded PO-MA corrector, the 2-D mesh and the
sharded matrix-free codim-2 solves) are not ported yet.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import resolve_device
from ..interop import state_to_mesh
from ..continuation.algorithms import PALC
from ..continuation.engine import ContIterable
from ..core.params import ContinuationPar, NewtonPar
from ..core.state import BorderedState, tree_axpy
from ..linalg.eig import ArnoldiEig
from ..linalg.linear import GMRES
from ..models.equilibria import brusselator_1d
from ..models.sh import swift_hohenberg_2d
from ..ops import sh_jv as sh_ops
from ..ops.sh_jv import sh_jv
from .halo import sharded_sh_jv_local
from .mesh import full_state, local_block, make_mesh, transport, use_mesh
from .models import brusselator_1d_sharded, swift_hohenberg_2d_sharded

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


def single_device(n_ranks: int, device=None,
                  flagship_rows: int = FLAGSHIP_ROWS) -> dict:
    """The legs' work on one device with the unsharded models: what
    `dryrun_multichip(n_ranks, ...)` is compared with."""
    device = resolve_device(device)
    return {"leg1": leg1_brusselator(None, device, n_ranks),
            "leg2": leg2_sh(None, device, n_ranks),
            "leg4": leg4_flagship(None, device, flagship_rows)}


def _halo_launches() -> dict:
    return {f"{dt}/K={k}": n
            for (closure, dt, k), n in sh_ops.sh_jv.launches_by_case.items()
            if closure == "halo"}


def dryrun_multichip(n_ranks: int, device=None,
                     flagship_rows: int = FLAGSHIP_ROWS,
                     mesh=None) -> dict:
    """Legs 1, 2 and 4 on a 1 x n_ranks mesh (`mesh`, or one made here)
    over the ranks of the initialised default group (each rank on
    `device`: the card unless "cpu"); returns this rank's numbers (seconds
    per leg, Newton and GMRES iterations, the halo-closure launches of
    `sh_jv` by dtype and batch, the transport)."""
    device = resolve_device(device)
    if mesh is None:
        mesh = make_mesh((1, n_ranks), ("branch", "space"),
                         device=device.type)
    sh_ops.sh_jv.launches_by_case.clear()
    out = {"transport": transport(mesh), "seconds": {}}
    for leg, fn in ((1, lambda: leg1_brusselator(mesh, device, n_ranks)),
                    (2, lambda: leg2_sh(mesh, device, n_ranks)),
                    (4, lambda: leg4_flagship(mesh, device, flagship_rows))):
        t0 = time.perf_counter()
        out[f"leg{leg}"] = fn()
        out["seconds"][f"leg{leg}"] = time.perf_counter() - t0
    out["halo_launches"] = _halo_launches()
    return out
