"""Continuation engine — the port of `jl_tpu/continuation/engine.py`
(ref src/Continuation.jl).

Device-resident state (`BorderedState` z, tangent tau) advanced by the
step kernels, with a thin host loop doing step-size control, detection,
bisection and recording on scalars.  The state never crosses to the host
unless solutions are saved by the caller's hooks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .. import check_tf32_off
from ..core.params import ContinuationPar
from ..core.state import BorderedState, ravel, tree_axpy, tree_norm
from .algorithms import PALC, AutoSwitch, MoorePenrose, Multiple, Natural
from .kernels import make_kernels
from .results import ContResult
from .tangents import Bordered, Polynomial, Secant


@dataclasses.dataclass
class ContState:
    """Host orchestration state (ref `ContState`, src/Continuation.jl:140).
    z/tau are device tensors; scalars live on the host for control flow."""

    z: BorderedState = None          # last converged point
    z_old: BorderedState = None      # previous converged point
    tau: BorderedState = None        # unit tangent (theta-norm)
    ds: float = 0.01
    step: int = 0
    converged: bool = True
    itnewton: int = 0
    itlinear: int = 0
    res: float = 0.0
    eigvals: Optional[np.ndarray] = None
    eigvecs: Any = None
    converged_eig: bool = True
    n_unstable: Tuple[int, int] = (-1, -1)   # (current, previous)
    n_imag: Tuple[int, int] = (-1, -1)
    stopcontinuation: bool = False
    stepsizecontrol: bool = True
    in_bisection: bool = False
    event_values: Optional[tuple] = None     # (current, previous)
    eig_seed: Any = None                     # eigensolver warm start (device)

    def copy(self) -> "ContState":
        return dataclasses.replace(self)

    # each read is a device -> host transfer of one scalar
    @property
    def p(self) -> float:
        return float(self.z.p)

    @property
    def p_old(self) -> float:
        return float(self.z_old.p)

    @property
    def tau_p(self) -> float:
        return float(self.tau.p)


class ContIterable:
    """Everything needed to run one continuation (ref src/Continuation.jl:27)."""

    def __init__(self, prob, alg, contparams: ContinuationPar,
                 norm: Callable = tree_norm,
                 finalise_solution: Optional[Callable] = None,
                 callback_newton: Optional[Callable] = None,
                 event=None,
                 verbosity: int = 0,
                 kind: str = "EquilibriumCont"):
        check_tf32_off()
        self.prob = prob
        self.alg = alg
        self.base_alg = (alg.alg if isinstance(alg, (AutoSwitch, Multiple))
                         else alg)
        self.contparams = contparams
        self.norm = norm
        self.finalise_solution = finalise_solution
        self.callback_newton = callback_newton
        self.event = event
        self.verbosity = verbosity
        self.kind = kind
        self.kernels = make_kernels(prob, self.base_alg, contparams, norm,
                                    callback=callback_newton)
        self._kernels_by_nev = {self.kernels.nev: self.kernels}
        # Polynomial tangent: arclengths and the (k, N+1) point buffer
        self._poly_s = []
        self._poly_rows = []
        # current (possibly updated along the branch) parameters; the
        # problem's update hook may replace them (ref update_problem!,
        # src/Continuation.jl:251)
        self.current_params = prob.params

    # ------------------------------------------------------------------
    # initialization: two Newton solves + secant tangent
    # (ref iterate(it) first point, src/Continuation.jl:349-446)
    # ------------------------------------------------------------------
    def init_state(self, x0=None, params=None) -> ContState:
        cp = self.contparams
        kn = self.kernels
        if params is not None:
            self.current_params = params
        params = self.current_params
        x0 = self.prob.u0 if x0 is None else x0
        p0 = float(self.prob.get_lens_param(params))
        ds = cp.ds

        u0, cv0, it0, _, res0 = kn.newton_fixed(x0, kn.as_p(p0), params)
        if not cv0:
            raise RuntimeError(
                f"Newton failed to converge on the initial guess at p = {p0} "
                f"(residual {res0:.3e})")

        # second point at p0 + ds / eta for the secant tangent
        p1 = p0 + ds / cp.eta
        u1, cv1, _, _, _ = kn.newton_fixed(u0, kn.as_p(p1), params)
        if not cv1:
            raise RuntimeError(f"Newton failed on the second point at p = {p1}")

        z0 = BorderedState(u=u0, p=kn.as_p(p0))
        z1 = BorderedState(u=u1, p=kn.as_p(p1))
        tau = kn.secant_tangent(z1, z0, ds)
        state = ContState(z=z0, z_old=z0, tau=tau, ds=ds, step=0,
                          converged=True, itnewton=it0, res=res0)
        if cp.compute_eigenelements:
            self.compute_eig(state)
            state.n_unstable = (state.n_unstable[0], state.n_unstable[0])
            state.n_imag = (state.n_imag[0], state.n_imag[0])
        return state

    # ------------------------------------------------------------------
    # eigen-elements + stability counters (ref is_stable, Bifurcations.jl:5)
    # ------------------------------------------------------------------
    def compute_eig(self, state: ContState):
        vals, vecs, cv, seed = self.kernels.eig(state.z.u, state.z.p,
                                                self._params(),
                                                state.eig_seed)
        state.eig_seed = seed
        self._set_eig(state, vals, vecs, cv)

    def _set_eig(self, state: ContState, vals: np.ndarray, vecs, cv: bool):
        tol = self.contparams.tol_stability
        state.eigvals = vals
        state.eigvecs = vecs
        state.converged_eig = cv
        counted = vals
        if getattr(self.prob, "eig_tracked_zero", False):
            # a fold curve's own zero eigenvalue has a roundoff sign: leave
            # the smallest-|lambda| near-real one out of the counts, or its
            # flips read as real crossings (spurious bp -> bt labels)
            realish = np.where(np.abs(vals.imag) <= tol)[0]
            if len(realish):
                drop = realish[np.argmin(np.abs(vals[realish]))]
                counted = np.delete(vals, drop)
        state.n_unstable = (int(np.sum(counted.real > tol)),
                            state.n_unstable[0])
        state.n_imag = (int(np.sum((np.abs(counted.imag) > tol)
                                   & (counted.real > tol))), state.n_imag[0])
        self._maybe_raise_nev(state)

    def _maybe_raise_nev(self, state: ContState):
        """Grow the eigensolve window to n_unstable + 5 (ref the nev
        auto-raise in compute_eigenvalues!, src/Utils.jl:67-105); kernels
        are memoized per nev, rounded up to a multiple of 4."""
        kn = self.kernels
        need = state.n_unstable[0] + 5
        # problems whose spectrum lives on a smaller space (a Floquet
        # monodromy acts on the vector field's n_vf dof) cap the raise
        # there with `eig_max_nev`, so it never asks for a useless rebuild
        cap = min(kn.n_state, getattr(self.prob, "eig_max_nev", kn.n_state))
        if need <= kn.nev or kn.nev >= cap:
            return
        new_nev = min(int(-(-need // 4) * 4), cap)
        if new_nev not in self._kernels_by_nev:
            self._kernels_by_nev[new_nev] = make_kernels(
                self.prob, self.base_alg, self.contparams, self.norm,
                callback=self.callback_newton, nev=new_nev)
        self.kernels = self._kernels_by_nev[new_nev]

    def _params(self):
        return self.current_params

    # ------------------------------------------------------------------
    # one continuation step (ref iterate(it, state), src/Continuation.jl:458)
    # ------------------------------------------------------------------
    def iterate(self, state: ContState):
        cp = self.contparams
        kn = self.kernels
        ds = state.ds
        tau_p = state.tau_p
        p_pred = state.p + ds * tau_p

        use_natural = isinstance(self.alg, Natural)
        if isinstance(self.alg, AutoSwitch):
            # AutoSwitch: shallow branch (param-dominated tangent) -> Natural,
            # steep (fold-approaching, |tau_p| small) -> PALC
            # (ref corrector! dispatch, src/continuation/AutoSwitch.jl:58-74)
            use_natural = ((1.0 - kn.theta) * abs(tau_p) > self.alg.tol_param
                           and not state.in_bisection)

        if use_natural:
            p_new = float(np.clip(state.p + ds, cp.p_min, cp.p_max))
            u_new, cv, itn, itl, res = kn.newton_fixed(
                state.z.u, kn.as_p(p_new), self._params())
            z_new = BorderedState(u=u_new, p=kn.as_p(p_new))
        elif p_pred <= cp.p_min or p_pred >= cp.p_max:
            # PALC falls back to Natural at the parameter-domain boundary
            # (ref corrector! dispatch, src/continuation/Palc.jl:157-166)
            p_clamped = float(np.clip(p_pred, cp.p_min, cp.p_max))
            u_pred = tree_axpy(ds, state.tau.u, state.z.u)
            u_new, cv, itn, itl, res = kn.newton_fixed(
                u_pred, kn.as_p(p_clamped), self._params())
            z_new = BorderedState(u=u_new, p=kn.as_p(p_clamped))
        elif isinstance(self.base_alg, MoorePenrose):
            z_pred = BorderedState(u=tree_axpy(ds, state.tau.u, state.z.u),
                                   p=state.z.p + ds * state.tau.p)
            z_new, tau_new, cv, itn, itl, res = kn.mp_corrector(
                z_pred, state.z, state.tau, ds, self._params())
            if cv:
                state.tau = tau_new
        elif isinstance(self.alg, Multiple):
            # pmcont: try predictors at i*ds for i = nb..1, accept the first
            # converged corrector (ref src/continuation/Multiple.jl:54-67);
            # far predictors (i > 1) must show residual decay by factor
            # alpha each Newton iteration or be abandoned early
            for i in range(self.alg.nb, 0, -1):
                dsi = ds * i
                z_pred = BorderedState(
                    u=tree_axpy(dsi, state.tau.u, state.z.u),
                    p=state.z.p + dsi * state.tau.p)
                decay = self.alg.alpha if i > 1 else np.inf
                z_new, cv, itn, itl, res = kn.palc_corrector(
                    z_pred, state.z, state.tau, dsi, self._params(), decay)
                if cv:
                    break
        elif self._can_fuse():
            # predictor + corrector + secant tangent + eig in one kernel call
            (z_new, tau_new, cv, itn, itl, res, vals, vecs,
             cv_eig, eig_seed) = kn.palc_step(state.z, state.tau, ds,
                                              self._params(), state.eig_seed)
            state.converged, state.itnewton = cv, itn
            state.itlinear, state.res = itl, res
            # a failed step eigensolved the old point: its seed is kept, its
            # spectrum (unchanged) is not recorded again
            state.eig_seed = eig_seed
            if cv:
                state.z_old = state.z
                state.z = z_new
                state.tau = tau_new
                if cp.compute_eigenelements:
                    self._set_eig(state, vals, vecs, cv_eig)
            if state.stepsizecontrol:
                self.step_size_control(state)
            state.step += 1
            return state
        else:
            z_new, cv, itn, itl, res = kn.palc_corrector(
                self._palc_predictor(state, ds), state.z, state.tau, ds,
                self._params())

        state.converged, state.itnewton = cv, itn
        state.itlinear, state.res = itl, res
        if cv:
            state.z_old = state.z
            state.z = z_new
            self._poly_push(state)
            if cp.compute_eigenelements:
                self.compute_eig(state)
        if state.stepsizecontrol:
            self.step_size_control(state)
        self.update_predictor(state)
        state.step += 1
        return state

    def _can_fuse(self) -> bool:
        """The fused step applies for plain PALC with the Secant tangent,
        unless the problem opts out: `fuse_step = False` (the matrix-free
        minimally augmented problems, whose failed steps do not eigensolve
        the old point, as in the JAX package) or `eig_two_stage = True`
        (structured-jacobian Floquet solvers, whose eigensolve the JAX
        package keeps out of the fused step)."""
        return (isinstance(self.alg, PALC)
                and isinstance(getattr(self.alg, "tangent", None), Secant)
                and not getattr(self.prob, "eig_two_stage", False)
                and getattr(self.prob, "fuse_step", True))

    # ------------------------------------------------------------------
    # predictors
    # ------------------------------------------------------------------
    def _palc_predictor(self, state: ContState, ds: float) -> BorderedState:
        """Tangent predictor z + ds*tau, or polynomial extrapolation in
        arclength when enough points are buffered (ref Polynomial,
        src/continuation/Tangents.jl:126-233).  The point buffer and the
        least-squares fit stay on the device."""
        tangent = getattr(self.alg, "tangent", None)
        if isinstance(tangent, Polynomial) and not state.in_bisection \
                and len(self._poly_s) >= max(tangent.n + 2, 4):
            ss = np.asarray(self._poly_s)
            s0, sc = ss.mean(), max(ss.std(), 1e-12)
            Z = torch.stack(self._poly_rows)                   # (k, N+1)
            powers = torch.arange(tangent.n + 1, dtype=Z.dtype,
                                  device=Z.device)
            t = torch.as_tensor((ss - s0) / sc, dtype=Z.dtype,
                                device=Z.device)
            t_new = torch.as_tensor((ss[-1] + ds - s0) / sc, dtype=Z.dtype,
                                    device=Z.device)
            # masked Vandermonde least squares, (k, n+1)
            A = t[:, None] ** powers[None, :]
            G = A.T @ A + 1e-12 * torch.eye(tangent.n + 1, dtype=Z.dtype,
                                            device=Z.device)
            coef = torch.linalg.solve(G, A.T @ Z)               # (n+1, N+1)
            z_flat = (t_new ** powers) @ coef
            _, unravel = ravel(state.z.u)
            return BorderedState(u=unravel(z_flat[:-1]), p=z_flat[-1])
        return BorderedState(u=tree_axpy(ds, state.tau.u, state.z.u),
                             p=state.z.p + ds * state.tau.p)

    def _poly_push(self, state: ContState):
        tangent = getattr(self.alg, "tangent", None)
        if not isinstance(tangent, Polynomial) or state.in_bisection:
            return
        s_prev = self._poly_s[-1] if self._poly_s else 0.0
        flat, _ = ravel(state.z.u)
        self._poly_rows.append(torch.cat([flat, state.z.p.reshape(1)]))
        self._poly_s.append(s_prev + abs(state.ds))
        if len(self._poly_rows) > tangent.k:
            self._poly_rows.pop(0)
            self._poly_s.pop(0)

    # ------------------------------------------------------------------
    # step-size control (ref _step_size_control!, Contbase.jl:77-160)
    # ------------------------------------------------------------------
    def step_size_control(self, state: ContState):
        cp = self.contparams
        ds = state.ds
        if not state.converged:
            if abs(ds) <= cp.dsmin:
                state.stopcontinuation = True
                if self.verbosity > 0:
                    print(f"!! Newton failed at dsmin — stopping at step "
                          f"{state.step}")
                return
            dsnew = np.sign(ds) * max(abs(ds) / 2, cp.dsmin)
        else:
            nmax = cp.newton_options.max_iterations
            factor = (nmax - state.itnewton) / nmax
            dsnew = ds * (1 + cp.a * factor ** 2)
        state.ds = float(np.sign(dsnew) *
                         np.clip(abs(dsnew), cp.dsmin, cp.dsmax))
        state.stopcontinuation = False

    # ------------------------------------------------------------------
    # predictor / tangent update (ref getpredictor!, Palc.jl:125)
    # ------------------------------------------------------------------
    def update_predictor(self, state: ContState):
        tangent = getattr(self.alg, "tangent", Secant())
        if isinstance(self.base_alg, MoorePenrose):
            return  # tangent updated inside the corrector
        if isinstance(tangent, Bordered) and state.converged:
            state.tau = self.kernels.bordered_tangent(
                state.z, state.tau, self._params())
        elif state.z is not state.z_old:
            state.tau = self.kernels.secant_tangent(state.z, state.z_old,
                                                    state.ds)

    # ------------------------------------------------------------------
    # recording (ref save!/get_state_summary, src/Continuation.jl:259-305)
    # ------------------------------------------------------------------
    def record(self, state: ContState) -> dict:
        rec = self.prob.record_from_solution(state.z.u, state.p)
        if not isinstance(rec, dict):
            rec = {"record": rec}
        rec = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v)) for k, v in rec.items()}
        rec.update({
            "param": state.p,
            "itnewton": state.itnewton,
            "itlinear": state.itlinear,
            "ds": state.ds,
            "n_unstable": state.n_unstable[0],
            "n_imag": state.n_imag[0],
            "stable": state.n_unstable[0] == 0,
            "step": state.step,
        })
        return rec

    def save(self, res: ContResult, state: ContState):
        cp = self.contparams
        res.append(self.record(state))
        if cp.compute_eigenelements and state.eigvals is not None and \
                state.step % cp.save_eig_every_step == 0:
            res.eig.append({
                "eigenvals": state.eigvals.copy(),
                "eigenvecs": (state.eigvecs.detach().cpu().numpy()
                              if (cp.save_eigenvectors and
                                  state.eigvecs is not None) else None),
                "step": state.step,
                "converged": state.converged_eig,
            })
        if cp.save_sol_every_step > 0 and \
                state.step % cp.save_sol_every_step == 0:
            x = state.z.u
            if self.prob.save_solution is not None:
                par = self.prob.set_lens_param(self._params(), state.z.p)
                x = self.prob.save_solution(x, par)
            res.sol.append({"x": x, "p": state.p, "step": state.step})

    # ------------------------------------------------------------------
    def done(self, state: ContState) -> bool:
        cp = self.contparams
        if state.stopcontinuation:
            return True
        if state.step >= cp.max_steps:
            return True
        # stalled at a parameter bound: previous and current point both
        # clamped to the same boundary value
        if state.step > 1 and state.converged:
            for bound in (cp.p_min, cp.p_max):
                if (abs(state.p - bound) < 1e-13 and
                        abs(state.p_old - bound) < 1e-13):
                    return True
        return False
