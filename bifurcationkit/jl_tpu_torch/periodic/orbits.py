"""Periodic-orbit orchestration — the port of `jl_tpu/periodic/orbits.py`
(ref src/periodicorbit/PeriodicOrbits.jl).

Wraps a discretization (Trapeze / Collocation / Shooting /
PoincareShooting) into an ordinary `BifurcationProblem` over
X = [orbit dof, T], so Newton, PALC, detection, bisection and events all
apply unchanged (ref the wrapper problems PeriodicOrbitFunctional*,
src/Problems.jl:394-425).  Stability comes from the Floquet monodromy via
the engine's `eig_jacobian` hook; the phase-condition reference orbit (or
the shooting sections) is refreshed by the update hook through the
parameter dict (ref updatesection!), which `continuation()` calls after
every converged step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..continuation.algorithms import PALC
from ..continuation.driver import continuation
from ..continuation.results import Branch
from ..core.lens import Lens, as_lens
from ..core.params import ContinuationPar, NewtonPar
from ..core.problem import BifurcationProblem
from ..core.state import ravel, tree_map
from ..newton import newton
from ..normal_forms.codim1 import hopf_normal_form, hopf_predictor
from .collocation import Collocation
from .cop import COPBLS, COPLS, collocation_block_jacobian
from .floquet import FloquetColl, FloquetEig, FloquetGEV, FloquetQaDMF
from .shooting import PoincareShooting, Shooting
from .trapezoid import Trapeze


def _flat_vector_field(prob_vf):
    """The vector field on raveled states: F, `jac_op`, `jac`, d2F_user
    and d3F_user of a structured state (e.g. cGL2d's (2, Nx, Ny))
    reshaped once here.  A batched F (and its J.v and forms) stays
    batched."""
    shape = tuple(prob_vf.u0.shape)
    flat0 = prob_vf.u0.reshape(-1)
    n = flat0.shape[0]
    if len(shape) == 1:
        return prob_vf, n
    base = prob_vf

    def unflat(x):
        return x.reshape(x.shape[:-1] + shape)

    def F_flat(x, par):
        return base.F(unflat(x), par).reshape(x.shape[:-1] + (n,))

    kw = {"F": F_flat, "u0": flat0}
    if base.jac_op is not None:
        def jac_op_flat(x, par):
            op = base.jac_op(unflat(x), par)

            def jv(v):
                out = op(unflat(v))        # x's and v's batches broadcast
                return out.reshape(out.shape[:out.dim() - len(shape)] + (n,))

            return jv

        kw["jac_op"] = jac_op_flat
    def flat_out(out):
        return out.reshape(out.shape[:out.dim() - len(shape)] + (n,))

    if base.jac is not None:
        kw["jac"] = lambda x, par: base.jac(unflat(x), par)
    if base.d2F_user is not None:
        kw["d2F_user"] = lambda x, par, d1, d2: flat_out(base.d2F_user(
            unflat(x), par, unflat(d1), unflat(d2)))
    if base.d3F_user is not None:
        kw["d3F_user"] = lambda x, par, d1, d2, d3: flat_out(base.d3F_user(
            unflat(x), par, unflat(d1), unflat(d2), unflat(d3)))
    flat = base.re_make(**kw)
    if getattr(base, "batched_F", False):
        object.__setattr__(flat, "batched_F", True)
    return flat, n


def _cast_params(par, dt):
    return tree_map(lambda a: a.to(dt) if (isinstance(a, torch.Tensor)
                                           and a.is_floating_point()) else a,
                    par)


def periodic_orbit_problem(prob_vf, disc, X0, params=None, uref=None,
                           update_section_every_step: int = 1,
                           use_cop: bool = False, floquet: str = "qad",
                           floquet_linsolver=None,
                           floquet_compute_dtype=None):
    """Build the PO `BifurcationProblem` for a discretization.
    `floquet` picks what the engine's `eig_jacobian` hands the Floquet
    solver: "qad" the dense monodromy, "qad_mf" the matrix-free operator
    (solved with `floquet_linsolver`, at `floquet_compute_dtype` if
    given), "coll" the COP blocks (`FloquetColl`), "gev" the interval maps
    (`FloquetGEV`).  `use_cop=True` makes the jacobian the structured
    `COPBlocks` (for `COPLS` / `COPBLS`)."""
    params = prob_vf.params if params is None else params
    prob_vf, n = _flat_vector_field(prob_vf)
    expected = disc.unknown_size(n)
    if X0.shape[0] != expected:
        raise ValueError(
            f"orbit guess has {X0.shape[0]} unknowns but {type(disc).__name__}"
            f" over a {n}-dim vector field needs {expected} "
            f"(orbit dof + period)")

    po_par = {"_inner": params}
    if isinstance(disc, Collocation):
        mesh = torch.as_tensor(np.linspace(0, 1, disc.Ntst + 1),
                               dtype=X0.dtype, device=X0.device)
        nodes, _ = disc.split(X0, n)
        nodes_ref = nodes if uref is None else uref
        _, phi = disc.phase_data(prob_vf, nodes_ref, params, mesh)
        po_par.update({"_uref": nodes_ref, "_phi": phi, "_mesh": mesh})
    elif isinstance(disc, Trapeze):
        u, _ = disc.split(X0, n)
        u_ref = u if uref is None else uref
        _, phi = disc.phase_data(prob_vf, u_ref, params)
        po_par.update({"_uref": u_ref, "_phi": phi})
    elif isinstance(disc, (Shooting, PoincareShooting)):
        po_par.update(disc.section_data(prob_vf, X0, params))
    else:
        raise TypeError(f"unknown discretization {type(disc)}")

    inner_lens = as_lens(prob_vf.lens)
    lens = Lens(
        get=lambda par: inner_lens.get(par["_inner"]),
        set=lambda par, v: {**par,
                            "_inner": inner_lens.set(par["_inner"], v)},
        name=f"po/{inner_lens.name}")

    def F_po(X, par):
        return disc.residual(prob_vf, X, par)

    is_poincare = isinstance(disc, PoincareShooting)
    is_poincare_ev = is_poincare and disc.event_driven
    # event-driven Poincare shooting: the period comes out of the crossing
    # integration (refreshed by the update hook), not from the unknowns
    period_cell = {"T": float(torch.sum(po_par["_thint"]))
                   if is_poincare_ev else None}

    def record(X, p, **k):
        T = period_cell["T"] if is_poincare_ev else disc.period(X)
        dof = X if is_poincare else X[:-1]
        out = {"param": p, "period": T,
               "norm": torch.linalg.vector_norm(dof) / np.sqrt(dof.shape[0])}
        if not is_poincare:
            traj = dof.reshape(-1, n)
            out.update({"amplitude": torch.max(traj[:, 0])
                        - torch.min(traj[:, 0]),
                        "max": torch.max(traj[:, 0]),
                        "min": torch.min(traj[:, 0])})
        return out

    def update(it, state):
        """Refresh the phase-condition reference (or the sections) to the
        current orbit (ref updatesection!), with the current parameter
        value set; collocation adapts its mesh here when asked (ref
        PeriodicOrbitCollocation.jl:1235-1400)."""
        if update_section_every_step <= 0 or \
                state.step % update_section_every_step != 0:
            return None
        par = it.prob.set_lens_param(it.current_params, float(state.p))
        X = state.z.u
        new = dict(par)
        if isinstance(disc, Collocation):
            nodes, T = disc.split(X, n)
            mesh_now = par["_mesh"]
            if disc.adapt_mesh:
                nodes, mesh_now = disc.adapt(nodes, mesh_now)
                new["_mesh"] = mesh_now
                state.z = dataclasses.replace(state.z,
                                              u=disc.pack(nodes, T))
            _, phi = disc.phase_data(prob_vf, nodes, par["_inner"],
                                     mesh_now)
            new.update({"_uref": nodes, "_phi": phi})
        elif isinstance(disc, Trapeze):
            u_now, _ = disc.split(X, n)
            _, phi = disc.phase_data(prob_vf, u_now, par["_inner"])
            new.update({"_uref": u_now, "_phi": phi})
        elif is_poincare_ev:
            new.update(disc.section_data(prob_vf, X, par["_inner"],
                                         po_par=par))
            period_cell["T"] = float(torch.sum(new["_thint"]))
        else:
            new.update(disc.section_data(prob_vf, X, par["_inner"]))
        return new


    if floquet in ("coll", "gev") and not isinstance(disc, Collocation):
        raise ValueError(f"floquet='{floquet}' requires Collocation")
    if floquet == "gev":
        def eig_jacobian(X, par):
            return disc.interval_maps(prob_vf, X, par)
    elif floquet == "coll":
        # COP-reusing FloquetColl (ref Floquet.jl:533-760): the stability
        # solve consumes the same structured blocks as the Newton solve
        def eig_jacobian(X, par):
            return collocation_block_jacobian(disc, prob_vf, X, par)
    elif floquet == "qad_mf":
        if not hasattr(disc, "monodromy_operator"):
            raise ValueError(
                "floquet='qad_mf' needs a discretization with a "
                "monodromy_operator (Shooting or Trapeze)")

        def eig_jacobian(X, par):
            if floquet_compute_dtype is not None:
                X = X.to(floquet_compute_dtype)
                par = _cast_params(par, floquet_compute_dtype)
            return disc.monodromy_operator(prob_vf, X, par,
                                           linsolver=floquet_linsolver)
    else:
        def eig_jacobian(X, par):
            return disc.monodromy(prob_vf, X, par)

    # closed-form PO jacobians: the trapezoid's operator from a batched
    # model's J.v; the shooting methods' from the variational flow, dense
    # as the operator on the identity's columns (one pass of the flow);
    # the COP blocks; other problems take the jvp of the residual
    jac = jac_op = None
    if use_cop:
        if not isinstance(disc, Collocation):
            raise ValueError("use_cop requires a Collocation discretization")

        def jac(X, par):
            return collocation_block_jacobian(disc, prob_vf, X, par)
    elif isinstance(disc, (Shooting, PoincareShooting)) \
            and disc._flow(prob_vf).variational:
        def jac_op(X, par):
            return disc.jacobian_operator(prob_vf, X, par)

        def jac(X, par):
            eye = torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
            return jac_op(X, par)(eye).T
    if isinstance(disc, Trapeze) and prob_vf.jac_op is not None \
            and getattr(prob_vf, "batched_F", False):
        def jac_op(X, par):
            return disc.jacobian_operator(prob_vf, X, par)

    po_prob = BifurcationProblem(F_po, u0=X0, params=po_par, lens=lens,
                                 jac=jac, jac_op=jac_op,
                                 record_from_solution=record, update=update)
    object.__setattr__(po_prob, "eig_jacobian", eig_jacobian)
    # structured-jacobian Floquet solvers (COP blocks / interval maps):
    # the blocks and the eigensolve run as two stages, FloquetColl's
    # eigensolve on the host
    object.__setattr__(po_prob, "eig_two_stage", floquet in ("coll", "gev"))
    object.__setattr__(po_prob, "disc", disc)
    object.__setattr__(po_prob, "prob_vf", prob_vf)
    object.__setattr__(po_prob, "n_vf", n)
    # the Floquet spectrum has at most n_vf entries: cap the engine's nev
    # auto-raise there
    object.__setattr__(po_prob, "eig_max_nev", n)
    return po_prob


def _po_contparams(cp: ContinuationPar) -> ContinuationPar:
    """PO defaults: a Floquet eigensolver and a looser stability tolerance
    (the trivial multiplier sits at exponent 0).  A user-chosen Floquet
    solver is kept; only a non-Floquet eigensolver is replaced."""
    nopts = cp.newton_options
    if not getattr(nopts.eigsolver, "is_floquet", False):
        nopts = nopts.replace(eigsolver=FloquetEig())
    return cp.replace(newton_options=nopts,
                      tol_stability=max(cp.tol_stability, 1e-6))


def newton_po(prob_vf, disc, X0, params=None,
              options: Optional[NewtonPar] = None, **kwargs):
    """Newton solve of a periodic orbit guess (ref newton entry,
    PeriodicOrbits.jl:310).  Returns (solution, PO problem)."""
    options = options or NewtonPar()
    po_prob = periodic_orbit_problem(prob_vf, disc, X0, params=params)
    return newton(po_prob, options, **kwargs), po_prob


def _floquet_mode(contparams: ContinuationPar, floquet=None) -> str:
    """The `eig_jacobian` flavor matching the configured Floquet solver
    (FloquetColl wants the COP blocks, FloquetGEV the interval maps)."""
    if floquet is not None:
        return floquet
    eig = contparams.newton_options.eigsolver
    for cls, mode in ((FloquetColl, "coll"), (FloquetGEV, "gev"),
                      (FloquetQaDMF, "qad_mf")):
        if isinstance(eig, cls):
            return mode
    return "qad"


def _cop_solvers(cp: ContinuationPar, alg, use_cop: bool):
    """With `use_cop`, Newton solves with COPLS and PALC's bordered solves
    ride the single-pass condensation (ref COPBLS, cop.jl:107): one
    stage 1 per corrector iteration, not two."""
    if use_cop:
        nopts = cp.newton_options
        if not isinstance(nopts.linsolver, COPLS):
            cp = cp.replace(newton_options=nopts.replace(linsolver=COPLS()))
        if isinstance(alg, PALC) and alg.bls is None:
            alg = dataclasses.replace(alg, bls=COPBLS())
    return cp, alg


def continuation_po(prob_vf, disc, X0, contparams: ContinuationPar,
                    alg=None, params=None, use_cop: bool = False,
                    floquet=None, floquet_linsolver=None,
                    floquet_compute_dtype=None, **kwargs) -> Branch:
    """Continue a periodic orbit in the vector field's lens parameter."""
    po_prob = periodic_orbit_problem(
        prob_vf, disc, X0, params=params, use_cop=use_cop,
        floquet=_floquet_mode(contparams, floquet),
        floquet_linsolver=floquet_linsolver,
        floquet_compute_dtype=floquet_compute_dtype)
    cp, alg = _cop_solvers(_po_contparams(contparams), alg or PALC(),
                           use_cop)
    gamma = continuation(po_prob, alg, cp, kind="PeriodicOrbitCont",
                         **kwargs)
    return Branch(gamma=gamma, bp=None)


def continuation_hopf_po(br, ind_hopf: int, contparams: ContinuationPar,
                         disc=None, alg=None, delta_p: float = None,
                         ampfactor: float = 1.0, use_cop: bool = False,
                         nf_kwargs: Optional[dict] = None,
                         floquet_linsolver=None,
                         floquet_compute_dtype=None,
                         **kwargs) -> Branch:
    """Automatic branch switching Hopf -> periodic orbits (ref
    continuation(br, ind_hopf, contparams, disc),
    PeriodicOrbits.jl:395-624): the normal-form predictor seeds the orbit
    guess; the discretization defaults to `Collocation(Ntst=20, m=4)`.
    `nf_kwargs={"matrix_free": True}` computes the seeding Hopf normal
    form without materializing the jacobian."""
    disc = disc or Collocation(Ntst=20, m=4)
    prob_vf = br.prob
    hp = hopf_normal_form(prob_vf, br, ind_hopf, **(nf_kwargs or {}))
    return _continuation_hopf_pred(
        prob_vf, hp, contparams, disc, alg=alg, delta_p=delta_p,
        ampfactor=ampfactor, use_cop=use_cop,
        floquet_linsolver=floquet_linsolver,
        floquet_compute_dtype=floquet_compute_dtype, **kwargs)


def _continuation_hopf_pred(prob_vf, hp, contparams, disc, alg=None,
                            delta_p=None, ampfactor=1.0, use_cop=False,
                            floquet_linsolver=None,
                            floquet_compute_dtype=None, **kwargs) -> Branch:
    """The common Hopf-normal-form -> PO-branch tail (ref
    _continuation(hopfpt, ...), PeriodicOrbits.jl:395-530)."""
    ds = delta_p if delta_p is not None else contparams.ds
    pred = hopf_predictor(hp, ds, ampfactor=ampfactor)
    n = hp.x0.shape[0]
    X0 = disc.generate_solution(pred["orbit"], float(pred["period"]), n,
                                dtype=hp.x0.dtype)
    params_new = prob_vf.set_lens_param(prob_vf.params, float(pred["p"]))
    po_prob = periodic_orbit_problem(
        prob_vf, disc, X0, params=params_new, use_cop=use_cop,
        floquet=_floquet_mode(contparams),
        floquet_linsolver=floquet_linsolver,
        floquet_compute_dtype=floquet_compute_dtype)
    cp, alg = _cop_solvers(_po_contparams(contparams), alg or PALC(),
                           use_cop)
    gamma = continuation(po_prob, alg, cp, kind="PeriodicOrbitCont",
                         **kwargs)
    return Branch(gamma=gamma, bp=hp)


def continuation_from_hopf_point(br_hopf, ind_pt: int,
                                 contparams: ContinuationPar, disc=None,
                                 alg=None, lens=None, delta_p: float = None,
                                 ampfactor: float = 1.0,
                                 use_cop: bool = False,
                                 nf_kwargs: Optional[dict] = None,
                                 **kwargs) -> Branch:
    """Branch switching from a point on a codim-2 Hopf curve to the
    periodic orbits emanating from it (ref continuation_from_hopf_point,
    src/periodicorbit/PeriodicOrbits.jl:530-601).  `br_hopf` comes from
    `continuation_hopf` run with `save_sol_every_step=1`; `ind_pt` indexes
    its saved solutions; `lens` is the PO continuation's parameter
    (default: the curve's second parameter, as the reference); the
    discretization defaults to `Collocation(Ntst=20, m=4)`."""
    from ..normal_forms.codim1 import hopf_normal_form_point

    gamma = br_hopf.gamma if isinstance(br_hopf, Branch) else br_hopf
    maprob = gamma.prob
    if getattr(maprob, "ma_kind", None) != "hopf":
        raise ValueError("br_hopf must be a codim-2 Hopf curve "
                         "(continuation_hopf result)")
    if not gamma.sol:
        raise ValueError("the Hopf curve stored no solutions; rerun "
                         "continuation_hopf with save_sol_every_step=1")
    prob_vf = maprob.inner_prob
    n = maprob.n_inner
    sol = gamma.sol[ind_pt]
    X = ravel(sol["x"])[0]
    p2 = float(sol["p"])
    x, p1, omega = X[:n], float(X[n]), float(X[n + 1])

    params = maprob.outer_lens.set(prob_vf.params, p2)
    params = maprob.inner_lens.set(params, p1)
    lens = lens if lens is not None else maprob.outer_lens
    prob_pt = prob_vf.re_make(u0=maprob.unravel_inner(x), params=params,
                              lens=lens)
    p0 = float(prob_pt.get_lens_param(params))
    nf_kwargs = dict(nf_kwargs or {})
    if getattr(maprob, "ma_mf", False):
        # a matrix-free Hopf curve never built a jacobian — neither does
        # its normal form, which takes the curve's preconditioner
        nf_kwargs.setdefault("matrix_free", True)
        nf_kwargs.setdefault("precond", maprob.precond)
    hp = hopf_normal_form_point(prob_pt, prob_pt.u0, p0, abs(omega),
                                **nf_kwargs)
    return _continuation_hopf_pred(prob_pt, hp, contparams,
                                   disc or Collocation(Ntst=20, m=4),
                                   alg=alg, delta_p=delta_p,
                                   ampfactor=ampfactor, use_cop=use_cop,
                                   **kwargs)


def get_periodic_orbit(br_po, idx: int = -1):
    """Reference-named accessor (ref get_periodic_orbit): a dict with the
    orbit samples, times, period and parameter (numpy)."""
    traj, T, p = orbit_from_branch(br_po, idx)
    return {"t": np.linspace(0.0, T, traj.shape[0]), "u": traj,
            "period": T, "p": p}


def orbit_from_branch(br_po, idx: int = -1):
    """(trajectory (npts, n), period, param) of a saved solution, numpy."""
    gamma = br_po.gamma if isinstance(br_po, Branch) else br_po
    sol = gamma.sol[idx]
    X = sol["x"].detach().cpu().numpy()
    return X[:-1].reshape(-1, gamma.prob.n_vf), float(X[-1]), float(sol["p"])
