"""Matrix-free minimally augmented codim-2 continuation — the port of
`jl_tpu/codim2/minaug_mf.py` (ref src/codim2/MinAugFold.jl:15-208,
MinAugHopf.jl:19-212): the PDE-scale route of the fold curve of the
151x100 SH2d model (ref examples/SH2d-fronts.jl:97-115) and of Hopf
curves, nothing materialised.

* A bordered system [J col; row^T 0][v; s] = [t; b] is solved by GMRES on
  the extended flat operator, which stays nonsingular where J itself is
  singular; the inner spectral preconditioner extends blockwise, identity
  on the scalar slots.  The complex-shifted systems of the Hopf route run
  in the real 2n + 2 embedding.
* The MA corrector jacobian is the Govaerts operator

      J_G [dx; dp1] = [J dx + F_p1 dp1; sigma_x . dx + sigma_p1 dp1],
      sigma_x = -grad_x <w, J(x) v>,

  applied with one J.v per product, so PALC's bordered solves run GMRES
  on J_G.
* Every plain product J.v goes through the model's `jac_op` (on the card
  a hand-written kernel).  The second derivatives (sigma_x, sigma_p1,
  d sigma / d p2 and the Hopf counterparts) are taken from F itself: a
  vjp or jvp of a jvp of F.  A kernel computes values only and carries
  no derivative.  The fold route takes the model's closed forms where it
  gives them (`jac_adjoint`, `grad_pairing`, `param_derivs`), as a
  row-partitioned model must (`parallel/models.py`): no AD crosses a halo
  exchange.
* On a row-partitioned state (inside `parallel.use_mesh`) the fold route
  completes its border dots and norms over the ranks, and its GMRES
  counts the extended vector's scalar tail once (`GMRES.n_rep`).
* Border re-anchoring, the BT/cusp/ZH and BT/GH test functions and the
  per-step inner spectrum (`eig_jacobian`, an operator for the iterative
  eigensolvers) reuse the same bordered solves.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.func import jvp, vjp

from ..continuation.algorithms import PALC
from ..continuation.driver import continuation
from ..continuation.kernels import _flat_op
from ..continuation.results import Branch
from ..core.lens import as_lens
from ..core.params import ContinuationPar
from ..core.problem import BifurcationProblem
from ..core.state import global_dot, global_norm, ravel, tree_map
from ..detection.events import ContinuousEvent, DiscreteEvent, PairOfEvents
from ..linalg.linear import GMRES, IterativeRefinement, PairedOperator
from ..linalg.eig import FlatOperator
from ..ops.nvcc import carries_derivative
from .minaug import _ma_lens, _set_ma_attrs


def ext_precond(precond, n: int):
    """Extend an inner preconditioner (flat size-n vectors) to the bordered
    flat vector: P on the leading n entries, identity on the scalar tail."""
    if precond is None:
        return None

    def pext(v):
        head = ravel(precond(v[:n]))[0]
        return torch.cat([head, v[n:]])

    return pext


def ext_precond2(precond, n: int):
    """Blockdiag(P, P, I) preconditioner for the real-embedded complex
    bordered system (size 2n + 2)."""
    if precond is None:
        return None

    def pext(v):
        h1 = ravel(precond(v[:n]))[0]
        h2 = ravel(precond(v[n:2 * n]))[0]
        return torch.cat([h1, h2, v[2 * n:]])

    return pext


def _ir_solve(op_hi, op_lo, rhs, gm_lo, lo, refinements: int = 2,
              rtol: float = 1e-11, atol: float = 1e-14, n_rep: int = 0):
    """Mixed-precision solve of op_hi x = rhs: all Krylov matvecs run the
    low-precision twin `op_lo`, a couple of residual corrections at rhs's
    precision restore full accuracy.  Each low-precision correction is
    finite-guarded: a Krylov breakdown contributes nothing instead of
    poisoning the iterate, and the next pass retries from the current x.
    The residual norms count rhs's last `n_rep` entries once on a
    partitioned state (`GMRES.n_rep`).  Returns (x, converged)."""
    def _san(v):
        return torch.where(torch.isfinite(v), v, torch.zeros_like(v))

    x0, _, _ = gm_lo(op_lo, rhs.to(lo))
    x = _san(ravel(x0)[0]).to(rhs.dtype)
    tol = max(rtol * float(global_norm(rhs, n_rep)), atol)
    rn = float(global_norm(rhs - op_hi(x), n_rep))
    k = 0
    while rn > tol and k < refinements:
        d, _, _ = gm_lo(op_lo, (rhs - op_hi(x)).to(lo))
        x = x + _san(ravel(d)[0]).to(rhs.dtype)
        rn = float(global_norm(rhs - op_hi(x), n_rep))
        k += 1
    return x, rn <= tol


def solve_bordered_ext(Jd, col, row, gmres, rhs_top=None, rhs_bot=1.0,
                       Jd_lo=None, gm_lo=None, lo=None):
    """Solve [J col; row^T 0][v; s] = [rhs_top; rhs_bot] by GMRES on the
    extended flat operator.  `Jd` is a flat matvec; the default RHS
    [0; 1] is the null-vector system.  With (`Jd_lo`, `gm_lo`, `lo`) the
    Krylov work runs the low-precision twin with refinement (`_ir_solve`).
    On a row-partitioned state (`parallel.use_mesh`) col, row and v are
    this rank's blocks and s the replicated tail: the border dot is
    completed over the ranks, and the GMRES of `_make_ma_gmres` counts s
    once.  Returns (v, s, converged)."""
    n = col.shape[0]

    def op(z):
        return torch.cat([Jd(z[:n]) + z[n] * col,
                          global_dot(row, z[:n]).reshape(1)])

    if rhs_top is None:
        rhs_top = torch.zeros((n,), dtype=col.dtype, device=col.device)
    rhs = torch.cat([rhs_top, torch.as_tensor(
        rhs_bot, dtype=col.dtype, device=col.device).reshape(1)])
    if Jd_lo is not None:
        col_lo, row_lo = col.to(lo), row.to(lo)

        def op_lo(z):
            return torch.cat([Jd_lo(z[:n]) + z[n] * col_lo,
                              global_dot(row_lo, z[:n]).reshape(1)])

        sol, cv = _ir_solve(op, op_lo, rhs, gm_lo, lo, n_rep=1)
        return sol[:n], sol[n], cv
    sol, cv, _ = gmres(op, rhs)
    return sol[:n], sol[n], cv


def solve_bordered_ext_cplx(Jd, Omega, cr, ci, dr, di, gmres2,
                            Jd_lo=None, gm_lo=None, lo=None,
                            rhs_top=None):
    """Real-block embedding of the complex bordered solve

        [K c; d^H 0][v; s] = [t; 0],   K = J + i*Omega*I  (J real)

    on the flat (2n+2) vector [vr; vi; sr; si].  Returns
    (vr, vi, sr, si, converged).  Forward Hopf system: Omega = -omega,
    c = a, d = b; adjoint: Jd = J^T (vjp), Omega = +omega, c = b, d = a.
    The default RHS (rhs_top=None) is the null-vector system [0; 1];
    `rhs_top=(tr, ti)` gives the complex top RHS t with zero scalar RHS."""
    n = cr.shape[0]

    def make_op(Jx, crx, cix, drx, dix, Om):
        def op(z):
            vr, vi = z[:n], z[n:2 * n]
            sr, si = z[2 * n], z[2 * n + 1]
            r1 = Jx(vr) - Om * vi + sr * crx - si * cix
            r2 = Jx(vi) + Om * vr + sr * cix + si * crx
            r3 = torch.dot(drx, vr) + torch.dot(dix, vi)
            r4 = torch.dot(drx, vi) - torch.dot(dix, vr)
            return torch.cat([r1, r2, r3.reshape(1), r4.reshape(1)])

        return op

    op = make_op(Jd, cr, ci, dr, di, Omega)
    if rhs_top is None:
        rhs = torch.zeros((2 * n + 2,), dtype=cr.dtype, device=cr.device)
        rhs[2 * n] = 1.0
    else:
        tr, ti = rhs_top
        rhs = torch.cat([tr, ti, torch.zeros((2,), dtype=cr.dtype,
                                             device=cr.device)])
    if Jd_lo is not None:
        op_lo = make_op(Jd_lo, cr.to(lo), ci.to(lo), dr.to(lo), di.to(lo),
                        torch.as_tensor(Omega).to(lo))
        sol, cv = _ir_solve(op, op_lo, rhs, gm_lo, lo)
    else:
        sol, cv, _ = gmres2(op, rhs)
    return sol[:n], sol[n:2 * n], sol[2 * n], sol[2 * n + 1], cv


def _cast_tree(tree, dt):
    return tree_map(
        lambda a: a.to(dt) if (isinstance(a, torch.Tensor)
                               and a.is_floating_point()) else a, tree)


def _make_ma_gmres(precond, n: int, k: int, opts: Optional[dict]):
    """GMRES for the extended systems: k = 1 the n + 1 bordered system,
    k = 2 the real-embedded 2n + 2 one, with the inner preconditioner
    extended blockwise; the k scalar slots are the flat vector's
    replicated tail on a partitioned state (`GMRES.n_rep`)."""
    o = dict(restart=40, maxiter=240, rtol=1e-10, atol=1e-14, n_rep=k)
    if opts:
        o.update(opts)
    pext = ext_precond(precond, n) if k == 1 else ext_precond2(precond, n)
    return GMRES(precond=pext, **o)


def solve_shifted_cplx(Jd, sig_re, sig_im, rhs_re, rhs_im, gm2n):
    """Solve (sigma I - J) x = b for complex sigma and b over a REAL
    operator J in the 2n real embedding — the matrix-free shifted solves
    of the codim-2 normal forms, e.g. (2 i omega - L) h020 = B(q1, q1)
    (ref src/codim2/NormalForms.jl).  Returns (xr, xi, converged)."""
    n = rhs_re.shape[0]

    def op(z):
        zr, zi = z[:n], z[n:]
        return torch.cat([sig_re * zr - sig_im * zi - Jd(zr),
                          sig_re * zi + sig_im * zr - Jd(zi)])

    sol, cv, _ = gm2n(op, torch.cat([rhs_re, rhs_im]))
    return sol[:n], sol[n:], cv


# ---------------------------------------------------------------------------
# products at one point of the inner problem
# ---------------------------------------------------------------------------


def _jd(prob, xs, params):
    """Flat J.v at (xs, params), through the model's `jac_op` where it
    gives one (the kernel on the card); the operator is built once.  The
    product keeps d's dtype (a model's constants may promote a
    low-precision twin internally)."""
    _, unravel = ravel(xs)
    J = prob.jacobian_operator(xs, params)
    return lambda d: ravel(J(unravel(d)))[0].to(d.dtype)


def _jtd(prob, xs, params):
    """Flat J^T.v at (xs, params): the model's adjoint, else one vjp of F
    built at the point; the product keeps d's dtype."""
    _, unravel = ravel(xs)
    if prob.jac_adjoint is not None:
        Jt = prob.jac_adjoint(xs, params)
    else:
        _, fn = vjp(lambda x: prob.F(x, params), xs)
        Jt = lambda d: fn(d)[0]                     # noqa: E731
    return lambda d: ravel(Jt(unravel(d)))[0].to(d.dtype)


def _jv_of_F(prob, xs, params, vs):
    """J(xs, params) v as a jvp of F: differentiable again in xs and in
    the parameters, which a kernel's product is not."""
    return ravel(jvp(lambda y: prob.F(y, params), (xs,), (vs,))[1])[0]


def _d_dp(fn, p):
    """d fn / d p at the 0-d tensor p (one jvp)."""
    return jvp(fn, (p,), (torch.ones_like(p),))[1]


def _grad_x_pairing(prob, x, unravel, params, vs, ws):
    """grad_x sum_k <w_k, J(x) v_k> for the pairs (v_k, w_k): the model's
    closed form (`grad_pairing`) where it gives one, else one vjp through
    the jvp of F."""
    hook = getattr(prob, "grad_pairing", None)
    if hook is not None:
        return ravel(hook(unravel(x), params, [unravel(v) for v in vs],
                          [unravel(w) for w in ws]))[0]

    def jvs(xf):
        xx = unravel(xf)
        return torch.stack([_jv_of_F(prob, xx, params, unravel(v))
                            for v in vs])

    _, fn = vjp(jvs, x)
    return fn(torch.stack(ws))[0]


def _param_hook(prob, lens, which: int):
    """The model's closed-form dF/dp (which = 0) or d(J.v)/dp (which = 1)
    for the parameter `lens` names (`param_derivs`), or None."""
    pair = (getattr(prob, "param_derivs", None) or {}).get(lens.name)
    return None if pair is None else pair[which]


def _dF_dp(prob, xs, lens, at, p):
    """dF/dp at p, the parameters `at(p)`: the model's closed form where
    it gives one, else one jvp of F."""
    hook = _param_hook(prob, lens, 0)
    if hook is not None:
        return ravel(hook(xs, at(p)))[0]
    return _d_dp(lambda pp: ravel(prob.F(xs, at(pp)))[0], p)


def _dJv_dp(prob, xs, lens, at, p, vs):
    """d(J(xs) vs)/dp at p, the parameters `at(p)`: the model's closed
    form where it gives one, else a jvp in p of the jvp of F."""
    hook = _param_hook(prob, lens, 1)
    if hook is not None:
        return ravel(hook(xs, at(p), vs))[0]
    return _d_dp(lambda pp: _jv_of_F(prob, xs, at(pp), vs), p)


def _p_tensor(p, like):
    return torch.as_tensor(p, dtype=like.dtype, device=like.device)


def _lo_gmres(precond, n, k, gmres_opts):
    """The low-precision twin's GMRES: rtol-only (an absolute floor would
    make the refinement solves, whose rhs is the shrinking residual, do
    nothing)."""
    lo_opts = dict(gmres_opts or {})
    lo_opts["rtol"] = max(float(lo_opts.get("rtol", 1e-10)), 3e-5)
    lo_opts["atol"] = 0.0
    return _make_ma_gmres(precond, n, k, lo_opts)


def _memo_anchors(raw, keys):
    """Identity-keyed one-slot memo of the anchors: the update hook and
    the BT/cusp event evaluate them at the same converged state each step
    (X is the state tensor itself, the same object in both), so the memo
    halves the per-step extended solves.  The event runs first, at the
    step's p2, and the update hook reuses its anchors.  A tensor that
    carries a derivative is never held."""
    slot = {}

    def anchors_kernel(X, par):
        objs = (X,) + tuple(par.get(k) for k in keys)
        if any(isinstance(o, torch.Tensor) and carries_derivative(o)
               for o in objs):
            return raw(X, par)
        held = slot.get("objs")
        if held is not None and all(a is b for a, b in zip(held, objs)):
            return slot["val"]
        val = raw(X, par)
        slot["objs"], slot["val"] = objs, val
        return val

    return anchors_kernel


def _ma_common(prob, lens1, lens2, precond, gmres_opts, low_dtype, k):
    inner_lens, outer_lens = as_lens(lens1), as_lens(lens2)
    flat0, unravel = ravel(prob.u0)
    n = flat0.shape[0]
    gm = _make_ma_gmres(precond, n, k, gmres_opts)
    gm_lo = None if low_dtype is None else _lo_gmres(precond, n, k,
                                                     gmres_opts)

    def lo_twins(xs, params, X):
        """Low-precision J.v / J^T.v at cast primals (None when mixed
        precision is off or the primals are already low)."""
        if low_dtype is None or X.dtype == low_dtype:
            return None, None
        xs_lo = _cast_tree(xs, low_dtype)
        params_lo = _cast_tree(params, low_dtype)
        return _jd(prob, xs_lo, params_lo), _jtd(prob, xs_lo, params_lo)

    return inner_lens, outer_lens, flat0, unravel, n, gm, gm_lo, lo_twins


def _eig_operator(prob, xs, params, eig_compute_dtype):
    """The inner jacobian as an operator for the iterative eigensolvers
    (ref FoldEig stripping the border, src/codim2/MinAugFold.jl:579-601),
    at the eigensolver's compute dtype when it has one."""
    ed = eig_compute_dtype
    if ed is None:
        return _flat_op(prob, xs, params)
    return _flat_op(prob, _cast_tree(xs, ed), _cast_tree(params, ed),
                    out_dtype=ed)


# ---------------------------------------------------------------------------
# Fold MA problem, operator path
# ---------------------------------------------------------------------------


def fold_ma_problem_mf(prob: BifurcationProblem, lens1, lens2,
                       precond=None, gmres_opts: Optional[dict] = None,
                       eig_compute_dtype=None,
                       update_every: int = 1,
                       low_dtype=None) -> BifurcationProblem:
    """Matrix-free fold MA problem: unknown X = (x, p1), G = (F, sigma)
    with sigma from the preconditioned extended bordered solve and the
    Govaerts operator jacobian (ref src/codim2/MinAugFold.jl:15-208).

    `low_dtype=torch.float32` runs every extended bordered solve's Krylov
    iterations on a low-precision twin of J.v with refinement, and
    `jac_op` returns a `PairedOperator` so the corrector's
    `IterativeRefinement` reuses the same twin."""
    (inner_lens, outer_lens, flat0, unravel, n, gm_ext, gm_lo,
     lo_twins) = _ma_common(prob, lens1, lens2, precond, gmres_opts,
                            low_dtype, 1)
    lo = low_dtype

    def at_point(X, par):
        x, p1 = X[:n], X[n]
        return x, p1, unravel(x), inner_lens.set(par["_inner"], p1)

    def _v_only(X, par):
        _, _, xs, params = at_point(X, par)
        Jd_lo, _ = lo_twins(xs, params, X)
        return solve_bordered_ext(_jd(prob, xs, params), par["_a"],
                                  par["_b"], gm_ext, Jd_lo=Jd_lo,
                                  gm_lo=gm_lo, lo=lo)

    def _vw(X, par):
        _, _, xs, params = at_point(X, par)
        Jd_lo, Jtd_lo = lo_twins(xs, params, X)
        v, sig, _ = solve_bordered_ext(_jd(prob, xs, params), par["_a"],
                                       par["_b"], gm_ext, Jd_lo=Jd_lo,
                                       gm_lo=gm_lo, lo=lo)
        w, _, _ = solve_bordered_ext(_jtd(prob, xs, params), par["_b"],
                                     par["_a"], gm_ext, Jd_lo=Jtd_lo,
                                     gm_lo=gm_lo, lo=lo)
        return v, sig, w

    def G(X, par):
        _, _, xs, params = at_point(X, par)
        F = ravel(prob.F(xs, params))[0]
        _, sig, _ = _v_only(X, par)
        return torch.cat([F, sig.reshape(1)])

    def jac_op(X, par):
        x, p1, xs, params = at_point(X, par)
        v, _, w = _vw(X, par)
        # sigma_x = -grad_x <w, J(x) v> and sigma_p1 = -<w, dJ/dp1 v>,
        # both taken from F (ref the Govaerts hessian terms,
        # src/codim2/MinAugFold.jl:119-208)
        sigma_x = -_grad_x_pairing(prob, x, unravel, params, [v], [w])

        def at_p1(pp):
            return inner_lens.set(par["_inner"], pp)

        sigma_p1 = -global_dot(w, _dJv_dp(prob, xs, inner_lens, at_p1, p1,
                                          unravel(v)))
        Fp1 = _dF_dp(prob, xs, inner_lens, at_p1, p1)
        Jd = _jd(prob, xs, params)

        def apply(d):
            dx, dp1 = d[:n], d[n]
            return torch.cat([Jd(dx) + dp1 * Fp1,
                              (global_dot(sigma_x, dx)
                               + sigma_p1 * dp1).reshape(1)])

        Jd_lo, _ = lo_twins(xs, params, X)
        if Jd_lo is None:
            return apply
        Fp1_lo, sx_lo, sp1_lo = (t.to(lo) for t in (Fp1, sigma_x, sigma_p1))

        def apply_lo(d):
            dx, dp1 = d[:n], d[n]
            return torch.cat([Jd_lo(dx) + dp1 * Fp1_lo,
                              (global_dot(sx_lo, dx)
                               + sp1_lo * dp1).reshape(1)])

        return PairedOperator(apply, FlatOperator(apply_lo, n + 1, lo,
                                                  X.device))

    def dFdp_user(X, par):
        """d G / d p2 at fixed X: (dF/dp2, -<w, (dJ/dp2) v>)."""
        x, p1, xs, _ = at_point(X, par)
        v, _, w = _vw(X, par)
        p2 = _p_tensor(outer_lens.get(par["_inner"]), X)

        def at_p2(pp):
            return inner_lens.set(outer_lens.set(par["_inner"], pp), p1)

        Fp2 = _dF_dp(prob, xs, outer_lens, at_p2, p2)
        dhs = global_dot(w, _dJv_dp(prob, xs, outer_lens, at_p2, p2,
                                    unravel(v)))
        return torch.cat([Fp2, (-dhs).reshape(1)])

    def record(X, p2, **k):
        return {"param": p2, "p1": X[n], "norm": global_norm(X[:n])}

    def eig_jacobian(X, par):
        _, _, xs, params = at_point(X, par)
        return _eig_operator(prob, xs, params, eig_compute_dtype)

    def _anchors_raw(X, par):
        v, sig, w = _vw(X, par)
        return v / global_norm(v), w / global_norm(w), sig

    anchors_kernel = _memo_anchors(_anchors_raw, ("_a", "_b"))

    def update(it, state):
        if update_every <= 0 or state.step % update_every != 0:
            return None
        v, w, _ = anchors_kernel(state.z.u, it.current_params)
        return {**it.current_params, "_b": v, "_a": w}

    maprob = BifurcationProblem(
        G, u0=None,
        params={"_inner": prob.params, "_a": torch.ones_like(flat0),
                "_b": torch.ones_like(flat0)},
        lens=_ma_lens(outer_lens, "fold-ma-mf"), jac_op=jac_op,
        dFdp_user=dFdp_user, record_from_solution=record, update=update)
    return _set_ma_attrs(maprob, prob, inner_lens, outer_lens, n, unravel,
                         "fold", eig_jacobian, ma_mf=True, fuse_step=False,
                         jac_op_paired=low_dtype is not None,
                         anchors_kernel=anchors_kernel, gm_ext=gm_ext,
                         precond=precond, eig_tracked_zero=True)


# ---------------------------------------------------------------------------
# Hopf MA problem, operator path (real-embedded complex bordered solves)
# ---------------------------------------------------------------------------


def hopf_ma_problem_mf(prob: BifurcationProblem, lens1, lens2,
                       precond=None, gmres_opts: Optional[dict] = None,
                       eig_compute_dtype=None,
                       update_every: int = 1,
                       low_dtype=None) -> BifurcationProblem:
    """Matrix-free Hopf MA problem: unknown X = (x, p1, omega),
    G = (F, Re sigma, Im sigma) with sigma from the real-embedded extended
    bordered solve of [J - i omega I, a; b^H, 0] and the Govaerts operator
    jacobian (ref src/codim2/MinAugHopf.jl:19-212).  The border vectors are
    real pairs (_ar, _ai, _br, _bi)."""
    (inner_lens, outer_lens, flat0, unravel, n, gm2, gm2_lo,
     lo_twins) = _ma_common(prob, lens1, lens2, precond, gmres_opts,
                            low_dtype, 2)
    lo = low_dtype

    def at_point(X, par):
        x, p1, om = X[:n], X[n], X[n + 1]
        return x, p1, om, unravel(x), inner_lens.set(par["_inner"], p1)

    def _forward(X, par, Jd, Jd_lo):
        return solve_bordered_ext_cplx(
            Jd, -X[n + 1], par["_ar"], par["_ai"], par["_br"], par["_bi"],
            gm2, Jd_lo=Jd_lo, gm_lo=gm2_lo, lo=lo)

    def _vw(X, par):
        _, _, om, xs, params = at_point(X, par)
        Jd_lo, Jtd_lo = lo_twins(xs, params, X)
        vr, vi, sr, si, _ = _forward(X, par, _jd(prob, xs, params), Jd_lo)
        # adjoint: (J - i om I)^H = J^T + i om I; the borders swap roles
        wr, wi, _, _, _ = solve_bordered_ext_cplx(
            _jtd(prob, xs, params), om, par["_br"], par["_bi"], par["_ar"],
            par["_ai"], gm2, Jd_lo=Jtd_lo, gm_lo=gm2_lo, lo=lo)
        return vr, vi, sr, si, wr, wi

    def G(X, par):
        _, _, _, xs, params = at_point(X, par)
        F = ravel(prob.F(xs, params))[0]
        Jd_lo, _ = lo_twins(xs, params, X)
        _, _, sr, si, _ = _forward(X, par, _jd(prob, xs, params), Jd_lo)
        return torch.cat([F, sr.reshape(1), si.reshape(1)])

    def _rows_p(xs, vr, vi, wr, wi, fn_par, p):
        """(Re, Im) of -<w, dJ/dp v>_H, the derivative taken from F."""
        vrs, vis = unravel(vr), unravel(vi)
        t = _d_dp(lambda pp: torch.stack([
            _jv_of_F(prob, xs, fn_par(pp), vrs),
            _jv_of_F(prob, xs, fn_par(pp), vis)]), p)
        tr, ti = t[0], t[1]
        return (-(torch.dot(wr, tr) + torch.dot(wi, ti)),
                -(torch.dot(wr, ti) - torch.dot(wi, tr)))

    def jac_op(X, par):
        """The Govaerts operator: sigma_dot = -<w, M_dot v> with
        M = J - i omega I (ref MinAugHopf.jl:117-212)."""
        x, p1, om, xs, params = at_point(X, par)
        vr, vi, _, _, wr, wi = _vw(X, par)
        # grad_x of Re <w, J v>_H = <wr, J vr> + <wi, J vi> and of
        # Im <w, J v>_H = <wr, J vi> - <wi, J vr>
        sigx_re = -_grad_x_pairing(prob, x, unravel, params, [vr, vi],
                                   [wr, wi])
        sigx_im = -_grad_x_pairing(prob, x, unravel, params, [vi, vr],
                                   [wr, -wi])
        sigp1_re, sigp1_im = _rows_p(
            xs, vr, vi, wr, wi, lambda pp: inner_lens.set(par["_inner"], pp),
            p1)
        # d/d omega (J - i omega I) = -i I  ->  sigma_dot = i <w, v>_H
        sigom_re = -(torch.dot(wr, vi) - torch.dot(wi, vr))
        sigom_im = torch.dot(wr, vr) + torch.dot(wi, vi)
        Fp1 = _d_dp(lambda pp: ravel(prob.F(
            xs, inner_lens.set(par["_inner"], pp)))[0], p1)
        rows = (sigx_re, sigx_im, sigp1_re, sigp1_im, sigom_re, sigom_im)

        def make_apply(Jx, Fp, r):
            def apply(d):
                dx, dp1, dom = d[:n], d[n], d[n + 1]
                r_re = torch.dot(r[0], dx) + r[2] * dp1 + r[4] * dom
                r_im = torch.dot(r[1], dx) + r[3] * dp1 + r[5] * dom
                return torch.cat([Jx(dx) + dp1 * Fp, r_re.reshape(1),
                                  r_im.reshape(1)])

            return apply

        apply = make_apply(_jd(prob, xs, params), Fp1, rows)
        Jd_lo, _ = lo_twins(xs, params, X)
        if Jd_lo is None:
            return apply
        apply_lo = make_apply(Jd_lo, Fp1.to(lo), [t.to(lo) for t in rows])
        return PairedOperator(apply, FlatOperator(apply_lo, n + 2, lo,
                                                  X.device))

    def dFdp_user(X, par):
        x, p1, _, xs, _ = at_point(X, par)
        vr, vi, _, _, wr, wi = _vw(X, par)
        p2 = _p_tensor(outer_lens.get(par["_inner"]), X)

        def at_p2(pp):
            return inner_lens.set(outer_lens.set(par["_inner"], pp), p1)

        Fp2 = _d_dp(lambda pp: ravel(prob.F(xs, at_p2(pp)))[0], p2)
        s_re, s_im = _rows_p(xs, vr, vi, wr, wi, at_p2, p2)
        return torch.cat([Fp2, s_re.reshape(1), s_im.reshape(1)])

    def record(X, p2, **k):
        return {"param": p2, "p1": X[n], "omega": X[n + 1],
                "norm": torch.linalg.vector_norm(X[:n])}

    def eig_jacobian(X, par):
        _, _, _, xs, params = at_point(X, par)
        return _eig_operator(prob, xs, params, eig_compute_dtype)

    def _anchors_raw(X, par):
        vr, vi, sr, si, wr, wi = _vw(X, par)
        nv = torch.sqrt(torch.dot(vr, vr) + torch.dot(vi, vi))
        nw = torch.sqrt(torch.dot(wr, wr) + torch.dot(wi, wi))
        return (vr / nv, vi / nv, wr / nw, wi / nw,
                torch.sqrt(sr * sr + si * si))

    anchors_kernel = _memo_anchors(_anchors_raw, ("_ar", "_br"))

    def update(it, state):
        if update_every <= 0 or state.step % update_every != 0:
            return None
        X = state.z.u
        vr, vi, wr, wi, _ = anchors_kernel(X, it.current_params)
        new = {**it.current_params, "_br": vr, "_bi": vi, "_ar": wr,
               "_ai": wi}
        if float(X[n + 1]) < 0:
            # pin omega > 0: (x, p1, -omega) is the conjugate solution;
            # flip omega and conjugate the anchors
            Xf = X.clone()
            Xf[n + 1] = -X[n + 1]
            state.z = dataclasses.replace(state.z, u=Xf)
            new["_ai"], new["_bi"] = -wi, -vi
        return new

    zero = torch.zeros_like(flat0)
    maprob = BifurcationProblem(
        G, u0=None,
        params={"_inner": prob.params, "_ar": torch.ones_like(flat0),
                "_ai": zero, "_br": torch.ones_like(flat0), "_bi": zero},
        lens=_ma_lens(outer_lens, "hopf-ma-mf"), jac_op=jac_op,
        dFdp_user=dFdp_user, record_from_solution=record, update=update)
    return _set_ma_attrs(maprob, prob, inner_lens, outer_lens, n, unravel,
                         "hopf", eig_jacobian, ma_mf=True, fuse_step=False,
                         jac_op_paired=low_dtype is not None,
                         anchors_kernel=anchors_kernel, gm2=gm2,
                         precond=precond)


# ---------------------------------------------------------------------------
# codim-2 test functions along MF curves (no dense eig anywhere)
# ---------------------------------------------------------------------------


def fold_codim2_event_mf(maprob):
    """BT (<w, v> -> 0), cusp (fold of the fold curve) and ZH (a complex
    crossing of the iterative inner spectrum) along an MF fold curve
    (ref test_bt_cusp/test_zh, src/codim2/MinAugFold.jl:539-577)."""
    anchors = maprob.anchors_kernel

    def cond(it, state):
        par = it.prob.set_lens_param(it.current_params, float(state.p))
        # the anchors memo is shared with the update hook (same X, same
        # borders in a step)
        v, w, _ = anchors(state.z.u, par)
        return (float(torch.dot(w, v)), float(state.tau.p))

    cont = ContinuousEvent(nb=2, condition=cond, labels=["bt", "cusp"])

    def zh_cond(it, state):
        if state.eigvals is None:
            return (0,)
        eps = it.contparams.tol_stability
        vals = np.asarray(state.eigvals)
        # leave out the fold's own zero mode (the smallest-|lambda|
        # near-real eigenvalue), then count complex modes in the right half
        # plane, up to the tolerance
        realish = np.abs(vals.imag) <= eps
        mask = np.ones(len(vals), bool)
        if np.any(realish):
            idx = np.where(realish)[0]
            mask[idx[np.argmin(np.abs(vals[idx]))]] = False
        return (int(np.sum(mask & (vals.real > -eps) & (vals.imag > eps))),)

    disc = DiscreteEvent(nb=1, condition=zh_cond, labels=["zh"])
    return PairOfEvents(cont, disc)


def make_l1_kernel_mf(maprob):
    """First Lyapunov coefficient along an MF Hopf curve — the GH test at
    PDE scale (ref MinAugHopf.jl:598-635).  (zeta, zeta*) come from the
    bordered solves of the functional (on the curve the bordered null
    vectors ARE the Hopf eigenvectors); the two linear solves
    ((2 i omega - J) and -J) run preconditioned GMRES, the complex one in
    the real embedding.  R2 and R3 come from the problem's d2F and d3F."""
    prob = maprob.inner_prob
    inner_lens = maprob.inner_lens
    n = maprob.n_inner
    unravel = maprob.unravel_inner
    precond = maprob.precond
    gm2 = maprob.gm2
    # the two solves take the problem's Krylov sizes (its `gmres_opts`;
    # GMRES(40, 240) by default): a fixed GMRES(40, 240) stops unconverged
    # on an unpreconditioned 1d diffusion jacobian of a few hundred
    # unknowns, and l1 then comes out wrong in sign and size
    sizes = dict(restart=gm2.restart, maxiter=gm2.maxiter)
    gm_n = GMRES(rtol=1e-9, atol=1e-13,
                 precond=(lambda v: ravel(precond(v))[0])
                 if precond is not None else None, **sizes)

    def pre2(v):
        return torch.cat([ravel(precond(v[:n]))[0],
                          ravel(precond(v[n:]))[0]])

    gm_2n = GMRES(rtol=1e-9, atol=1e-13,
                  precond=pre2 if precond is not None else None, **sizes)

    def l1_fn(X, par):
        om = X[n + 1]
        xs = unravel(X[:n])
        params = inner_lens.set(par["_inner"], X[n])
        Jd, Jtd = _jd(prob, xs, params), _jtd(prob, xs, params)
        vr, vi, _, _, _ = solve_bordered_ext_cplx(
            Jd, -om, par["_ar"], par["_ai"], par["_br"], par["_bi"], gm2)
        wr, wi, _, _, _ = solve_bordered_ext_cplx(
            Jtd, om, par["_br"], par["_bi"], par["_ar"], par["_ai"], gm2)
        nz = torch.sqrt(torch.dot(vr, vr) + torch.dot(vi, vi))
        zr, zi = vr / nz, vi / nz
        # zeta_ad normalised so that <zeta, zeta_ad> = 1
        cr = torch.dot(zr, wr) + torch.dot(zi, wi)
        ci = torch.dot(zr, wi) - torch.dot(zi, wr)
        c2 = cr * cr + ci * ci
        ar, ai = (wr * cr + wi * ci) / c2, (wi * cr - wr * ci) / c2

        def d2(a, b):
            return ravel(prob.d2F(xs, params, unravel(a), unravel(b)))[0]

        def d3(a, b, c):
            return ravel(prob.d3F(xs, params, unravel(a), unravel(b),
                                  unravel(c)))[0]

        # R2(z, z) = ((d2[zr,zr] - d2[zi,zi]) + 2i d2[zr,zi]) / 2 and the
        # real R2(z, conj z) = (d2[zr,zr] + d2[zi,zi]) / 2
        d_rr, d_ii = d2(zr, zr), d2(zi, zi)
        R20_r, R20_i = 0.5 * (d_rr - d_ii), d2(zr, zi)
        R11 = 0.5 * (d_rr + d_ii)

        # Psi200: (2 i om I - J) Psi = R20, in the real embedding
        def op2(zv):
            pr, pi = zv[:n], zv[n:]
            return torch.cat([-Jd(pr) - 2 * om * pi, -Jd(pi) + 2 * om * pr])

        sol2, _, _ = gm_2n(op2, torch.cat([R20_r, R20_i]))
        P200_r, P200_i = sol2[:n], sol2[n:]
        # Psi110: -J Psi = 2 R11
        P110, _, _ = gm_n(lambda d: -Jd(d), 2.0 * R11)

        # bv = 2 R2(z, Psi110) + 2 R2(conj z, Psi200) + 3 R3(z, z, conj z)
        bv_r = (d2(zr, P110) + (d2(zr, P200_r) + d2(zi, P200_i))
                + 0.5 * (d3(zr, zr, zr) + d3(zi, zi, zr)))
        bv_i = (d2(zi, P110) + (d2(zr, P200_i) - d2(zi, P200_r))
                + 0.5 * (d3(zr, zr, zi) + d3(zi, zi, zi)))
        # l1 = Re <bv, zeta_ad> = Re sum(conj(bv) * zeta_ad)
        return torch.dot(bv_r, ar) + torch.dot(bv_i, ai)

    return l1_fn


def hopf_codim2_event_mf(maprob, with_gh: bool = True,
                         gh_every: int = 1):
    """BT (omega -> 0) and GH (l1 -> 0) monitoring along an MF Hopf curve.

    `gh_every=k` evaluates the l1 kernel (six extended bordered solves and
    two GMRES solves, the costliest per-step work) only every k-th step
    and holds the last value in between: a GH sign change is seen at most
    k steps late, and the event's bisection always evaluates the kernel
    (`state.in_bisection`), so the located point is exact."""
    n = maprob.n_inner
    l1_fn = make_l1_kernel_mf(maprob) if with_gh else None
    last = {"l1": 0.0, "step": None}

    def cond(it, state):
        X = state.z.u
        vals = [float(X[n + 1])]
        if with_gh:
            if (gh_every <= 1 or state.in_bisection
                    or state.step % gh_every == 0 or last["step"] is None):
                par = it.prob.set_lens_param(it.current_params,
                                             float(state.p))
                last["l1"] = float(l1_fn(X, par))
                last["step"] = state.step
            vals.append(last["l1"])
        return tuple(vals)

    labels = ["bt"] + (["gh"] if with_gh else [])
    return ContinuousEvent(nb=1 + int(with_gh), condition=cond,
                           labels=labels)


# ---------------------------------------------------------------------------
# starters: anchor bootstrap by bordered inverse iteration
# ---------------------------------------------------------------------------


def _null_seed(sp, n):
    """Best available seed for the critical eigenvector: the special
    point's saved eigenvector, else a deterministic random direction."""
    if sp.eigenvecs is not None:
        ind = max(int(sp.ind_ev) - 1, 0)
        vecs = sp.eigenvecs
        col = (vecs.detach().cpu().numpy() if isinstance(vecs, torch.Tensor)
               else np.asarray(vecs))[:, ind]
        return np.real(col), np.imag(col)
    rng = np.random.default_rng(13)
    return rng.standard_normal(n), np.zeros(n)


def _as_like(a, like):
    return torch.as_tensor(np.asarray(a), dtype=like.dtype,
                           device=like.device)


def bootstrap_fold_anchors(maprob, X0, params, iters: int = 3,
                           seed=None):
    """Refine the MA border vectors by bordered inverse iteration: at a
    fold J is singular, so one bordered solve with any reasonable border
    concentrates v onto the null vector; re-anchoring converges
    quadratically (ref the eigenvector start, src/codim2/codim2.jl:86-106)."""
    par = dict(params)
    if seed is not None:
        s = _as_like(seed, par["_a"])
        par["_a"] = par["_b"] = s / torch.linalg.vector_norm(s)
    for _ in range(iters):
        v, w, _ = maprob.anchors_kernel(X0, par)
        par["_b"], par["_a"] = v, w
    return par


def bootstrap_hopf_anchors(maprob, X0, params, iters: int = 3,
                           seed=None):
    par = dict(params)
    if seed is not None:
        s_r, s_i = _as_like(seed[0], par["_ar"]), _as_like(seed[1],
                                                           par["_ar"])
        nrm = torch.sqrt(torch.dot(s_r, s_r) + torch.dot(s_i, s_i))
        par["_ar"], par["_ai"] = s_r / nrm, s_i / nrm
        par["_br"], par["_bi"] = s_r / nrm, s_i / nrm
    for _ in range(iters):
        vr, vi, wr, wi, _ = maprob.anchors_kernel(X0, par)
        par["_br"], par["_bi"] = vr, vi
        par["_ar"], par["_ai"] = wr, wi
    return par


def _iter_spectrum_at(maprob, X, par, nev: int = 10, with_vectors=True):
    """Iterative inner spectrum at a point of an MF MA curve: Arnoldi on
    the problem's `eig_jacobian` operator.  Returns (values, vectors or
    None, converged) on the host."""
    from ..linalg.eig import ArnoldiEig

    op = maprob.eig_jacobian(torch.as_tensor(X), par)
    vals, vecs, cv, _ = ArnoldiEig(krylov_dim=max(4 * nev, 48), restarts=4,
                                   which="LR")(op, nev)
    return (vals.cpu().numpy(),
            vecs.detach().cpu().numpy() if with_vectors else None, bool(cv))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _ma_eigsolver(nopts, contparams):
    """`eig_jacobian` hands over an operator: a dense eigensolver would
    raise, so a DenseEig default becomes warm-started Arnoldi."""
    from ..linalg.eig import ArnoldiEig, DenseEig

    if isinstance(nopts.eigsolver, DenseEig) \
            and contparams.detect_bifurcation > 1:
        return nopts.replace(eigsolver=ArnoldiEig(
            krylov_dim=max(2 * contparams.nev + 12, 40), restarts=3))
    return nopts


def _ma_palc(alg, ls_ma):
    """PALC over the MA operator: plain block elimination, no refinement
    pass (ls_ma solves J_G to its own rtol; a refinement pass would double
    the nested Krylov work of each corrector iteration)."""
    from ..linalg.bordered import BorderingBLS

    if isinstance(alg, PALC) and getattr(alg, "bls", None) is None:
        return dataclasses.replace(
            alg, bls=BorderingBLS(solver=ls_ma, check_precision=False))
    return alg


def _ma_linsolver(precond, n, k, user_ls, low_dtype=None):
    """Corrector linear solver for the (n+k)-dim MA operator: GMRES with
    the inner preconditioner extended by identity scalar slots, with the
    user's GMRES settings where one was given.  With `low_dtype`, an
    IterativeRefinement runs the Krylov work on the jac_op's low twin
    (`PairedOperator`)."""
    o = {}
    if isinstance(user_ls, GMRES):
        o = dict(restart=user_ls.restart, maxiter=user_ls.maxiter,
                 rtol=user_ls.rtol, atol=user_ls.atol)
    elif isinstance(user_ls, IterativeRefinement) \
            and isinstance(user_ls.inner, GMRES):
        o = dict(restart=user_ls.inner.restart,
                 maxiter=user_ls.inner.maxiter)
    o.setdefault("restart", 40)
    o.setdefault("maxiter", 240)
    o.setdefault("rtol", 1e-9)
    o.setdefault("atol", 1e-13)
    pext = ext_precond(precond, n)
    if low_dtype is not None:
        inner = GMRES(precond=pext, restart=o["restart"],
                      maxiter=o["maxiter"], rtol=3e-5, atol=0.0)
        return IterativeRefinement(inner=inner, low_dtype=low_dtype,
                                   refinements=4, rtol=o["rtol"],
                                   atol=o["atol"])
    return GMRES(precond=pext, **o)


def _low_dtype(low_dtype):
    """"auto" mixes precisions only where f64 is emulated (a TPU in the
    JAX package); the card and the CPU run f64 natively."""
    return None if low_dtype == "auto" else low_dtype


def _continue_ma(br, maprob, contparams, alg, precond, k, low_dtype, event,
                 detect_codim2_bifurcation, kind, kwargs):
    from .minaug import _codim2_contparams, _relabel_codim2

    nopts = contparams.newton_options
    ls_ma = _ma_linsolver(precond, maprob.n_inner, k, nopts.linsolver,
                          low_dtype=low_dtype)
    cp = contparams.replace(newton_options=_ma_eigsolver(
        nopts, contparams).replace(linsolver=ls_ma))
    if event is not None:
        cp = _codim2_contparams(cp, detect_codim2_bifurcation)
    gamma = continuation(maprob, _ma_palc(alg or PALC(), ls_ma), cp,
                         kind=kind, event=event, **kwargs)
    _relabel_codim2(gamma, maprob)
    return gamma


def continuation_fold_mf(br, ind_bif: int, lens2,
                         contparams: ContinuationPar,
                         alg=None, detect_codim2_bifurcation: int = 2,
                         update_minaug_every_step: int = 1,
                         precond=None, gmres_opts: Optional[dict] = None,
                         bootstrap_iters: int = 3, low_dtype="auto",
                         **kwargs) -> Branch:
    """Operator-path fold-curve continuation: the reference's own PDE leg
    (`continuation_fold` with `jacobian_ma = MinAug()` + BorderingBLS,
    ref src/codim2/MinAugFold.jl:369-538, examples/SH2d-fronts.jl:97-115).
    Newton and PALC solve the MA operator with preconditioned GMRES;
    sigma, the anchors, the test functions and the per-step inner
    spectrum are all iterative."""
    prob = br.prob
    sp = br.specialpoint[ind_bif]
    if sp.type not in ("fold", "bp"):
        raise ValueError(f"point {ind_bif} is a {sp.type!r}, not fold/bp")
    if precond is None:
        precond = getattr(prob, "spectral_precond", None)
    low_dtype = _low_dtype(low_dtype)
    maprob = fold_ma_problem_mf(
        prob, prob.lens, lens2, precond=precond, gmres_opts=gmres_opts,
        eig_compute_dtype=getattr(contparams.newton_options.eigsolver,
                                  "compute_dtype", None),
        update_every=update_minaug_every_step, low_dtype=low_dtype)
    x_flat, _ = ravel(sp.x)
    X0 = torch.cat([x_flat, _p_tensor(float(sp.param), x_flat).reshape(1)])
    seed_r, _ = _null_seed(sp, maprob.n_inner)
    params = bootstrap_fold_anchors(maprob, X0, dict(maprob.params),
                                    iters=bootstrap_iters, seed=seed_r)
    maprob = maprob.re_make(u0=X0, params=params)
    event = (fold_codim2_event_mf(maprob)
             if detect_codim2_bifurcation > 0 else None)
    gamma = _continue_ma(br, maprob, contparams, alg, precond, 1, low_dtype,
                         event, detect_codim2_bifurcation, "FoldCont",
                         kwargs)
    return Branch(gamma=gamma, bp=sp)


def continuation_hopf_mf(br, ind_bif: int, lens2,
                         contparams: ContinuationPar,
                         alg=None, detect_codim2_bifurcation: int = 2,
                         update_minaug_every_step: int = 1,
                         compute_lyapunov: bool = True,
                         gh_every: int = 2,
                         precond=None, gmres_opts: Optional[dict] = None,
                         bootstrap_iters: int = 3, low_dtype="auto",
                         **kwargs) -> Branch:
    """Operator-path Hopf-curve continuation with BT and GH monitoring
    (`jacobian_ma = MinAug()`, ref examples/cGL2d.jl:115-160,
    src/codim2/MinAugHopf.jl:425-523).  omega and the seed of the anchors
    come from the eigenvalues and eigenvectors saved on the Hopf point."""
    prob = br.prob
    sp = br.specialpoint[ind_bif]
    if sp.type != "hopf":
        raise ValueError(f"point {ind_bif} is a {sp.type!r}, not hopf")
    if precond is None:
        precond = getattr(prob, "spectral_precond", None)
    if sp.eigenvals is None:
        raise ValueError("Hopf special point carries no eigenvalues; rerun "
                         "with detect_bifurcation >= 2")
    vals = np.asarray(sp.eigenvals)
    lam = vals[max(int(sp.ind_ev) - 1, 0)]
    if float(np.imag(lam)) == 0.0:
        cand = vals[np.abs(vals.imag) > 1e-10]
        if len(cand) == 0:
            raise RuntimeError("no complex eigenvalue at the Hopf point")
        lam = cand[np.argmin(np.abs(cand.real))]
    omega = abs(float(np.imag(lam)))
    low_dtype = _low_dtype(low_dtype)
    maprob = hopf_ma_problem_mf(
        prob, prob.lens, lens2, precond=precond, gmres_opts=gmres_opts,
        eig_compute_dtype=getattr(contparams.newton_options.eigsolver,
                                  "compute_dtype", None),
        update_every=update_minaug_every_step, low_dtype=low_dtype)
    x_flat, _ = ravel(sp.x)
    X0 = torch.cat([x_flat, _p_tensor(float(sp.param), x_flat).reshape(1),
                    _p_tensor(omega, x_flat).reshape(1)])
    seed = _null_seed(sp, maprob.n_inner)
    if float(np.imag(lam)) < 0:
        # omega > 0: conjugate the seed so the anchors select the +i omega
        # pair, not its conjugate
        seed = (seed[0], -seed[1])
    params = bootstrap_hopf_anchors(maprob, X0, dict(maprob.params),
                                    iters=bootstrap_iters, seed=seed)
    maprob = maprob.re_make(u0=X0, params=params)
    event = (hopf_codim2_event_mf(maprob, with_gh=compute_lyapunov,
                                  gh_every=gh_every)
             if detect_codim2_bifurcation > 0 else None)
    gamma = _continue_ma(br, maprob, contparams, alg, precond, 2, low_dtype,
                         event, detect_codim2_bifurcation, "HopfCont",
                         kwargs)
    return Branch(gamma=gamma, bp=sp)


# ---------------------------------------------------------------------------
# codim-2 -> codim-2 switching from matrix-free curves
# ---------------------------------------------------------------------------


def _bt_to_hopf_probe_mf(maprob, sp, contparams, lens2, nev: int = 10,
                         **kwargs):
    """bt -> hopf from a matrix-free fold curve: probe (p1, p2) around the
    BT as the dense route does, reconverge the equilibrium with the
    (iterative) inner Newton, and read the split of the double zero
    eigenvalue through the BT Jordan subspace.  Against a stiff PDE
    spectrum plain Krylov cannot see the near-zero pair, but it lives in
    span(q0, q1) of the Jordan chain that the matrix-free BT normal form
    delivers: the 2x2 oblique projection <p_i, J q_j> (eigensolved on the
    host) tracks how the pair splits at each probe, to O(eps^2).  Where
    that basis cannot be had, the probe falls back to Arnoldi on the
    inner operator."""
    from .minaug import _bt_probes, _collapsed, _point_shim, _probe_newton
    from .normal_forms import bt_normal_form

    inner = maprob.inner_prob
    n = maprob.n_inner
    X = torch.as_tensor(sp.x)
    x_in = maprob.unravel_inner(X[:n])
    p1, p2 = float(X[n]), float(sp.param)
    try:
        par_bt = maprob.lens.set(dict(maprob.params), p2)
        pt_bt = bt_normal_form(
            inner, x_in, maprob.inner_lens.set(par_bt["_inner"], p1),
            matrix_free=True, precond=getattr(inner, "spectral_precond",
                                              None))
        basis = pt_bt.zeta + pt_bt.zeta_star          # q0, q1, p0, p1
    except RuntimeError:
        basis = None
    last_err = None
    for p1_t, p2_t, par_in in _bt_probes(maprob, p1, p2):
        sol = _probe_newton(inner, x_in, par_in, contparams)
        if sol is None:
            continue
        x_flat = ravel(sol.u)[0]
        if basis is not None:
            q0b, q1b, p0b, p1b = basis
            Jd = _jd(inner, sol.u, par_in)
            Jq = torch.stack([Jd(q0b), Jd(q1b)])
            A2 = torch.stack([Jq @ p0b, Jq @ p1b]).cpu().numpy()
            w2, v2 = np.linalg.eig(A2)
            icx = np.where(w2.imag > 1e-10)[0]
            if len(icx) == 0:
                continue
            lam = w2[icx[0]]
            if abs(lam.real) > 0.5 * abs(lam.imag):
                continue
            c = v2[:, icx[0]]
            zeta = (complex(c[0]) * q0b + complex(c[1]) * q1b).cpu().numpy()
            zeta = zeta / np.linalg.norm(zeta)
            vals = np.array([lam, np.conj(lam)])
            vecs = np.stack([zeta, np.conj(zeta)], axis=1)
            i0 = 0
        else:
            X_try = torch.cat([x_flat, _p_tensor(p1_t, x_flat).reshape(1)])
            par_try = maprob.lens.set(dict(maprob.params), p2_t)
            vals, vecs, _ = _iter_spectrum_at(maprob, X_try, par_try,
                                              nev=nev)
            cand = np.where(vals.imag > 1e-8)[0]
            if len(cand) == 0:
                continue
            i0 = int(cand[np.argmin(np.abs(vals.real[cand]))])
            lam = vals[i0]
            if abs(lam.real) > 0.5 * abs(lam.imag):
                continue             # complexified but not near a Hopf yet
        shim = _point_shim(inner.re_make(u0=sol.u, params=par_in), "hopf",
                           p1_t, sol.u, eigenvals=vals, eigenvecs=vecs,
                           ind_ev=i0 + 1)
        try:
            out = continuation_hopf_mf(shim, 0, lens2, contparams, **kwargs)
        except RuntimeError as err:
            last_err = err
            continue
        if _collapsed(out):
            last_err = RuntimeError("collapsed onto omega = 0")
            continue
        return out
    raise RuntimeError(f"bt -> hopf probing failed around (p1, p2) = "
                       f"({p1}, {p2})"
                       + (f" (last: {last_err})" if last_err else ""))


def switch_codim2_mf(br_c2, ind: int, contparams: ContinuationPar,
                     to: Optional[str] = None, nev: int = 10,
                     **kwargs) -> Branch:
    """Start the OTHER matrix-free codim-2 curve from a codim-2 point of a
    matrix-free MA curve (ref the jacobian_ma-generic dispatch,
    src/codim2/codim2.jl:400-560):

      zh on a fold curve    -> the Hopf curve through the same point
      zh/bt on a Hopf curve -> the fold curve through the point
      hh on a Hopf curve    -> the OTHER Hopf curve (second frequency)
      bt on a fold curve    -> the Hopf curve, by the two-sided probe

    The target eigenpair comes from the point's saved iterative spectrum
    when it has one, else from Arnoldi on the inner operator; nothing
    materialises a matrix."""
    import warnings

    from .minaug import _point_shim, _switch_target

    gamma = br_c2.gamma if isinstance(br_c2, Branch) else br_c2
    sp = gamma.specialpoint[ind]
    maprob = gamma.prob
    if not getattr(maprob, "ma_mf", False):
        raise ValueError("switch_codim2_mf needs a matrix-free MA curve")
    n = maprob.n_inner
    X = torch.as_tensor(sp.x)
    p1, p2 = float(X[n]), float(sp.param)
    omega_cur = float(X[n + 1]) if maprob.ma_kind == "hopf" else None
    to = _switch_target(sp, maprob.ma_kind, to)
    lens2 = maprob.outer_lens
    if to == "hopf" and sp.type == "bt":
        return _bt_to_hopf_probe_mf(maprob, sp, contparams, lens2, nev=nev,
                                    **kwargs)

    # the inner problem anchored at the point (p2 frozen into params); the
    # state shape is the same, so re_make keeps `spectral_precond`
    par_full = maprob.lens.set(dict(maprob.params), p2)
    x_in = maprob.unravel_inner(X[:n])
    prob2 = maprob.inner_prob.re_make(
        u0=x_in, params=maprob.inner_lens.set(par_full["_inner"], p1))

    vals = None if sp.eigenvals is None else np.asarray(sp.eigenvals)
    vecs = sp.eigenvecs
    if vals is None or (to == "hopf" and vecs is None):
        vals, vecs, cv = _iter_spectrum_at(maprob, X, par_full, nev=nev)
        if not cv:
            warnings.warn("iterative spectrum at the switch point did not "
                          "fully converge; the anchors' bootstrap inverse "
                          "iteration refines them", RuntimeWarning)
    if to == "fold":
        # the fold eigenvalue: smallest |lambda| among the near-real ones
        realish = np.where(np.abs(vals.imag) < 1e-6)[0]
        eig = {}
        if len(realish):
            i0 = int(realish[np.argmin(np.abs(vals[realish]))])
            eig = dict(eigenvals=vals, ind_ev=i0 + 1)
            if vecs is not None:
                eig["eigenvecs"] = vecs
        return continuation_fold_mf(_point_shim(prob2, "fold", p1, x_in,
                                                **eig),
                                    0, lens2, contparams, **kwargs)
    cand = np.where(vals.imag > 1e-10)[0]
    if len(cand) == 0:
        raise RuntimeError("no complex pair in the iterative spectrum at "
                           "the switch point (raise nev)")
    if sp.type == "hh" and omega_cur is not None:
        # at an HH both pairs sit on the axis: the target is the pair
        # FARTHEST in frequency from the current curve's omega
        i0 = cand[np.argmax(np.abs(vals[cand].imag - abs(omega_cur)))]
    else:
        i0 = cand[np.argmin(np.abs(vals.real[cand]))]
    return continuation_hopf_mf(
        _point_shim(prob2, "hopf", p1, x_in, eigenvals=vals, eigenvecs=vecs,
                    ind_ev=int(i0) + 1), 0, lens2, contparams, **kwargs)
