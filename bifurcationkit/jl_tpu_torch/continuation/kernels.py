"""Per-step kernels for the continuation engine — the port of
`jl_tpu/continuation/kernels.py`.

Each kernel is a Python function over device tensors: the Newton and PALC
corrector loops read one residual norm on the host per iteration (the JAX
package's `lax.while_loop`s), the predictor, tangent and eigensolve stay
on the device.  The host engine orchestrates step-size control, detection,
bisection and recording on scalars (ref control flow:
src/Continuation.jl:349-504).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from types import SimpleNamespace
from typing import Callable

import torch

from ..core.params import ContinuationPar
from ..core.state import (BorderedState, DotTheta, check_partition, ravel,
                          tree_axpy, tree_map, tree_norm, tree_scale,
                          tree_sub, tree_vdot, tree_zeros_like)
from ..linalg.bordered import BorderingBLS
from ..linalg.eig import (ArnoldiEig, DenseEig, FlatOperator, LOBPCGEig,
                          ShiftInvertEig)
from ..linalg.linear import DenseLS, IterativeRefinement, PairedOperator
from .algorithms import MoorePenrose, MoorePenroseLS


def default_bls(alg, newton_opts):
    """Choose/complete the bordered linear solver: inject the Newton linear
    solver (ref `update(alg, contParams, linear_algo)`, Palc.jl:100-110)."""
    bls = getattr(alg, "bls", None)
    if bls is None:
        return BorderingBLS(solver=newton_opts.linsolver)
    if getattr(bls, "solver", "missing") is None:
        return dataclasses.replace(bls, solver=newton_opts.linsolver)
    return bls


def _cast_floats(tree, dt):
    return tree_map(
        lambda a: a.to(dt) if (isinstance(a, torch.Tensor)
                               and a.is_floating_point()) else a, tree)


def _flat_op(prob, u, par, out_dtype=None) -> FlatOperator:
    """J(u, par) as a flat-vector operator; its block form applies J to a
    (k, n) block of rows in one call through the model's `jac_op` (which
    takes a batch), or through `torch.func.vmap` when J is the jvp of F."""
    flat0, unravel = ravel(u)
    n = flat0.shape[0]
    J = prob.jacobian_operator(u, par)

    def op(v):
        # keep the pipeline at the requested dtype even if the model embeds
        # f64 constants that would promote internally
        if out_dtype is not None:
            v = v.to(out_dtype)
        of = ravel(J(unravel(v)))[0]
        return of if out_dtype is None else of.to(out_dtype)

    if prob.jac_op is not None:
        shape = tuple(u.shape)

        def block(X):
            if out_dtype is not None:
                X = X.to(out_dtype)
            return J(X.reshape((X.shape[0],) + shape)).reshape(X.shape[0], n)
    else:
        block = torch.func.vmap(op)
    return FlatOperator(op, n, out_dtype or flat0.dtype, flat0.device, block)


def _pick_jac(prob, linsolver):
    if isinstance(linsolver, DenseLS) or getattr(linsolver, "needs_matrix",
                                                 False):
        return prob.jacobian
    if isinstance(linsolver, IterativeRefinement):
        # problems whose jac_op already returns a PairedOperator (the
        # matrix-free minimally augmented functionals) bring their own low
        # twin; one built here would re-enter their sigma solves at cast
        # primals
        if getattr(prob, "jac_op_paired", False):
            return prob.jacobian_operator
        # mixed-precision refinement: pair the accurate operator with a
        # twin built at cast (low-precision) primals, so the inner Krylov
        # runs natively at that precision (the SH kernel's f32 instance)
        lo = linsolver.low_dtype

        def jac(x, par):
            low = _flat_op(prob, _cast_floats(x, lo), _cast_floats(par, lo),
                           out_dtype=lo)
            return PairedOperator(prob.jacobian_operator(x, par), low)

        return jac
    return prob.jacobian_operator


def make_kernels(prob, alg, contparams: ContinuationPar,
                 norm: Callable = tree_norm, dot_theta: DotTheta = None,
                 callback: Callable = None, nev: int = None):
    """Build the step kernels for one (problem, algorithm, options) triple.
    `nev` overrides contparams.nev (the engine rebuilds with a larger
    request when a branch destabilizes in more directions than the current
    spectrum window; ref src/Utils.jl:67-105)."""
    nopts = contparams.newton_options
    theta = float(getattr(alg, "theta", 0.5))
    dot_t = dot_theta or DotTheta()
    like = ravel(prob.u0)[0]
    # a row-partitioned problem (`parallel/models.py`) holds one rank's
    # block in u0 and the whole state's size in `n_global`; its kernels run
    # inside `parallel.use_mesh`, every other problem's outside it
    n_global = getattr(prob, "n_global", None)
    n_state = like.numel() if n_global is None else n_global
    bls = default_bls(alg, nopts)
    jac = _pick_jac(prob, nopts.linsolver)
    p_min, p_max = contparams.p_min, contparams.p_max

    def scoped(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            check_partition(n_global is not None,
                            "the continuation kernels of this problem")
            return fn(*args, **kwargs)
        return run

    def as_p(x):
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)

    def dotp(x, y):
        d = torch.real(tree_vdot(x, y))
        return d / n_state if dot_t.normalize else d

    def set_p(params, p):
        return prob.set_lens_param(params, p)

    # ------------------------------------------------------------------
    # plain Newton at fixed parameter (init & Natural corrector)
    # ------------------------------------------------------------------
    def newton_fixed(u, p, params):
        par = set_p(params, p)
        ls = nopts.linsolver
        x = u
        rf = prob.residual(x, par)
        r = float(norm(rf))
        k, itl, keep = 0, 0, True
        while r > nopts.tol and k < nopts.max_iterations and keep:
            du, _, itlin = ls(jac(x, par), rf)
            if nopts.linesearch:
                # Armijo halving (ref the linesearch branch of _newton,
                # src/Newton.jl): halve the damping until the residual
                # decreases (or alpha_min); accept the last trial otherwise
                alpha = nopts.alpha
                xa = tree_axpy(-alpha, du, x)
                rfa = prob.residual(xa, par)
                ra = float(norm(rfa))
                while ra >= r and alpha > nopts.alpha_min:
                    alpha *= 0.5
                    xa = tree_axpy(-alpha, du, x)
                    rfa = prob.residual(xa, par)
                    ra = float(norm(rfa))
                x, rf, r = xa, rfa, ra
            else:
                x = tree_sub(x, du)
                rf = prob.residual(x, par)
                r = float(norm(rf))
            if callback is not None:
                keep = bool(callback({"x": x, "residual": rf,
                                      "residual_norm": r, "p": p,
                                      "step": k + 1}))
            k += 1
            itl += int(itlin)
        return x, r <= nopts.tol, k, itl, r

    # ------------------------------------------------------------------
    # PALC bordered-Newton corrector (ref newton_palc, Palc.jl:187-305)
    # ------------------------------------------------------------------
    def palc_corrector(z_pred: BorderedState, z0: BorderedState,
                       tau: BorderedState, ds, params,
                       decay_alpha=math.inf):
        """decay_alpha < inf aborts Newton early unless the residual decays
        by that factor each iteration — the pmcont predictor-acceptance
        criterion (ref the Multiple callback, Multiple.jl:52-65)."""
        def full_res(u, p):
            rf = prob.residual(u, set_p(params, p))
            # theta <u - z0.u, tau.u>/n + (1-theta)(p - z0.p) tau.p - ds
            rn = (dotp(tree_sub(u, z0.u), tau.u) * theta
                  + (p - z0.p) * tau.p * (1.0 - theta) - ds)
            return rf, rn, float(torch.maximum(norm(rf), torch.abs(rn)))

        u, p = z_pred.u, as_p(z_pred.p)
        rf, rn, r = full_res(u, p)
        k, itl, ok, r_prev = 0, 0, True, r
        while r > nopts.tol and k < nopts.max_iterations and ok \
                and (k < 1 or r <= decay_alpha * r_prev):
            par = set_p(params, p)
            dFdp = prob.dFdp(u, par)
            du, dp, _, itlin = bls(jac(u, par), dFdp, tau.u, tau.p, rf, rn,
                                   theta, 1.0 - theta, dotp=dotp)
            u = tree_sub(u, du)
            p = torch.clamp(p - dp, p_min, p_max)
            r_prev = r
            rf, rn, r = full_res(u, p)
            if callback is not None:
                ok = bool(callback({"x": u, "residual": rf,
                                    "residual_norm": r, "p": p,
                                    "step": k + 1}))
            k += 1
            itl += int(itlin)
        return BorderedState(u=u, p=p), r <= nopts.tol, k, itl, r

    # ------------------------------------------------------------------
    # Moore-Penrose corrector (ref newton_moore_penrose, MoorePenrose.jl:129)
    # Gauss-Newton on the extended system with the tangent as the extra row;
    # the tangent itself is updated from the bordered solve each iteration.
    # ------------------------------------------------------------------
    def res_only(u, p, params):
        rf = prob.residual(u, set_p(params, p))
        return rf, float(norm(rf))

    def mp_corrector(z_pred: BorderedState, z0: BorderedState,
                     tau0: BorderedState, ds, params):
        u, p, tu, tp = z_pred.u, as_p(z_pred.p), tau0.u, as_p(tau0.p)
        rf, r = res_only(u, p, params)
        k, itl = 0, 0
        while r > nopts.tol and k < nopts.max_iterations:
            par = set_p(params, p)
            dFdp = prob.dFdp(u, par)
            J = jac(u, par)
            # solve [J dFdp; tau'][du; dp] = [rf; 0]
            du, dp, _, itlin = bls(J, dFdp, tu, tp, rf, as_p(0.0), theta,
                                   1.0 - theta, dotp=dotp)
            # update tangent: solve [J dFdp; tau'][tu'; tp'] = [0; 1]
            ntu, ntp, _, _ = bls(J, dFdp, tu, tp, tree_zeros_like(u),
                                 as_p(1.0), theta, 1.0 - theta, dotp=dotp)
            nrm = torch.sqrt(dotp(ntu, ntu) * theta
                             + ntp * ntp * (1.0 - theta))
            tu, tp = tree_scale(ntu, 1.0 / nrm), ntp / nrm
            u = tree_sub(u, du)
            p = torch.clamp(p - dp, p_min, p_max)
            rf, r = res_only(u, p, params)
            k += 1
            itl += int(itlin)
        return (BorderedState(u=u, p=p), BorderedState(u=tu, p=tp),
                r <= nopts.tol, k, itl, r)

    if isinstance(alg, MoorePenrose) and alg.method == MoorePenroseLS.pInv:
        def mp_corrector(z_pred: BorderedState, z0: BorderedState,  # noqa: F811
                         tau0: BorderedState, ds, params):
            """pInv mode: least-norm update dz = pinv([J dFdp]) @ rf and
            tangent = theta-normalized projection of the previous tangent
            onto null([J dFdp]) (ref MoorePenrose pInv,
            src/continuation/MoorePenrose.jl:23-127).  Requires a flat
            tensor state and a dense jacobian."""
            u, p = z_pred.u, as_p(z_pred.p)
            t = torch.cat([tau0.u, as_p(tau0.p).reshape(1)])
            rf, r = res_only(u, p, params)
            k = 0
            while r > nopts.tol and k < nopts.max_iterations:
                par = set_p(params, p)
                G = torch.cat([jac(u, par), prob.dFdp(u, par)[:, None]],
                              dim=1)                        # (n, n+1)
                Gp = torch.linalg.pinv(G)
                dz = Gp @ rf
                u = u - dz[:-1]
                p = torch.clamp(p - dz[-1], p_min, p_max)
                t = t - Gp @ (G @ t)           # project onto null(G)
                t = t / torch.sqrt(dotp(t[:-1], t[:-1]) * theta
                                   + t[-1] ** 2 * (1.0 - theta))
                rf, r = res_only(u, p, params)
                k += 1
            return (BorderedState(u=u, p=p), BorderedState(u=t[:-1], p=t[-1]),
                    r <= nopts.tol, k, k, r)

    # ------------------------------------------------------------------
    # tangents
    # ------------------------------------------------------------------
    def secant_tangent(z_new: BorderedState, z_old: BorderedState, ds):
        d = tree_sub(z_new, z_old)
        nrm = dot_t.norm_bs(d, theta, n_state)
        alpha = math.copysign(1.0, ds) / torch.clamp_min(
            nrm, torch.finfo(nrm.dtype).tiny)
        return BorderedState(u=tree_scale(d.u, alpha), p=d.p * alpha)

    def bordered_tangent(z: BorderedState, tau_prev: BorderedState, params):
        par = set_p(params, z.p)
        dFdp = prob.dFdp(z.u, par)
        tu, tp, _, _ = bls(jac(z.u, par), dFdp, tau_prev.u, tau_prev.p,
                           tree_zeros_like(z.u), as_p(1.0),
                           theta, 1.0 - theta, dotp=dotp)
        nrm = torch.sqrt(dotp(tu, tu) * theta + tp * tp * (1.0 - theta))
        orient = torch.sign(dotp(tau_prev.u, tu) * theta
                            + tau_prev.p * tp * (1.0 - theta))
        alpha = orient / torch.clamp_min(nrm, torch.finfo(nrm.dtype).tiny)
        return BorderedState(u=tree_scale(tu, alpha), p=tp * alpha)

    # ------------------------------------------------------------------
    # eigen-elements (ref compute_eigenvalues, src/Utils.jl:67-105)
    # ------------------------------------------------------------------
    eigsolver = nopts.eigsolver
    nev = min(contparams.nev if nev is None else nev, n_state)
    eigsolver = _widen_eigsolver(eigsolver, nev)
    # dense-matrix eigensolvers get jacfwd; iterative ones an operator
    eig_needs_matrix = (isinstance(eigsolver, DenseEig)
                        or (isinstance(eigsolver, ShiftInvertEig)
                            and eigsolver.linsolver is None))
    # reduced-precision stability sweep: the J.v operator is built at the
    # eigensolver's compute_dtype (the SH kernel's f32 instance); Newton /
    # PALC residuals are untouched
    eig_dtype = getattr(eigsolver, "compute_dtype", None)
    # warm starts from the previous step (the spectrum moves little along
    # a branch): LOBPCG from the eigenvector block, Arnoldi-family solvers
    # from one recombined Ritz direction, so a warm solve usually converges
    # in one factorization
    eig_accepts_v0 = (isinstance(eigsolver, (ArnoldiEig, ShiftInvertEig,
                                             LOBPCGEig))
                      or bool(getattr(eigsolver, "accepts_v0", False)))
    seed_dtype = eig_dtype or like.dtype
    _seed_cols_fn = getattr(eigsolver, "seed_cols", None)
    n_seed_cols = _seed_cols_fn(nev) if callable(_seed_cols_fn) else None
    # augmented (codim-2) problems give the spectrum-defining inner
    # jacobian separately, on the inner state without the border rows
    # (ref FoldEig stripping the border, src/codim2/MinAugFold.jl:579-601);
    # a Floquet monodromy acts on the vector field's n_vf dof
    eig_jac = getattr(prob, "eig_jacobian", None)
    # the seed holds this rank's entries of the state
    n_eig = (getattr(prob, "n_vf", None) or getattr(prob, "n_inner", None)
             or n_state) if eig_jac else like.numel()
    seed_shape = (n_eig, n_seed_cols) if n_seed_cols else (n_eig,)
    # the symmetry probe costs two matvecs and a sync: run it on the first
    # sweep only (the JAX package skips it inside its jitted step)
    probe = {"pending": bool(getattr(eigsolver, "symmetry_check", False))}
    # two-stage eig of structured-jacobian Floquet solvers (FloquetColl):
    # the device reduces the blocks to a small (n, n) product, the host
    # eigensolves it in numpy f64 (JAX kernels.py:385-489)
    eig_host_split = (bool(getattr(prob, "eig_two_stage", False))
                      and eig_jac is not None
                      and callable(getattr(eigsolver, "device_reduce", None))
                      and callable(getattr(eigsolver, "host_eig", None)))

    def eig(u, p, params, eig_seed=None):
        """Host-facing eig: numpy complex eigenvalues, the eigenvector
        block (device, or None unless saved), the converged flag and the
        device-side warm-start seed for the next call."""
        if eig_seed is not None and tuple(eig_seed.shape) != seed_shape:
            eig_seed = None          # shape change = nev was auto-raised
        par = set_p(params, p)
        J_hi = None
        if eig_host_split:
            reduced = eigsolver.device_reduce(eig_jac(u, par))
            vals, vecs, cv, _ = eigsolver.host_eig(
                *reduced, nev, with_vectors=contparams.save_eigenvectors)
            if vecs is not None:
                vecs = torch.as_tensor(vecs, device=like.device)
            return vals, vecs, bool(cv), eig_seed
        if eig_jac is not None:
            J = eig_jac(u, par)
        elif eig_needs_matrix:
            J = prob.jacobian(u, par)
        elif eig_dtype is not None:
            J = _flat_op(prob, _cast_floats(u, eig_dtype),
                         _cast_floats(par, eig_dtype), out_dtype=eig_dtype)
            # mixed-precision LOBPCG refines its reduced-precision subspace
            # on the full-precision operator (eig.py::_refine)
            if getattr(eigsolver, "refine_iters", 0) > 0:
                J_hi = _flat_op(prob, u, par)
        else:
            J = _flat_op(prob, u, par)
        solver = eigsolver
        if probe["pending"]:
            probe["pending"] = False
        elif getattr(eigsolver, "symmetry_check", False):
            solver = dataclasses.replace(eigsolver, symmetry_check=False)
        if J_hi is not None:
            vals, vecs, cv, _ = solver(J, nev, v0=eig_seed, J_hi=J_hi)
        elif eig_accepts_v0:
            vals, vecs, cv, _ = solver(J, nev, v0=eig_seed)
        else:
            vals, vecs, cv, _ = solver(J, nev)
        seed_new = eig_seed
        if eig_accepts_v0 and vecs is not None:
            if n_seed_cols:
                mk = getattr(solver, "make_seed", None)
                blk = (mk(vecs, n_seed_cols) if callable(mk)
                       else torch.real(vecs[:, :n_seed_cols])).to(seed_dtype)
                pad = n_seed_cols - blk.shape[1]
                if pad > 0:
                    blk = torch.nn.functional.pad(blk, (0, pad))
                seed_new = blk
            else:
                seed_new = torch.real(torch.sum(vecs, dim=1)).to(seed_dtype)
        if not contparams.save_eigenvectors:
            vecs = None
        return vals.cpu().numpy(), vecs, bool(cv), seed_new

    # ------------------------------------------------------------------
    # full PALC step: predictor + corrector + secant tangent + eig
    # ------------------------------------------------------------------
    def palc_step(z: BorderedState, tau: BorderedState, ds, params,
                  eig_seed=None):
        """Returns (z_acc, tau_acc, converged, itnewton, itlinear, res,
        eigvals, eigvecs, converged_eig, eig_seed).  On a failed corrector
        z_acc, tau_acc are the old z, tau; the eigensolve runs on the
        accepted point either way and refreshes the seed, as the JAX
        package's fused step does."""
        z_pred = BorderedState(u=tree_axpy(ds, tau.u, z.u),
                               p=z.p + ds * tau.p)
        z_new, cv, itn, itl, res = palc_corrector(z_pred, z, tau, ds, params)
        z_acc, tau_acc = z, tau
        if cv:
            z_acc, tau_acc = z_new, secant_tangent(z_new, z, ds)
        vals, vecs, cv_eig, seed = None, None, True, eig_seed
        if contparams.compute_eigenelements:
            vals, vecs, cv_eig, seed = eig(z_acc.u, z_acc.p, params,
                                           eig_seed)
        return z_acc, tau_acc, cv, itn, itl, res, vals, vecs, cv_eig, seed

    return SimpleNamespace(
        newton_fixed=scoped(newton_fixed),
        palc_corrector=scoped(palc_corrector),
        mp_corrector=scoped(mp_corrector),
        palc_step=scoped(palc_step),
        secant_tangent=scoped(secant_tangent),
        bordered_tangent=scoped(bordered_tangent),
        eig=scoped(eig),
        as_p=as_p,
        n_state=n_state,
        nev=nev,
        theta=theta,
        is_floquet=getattr(eigsolver, "is_floquet", False),
    )


def _widen_eigsolver(eig, nev):
    """Make an Arnoldi solver's Krylov space large enough to hold `nev`
    converged Ritz pairs (needed once the engine auto-raises nev), also
    inside a wrapper such as `ShiftInvertEig`."""
    if isinstance(eig, ArnoldiEig) and eig.krylov_dim < nev + 8:
        return dataclasses.replace(eig, krylov_dim=nev + 12)
    inner = getattr(eig, "eigsolver", None)
    if inner is not None:
        widened = _widen_eigsolver(inner, nev)
        if widened is not inner:
            return dataclasses.replace(eig, eigsolver=widened)
    return eig
