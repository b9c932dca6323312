"""Bordered linear solvers — the port of `jl_tpu/linalg/bordered.py`
(ref src/LinearBorderSolver.jl).

Solve the (N+1) x (N+1) block system

    | shift*I + J    dR  | |dX|   |R|
    | xi_u * dzu^T  xi_p*dzp | |dl| = |n|

* `BorderingBLS` — Govaerts' block elimination BEC + k iterative refinement
  (ref src/LinearBorderSolver.jl:59-166).
* `MatrixBLS`   — assemble the dense (N+1)^2 matrix and solve directly
  (ref src/LinearBorderSolver.jl:217-264).
* `MatrixFreeBLS` — Krylov on the extended operator acting on
  BorderedState(u, p) (ref src/LinearBorderSolver.jl:299-450).

All return `(dX, dl, converged, n_iter)`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.state import (BorderedState, check_partition, ravel, tree_add,
                          tree_axpy, tree_norm, tree_size, tree_sub,
                          tree_vdot)
from .linear import DenseLS, GMRES, apply_J, dense_solve, is_operator


def _default_dotp(x, y):
    """Normalized dot used by PALC (ref `NormalisedDot`, Palc.jl:1-5)."""
    return torch.real(tree_vdot(x, y)) / tree_size(x)


@dataclasses.dataclass(frozen=True)
class BorderingBLS:
    """Block-elimination bordered solver BEC+k (Govaerts 1991;
    ref src/LinearBorderSolver.jl:59-166)."""

    solver: Any = dataclasses.field(default_factory=DenseLS)
    tol: float = 1e-12
    check_precision: bool = True
    k: int = 1

    def __call__(self, J, dR, dzu, dzp, R, n, xi_u=1.0, xi_p=1.0,
                 shift=None, dotp: Callable = _default_dotp):
        def bec(Rb, nb):
            return _bec_step(self.solver, J, dR, dzu, dzp, Rb, nb,
                             xi_u, xi_p, shift, dotp)

        dX, dl, cv, itl = bec(R, n)

        # BEC + k refinement (ref while loop at
        # src/LinearBorderSolver.jl:118-130): a pass whose residual already
        # meets tol costs one matvec, not two solves
        if self.check_precision:
            for _ in range(self.k):
                dres_X, dres_l = _bec_residual(J, dR, dzu, dzp, R, n, dX, dl,
                                               xi_u, xi_p, shift, dotp)
                if (float(tree_norm(dres_X)) > self.tol
                        or abs(float(dres_l)) > self.tol):
                    dX1, dl1, _, _ = bec(dres_X, dres_l)
                    dX = tree_add(dX, dX1)
                    dl = dl + dl1
        return dX, dl, cv, itl


def _bec_step(solver, J, dR, dzu, dzp, R, n, xi_u, xi_p, shift, dotp):
    a0 = 0.0 if shift is None else shift
    if hasattr(solver, "solve_two") and shift is None:
        x1, x2, cv, itl = solver.solve_two(J, R, dR)
        itl = itl[0] + itl[1]
    else:
        x1, cv1, it1 = solver(J, R, a0=a0)
        x2, cv2, it2 = solver(J, dR, a0=a0)
        cv = bool(cv1) and bool(cv2)
        itl = it1 + it2
    dl = (n - dotp(dzu, x1) * xi_u) / (dzp * xi_p - dotp(dzu, x2) * xi_u)
    dX = tree_axpy(-dl, x2, x1)
    return dX, dl, cv, itl


def _bec_residual(J, dR, dzu, dzp, R, n, dX, dl, xi_u, xi_p, shift, dotp):
    JdX = apply_J(J, dX)
    if shift is not None:
        JdX = tree_axpy(shift, dX, JdX)
    top = tree_sub(R, tree_axpy(dl, dR, JdX))
    bot = n - xi_p * dzp * dl - xi_u * dotp(dzu, dX)
    return top, bot


@dataclasses.dataclass(frozen=True)
class MatrixBLS:
    """Assemble the extended (N+1) x (N+1) matrix and solve dense
    (ref src/LinearBorderSolver.jl:217-264)."""

    solver: Any = dataclasses.field(default_factory=DenseLS)

    def __call__(self, J, dR, dzu, dzp, R, n, xi_u=1.0, xi_p=1.0,
                 shift=None, dotp: Callable = _default_dotp):
        check_partition(False, "MatrixBLS")
        if is_operator(J):
            raise TypeError("MatrixBLS needs a dense matrix jacobian; use "
                            "BorderingBLS or MatrixFreeBLS for operators")
        dR_flat, _ = ravel(dR)
        dzu_flat, _ = ravel(dzu)
        R_flat, unravel = ravel(R)
        N = J.shape[0]
        eye = torch.eye(N, dtype=J.dtype, device=J.device)
        A = J if shift is None else J + shift * eye
        # the xi_u row reproduces xi_u * dotp(dzu, .); with the default
        # normalized dot that is xi_u / N * dzu^T
        norm_factor = _dotp_row_scale(dotp, dzu, N)
        corner = torch.as_tensor(xi_p * dzp, dtype=J.dtype, device=J.device)
        bottom = torch.cat([xi_u * norm_factor * dzu_flat, corner.reshape(1)])
        top = torch.cat([A, dR_flat[:, None]], dim=1)
        Aext = torch.cat([top, bottom[None, :]], dim=0)
        rhs = torch.cat([R_flat, torch.as_tensor(
            n, dtype=J.dtype, device=J.device).reshape(1)])
        sol, cv, itl = self.solver(Aext, rhs)
        return unravel(sol[:N]), sol[N], cv, itl


def _dotp_row_scale(dotp, dzu, N):
    """The row scaling s with dotp(dzu, x) = s * dzu^T x (exact for the
    standard and normalized dots, the only linear ones used)."""
    if dotp is _default_dotp:
        return 1.0 / N
    flat, _ = ravel(dzu)
    denom = torch.dot(flat, flat)
    return torch.real(dotp(dzu, dzu)) / torch.where(
        denom == 0, torch.ones_like(denom), denom)


@dataclasses.dataclass(frozen=True)
class MatrixFreeBLS:
    """Krylov solve of the extended operator on BorderedState
    (ref src/LinearBorderSolver.jl:299-450)."""

    solver: Any = dataclasses.field(
        default_factory=lambda: GMRES(restart=50, maxiter=500, rtol=1e-10))

    def __call__(self, J, dR, dzu, dzp, R, n, xi_u=1.0, xi_p=1.0,
                 shift=None, dotp: Callable = _default_dotp):
        def ext_op(z: BorderedState):
            Ju = apply_J(J, z.u)
            if shift is not None:
                Ju = tree_axpy(shift, z.u, Ju)
            top = tree_axpy(z.p, dR, Ju)
            bot = xi_u * dotp(dzu, z.u) + xi_p * dzp * z.p
            return BorderedState(u=top, p=bot)

        like = ravel(R)[0]
        rhs = BorderedState(u=R, p=torch.as_tensor(
            n, dtype=like.dtype, device=like.device))
        sol, cv, itl = self.solver(ext_op, rhs)
        return sol.u, sol.p, cv, itl


def solve_bls_block(solver, J, C, D, E, R, s, shift=None):
    """Explicit k-border block elimination (ref solve_bls_block,
    src/LinearBorderSolver.jl:173-206,272-285):

        [ J   C ] [x]   [R]     J: N x N (any solver-compatible form),
        [ D   E ] [y] = [s]     C: (N, k) columns, D: (k, N) rows, E: k x k.

    x1 = J\\R and X2 = J\\C are k+1 independent solves (one after the
    other here; the JAX package vmaps them), then the k x k Schur
    complement closes the system.  Returns (x, y, converged, n_iter)."""
    check_partition(False, "solve_bls_block")
    R_flat, unravel = ravel(R)
    kw = {} if shift is None else {"a0": shift}
    sols, cvs, its = [], [], []
    for b in torch.cat([R_flat[None, :], C.T], dim=0):
        sol, cv, it = solver(J, unravel(b), **kw)
        sols.append(ravel(sol)[0])
        cvs.append(bool(cv))
        its.append(int(it))
    x1 = sols[0]
    X2 = torch.stack(sols[1:], dim=1)                          # (N, k)
    Schur = E - D @ X2
    y = dense_solve(Schur, s - D @ x1)
    x = x1 - X2 @ y
    return unravel(x), y, all(cvs), sum(its)


@dataclasses.dataclass(frozen=True)
class LSFromBLS:
    """A bordered solver used as a plain (N+1)-dim linear solver
    (ref `LSFromBLS`, src/LinearBorderSolver.jl:468-488)."""

    bls: Any = dataclasses.field(default_factory=BorderingBLS)

    def __call__(self, A, rhs, a0=0.0, a1=1.0):
        check_partition(False, "LSFromBLS")
        # split A = [[J, b], [c^T, d]] and rhs = [R; n]
        J = A[:-1, :-1]
        b = A[:-1, -1]
        c = A[-1, :-1]
        d = A[-1, -1]
        dX, dl, cv, itl = self.bls(
            J, b, c, d, rhs[:-1], rhs[-1], 1.0, 1.0,
            dotp=lambda x, y: torch.dot(x, y))
        return torch.cat([dX, dl.reshape(1)]), cv, itl
