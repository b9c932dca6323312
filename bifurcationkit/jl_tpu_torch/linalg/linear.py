"""Linear solvers — the port of `jl_tpu/linalg/linear.py`
(ref src/LinearSolver.jl:8-414).

A linear solver is a frozen-dataclass callable

    ls(J, rhs, a0=0.0, a1=1.0) -> (sol, converged, n_iter)

solving ``(a0 * I + a1 * J) x = rhs`` (`converged` a Python bool, `n_iter`
a Python int); ``J`` is a dense 2-D tensor or any callable ``v -> J @ v``
on states.  The JAX package's `lax.while_loop`s are Python loops here:
each Krylov iteration reads its residual estimate on the host (one device
sync per iteration), and the small Hessenberg least-squares runs on the
host in the working dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.state import (BorderedState, check_partition, global_bdot,
                          global_dot, global_norm, global_row_norms,
                          global_size, ravel, tree_axpby)


# ---------------------------------------------------------------------------
# Operator utilities
# ---------------------------------------------------------------------------


def is_operator(J) -> bool:
    return callable(J) and not isinstance(J, torch.Tensor)


def apply_J(J, v):
    """Apply a jacobian representation (matrix or callable) to state v."""
    if is_operator(J):
        return J(v)
    flat, unravel = ravel(v)
    return unravel(J @ flat)


def shifted_apply(J, v, a0, a1):
    """(a0 I + a1 J) v   (ref `_axpy_op`, src/LinearSolver.jl:55-76)."""
    return tree_axpby(a0, v, a1, apply_J(J, v))


def materialize_shift(J: torch.Tensor, a0, a1) -> torch.Tensor:
    if a0 == 0 and a1 == 1:
        return J
    return a1 * J + a0 * torch.eye(J.shape[0], dtype=J.dtype, device=J.device)


# ---------------------------------------------------------------------------
# Dense direct solver
# ---------------------------------------------------------------------------


def dense_factor(A):
    """LU handle for repeated solves."""
    return torch.linalg.lu_factor(A)


def dense_factor_solve(fac, b):
    LU, piv = fac
    return torch.linalg.lu_solve(LU, piv, b.unsqueeze(-1)).squeeze(-1)


def dense_solve(A, b):
    return dense_factor_solve(dense_factor(A), b)


@dataclasses.dataclass(frozen=True)
class DenseLS:
    """Direct dense solve via LU (ref `DefaultLS`, src/LinearSolver.jl:94-117)."""

    def __call__(self, J, rhs, a0=0.0, a1=1.0):
        check_partition(False, "DenseLS")
        A = materialize_shift(J, a0, a1)
        flat, unravel = ravel(rhs)
        return unravel(dense_solve(A, flat)), True, 1

    def solve_two(self, J, r1, r2, a0=0.0, a1=1.0):
        """Two RHS sharing one factorization (ref src/LinearSolver.jl:119-131)."""
        check_partition(False, "DenseLS")
        A = materialize_shift(J, a0, a1)
        f1, unravel1 = ravel(r1)
        f2, unravel2 = ravel(r2)
        fac = dense_factor(A)
        return (unravel1(dense_factor_solve(fac, f1)),
                unravel2(dense_factor_solve(fac, f2)), True, (1, 1))


# ---------------------------------------------------------------------------
# GMRES
# ---------------------------------------------------------------------------


def _sequential_solve_two(solver, J, r1, r2, a0=0.0, a1=1.0):
    """Two RHS one after the other.  The JAX package vmaps the two lanes;
    a vmapped while_loop freezes a finished lane, so each lane's result
    is the same as this sequential one."""
    s1, c1, i1 = solver(J, r1, a0=a0, a1=a1)
    s2, c2, i2 = solver(J, r2, a0=a0, a1=a1)
    return s1, s2, bool(c1) and bool(c2), (i1, i2)


@dataclasses.dataclass(frozen=True)
class GMRES:
    """Restarted GMRES (CGS2 Arnoldi + Givens least squares) with a
    preallocated `(restart+1, n)` Krylov basis on the device.

    On a row-partitioned state (inside `parallel.use_mesh`) each rank
    holds its block of the raveled vector and every projection, norm and
    size is completed over the ranks.  Entries that every rank holds
    whole (a replicated tail) must count once: `n_rep` names how many of
    the raveled vector's last entries are such a tail, for a plain flat
    vector such as the MA problems' [x; p1] or the extended [v; s]
    (`codim2/minaug_mf.py` sets it); a `BorderedState`'s `p` adds its
    own entries to it.  The same holds for each row of `solve_block`.
    Without a reducer (one device) `n_rep` changes nothing."""

    restart: int = 30
    maxiter: int = 200           # total matvecs bound
    rtol: float = 1e-8
    atol: float = 1e-12
    precond: Optional[Callable] = None   # left preconditioner: v -> M^{-1} v
    n_rep: int = 0               # replicated tail of a partitioned vector

    def __call__(self, J, rhs, a0=0.0, a1=1.0):
        flat_rhs, unravel = ravel(rhs)
        # a bordered state ravels to [u; p]: on a row-partitioned state its
        # p is the same on every rank and enters each reduction once
        n_rep = self.n_rep + (ravel(rhs.p)[0].numel()
                              if isinstance(rhs, BorderedState) else 0)

        def matvec(xf):
            return ravel(shifted_apply(J, unravel(xf), a0, a1))[0]

        if self.precond is not None:
            prec = self.precond

            def matvec_p(xf):
                return ravel(prec(unravel(matvec(xf))))[0]

            pb = ravel(prec(unravel(flat_rhs)))[0]
            sol, res, it = _gmres_flat(matvec_p, pb, self.restart,
                                       self.maxiter, self.rtol, self.atol,
                                       n_rep)
        else:
            sol, res, it = _gmres_flat(matvec, flat_rhs, self.restart,
                                       self.maxiter, self.rtol, self.atol,
                                       n_rep)
        b_norm = float(global_norm(flat_rhs, n_rep))
        converged = res <= max(self.rtol * b_norm, self.atol)
        return unravel(sol), converged, it

    def solve_two(self, J, r1, r2, a0=0.0, a1=1.0):
        return _sequential_solve_two(self, J, r1, r2, a0=a0, a1=a1)

    def solve_block(self, J_block, rhs, a0=0.0, a1=1.0):
        """Solve (a0 I + a1 J) x = rhs for every row of `rhs` (k, n) at
        once (`_gmres_block`).  `J_block` applies J to a (k, n) block of
        flat vectors and the preconditioner must take such a block too.
        Returns (X, converged, n_iter) with one entry per row (numpy)."""
        def matvec(Xb):
            out = J_block(Xb)
            if a0 != 0 or a1 != 1:
                out = a0 * Xb + a1 * out
            return out

        if self.precond is not None:
            prec = self.precond

            def matvec_p(Xb):
                return prec(matvec(Xb))

            X, res, it = _gmres_block(matvec_p, prec(rhs), self.restart,
                                      self.maxiter, self.rtol, self.atol,
                                      self.n_rep)
        else:
            X, res, it = _gmres_block(matvec, rhs, self.restart,
                                      self.maxiter, self.rtol, self.atol,
                                      self.n_rep)
        b_norm = global_row_norms(rhs, self.n_rep).cpu().numpy()
        return X, res <= np.maximum(self.rtol * b_norm, self.atol), it


def _torch_to_np_dtype(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _gmres_flat(matvec, b, restart, maxiter, rtol, atol, n_rep=0):
    """Flat-vector restarted GMRES.  Returns (x, final_resnorm, n_matvec)
    with the JAX package's counting: each cycle costs one residual matvec
    plus one per Arnoldi step.  On a row-partitioned state
    (`parallel.use_mesh`) b is this rank's block and every projection and
    norm is completed over the ranks, b's last `n_rep` entries (the same
    on every rank) counted once."""
    n = b.shape[0]
    dtype = b.dtype
    npdt = _torch_to_np_dtype(dtype)
    # dtype-aware division guard: the f64 habit of 1e-300 underflows to 0
    # in f32, turning the happy breakdown h_{j+1,j} -> 0 into w / 0 = NaN
    tiny = float(torch.finfo(dtype).tiny)
    m = min(restart, global_size(n, n_rep))
    b_norm = float(global_norm(b, n_rep))
    tol = max(rtol * b_norm, atol)

    x = torch.zeros_like(b)
    res, nmv, done = b_norm, 0, b_norm <= tol
    V = torch.empty((m + 1, n), dtype=dtype, device=b.device)
    while not done and nmv < maxiter:
        r = b - matvec(x)
        beta_t = global_norm(r, n_rep)
        beta = float(beta_t)
        V[0] = r / max(beta, tiny) if beta > 0 else r
        # Hessenberg columns after rotation, Givens pairs and the rotated
        # rhs g, all on the host in the working dtype (numpy keeps f32
        # arithmetic in f32, as the JAX package does on the device)
        R = np.zeros((m, m), npdt)
        cs = np.zeros(m, npdt)
        sn = np.zeros(m, npdt)
        g = np.zeros(m + 1, npdt)
        g[0] = npdt(beta)
        res = beta
        j = 0
        while j < m and res > tol:
            w = matvec(V[j])
            # classical Gram-Schmidt with reorthogonalization (CGS2) on the
            # j+1 filled rows of the basis
            Vj = V[:j + 1]
            h1 = global_dot(Vj, w, n_rep)
            w = w - h1 @ Vj
            h2 = global_dot(Vj, w, n_rep)
            w = w - h2 @ Vj
            hlast_t = global_norm(w, n_rep)
            h_host = torch.cat([h1 + h2, hlast_t[None]]).cpu().numpy()
            hlast = float(h_host[-1])
            if hlast > tiny:
                V[j + 1] = w / hlast_t
            else:
                V[j + 1] = 0.0
            h = h_host.astype(npdt)
            for i in range(j):        # previous rotations
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                h[i + 1] = -sn[i] * h[i] + cs[i] * h[i + 1]
                h[i] = hi
            denom = np.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            if denom > 0:
                c = h[j] / max(denom, npdt(tiny))
                s = h[j + 1] / max(denom, npdt(tiny))
            else:
                c, s = npdt(1.0), npdt(0.0)
            h[j] = c * h[j] + s * h[j + 1]
            cs[j], sn[j] = c, s
            gj1 = -s * g[j]
            g[j] = c * g[j]
            g[j + 1] = gj1
            R[:j + 1, j] = h[:j + 1]
            res = float(abs(gj1))
            j += 1
        if j > 0:
            y = _back_substitute(R[:j, :j], g[:j])
            x = x + torch.as_tensor(y, device=b.device) @ V[:j]
        nmv += j + 1
        done = res <= tol
    return x, res, nmv


def _gmres_block(matvec_block, B, restart, maxiter, rtol, atol, n_rep=0):
    """Restarted GMRES on the k right-hand sides in the rows of B (k, n) at
    once.  Each column keeps its own Krylov basis, Givens rotations,
    residual estimate and matvec count, and stops exactly where
    `_gmres_flat` stops on that column alone: a column that has converged
    (or spent `maxiter`) is frozen, and `matvec_block` is applied to the
    (r, n) rows of the columns still running only.  So the JAX package's
    vmapped `while_loop` GMRES, which freezes a finished lane, and a loop
    of single-vector calls give each column the same answer.  The CGS2
    projections run as batched products over the running columns; the
    Givens updates run on the host, vectorized over the columns, in the
    working dtype.  Returns (X, final_resnorms, n_matvecs) with numpy
    arrays of one entry per column.

    On a row-partitioned state (`parallel.use_mesh`) B holds this rank's
    block of each row, the projections and norms are completed over the
    ranks (each row's last `n_rep` entries counted once), and every host
    decision (the columns still running, the frozen ones, the restarts)
    reads those reduced values, the same on every rank."""
    k, n = B.shape
    dtype, dev = B.dtype, B.device
    npdt = _torch_to_np_dtype(dtype)
    tiny = float(torch.finfo(dtype).tiny)
    m = min(restart, global_size(n, n_rep))
    b_norm = global_row_norms(B, n_rep).cpu().numpy().astype(np.float64)
    tol = np.maximum(rtol * b_norm, atol)

    X = torch.zeros_like(B)
    res = b_norm.copy()
    nmv = np.zeros(k, np.int64)
    done = b_norm <= tol
    V = torch.empty((k, m + 1, n), dtype=dtype, device=dev)
    while True:
        cols = np.nonzero(~done & (nmv < maxiter))[0]
        if cols.size == 0:
            break
        ci = torch.as_tensor(cols, device=dev)
        R0 = B[ci] - matvec_block(X[ci])
        beta_t = global_row_norms(R0, n_rep)
        beta = beta_t.cpu().numpy().astype(np.float64)
        V[ci, 0] = torch.where(beta_t[:, None] > 0,
                               R0 / torch.clamp_min(beta_t, tiny)[:, None],
                               R0)
        c_ = cols.size
        Rm = np.zeros((c_, m, m), npdt)
        cs = np.zeros((c_, m), npdt)
        sn = np.zeros((c_, m), npdt)
        g = np.zeros((c_, m + 1), npdt)
        g[:, 0] = beta.astype(npdt)
        rc = beta.copy()
        jc = np.zeros(c_, np.int64)
        for j in range(m):
            run = np.nonzero(rc > tol[cols])[0]
            if run.size == 0:
                break
            rows = torch.as_tensor(cols[run], device=dev)
            W = matvec_block(V[rows, j])
            # CGS2 on each running column's j+1 filled basis rows
            Vj = V[rows, :j + 1]
            h1 = global_bdot(Vj, W, n_rep)
            W = W - torch.bmm(h1[:, None, :], Vj)[:, 0]
            h2 = global_bdot(Vj, W, n_rep)
            W = W - torch.bmm(h2[:, None, :], Vj)[:, 0]
            hlast_t = global_row_norms(W, n_rep)
            V[rows, j + 1] = torch.where(
                hlast_t[:, None] > tiny,
                W / torch.clamp_min(hlast_t, tiny)[:, None], 0.0)
            h = torch.cat([h1 + h2, hlast_t[:, None]], dim=1).cpu().numpy(
                ).astype(npdt)
            csr, snr = cs[run], sn[run]
            for i in range(j):        # previous rotations
                hi = csr[:, i] * h[:, i] + snr[:, i] * h[:, i + 1]
                h[:, i + 1] = -snr[:, i] * h[:, i] + csr[:, i] * h[:, i + 1]
                h[:, i] = hi
            denom = np.sqrt(h[:, j] ** 2 + h[:, j + 1] ** 2)
            safe = np.maximum(denom, npdt(tiny))
            c = np.where(denom > 0, h[:, j] / safe, npdt(1.0)).astype(npdt)
            s = np.where(denom > 0, h[:, j + 1] / safe, npdt(0.0)).astype(
                npdt)
            h[:, j] = c * h[:, j] + s * h[:, j + 1]
            cs[run, j], sn[run, j] = c, s
            gj = g[run, j]
            g[run, j + 1] = -s * gj
            g[run, j] = c * gj
            Rm[run, :j + 1, j] = h[:, :j + 1]
            rc[run] = np.abs(g[run, j + 1]).astype(np.float64)
            jc[run] += 1
        for q, col in enumerate(cols):
            if jc[q] > 0:
                y = _back_substitute(Rm[q, :jc[q], :jc[q]], g[q, :jc[q]])
                X[col] = X[col] + torch.as_tensor(y, device=dev) \
                    @ V[col, :jc[q]]
        nmv[cols] += jc + 1
        res[cols] = rc
        done[cols] = rc <= tol[cols]
    return X, res, nmv


def _back_substitute(R, g):
    """Upper-triangular solve in R's dtype."""
    y = np.zeros_like(g)
    for i in range(len(g) - 1, -1, -1):
        y[i] = (g[i] - R[i, i + 1:] @ y[i + 1:]) / R[i, i]
    return y


# ---------------------------------------------------------------------------
# BiCGStab — cheaper per-iteration alternative for non-symmetric systems
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BiCGStab:
    """Left-preconditioned BiCGStab (two matvecs per iteration), the port
    of the JAX package's `BiCGStab`; one host sync per iteration reads the
    residual norm."""

    maxiter: int = 500
    rtol: float = 1e-8
    atol: float = 1e-12
    precond: Optional[Callable] = None

    def __call__(self, J, rhs, a0=0.0, a1=1.0):
        flat_rhs, unravel = ravel(rhs)

        def matvec(xf):
            out = shifted_apply(J, unravel(xf), a0, a1)
            if self.precond is not None:
                out = self.precond(out)
            return ravel(out)[0]

        check_partition(False, "BiCGStab")
        b = flat_rhs
        if self.precond is not None:
            b = ravel(self.precond(unravel(flat_rhs)))[0]
        b_norm = float(torch.linalg.vector_norm(b))
        tol = max(self.rtol * b_norm, self.atol)
        tiny = float(torch.finfo(b.dtype).tiny)   # f32-safe division guard

        def guard(d):
            return torch.where(d == 0, torch.full_like(d, tiny), d)

        x = torch.zeros_like(b)
        r = b
        rhat = b
        p = torch.zeros_like(b)
        v = torch.zeros_like(b)
        one = torch.ones((), dtype=b.dtype, device=b.device)
        rho, alpha, omega = one, one, one
        k, res = 0, b_norm
        while res > tol and k < self.maxiter:
            rho1 = torch.dot(rhat, r)
            beta = (rho1 / guard(rho)) * (alpha / guard(omega))
            p = r + beta * (p - omega * v)
            v = matvec(p)
            alpha = rho1 / guard(torch.dot(rhat, v))
            s = r - alpha * v
            t = matvec(s)
            omega = torch.dot(t, s) / guard(torch.dot(t, t))
            x = x + alpha * p + omega * s
            r = s - omega * t
            rho = rho1
            res = float(torch.linalg.vector_norm(r))
            k += 1
        return unravel(x), res <= tol, k


# ---------------------------------------------------------------------------
# Mixed-precision iterative refinement
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IterativeRefinement:
    """Solve (a0 I + a1 J) x = rhs to f64 accuracy with all Krylov work in a
    low precision (default f32) and a handful of f64 residual corrections:

        repeat:  r = rhs - A x   (accurate dtype, one matvec)
                 d = inner_solve(A_low, r_low)   (all matvecs low precision)
                 x = x + d

    The low-precision operator comes from `J.low` when the jacobian carries
    one (the continuation kernels attach an f32-built operator, see
    kernels._pick_jac); otherwise the accurate operator is wrapped with
    casts (correct, without the compute saving).
    """

    inner: Any = dataclasses.field(
        default_factory=lambda: GMRES(restart=40, maxiter=160, rtol=1e-5))
    low_dtype: Any = torch.float32
    refinements: int = 4            # max outer passes
    rtol: float = 1e-10
    atol: float = 1e-13

    def __call__(self, J, rhs, a0=0.0, a1=1.0):
        check_partition(False, "IterativeRefinement")
        flat_rhs, unravel = ravel(rhs)
        lo = self.low_dtype

        J_low = getattr(J, "low", None)
        if J_low is None:
            def J_low(v_lo):
                out = apply_J(J, unravel(v_lo.to(flat_rhs.dtype)))
                return ravel(out)[0].to(lo)

        def matvec_acc(xf):
            return ravel(shifted_apply(J, unravel(xf), a0, a1))[0]

        b_norm = float(torch.linalg.vector_norm(flat_rhs))
        tol = max(self.rtol * b_norm, self.atol)

        x = torch.zeros_like(flat_rhs)
        r, rn, k, itl = flat_rhs, b_norm, 0, 0
        while rn > tol and k < self.refinements:
            d_lo, _, it = self.inner(J_low, r.to(lo), a0=a0, a1=a1)
            x = x + ravel(d_lo)[0].to(flat_rhs.dtype)
            # the residual of the new iterate closes this pass and opens the
            # next one (the JAX package recomputes the same value there)
            r = flat_rhs - matvec_acc(x)
            rn = float(torch.linalg.vector_norm(r))
            k += 1
            itl += it
        return unravel(x), rn <= tol, itl

    def solve_two(self, J, r1, r2, a0=0.0, a1=1.0):
        return _sequential_solve_two(self, J, r1, r2, a0=a0, a1=a1)


class PairedOperator:
    """Accurate matvec closure carrying a low-precision twin as `.low` (a
    flat-vector operator built at cast primals).  Consumed by
    `IterativeRefinement`; the accurate operator everywhere else."""

    __slots__ = ("op", "low")

    def __init__(self, op, low):
        self.op = op
        self.low = low

    def __call__(self, v):
        return self.op(v)
