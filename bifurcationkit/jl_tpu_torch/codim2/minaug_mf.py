"""Extended-operator bordered solves — the port of the helpers of
`jl_tpu/codim2/minaug_mf.py:66-242` that the matrix-free normal forms run
(the minimally augmented codim-2 problems of that module come with their
own slice).

A bordered system [J col; row^T 0][v; s] = [t; b] is solved by GMRES on
the extended flat operator, which stays nonsingular where J itself is
singular (at a branch or Hopf point); the inner spectral preconditioner
extends blockwise, identity on the scalar slots.  The complex-shifted
systems of the Hopf route run in the real 2n + 2 embedding, as in the JAX
package.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.state import ravel, tree_map
from ..linalg.linear import GMRES


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
              rtol: float = 1e-11, atol: float = 1e-14):
    """Mixed-precision solve of op_hi x = rhs: all Krylov matvecs run the
    low-precision twin `op_lo`, a couple of residual corrections at rhs's
    precision restore full accuracy.  Each low-precision correction is
    finite-guarded: a Krylov breakdown contributes nothing instead of
    poisoning the iterate, and the next pass retries from the current x.
    Returns (x, converged)."""
    def _san(v):
        return torch.where(torch.isfinite(v), v, torch.zeros_like(v))

    x0, _, _ = gm_lo(op_lo, rhs.to(lo))
    x = _san(ravel(x0)[0]).to(rhs.dtype)
    tol = max(rtol * float(torch.linalg.vector_norm(rhs)), atol)
    rn = float(torch.linalg.vector_norm(rhs - op_hi(x)))
    k = 0
    while rn > tol and k < refinements:
        d, _, _ = gm_lo(op_lo, (rhs - op_hi(x)).to(lo))
        x = x + _san(ravel(d)[0]).to(rhs.dtype)
        rn = float(torch.linalg.vector_norm(rhs - op_hi(x)))
        k += 1
    return x, rn <= tol


def solve_bordered_ext(Jd, col, row, gmres, rhs_top=None, rhs_bot=1.0,
                       Jd_lo=None, gm_lo=None, lo=None):
    """Solve [J col; row^T 0][v; s] = [rhs_top; rhs_bot] by GMRES on the
    extended flat operator.  `Jd` is a flat matvec; the default RHS
    [0; 1] is the null-vector system.  With (`Jd_lo`, `gm_lo`, `lo`) the
    Krylov work runs the low-precision twin with refinement (`_ir_solve`).
    Returns (v, s, converged)."""
    n = col.shape[0]

    def op(z):
        return torch.cat([Jd(z[:n]) + z[n] * col,
                          torch.dot(row, z[:n]).reshape(1)])

    if rhs_top is None:
        rhs_top = torch.zeros((n,), dtype=col.dtype, device=col.device)
    rhs = torch.cat([rhs_top, torch.as_tensor(
        rhs_bot, dtype=col.dtype, device=col.device).reshape(1)])
    if Jd_lo is not None:
        col_lo, row_lo = col.to(lo), row.to(lo)

        def op_lo(z):
            return torch.cat([Jd_lo(z[:n]) + z[n] * col_lo,
                              torch.dot(row_lo, z[:n]).reshape(1)])

        sol, cv = _ir_solve(op, op_lo, rhs, gm_lo, lo)
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
    extended blockwise."""
    o = dict(restart=40, maxiter=240, rtol=1e-10, atol=1e-14)
    if opts:
        o.update(opts)
    pext = ext_precond(precond, n) if k == 1 else ext_precond2(precond, n)
    return GMRES(precond=pext, **o)
