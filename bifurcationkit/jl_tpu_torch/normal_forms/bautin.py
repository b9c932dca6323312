"""Bautin (generalised Hopf) normal form: the second Lyapunov coefficient
l2 — the port of `jl_tpu/normal_forms/bautin.py` (ref Bautin NF,
src/codim2/NormalForms.jl:642-958).

Standard centre-manifold formulas (Kuznetsov, Elements of Applied
Bifurcation Theory, §8.3.2, the recipe MatCont's nf_GH uses) with the
multilinear forms B, C, D, E of the problem's jets:

  h20 = (2 i w I - A)^-1 B(q, q)
  h11 = -A^-1 B(q, qb)
  g21 = <p, C(q,q,qb) + B(qb,h20) + 2 B(q,h11)>
  h30 = (3 i w I - A)^-1 [C(q,q,q) + 3 B(q,h20)]
  h21 : bordered solve of (i w I - A) h21 = rhs21 - g21 q   (resonant)
  h31 = (2 i w I - A)^-1 [D(q,q,q,qb) + 3 C(q,q,h11) + 3 C(q,qb,h20)
        + 3 B(h20,h11) + B(qb,h30) + 3 B(q,h21) - 3 g21 h20]
  h22 = -A^-1 [D(q,q,qb,qb) + 4 C(q,qb,h11) + C(qb,qb,h20) + C(q,q,cj(h20))
        + 2 B(h11,h11) + 2 B(q,cj(h21)) + 2 B(qb,h21) + B(cj(h20),h20)
        - 2 h11 (g21 + cj(g21))]
  g32 = <p, E(q,q,q,qb,qb) + ... >  (see `_bautin_terms`)
  l2  = Re(g32) / 12

The 4th and 5th forms are nested jvps of F.  Each stage's forms of one
order go through one batched `torch.func.vmap` call
(`_FlatProblem.forms`), re/im combinations and all.
"""
from __future__ import annotations

import numpy as np
import torch

from ..detection.points import Bautin
from ..linalg.eig import dense_eig
from .codim1 import _FlatProblem

_C = torch.complex128


def bautin_normal_form(prob, x0, params, verbose: bool = False,
                       matrix_free: bool = False, precond=None,
                       gmres_opts=None, omega=None, seed=None):
    """Second Lyapunov coefficient at a (near-)degenerate Hopf point.

    `matrix_free=True` is the PDE-scale route: (q, p) by complex bordered
    inverse iteration near i omega, every h-solve through the real-embedded
    shifted operator (sigma in {0, 2iw, 3iw}) and the resonant h21 through
    the complex bordered extended solve; nothing materialises."""
    core = _bautin_core_mf if matrix_free else _bautin_core
    kw = dict(precond=precond, gmres_opts=gmres_opts, omega=omega,
              seed=seed) if matrix_free else {}
    fp = _FlatProblem(prob, x0, params)
    l1, l2, g21, g32, w, q, p = core(fp, prob, params, **kw)
    pt = Bautin(x0=fp.flat0, p=None, params=params, lens=prob.lens,
                zeta=q, zeta_star=p, omega=float(w),
                nf={"l1": float(l1), "l2": float(l2), "g21": complex(g21),
                    "g32": complex(g32)}, prob=prob)
    pt.subtype = "SuperCritical" if l2 < 0 else "SubCritical"
    if verbose:
        print(f"Bautin NF: l1 = {float(l1):.6g} (should be ~0), "
              f"l2 = {float(l2):.6g}, omega = {float(w):.6g}")
    return pt


def _bautin_terms(fp, q, p, w, solveC, resonant):
    """The h-solves and the two projections shared by both routes;
    `solveC(sigma, b)` solves (sigma I - A) h = b and `resonant(r)` the
    bordered (i w I - A) h = r with <p, h> = 0.  The forms are gathered
    per stage and order into single batched calls (`_FlatProblem.forms`):
    four of B, two of C, one of D and one of E."""
    pr = fp.prob
    qb = torch.conj(q)

    def ip(vec):
        return complex(torch.sum(torch.conj(p) * vec))

    Bqq, Bqqb = fp.forms(pr.d2F, [(q, q), (q, qb)])
    h20 = solveC(2j * w, Bqq)
    h11 = solveC(0.0, Bqqb)
    c20 = torch.conj(h20)
    (C_qqqb, C_qqq, C_qqh11, C_qqbh20, C_qqbh11, C_qbqbh20, C_qqc20,
     C_qc20h20, C_qh11h11, C_qbh20h11) = fp.forms(pr.d3F, [
         (q, q, qb), (q, q, q), (q, q, h11), (q, qb, h20), (q, qb, h11),
         (qb, qb, h20), (q, q, c20), (q, c20, h20), (q, h11, h11),
         (qb, h20, h11)])
    B_qbh20, B_qh11, B_qh20, B_h20h11, B_h11h11, B_c20h20 = fp.forms(
        pr.d2F, [(qb, h20), (q, h11), (q, h20), (h20, h11), (h11, h11),
                 (c20, h20)])
    D_qqqqb, D_qqqbqb, D_qqqc20, D_qqbqbh20, D_qqqbh11 = fp.forms(pr.d4F, [
        (q, q, q, qb), (q, q, qb, qb), (q, q, q, c20), (q, qb, qb, h20),
        (q, q, qb, h11)])
    (E_qqqqbqb,) = fp.forms(pr.d5F, [(q, q, q, qb, qb)])

    rhs21 = C_qqqb + B_qbh20 + 2.0 * B_qh11
    g21 = ip(rhs21)
    h21 = resonant(rhs21 - g21 * q)
    h30 = solveC(3j * w, C_qqq + 3.0 * B_qh20)
    c21 = torch.conj(h21)
    B_qbh30, B_qh21, B_qc21, B_qbh21 = fp.forms(
        pr.d2F, [(qb, h30), (q, h21), (q, c21), (qb, h21)])
    h31 = solveC(2j * w,
                 D_qqqqb + 3.0 * C_qqh11 + 3.0 * C_qqbh20
                 + 3.0 * B_h20h11 + B_qbh30 + 3.0 * B_qh21
                 - 3.0 * g21 * h20)
    h22 = solveC(0.0,
                 D_qqqbqb + 4.0 * C_qqbh11 + C_qbqbh20 + C_qqc20
                 + 2.0 * B_h11h11 + 2.0 * B_qc21 + 2.0 * B_qbh21 + B_c20h20
                 - 2.0 * (g21 + np.conj(g21)) * h11)
    C_qbqbh30, C_qqc21, C_qqbh21 = fp.forms(
        pr.d3F, [(qb, qb, h30), (q, q, c21), (q, qb, h21)])
    B_qbh31, B_qh22, B_c20h30, B_c21h20, B_h11h21 = fp.forms(
        pr.d2F, [(qb, h31), (q, h22), (c20, h30), (c21, h20), (h11, h21)])
    g32 = ip(E_qqqqbqb
             + D_qqqc20 + 3.0 * D_qqbqbh20 + 6.0 * D_qqqbh11
             + C_qbqbh30 + 3.0 * C_qqc21 + 6.0 * C_qqbh21
             + 3.0 * C_qc20h20 + 6.0 * C_qh11h11 + 6.0 * C_qbh20h11
             + 2.0 * B_qbh31 + 3.0 * B_qh22
             + B_c20h30 + 3.0 * B_c21h20 + 6.0 * B_h11h21)
    return g21.real / 2.0, g32.real / 12.0, g21, g32


def _bautin_core(fp, prob, params):
    """Dense route: host eig of the jacobian, complex solves on its
    device."""
    A = fp.jacobian().to(_C)
    n = fp.n
    vals, vecs = dense_eig(A)
    vals_np = vals.cpu().numpy()
    # complex pair with minimal |Re| (real eigenvalues masked)
    score = np.where(vals_np.imag > 1e-10, np.abs(vals_np.real), np.inf)
    i0 = int(np.argmin(score))
    lam = vals_np[i0]
    w = float(lam.imag)
    q = vecs[:, i0]
    q = q / torch.linalg.vector_norm(q)
    valsT, vecsT = dense_eig(A.T)
    iT = int(np.argmin(np.abs(valsT.cpu().numpy() - np.conj(lam))))
    p = vecsT[:, iT]
    p = p / np.conj(complex(torch.sum(torch.conj(p) * q)))
    eye = torch.eye(n, dtype=_C, device=A.device)

    def solveC(sig, b):
        return torch.linalg.solve(sig * eye - A, b.to(_C))

    # resonant bordered solve: [i w - A, q; p^H, 0][h21; s] = [rhs; 0]
    M = torch.zeros((n + 1, n + 1), dtype=_C, device=A.device)
    M[:n, :n] = 1j * w * eye - A
    M[:n, n] = q
    M[n, :n] = torch.conj(p)

    def resonant(r):
        rhs = torch.cat([r.to(_C), torch.zeros(1, dtype=_C,
                                               device=A.device)])
        return torch.linalg.solve(M, rhs)[:n]

    l1, l2, g21, g32 = _bautin_terms(fp, q, p, w, solveC, resonant)
    return l1, l2, g21, g32, w, q, p


def _bautin_core_mf(fp, prob, params, precond=None, gmres_opts=None,
                    omega=None, seed=None):
    """Matrix-free route: the same formulas, every linear solve through the
    preconditioned iterative closures of the codim-2 unfolding kit (ref
    src/codim2/NormalForms.jl:642-958):

      (q, p, w)          complex bordered inverse iteration near i omega
      (sigma I - A)^-1   real-embedded shifted GMRES (sigma = 0, 2iw, 3iw)
      resonant h21       complex bordered extended solve with borders
                         (q, p): [iw - A, q; p^H, 0][h; s] = [rhs; 0] is
                         the complex bordered (A - iw) applied to -rhs."""
    from ..codim2.unfolding import (_estimate_hopf_omega, _make_cbord,
                                    _make_solveC, _mf_hopf_pair,
                                    _mf_solver_set)

    Jd, Jtd, gm1, gm2, gm2n = _mf_solver_set(fp, prob, params, precond,
                                             gmres_opts)
    if omega is None:
        omega = _estimate_hopf_omega(fp, Jd)
    q, p, w = _mf_hopf_pair(fp, Jd, Jtd, gm2, omega, seed=seed)
    cbord = _make_cbord(Jd, w, q, p, gm2)
    l1, l2, g21, g32 = _bautin_terms(fp, q, p, w, _make_solveC(Jd, gm2n),
                                     lambda r: cbord(-r.to(_C)))
    return l1, l2, g21, g32, w, q, p
