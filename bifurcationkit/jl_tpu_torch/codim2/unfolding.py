"""Detailed codim-2 normal-form unfoldings and their predictors — the port
of `jl_tpu/codim2/unfolding.py` (ref src/codim2/NormalForms.jl:141-506 BT
with its homoclinic predictor, :642-958 Bautin with the fold-of-PO
predictor, :959-1313 ZH with the NS predictor, :1315-1624 HH with the NS
predictors), and `switch_codim2_po`, which starts a periodic-orbit
codim-2 curve (fold of PO, NS) from a codim-2 point of equilibria.

The mathematics follows
  REF1  Kuznetsov 1999, "Numerical normalization techniques for all codim
        2 bifurcations of equilibria in ODEs", SINUM 36(4)
  REF2  Kuznetsov, Meijer, Govaerts, Sautois 2008, "Switching to
        nonhyperbolic cycles from codim 2 bifurcations of equilibria in
        ODEs", Physica D 237
  REF3  Al-Hdaibat, Govaerts, Kuznetsov, Meijer 2016, "Initialization of
        homoclinic solutions near Bogdanov-Takens points", SIADS 15(2)

Every parameter derivative (J1, A1, B1, C1, the mixed second derivatives)
is exact, a `torch.func.jvp` over the lens value, and is taken from F or
the problem's d2F/d3F, never through `jac_op`: a hand-written J.v kernel
carries no tangent.  Vectors stay on the problem's device and dtype
(complex128 where complex); projections come back as Python numbers, and
only the 2x2 systems and the dense eigenproblems go to the host.  The
matrix-free routes solve through the extended bordered and shifted
operators of `minaug_mf` (GMRES with the model's spectral preconditioner
extended blockwise), every plain J.v through the model's `jac_op`.

Start vectors of the iterative bases come from a CPU `torch.Generator`
with a fixed seed (the same numbers on every device), or from the caller.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp, vmap

from ..core.problem import re_im_rows, weighted_sum
from ..core.state import ravel
from ..linalg.eig import ArnoldiEig, FlatOperator, dense_eig
from ..linalg.linear import GMRES
from ..normal_forms.codim1 import _FlatProblem
from .minaug import _host
from .minaug_mf import (_grad_x_pairing, _jv_of_F, _make_ma_gmres,
                        ext_precond, ext_precond2, solve_bordered_ext,
                        solve_bordered_ext_cplx, solve_shifted_cplx)

_C = torch.complex128


def _dot(p, v) -> complex:
    """Julia LA.dot: sum(conj(p) * v), as a Python complex."""
    return complex(torch.sum(torch.conj(p) * v))


def _rdot(p, v) -> float:
    return float(torch.real(torch.sum(torch.conj(p) * v)))


def _c(v):
    return v.to(_C)


def _seed_vector(n, seed: int, like):
    """A start vector from a CPU `torch.Generator` (the same numbers on any
    device), moved to `like`'s device and dtype."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n,), generator=g, dtype=torch.float64).to(
        dtype=like.dtype, device=like.device)


class _ParamJet:
    """Exact parameter derivatives of the vector field at a fixed point:
    J1 = dF/dp, A1(q) = d(J q)/dp, B1(q, r) = dB(q, r)/dp and
    C1(q, r, s) = dC(q, r, s)/dp, each one jvp over the lens value.  J q
    is a jvp of F, so no derivative ever reaches a kernel."""

    def __init__(self, prob, x0_tree, params, lens):
        self.prob = prob
        self.x0 = x0_tree
        self.params = params
        self.lens = lens
        flat, self.unravel = ravel(x0_tree)
        self.p0 = torch.as_tensor(float(lens.get(params)), dtype=flat.dtype,
                                  device=flat.device)

    def _d(self, g):
        """d/dp g(params(p)) at p0 for g returning a flat real vector."""
        return jvp(lambda t: g(self.lens.set(self.params, t)), (self.p0,),
                   (torch.ones_like(self.p0),))[1]

    def J1(self):
        return self._d(lambda par: ravel(self.prob.F(self.x0, par))[0])

    def _A1r(self, q):
        qs = self.unravel(q)
        return self._d(lambda par: _jv_of_F(self.prob, self.x0, par, qs))

    def A1(self, q):
        if q.is_complex():
            return torch.complex(self._A1r(q.real), self._A1r(q.imag))
        return self._A1r(q)

    def _complex_form(self, form, args):
        """d/dp of a real multilinear form (`prob.d2F`, `prob.d3F`) at x0,
        extended to complex arguments over their real and imaginary parts:
        the real evaluations run in one `torch.func.vmap` inside one jvp
        over the lens value."""
        rows, weights = re_im_rows(args)
        cols = [torch.stack(c) for c in zip(*rows)]

        def g(par):
            return vmap(lambda *ds: ravel(form(
                self.x0, par, *[self.unravel(d) for d in ds]))[0])(*cols)

        terms = self._d(g)
        if not any(a.is_complex() for a in args):
            return terms[0]
        return weighted_sum(terms, weights)

    def B1(self, q, r):
        return self._complex_form(self.prob.d2F, (q, r))

    def C1(self, q, r, s):
        return self._complex_form(self.prob.d3F, (q, r, s))


def _dd_p2(prob, x0_tree, params, lensA, lensB):
    """Mixed second parameter derivative d^2 F / dpA dpB at x0 (exact)."""
    like = ravel(x0_tree)[0]
    pA = torch.as_tensor(float(lensA.get(params)), dtype=like.dtype,
                         device=like.device)
    pB = torch.as_tensor(float(lensB.get(params)), dtype=like.dtype,
                         device=like.device)

    def inner(tA):
        def g(tB):
            par = lensB.set(lensA.set(params, tA), tB)
            return ravel(prob.F(x0_tree, par))[0]

        return jvp(g, (pB,), (torch.ones_like(pB),))[1]

    return jvp(inner, (pA,), (torch.ones_like(pA),))[1]


def _bord_solve(L, col, row, rhs, shift=0.0):
    """Solve [L + shift I, col; row^H, 0][h; s] = [rhs; 0] (dense)."""
    n = L.shape[0]
    cplx = (L.is_complex() or col.is_complex() or row.is_complex()
            or rhs.is_complex() or isinstance(shift, complex))
    dt = _C if cplx else L.dtype
    eye = torch.eye(n, dtype=dt, device=L.device)
    M = torch.zeros((n + 1, n + 1), dtype=dt, device=L.device)
    M[:n, :n] = L.to(dt) + shift * eye
    M[:n, n] = col.to(dt)
    M[n, :n] = torch.conj(row.to(dt))
    b = torch.zeros((n + 1,), dtype=dt, device=L.device)
    b[:n] = rhs.to(dt)
    return torch.linalg.solve(M, b)[:n]


def _dense_spectrum(L):
    """Host eigen data of L and of L^T: (vals, vecs, valsT, vecsT), values
    as numpy, vectors as complex tensors on L's device."""
    vals, vecs = dense_eig(L.to(_C))
    valsT, vecsT = dense_eig(L.T.to(_C))
    return _host(vals), vecs, _host(valsT), vecsT


# ---------------------------------------------------------------------------
# matrix-free solver kit shared by the unfoldings
# ---------------------------------------------------------------------------


def _mf_solver_set(fp, prob, params, precond, gmres_opts):
    """(Jd, Jtd, gm1, gm2, gm2n): the flat J.v (through `jac_op`), J^T.v,
    and GMRES for the n + 1 bordered, the 2n + 2 complex bordered and the
    2n shifted systems, each with the spectral preconditioner extended
    blockwise."""
    n = fp.n
    if precond is None:
        precond = getattr(prob, "spectral_precond", None)
    gm1 = _make_ma_gmres(precond, n, 1, gmres_opts)
    gm2 = _make_ma_gmres(precond, n, 2, gmres_opts)
    o = dict(restart=40, maxiter=240, rtol=1e-10, atol=1e-14)
    if gmres_opts:
        o.update(gmres_opts)
    gm2n = GMRES(precond=ext_precond2(precond, n)
                 if precond is not None else None, **o)
    return fp.dF, fp.dFt, gm1, gm2, gm2n


def _estimate_hopf_omega(fp, Jd, exclude=()):
    """Leading Hopf frequency by Arnoldi on the J.v operator."""
    op = FlatOperator(Jd, fp.n, fp.flat0.dtype, fp.flat0.device)
    vals, _, _, _ = ArnoldiEig(krylov_dim=80, restarts=5, which="LR")(op, 8)
    v = _host(vals)
    cand = v[v.imag > 1e-8]
    for w_ex in exclude:
        cand = cand[np.abs(cand.imag - w_ex) > 1e-6]
    if len(cand) == 0:
        raise RuntimeError("no complex pair found; pass omega explicitly")
    return float(cand[np.argmin(np.abs(cand.real))].imag)


def _mf_hopf_pair(fp, Jd, Jtd, gm2, omega, seed=None):
    """(q1, p1, w): unit right vector and <p1, q1> = 1 left vector of the
    eigenvalue nearest i omega, by complex bordered inverse iteration."""
    from ..normal_forms.codim1 import hopf_null_basis_iter

    like = fp.flat0
    if seed is None:
        sr, si = _seed_vector(fp.n, 41, like), _seed_vector(fp.n, 42, like)
    else:
        sc = torch.as_tensor(seed).to(device=like.device)
        if sc.is_complex() and bool(torch.any(sc.imag != 0)):
            sr, si = sc.real, sc.imag
        else:
            sr, si = torch.real(sc), _seed_vector(fp.n, 42, like)
        sr, si = sr.to(like.dtype), si.to(like.dtype)
    zr, zi, wr, wi, _, om = hopf_null_basis_iter(Jd, Jtd, omega, sr, si, gm2)
    q1 = torch.complex(zr, zi)
    p1c = torch.complex(wr, wi)
    return q1, p1c / np.conj(_dot(p1c, q1)), float(om)


def _make_solveC(Jd, gm2n):
    """(sigma I - J)^{-1} b for complex sigma and b over the real operator
    J, in the real 2n embedding (sigma = 0 gives -J^{-1} b)."""
    def solveC(sig, b):
        b = _c(b)
        sig = complex(sig)
        xr, xi, _ = solve_shifted_cplx(Jd, sig.real, sig.imag, b.real,
                                       b.imag, gm2n)
        return torch.complex(xr, xi)

    return solveC


def _make_cbord(Jd, w, q, p, gm2):
    """h -> the solution of [J - i w, q; p^H, 0][h; s] = [rhs; 0] through
    the complex bordered extended operator."""
    qr, qi, pr, pi = q.real, q.imag, p.real, p.imag

    def cbord(rhs):
        rhs = _c(rhs)
        vr, vi, _, _, _ = solve_bordered_ext_cplx(
            Jd, -w, qr, qi, pr, pi, gm2, rhs_top=(rhs.real, rhs.imag))
        return torch.complex(vr, vi)

    return cbord


def _zh_basis_mf(fp, prob, params, precond=None, gmres_opts=None,
                 omega=None, seed=None):
    """Matrix-free ZH basis and solver closures: (q0, p0) by bordered
    inverse iteration, (q1, p1) by the complex one, Ainv0/Ainv1 through
    the extended operators, solveC the shifted solve (ref
    src/codim2/NormalForms.jl:959-1205)."""
    from ..normal_forms.codim1 import null_basis_iter

    Jd, Jtd, gm1, gm2, gm2n = _mf_solver_set(fp, prob, params, precond,
                                             gmres_opts)
    if omega is None:
        omega = _estimate_hopf_omega(fp, Jd)
    q0, p0 = null_basis_iter(Jd, Jtd, _seed_vector(fp.n, 43, fp.flat0), gm1)
    p0 = p0 / torch.dot(p0, q0)
    q1, p1, w = _mf_hopf_pair(fp, Jd, Jtd, gm2, omega, seed=seed)

    def Ainv0(dx):
        v, _, _ = solve_bordered_ext(Jd, q0, p0, gm1,
                                     rhs_top=torch.real(dx), rhs_bot=0.0)
        return v

    return (q0, p0, q1, p1, w, Ainv0, _make_cbord(Jd, w, q1, p1, gm2),
            _make_solveC(Jd, gm2n))


# ---------------------------------------------------------------------------
# Bautin (GH): detailed unfolding + fold-of-PO predictor (REF2 §2.3.1)
# ---------------------------------------------------------------------------


def bautin_unfolding(prob, x0_tree, params, lens1, lens2,
                     matrix_free: bool = False, precond=None,
                     gmres_opts=None, omega=None, seed=None):
    """Detailed Bautin normal form: the REF1 §7 coefficients and the REF2
    formulas (17), (19)-(22) parameter unfolding that predicts the
    fold-of-PO curve (ref src/codim2/NormalForms.jl:835-925).

    `matrix_free=True` routes every solve through the iterative closures:
    (q0, p0) by complex bordered inverse iteration, the shifted solves in
    the real embedding, the resonant bordered solves through the complex
    extended operator; l2 comes from the matrix-free Bautin core."""
    from ..normal_forms.bautin import bautin_normal_form

    fp = _FlatProblem(prob, x0_tree, params)
    if matrix_free:
        Jd, Jtd, gm1, gm2, gm2n = _mf_solver_set(fp, prob, params, precond,
                                                 gmres_opts)
        if omega is None:
            omega = _estimate_hopf_omega(fp, Jd)
        q0, p0, w = _mf_hopf_pair(fp, Jd, Jtd, gm2, omega, seed=seed)
        solveC = _make_solveC(Jd, gm2n)
        cbord = _make_cbord(Jd, w, q0, p0, gm2)

        def solve2wmL(b):            # (2 i w I - L)^{-1} b
            return solveC(2j * w, b)

        def solvemL(b):              # (-L)^{-1} b
            return solveC(0.0, b)

        def bord_res(rhs):
            # [-L + i w, q0; p0^H, 0][h; s] = [rhs; 0] is the complex
            # bordered (L - i w) applied to -rhs
            return cbord(-_c(rhs))

        Ainv = cbord                 # [L - i w, q0; p0^H, 0][h; s] = [dx; 0]
        l2_pt = bautin_normal_form(prob, x0_tree, params, matrix_free=True,
                                   precond=precond, gmres_opts=gmres_opts,
                                   omega=w, seed=q0)
    else:
        L = fp.jacobian()
        vals, vecs, valsT, vecsT = _dense_spectrum(L)
        score = np.where(vals.imag > 1e-10, np.abs(vals.real), np.inf)
        i0 = int(np.argmin(score))
        lam = vals[i0]
        w = float(lam.imag)
        q0 = vecs[:, i0]
        q0 = q0 / torch.linalg.vector_norm(q0)
        p0 = vecsT[:, int(np.argmin(np.abs(valsT - np.conj(lam))))]
        p0 = p0 / np.conj(_dot(p0, q0))
        Lc = L.to(_C)
        eye = torch.eye(fp.n, dtype=_C, device=L.device)

        def solve2wmL(b):
            return torch.linalg.solve(2j * w * eye - Lc, _c(b))

        def solvemL(b):
            return torch.linalg.solve(-Lc, _c(b))

        def bord_res(rhs):
            return _bord_solve(-L, q0, p0, rhs, shift=1j * w)

        def Ainv(dx):
            return _bord_solve(L, q0, p0, dx, shift=-1j * w)

        l2_pt = bautin_normal_form(prob, x0_tree, params)
    cq0 = torch.conj(q0)
    B, C, D = fp.d2F, fp.d3F, fp.d4F

    # REF1 (7.2)-(7.7)
    h2000 = solve2wmL(B(q0, q0))
    h1100 = torch.real(solvemL(B(q0, cq0)))
    rhs21 = C(q0, q0, cq0) + B(cq0, h2000) + 2.0 * B(q0, h1100)
    G21 = _dot(p0, rhs21)
    # the reference solves (i w I - A) h21 = rhs - G21 q0 bordered; here
    # (-L + i w) h = ... is the same matrix
    h2100 = bord_res(rhs21 - G21 * q0)
    l1 = G21 / 2.0          # complex l1 (REF2 notation)
    l2 = l2_pt.nf["l2"]

    # REF2 formula (17)
    pj1 = _ParamJet(prob, x0_tree, params, lens1)
    pj2 = _ParamJet(prob, x0_tree, params, lens2)
    h0010 = torch.real(solvemL(pj1.J1()))
    h0001 = torch.real(solvemL(pj2.J1()))
    A1q0_1, A1q0_2 = pj1.A1(q0), pj2.A1(q0)
    g110 = _dot(p0, A1q0_1 + B(q0, h0010))
    g101 = _dot(p0, A1q0_2 + B(q0, h0001))

    # REF2 (19): Ainv = bordered (L - i w) with borders (q0, p0)
    h1010 = Ainv(g110 * q0 - A1q0_1 - B(q0, h0010))
    h1001 = Ainv(g101 * q0 - A1q0_2 - B(q0, h0001))

    # REF2 (20a): (-2 i w I + L) h = tmp
    def h20(g, h00, h10, pj):
        tmp = (2.0 * g) * h2000 - (C(q0, q0, h00) + 2.0 * B(q0, h10)
                                   + B(h2000, h00) + pj.B1(q0, q0)
                                   + pj.A1(h2000))
        return -solve2wmL(tmp)

    h2010 = h20(g110, h0010, h1010, pj1)
    h2001 = h20(g101, h0001, h1001, pj2)

    # REF2 (20b): L h = tmp
    def h11(g, h00, h10, pj):
        tmp = 2.0 * g.real * h1100 - (
            C(q0, cq0, h00) + B(h1100, h00)
            + 2.0 * torch.real(B(cq0, h10)) + pj.B1(q0, cq0)
            + pj.A1(h1100))
        return -solvemL(tmp)

    h1110 = h11(g110, h0010, h1010, pj1)
    h1101 = h11(g101, h0001, h1001, pj2)

    # REF2 (21)
    def tmp21(h00_, h10_, h20_, h11_, pj):
        return (D(q0, q0, cq0, h00_)
                + 2.0 * C(q0, h1100, h00_)
                + 2.0 * C(q0, cq0, h10_)
                + C(q0, q0, torch.conj(h10_))
                + C(h2000, cq0, h00_)
                + 2.0 * B(q0, h11_)
                + 2.0 * B(h1100, h10_)
                + B(h2000, torch.conj(h10_))
                + B(h2100, h00_)
                + B(h20_, cq0)
                + pj.C1(q0, q0, cq0)
                + 2.0 * pj.B1(h1100, q0)
                + pj.B1(h2000, cq0)
                + pj.A1(h2100))

    g210 = _dot(p0, tmp21(h0010, h1010, h2010, h1110, pj1)) / 2.0
    g201 = _dot(p0, tmp21(h0001, h1001, h2001, h1101, pj2)) / 2.0

    # REF2 (22)
    Gam = np.array([[g110, g101], [g210, g201]])
    alpha = np.linalg.solve(np.real(Gam), np.array([0.0, 1.0]))
    return {
        "x0": fp.flat0, "omega": w, "q0": q0, "p0": p0,
        "l1": l1, "l2": float(l2), "G21": G21,
        "h2000": h2000, "h1100": h1100, "h2100": h2100,
        "h0010": h0010, "h0001": h0001,
        "g110": g110, "g101": g101, "g210": g210, "g201": g201,
        "alpha": alpha,
        "p10": float(lens1.get(params)), "p20": float(lens2.get(params)),
    }


def predictor_fold_po(nf: dict, eps: float):
    """Fold-of-PO curve predictor from a Bautin point (REF2 §2.3.1; ref
    predictor(gh, Val{:FoldPeriodicOrbitCont}),
    src/codim2/NormalForms.jl:935-957)."""
    l2, alpha = nf["l2"], nf["alpha"]
    x0 = nf["x0"] + eps ** 2 * torch.real(
        nf["h1100"] - 2.0 * l2 * (nf["h0010"] * float(alpha[0])
                                  + nf["h0001"] * float(alpha[1])))
    q0, h2000 = nf["q0"], nf["h2000"]

    def orbit(theta):
        return (x0 + 2 * eps * torch.real(q0 * np.exp(1j * theta))
                + 2 * eps ** 2 * torch.real(h2000 * np.exp(2j * theta)))

    omega = nf["omega"] + (-2.0 * l2 * np.imag(alpha[0] * nf["g110"]
                                               + alpha[1] * nf["g101"])
                           + np.imag(nf["l1"])) * eps ** 2
    params = np.array([nf["p10"], nf["p20"]]) - 2.0 * l2 * alpha * eps ** 2
    return {"orbit": orbit, "omega": float(omega),
            "T": float(2 * np.pi / abs(omega)),
            "p1": float(params[0]), "p2": float(params[1])}


# ---------------------------------------------------------------------------
# Zero-Hopf: detailed unfolding + NS predictor (REF1 §8, REF2 §2.3.2)
# ---------------------------------------------------------------------------


def zh_unfolding(prob, x0_tree, params, lens1, lens2,
                 matrix_free: bool = False, precond=None, gmres_opts=None,
                 omega=None, seed=None):
    """Detailed ZH normal form (ref src/codim2/NormalForms.jl:1100-1205):
    REF1 (8.2)-(8.6) second- and third-order terms and the REF2 (24)-(25)
    unfolding.

    `matrix_free=True`: (q0, p0) by bordered inverse iteration, (q1, p1)
    by the complex one, and every projection solve through the
    preconditioned extended and shifted operators (pass `omega` to target
    the Hopf pair; else Arnoldi finds it)."""
    fp = _FlatProblem(prob, x0_tree, params)
    if matrix_free:
        q0, p0, q1, p1, w, Ainv0, Ainv1, solveC = _zh_basis_mf(
            fp, prob, params, precond=precond, gmres_opts=gmres_opts,
            omega=omega, seed=seed)
    else:
        L = fp.jacobian()
        vals, vecs, valsT, vecsT = _dense_spectrum(L)
        izero = int(np.argmin(np.abs(vals)))
        cand = np.where(vals.imag > 1e-8)[0]
        ih = int(cand[int(np.argmin(np.abs(vals[cand].real)))])
        lamH = vals[ih]
        w = float(lamH.imag)
        q0 = torch.real(vecs[:, izero])
        q0 = q0 / torch.linalg.vector_norm(q0)
        q1 = vecs[:, ih]
        q1 = q1 / torch.linalg.vector_norm(q1)
        p0 = torch.real(vecsT[:, int(np.argmin(np.abs(valsT)))])
        p0 = p0 / torch.dot(p0, q0)
        p1 = vecsT[:, int(np.argmin(np.abs(valsT - np.conj(lamH))))]
        p1 = p1 / np.conj(_dot(p1, q1))
        eye = torch.eye(fp.n, dtype=_C, device=L.device)

        def Ainv0(dx):
            return _bord_solve(L, q0, p0, torch.real(dx))

        def Ainv1(dx):
            return _bord_solve(L, q1, p1, dx, shift=-1j * w)

        def solveC(sig, b):
            return torch.linalg.solve(sig * eye - L.to(_C), _c(b))
    cq1 = torch.conj(q1)
    B, C = fp.d2F, fp.d3F

    # REF1 (8.2)
    G200 = _rdot(p0, B(q0, q0))
    G110 = _dot(p1, B(q0, q1))
    G011 = _rdot(p0, B(q1, cq1))

    # REF1 (8.3)-(8.6)
    h200 = Ainv0(-B(q0, q0) + G200 * q0)
    h020 = solveC(2j * w, B(q1, q1))
    h110 = -Ainv1(B(q0, q1) - G110 * q1)
    h011 = -Ainv0(B(q1, cq1) - G011 * q0)

    # third-order resonant projections
    G111 = _dot(p0, C(q0, q1, cq1) + B(q0, h011) + B(q1, torch.conj(h110))
                + B(cq1, h110))
    G021 = _dot(p1, C(q1, q1, cq1) + 2.0 * B(q1, h011) + B(cq1, h020))

    # REF2 notations
    f011, g021, f111, g110, f200 = G011, G021 / 2.0, G111, G110, G200 / 2.0
    hasNS = bool(g110.real * f011 < 0)

    # REF2 (24)-(25) parameter unfolding
    pj1 = _ParamJet(prob, x0_tree, params, lens1)
    pj2 = _ParamJet(prob, x0_tree, params, lens2)
    J1_1, J1_2 = pj1.J1(), pj2.J1()
    s1 = np.array([float(torch.dot(p0, J1_1)), float(torch.dot(p0, J1_2))])
    s2 = np.array([-s1[1], s1[0]])
    s1 = s1 / np.dot(s1, s1)
    r1 = Ainv0(q0 - J1_1 * s1[0] - J1_2 * s1[1])
    r2 = Ainv0(J1_1 * s2[0] + J1_2 * s2[1])

    def proj(p, q, r, s):
        return _dot(p, B(q, r) + pj1.A1(q) * s[0] + pj2.A1(q) * s[1])

    LL = np.array([[proj(p0, q0, r2, s2), 2.0 * f200],
                   [proj(p1, q1, r2, s2), g110]])
    RR = np.array([-proj(p0, q0, r1, s1), -proj(p1, q1, r1, s1)])
    d13 = np.linalg.solve(np.real(LL), np.real(RR))
    d24 = np.linalg.solve(np.real(LL), np.array([0.0, 1.0]))
    v10 = s1 + d13[0] * s2
    v01 = d24[0] * s2
    h00010 = r1 + float(d13[0]) * r2 + float(d13[1]) * q1
    h00001 = float(d24[0]) * r2 + float(d24[1]) * q1

    # REF2 (10)
    xcoef = -(f111 + 2.0 * g021) / (2.0 * f200)
    beta1 = -f011
    beta2 = float(np.real((2.0 * g021.real * (g110.real - f200)
                           + g110.real * f111) / (2.0 * f200)))
    return {
        "x0": fp.flat0, "omega": w, "q0": q0, "q1": q1, "p0": p0, "p1": p1,
        "G200": G200, "G110": G110, "G011": G011, "G111": G111,
        "G021": G021, "h020": h020, "h011": h011, "h110": h110,
        "h200": h200, "g110": g110, "f011": f011, "hasNS": hasNS,
        "v10": v10, "v01": v01, "h00010": h00010, "h00001": h00001,
        "x": xcoef, "beta1": beta1, "beta2": beta2,
        "p10": float(lens1.get(params)), "p20": float(lens2.get(params)),
    }


def predictor_ns_zh(nf: dict, eps: float):
    """NS-of-PO curve predictor from a ZH point (REF2 formula (27); ref
    predictor(zh, Val{:NS}), src/codim2/NormalForms.jl:1283-1313)."""
    beta1, beta2 = nf["beta1"], nf["beta2"]
    x = torch.real(nf["x0"] + eps ** 2 * (nf["h00010"] * beta1
                                          + nf["h00001"] * beta2
                                          + nf["x"] * nf["q0"]
                                          + nf["h011"]))
    q1, h020, w = nf["q1"], nf["h020"], nf["omega"]

    def orbit(theta):
        return (x + 2 * eps * torch.real(q1 * np.exp(1j * theta))
                + 2 * eps ** 2 * torch.real(h020 * np.exp(2j * theta)))

    # predicted NS angle: the second frequency o1 winds over the orbit
    o1 = np.sqrt(2.0 * abs(np.real(nf["g110"]) * nf["f011"])) * eps
    k = float(np.arccos(np.clip(1.0 - (2 * np.pi * o1 / w) ** 2 / 2.0,
                                -1.0, 1.0)))
    pars = np.real(np.array([nf["p10"], nf["p20"]])
                   + (beta1 * nf["v10"] + beta2 * nf["v01"]) * eps ** 2)
    return {"orbit": orbit, "T": float(2 * np.pi / w), "k": k,
            "hasNS": nf["hasNS"], "p1": float(pars[0]),
            "p2": float(pars[1])}


# ---------------------------------------------------------------------------
# Hopf-Hopf: detailed unfolding + NS predictors (REF1 §9, REF2 §2.3.3)
# ---------------------------------------------------------------------------


def hh_unfolding(prob, x0_tree, params, lens1, lens2,
                 matrix_free: bool = False, precond=None, gmres_opts=None,
                 omegas=None, seeds=None):
    """Detailed HH normal form (ref src/codim2/NormalForms.jl:1459-1533):
    REF1 (9.2)-(9.6) and REF2 (26)/(22)/(28).

    `matrix_free=True`: both (q_k, p_k) pairs by complex bordered
    iteration (pass `omegas=(w1, w2)` to target them; else Arnoldi) and
    the six projection solves through the real-embedded shifted
    operator."""
    fp = _FlatProblem(prob, x0_tree, params)
    if matrix_free:
        Jd, Jtd, gm1, gm2, gm2n = _mf_solver_set(fp, prob, params, precond,
                                                 gmres_opts)
        if omegas is None:
            wa = _estimate_hopf_omega(fp, Jd)
            omegas = (wa, _estimate_hopf_omega(fp, Jd, exclude=(wa,)))
        omegas = tuple(sorted(abs(float(w)) for w in omegas))
        s1_, s2_ = seeds if seeds is not None else (None, None)
        q1, p1, w1 = _mf_hopf_pair(fp, Jd, Jtd, gm2, omegas[0], seed=s1_)
        q2, p2, w2 = _mf_hopf_pair(fp, Jd, Jtd, gm2, omegas[1], seed=s2_)
        solveC = _make_solveC(Jd, gm2n)
    else:
        L = fp.jacobian()
        vals, vecs, valsT, vecsT = _dense_spectrum(L)
        cand = np.where(vals.imag > 1e-8)[0]
        order = cand[np.argsort(np.abs(vals[cand].real))[:2]]
        pair = vals[order]
        srt = np.argsort(pair.imag)
        lam1, lam2 = pair[srt[0]], pair[srt[1]]
        i1, i2 = int(order[srt[0]]), int(order[srt[1]])
        w1, w2 = float(lam1.imag), float(lam2.imag)
        q1 = vecs[:, i1] / torch.linalg.vector_norm(vecs[:, i1])
        q2 = vecs[:, i2] / torch.linalg.vector_norm(vecs[:, i2])
        p1 = vecsT[:, int(np.argmin(np.abs(valsT - np.conj(lam1))))]
        p1 = p1 / np.conj(_dot(p1, q1))
        p2 = vecsT[:, int(np.argmin(np.abs(valsT - np.conj(lam2))))]
        p2 = p2 / np.conj(_dot(p2, q2))
        eye = torch.eye(fp.n, dtype=_C, device=L.device)

        def solveC(sig, b):
            return torch.linalg.solve(sig * eye - L.to(_C), _c(b))
    cq1, cq2 = torch.conj(q1), torch.conj(q2)
    B, C = fp.d2F, fp.d3F

    # REF1 (9.2)-(9.6)
    h2000 = solveC(2j * w1, B(q1, q1))
    h0020 = solveC(2j * w2, B(q2, q2))
    h1010 = solveC(1j * (w1 + w2), B(q1, q2))
    h1001 = solveC(1j * (w1 - w2), B(q1, cq2))
    h1100 = torch.real(solveC(0.0, B(q1, cq1)))
    h0011 = torch.real(solveC(0.0, B(q2, cq2)))

    G2100 = _dot(p1, C(q1, q1, cq1) + B(h2000, cq1) + 2.0 * B(h1100, q1))
    G0021 = _dot(p2, C(q2, q2, cq2) + B(h0020, cq2) + 2.0 * B(h0011, q2))
    G1110 = _dot(p2, C(q1, cq1, q2) + B(h1100, q2) + B(h1010, cq1)
                 + B(torch.conj(h1001), q1))
    G1011 = _dot(p1, C(q1, q2, cq2) + B(h1010, cq2) + B(h1001, q2)
                 + B(h0011, q1))

    # REF2 (26)
    pj1 = _ParamJet(prob, x0_tree, params, lens1)
    pj2 = _ParamJet(prob, x0_tree, params, lens2)
    h000010 = torch.real(solveC(0.0, pj1.J1()))
    h000001 = torch.real(solveC(0.0, pj2.J1()))
    g110 = _dot(p1, B(q1, h000010) + pj1.A1(q1))
    g210 = _dot(p2, B(q2, h000010) + pj1.A1(q2))
    g101 = _dot(p1, B(q1, h000001) + pj2.A1(q1))
    g201 = _dot(p2, B(q2, h000001) + pj2.A1(q2))
    Gam = np.array([[g110, g101], [g210, g201]])

    # REF2 (22)/(28) for each NS family
    f2100 = G2100.real / 2.0
    alpha1 = np.linalg.solve(np.real(Gam), np.array([f2100, G1110.real]))
    dw1_1, dw2_1 = (np.array([G2100.imag / 2.0, G1110.imag])
                    - np.imag(Gam) @ alpha1)
    f0021 = G0021.real / 2.0
    alpha2 = np.linalg.solve(np.real(Gam), np.array([G1011.real, f0021]))
    dw1_2, dw2_2 = (np.array([G1011.imag, G0021.imag / 2.0])
                    - np.imag(Gam) @ alpha2)
    return {
        "x0": fp.flat0, "w1": w1, "w2": w2,
        "q1": q1, "q2": q2, "p1": p1, "p2": p2,
        "G2100": G2100, "G0021": G0021, "G1110": G1110, "G1011": G1011,
        "h1100": h1100, "h0011": h0011, "h2000": h2000, "h0020": h0020,
        "h000010": h000010, "h000001": h000001,
        "ns1": {"alpha": alpha1, "dw1": float(dw1_1), "dw2": float(dw2_1)},
        "ns2": {"alpha": alpha2, "dw1": float(dw1_2), "dw2": float(dw2_2)},
        "p10": float(lens1.get(params)), "p20": float(lens2.get(params)),
    }


def predictor_ns_hh(nf: dict, eps: float, which: int = 1):
    """NS-of-PO predictors from an HH point, one per Hopf family (ref
    predictor(hh, Val{:NS}), src/codim2/NormalForms.jl:1574-1624)."""
    par0 = np.array([nf["p10"], nf["p20"]])
    ns = nf["ns1"] if which == 1 else nf["ns2"]
    shift = (nf["h000010"] * float(ns["alpha"][0])
             + nf["h000001"] * float(ns["alpha"][1]))
    if which == 1:
        x = nf["x0"] + eps ** 2 * (nf["h1100"] - shift)
        q, h2 = nf["q1"], nf["h2000"]
        # own frequency + the OTHER family's frequency wind the NS angle
        w_own = nf["w1"] + ns["dw1"] * eps ** 2
        w_oth = nf["w2"] + ns["dw2"] * eps ** 2
    else:
        x = nf["x0"] + eps ** 2 * (nf["h0011"] - shift)
        q, h2 = nf["q2"], nf["h0020"]
        w_own = nf["w2"] + ns["dw2"] * eps ** 2
        w_oth = nf["w1"] + ns["dw1"] * eps ** 2

    def orbit(theta):
        return (x + 2 * eps * torch.real(q * np.exp(1j * theta))
                + 2 * eps ** 2 * torch.real(h2 * np.exp(2j * theta)))

    k = float(np.mod(w_oth / w_own * 2 * np.pi, 2 * np.pi))
    pars = par0 - ns["alpha"] * eps ** 2
    return {"orbit": orbit, "T": float(2 * np.pi / w_own), "k": k,
            "p1": float(pars[0]), "p2": float(pars[1])}


# ---------------------------------------------------------------------------
# Bogdanov-Takens: detailed unfolding (REF3) + homoclinic predictor
# ---------------------------------------------------------------------------


def bt_unfolding(prob, x0_tree, params, lens1, lens2, pt=None,
                 matrix_free: bool = False, precond=None, gmres_opts=None):
    """Detailed BT normal form following REF3 (ref
    src/codim2/NormalForms.jl:195-340): the parameter transformation
    (K10, K11, K2) and the centre-manifold expansions (H...) that the
    Lindstedt-Poincare homoclinic predictor needs.

    `matrix_free=True` routes every linear solve through the
    preconditioned extended bordered operators (the reference's `bls` and
    `solve_bls_block`, src/codim2/NormalForms.jl:40-41,148-149,258-262):
    nothing materialises the jacobian."""
    from .normal_forms import bt_normal_form

    if pt is None:
        pt = bt_normal_form(prob, x0_tree, params, matrix_free=matrix_free,
                            precond=precond, gmres_opts=gmres_opts)
    a, b = pt.nf["a"], pt.nf["b"]
    fp = _FlatProblem(prob, x0_tree, params)
    like = fp.flat0
    q0, q1 = (torch.as_tensor(v).to(like) for v in pt.zeta)
    p0, p1 = (torch.as_tensor(v).to(like) for v in pt.zeta_star)
    n = fp.n
    B, C3 = fp.d2F, fp.d3F
    if precond is None:
        precond = getattr(prob, "spectral_precond", None)

    if matrix_free:
        gm = _make_ma_gmres(precond, n, 1, gmres_opts)

        def Ainv(dx):
            v, _, _ = solve_bordered_ext(fp.dF, p1, q0, gm, rhs_top=dx,
                                         rhs_bot=0.0)
            return v
    else:
        L = fp.jacobian()

        def Ainv(dx):
            # bordered [L, p1; q0^T, 0] (L singular, ker = span(q0))
            return _bord_solve(L, p1, q0, dx)

    dot = torch.dot
    H2000 = Ainv(2.0 * a * q1 - B(q0, q0))
    gam = float(-2.0 * dot(p0, H2000) + 2.0 * dot(p0, B(q0, q1))
                + dot(p1, B(q1, q1))) / 2.0
    H2000 = H2000 + gam * q0
    H1100 = Ainv(b * q1 + H2000 - B(q0, q1))
    H0200 = Ainv(2.0 * H1100 - B(q1, q1))

    # Hessian-of-(p.F) contractions: A12_i = grad_x <p, J(x) q>, one vjp
    # through a jvp of F
    x0 = fp.x0

    def Hp(p_vec, q_vec):
        return _grad_x_pairing(prob, like, fp.unravel, params, [q_vec],
                               [p_vec])

    A12_1 = Hp(p1, q0)
    A12_2 = Hp(p0, q0) + Hp(p1, q1)

    pj1 = _ParamJet(prob, x0, params, lens1)
    pj2 = _ParamJet(prob, x0, params, lens2)
    J1_1, J1_2 = pj1.J1(), pj2.J1()
    A1 = {(1, 0): pj1.A1(q0), (2, 0): pj2.A1(q0), (1, 1): pj1.A1(q1),
          (2, 1): pj2.A1(q1)}
    A22 = torch.stack([
        torch.stack([dot(p1, A1[1, 0]), dot(p1, A1[2, 0])]),
        torch.stack([dot(p0, A1[1, 0]) + dot(p1, A1[1, 1]),
                     dot(p0, A1[2, 0]) + dot(p1, A1[2, 1])])])

    if matrix_free:
        # 2-border extended operator, preconditioned GMRES (the
        # reference's solve_bls_block, src/codim2/NormalForms.jl:258-262)
        o2 = dict(restart=40, maxiter=240, rtol=1e-10, atol=1e-14)
        if gmres_opts:
            o2.update(gmres_opts)
        gm2b = GMRES(precond=ext_precond(precond, n), **o2)

        def op2(z):
            zx, za, zb = z[:n], z[n], z[n + 1]
            top = fp.dF(zx) + za * J1_1 + zb * J1_2
            r1 = dot(A12_1, zx) + A22[0, 0] * za + A22[0, 1] * zb
            r2 = dot(A12_2, zx) + A22[1, 0] * za + A22[1, 1] * zb
            return torch.cat([top, r1.reshape(1), r2.reshape(1)])

        def solve_block(rhs_top, rhs_bot):
            sol, _, _ = gm2b(op2, torch.cat([rhs_top, rhs_bot]))
            return sol[:n], sol[n:]
    else:
        M = torch.zeros((n + 2, n + 2), dtype=like.dtype, device=like.device)
        M[:n, :n] = L
        M[:n, n] = J1_1
        M[:n, n + 1] = J1_2
        M[n, :n] = A12_1
        M[n + 1, :n] = A12_2
        M[n:, n:] = A22

        def solve_block(rhs_top, rhs_bot):
            sol = torch.linalg.solve(M, torch.cat([rhs_top, rhs_bot]))
            return sol[:n], sol[n:]

    c = float(3.0 * dot(p0, H1100) - dot(p0, B(q1, q1)))
    H0010, K10 = solve_block(q1, torch.stack([dot(p1, B(q1, q1)) / 2.0,
                                              torch.as_tensor(c).to(like)]))
    H0001, K11 = solve_block(torch.zeros_like(like),
                             torch.tensor([0.0, 1.0]).to(like))
    k11 = [float(v) for v in K11]

    # K2 (REF3): the reference has a J2_11 typo in the last term of J2K;
    # the correct quadratic form uses J2_22
    J2_11 = _dd_p2(prob, x0, params, lens1, lens1)
    J2_22 = _dd_p2(prob, x0, params, lens2, lens2)
    J2_12 = _dd_p2(prob, x0, params, lens1, lens2)
    A1H1, A1H2 = pj1.A1(H0001), pj2.A1(H0001)
    k1_ = dot(p1, B(H0001, H0001))
    k2_ = dot(p1, A1H1) * k11[0] + dot(p1, A1H2) * k11[1]
    J2K = (J2_11 * k11[0] ** 2 + 2.0 * J2_12 * k11[0] * k11[1]
           + J2_22 * k11[1] ** 2)
    k3_ = dot(p1, J2K)
    K2 = -(k1_ + 2.0 * k2_ + k3_) * K10
    k2 = [float(v) for v in K2]

    h0002 = (B(H0001, H0001) + A1H1 * (2.0 * k11[0]) + A1H2 * (2.0 * k11[1])
             + J2K + J1_1 * k2[0] + J1_2 * k2[1])
    H0002 = -Ainv(h0002)
    H1001 = -Ainv(B(q0, H0001) + A1[1, 0] * k11[0] + A1[2, 0] * k11[1])
    H0101 = -Ainv(B(q1, H0001) + A1[1, 1] * k11[0] + A1[2, 1] * k11[1]
                  - H1001 - q1)

    C000 = C3(q0, q0, q0)
    h3000 = C000 + 3.0 * B(q0, H2000) - 6.0 * a * H1100
    d = float(dot(p1, h3000)) / 6.0
    H3000 = -Ainv(h3000 - 6.0 * d * q1)

    e = float(dot(p1, C000) + 2.0 * dot(p1, B(q0, H1100))
              + dot(p1, B(q1, H2000)) - 2.0 * b * dot(p1, H1100)
              - 2.0 * a * dot(p1, H0200) - dot(p1, H3000)) / 2.0

    A1H2000 = (pj1.A1(H2000), pj2.A1(H2000))
    h2001 = (C3(q0, q0, H0001) + 2.0 * B(q0, H1001) + B(H0001, H2000)
             + pj1.B1(q0, q0) * k11[0] + pj2.B1(q0, q0) * k11[1]
             + A1H2000[0] * k11[0] + A1H2000[1] * k11[1]
             - 2.0 * a * H0101)
    a1 = float(dot(p1, h2001)) / 2.0
    H2001 = -Ainv(h2001 - 2.0 * a1 * q1)

    b1 = float(dot(p1, C3(q0, q1, H0001))
               + dot(p1, pj1.B1(q0, q1)) * k11[0]
               + dot(p1, pj2.B1(q0, q1)) * k11[1]
               + dot(p1, B(q1, H1001)) + dot(p1, B(H0001, H1100))
               + dot(p1, B(q0, H0101))
               + dot(p1, pj1.A1(H1100)) * k11[0]
               + dot(p1, pj2.A1(H1100)) * k11[1]
               - b * dot(p1, H0101) - dot(p1, H1100)
               - dot(p1, H2001))

    nf = dict(pt.nf)
    nf.update({"K10": K10, "K11": K11, "K2": K2, "gamma": gam, "c": c,
               "d": d, "e": e, "a1": a1, "b1": b1, "H0001": H0001,
               "H0010": H0010, "H0002": H0002, "H1001": H1001,
               "H2000": H2000, "q0": q0, "q1": q1, "x0": like,
               "p10": float(lens1.get(params)),
               "p20": float(lens2.get(params))})
    return nf


def predictor_homoclinic_bt(nf: dict, eps: float):
    """Lindstedt-Poincare homoclinic predictor near a BT point (REF3
    formulas 63/69/71; ref predictor(bt, Val{:HomoclinicCurve}),
    src/codim2/NormalForms.jl:446-506).  Returns the parameter curve
    alpha(eps) and the orbit t -> x(t) (xi = eps * t)."""
    a, b = nf["a"], nf["b"]
    b1, e, d, a1 = nf["b1"], nf["e"], nf["d"], nf["a1"]
    K10, K11, K2 = (_host(nf[k]) for k in ("K10", "K11", "K2"))
    par0 = np.array([nf["p10"], nf["p20"]])
    q0, q1 = nf["q0"], nf["q1"]

    # formula 63
    tau2 = (4.0 / a * (25.0 / 49.0 * b1 - e / b)
            + 2.0 / (49.0 * a ** 2)
            * (144.0 / 49.0 * b ** 2 - 25.0 * b * a1 + 73.0 * d))

    def alpha(ep):
        # formula 69
        return (par0 + (10.0 * b * ep ** 2 / (7.0 * a)) * K11
                + ep ** 4 / a * (-4.0 * K10
                                 + 50.0 * b ** 2 / (49.0 * a) * K2
                                 + b * tau2 * K11))

    def u0(xi):
        return -6.0 / np.cosh(xi) ** 2 + 2.0

    def v0(xi):
        return 12.0 * np.tanh(xi) / np.cosh(xi) ** 2

    def v1(xi):
        return -6.0 * b / (7.0 * a) * np.tanh(xi) * v0(xi)

    def u2(xi):
        return (-3.0 / (49.0 * a ** 2)
                * (6.0 * b ** 2 - 70.0 * b * a1 + 49.0 * d)
                / np.cosh(xi) ** 2
                - 2.0 * (5.0 * a1 * b + 7.0 * d) / (7.0 * a ** 2))

    def orbit(t, ep=eps):
        # formula 71 (u1 = 0)
        xi = float(ep * t)
        return (nf["x0"]
                + (ep ** 2 / a) * (10.0 * b / 7.0 * nf["H0001"]
                                   + u0(xi) * q0)
                + (ep ** 3 / a) * (v0(xi) * q1)
                + (ep ** 4 / a) * (-4.0 * nf["H0010"]
                                   + 50.0 * b ** 2 / (49.0 * a)
                                   * nf["H0002"]
                                   + b * tau2 * nf["H0001"]
                                   + u2(xi) * q0 + v1(xi) * q1
                                   + 1.0 / (2.0 * a) * u0(xi) ** 2
                                   * nf["H2000"]
                                   + 10.0 * b / (7.0 * a) * u0(xi)
                                   * nf["H1001"]))

    pars = alpha(eps)
    return {"alpha": alpha, "orbit": orbit, "tau2": float(tau2),
            "p1": float(pars[0]), "p2": float(pars[1])}


# ---------------------------------------------------------------------------
# the context of a codim-2 point on an MA curve
# ---------------------------------------------------------------------------


def _curve_omega_sp(sp, maprob):
    """Hopf frequency stored in the extended MA state (Hopf curves only)."""
    if getattr(maprob, "ma_kind", None) == "hopf":
        X = torch.as_tensor(sp.x)
        n = maprob.n_inner
        if X.shape[0] > n + 1:
            return abs(float(X[n + 1]))
    return None


def _codim2_point_context(br_codim2, ind_bif):
    """(special point, inner problem, x0 state, params at the point, lens1,
    lens2) of a codim-2 MA curve's special point."""
    gamma = getattr(br_codim2, "gamma", br_codim2)
    sp = gamma.specialpoint[ind_bif]
    maprob = gamma.prob
    n = maprob.n_inner
    X = torch.as_tensor(sp.x)
    par_dict = {"_inner": maprob.inner_lens.set(
        gamma.prob.params["_inner"], float(X[n]))}
    params = maprob.lens.set(par_dict, sp.param)["_inner"]
    return (sp, maprob.inner_prob, maprob.unravel_inner(X[:n]), params,
            maprob.inner_lens, maprob.outer_lens)


def switch_codim2_po(br_codim2, ind_bif: int, contparams, disc=None,
                     eps: float = 0.05, which: int = 1,
                     newton_options=None, verbose: bool = False,
                     as_type=None, **kwargs):
    """Start a PO codim-2 MA curve from a codim-2 equilibrium point (ref
    the :FoldPeriodicOrbitCont / :NS predictors composed with the PO-MA
    continuation, src/codim2/NormalForms.jl:935,1283,1536-1574):

      gh (Bautin)    -> fold-of-PO curve
      zh (Zero-Hopf) -> NS (torus) curve
      hh (Hopf-Hopf) -> NS curve of family `which` (1 or 2)

    The detailed unfolding at the point (matrix-free on a matrix-free
    curve) predicts the orbit, its period and the two parameters at
    amplitude `eps`; Newton on the PO functional at the predicted
    parameters (not for the fold, whose predicted orbit sits at the fold);
    the monodromy eigenpair near the predicted multiplier; then the
    functional PO-MA continuation in the second parameter.  An NS start
    that collapses onto the trivial multiplier falls back to the
    on-branch flow: continue the orbit branch through the predicted point
    with Floquet detection and start the NS curve at the detected
    crossing."""
    from ..core.lens import as_lens
    from ..core.params import NewtonPar
    from ..periodic.codim2 import _po_codim2_from_data
    from ..periodic.collocation import Collocation
    from ..periodic.orbits import newton_po, periodic_orbit_problem

    sp, inner, x, params, lens1, lens2 = _codim2_point_context(
        br_codim2, ind_bif)
    sp_type = as_type or sp.type
    maprob = getattr(br_codim2, "gamma", br_codim2).prob
    mf_kw = {}
    if bool(getattr(maprob, "ma_mf", False)):
        mf_kw = dict(matrix_free=True, precond=getattr(maprob, "precond",
                                                       None))
        om = _curve_omega_sp(sp, maprob)
        if om is not None and sp_type in ("gh", "zh"):
            mf_kw["omega"] = om
    if sp_type == "gh":
        nf = bautin_unfolding(inner, x, params, lens1, lens2, **mf_kw)
        pred = predictor_fold_po(nf, eps)
        kind, theta_pred = "fold", 0.0
    elif sp_type == "zh":
        nf = zh_unfolding(inner, x, params, lens1, lens2, **mf_kw)
        pred = predictor_ns_zh(nf, eps)
        if not pred["hasNS"]:
            raise ValueError(
                "this ZH point has no NS curve (Re(G110) * G011 >= 0)")
        kind, theta_pred = "ns", pred["k"]
    elif sp_type == "hh":
        nf = hh_unfolding(inner, x, params, lens1, lens2, **mf_kw)
        pred = predictor_ns_hh(nf, eps, which=which)
        kind, theta_pred = "ns", pred["k"]
    else:
        raise ValueError(f"point {ind_bif} has type {sp_type!r}; expected "
                         "gh/zh/hh")
    if verbose:
        print(f"switch_codim2_po[{sp_type}->{kind}]: predicted "
              f"(p1, p2) = ({pred['p1']:.6g}, {pred['p2']:.6g}), "
              f"T = {pred['T']:.6g}, theta = {theta_pred:.4g}")

    disc = disc or Collocation(Ntst=40, m=4)
    par_pred = lens2.set(lens1.set(params, pred["p1"]), pred["p2"])
    flat0 = ravel(inner.u0)[0]
    vf = inner.re_make(params=par_pred)
    X0 = disc.generate_solution(pred["orbit"], pred["T"], flat0.shape[0],
                                dtype=flat0.dtype, device=flat0.device)
    if kind == "fold":
        # no plain Newton first: at fixed parameters it walks the predicted
        # fold-amplitude orbit to the nearby regular cycle, after which the
        # MA corrector can collapse onto the zero-amplitude solution; the
        # predicted orbit sits at the fold and goes to the MA corrector
        Xs = X0
    else:
        nopts = newton_options or NewtonPar(tol=1e-9, max_iterations=30)
        sol, _ = newton_po(vf, disc, X0, options=nopts)
        if not bool(sol.converged):
            raise RuntimeError(
                "switch_codim2_po: Newton on the predicted orbit failed; "
                "try a different eps")
        Xs = sol.u

    po_prob = periodic_orbit_problem(vf, disc, Xs,
                                     use_cop=isinstance(disc, Collocation))
    par_po = po_prob.params
    M = disc.monodromy(po_prob.prob_vf, Xs, par_po)
    mult, vecs = dense_eig(M)
    mult_np = _host(mult)
    if kind == "ns":
        cand = np.where(mult_np.imag > 1e-8)[0]
        if len(cand) == 0:
            raise RuntimeError("no complex multiplier pair at the "
                               "predicted NS orbit")
        i0 = int(cand[int(np.argmin(np.abs(mult_np[cand]
                                           - np.exp(1j * theta_pred))))])
        theta = float(np.angle(mult_np[i0]))
    else:
        order = np.argsort(np.abs(mult_np - 1.0))
        i0 = int(order[1]) if len(order) > 1 else int(order[0])
        theta = None
    multT, vecsT = dense_eig(M.T)
    iT = int(np.argmin(np.abs(_host(multT) - np.conj(mult_np[i0]))))
    if verbose:
        print(f"switch_codim2_po: critical multiplier "
              f"{complex(mult_np[i0]):.6g}")
    start = (Xs, pred["p1"], theta, vecs[:, i0], vecsT[:, iT], par_po)
    try:
        out = _po_codim2_from_data(po_prob, start, lens2, contparams, kind,
                                   bp=sp, **kwargs)
        if kind == "ns":
            # the NS sigma vanishes spuriously at theta = 0 (mod 2 pi)
            # through the trivial multiplier: a corrector that escaped to
            # that basin rides the plain orbit family
            thetas = np.asarray(out.gamma._table().get("theta", []))
            if len(thetas) and np.min(np.abs(np.sin(thetas / 2.0))) < 0.02:
                raise RuntimeError("NS MA collapsed onto the trivial "
                                   "multiplier")
        return out
    except RuntimeError as err:
        if kind != "ns":
            raise
        if verbose:
            print(f"switch_codim2_po: direct MA start failed ({err}); "
                  "falling back to on-branch NS detection")
        from ..periodic.codim2 import continuation_ns
        from ..periodic.floquet import FloquetColl
        from ..periodic.orbits import continuation_po

        # sweep axis 1 (p1); where the NS level set is near-tangent to it
        # (Lorenz-84), sweep axis 2 with the parameter roles swapped
        attempts = ((vf, pred["p1"], lens2),
                    (vf.re_make(lens=lens2), pred["p2"], lens1))
        for vf_c, p_c, lens_curve in attempts:
            cpo = contparams.replace(
                ds=abs(contparams.ds), dsmax=max(contparams.dsmax, 0.01),
                p_min=p_c - 0.25, p_max=p_c + 0.25,
                max_steps=20, detect_bifurcation=3, detect_event=0,
                n_inversion=4, tol_stability=1e-5,
                newton_options=contparams.newton_options.replace(
                    linesearch=False, eigsolver=FloquetColl()))
            br_po = continuation_po(vf_c, disc, Xs, cpo,
                                    use_cop=isinstance(disc, Collocation),
                                    floquet="coll", bothside=True)
            ns_pts = [i for i, s2 in enumerate(br_po.gamma.specialpoint)
                      if s2.type == "ns"]
            if ns_pts:
                if verbose:
                    print("switch_codim2_po: NS detected on the orbit "
                          "branch at "
                          f"{br_po.gamma.specialpoint[ns_pts[0]].param:.6g}"
                          f" (sweep lens {as_lens(vf_c.lens).name})")
                out = continuation_ns(br_po, ns_pts[0], lens_curve,
                                      contparams, **kwargs)
                out.bp = sp
                return out
        raise RuntimeError(
            "switch_codim2_po: no NS crossing detected on the orbit "
            "branch around the predicted point (both parameter sweeps)"
        ) from err
