"""Codim-1 normal forms (ref src/NormalForms.jl) — the port of
`jl_tpu/normal_forms/codim1.py`.

Lyapunov–Schmidt reduction at simple branch points (1d kernel) and the
Hopf first Lyapunov coefficient, each by a dense route (host eig of the
materialised jacobian) and a matrix-free one (bordered inverse iteration
and GMRES on the extended operator, every J.v through the problem's
`jac_op`).  The reference convention is kept throughout:
`inner(x, y) = sum(conj(x) * y)` and the reduced equations

    1d:   a01*dp + a02*dp^2/2 + b11*x*dp + b20*x^2/2 + b30*x^3/6
    Hopf: da = a*dp*z + b*z|z|^2   (b = first Lyapunov coefficient)

Complex directions are torch complex tensors on the state's device; the
jets split them into real and imaginary parts, since F is real.  The
mixed derivative d/dp (J v) is taken from F itself (a jvp in u nested in
a jvp in p), never through `jac_op`: a hand-written kernel carries no
tangent in p.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import jvp, vjp

from ..core.problem import re_im_rows, weighted_sum
from ..core.state import ravel
from ..detection.points import (BranchPoint, Fold, Hopf, Pitchfork,
                                Transcritical)
from ..linalg.bordered import MatrixBLS
from ..linalg.eig import dense_eig
from ..linalg.linear import GMRES


# ---------------------------------------------------------------------------
# flat-space wrappers around the problem's derivative operators
# ---------------------------------------------------------------------------


class _FlatProblem:
    """View of a BifurcationProblem at one point (x0, parbif), acting on
    the raveled state.  The jacobian operator (`jac_op` where the model
    gives one) and the transpose (a vjp of F) are built once, for the
    lifetime of the view."""

    def __init__(self, prob, x0, parbif):
        self.prob = prob
        self.parbif = parbif
        self.flat0, self.unravel = ravel(x0)
        self.n = self.flat0.shape[0]
        self._J = None
        self._Jt = None

    @property
    def x0(self):
        return self.unravel(self.flat0)

    def _as_state(self, v):
        """A real flat direction as a state at the primal dtype (saved
        eigenvectors may come from an f32 stability sweep)."""
        return self.unravel(v.to(self.flat0.dtype))

    def _p(self, p):
        return torch.as_tensor(p, dtype=self.flat0.dtype,
                               device=self.flat0.device)

    def jacobian(self):
        return self.prob.jacobian(self.x0, self.parbif)

    def dF(self, v):
        """J(x0) v, through the operator built once at the point."""
        if v.is_complex():
            return torch.complex(self.dF(v.real), self.dF(v.imag))
        if self._J is None:
            self._J = self.prob.jacobian_operator(self.x0, self.parbif)
        return ravel(self._J(self._as_state(v)))[0]

    def dFt(self, v):
        """J(x0)^T v: the model's adjoint where it gives one, else one vjp
        of F built at the point."""
        if self._Jt is None:
            if self.prob.jac_adjoint is not None:
                self._Jt = self.prob.jac_adjoint(self.x0, self.parbif)
            else:
                _, fn = vjp(lambda x: self.prob.F(x, self.parbif), self.x0)
                self._Jt = lambda d: fn(d)[0]
        return ravel(self._Jt(self._as_state(v)))[0]

    def forms(self, form, tuples):
        """A real multilinear form (`prob.d2F` ... `prob.d5F`) at x0 on a
        list of direction tuples of one order, complex directions
        extended by multilinearity (2^k real evaluations, weights i^(number
        of imaginary parts)).  All the tuples' real evaluations go through
        `form` in ONE `torch.func.vmap` call: a nested jvp of F costs about
        the same per call whatever its batch (on the CPU 10 ms for the
        2nd form to 400 ms for the 5th), so a normal form gathers the
        forms it needs per stage.  A problem with `forms_rows(order, x,
        params, rows)` evaluates all the real rows itself, in one call.
        Returns one flat result per tuple."""
        rows, owner, weight = [], [], []
        for t, vs in enumerate(tuples):
            r, w = re_im_rows(vs)
            rows += r
            weight += w
            owner += [t] * len(r)

        def one(*ds):
            return ravel(form(self.x0, self.parbif,
                              *[self.unravel(d) for d in ds]))[0]

        rows_fn = getattr(self.prob, "forms_rows", None)
        if rows_fn is not None:
            # a problem that evaluates its own forms on many directions at
            # once (the Poincare return map's jets through the flow)
            terms = rows_fn(len(rows[0]), self.flat0, self.parbif,
                            [tuple(d.to(self.flat0.dtype) for d in r)
                             for r in rows])
        else:
            cols = [torch.stack(c).to(self.flat0.dtype)
                    for c in zip(*rows)]
            terms = (torch.func.vmap(one)(*cols) if len(rows) > 1
                     else one(*[c[0] for c in cols])[None])
        out = []
        for t, vs in enumerate(tuples):
            idx = [i for i, o in enumerate(owner) if o == t]
            out.append(weighted_sum(terms[idx], [weight[i] for i in idx])
                       if any(v.is_complex() for v in vs)
                       else terms[idx[0]])
        return out

    def _multilinear(self, form, vs):
        return self.forms(form, [vs])[0]

    def d2F(self, v1, v2):
        return self._multilinear(self.prob.d2F, (v1, v2))

    def forms_batch(self, form, *blocks):
        """A real multilinear form (`prob.d2F`, `prob.d3F`) at x0 on a
        batch of real direction tuples, the rows of the (k, n) `blocks`,
        in one vmapped call: (k, n)."""
        def one(*cols):
            return ravel(form(self.x0, self.parbif,
                              *[self._as_state(c) for c in cols]))[0]

        return torch.func.vmap(one)(*blocks)

    def d3F(self, v1, v2, v3):
        return self._multilinear(self.prob.d3F, (v1, v2, v3))

    def d4F(self, v1, v2, v3, v4):
        return self._multilinear(self.prob.d4F, (v1, v2, v3, v4))

    def d5F(self, v1, v2, v3, v4, v5):
        return self._multilinear(self.prob.d5F, (v1, v2, v3, v4, v5))

    def _param_fd(self, p):
        """A problem's own parameter derivatives at the point, where it
        brings them (`param_derivatives(params, p)`: the Poincare return
        map, whose forward AD in p would run through the whole flow)."""
        hook = getattr(self.prob, "param_derivatives", None)
        return None if hook is None else hook(self.parbif, p)

    def dFdp_at(self, p):
        """Exact d/dp of the residual through the lens at x0."""
        fd = self._param_fd(p)
        if fd is not None:
            return fd.dFdp(self.flat0)
        x0 = self.x0

        def f(pp):
            par = self.prob.set_lens_param(self.parbif, pp)
            return ravel(self.prob.residual(x0, par))[0]

        pt = self._p(p)
        return jvp(f, (pt,), (torch.ones_like(pt),))[1]

    def d2Fdp2_at(self, p):
        fd = self._param_fd(p)
        if fd is not None:
            return fd.d2Fdp2(self.flat0)
        pt = self._p(p)
        return jvp(self.dFdp_at, (pt,), (torch.ones_like(pt),))[1]

    def dFdp_dir(self, v, p):
        """d/dp [ J(x0, p) v ] — the mixed derivative R11 applied to v,
        a jvp of F in u nested in a jvp in p (the same quantity as the
        JAX package's jvp in p of `prob.dF`; a `jac_op` kernel carries no
        tangent in p, so F is differentiated instead)."""
        if v.is_complex():
            return torch.complex(self.dFdp_dir(v.real, p),
                                 self.dFdp_dir(v.imag, p))
        fd = self._param_fd(p)
        if fd is not None:
            return fd.dFdp_dir(self.flat0, v.to(self.flat0.dtype))
        x0, vv = self.x0, self._as_state(v)

        def jv(pp):
            par = self.prob.set_lens_param(self.parbif, pp)
            out = jvp(lambda x: self.prob.F(x, par), (x0,), (vv,))[1]
            return ravel(out)[0]

        pt = self._p(p)
        return jvp(jv, (pt,), (torch.ones_like(pt),))[1]


def _inner(x, y):
    """VI.inner convention: sum(conj(x) * y)."""
    return complex(torch.sum(torch.conj(x) * y))


def _normalize(v):
    return v / torch.linalg.vector_norm(v)


def get_adjoint_basis(Lt, lam):
    """Left eigenvector for the eigenvalue closest to `lam`
    (ref get_adjoint_basis, src/NormalForms.jl:27-43)."""
    vals, vecs = dense_eig(Lt, with_vectors=True)
    vals_np = vals.cpu().numpy()
    idx = int(np.argmin(np.abs(vals_np - lam)))
    return vecs[:, idx], vals_np[idx]


def null_basis_iter(Jd, Jtd, seed, gmres, iters: int = 3,
                    rayleigh_iters: int = 2):
    """Matrix-free (right, left) critical-eigenvector pair of a
    (near-)singular real operator by bordered inverse iteration: one
    extended bordered solve per sweep concentrates v onto the null
    direction (the extended operator is nonsingular), and re-anchoring
    converges quadratically.  `rayleigh_iters` extra sweeps with the
    Rayleigh-quotient shift lock onto the exact eigenvector of the
    eigenvalue nearest zero (the point is only near the singularity when
    bisection located it).  Jᵀv comes from a vjp.  Returns
    (zeta, zeta_ad) with ||zeta|| = 1, ||zeta_ad|| = 1."""
    from ..codim2.minaug_mf import solve_bordered_ext

    def sweep(a, b, lam):
        v, _, _ = solve_bordered_ext(lambda d: Jd(d) - lam * d, a, b, gmres)
        w, _, _ = solve_bordered_ext(lambda d: Jtd(d) - lam * d, b, a, gmres)
        return _normalize(v), _normalize(w)

    b = _normalize(seed)
    a = b
    for _ in range(iters):
        b, a = sweep(a, b, 0.0)
    for _ in range(rayleigh_iters):
        lam = torch.dot(b, Jd(b))           # ||b|| = 1
        b, a = sweep(a, b, lam)
    return b, a


def hopf_null_basis_iter(Jd, Jtd, omega, seed_r, seed_i, gm2,
                         iters: int = 3, rayleigh_iters: int = 2):
    """Matrix-free (right, left) eigenvector pair of a real operator J at
    the complex eigenvalue nearest ``i*omega`` by bordered inverse
    iteration in the real embedding: each sweep solves the extended
    bordered systems [J - (alpha + i om) I, a; b^H, 0][v; s] = [0; 1]
    (forward) and its adjoint, then re-anchors; `rayleigh_iters` extra
    sweeps with the complex Rayleigh-quotient shift lock onto the exact
    pair, refining omega along the way (ref src/NormalForms.jl:1009-1064).

    Returns (zr, zi, wr, wi, alpha, omega_ref): zeta = zr + i*zi (right,
    ||zeta|| = 1), w = wr + i*wi (left, ||w|| = 1, not normalized against
    zeta), and the refined eigenvalue alpha + i*omega_ref (omega_ref > 0)."""
    from ..codim2.minaug_mf import solve_bordered_ext_cplx

    def sweep(ar, ai, br_, bi, alpha, om):
        vr, vi, _, _, _ = solve_bordered_ext_cplx(
            lambda d: Jd(d) - alpha * d, -om, ar, ai, br_, bi, gm2)
        wr, wi, _, _, _ = solve_bordered_ext_cplx(
            lambda d: Jtd(d) - alpha * d, om, br_, bi, ar, ai, gm2)
        nv = torch.sqrt(torch.dot(vr, vr) + torch.dot(vi, vi))
        nw = torch.sqrt(torch.dot(wr, wr) + torch.dot(wi, wi))
        return vr / nv, vi / nv, wr / nw, wi / nw

    def rayleigh(zr, zi):
        # lambda = z^H J z with ||z|| = 1  (J real)
        Jzr, Jzi = Jd(zr), Jd(zi)
        return (torch.dot(zr, Jzr) + torch.dot(zi, Jzi),
                torch.dot(zr, Jzi) - torch.dot(zi, Jzr))

    nrm = torch.sqrt(torch.dot(seed_r, seed_r) + torch.dot(seed_i, seed_i))
    zr, zi = seed_r / nrm, seed_i / nrm
    ar, ai = zr, zi
    alpha = 0.0
    om = float(omega)
    for _ in range(iters):
        zr, zi, ar, ai = sweep(ar, ai, zr, zi, alpha, om)
    for _ in range(rayleigh_iters):
        alpha, om = rayleigh(zr, zi)
        if float(om) < 0:
            # omega > 0 convention: conjugate the iterate
            zi, ai, om = -zi, -ai, -om
        zr, zi, ar, ai = sweep(ar, ai, zr, zi, alpha, om)
    alpha, om_ref = rayleigh(zr, zi)
    if float(om_ref) < 0:
        zi, ai, om_ref = -zi, -ai, -om_ref
    return zr, zi, ar, ai, float(alpha), float(om_ref)


def _bifpoint_eigen(br, sp, which: Optional[int] = None):
    """Eigen-elements at a special point: prefer those stored on the point."""
    ind = sp.ind_ev if which is None else which
    ind = max(int(ind) - 1, 0)
    if sp.eigenvals is None:
        raise ValueError("special point carries no eigen-elements; rerun "
                         "continuation with detect_bifurcation >= 2")
    lam = sp.eigenvals[ind]
    zeta = None
    if sp.eigenvecs is not None:
        zeta = torch.as_tensor(sp.eigenvecs)[:, ind]
    return lam, zeta, ind


# ---------------------------------------------------------------------------
# 1d kernel (ref get_normal_form1d, src/NormalForms.jl:189-357)
# ---------------------------------------------------------------------------


def get_normal_form1d(prob, br, ind_bif: int, verbose: bool = False,
                      tol_fold: float = 1e-3, bls=None,
                      matrix_free: bool = False, precond=None,
                      gmres_opts: Optional[dict] = None):
    """1d-kernel Lyapunov-Schmidt normal form (ref get_normal_form1d,
    src/NormalForms.jl:189-357).  With `matrix_free=True` nothing
    materializes the jacobian: (zeta, zeta*) come from bordered inverse
    iteration (vjp transpose) and the two bordered projections run
    preconditioned GMRES on the extended operator — the PDE-scale route
    (`get_normal_form(br, 19)` at 15,100 dof, ref
    examples/SH2d-fronts.jl:95)."""
    from ..codim2.minaug_mf import _make_ma_gmres, solve_bordered_ext

    sp = br.specialpoint[ind_bif]
    if sp.type not in ("bp", "fold"):
        raise ValueError(f"point {ind_bif} is of type {sp.type!r}, not a "
                         "branch point with 1d kernel")
    p = sp.param
    parbif = prob.set_lens_param(br.prob.params if br.prob else prob.params,
                                 p)
    fp = _FlatProblem(prob, sp.x, parbif)
    like = fp.flat0

    try:
        lam, zeta, ind = _bifpoint_eigen(br, sp)
    except ValueError:
        # fold-by-monotony points carry no eigen-elements; the critical
        # eigenvalue is 0 by definition and zeta comes from the fallback
        # (dense eig / bordered inverse iteration) below
        lam, zeta, ind = 0.0, None, 0
    lam = float(np.real(lam))

    if matrix_free:
        if precond is None:
            precond = getattr(prob, "spectral_precond", None)
        gm = _make_ma_gmres(precond, fp.n, 1, gmres_opts)
        if zeta is None:
            seed = torch.as_tensor(
                np.random.default_rng(17).standard_normal(fp.n))
        else:
            seed = torch.real(zeta)
        # saved eigenvectors may be f32 (LOBPCG compute_dtype sweeps); the
        # bordered iteration runs at the state dtype
        seed = seed.to(dtype=like.dtype, device=like.device)
        zeta, zeta_ad = null_basis_iter(fp.dF, fp.dFt, seed, gm)
        L = None

        def bls(Lop, col, row, dzp, R, nb, dotp=None):
            Psi, s, cv = solve_bordered_ext(fp.dF, col, row, gm, rhs_top=R,
                                            rhs_bot=nb)
            return Psi, s, cv, 0
    else:
        bls = bls or MatrixBLS()
        L = fp.jacobian()
        if zeta is None:
            vals, vecs = dense_eig(L)
            ind = int(np.argmin(np.abs(vals.real.cpu().numpy())))
            zeta = vecs[:, ind]
        zeta = _normalize(torch.real(zeta).to(dtype=like.dtype,
                                              device=like.device))
        # adjoint kernel basis
        zeta_ad, _ = get_adjoint_basis(L.T, lam)
        zeta_ad = torch.real(zeta_ad).to(like.dtype)
    inner_zz = _inner(zeta, zeta_ad)
    if abs(inner_zz) < 1e-10:
        raise RuntimeError("<zeta, zeta*> ~ 0; increase nev")
    zeta_ad = zeta_ad / np.real(inner_zz)

    def E(x):
        """Projection onto Range(L): x - <x, zeta*> zeta."""
        return x - torch.real(torch.sum(torch.conj(x) * zeta_ad)) * zeta

    def vdot(x, y):
        return torch.sum(torch.conj(x) * y)

    R01 = fp.dFdp_at(p)
    R02 = fp.d2Fdp2_at(p)
    a01 = _inner(R01, zeta_ad).real

    # Psi01 from bordered solve [L zeta*; zeta' 0][Psi; s] = [E(-R01); 0]
    Psi01, _, _, _ = bls(L, zeta_ad, zeta, 0.0, E(-R01), 0.0, dotp=vdot)

    R11 = fp.dFdp_dir(zeta, p)
    b11 = _inner(R11 + fp.d2F(zeta, Psi01), zeta_ad).real

    R11Psi = fp.dFdp_dir(Psi01, p)
    a02 = _inner(R02 + 2 * R11Psi + fp.d2F(Psi01, Psi01), zeta_ad).real

    b2v = fp.d2F(zeta, zeta)
    b20 = _inner(b2v, zeta_ad).real

    Psi20, _, _, _ = bls(L, zeta_ad, zeta, 0.0, E(-b2v), 0.0, dotp=vdot)
    b3v = fp.d3F(zeta, zeta, zeta) + 3 * fp.d2F(zeta, Psi20)
    b30 = _inner(b3v, zeta_ad).real

    nf = {"a01": a01, "a02": a02, "b11": b11, "b20": b20, "b30": b30,
          "Psi01": Psi01, "Psi20": Psi20}
    if verbose:
        print(f"normal form: a01={a01:.6g} a02={a02:.6g} b11={b11:.6g} "
              f"b20/2={b20/2:.6g} b30/6={b30/6:.6g}")

    common = dict(x0=fp.flat0, p=p, params=parbif, lens=prob.lens,
                  zeta=zeta, zeta_star=zeta_ad, nf=nf, prob=prob)
    if max(abs(a01), abs(b11)) > 1e-10:
        if abs(a01) < tol_fold:
            if 100 * abs(b20 / 2) < abs(b30 / 6):
                out = Pitchfork(**common)
            else:
                out = Transcritical(**common)
        else:
            out = Fold(**common)
    else:
        out = BranchPoint(**common)
    out.tau = sp.tau
    out.unravel = fp.unravel
    return out


# ---------------------------------------------------------------------------
# Hopf (ref hopf_normal_form / __hopf_normal_form, src/NormalForms.jl:987-1205)
# ---------------------------------------------------------------------------


def hopf_normal_form(prob, br, ind_hopf: int, verbose: bool = False,
                     **kwargs):
    sp = br.specialpoint[ind_hopf]
    if sp.type != "hopf":
        raise ValueError(f"point {ind_hopf} is not a Hopf point "
                         f"(type={sp.type!r})")
    lam, zeta, ind = _bifpoint_eigen(br, sp)
    # ensure omega > 0 convention
    if np.imag(lam) < 0:
        lam = np.conj(lam)
        zeta = None if zeta is None else torch.conj(zeta)
    return hopf_normal_form_point(prob, sp.x, sp.param,
                                  omega=float(np.imag(lam)), zeta=zeta,
                                  tau=sp.tau, verbose=verbose, **kwargs)


def _hopf_point(prob, fp, p, parbif, omega, zeta, zeta_ad, tau, nf):
    b = nf["b"]
    hp = Hopf(x0=fp.flat0, p=p, params=parbif, lens=prob.lens, zeta=zeta,
              zeta_star=zeta_ad, omega=float(omega), prob=prob, nf=nf)
    hp.subtype = ("SuperCritical" if b.real < 0 else
                  "SubCritical" if b.real > 0 else "Singular")
    hp.tau = tau
    hp.unravel = fp.unravel
    return hp


def hopf_normal_form_point(prob, x, p, omega, zeta=None, tau=None,
                           verbose: bool = False,
                           matrix_free: bool = False, precond=None,
                           gmres_opts: Optional[dict] = None,
                           low_dtype="auto",
                           eig_iters: int = 3, rayleigh_iters: int = 2):
    """Hopf normal form from a raw point (x, p, omega) (ref
    hopf_normal_form, src/NormalForms.jl:987-1205).

    With `matrix_free=True` nothing materializes the jacobian: (zeta,
    zeta*) come from complex bordered inverse iteration
    (`hopf_null_basis_iter`, vjp transpose), Psi001/Psi110 run GMRES on
    J / -J, Psi200 the real-embedded (2i*omega - J) solve, and `a` uses
    the exact parameter jvp.  `low_dtype="auto"` means full precision on
    the card; an explicit `low_dtype=torch.float32` runs every Krylov
    matvec on an f32 twin with refinement at the state's precision."""
    if matrix_free:
        return _hopf_normal_form_point_mf(
            prob, x, p, omega, zeta=zeta, tau=tau, verbose=verbose,
            precond=precond, gmres_opts=gmres_opts, low_dtype=low_dtype,
            eig_iters=eig_iters, rayleigh_iters=rayleigh_iters)
    parbif = prob.set_lens_param(prob.params, p)
    fp = _FlatProblem(prob, x, parbif)
    L = fp.jacobian()
    cdt = torch.complex128 if L.dtype == torch.float64 else torch.complex64
    L_np = L.detach().cpu().numpy().astype(np.float64)
    dev = L.device

    lam = 1j * omega
    if zeta is None:
        vals_np, vecs_np = np.linalg.eig(L_np)
        ind = int(np.argmin(np.abs(vals_np - lam)))
        zeta = vecs_np[:, ind]
        if np.imag(vals_np[ind]) < 0:
            zeta = np.conj(zeta)
    zeta = _normalize(torch.as_tensor(zeta, device=dev).to(cdt))

    valsT, vecsT = np.linalg.eig(L_np.T)
    zeta_ad = torch.as_tensor(
        vecsT[:, int(np.argmin(np.abs(valsT - np.conj(lam))))],
        device=dev).to(cdt)
    # normalize: dot(zeta, zeta_ad) = sum(conj(zeta) zeta_ad) = 1
    zeta_ad = zeta_ad / torch.sum(torch.conj(zeta) * zeta_ad)

    czeta = torch.conj(zeta)
    Lc = L.to(cdt)

    def R2(a, b):
        return fp.d2F(a, b) / 2.0

    def R3(a, b, c):
        return fp.d3F(a, b, c) / 6.0

    R01 = fp.dFdp_at(p)
    Psi001 = torch.linalg.solve(L, -R01)

    av = fp.dFdp_dir(zeta, p) + 2.0 * R2(zeta, Psi001)
    a = _inner(av, zeta_ad)

    # (2 i omega - L) Psi200 = R20(zeta, zeta)
    eye = torch.eye(fp.n, dtype=cdt, device=dev)
    Psi200 = torch.linalg.solve(2j * omega * eye - Lc,
                                R2(zeta, zeta).to(cdt))
    # -L Psi110 = 2 R2(zeta, conj zeta); rhs is real
    Psi110 = torch.linalg.solve(-Lc, (2.0 * R2(zeta, czeta)).to(cdt))

    bv = 2.0 * R2(zeta, Psi110) + 2.0 * R2(czeta, Psi200) \
        + 3.0 * R3(zeta, zeta, czeta)
    b = _inner(bv, zeta_ad)

    if verbose:
        print(f"Hopf normal form: a={a:.6g}, b={b:.6g} "
              f"({'supercritical' if b.real < 0 else 'subcritical'})")
    return _hopf_point(prob, fp, p, parbif, omega, zeta, zeta_ad, tau,
                       {"a": a, "b": b, "Psi001": Psi001, "Psi110": Psi110,
                        "Psi200": Psi200})


def _hopf_normal_form_point_mf(prob, x, p, omega, zeta=None, tau=None,
                               verbose: bool = False, precond=None,
                               gmres_opts: Optional[dict] = None,
                               low_dtype="auto", eig_iters: int = 3,
                               rayleigh_iters: int = 2):
    """Matrix-free Hopf normal form (see hopf_normal_form_point).  All
    complex arithmetic is split into real parts; the three Psi solves run
    GMRES, Psi200 on the real 2n embedding (ref src/NormalForms.jl:1037-1064)."""
    from ..codim2.minaug_mf import (_cast_tree, _ir_solve, _make_ma_gmres,
                                    ext_precond2)

    parbif = prob.set_lens_param(prob.params, p)
    fp = _FlatProblem(prob, x, parbif)
    n = fp.n
    like = fp.flat0
    if precond is None:
        precond = getattr(prob, "spectral_precond", None)
    # mixed precision pays only where f64 is emulated (a TPU); on the card
    # "auto" keeps the state's precision
    lo = None if low_dtype == "auto" else low_dtype

    Jd, Jtd = fp.dF, fp.dFt
    gm2 = _make_ma_gmres(precond, n, 2, gmres_opts)
    o = dict(restart=40, maxiter=240, rtol=1e-10, atol=1e-14)
    if gmres_opts:
        o.update(gmres_opts)
    pre1 = ((lambda v: ravel(precond(v))[0]) if precond is not None
            else None)
    pre2 = ext_precond2(precond, n) if precond is not None else None
    gm_n = GMRES(precond=pre1, **o)
    gm_2n = GMRES(precond=pre2, **o)
    Jd_lo = gm_n_lo = gm_2n_lo = None
    if lo is not None:
        lo_o = dict(restart=o["restart"], maxiter=o["maxiter"],
                    rtol=max(float(o.get("rtol", 1e-10)), 3e-5), atol=0.0)
        gm_n_lo = GMRES(precond=pre1, **lo_o)
        gm_2n_lo = GMRES(precond=pre2, **lo_o)
        J_lo = prob.jacobian_operator(_cast_tree(fp.x0, lo),
                                      _cast_tree(parbif, lo))

        def Jd_lo(d):
            return ravel(J_lo(fp.unravel(d)))[0]

    def solve(op_hi, op_lo, rhs, gm, gm_lo):
        """Mixed-precision (or plain) GMRES solve of op_hi x = rhs."""
        if lo is not None:
            return _ir_solve(op_hi, op_lo, rhs, gm_lo, lo)[0]
        return gm(op_hi, rhs)[0]

    # (zeta, zeta*) by complex bordered inverse iteration from the best seed
    if zeta is None:
        rng = np.random.default_rng(23)
        seed_r = torch.as_tensor(rng.standard_normal(n))
        seed_i = torch.as_tensor(rng.standard_normal(n))
    else:
        zc = torch.as_tensor(zeta)
        if not zc.is_complex():
            zc = torch.complex(zc, torch.zeros_like(zc))
        seed_r, seed_i = zc.real, zc.imag
    seed_r = seed_r.to(dtype=like.dtype, device=like.device)
    seed_i = seed_i.to(dtype=like.dtype, device=like.device)
    if not bool(torch.any(seed_i != 0)):
        # a purely real seed collapses the complex iteration onto a real
        # ray; rotate a quarter period via J (z_i ~ J z_r / omega)
        seed_i = Jd(seed_r) / max(abs(omega), 1e-8)
    zr, zi, wr, wi, alpha, om_ref = hopf_null_basis_iter(
        Jd, Jtd, omega, seed_r, seed_i, gm2, iters=eig_iters,
        rayleigh_iters=rayleigh_iters)
    om = om_ref if abs(om_ref - abs(omega)) < 0.2 * abs(om_ref) + 1e-8 \
        else abs(omega)

    # zeta_ad scaled so <zeta, zeta_ad> = sum(conj(zeta) zeta_ad) = 1
    cr = torch.dot(zr, wr) + torch.dot(zi, wi)
    ci = torch.dot(zr, wi) - torch.dot(zi, wr)
    c2 = cr * cr + ci * ci
    ar = (wr * cr + wi * ci) / c2
    ai = (wi * cr - wr * ci) / c2

    def cdot(vr, vi):
        """<v, zeta_ad> = sum(conj(v) zeta_ad) for v = vr + i vi."""
        return complex(torch.dot(vr, ar) + torch.dot(vi, ai),
                       torch.dot(vr, ai) - torch.dot(vi, ar))

    d2, d3 = fp.d2F, fp.d3F

    # Psi001 = J^{-1} (-R01)   (J nonsingular at a Hopf point)
    R01 = fp.dFdp_at(p)
    Psi001 = solve(Jd, Jd_lo, -R01, gm_n, gm_n_lo)

    # a = <R11(zeta) + 2 R2(zeta, Psi001), zeta_ad>
    a = cdot(fp.dFdp_dir(zr, p) + d2(zr, Psi001),
             fp.dFdp_dir(zi, p) + d2(zi, Psi001))

    # R20 = R2(z, z) (complex), R11c = R2(z, conj z) (real)
    R20_r = 0.5 * (d2(zr, zr) - d2(zi, zi))
    R20_i = d2(zr, zi)
    R11c = 0.5 * (d2(zr, zr) + d2(zi, zi))

    # Psi200: (2 i om - J) Psi = R20, real embedding
    def shifted(J, omx):
        def op(zv):
            pr, pi = zv[:n], zv[n:]
            return torch.cat([-J(pr) - 2 * omx * pi, -J(pi) + 2 * omx * pr])

        return op

    sol2 = solve(shifted(Jd, om), shifted(Jd_lo, om) if lo else None,
                 torch.cat([R20_r, R20_i]), gm_2n, gm_2n_lo)
    P200_r, P200_i = sol2[:n], sol2[n:]

    # Psi110: -J Psi = 2 R2(z, conj z)
    P110 = solve(lambda d: -Jd(d), (lambda d: -Jd_lo(d)) if lo else None,
                 2.0 * R11c, gm_n, gm_n_lo)

    # bv = 2 R2(z, Psi110) + 2 R2(conj z, Psi200) + 3 R3(z, z, conj z)
    bv_r = (d2(zr, P110) + (d2(zr, P200_r) + d2(zi, P200_i))
            + 0.5 * (d3(zr, zr, zr) + d3(zi, zi, zr)))
    bv_i = (d2(zi, P110) + (d2(zr, P200_i) - d2(zi, P200_r))
            + 0.5 * (d3(zr, zr, zi) + d3(zi, zi, zi)))
    b = cdot(bv_r, bv_i)

    if verbose:
        print(f"Hopf normal form (matrix-free): a={a:.6g}, b={b:.6g} "
              f"({'supercritical' if b.real < 0 else 'subcritical'})")
    return _hopf_point(prob, fp, p, parbif, om, torch.complex(zr, zi),
                       torch.complex(ar, ai), tau,
                       {"a": a, "b": b, "Psi001": Psi001, "Psi110": P110,
                        "Psi200": torch.complex(P200_r, P200_i)})


# ---------------------------------------------------------------------------
# predictors (ref predictor(...), src/NormalForms.jl:389-536, 1227-1282)
# ---------------------------------------------------------------------------


def predictor(bp, ds: float, verbose: bool = False, ampfactor: float = 1.0):
    if isinstance(bp, Transcritical):
        nf = bp.nf
        pnew = bp.p + ds
        amp = -2 * ds * nf["b11"] / nf["b20"] * ampfactor
        if amp == 0:
            amp = abs(ds)
        x1 = bp.x0 + amp * torch.real(bp.zeta) - ds * nf["Psi01"]
        xm1 = bp.x0 - amp * torch.real(bp.zeta) + ds * nf["Psi01"]
        return {"x0": bp.x0, "x1": x1, "xm1": xm1, "p": pnew,
                "pm1": bp.p - ds, "amp": amp, "dsfactor": 1.0}
    if isinstance(bp, Pitchfork):
        nf = bp.nf
        dsfactor = 1.0 if nf["b11"] * nf["b30"] < 0 else -1.0
        amp = ampfactor * np.sqrt(max(-6 * abs(ds) * dsfactor * nf["b11"]
                                      / nf["b30"], 0.0))
        if amp == 0:
            amp = abs(ds)
        pnew = bp.p + abs(ds) * dsfactor
        x1 = bp.x0 + amp * torch.real(bp.zeta)
        return {"x0": bp.x0, "x1": x1, "p": pnew, "amp": amp,
                "dsfactor": dsfactor, "dp": pnew - bp.p}
    if isinstance(bp, Hopf):
        return hopf_predictor(bp, ds, verbose=verbose, ampfactor=ampfactor)
    if isinstance(bp, Fold):
        return None
    if isinstance(bp, BranchPoint):
        # generic quadratic normal form: find zero directions of the reduced
        # equation on a circle of radius |ds| (ref _predictor, :495-536)
        nf = bp.nf
        ads = abs(ds)

        def g(x, pp):
            return ((nf["a01"] + nf["a02"] * pp / 2) * pp
                    + (nf["b11"] * pp + nf["b20"] * x / 2
                       + nf["b30"] * x ** 2 / 6) * x)

        thetas = np.linspace(0, 2 * np.pi, 100_000)
        vals = g(ads * np.cos(thetas), ads * np.sin(thetas))
        sign_flips = np.where(np.sign(vals[1:]) * np.sign(vals[:-1]) < 0)[0]
        if len(sign_flips) == 0:
            return None
        # pick the direction least aligned with the current branch tangent
        tau = bp.tau
        tau_zeta = float(torch.sum(ravel(tau.u)[0] * torch.real(bp.zeta)))
        best, best_dot = None, np.inf
        for i in sign_flips:
            c, s = ads * np.cos(thetas[i]), ads * np.sin(thetas[i])
            d = abs(tau_zeta * c + s * float(tau.p))
            if d < best_dot:
                best_dot, best = d, (c, s)
        c, s = best
        pnew = bp.p + s
        x1 = bp.x0 + c * torch.real(bp.zeta)
        return {"x0": bp.x0, "x1": x1, "p": pnew, "amp": c, "dsfactor": 1.0}
    raise TypeError(f"no predictor for {type(bp)}")


def hopf_predictor(hp: Hopf, ds: float, verbose: bool = False,
                   ampfactor: float = 1.0):
    """Second-order periodic-orbit guess from the Hopf normal form
    (ref predictor(hp::Hopf, ds), src/NormalForms.jl:1227-1282)."""
    nf = hp.nf
    a, b = nf["a"], nf["b"]
    dsfactor = 1 if a.real * b.real < 0 else -1
    dsnew = abs(ds) * dsfactor
    pnew = hp.p + dsnew
    amp = ampfactor * np.sqrt(max(-dsnew * a.real / b.real, 0.0))
    omega = hp.omega + (a.imag - b.imag * a.real / b.real) * dsnew

    def orbit(t):
        A = amp * np.exp(1j * t)
        return (hp.x0 + 2 * torch.real(hp.zeta * A)
                + dsnew * torch.real(nf["Psi001"])
                + abs(A) ** 2 * torch.real(nf["Psi110"])
                + 2 * torch.real(A ** 2 * nf["Psi200"]))

    return {"orbit": orbit, "amp": 2 * amp, "omega": omega,
            "period": abs(2 * np.pi / omega), "p": pnew,
            "dsfactor": dsfactor, "dp": dsnew}


# ---------------------------------------------------------------------------
# dispatcher (ref get_normal_form, src/NormalForms.jl:130-177)
# ---------------------------------------------------------------------------


def get_normal_form(br, ind_bif: int, prob=None, verbose: bool = False,
                    **kwargs):
    gamma = getattr(br, "gamma", br)
    prob = prob or gamma.prob
    if hasattr(prob, "disc"):
        # periodic-orbit branches: the Poincare return map's normal form
        # (or Iooss with method="iooss")
        from ..periodic.normal_forms import get_normal_form_po

        return get_normal_form_po(gamma, ind_bif, verbose=verbose, **kwargs)
    br = gamma
    sp = br.specialpoint[ind_bif]
    if sp.type == "hopf":
        return hopf_normal_form(prob, br, ind_bif, verbose=verbose,
                                **kwargs)
    if sp.type in ("bp", "fold", "nd"):
        from .codim1_nd import get_normal_form_nd

        if abs(sp.delta[0]) > 1 or sp.type == "nd":
            return get_normal_form_nd(prob, br, ind_bif, verbose=verbose,
                                      **kwargs)
        return get_normal_form1d(prob, br, ind_bif, verbose=verbose, **kwargs)
    raise ValueError(f"no normal form available for point type {sp.type!r}")
