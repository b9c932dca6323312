"""Codim-2 normal forms — the port of `jl_tpu/codim2/normal_forms.py` (ref
src/codim2/NormalForms.jl).

* Bogdanov-Takens: Jordan pair (q0, q1) and adjoint pair, quadratic
  coefficients of  xi0' = xi1, xi1' = a xi0^2 + b xi0 xi1
  (ref :141-506; Kuznetsov 8.4), with local fold/Hopf curve predictors.
* Cusp: cubic coefficient c of the reduced equation on the fold curve
  (ref :15-141).
* `get_normal_form_codim2` routes a codim-2 point of a fold or Hopf curve
  to its normal form (bt, cusp, gh = Bautin l2, zh; hh gets the record),
  matrix-free on a matrix-free curve.

The dense routes take a host SVD or eig of the materialised jacobian and
solve on its device; the matrix-free routes run bordered inverse
iterations and extended bordered GMRES solves, every plain J.v through
the model's `jac_op`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..detection.points import BogdanovTakens, Cusp, HopfHopf
from ..linalg.eig import dense_eig
from ..normal_forms.codim1 import _FlatProblem


def _gauge(q0, q1, p0, p1, tag=""):
    """The gauge of the reference (MinAugBT.jl): q0 unit, q1 orthogonal to
    q0 (J q1 = q0 is kept: q0 spans ker J), then the adjoint chain
    biorthonormalised: <p1, q1> = <p0, q0> = 1, <p0, q1> = 0."""
    q1 = q1 - torch.dot(q0, q1) * q0
    s = float(torch.dot(p1, q1))
    if abs(s) < 1e-12:
        raise RuntimeError(f"BT basis{tag}: <p1, q1> ~ 0; the point is not "
                           "a clean BT")
    p1 = p1 / s
    p0 = p0 - torch.dot(p0, q1) * p1
    s0 = float(torch.dot(p0, q0))
    if abs(s0) < 1e-12:
        raise RuntimeError(f"BT basis{tag}: <p0, q0> ~ 0")
    return q0, q1, p0 / s0, p1


def _bt_basis(J):
    """Jordan chain q0, q1 (J q0 = 0, J q1 = q0) and adjoint chain p1, p0
    (J' p1 = 0, J' p0 = p1), normalised so that <p0,q0> = <p1,q1> = 1 and
    <p1,q0> = <p0,q1> = 0 (ref :170-260): the null pair from a host SVD
    (robust at a near-defective jacobian), the generalised vectors by
    least squares."""
    Jh = J.detach().cpu().numpy()
    U, S, Vh = np.linalg.svd(Jh)
    q0 = Vh[-1].real / np.linalg.norm(Vh[-1].real)
    p1 = U[:, -1].real / np.linalg.norm(U[:, -1].real)
    q1 = np.linalg.lstsq(Jh, q0, rcond=None)[0]
    p0 = np.linalg.lstsq(Jh.T, p1, rcond=None)[0]
    as_t = lambda a: torch.as_tensor(a, dtype=J.dtype, device=J.device)  # noqa: E731
    return _gauge(as_t(q0), as_t(q1), as_t(p0), as_t(p1))


def _bt_basis_mf(fp, prob, params, precond=None, gmres_opts=None, seed=None,
                 sweeps: int = 3):
    """Matrix-free BT Jordan chains through the bordered solver (ref
    src/codim2/NormalForms.jl:148-262).  At a bisection-located BT the
    zero eigenvalue is defective up to a residual delta: plain inverse
    iteration is O(sqrt(delta)) inaccurate there, so q0 and p1 come from
    singular-vector iteration (alternating J and J^T bordered solves, the
    matrix-free analogue of the dense SVD), and the generalised vectors
    solve [J, p1; q0^T, 0][q1; s] = [q0; 0] (the border row is the
    q0-orthogonal gauge).  `seed` starts the iteration (default: a CPU
    `torch.Generator` with a fixed seed)."""
    from .minaug_mf import _make_ma_gmres, solve_bordered_ext
    from .unfolding import _seed_vector

    like = fp.flat0
    if precond is None:
        precond = getattr(prob, "spectral_precond", None)
    gm = _make_ma_gmres(precond, fp.n, 1, gmres_opts)
    Jd, Jtd = fp.dF, fp.dFt
    q0 = (_seed_vector(fp.n, 29, like) if seed is None
          else torch.as_tensor(seed).to(like))
    q0 = q0 / torch.linalg.vector_norm(q0)
    p1 = q0
    for _ in range(sweeps):
        # at a BT the [0; 1]-driven bordered solve returns the null vector
        # in one application; re-anchoring polishes a near-BT point
        v, _, _ = solve_bordered_ext(Jd, p1, q0, gm)
        w, _, _ = solve_bordered_ext(Jtd, q0, p1, gm)
        q0 = v / torch.linalg.vector_norm(v)
        p1 = w / torch.linalg.vector_norm(w)
    q1, _, _ = solve_bordered_ext(Jd, p1, q0, gm, rhs_top=q0, rhs_bot=0.0)
    p0, _, _ = solve_bordered_ext(Jtd, q0, p1, gm, rhs_top=p1, rhs_bot=0.0)
    return _gauge(q0, q1, p0, p1, " (mf)")


def bt_normal_form(prob, x0, params, verbose: bool = False,
                   matrix_free: bool = False, precond=None,
                   gmres_opts=None, seed=None):
    """BT quadratic coefficients a, b (ref :141-340):
    a = <p1, B(q0,q0)>/2,  b = <p1, B(q0,q1)> + <p0, B(q0,q0)>.

    `matrix_free=True` computes the Jordan chains by bordered
    singular-vector iteration and preconditioned extended solves, the
    PDE-scale route for BT points on matrix-free fold curves."""
    fp = _FlatProblem(prob, x0, params)
    if matrix_free:
        q0, q1, p0, p1 = _bt_basis_mf(fp, prob, params, precond=precond,
                                      gmres_opts=gmres_opts, seed=seed)
    else:
        q0, q1, p0, p1 = _bt_basis(fp.jacobian())
    Bq0q0 = fp.d2F(q0, q0)
    a = float(torch.dot(p1, Bq0q0)) / 2.0
    b = float(torch.dot(p1, fp.d2F(q0, q1)) + torch.dot(p0, Bq0q0))
    # (a, b) ~ (-a, -b) under the basis flip (q0,q1,p0,p1) -> -(...); the
    # convention a > 0 fixes it (the invariants are sign(a b) and |a|, |b|)
    if a < 0:
        a, b = -a, -b
        q0, q1, p0, p1 = -q0, -q1, -p0, -p1
    pt = BogdanovTakens(x0=fp.flat0, p=None, params=params, lens=prob.lens,
                        zeta=(q0, q1), zeta_star=(p0, p1),
                        nf={"a": a, "b": b}, prob=prob)
    if verbose:
        print(f"BT normal form: a = {a:.6g}, b = {b:.6g}")
    return pt


def bt_predictors(bt: BogdanovTakens, ds: float):
    """Local curve predictors from a BT point in normal-form coordinates
    (beta1, beta2) (ref :342-506), for the unfolding
    eta1' = eta2, eta2' = beta1 + beta2 eta1 + a eta1^2 + b eta1 eta2."""
    a = bt.nf["a"]

    def fold(s):
        """Fold curve: discriminant zero, beta1 = beta2^2 / (4a)."""
        return {"beta2": s, "beta1": s * s / (4.0 * a)}

    def hopf(s):
        """Hopf curve: the eta1 = 0 equilibrium with det = -beta2 > 0:
        {beta1 = 0, beta2 = -|s|}."""
        return {"beta1": 0.0, "beta2": -abs(s)}

    return {"fold": fold, "hopf": hopf}


def cusp_normal_form(prob, x0, params, verbose: bool = False,
                     matrix_free: bool = False, precond=None,
                     gmres_opts=None, seed=None):
    """Cubic coefficient at a cusp (ref :15-141): with (q, p) the null pair
    of J (b20 = 0 at the cusp), c = <p, C(q,q,q) + 3 B(q, h2)>/6 where
    L h2 = -E(B(q,q)).

    `matrix_free=True`: the null pair by bordered inverse iteration and h2
    through the preconditioned extended bordered operator."""
    from .minaug_mf import solve_bordered_ext

    fp = _FlatProblem(prob, x0, params)
    n = fp.n
    like = fp.flat0
    if matrix_free:
        from ..normal_forms.codim1 import null_basis_iter
        from .unfolding import _mf_solver_set, _seed_vector

        Jd, Jtd, gm1, _, _ = _mf_solver_set(fp, prob, params, precond,
                                            gmres_opts)
        start = (_seed_vector(n, 31, like) if seed is None
                 else torch.as_tensor(seed).to(like))
        q, p = null_basis_iter(Jd, Jtd, start, gm1)
    else:
        J = fp.jacobian()
        vals, vecs = dense_eig(J)
        q = torch.real(vecs[:, int(np.argmin(np.abs(
            vals.cpu().numpy().real)))]).to(like.dtype)
        valsT, vecsT = dense_eig(J.T)
        p = torch.real(vecsT[:, int(np.argmin(np.abs(
            valsT.cpu().numpy().real)))]).to(like.dtype)
    q = q / torch.linalg.vector_norm(q)
    p = p / torch.dot(p, q)
    Bqq = fp.d2F(q, q)
    b20 = float(torch.dot(p, Bqq))
    rhs = -Bqq + torch.dot(p, Bqq) * q          # E(-B(q, q))
    if matrix_free:
        h2, _, _ = solve_bordered_ext(Jd, p, q, gm1, rhs_top=rhs,
                                      rhs_bot=0.0)
    else:
        # bordered solve [J p; q' 0][h2; s] = [E(-Bqq); 0]
        A = torch.zeros((n + 1, n + 1), dtype=J.dtype, device=J.device)
        A[:n, :n], A[:n, n], A[n, :n] = J, p, q
        h2 = torch.linalg.solve(A, torch.cat([rhs, torch.zeros_like(
            rhs[:1])]))[:n]
    c = float(torch.dot(p, fp.d3F(q, q, q) + 3.0 * fp.d2F(q, h2))) / 6.0
    pt = Cusp(x0=fp.flat0, p=None, params=params, lens=prob.lens,
              zeta=q, zeta_star=p, nf={"c": c, "b20": b20}, prob=prob)
    if verbose:
        print(f"Cusp normal form: c = {c:.6g} (b20 = {b20:.3g})")
    return pt


def newton_bt(br_codim2, ind_bif: int, lens2=None, options=None,
              verbose: bool = False):
    """Newton refinement of a Bogdanov-Takens point in (x, p1, p2) (ref
    newton_bt, src/codim2/MinAugBT.jl:277-440).

    Augmented system G(x, p1, p2) = (F, sigma, <w, v>): sigma is the fold
    minimally augmented test and <w, v> the BT test, both from dense
    bordered solves that `torch.func.jacfwd` differentiates."""
    from ..core.params import NewtonPar
    from ..core.problem import BifurcationProblem
    from ..core.state import ravel
    from ..newton import newton as _newton
    from .minaug import _adjoint_border_solve, _border_solve

    gamma = getattr(br_codim2, "gamma", br_codim2)
    sp = gamma.specialpoint[ind_bif]
    maprob = gamma.prob
    inner = maprob.inner_prob
    n = maprob.n_inner
    unravel = maprob.unravel_inner
    inner_lens = maprob.inner_lens
    lens2_optic = maprob.lens          # optic over the MA param dict
    Xsp = torch.as_tensor(sp.x)
    x0, p1_0, p2_0 = Xsp[:n], float(Xsp[n]), float(sp.param)
    base_inner = gamma.prob.params["_inner"]

    def at(par_inner, pp1, pp2):
        params = inner_lens.set(par_inner, pp1)
        return lens2_optic.set({"_inner": params}, pp2)["_inner"]

    # anchor the borders at the starting point
    q0, _, _, p1v = _bt_basis(inner.jacobian(unravel(x0),
                                             at(base_inner, p1_0, p2_0)))
    a = p1v / torch.linalg.vector_norm(p1v)
    b = q0 / torch.linalg.vector_norm(q0)

    def G(Y, par):
        params = at(par["_inner"], Y[n], Y[n + 1])
        F = ravel(inner.F(unravel(Y[:n]), params))[0]
        J = inner.jacobian(unravel(Y[:n]), params)
        v, sigma = _border_solve(J, par["_a"], par["_b"])
        w, _ = _adjoint_border_solve(J, par["_a"], par["_b"])
        v = v / torch.linalg.vector_norm(v)
        w = w / torch.linalg.vector_norm(w)
        bt = torch.real(torch.sum(torch.conj(w) * v))
        return torch.cat([F, torch.real(sigma).reshape(1), bt.reshape(1)])

    Y0 = torch.cat([x0, torch.tensor([p1_0, p2_0], dtype=x0.dtype,
                                     device=x0.device)])
    prob_bt = BifurcationProblem(
        G, u0=Y0, params={"_inner": base_inner, "_a": a, "_b": b},
        lens=None)
    sol = _newton(prob_bt, options or NewtonPar(tol=1e-10,
                                                max_iterations=30))
    if verbose:
        print(f"newton_bt: converged={bool(sol.converged)} (p1, p2) = "
              f"({float(sol.u[n]):.8g}, {float(sol.u[n + 1]):.8g})")
    return sol


def _curve_omega(X, n, maprob):
    """Hopf frequency stored in the extended MA state (Hopf curves only)."""
    if getattr(maprob, "ma_kind", None) == "hopf" and X.shape[0] > n + 1:
        return abs(float(X[n + 1]))
    return None


def get_normal_form_codim2(br_codim2, ind_bif: int, verbose: bool = False,
                           matrix_free=None, **nf_kwargs):
    """Normal form at a detected codim-2 special point of a fold or Hopf
    MA curve (bt/cusp/gh/zh/hh).  On a matrix-free curve bt, cusp, gh and
    zh default to the iterative route (gh is the full matrix-free Bautin
    l2); `matrix_free=False` forces the dense one.  The iterations start
    from the curve's own anchor `_b` where it has one (at a BT or cusp the
    anchors are the fold's null pair)."""
    from ..normal_forms.bautin import bautin_normal_form
    from .unfolding import _codim2_point_context
    from .zh_hh import zh_normal_form

    gamma = getattr(br_codim2, "gamma", br_codim2)
    sp, inner, x, params, _, _ = _codim2_point_context(br_codim2, ind_bif)
    maprob = gamma.prob
    n = maprob.n_inner
    X = torch.as_tensor(sp.x)
    p1 = float(X[n])
    mf = bool(getattr(maprob, "ma_mf", False)) if matrix_free is None \
        else matrix_free
    kw = dict(nf_kwargs)
    mf_kw = {}
    if mf:
        mf_kw = dict(matrix_free=True,
                     precond=getattr(maprob, "precond", None))
        if sp.type in ("bt", "cusp") and "_b" in gamma.prob.params:
            kw.setdefault("seed", gamma.prob.params["_b"])
        om = _curve_omega(X, n, maprob)
        if sp.type in ("gh", "zh") and om is not None:
            kw.setdefault("omega", om)
    if sp.type == "bt":
        pt = bt_normal_form(inner, x, params, verbose=verbose, **mf_kw,
                            **kw)
    elif sp.type == "cusp":
        pt = cusp_normal_form(inner, x, params, verbose=verbose, **mf_kw,
                              **kw)
    elif sp.type == "gh":
        pt = bautin_normal_form(inner, x, params, verbose=verbose, **mf_kw,
                                **kw)
    elif sp.type == "zh":
        pt = zh_normal_form(inner, x, params, verbose=verbose, **mf_kw, **kw)
    elif sp.type == "hh":
        # hh_normal_form exists, but its coefficient conventions are still
        # experimental: the record with eigen data, as the JAX package does
        return HopfHopf(x0=X[:n], p=(p1, sp.param), params=params,
                        lens=inner.lens, prob=inner)
    else:
        raise ValueError(f"point {ind_bif} has type {sp.type!r}; expected a "
                         "codim-2 type (bt/cusp/gh/zh/hh)")
    pt.p = (p1, sp.param)
    return pt
