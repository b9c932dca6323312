"""Bogdanov-Takens and cusp normal forms, `newton_bt`, and
`get_normal_form_codim2` at a point detected on a dense fold curve, run by
the JAX package and by the port (mirrors `test_codim2.py:145-202`).

Tolerances, and why:
* coefficients to 1e-8 * max(|c|, 1) against the JAX package's at the same
  point and against the closed forms (a = 1, b = -1 at the exact BT of
  x' = y, y' = b1 + b2 x + x^2 - x y; c = 1 at the cusp of
  u^3 + p1 u + p2); the BT basis is fixed by the same gauge and the
  convention a > 0 in both packages, and the cusp's c does not depend on
  the null vector's sign (p is normalised against q), so nothing is
  aligned;
* a BT located by the curve's event bisection: (a, b) within 1e-2 and
  5e-2 of the exact BT's, as in the JAX test (the bisection stops at
  |b2| ~ 1e-3); `newton_bt` refines it to (b1, b2) = (0, 0) to 1e-7 and
  to the JAX package's Newton from the same point to 1e-8.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu.codim2.normal_forms import (
    bt_normal_form as j_bt_nf, cusp_normal_form as j_cusp_nf)
from bifurcationkit.jl_tpu_torch import interop
from tests._codim2_models import bt_model, close, one_thread, prob, zeros


def _cp(pkg, **kw):
    base = dict(ds=0.01, dsmax=0.05, dsmin=1e-5, p_min=-1.0, p_max=1.0,
                max_steps=150, detect_bifurcation=3, nev=2, n_inversion=4,
                newton_options=pkg.NewtonPar(tol=1e-10, max_iterations=30))
    base.update(kw)
    return pkg.ContinuationPar(**base)


def cusp(pkg):
    def F(u, par):
        return u ** 3 + par["p1"] * u + par["p2"]

    return prob(pkg, F, 1, p1=0.0, p2=0.0)


@pytest.mark.parametrize("pkg_name", ["dense", "mf"])
def test_cusp_normal_form(pkg_name):
    """c = 1 and b20 = 0 at the cusp (0, 0), dense and matrix-free (the
    null pair by bordered inverse iteration, h2 by an extended bordered
    GMRES solve), against the JAX package's dense form."""
    mf = pkg_name == "mf"
    ref = j_cusp_nf(cusp(bj), jnp.zeros(1), cusp(bj).params)
    p = cusp(bt)
    got = bt.cusp_normal_form(p, zeros(bt, 1), p.params, matrix_free=mf)
    close(got.nf["c"], 1.0)
    close(got.nf["c"], ref.nf["c"])
    assert abs(got.nf["b20"]) < 1e-10


@pytest.mark.parametrize("mf", [False, True], ids=["dense", "mf"])
def test_bt_normal_form_exact(mf):
    """a = 1, b = -1 at the exact BT of bt_model, dense and matrix-free,
    the Jordan chains against the JAX package's dense ones to 1e-8, and
    the local fold/Hopf predictors."""
    pj = bt_model(bj, 0.0, 0.0)
    ref = interop.codim2_point_to_numpy(
        j_bt_nf(pj, jnp.zeros(2), pj.params))
    p = bt_model(bt, 0.0, 0.0)
    pt = bt.bt_normal_form(p, zeros(bt, 2), p.params, matrix_free=mf)
    got = interop.codim2_point_to_numpy(pt)
    close(got["nf"]["a"], 1.0)
    close(got["nf"]["b"], -1.0)
    for k in ("zeta", "zeta_star"):
        close(got[k], ref[k])
    preds = bt.bt_predictors(pt, 0.1)
    assert preds["fold"](0.2)["beta1"] == pytest.approx(0.2 ** 2 / 4)
    assert preds["hopf"](0.3) == {"beta1": 0.0, "beta2": -0.3}


@pytest.fixture(scope="module")
def bt_fold_curve():
    """The port's dense fold curve of bt_model in b2 from its fold at
    b1 = 1 (b2 = 2), through the BT at b2 = 0."""
    p = bt_model(bt, 0.5, 2.0)
    br = bt.continuation(p, bt.PALC(), _cp(
        bt, p_min=0.2, p_max=1.5, max_steps=40, detect_bifurcation=2,
        detect_fold=True))
    idx = next(i for i, sp in enumerate(br.specialpoint)
               if sp.type in ("fold", "bp"))
    return bt.continuation_fold(br, idx, "b2", _cp(
        bt, ds=-0.1, dsmax=0.2, p_min=-2.5, p_max=2.5, max_steps=30,
        detect_bifurcation=0, detect_fold=False),
        detect_codim2_bifurcation=2)


def test_get_normal_form_codim2_dense(bt_fold_curve):
    """The fold curve is b1 = b2^2/4 (1e-8); its BT event is routed to
    the dense BT form, which matches the JAX package's form at the same
    point to 1e-8 and the exact BT's (a, b) to the JAX test's bounds."""
    brf = bt_fold_curve
    t = interop.codim2_branch_to_numpy(brf)
    np.testing.assert_allclose(t["p1"], t["param"] ** 2 / 4, atol=1e-8)
    i = next(i for i, sp in enumerate(brf.gamma.specialpoint)
             if sp.type == "bt")
    pt = bt.get_normal_form_codim2(brf, i)
    got = interop.codim2_point_to_numpy(pt)
    assert got["kind"] == "BogdanovTakens"
    assert got["nf"]["a"] == pytest.approx(1.0, abs=1e-2)
    assert got["nf"]["b"] == pytest.approx(-1.0, abs=5e-2)
    b1, b2 = (float(v) for v in got["p"])
    x = interop._to_numpy(pt.x0)
    ref = j_bt_nf(bt_model(bj), jnp.asarray(x), {"b1": b1, "b2": b2})
    close(got["nf"]["a"], ref.nf["a"])
    close(got["nf"]["b"], ref.nf["b"])


def test_newton_bt(bt_fold_curve):
    """`newton_bt` refines the detected BT to (b1, b2) = (0, 0): to 1e-7
    of the exact point and to 1e-8 of the JAX package's Newton on the
    same augmented system from the same start."""
    from bifurcationkit.jl_tpu.core.problem import BifurcationProblem
    from bifurcationkit.jl_tpu.newton import newton as j_newton
    from bifurcationkit.jl_tpu.codim2.minaug import (
        _adjoint_border_solve, _border_solve)
    from bifurcationkit.jl_tpu.codim2.normal_forms import _bt_basis

    brf = bt_fold_curve
    i = next(i for i, sp in enumerate(brf.gamma.specialpoint)
             if sp.type == "bt")
    sol = bt.newton_bt(brf, i)
    assert bool(sol.converged)
    u = sol.u.numpy()
    assert abs(u[-2]) < 1e-7 and abs(u[-1]) < 1e-7
    # the JAX package's augmented system (newton_bt's G) from the same
    # point and borders
    sp = brf.gamma.specialpoint[i]
    X = interop._to_numpy(sp.x)
    pj = bt_model(bj)
    q0, _, _, p1v = _bt_basis(pj.jacobian(jnp.asarray(X[:2]), {
        "b1": float(X[2]), "b2": float(sp.param)}))

    def G(Y, par):
        params = {"b1": Y[2], "b2": Y[3]}
        J = pj.jacobian(Y[:2], params)
        v, sigma = _border_solve(J, par["_a"], par["_b"])
        w, _ = _adjoint_border_solve(J, par["_a"], par["_b"])
        v, w = v / jnp.linalg.norm(v), w / jnp.linalg.norm(w)
        return jnp.concatenate([pj.F(Y[:2], params), jnp.real(sigma)[None],
                                jnp.real(jnp.vdot(w, v))[None]])

    Y0 = jnp.asarray(np.concatenate([X[:3], [float(sp.param)]]))
    ref = j_newton(BifurcationProblem(
        G, u0=Y0, params={"_a": p1v / jnp.linalg.norm(p1v),
                          "_b": q0 / jnp.linalg.norm(q0)}, lens=None),
        bj.NewtonPar(tol=1e-10, max_iterations=30))
    np.testing.assert_allclose(u, np.asarray(ref.u), rtol=0, atol=1e-8)
