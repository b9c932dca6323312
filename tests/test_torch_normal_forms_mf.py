"""The matrix-free normal forms at PDE scale, the port against the JAX
package from the same points (mirrors `test_minaug_mf.py::
test_normal_form1d_mf_parity`, `::test_hopf_nf_mf_parity_cgl2d` — here on
the Brusselator, cgl2d comes with the periodic-orbit slice — and
`test_mittelmann.py::test_mittelmann_nd_nf_mf_parity`,
`::test_mittelmann_multicontinuation_d4`).

* SH2d at 60x40 (the domain cut with the grid, so the mesh width stays the
  flagship's): the 1d normal form at the first bp of the branch that
  `test_torch_sh2d_branch.py` holds step for step against JAX
  (p = -0.10081828 in both), its point recomputed by one Newton solve.
* The 32-site Brusselator at its exact Hopf point (the homogeneous state
  is a root for every l; l* is where the leading pair crosses, found by
  bracketing), with the DIA `jac_op` on the port side.
* Mittelmann's Gelfand-Bratu problem on an 8x8 square: the flat branch
  started just above its 2d branch point, which both packages detect at
  lam* = u* e^-u*, u* = 1 + |lambda_1(Delta)|/10 (the modes cos x and
  cos y), and above its simple branch point (the mode cos x cos y, at
  u* = 1 + 2|lambda_1|/10), where the port's dense route is held against
  its matrix-free one and branch switching leaves the flat state.

Tolerances, and why:
* 1d coefficients: 1e-8 relative to max(|c|, 1), zeta's sign aligned —
  the JAX test's bound; both routes stop their GMRES at 1e-10;
* Hopf a and b: 1e-8 relative; omega 1e-9 — the JAX test's bounds;
* Nd: the eigenvalues of b11 (basis invariant) to 1e-8, |a01| < 1e-7,
  the 8 predicted states to 1e-8 — the JAX test's bounds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import brentq
from scipy.special import lambertw

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu import models as jmodels
from bifurcationkit.jl_tpu.continuation.results import ContResult as JResult
from bifurcationkit.jl_tpu.detection.points import SpecialPoint as JPoint
from bifurcationkit.jl_tpu.normal_forms import codim1 as j1
from bifurcationkit.jl_tpu.normal_forms import codim1_nd as jnd
from bifurcationkit.jl_tpu.ops import DIAMatrix as JDIA
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch import models as tmodels
from bifurcationkit.jl_tpu_torch.continuation.results import ContResult
from bifurcationkit.jl_tpu_torch.detection.points import SpecialPoint
from bifurcationkit.jl_tpu_torch.normal_forms import codim1 as t1
from bifurcationkit.jl_tpu_torch.normal_forms import codim1_nd as tnd
from bifurcationkit.jl_tpu_torch.ops import DIAMatrix

from test_torch_brusselator_branch import _dia_jac_op

NF_KEYS = ("a01", "b11", "b20", "b30")
P_BP = -0.10081828     # the 60x40 branch's first bp, in both packages


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, rtol=1e-8):
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1.0)


def _same_1d(nf_a, nf_b):
    a, b = interop.normal_form_to_numpy(nf_a), interop.normal_form_to_numpy(
        nf_b)
    assert a["kind"] == b["kind"]
    sign = float(np.sign(np.dot(a["zeta"], b["zeta"])))
    for key in NF_KEYS:
        s = sign if key in ("a01", "b20") else 1.0
        assert _close(a["nf"][key], s * b["nf"][key]), \
            (key, a["nf"][key], b["nf"][key])


def _sh_point(nx, ny, p):
    """The cut-domain SH2d problem of both packages and a root at p (one
    Newton solve of the port from the model's u0), as numpy."""
    dom = dict(lx=8 * np.pi * nx / 151, ly=4 * np.pi / np.sqrt(3) * ny / 100)
    pt = tmodels.swift_hohenberg_2d(Nx=nx, Ny=ny, device="cpu", **dom)
    pt = pt.re_make(params=pt.set_lens_param(
        pt.params, torch.tensor(p, dtype=torch.float64)))
    ls = bt.GMRES(restart=40, maxiter=300, rtol=1e-12,
                  precond=pt.spectral_precond)
    sol = bt.newton(pt, bt.NewtonPar(tol=1e-9, max_iterations=25,
                                     linsolver=ls))
    assert sol.converged
    return pt, jmodels.swift_hohenberg_2d(Nx=nx, Ny=ny, **dom), \
        sol.u.numpy()


def _at(prob, x, p, pkg):
    """A one-point branch holding the bp (x, p) of either package."""
    if pkg is bj:
        return JResult(prob=prob, specialpoint=[JPoint(
            type="bp", param=p, x=jnp.asarray(x), status="converged",
            delta=(1, 0))])
    return ContResult(prob=prob, specialpoint=[SpecialPoint(
        type="bp", param=p, x=torch.as_tensor(x), status="converged",
        delta=(1, 0))])


def test_sh2d_1d_normal_form_mf_matches_jax():
    pt, pj, x = _sh_point(60, 40, P_BP)
    nf_t = t1.get_normal_form1d(pt, _at(pt, x, P_BP, bt), 0,
                                matrix_free=True)
    nf_j = j1.get_normal_form1d(pj, _at(pj, x, P_BP, bj), 0,
                                matrix_free=True)
    _same_1d(nf_t, nf_j)
    # the switched branch's first guess, from either package's form
    pred_t, pred_j = bt.predictor(nf_t, -0.003), bj.predictor(nf_j, -0.003)
    assert pred_t["p"] == pytest.approx(pred_j["p"], abs=1e-12)
    assert abs(pred_t["amp"]) == pytest.approx(abs(pred_j["amp"]), rel=1e-8)


def test_brusselator_hopf_normal_form_matches_jax():
    n = 32
    pt = tmodels.brusselator_1d(n=n, device="cpu").re_make(
        jac_op=_dia_jac_op(torch, DIAMatrix, n))
    pj = jmodels.brusselator_1d(n=n).re_make(
        jac_op=_dia_jac_op(jnp, JDIA, n))

    def spectrum(l):
        J = pt.jacobian(pt.u0, pt.set_lens_param(pt.params, l))
        return np.linalg.eigvals(J.numpy())

    l_star = brentq(lambda l: spectrum(l).real.max(), 0.3, 0.8, xtol=1e-14)
    w = spectrum(l_star)
    omega = float(abs(w[np.argmax(w.real)].imag))
    assert abs(w.real.max()) < 1e-12
    # the unpreconditioned real-embedded system has 2(2n) + 2 unknowns
    opts = dict(restart=4 * n + 2, maxiter=4 * (4 * n + 2))
    x = pt.u0.numpy()
    hp_j = j1.hopf_normal_form_point(pj, jnp.asarray(x), l_star, omega,
                                     matrix_free=True, gmres_opts=opts)
    ref = interop.normal_form_to_numpy(hp_j)
    for kw in ({}, dict(matrix_free=True, gmres_opts=opts)):
        hp = t1.hopf_normal_form_point(pt, torch.as_tensor(x), l_star, omega,
                                       **kw)
        got = interop.normal_form_to_numpy(hp)
        for key in ("a", "b"):
            assert _close(got["nf"][key], ref["nf"][key]), (kw, key)
        assert abs(got["omega"] - ref["omega"]) < 1e-9
        assert hp.subtype == hp_j.subtype
        # the orbit guess is phase invariant in its amplitude and period
        pred, pred_j = bt.predictor(hp, 0.01), bj.predictor(hp_j, 0.01)
        assert pred["period"] == pytest.approx(pred_j["period"], rel=1e-9)
        assert pred["amp"] == pytest.approx(pred_j["amp"], rel=1e-8)


MIT_N = 8
LAM1 = 2 * (np.cos(np.pi / MIT_N) - 1) * MIT_N ** 2   # lambda_1(Delta)


def _mittelmann_branch(pkg, u_star):
    """The flat Mittelmann branch of a package from just above the branch
    point at the flat state u_star, down through it."""
    lam0 = u_star * np.exp(-u_star) + 0.001
    u0 = float(-lambertw(-lam0, -1).real)     # the flat upper-branch root
    if pkg is bj:
        prob = jmodels.mittelmann(Nx=MIT_N, Ny=MIT_N).re_make(
            u0=jnp.full((MIT_N, MIT_N), u0), params={"lam": lam0})
    else:
        prob = tmodels.mittelmann(Nx=MIT_N, Ny=MIT_N, device="cpu")
        prob = prob.re_make(
            u0=torch.full((MIT_N, MIT_N), u0, dtype=torch.float64),
            params={"lam": torch.tensor(lam0, dtype=torch.float64)})
    cp = pkg.ContinuationPar(
        ds=-0.002, dsmax=0.01, dsmin=1e-5, p_min=0.01, p_max=3.5,
        max_steps=6, detect_bifurcation=3, nev=16, n_inversion=6,
        tol_stability=1e-6,
        newton_options=pkg.NewtonPar(tol=1e-9, max_iterations=20))
    return prob, pkg.continuation(prob, pkg.PALC(), cp)


@pytest.fixture(scope="module")
def mittelmann_nd():
    """Both packages' flat Mittelmann branch through its 2d branch point."""
    u_star = 1 - LAM1 / 10
    out = {}
    for pkg in (bj, bt):
        prob, br = _mittelmann_branch(pkg, u_star)
        nds = [i for i, sp in enumerate(br.specialpoint) if sp.type == "nd"]
        assert nds
        out[pkg] = (prob, br, nds[0])
    pj, pt = out[bj][1].specialpoint[out[bj][2]], \
        out[bt][1].specialpoint[out[bt][2]]
    assert pt.delta == pj.delta and abs(pt.delta[0]) == 2
    assert pt.param == pytest.approx(pj.param, abs=1e-10)
    assert pt.param == pytest.approx(u_star * np.exp(-u_star), abs=1e-5)
    return out


def test_mittelmann_nd_normal_form_mf_matches_jax(mittelmann_nd):
    prob_j, br_j, i_j = mittelmann_nd[bj]
    prob_t, br_t, i_t = mittelmann_nd[bt]
    nf_j = jnd.get_normal_form_nd(prob_j, br_j, i_j, matrix_free=True)
    nf_m = tnd.get_normal_form_nd(prob_t, br_t, i_t, matrix_free=True)
    nf_d = tnd.get_normal_form_nd(prob_t, br_t, i_t)
    ref = np.sort(np.linalg.eigvals(nf_j.nf["b11"]).real)
    for nf in (nf_m, nf_d):
        np.testing.assert_allclose(
            np.sort(np.linalg.eigvals(nf.nf["b11"]).real), ref, rtol=1e-8)
        assert np.linalg.norm(nf.nf["a01"]) < 1e-7
    X = {}
    for name, nf, preds in (("jax", nf_j, jnd.nd_branch_predictors),
                            ("mf", nf_m, tnd.nd_branch_predictors),
                            ("dense", nf_d, tnd.nd_branch_predictors)):
        pr = preds(nf, 0.001, n_trials=5)
        assert len(pr) == 8                   # D4: 4 stripes + 4 diagonals
        X[name] = np.stack([np.asarray(p["x1"]) for p in pr])
    for name in ("mf", "dense"):
        D = np.linalg.norm(X[name][:, None, :] - X["jax"][None, :, :], axis=2)
        assert np.max(D.min(axis=1)) < 1e-8, name


def test_mittelmann_multicontinuation_d4(mittelmann_nd):
    """The 2d point splits into the D4 pattern: 8 switched branches, each
    converged away from the flat state."""
    prob, br, i = mittelmann_nd[bt]
    cp = br.contparams.replace(ds=0.001, max_steps=4, detect_bifurcation=0,
                               save_sol_every_step=1)
    nf, branches = bt.multicontinuation(br, i, cp)
    assert nf.N == 2 and len(branches) == 8
    for b in branches:
        x = b.gamma.sol[-1]["x"].numpy()
        assert np.ptp(x) > 1e-4


def test_mittelmann_simple_bp_dense_matches_mf_and_switches():
    """At the simple branch point of the flat branch: the dense normal form
    (jacfwd + host eig) equals the matrix-free one (bordered inverse
    iteration + GMRES), and aBS there gives a non-flat branch (mirrors
    `test_mittelmann.py::test_mittelmann_simple_bp_switch`)."""
    u_star = 1 - 2 * LAM1 / 10
    prob, br = _mittelmann_branch(bt, u_star)
    bps = [i for i, sp in enumerate(br.specialpoint) if sp.type == "bp"]
    assert bps
    sp = br.specialpoint[bps[0]]
    assert sp.param == pytest.approx(u_star * np.exp(-u_star), abs=1e-5)
    _same_1d(t1.get_normal_form1d(prob, br, bps[0]),
             t1.get_normal_form1d(prob, br, bps[0], matrix_free=True))
    cp = br.contparams.replace(ds=0.001, max_steps=6, detect_bifurcation=0,
                               save_sol_every_step=1)
    b = bt.continuation_from_bp(br, bps[0], cp)
    assert np.ptp(b.gamma.sol[-1]["x"].numpy()) > 1e-4
