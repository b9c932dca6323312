"""Codim-1 normal forms and branch switching on small problems with
closed-form values, run by the JAX package and by the port from the same
problems and options (mirrors `test_normal_forms.py`).

Tolerances, and why:
* gold values: those of the JAX tests (a01, b20 ~ 0 to 1e-6, b11 to 1e-5,
  b30 to 1e-4; Hopf a to 1e-4, b to 1e-3, omega to 1e-4);
* coefficients against the JAX package's: 1e-9 relative to max(|c|, 1)
  after aligning zeta's sign (b20 and a01 flip with it) — the same dense
  formulas on branch points that agree to the bisection's 1e-10;
* Hopf a and b: 1e-9 relative (invariant under zeta's phase);
* the pitchfork's switched branch: |u| = sqrt(p) to 1e-4 relative, as in
  the JAX test, and the port's branch against the JAX one to 1e-8;
* Nd: the normal-form tensors to 1e-9 (the decoupled system's kernel
  basis is the coordinate basis up to order and sign, aligned below);
  the 8 predictors' points to 1e-8; at least 4 switched branches, as the
  JAX test asks (only the port continues them: the JAX package compiles
  its step anew for each of the 8 restarted problems).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu import models as jmodels
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch import models as tmodels
from bifurcationkit.jl_tpu_torch.detection.points import (
    Hopf, NdBranchPoint, Pitchfork, Transcritical)

PKGS = {"jax": (bj, jmodels, {}), "torch": (bt, tmodels, {"device": "cpu"})}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cp(pkg, **kw):
    base = dict(ds=0.01, dsmax=0.05, dsmin=1e-4, p_min=-1.0, p_max=1.0,
                max_steps=200, detect_bifurcation=3, nev=2, n_inversion=6,
                max_bisection_steps=30,
                newton_options=pkg.NewtonPar(tol=1e-10))
    base.update(kw)
    return pkg.ContinuationPar(**base)


def _branches(model, **kw):
    """The model's branch in both packages."""
    out = {}
    for name, (pkg, models, dev) in PKGS.items():
        prob = getattr(models, model)(p=-0.5, **kw, **dev)
        out[name] = (prob, pkg.continuation(prob, pkg.PALC(), _cp(pkg)))
    return out


@pytest.fixture(scope="module")
def pitchfork():
    return _branches("pitchfork_1d")


def _close(a, b, rtol):
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1.0)


def _same_1d_form(nf_t, nf_j, rtol=1e-9):
    t = interop.normal_form_to_numpy(nf_t)
    j = interop.normal_form_to_numpy(nf_j)
    assert t["kind"] == j["kind"]
    sign = float(np.sign(np.dot(t["zeta"], j["zeta"])))
    for key, flips in (("a01", True), ("a02", False), ("b11", False),
                       ("b20", True), ("b30", False)):
        s = sign if flips else 1.0
        assert _close(t["nf"][key], s * j["nf"][key], rtol), \
            (key, t["nf"][key], j["nf"][key])
    np.testing.assert_allclose(t["zeta"], sign * j["zeta"], atol=1e-9)
    assert t["p"] == pytest.approx(j["p"], abs=1e-10)
    return t


def test_pitchfork_nf_coefficients(pitchfork):
    nfs = {k: PKGS[k][0].get_normal_form(br, 0)
           for k, (_, br) in pitchfork.items()}
    nf = nfs["torch"]
    assert isinstance(nf, Pitchfork)
    # F = p*u - u^3: a01 = 0, b11 = 1, b20 = 0, b30 = -6
    assert abs(nf.nf["a01"]) < 1e-6
    assert nf.nf["b11"] == pytest.approx(1.0, abs=1e-5)
    assert abs(nf.nf["b20"]) < 1e-6
    assert nf.nf["b30"] == pytest.approx(-6.0, abs=1e-4)
    _same_1d_form(nf, nfs["jax"])


def test_transcritical_nf_coefficients():
    nfs = {k: PKGS[k][0].get_normal_form(br, 0)
           for k, (_, br) in _branches("transcritical_1d").items()}
    nf = nfs["torch"]
    assert isinstance(nf, Transcritical)
    # F = p*u - u^2: b11 = 1, b20 = -2
    assert nf.nf["b11"] == pytest.approx(1.0, abs=1e-5)
    assert abs(nf.nf["b20"]) == pytest.approx(2.0, abs=1e-4)
    _same_1d_form(nf, nfs["jax"])
    # the predictor's point, in either package, for the same ds
    pt, pj = bt.predictor(nf, 0.02), bj.predictor(nfs["jax"], 0.02)
    assert pt["p"] == pytest.approx(pj["p"], abs=1e-12)
    np.testing.assert_allclose(pt["x1"].numpy(), np.asarray(pj["x1"]),
                               atol=1e-9)


def test_hopf_nf_coefficients():
    br = _branches("hopf_normal_2d", omega=1.0, l1=-1.0)
    hj = bj.get_normal_form(br["jax"][1], 0)
    hp = bt.get_normal_form(br["torch"][1], 0)
    assert isinstance(hp, Hopf)
    # z' = (p + i omega) z + l1 z|z|^2: a = 1, b = 2 l1 with unit-norm zeta
    assert hp.omega == pytest.approx(1.0, abs=1e-4)
    assert hp.nf["a"].real == pytest.approx(1.0, abs=1e-4)
    assert hp.nf["b"].real == pytest.approx(-2.0, abs=1e-3)
    assert hp.subtype == hj.subtype == "SuperCritical"
    t, j = interop.normal_form_to_numpy(hp), interop.normal_form_to_numpy(hj)
    for key in ("a", "b"):
        assert _close(t["nf"][key], j["nf"][key], 1e-9), key
    assert t["omega"] == pytest.approx(j["omega"], abs=1e-10)
    pred, predj = bt.predictor(hp, 0.04), bj.predictor(hj, 0.04)
    assert pred["dsfactor"] == predj["dsfactor"] == 1
    assert pred["amp"] == pytest.approx(2 * np.sqrt(0.04 / 2), rel=1e-3)
    assert pred["period"] == pytest.approx(predj["period"], rel=1e-9)
    # the predicted orbit lies on the limit cycle |z| = sqrt(dp)
    orb0 = pred["orbit"](0.0).numpy()
    assert np.linalg.norm(orb0) == pytest.approx(np.sqrt(0.04), rel=0.05)
    assert np.linalg.norm(orb0) == pytest.approx(
        np.linalg.norm(np.asarray(predj["orbit"](0.0))), rel=1e-9)


def test_branch_switching_pitchfork(pitchfork):
    rows = {}
    for name, (pkg, _, _) in PKGS.items():
        br2 = pkg.continuation_from_bp(
            pitchfork[name][1], 0, _cp(pkg, detect_bifurcation=0),
            delta_p=0.02)
        assert len(br2) > 5
        rows[name] = br2.gamma._table()
    tbl = rows["torch"]
    mask = tbl["param"] > 0.05
    assert mask.sum() > 3
    np.testing.assert_allclose(tbl["norm"][mask],
                               np.sqrt(tbl["param"][mask]), rtol=1e-4)
    np.testing.assert_allclose(tbl["param"], rows["jax"]["param"], rtol=0,
                               atol=1e-8)


def _double_pitchfork(pkg):
    if pkg is bj:
        return bj.BifurcationProblem(
            lambda u, par: jnp.array([par["p"] * u[0] - u[0] ** 3,
                                      par["p"] * u[1] - u[1] ** 3]),
            u0=jnp.zeros(2), params={"p": -0.5}, lens="p")
    return bt.BifurcationProblem(
        lambda u, par: torch.stack([par["p"] * u[0] - u[0] ** 3,
                                    par["p"] * u[1] - u[1] ** 3]),
        u0=torch.zeros(2, dtype=torch.float64),
        params={"p": torch.tensor(-0.5, dtype=torch.float64)}, lens="p")


def test_nd_normal_form_and_multicontinuation():
    """Decoupled double pitchfork F = (p x - x^3, p y - y^3): a 2d kernel
    at 0, b11 = I, b30[i,i,i,i] = -6, 8 nontrivial roots at dp > 0."""
    from bifurcationkit.jl_tpu.normal_forms import (
        nd_branch_predictors as j_preds)
    from bifurcationkit.jl_tpu_torch.normal_forms import (
        nd_branch_predictors as t_preds)

    out = {}
    for name, (pkg, _, _) in PKGS.items():
        br = pkg.continuation(_double_pitchfork(pkg), pkg.PALC(),
                              _cp(pkg, nev=2))
        assert [sp.type for sp in br.specialpoint][:1] == ["nd"]
        out[name] = (br, pkg.get_normal_form(br, 0))
    nf, nfj = out["torch"][1], out["jax"][1]
    assert isinstance(nf, NdBranchPoint) and nf.N == 2
    np.testing.assert_allclose(nf.nf["b11"], np.eye(2), atol=1e-4)
    assert nf.nf["b30"][0, 0, 0, 0] == pytest.approx(-6.0, abs=1e-3)
    assert nf.nf["b30"][1, 1, 1, 1] == pytest.approx(-6.0, abs=1e-3)
    assert abs(nf.nf["b30"][0, 1, 1, 1]) < 1e-4
    # against JAX with the basis aligned: Z_t = Z_j Q with Q a signed
    # permutation, so each tensor transforms by Q on every index
    t, j = interop.normal_form_to_numpy(nf), interop.normal_form_to_numpy(nfj)
    Q = np.round(j["zeta"].T @ t["zeta"])
    assert np.allclose(np.abs(Q).sum(axis=0), 1)
    np.testing.assert_allclose(t["nf"]["a01"], Q.T @ j["nf"]["a01"],
                               atol=1e-9)
    np.testing.assert_allclose(t["nf"]["b11"], Q.T @ j["nf"]["b11"] @ Q,
                               atol=1e-9)
    np.testing.assert_allclose(
        t["nf"]["b30"], np.einsum("abcd,ai,bj,ck,dl->ijkl", j["nf"]["b30"],
                                  Q, Q, Q, Q), atol=1e-9)
    preds, preds_j = t_preds(nf, 0.02, n_trials=5), j_preds(nfj, 0.02,
                                                              n_trials=5)
    assert len(preds) == len(preds_j) == 8
    X = np.stack([p["x1"].numpy() for p in preds])
    Xj = np.stack([np.asarray(p["x1"]) for p in preds_j])
    D = np.linalg.norm(X[:, None, :] - Xj[None, :, :], axis=2)
    assert np.max(D.min(axis=1)) < 1e-8
    # each switched branch starts from one of those (JAX-matched) points;
    # the JAX test asks for at least 4 of them to continue
    _, branches = bt.multicontinuation(
        out["torch"][0], 0, _cp(bt, detect_bifurcation=0, max_steps=6))
    assert len(branches) >= 4
    for b in branches:
        assert len(b) > 5 and b.bp is branches[0].bp


def test_bifurcation_diagram():
    trees = {}
    for name, (pkg, models, dev) in PKGS.items():
        trees[name] = pkg.bifurcationdiagram(
            models.pitchfork_1d(p=-0.5, **dev), pkg.PALC(), level=2,
            contparams=_cp(pkg))
    diag = trees["torch"]
    # root branch + the bifurcated branch from its one bp
    assert len(diag.children) == len(trees["jax"].children) >= 1
    child = diag.children[0]
    assert child.level == 2 and len(child.gamma) > 5
    assert len(diag) == len(trees["jax"])
    np.testing.assert_allclose(child.gamma.param,
                               trees["jax"].children[0].gamma.param,
                               rtol=0, atol=1e-8)
