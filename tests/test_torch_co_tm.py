"""The CO-oxidation and Tsodyks-Markram models: their residuals against the
JAX package's, the reference's gold special points on their equilibrium
branches, the CO model's Bogdanov-Takens point on its fold curve with its
gold coefficients, and the TM model's Hopf curve (mirrors
`test_co_model.py:12-86` and `test_tm_model.py:25-79`; the PO case of the
TM model is not ported yet).

Tolerances, and why:
* F and the dense jacobian against the JAX package's at random states to
  1e-12 relative (the same formulas, softplus as logaddexp); the CO
  model's d4F, d5F and their complex extensions to 1e-10;
* special points to 2e-3 of the reference's gold values, as the JAX
  tests; the CO BT's (a, b) to 1e-3 relative of the reference's gold
  a = 0.083784, b = 2.1363 (ref COModel.jl:57,68-69) and to 1e-8 *
  max(|c|, 1) of the JAX package's form at the port's refined point;
* the Hopf curve's J - i omega I singular to 1e-6 (smallest singular
  value), as the JAX test.
Depth is cut: the branches run over the parameter windows that hold the
gold points, one side only, and the curves a few steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu import models as jmodels
from bifurcationkit.jl_tpu.codim2.normal_forms import (
    bt_normal_form as j_bt_nf)
from tests._codim2_models import (DTYPE, check_jets, close, co_model,
                                  one_thread)

MODELS = {"co": (jmodels.co_oxidation, bt.models.co_oxidation),
          "tm": (jmodels.tsodyks_markram, bt.models.tsodyks_markram)}


@pytest.mark.parametrize("name", ["co", "tm"])
def test_model_matches_jax(name):
    """F and its dense jacobian at random states near u0."""
    jmake, tmake = MODELS[name]
    pj, pt = jmake(), tmake(device="cpu")
    F_j = jax.jit(lambda u: pj.F(u, pj.params))
    J_j = jax.jit(lambda u: pj.jacobian(u, pj.params))
    rng = np.random.default_rng(3)
    for _ in range(3):
        u = np.asarray(pt.u0) * (1 + 0.1 * rng.standard_normal(3))
        ref_F = np.asarray(F_j(jnp.asarray(u)))
        ref_J = np.asarray(J_j(jnp.asarray(u)))
        got_F = pt.F(torch.tensor(u), pt.params).numpy()
        got_J = pt.jacobian(torch.tensor(u), pt.params).numpy()
        close(got_F, ref_F, 1e-12 * np.max(np.abs(ref_F)))
        close(got_J, ref_J, 1e-12 * np.max(np.abs(ref_J)))


def test_co_jets_match_jax():
    """d4F, d5F and their complex extensions on the CO model against the
    JAX package's nested jvps, to 1e-10 relative to the largest entry."""
    check_jets(co_model(bj), co_model(bt), 3)


@pytest.fixture(scope="module")
def co_branch():
    prob = bt.models.co_oxidation(device="cpu")
    cp = bt.ContinuationPar(
        ds=0.002, dsmax=0.005, dsmin=1e-6, p_min=0.95, p_max=1.06,
        max_steps=60, detect_bifurcation=3, nev=3, n_inversion=6,
        max_bisection_steps=25, newton_options=bt.NewtonPar(tol=1e-10))
    return prob, bt.continuation(prob, bt.PALC(), cp)


def test_co_branch_special_points(co_branch):
    """Special points at q2 ~ {1.041, 1.0422, 1.0516, 1.0522} (ref
    COModel.jl:31-34)."""
    _, br = co_branch
    pts = sorted(float(sp.param) for sp in br.specialpoint
                 if sp.type in ("bp", "hopf", "fold"))
    for g in (1.04099606, 1.04204851, 1.05158367, 1.05220029):
        assert min(abs(p - g) for p in pts) < 2e-3, (g, pts)


def test_co_bt_normal_form(co_branch):
    """The fold curve in k from the first fold finds the BT at
    q2 = 1.417628 (ref COModel.jl:57); `newton_bt` refines it and its
    dense form has the gold |a| = 0.083784, |b| = 2.1363, as the JAX
    package's form at the same point does."""
    prob, br = co_branch
    idx = next(i for i, sp in enumerate(br.specialpoint)
               if sp.type in ("fold", "bp"))
    cp2 = bt.ContinuationPar(
        ds=0.02, dsmax=0.08, dsmin=1e-7, p_min=0.0, p_max=1.0, max_steps=25,
        detect_bifurcation=0, detect_fold=False, n_inversion=8,
        newton_options=bt.NewtonPar(tol=1e-9, max_iterations=30))
    brf = bt.continuation_fold(br, idx, "k", cp2,
                               detect_codim2_bifurcation=2)
    ibt = next(i for i, sp in enumerate(brf.gamma.specialpoint)
               if sp.type == "bt")
    sol = bt.newton_bt(brf, ibt)
    assert bool(sol.converged)
    Y = sol.u.numpy()
    q2, k = float(Y[3]), float(Y[4])
    assert abs(q2 - 1.417628) < 1e-4
    params = {**prob.params, "q2": torch.tensor(q2, dtype=DTYPE),
              "k": torch.tensor(k, dtype=DTYPE)}
    nf = bt.bt_normal_form(prob, torch.tensor(Y[:3]), params).nf
    assert abs(nf["a"]) == pytest.approx(0.083784, rel=1e-3)
    assert abs(nf["b"]) == pytest.approx(2.1363, rel=1e-3)
    pj = jmodels.co_oxidation()
    ref = j_bt_nf(pj.re_make(F=jax.jit(pj.F)), jnp.asarray(Y[:3]),
                  {**pj.params, "q2": q2, "k": k}).nf
    close(nf["a"], ref["a"])
    close(nf["b"], ref["b"])


@pytest.fixture(scope="module")
def tm_branch():
    prob = bt.models.tsodyks_markram(device="cpu")
    cp = bt.ContinuationPar(
        ds=0.01, dsmax=0.05, dsmin=1e-6, p_min=-2.0, p_max=-1.0,
        max_steps=120, detect_bifurcation=3, nev=3, n_inversion=8,
        newton_options=bt.NewtonPar(tol=1e-10))
    return prob, bt.continuation(prob, bt.PALC(), cp)


def test_tm_special_points(tm_branch):
    """The S-shaped branch's two folds and two Hopf points (ref
    examples/TMModel.jl:25-27), and a pair on the imaginary axis at the
    last Hopf point."""
    prob, br = tm_branch
    folds = sorted({round(float(sp.param), 3) for sp in br.specialpoint
                    if sp.type == "fold"})
    hopfs = sorted(float(sp.param) for sp in br.specialpoint
                   if sp.type == "hopf")
    assert len(folds) == 2 and len(hopfs) == 2
    for got, gold in zip(folds + hopfs, (-1.8652, -1.4630, -1.8501,
                                         -1.1511)):
        assert abs(got - gold) < 2e-3
    sp = [s for s in br.specialpoint if s.type == "hopf"][-1]
    J = prob.jacobian(sp.x, prob.set_lens_param(prob.params, sp.param))
    vals = np.linalg.eigvals(J.numpy())
    i = np.argmin(np.abs(vals.real))
    assert abs(vals[i].real) < 1e-3 and abs(vals[i].imag) > 1.0


def test_tm_hopf_curve(tm_branch):
    """The Hopf curve in alpha (ref TMModel.jl:29-33): each stored point
    keeps J - i omega I singular."""
    prob, br = tm_branch
    ih = [i for i, sp in enumerate(br.specialpoint)
          if sp.type == "hopf"][-1]
    cph = bt.ContinuationPar(
        ds=0.01, dsmax=0.05, dsmin=1e-7, p_min=0.2, p_max=5.0, max_steps=6,
        detect_bifurcation=0, save_sol_every_step=1,
        newton_options=bt.NewtonPar(tol=1e-9, max_iterations=25))
    brh = bt.continuation_hopf(br, ih, "alpha", cph,
                               detect_codim2_bifurcation=0)
    g = brh.gamma
    assert len(g.sol) >= 6
    maprob = g.prob
    n = maprob.n_inner
    for sol in g.sol:
        X = sol["x"].numpy()
        params = maprob.inner_lens.set(
            maprob.outer_lens.set(prob.params, float(sol["p"])), float(X[n]))
        J = prob.jacobian(torch.tensor(X[:n]), params).numpy()
        sv = np.linalg.svd(J - 1j * X[n + 1] * np.eye(n), compute_uv=False)
        assert sv[-1] < 1e-6
