"""`switch_codim2` on dense curves: zero-Hopf on a Lorenz-84 Hopf curve to
the fold curve, and Bogdanov-Takens on a fold curve to the Hopf curve by
the two-sided probe (mirrors `test_codim2.py:324-354, 407-427` and the
lorenz84 flow of `examples/lorenz84.py:33-56`; Hopf-Hopf to the other
Hopf curve is in `test_torch_zh_hh.py`).

Tolerances, and why:
* the switched curves against their exact geometry: a zero eigenvalue of
  the inner jacobian along the Lorenz-84 fold curve (1e-10, as the JAX
  test) and the BT model's Hopf curve b1 = 0, omega^2 = -b2 (1e-8 each);
* the Lorenz-84 fold curve against the JAX package's fold curve started
  from the same zero-Hopf point, column by column, to 1e-8 (the same
  Newton on the same functional, converged to 1e-9), and the ZH form
  there against the JAX package's to 1e-8 * max(|c|, 1).
Depth is cut: the Lorenz-84 Hopf curve starts near its Hopf point at
G = 1.6 and meets the zero-Hopf point within 4 steps (its event
bisection takes 4 steps), and each switched curve runs a few steps.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu.codim2.zh_hh import zh_normal_form as j_zh
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch import models as tmodels
from bifurcationkit.jl_tpu_torch.codim2.unfolding import (
    _codim2_point_context)
from tests._codim2_models import DTYPE, bt_model, close, one_thread

L84 = {"a": 0.25, "b": 4.0, "G": 1.6, "F": 1.64}


def _first(br, kind):
    return next(i for i, sp in enumerate(br.specialpoint)
                if sp.type == kind)


@pytest.fixture(scope="module")
def lorenz84_zh():
    """The port's Lorenz-84 Hopf curve in G from the Hopf point of its
    branch in F (G = 1.6), with the zero-Hopf point the GH test finds."""
    prob = tmodels.lorenz84(params=L84, device="cpu")
    prob = prob.re_make(u0=torch.tensor([1.18467, -0.013138, 0.337135, 0.0],
                                        dtype=DTYPE))
    br = bt.continuation(prob, bt.PALC(), bt.ContinuationPar(
        ds=-0.005, dsmax=0.01, dsmin=1e-6, p_min=-1.0, p_max=5.0,
        max_steps=4, detect_bifurcation=3, nev=4, n_inversion=6,
        newton_options=bt.NewtonPar(tol=1e-10, max_iterations=30)))
    cp2 = bt.ContinuationPar(
        ds=0.01, dsmax=0.03, dsmin=1e-6, p_min=0.0001, p_max=1.75,
        max_steps=4, detect_bifurcation=0, detect_fold=False,
        max_bisection_steps=4,
        newton_options=bt.NewtonPar(tol=1e-9, max_iterations=30))
    brh = bt.continuation_hopf(br, _first(br, "hopf"), "G", cp2,
                               detect_codim2_bifurcation=2)
    return prob, brh, cp2


def test_switch_zh_to_fold_lorenz84(lorenz84_zh):
    """zh on the Hopf curve -> the fold curve through the same point: the
    inner jacobian has an exact zero eigenvalue along it, the curve equals
    the JAX package's fold curve from the same point, and so does the ZH
    form there."""
    from bifurcationkit.jl_tpu import models as jmodels
    from bifurcationkit.jl_tpu.detection.points import SpecialPoint

    prob, brh, cp2 = lorenz84_zh
    izh = _first(brh.gamma, "zh")
    cp3 = cp2.replace(max_steps=4)
    br_fold = bt.switch_codim2(brh, izh, cp3)
    assert br_fold.gamma.prob.ma_kind == "fold"
    t = interop.codim2_branch_to_numpy(br_fold)
    assert len(t["param"]) >= 4
    for sol in br_fold.gamma.sol:
        X = sol["x"].numpy()
        par = {**prob.params, "G": torch.tensor(float(sol["p"]), dtype=DTYPE),
               "F": torch.tensor(float(X[4]), dtype=DTYPE)}
        vals = np.linalg.eigvals(prob.jacobian(torch.as_tensor(X[:4]),
                                               par).numpy())
        assert float(np.min(np.abs(vals))) < 1e-10
    # the JAX package's fold curve from the same point (what its
    # switch_codim2 runs for a zh on a Hopf curve)
    sp = brh.gamma.specialpoint[izh]
    X = sp.x.numpy()
    jprob = jmodels.lorenz84(params={**L84, "G": float(sp.param)})
    jprob = jprob.re_make(F=jax.jit(jprob.F), u0=jnp.asarray(X[:4]),
                          params={**L84, "G": float(sp.param),
                                  "F": float(X[4])})
    shim = SimpleNamespace(prob=jprob, specialpoint=[SpecialPoint(
        type="fold", param=float(X[4]), x=jnp.asarray(X[:4]))])
    ref = interop.codim2_branch_to_numpy(bj.continuation_fold(
        shim, 0, "G", bj.ContinuationPar(**{
            **cp3.__dict__, "newton_options": bj.NewtonPar(
                tol=1e-9, max_iterations=30)})))
    assert len(ref["param"]) == len(t["param"])
    for k in ("param", "p1"):
        np.testing.assert_allclose(t[k], ref[k], rtol=0, atol=1e-8)
    # the ZH form at the switch point (examples/lorenz84.py:51-56), dense
    # in both packages: the same host eigenvectors, so no alignment
    _, inner, x, params, _, _ = _codim2_point_context(brh, izh)
    got = bt.zh_normal_form(inner, x, params)
    ref_nf = j_zh(jprob, jnp.asarray(X[:4]), jprob.params)
    for k in ("G200", "G011", "G110"):
        close(got.nf[k], ref_nf.nf[k])
    close(got.omega, ref_nf.omega)


def test_switch_bt_to_hopf():
    """BT on the bt_model fold curve (from its fold at b1 = 0.09,
    b2 = 0.6; the JAX test starts at b2 = 2) -> the Hopf curve {b1 = 0,
    b2 < 0, omega = sqrt(-b2)} by the two-sided probe."""
    p = bt_model(bt, 0.05, 0.6)
    cp = dict(dsmin=1e-5, nev=2, n_inversion=4,
              newton_options=bt.NewtonPar(tol=1e-10, max_iterations=30))
    br = bt.continuation(p, bt.PALC(), bt.ContinuationPar(
        ds=0.01, dsmax=0.02, p_min=0.0, p_max=1.5, max_steps=12,
        detect_bifurcation=2, detect_fold=True, **cp))
    cp2 = bt.ContinuationPar(ds=-0.1, dsmax=0.2, p_min=-2.5, p_max=2.5,
                             max_steps=8, detect_bifurcation=0,
                             detect_fold=False, **cp)
    brf = bt.continuation_fold(br, _first(br, "fold"), "b2", cp2,
                               detect_codim2_bifurcation=2)
    ibt = _first(brf.gamma, "bt")
    brh = bt.switch_codim2(brf, ibt, cp2.replace(ds=-0.05, max_steps=8))
    assert brh.gamma.prob.ma_kind == "hopf"
    t = interop.codim2_branch_to_numpy(brh)
    assert len(t["param"]) >= 5 and np.min(t["param"]) < -0.1
    np.testing.assert_allclose(t["p1"], 0.0, atol=1e-8)
    # omega^2 = -b2 (omega = sqrt(-b2) amplifies b2's error by 1/(2 omega)
    # at the curve's start, where omega = 0.01)
    np.testing.assert_allclose(t["omega"] ** 2, -t["param"], atol=1e-8)
