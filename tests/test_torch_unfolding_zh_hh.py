"""The detailed zero-Hopf and Hopf-Hopf unfoldings and their
Neimark-Sacker predictors, dense and matrix-free, run by the JAX package
and by the port on the same models (mirrors `test_po_switch.py:110-127`
and `test_minaug_mf.py:752-817`).

Tolerances, and why:
* coefficients (G's, beta1, beta2, the NS alphas and frequency shifts) to
  1e-8 * max(|c|, 1) against the JAX package's dense unfolding (the JAX
  tests hold its matrix-free route to its dense one at 1e-8); the
  predicted NS parameters against the closed-form NS surface (p2 to
  1e-12, p1 to 5 eps^4) as in the JAX test;
* alignment: G200, G011, G110 and beta1 = -G011 flip together with q0's
  sign (p0 is normalised against q0), which the iterative null basis
  does not fix: they are multiplied by sign(<q0, q0_ref>) before they are
  compared; G111, G021, beta2, the predictor's parameters and the HH
  coefficients are invariant under that sign and under the
  eigenvectors' phases.
"""
import numpy as np
import pytest

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu.codim2.unfolding import (
    hh_unfolding as j_hh_unf, predictor_ns_hh as j_ns_hh,
    predictor_ns_zh as j_ns_zh, zh_unfolding as j_zh_unf)
from bifurcationkit.jl_tpu.core.lens import as_lens as j_lens
from bifurcationkit.jl_tpu_torch import interop
from tests._codim2_models import (A_ZH, B_ZH, CR_ZH, DR_ZH, HH2_W, OM_ZH,
                                  close, hh_two, one_thread, zeros,
                                  zh_unfold)


def _unfold(pkg, fn, model, lenses, **kw):
    p = model(pkg)
    lens = j_lens if pkg is bj else bt.as_lens
    return fn(p, zeros(pkg, p.u0.shape[0]), p.params,
              *[lens(n) for n in lenses], **kw)


@pytest.fixture(scope="module")
def zh_ref():
    return interop.unfolding_to_numpy(
        _unfold(bj, j_zh_unf, zh_unfold, ("p1", "p2")))


@pytest.mark.parametrize("mf", [False, True], ids=["dense", "mf"])
def test_zh_unfolding_matches_jax(zh_ref, mf):
    """The ZH unfolding of `test_po_switch._zh_model`, dense and
    matrix-free (omega targeted as the JAX test does), against the JAX
    package's dense one; its NS predictor against the closed-form NS
    surface and against the JAX package's predictor."""
    nf = _unfold(bt, bt.zh_unfolding, zh_unfold, ("p1", "p2"),
                 matrix_free=mf, **({"omega": OM_ZH} if mf else {}))
    got = interop.unfolding_to_numpy(nf)
    s = float(np.sign(np.dot(got["q0"], zh_ref["q0"])))
    for k in ("G200", "G011", "G110", "beta1"):
        close(s * got[k], zh_ref[k])
    for k in ("G111", "G021", "beta2", "omega"):
        close(got[k], zh_ref[k])
    assert got["hasNS"] and zh_ref["hasNS"]
    for eps in (0.1, 0.05):
        pred, ref = bt.predictor_ns_zh(nf, eps), j_ns_zh(zh_ref, eps)
        r2 = 2 * eps ** 2                  # r^2 of the predicted orbit
        x_ex = -DR_ZH * r2 / A_ZH
        assert pred["p2"] == pytest.approx(-CR_ZH * x_ex - DR_ZH * r2,
                                           abs=1e-12)
        assert pred["p1"] == pytest.approx(-A_ZH * x_ex ** 2 - B_ZH * r2,
                                           abs=5 * eps ** 4)
        for k in ("p1", "p2", "T", "k"):
            close(pred[k], ref[k])


@pytest.fixture(scope="module")
def hh_ref():
    return interop.unfolding_to_numpy(
        _unfold(bj, j_hh_unf, hh_two, ("b1", "b2")))


@pytest.mark.parametrize("mf", [False, True], ids=["dense", "mf"])
def test_hh_unfolding_matches_jax(hh_ref, mf):
    """The HH unfolding of the two-oscillator model, dense and matrix-free
    (omegas targeted), against the JAX package's dense one: the four cubic
    G's, both NS families' alpha and frequency shifts, and the two NS
    predictors' parameters, angle and period."""
    nf = _unfold(bt, bt.hh_unfolding, hh_two, ("b1", "b2"),
                 matrix_free=mf, **({"omegas": HH2_W} if mf else {}))
    got = interop.unfolding_to_numpy(nf)
    for k in ("G2100", "G0021", "G1110", "G1011", "w1", "w2"):
        close(got[k], hh_ref[k])
    for fam in ("ns1", "ns2"):
        for k in ("alpha", "dw1", "dw2"):
            close(got[fam][k], hh_ref[fam][k])
    for which in (1, 2):
        pred, ref = (bt.predictor_ns_hh(nf, 0.05, which),
                     j_ns_hh(hh_ref, 0.05, which))
        for k in ("p1", "p2", "T", "k"):
            close(pred[k], ref[k])
