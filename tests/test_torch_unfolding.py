"""The detailed Bogdanov-Takens and Bautin unfoldings and their predictors
(the homoclinic orbit, the fold of periodic orbits), dense and
matrix-free, run by the JAX package and by the port on the same models
(mirrors `test_po_switch.py:67-108` and `test_minaug_mf.py:429-469,
752-880`; the ZH and HH unfoldings are in `test_torch_unfolding_zh_hh.py`).

Tolerances, and why:
* scalar coefficients and the parameter maps (K10, K11, K2, alpha) to
  1e-8 * max(|c|, 1) against the JAX package's dense unfolding (the JAX
  tests hold its matrix-free route to its dense one at 1e-8), and the
  closed forms to 1e-10 where the JAX test states them so;
* alignment: both routes fix the BT basis by the same gauge and the
  convention a > 0, so (a, b) and every REF3 coefficient compare as
  they are; the Bautin coefficients g110 ... g201 and alpha do not depend
  on the eigenvector's phase (p0 is normalised against q0), but the
  fold-of-PO orbit's angle does: with q0 = e^{i phi} q0_ref the port's
  orbit at theta is compared with the JAX package's at theta + phi;
* the homoclinic orbit's ODE residual to 5e-4 at eps = 0.1 and its
  eps^4 scaling, as in the JAX test; the predictors' parameters against
  the JAX package's to 1e-8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu.codim2.unfolding import (
    bautin_unfolding as j_bautin_unf, bt_unfolding as j_bt_unf,
    predictor_fold_po as j_fold_po, predictor_homoclinic_bt as j_homoc)
from bifurcationkit.jl_tpu.core.lens import as_lens as j_lens
from bifurcationkit.jl_tpu.normal_forms.bautin import _bautin_core
from bifurcationkit.jl_tpu_torch import interop
from tests._codim2_models import (DTYPE, L5_GH, OM_GH, bt_cubic, bt_planar,
                                  close, one_thread, quintic_bautin, zeros)

BT_KEYS = ("a", "b", "d", "e", "a1", "b1", "gamma", "c")


def _unfold(pkg, fn, model, lenses, **kw):
    p = model(pkg)
    lens = j_lens if pkg is bj else bt.as_lens
    return fn(p, zeros(pkg, p.u0.shape[0]), p.params,
              *[lens(n) for n in lenses], **kw)


@pytest.fixture(scope="module")
def bt_ref():
    return interop.unfolding_to_numpy(
        _unfold(bj, j_bt_unf, bt_cubic, ("b1", "b2")))


@pytest.mark.parametrize("mf", [False, True], ids=["dense", "mf"])
def test_bt_unfolding_matches_jax(bt_ref, mf):
    """Every REF3 coefficient and (K10, K11, K2) of the cubic BT model,
    dense and matrix-free, against the JAX package's dense unfolding; the
    homoclinic predictor's parameters and orbit against its predictor."""
    nf = _unfold(bt, bt.bt_unfolding, bt_cubic, ("b1", "b2"),
                 matrix_free=mf)
    got = interop.unfolding_to_numpy(nf)
    for k in BT_KEYS + ("K10", "K11", "K2"):
        close(got[k], bt_ref[k])
    assert abs(got["d"]) > 1e-3 and abs(got["e"]) > 1e-3
    hom, hom_ref = bt.predictor_homoclinic_bt(nf, 0.1), j_homoc(bt_ref, 0.1)
    for k in ("p1", "p2", "tau2"):
        close(hom[k], hom_ref[k])
    close(hom["orbit"](0.5).numpy(), np.asarray(hom_ref["orbit"](0.5)))


def test_bt_unfolding_planar_and_homoclinic_residual():
    """On the planar BT normal form the parameter transform is the
    identity (K10 = [1, 0], K11 = [0, 1], K2 = 0, cubic coefficients 0,
    to 1e-10), and the Lindstedt-Poincare homoclinic orbit's ODE residual
    is below 5e-4 at eps = 0.1 and shrinks like eps^4."""
    p = bt_planar(bt)
    nf = bt.bt_unfolding(p, zeros(bt, 2), p.params, bt.as_lens("p1"),
                         bt.as_lens("p2"))
    got = interop.unfolding_to_numpy(nf)
    np.testing.assert_allclose(got["K10"], [1.0, 0.0], atol=1e-10)
    np.testing.assert_allclose(got["K11"], [0.0, 1.0], atol=1e-10)
    np.testing.assert_allclose(got["K2"], [0.0, 0.0], atol=1e-10)
    for key in ("d", "e", "a1", "b1"):
        assert abs(got[key]) < 1e-10

    def max_residual(eps):
        pred = bt.predictor_homoclinic_bt(nf, eps)
        al = pred["alpha"](eps)
        par = {"p1": torch.tensor(al[0], dtype=DTYPE),
               "p2": torch.tensor(al[1], dtype=DTYPE)}
        dt, res = 1e-6, 0.0
        for t in np.linspace(-3 / eps, 3 / eps, 21):
            x = pred["orbit"](t, eps)
            xd = (pred["orbit"](t + dt, eps)
                  - pred["orbit"](t - dt, eps)) / (2 * dt)
            res = max(res, float(torch.max(torch.abs(xd - p.F(x, par)))))
        return res

    r1, r2 = max_residual(0.1), max_residual(0.05)
    assert r1 < 5e-4
    assert r1 / r2 > 8.0          # ~ eps^4 asymptotics


@pytest.fixture(scope="module")
def bautin_ref():
    """The JAX package's dense Bautin unfolding of the quintic model, its
    l2 from the JAX dense core run eagerly (through the cache slot that
    `bautin_normal_form` reads; its own jit compiles the fifth-order jets
    for about 27 s)."""
    p = quintic_bautin(bj)
    object.__setattr__(p, "_bautin_core",
                       lambda xf, par: _bautin_core(p, xf, par))
    nf = j_bautin_unf(p, jnp.zeros(2), p.params, j_lens("p1"), j_lens("p2"))
    return interop.unfolding_to_numpy(nf)


@pytest.mark.parametrize("mf", [False, True], ids=["dense", "mf"])
def test_bautin_unfolding_matches_jax(bautin_ref, mf):
    """l1, l2, g110, g101, g210, g201, alpha and omega of the quintic
    Bautin model, dense and matrix-free, against the JAX package's dense
    unfolding; the fold-of-PO predictor against the closed-form
    fold-of-cycles curve (p2 = -4 L5 eps^2 to 1e-8 relative) and against
    the JAX package's predictor."""
    nf = _unfold(bt, bt.bautin_unfolding, quintic_bautin, ("p1", "p2"),
                 matrix_free=mf)
    got = interop.unfolding_to_numpy(nf)
    for k in ("l1", "l2", "g110", "g101", "g210", "g201", "alpha",
              "omega"):
        close(got[k], bautin_ref[k])
    assert got["l2"] * L5_GH > 0
    for eps in (0.1, 0.05):
        pred, ref = bt.predictor_fold_po(nf, eps), j_fold_po(bautin_ref,
                                                              eps)
        assert pred["p2"] == pytest.approx(-4 * L5_GH * eps ** 2, rel=1e-8)
        assert abs(pred["p1"]) < 10 * eps ** 4
        assert pred["T"] == pytest.approx(2 * np.pi / OM_GH, rel=5e-2)
        for k in ("p1", "p2", "omega", "T"):
            close(pred[k], ref[k])
        # the orbit's parametrisation follows q0's phase: q0 = e^{i phi}
        # q0_ref gives orbit(theta) = orbit_ref(theta + phi)
        phi = np.angle(np.vdot(bautin_ref["q0"], got["q0"]))
        close(pred["orbit"](0.7).numpy(),
              np.asarray(ref["orbit"](0.7 + phi)))
