"""The zero-Hopf and Hopf-Hopf normal forms, run by the JAX package and by
the port on the same models, and `switch_codim2` from a Hopf-Hopf point
to the other Hopf curve (mirrors `test_codim2.py:264-322, 355-406` and
the matrix-free ZH of `test_minaug_mf.py:752-880`).

Tolerances, and why:
* coefficients to 1e-8 * max(|c|, 1) against the JAX package's and
  against the closed-form gold values (G200 = 2a, G011 = 2b, G110 = c,
  omega = w; the HH ratios delta and theta);
* sign alignment: the iterative null basis fixes no sign, and the ZH G's
  flip together with q0 (G200, G011 and G110 all change sign under
  q0 -> -q0, p0 -> -p0 at fixed normalisations), so each matrix-free ZH
  form is multiplied by sign(<q0_mf, q0_dense>) of its own package
  before it is compared; the HH G's and omega do not depend on the
  eigenvectors' phases (p_k is normalised against q_k);
* the switched Hopf curve against its exact locus b2 + 0.4 b1 = 0
  (1e-8) at omega = 1.7 (1e-6). The two-oscillator model starts at
  (b1, b2) = (-0.06, -0.07), near its Hopf and Hopf-Hopf points (the JAX
  test starts at (-0.3, -0.2)).
"""
import jax.numpy as jnp
import numpy as np
import torch

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu.codim2.zh_hh import (
    hh_normal_form as j_hh, zh_normal_form as j_zh)
from bifurcationkit.jl_tpu_torch import interop
from tests._codim2_models import (DTYPE, HH2_W, HH_G, HH_W, ZH_A, ZH_B,
                                  ZH_C, ZH_W, close, hh_gold, hh_two,
                                  one_thread, zh_gold)


def _first(br, kind):
    return next(i for i, sp in enumerate(br.specialpoint)
                if sp.type == kind)


def test_zh_normal_form_gold_and_jax():
    """G200 = 2a, G011 = 2b, G110 = c and omega = w, dense and
    matrix-free, each against the JAX package's dense and matrix-free
    forms (sign-aligned as stated above)."""
    pj, pt = zh_gold(bj), zh_gold(bt)
    ref = j_zh(pj, jnp.zeros(3), pj.params)
    ref_mf = j_zh(pj, jnp.zeros(3), pj.params, matrix_free=True)
    ref_s = float(np.sign(np.dot(np.asarray(ref_mf.zeta[0]),
                                 np.asarray(ref.zeta[0]))))
    x0 = torch.zeros(3, dtype=DTYPE)
    dense = bt.zh_normal_form(pt, x0, pt.params)
    mf = bt.zh_normal_form(pt, x0, pt.params, matrix_free=True)
    s = float(torch.sign(torch.dot(mf.zeta[0], dense.zeta[0])))
    gold = {"G200": 2 * ZH_A, "G011": 2 * ZH_B, "G110": ZH_C}
    for k, g in gold.items():
        close(dense.nf[k], g)
        close(s * mf.nf[k], g)
        close(dense.nf[k], ref.nf[k])
        close(s * mf.nf[k], ref_s * ref_mf.nf[k])
    for pt_ in (dense, mf):
        close(pt_.omega, ZH_W)
    close(mf.omega, ref_mf.omega)


def test_hh_normal_form_invariants_and_jax():
    """The HH classification invariants delta = Re G1110 / Re G2100 and
    theta = Re G1011 / Re G0021 (exact model ratios), the criticality
    signs, and the four G's and two frequencies against the JAX package's
    (same basis convention: ||q_k|| = 1, <p_k, q_k> = 1)."""
    pj, pt = hh_gold(bj), hh_gold(bt)
    ref = j_hh(pj, jnp.zeros(4), pj.params)
    got = interop.codim2_point_to_numpy(
        bt.hh_normal_form(pt, torch.zeros(4, dtype=DTYPE), pt.params))
    g2100, g1011, g1110, g0021 = HH_G
    assert got["kind"] == "HopfHopf"
    close(got["omega1"], HH_W[0])
    close(got["omega2"], HH_W[1])
    nf = got["nf"]
    close(nf["G1110"].real / nf["G2100"].real, g1110 / (g2100 / 2))
    close(nf["G1011"].real / nf["G0021"].real, g1011 / (g0021 / 2))
    assert nf["G2100"].real > 0 and nf["G0021"].real > 0
    for k in ("G2100", "G1011", "G1110", "G0021"):
        close(nf[k], ref.nf[k])
    close(got["omega1"], ref.omega1)
    close(got["omega2"], ref.omega2)


def test_switch_hh_to_other_hopf():
    """hh, found by the inner-spectrum count along the first Hopf curve of
    the two-oscillator model, -> the second Hopf curve: its locus
    b2 + 0.4 b1 = 0 at omega = 1.7."""
    p = hh_two(bt, b1=-0.06, b2=-0.07)
    br = bt.continuation(p, bt.PALC(), bt.ContinuationPar(
        ds=0.02, dsmax=0.05, dsmin=1e-6, p_min=-0.5, p_max=0.4,
        max_steps=6, detect_bifurcation=3, nev=4, n_inversion=6,
        newton_options=bt.NewtonPar(tol=1e-10)))
    cp2 = bt.ContinuationPar(
        ds=0.02, dsmax=0.05, dsmin=1e-6, p_min=-0.5, p_max=0.5,
        max_steps=3, detect_bifurcation=3, nev=4, n_inversion=4,
        detect_fold=False, tol_stability=1e-6,
        newton_options=bt.NewtonPar(tol=1e-10, max_iterations=25))
    # the HH is a crossing of the inner spectrum (detect_bifurcation=3);
    # the first-Lyapunov (GH) monitor is off
    brh = bt.continuation_hopf(br, _first(br, "hopf"), "b2", cp2,
                               detect_codim2_bifurcation=2,
                               compute_lyapunov=False)
    ihh = _first(brh.gamma, "hh")
    assert abs(brh.gamma.specialpoint[ihh].param) < 2e-2
    br2 = bt.switch_codim2(brh, ihh, cp2.replace(max_steps=5,
                                                 detect_bifurcation=0))
    t = interop.codim2_branch_to_numpy(br2)
    assert len(t["param"]) >= 5
    np.testing.assert_allclose(t["omega"], HH2_W[1], atol=1e-6)
    np.testing.assert_allclose(t["param"] + 0.4 * t["p1"], 0.0, atol=1e-8)
