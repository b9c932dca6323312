"""`switch_codim2_po` (codim2/unfolding.py) on the constructed models of
test_po_switch.py:20-60, whose PO codim-2 curves are known in closed
form (the zero-Hopf case is `test_torch_switch_codim2_po_zh.py`, which
takes the models and helpers from here): from the Bautin point of z' = (p1 + i om) z + (p2 + i c1) z|z|^2 +
(L5 + i c2) z|z|^4 to the fold-of-cycles curve p1 = p2^2 / (4 L5), and
from the zero-Hopf point of x' = p1 + a x^2 + b|z|^2,
z' = (p2 + i om) z + c x z + d z|z|^2 to the NS curve
p1 = 2 p2 - 4 p2^2.

The models are written in real arithmetic (the port's forward AD takes
a real F); the Hopf curves are cut just past their codim-2 points (p2 in
[-0.4, 0.02] and [-0.02, 0.05]), the PO curves to 4 steps (the JAX tests run 8, marked slow) on
Collocation(30, 4).  Tolerances as the JAX tests: the fold-of-cycles
curve to 1e-7, the NS curve to 1e-6, the inner orbit's complex
multipliers on the unit circle to 1e-6 at the NS curve's last point."""
import numpy as np
import torch

import bifurcationkit.jl_tpu_torch as bt
from tests._codim2_models import one_thread  # noqa: F401

DT = torch.float64
OM_GH, C1_GH, L5_GH, C2_GH = 1.3, 0.4, -2.0, 0.1
OM_ZH = 1.5
A_ZH, B_ZH, CR_ZH, CI_ZH, DR_ZH, DI_ZH = 1.0, -1.0, 0.5, 0.3, -1.0, 0.2


def _bautin(u, par):
    x, y = u[0], u[1]
    zz = x * x + y * y
    p1, p2 = par["p1"], par["p2"]
    return torch.stack([
        p1 * x - OM_GH * y + zz * (p2 * x - C1_GH * y)
        + zz * zz * (L5_GH * x - C2_GH * y),
        p1 * y + OM_GH * x + zz * (p2 * y + C1_GH * x)
        + zz * zz * (L5_GH * y + C2_GH * x)])


def _zh(u, par):
    x, a, b = u[0], u[1], u[2]
    zz = a * a + b * b
    p1, p2 = par["p1"], par["p2"]
    return torch.stack([
        p1 + A_ZH * x * x + B_ZH * zz,
        p2 * a - OM_ZH * b + x * (CR_ZH * a - CI_ZH * b)
        + zz * (DR_ZH * a - DI_ZH * b),
        p2 * b + OM_ZH * a + x * (CR_ZH * b + CI_ZH * a)
        + zz * (DR_ZH * b + DI_ZH * a)])


def _prob(F, u0, **params):
    return bt.BifurcationProblem(
        F, u0=torch.tensor(u0, dtype=DT),
        params={k: torch.tensor(v, dtype=DT) for k, v in params.items()},
        lens="p1")


def _hopf_curve(prob, cp_kw, cp2_kw):
    cp = bt.ContinuationPar(newton_options=bt.NewtonPar(tol=1e-10),
                            detect_bifurcation=3, nev=3, n_inversion=4,
                            **cp_kw)
    br = bt.continuation(prob, bt.PALC(), cp)
    i = next(k for k, sp in enumerate(br.specialpoint) if sp.type == "hopf")
    cp2 = bt.ContinuationPar(detect_bifurcation=0, detect_fold=False,
                             newton_options=bt.NewtonPar(tol=1e-10,
                                                         max_iterations=30),
                             **cp2_kw)
    return bt.continuation_hopf(br, i, "p2", cp2,
                                detect_codim2_bifurcation=2)


def test_switch_gh_to_fold_po_curve():
    prob = _prob(_bautin, [0.0, 0.0], p1=-0.05, p2=-0.3)
    brh = _hopf_curve(prob, dict(ds=0.005, dsmax=0.01, dsmin=1e-7,
                                 p_min=-0.06, p_max=0.05, max_steps=60),
                      dict(ds=0.02, dsmax=0.04, dsmin=1e-7, p_min=-0.4,
                           p_max=0.02, max_steps=30))
    ghs = [i for i, sp in enumerate(brh.gamma.specialpoint)
           if sp.type == "gh"]
    assert ghs and abs(brh.gamma.specialpoint[ghs[0]].param) < 1e-3
    cp3 = bt.ContinuationPar(ds=0.002, dsmax=0.01, dsmin=1e-8,
                             p_min=0.0001, p_max=0.3, max_steps=4,
                             detect_bifurcation=0, detect_event=0,
                             newton_options=bt.NewtonPar(tol=1e-8,
                                                         max_iterations=30))
    br_f = bt.switch_codim2_po(brh, ghs[0], cp3,
                               disc=bt.Collocation(Ntst=30, m=4), eps=0.07,
                               detect_codim3=0)
    tbl = br_f.gamma._table()
    p2s, p1s = np.asarray(tbl["param"]), np.asarray(tbl["p1"])
    assert len(p2s) >= 4
    np.testing.assert_allclose(p1s, p2s ** 2 / (4 * L5_GH), atol=1e-7)
