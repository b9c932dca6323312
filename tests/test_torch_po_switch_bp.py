"""The branch-point switch of periodic orbits on Freire and the
Tsodyks-Markram PO branch from a Hopf curve point.

* `bp_po_branch_switch` at the Freire PO branch's second branch point
  (Collocation(30, 4)): the same-period guess perturbed along the
  critical mode and the jump in nu against the JAX package's from the same
  point (its `continuation_po` intercepted), to 1e-10 after aligning the
  mode's sign; the switched branch carries an NS point
  (test_bp_po.py:84-95).
* The port of test_tm_model.py:80-101: `continuation_from_hopf_point` at
  a third of the TM Hopf curve in alpha (Collocation(25, 4), 8 steps),
  the first orbit's period within 0.05 of 2 pi / omega and an amplitude in
  E above 1e-4; its orbits satisfy the JAX package's collocation rows to
  1e-8.  The equilibrium branch is cut to E0 in [-2, -1.1] (both folds
  and Hopfs), the Hopf curve to 8 steps each way with its codim-2
  monitor off."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu import models as jm
from bifurcationkit.jl_tpu.periodic import codim2 as jc2
from bifurcationkit.jl_tpu_torch.periodic import orbits as torbits
from tests._codim2_models import one_thread  # noqa: F401
from tests._po_models import freire_switched
from tests.test_torch_po_switch import (_capture, _close_up_to_sign,
                                        _jax_guess)


def test_freire_bp_switch_matches_jax(monkeypatch):
    _, br_po, ibp, br2 = freire_switched()
    sp = br_po.gamma.specialpoint[ibp]
    got = _capture(monkeypatch, torbits)
    bt.bp_po_branch_switch(br_po, ibp, bt.ContinuationPar(ds=-0.001),
                           ampfactor=0.01, delta_p=-0.001)
    monkeypatch.undo()
    ref = _jax_guess(monkeypatch, jc2.bp_po_branch_switch, jm.freire(),
                     bj.Collocation(Ntst=30, m=4), sp, ampfactor=0.01,
                     delta_p=-0.001)
    base = sp.x.numpy()
    _close_up_to_sign(got["X"], ref["X"], base)
    assert float(got["params"]["nu"]) == pytest.approx(
        ref["params"]["nu"], abs=1e-14)
    types = [s.type for s in br2.gamma.specialpoint]
    assert "ns" in types


def test_tm_po_from_hopf_curve_point():
    prob = bt.models.tsodyks_markram(device="cpu")
    cp = bt.ContinuationPar(ds=0.01, dsmax=0.05, dsmin=1e-6, p_min=-2.0,
                            p_max=-1.1, max_steps=300, detect_bifurcation=3,
                            nev=3, n_inversion=8,
                            newton_options=bt.NewtonPar(tol=1e-10))
    br = bt.continuation(prob, bt.PALC(), cp, bothside=True)
    ih = [i for i, sp in enumerate(br.specialpoint) if sp.type == "hopf"][-1]
    assert abs(br.specialpoint[ih].param - (-1.1511)) < 2e-3
    cph = bt.ContinuationPar(ds=0.01, dsmax=0.05, dsmin=1e-7, p_min=0.2,
                             p_max=5.0, max_steps=8, detect_bifurcation=0,
                             save_sol_every_step=1,
                             newton_options=bt.NewtonPar(tol=1e-9,
                                                         max_iterations=25))
    brh = bt.continuation_hopf(br, ih, "alpha", cph, bothside=True,
                               detect_codim2_bifurcation=0)
    g = brh.gamma
    idx = len(g.sol) // 3
    omega = float(g.sol[idx]["x"][3 + 1])
    cpo = bt.ContinuationPar(ds=0.001, dsmax=0.01, dsmin=1e-7, p_min=0.2,
                             p_max=5.0, max_steps=8, detect_bifurcation=0,
                             save_sol_every_step=1,
                             newton_options=bt.NewtonPar(tol=1e-8,
                                                         max_iterations=20))
    brpo = bt.continuation_from_hopf_point(brh, idx, cpo,
                                           bt.Collocation(Ntst=25, m=4),
                                           delta_p=0.02)
    assert len(brpo.gamma) >= 5
    orb = bt.get_periodic_orbit(brpo, 0)
    assert abs(orb["period"] - 2 * np.pi / abs(omega)) < 0.05
    E = orb["u"][:, 0]
    assert E.max() - E.min() > 1e-4
    po = brpo.gamma.prob
    pj = jm.tsodyks_markram()
    disc = bj.Collocation(Ntst=25, m=4)
    resid = jax.jit(lambda X, par: disc.residual(pj, X, par))
    lens = bt.as_lens(po.prob_vf.lens)
    for sol in brpo.gamma.sol[:3]:
        X = sol["x"].numpy()
        inner = {k: float(v) for k, v in po.params["_inner"].items()}
        inner[lens.name] = float(sol["p"])
        par = {"_inner": inner,
               "_mesh": jnp.linspace(0.0, 1.0, 26),
               "_uref": jnp.asarray(X[:-1].reshape(-1, 3)),
               "_phi": jnp.zeros((25, 4, 3))}
        R = np.asarray(resid(jnp.asarray(X), par))
        assert np.abs(R[:-1]).max() <= 1e-8
