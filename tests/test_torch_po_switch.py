"""Branch switching onto other periodic-orbit branches
(`periodic/codim2.py`): the period-doubling switch's doubled guess for
Collocation, Trapeze and Shooting, each against the JAX package's guess
from the same special point (the JAX package's `continuation_po` is
intercepted, so it runs no continuation), then the switched branch on
the port.  The helpers here serve `test_torch_po_switch_bp.py` too.

Sizes: Lur'e on Collocation(25, 4) at its PD, the same orbit on
Trapeze(M = 101) and on Shooting(M = 3, 40 rk4 steps a segment),
re-detected on 4-step branches.  The
shooting mode propagation uses the variational flow (the port's stated
difference from the JAX package's jacfwd through the integrator).
Tolerances: guesses to 1e-10 after aligning the critical mode's sign (an
eigenvector's sign is arbitrary); the doubled period 2 T exactly; the
switched branches' first periods within 5 % of 2 T
(test_po_codim2.py:80-99)."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu import models as jm
from bifurcationkit.jl_tpu.periodic import codim2 as jc2
from bifurcationkit.jl_tpu.periodic import orbits as jorbits
from bifurcationkit.jl_tpu_torch.periodic import codim2 as pc2
from tests._codim2_models import one_thread  # noqa: F401
from tests._po_models import lure_po_branch


def _capture(monkeypatch, module):
    got = {}

    def fake(prob_vf, disc, X0, contparams, **kw):
        got.update(disc=disc, X=np.asarray(X0.detach().cpu().numpy()
                                           if hasattr(X0, "detach")
                                           else X0),
                   params=kw.get("params"))
        return None

    monkeypatch.setattr(module, "continuation_po", fake)
    return got


def _jax_guess(monkeypatch, switch, jprob, jdisc, sp, **kw):
    got = _capture(monkeypatch, jorbits)
    X = jnp.asarray(sp.x.numpy())
    jpo = jorbits.periodic_orbit_problem(jprob, jdisc, X)
    shim = SimpleNamespace(specialpoint=[SimpleNamespace(
        x=X, param=float(sp.param))], prob=jpo)
    switch(shim, 0, bj.ContinuationPar(ds=-0.01), **kw)
    monkeypatch.undo()
    return got


def _close_up_to_sign(a, b, base, tol=1e-10):
    """a and b are base + s d and base + s' d' with d' = +-d."""
    da, db = a - base, b - base
    s = np.sign(np.dot(da, db))
    assert np.abs(da - s * db).max() <= tol * max(np.abs(db).max(), 1.0)


@pytest.fixture(scope="module")
def lure():
    return lure_po_branch()


def _doubled_base(X, n, kind, M=None):
    u, T = X[:-1].reshape(-1, n), X[-1]
    if kind == "shooting":
        body = np.concatenate([u, u])
    else:
        body = np.concatenate([u[:-1], u[:-1], u[:1]])
    return np.concatenate([body.reshape(-1), [2 * T]])


def test_collocation_pd_guess_matches_jax(lure, monkeypatch):
    prob, _, br_po, ipd = lure
    sp = br_po.gamma.specialpoint[ipd]
    po = br_po.gamma.prob
    X2, disc2 = pc2.pd_doubled_guess(po, sp, ampfactor=0.05)
    ref = _jax_guess(monkeypatch, jc2.pd_branch_switch,
                     jm.lure(alpha=1.2, beta=1.0),
                     bj.Collocation(Ntst=25, m=4), sp, ampfactor=0.05)
    assert ref["disc"].Ntst == disc2.Ntst == 50
    base = _doubled_base(sp.x.numpy(), 3, "coll")
    _close_up_to_sign(X2.numpy(), ref["X"], base)
    cp = bt.ContinuationPar(ds=-0.01, dsmax=0.02, dsmin=1e-7, p_min=0.2,
                            p_max=1.05, max_steps=2, detect_bifurcation=0,
                            detect_fold=False,
                            newton_options=bt.NewtonPar(tol=1e-8,
                                                        max_iterations=30))
    br2 = bt.pd_branch_switch(br_po, ipd, cp, ampfactor=0.05, delta_p=-0.005)
    T1 = float(sp.x[-1])
    assert len(br2) >= 3
    assert br2.gamma._table()["period"][0] == pytest.approx(2 * T1, rel=0.05)


def _reconverged(prob, br_po, ipd, disc, X0):
    sp = br_po.gamma.specialpoint[ipd]
    par = prob.set_lens_param(prob.params, float(sp.param))
    sol, _ = bt.newton_po(prob, disc, X0, params=par,
                          options=bt.NewtonPar(tol=1e-9, max_iterations=30))
    assert bool(sol.converged)
    cp = bt.ContinuationPar(ds=-0.004, dsmax=0.006, dsmin=1e-8, p_min=0.2,
                            p_max=1.05, max_steps=4, detect_bifurcation=3,
                            nev=3, n_inversion=4, tol_stability=1e-3,
                            newton_options=bt.NewtonPar(tol=1e-8,
                                                        max_iterations=30))
    br = bt.continuation_po(prob, disc, sol.u, cp, params=par)
    pds = [i for i, s in enumerate(br.gamma.specialpoint) if s.type == "pd"]
    assert pds, "the PD was not re-detected"
    return br, pds[0]


def test_trapeze_pd_guess_matches_jax(lure, monkeypatch):
    prob, _, br_po, ipd = lure
    n = 3
    nodes = br_po.gamma.specialpoint[ipd].x[:-1].reshape(-1, n)
    T1 = float(br_po.gamma.specialpoint[ipd].x[-1])
    disc = bt.Trapeze(M=nodes.shape[0])
    br_tr, itr = _reconverged(prob, br_po, ipd, disc, disc.pack(nodes, T1))
    sp = br_tr.gamma.specialpoint[itr]
    X2, disc2 = pc2.pd_doubled_guess(br_tr.gamma.prob, sp, ampfactor=0.05)
    ref = _jax_guess(monkeypatch, jc2.pd_branch_switch,
                     jm.lure(alpha=1.2, beta=1.0), bj.Trapeze(M=disc.M), sp,
                     ampfactor=0.05)
    assert ref["disc"].M == disc2.M == 2 * disc.M - 1
    _close_up_to_sign(X2.numpy(), ref["X"],
                      _doubled_base(sp.x.numpy(), n, "trap"))


def test_shooting_pd_guess_matches_jax(lure, monkeypatch):
    prob, _, br_po, ipd = lure
    n = 3
    nodes = br_po.gamma.specialpoint[ipd].x[:-1].reshape(-1, n)
    T1 = float(br_po.gamma.specialpoint[ipd].x[-1])
    disc = bt.Shooting(M=3, steps_per_segment=40, method="rk4")
    idx = [int(round(t * (nodes.shape[0] - 1)))
           for t in np.linspace(0, 1, disc.M, endpoint=False)]
    br_sh, ish = _reconverged(prob, br_po, ipd, disc,
                              disc.pack(nodes[idx], T1))
    sp = br_sh.gamma.specialpoint[ish]
    X2, disc2 = pc2.pd_doubled_guess(br_sh.gamma.prob, sp, ampfactor=0.05)
    ref = _jax_guess(monkeypatch, jc2.pd_branch_switch,
                     jm.lure(alpha=1.2, beta=1.0),
                     bj.Shooting(M=3, steps_per_segment=40, method="rk4"),
                     sp, ampfactor=0.05)
    assert ref["disc"].M == disc2.M == 6
    _close_up_to_sign(X2.numpy(), ref["X"],
                      _doubled_base(sp.x.numpy(), n, "shooting"))
