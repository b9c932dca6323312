"""`switch_codim2_po` from the zero-Hopf point of the constructed model
of test_po_switch.py:38-50 to its NS curve p1 = 2 p2 - 4 p2^2 (4 steps on
Collocation(30, 4); the JAX test runs 8, marked slow), to 1e-6, with the
inner orbit's complex multipliers on the unit circle to 1e-6 at the
curve's last point.  The model and the Hopf-curve helper are
`test_torch_switch_codim2_po.py`'s."""
import numpy as np

import bifurcationkit.jl_tpu_torch as bt
from tests._codim2_models import one_thread  # noqa: F401
from tests.test_torch_switch_codim2_po import _hopf_curve, _prob, _zh


def test_switch_zh_to_ns_curve():
    prob = _prob(_zh, [-0.3, 0.0, 0.0], p1=-0.09, p2=0.05)
    brh = _hopf_curve(prob, dict(ds=0.005, dsmax=0.01, dsmin=1e-7,
                                 p_min=-0.1, p_max=-0.001, max_steps=100),
                      dict(ds=-0.005, dsmax=0.01, dsmin=1e-7, p_min=-0.02,
                           p_max=0.2, max_steps=30))
    cand = [i for i, sp in enumerate(brh.gamma.specialpoint)
            if sp.type in ("zh", "gh") and abs(sp.param) < 0.05]
    assert cand
    cp3 = bt.ContinuationPar(ds=0.002, dsmax=0.005, dsmin=1e-8,
                             p_min=0.0001, p_max=0.2, max_steps=4,
                             detect_bifurcation=0, detect_event=0,
                             save_sol_every_step=1,
                             newton_options=bt.NewtonPar(tol=1e-8,
                                                         max_iterations=30))
    br_ns = bt.switch_codim2_po(brh, cand[0], cp3,
                                disc=bt.Collocation(Ntst=30, m=4), eps=0.08,
                                detect_codim3=0, as_type="zh")
    tbl = br_ns.gamma._table()
    p2s, p1s = np.asarray(tbl["param"]), np.asarray(tbl["p1"])
    assert len(p2s) >= 4
    np.testing.assert_allclose(p1s, 2 * p2s - 4 * p2s ** 2, atol=1e-6)
    tv = bt.po_codim2_test_values(br_ns, -1)
    mult = tv["multipliers"]
    cplx = mult[np.abs(mult.imag) > 1e-6]
    assert len(cplx) >= 2
    assert np.min(np.abs(np.abs(cplx) - 1.0)) < 1e-6
