"""Poincare-return-map normal forms (`periodic/normal_forms.py`) at the
Lur'e PD (Collocation(25, 4)): the return map's jacobian and `pd_coef`
of `make_prm_coef_kernels` (120 flow steps) against the JAX package's
jitted kernels at the same point, q and p, and `get_normal_form` on the
PO branch by both routes.

The port takes the map's derivatives as Taylor jets through the flow,
the JAX package by nested forward AD: both are exact derivatives of the
same discrete map.  Tolerances: the jacobian to 1e-10 absolute, pd_coef
to 1e-8 relative; the map's multiplier within 5e-2 of -1, c > 0 and
SuperCritical on the PRM route, b3 < 0 on the Iooss route
(test_po_codim2.py:102-168)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu import models as jm
from bifurcationkit.jl_tpu.periodic import normal_forms as jnf
from bifurcationkit.jl_tpu_torch.periodic import normal_forms as pnf
from tests._codim2_models import close, one_thread  # noqa: F401
from tests._po_models import jax_params, lure_po_branch

STEPS = 120


@pytest.fixture(scope="module")
def lure():
    return lure_po_branch()


def test_pd_coef_matches_jax(lure):
    _, _, br_po, ipd = lure
    po = br_po.gamma.prob
    sp = br_po.gamma.specialpoint[ipd]
    X = torch.as_tensor(sp.x)
    x0, T = X[:-1].reshape(-1, 3)[0], float(X[-1])
    par = po.prob_vf.set_lens_param(po.prob_vf.params, sp.param)
    dP, pd_coef, _ = pnf.make_prm_coef_kernels(po.prob_vf, flow_steps=STEPS)
    jdP, jpd, _ = jnf.make_prm_coef_kernels(jm.lure(alpha=1.2, beta=1.0),
                                            flow_steps=STEPS)
    jpar = jax_params(par)
    A = dP(x0, T, par).numpy()
    Aj = np.asarray(jdP(jnp.asarray(x0.numpy()), T, jpar))
    np.testing.assert_allclose(A, Aj, rtol=0, atol=1e-10)
    vals, vecs = np.linalg.eig(A)
    i0 = int(np.argmin(np.abs(vals + 1.0)))
    assert abs(vals[i0] + 1.0) < 5e-2
    q = np.real(vecs[:, i0])
    q /= np.linalg.norm(q)
    valsT, vecsT = np.linalg.eig(A.T)
    p = np.real(vecsT[:, int(np.argmin(np.abs(valsT + 1.0)))])
    p /= np.dot(p, q)
    got = pd_coef(x0, T, par, q, p)
    ref = float(jpd(jnp.asarray(x0.numpy()), T, jpar, jnp.asarray(q),
                    jnp.asarray(p)))
    close(got, ref)


def test_get_normal_form_on_po_branch(lure):
    """`get_normal_form` routes a PO branch to `get_normal_form_po`."""
    _, _, br_po, ipd = lure
    pt = bt.get_normal_form(br_po, ipd, flow_steps=STEPS)
    assert type(pt).__name__ == "PeriodDoubling"
    assert abs(pt.nf["mu"] + 1.0) < 5e-2
    assert pt.nf["c"] > 0 and pt.subtype == "SuperCritical"
    dP, pd_coef, _ = pnf.make_prm_coef_kernels(br_po.gamma.prob.prob_vf,
                                               flow_steps=STEPS)
    sp = br_po.gamma.specialpoint[ipd]
    X = torch.as_tensor(sp.x)
    par = br_po.gamma.prob.prob_vf.set_lens_param(
        br_po.gamma.prob.prob_vf.params, sp.param)
    c = pd_coef(X[:-1].reshape(-1, 3)[0], float(X[-1]), par,
                pt.zeta.numpy(), pt.zeta_star.numpy())
    close(c, pt.nf["c"], 1e-10)
    pti = bt.get_normal_form(br_po, ipd, method="iooss")
    assert pti.nf["b3"] < 0 and pti.subtype == "SuperCritical"
