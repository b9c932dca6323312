"""The Poincare-return-map normal form at the Freire PO branch's second
branch point (Collocation(30, 4), 30 flow steps): `get_normal_form`
takes the return map's fixed-point problem Phi(y, nu) = P(y, nu) - y
through `get_normal_form1d` (test_bp_po.py:68-81: a branch point with
|a01| < 1e-3, |b11| > 1 and a finite b30).

Its parameter derivatives are jets through the flow with nu as one more
direction.  The JAX package's return map, differentiated by nested jvps
under `jax.jit` at the port's point (x0, T, nu), gives dP/dnu,
d2P/dnu2, the mixed matrix d2P/dy dnu and the Hessian in y; with the
port's zeta, zeta* and Psi01 they give a01, b11 and a02, held to the
port's to 1e-8 relative to max(|c|, 1), and the derivatives themselves
to 1e-10 relative.  The JAX
package's whole `get_normal_form_po` there takes about 22 s on the CPU,
so its comparison of every coefficient (1e-8) is the test marked slow."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu import models as jm
from bifurcationkit.jl_tpu.detection.points import SpecialPoint
from bifurcationkit.jl_tpu.periodic import normal_forms as jnf
from tests._codim2_models import close, one_thread  # noqa: F401
from tests._po_models import freire_po_branch, jax_params

STEPS = 30


@pytest.fixture(scope="module")
def bp_form():
    _, br_po, ibp = freire_po_branch()
    return br_po, ibp, bt.get_normal_form(br_po, ibp, flow_steps=STEPS)


def test_get_normal_form_bp(bp_form):
    _, _, bp = bp_form
    assert type(bp).__name__ in ("Pitchfork", "Transcritical",
                                 "BranchPoint")
    assert abs(bp.nf["a01"]) < 1e-3
    assert np.isfinite(bp.nf["b11"]) and abs(bp.nf["b11"]) > 1.0
    assert np.isfinite(bp.nf["b30"])


def test_bp_param_derivatives_match_jax(bp_form):
    br_po, ibp, bp = bp_form
    sp = br_po.gamma.specialpoint[ibp]
    vf = br_po.gamma.prob.prob_vf
    X = torch.as_tensor(sp.x)
    x0, T, p0 = X[:-1].reshape(-1, 3)[0], float(X[-1]), float(sp.param)
    par = vf.set_lens_param(vf.params, p0)
    jvf = jm.freire()
    jpar = jax_params(par)
    jmp, jy0 = jnf.poincare_return_map(jvf, jnp.asarray(x0.numpy()), jpar,
                                       T, steps=STEPS)

    def P(q, y):
        return jmp.F(y, jvf.set_lens_param(jpar, q))

    def R01_at(q, y):
        return jax.jvp(lambda r: P(r, y), (q,), (1.0,))[1]

    @jax.jit
    def pieces():
        R01, R02 = jax.jvp(lambda q: R01_at(q, jy0), (p0,), (1.0,))
        M = jax.jacfwd(lambda y: R01_at(p0, y))(jy0)
        H = jax.jacfwd(jax.jacfwd(lambda y: P(p0, y)))(jy0)
        return R01, R02, M, H

    zeta, zs = bp.zeta.numpy(), bp.zeta_star.numpy()
    psi = bp.nf["Psi01"].numpy()
    R01, R02, M, H = (np.asarray(a) for a in pieces())

    def B(a, b):
        return np.einsum("ijk,j,k->i", H, a, b)

    close(float(R01 @ zs), bp.nf["a01"], 1e-8)
    close(float((M @ zeta + B(zeta, psi)) @ zs), bp.nf["b11"], 1e-8)
    close(float((R02 + 2 * M @ psi + B(psi, psi)) @ zs), bp.nf["a02"],
          1e-8)

    pj = bp.prob.param_derivatives(bp.params, p0)
    y0 = torch.zeros(2, dtype=torch.float64)
    for got, ref in ((pj.dFdp(y0), R01), (pj.d2Fdp2(y0), R02),
                     (pj.dFdp_dir(y0, bp.zeta), M @ zeta),
                     (pj.dFdp_dir(y0, bp.nf["Psi01"]), M @ psi)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max())


@pytest.mark.slow
def test_bp_normal_form_matches_jax(bp_form):
    br_po, ibp, bp = bp_form
    sp = br_po.gamma.specialpoint[ibp]
    jsp = SpecialPoint(type="bp", x=np.asarray(sp.x), param=float(sp.param))
    gamma = types.SimpleNamespace(
        specialpoint=[jsp],
        prob=types.SimpleNamespace(prob_vf=jm.freire(), disc=None, n_vf=3))
    ref = jnf.get_normal_form_po(gamma, 0, flow_steps=STEPS)
    assert type(ref).__name__ == type(bp).__name__
    for k in ("a01", "a02", "b11", "b20", "b30"):
        close(bp.nf[k], ref.nf[k], 1e-8)
    for k in ("Psi01", "Psi20"):
        np.testing.assert_allclose(bp.nf[k].numpy(), np.asarray(ref.nf[k]),
                                   rtol=0, atol=1e-8)
