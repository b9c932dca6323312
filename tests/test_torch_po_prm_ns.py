"""Poincare-return-map normal forms at the Freire points.  `ns_coef` of
`make_prm_coef_kernels` (60 flow steps) at the switched branch's NS
point: the JAX package's jitted `ns_coef` compiles for about 40 s on the
CPU, so it is held to the JAX package in two links, both to 1e-10
relative: the return map's second and third derivatives along the four
real directions its polarization uses (q's real and imaginary parts,
their sum and difference) against the JAX return map's nested jvps, and
`ns_coef` against the port's `neimark_sacker_nf` on the same map (whose
formula `test_torch_maps_nf.py` holds to the JAX package's); `ns_coef`
itself is checked to 1e-8 relative there.  `get_normal_form` there (PRM:
subcritical, as the Iooss form; freire.jl:65-66).  The branch point's
form is in `test_torch_po_prm_bp.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu import models as jm
from bifurcationkit.jl_tpu.periodic import normal_forms as jnf
from bifurcationkit.jl_tpu_torch.normal_forms.maps import neimark_sacker_nf
from bifurcationkit.jl_tpu_torch.periodic import normal_forms as pnf
from tests._codim2_models import close, one_thread  # noqa: F401
from tests._po_models import freire_switched, jax_params

STEPS = 60


@pytest.fixture(scope="module")
def freire():
    return freire_switched()


def test_ns_coef_matches_jax(freire):
    _, _, _, br2 = freire
    ins = next(i for i, s in enumerate(br2.gamma.specialpoint)
               if s.type == "ns")
    sp = br2.gamma.specialpoint[ins]
    vf = br2.gamma.prob.prob_vf
    X = torch.as_tensor(sp.x)
    x0, T = X[:-1].reshape(-1, 3)[0], float(X[-1])
    par = vf.set_lens_param(vf.params, sp.param)
    mp, y0 = pnf.poincare_return_map(vf, x0, par, T, steps=STEPS)
    pt = neimark_sacker_nf(mp, y0, par)
    q, p = pt.zeta.numpy(), pt.zeta_star.numpy()
    _, _, ns_coef = pnf.make_prm_coef_kernels(vf, flow_steps=STEPS)
    close(ns_coef(x0, T, par, q, p, pt.omega), pt.nf["d"], 1e-10)

    r, s_ = q.real, q.imag
    D = np.stack([r, s_, r + s_, r - s_])
    jets = pnf._ReturnMapJets(vf, x0, par, T, steps=STEPS)
    got = jets.jets(y0, torch.tensor(D), 3)
    jpar = jax_params(par)
    jmp, jy0 = jnf.poincare_return_map(jm.freire(), jnp.asarray(x0.numpy()),
                                       jpar, T, steps=STEPS)

    def q23(d):
        f = lambda e: jmp.F(jy0 + e * d, jpar)
        f1 = lambda e: jax.jvp(f, (e,), (1.0,))[1]
        f2 = lambda e: jax.jvp(f1, (e,), (1.0,))[1]
        return f2(0.0), jax.jvp(f2, (0.0,), (1.0,))[1]

    r2, r3 = jax.jit(jax.vmap(q23))(jnp.asarray(D))
    for g, ref in ((got[2], r2), (got[3], r3)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max())


def test_get_normal_form_ns(freire):
    _, _, _, br2 = freire
    ins = next(i for i, s in enumerate(br2.gamma.specialpoint)
               if s.type == "ns")
    pt = bt.get_normal_form(br2, ins, flow_steps=STEPS)
    assert type(pt).__name__ == "NeimarkSacker"
    assert pt.subtype == "SubCritical" and 0 < pt.omega < np.pi
