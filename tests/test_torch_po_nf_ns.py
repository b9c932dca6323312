"""Iooss NS normal form (`periodic/normal_forms.py::_ns_iooss_core`) on
the Freire orbit: the switched branch's NS point (Collocation(30, 4),
364 unknowns), the port against the JAX package at the same orbit with
the same random null-vector borders (the JAX core jitted, its host
conversions passed through), to 1e-8 relative to max(|c|, 1); the port's
own borders to 1e-5 (the point's distance from an exact NS); subcritical
with Re d > 0 and 0 < theta < pi (freire.jl:65-66)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu import models as jm
from bifurcationkit.jl_tpu.periodic import normal_forms as jnf
from bifurcationkit.jl_tpu_torch.periodic import normal_forms as pnf
from tests._codim2_models import close, one_thread  # noqa: F401
from tests._po_models import freire_switched, jax_null_borders, jax_params
from tests.test_torch_po_nf import (_concrete_period, _point,  # noqa: F401
                                    monkeypatch_module, pick, traced)


def test_freire_ns_iooss_matches_jax(traced):
    _, _, _, br2 = freire_switched()
    ins = next(i for i, s in enumerate(br2.gamma.specialpoint)
               if s.type == "ns")
    assert br2.gamma.specialpoint[ins].param == pytest.approx(-0.5917,
                                                              abs=2e-3)
    pt = bt.neimark_sacker_iooss(br2, ins)
    assert pt.subtype == "SubCritical" and pt.nf["d"].real > 0
    assert 0 < pt.omega < np.pi
    po, X, par = _point(br2, ins)
    disc, n = po.disc, po.n_vf
    nj = disc.unknown_size(n) - 1
    got = pnf._ns_iooss_core(disc, po.prob_vf, n, X, par["_inner"],
                             par["_mesh"], pt.omega,
                             borders=jax_null_borders(nj))
    pj = jm.freire()
    dj = _concrete_period(bj.Collocation(Ntst=disc.Ntst, m=disc.m),
                          float(X[-1]))
    ref = jax.jit(lambda X_, p_, m_: pick(jnf._ns_iooss_core(
        dj, pj, n, X_, p_, m_, pt.omega), ("a", "d")))(
        jnp.asarray(X.numpy()), jax_params(par["_inner"]),
        jnp.asarray(par["_mesh"].numpy()))
    close(got["a"], float(ref["a"]))
    close(got["d"], complex(ref["d"]))
    # the port's own borders agree up to the point's distance from an
    # exact NS
    close(pt.nf["d"], got["d"], 1e-5)
