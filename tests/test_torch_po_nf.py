"""Iooss PD normal form (`periodic/normal_forms.py::_pd_iooss_core`) on
the Lur'e orbit at its PD (Collocation(25, 4), 304 unknowns): the port
against the JAX package at the same orbit.  The JAX core runs jitted
(its host conversions pass traced values through) with the JAX package's
random null-vector borders, which the port takes explicitly.
Tolerances: a and b3 to 1e-8 relative to max(|c|, 1); b3 against the
reference's ApproxFun gold value -0.30509421737255177 to 1e-2 relative
(testLure.jl:121); the port's own borders (a CPU torch.Generator) to
1e-5, the point's distance from an exact PD.  The helpers here serve
`test_torch_po_nf_ns.py` too."""
import builtins

import jax
import jax.numpy as jnp
import pytest
import torch

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu import models as jm
from bifurcationkit.jl_tpu.periodic import normal_forms as jnf
from bifurcationkit.jl_tpu_torch.periodic import normal_forms as pnf
from tests._codim2_models import close, one_thread  # noqa: F401
from tests._po_models import jax_null_borders, jax_params, lure_po_branch


def _float(x):
    return x if isinstance(x, jax.core.Tracer) else builtins.float(x)


def _complex(*a):
    if any(isinstance(x, jax.core.Tracer) for x in a):
        return a[0] + 1j * a[1] if len(a) > 1 else a[0]
    return builtins.complex(*a)


@pytest.fixture(scope="module")
def traced(monkeypatch_module):
    """Let the JAX cores trace under jit: their float()/complex()
    conversions pass traced values through inside the module."""
    monkeypatch_module.setattr(jnf, "float", _float, raising=False)
    monkeypatch_module.setattr(jnf, "complex", _complex, raising=False)
    op = jnf._coll_linear_operator

    def operator(*a, **k):
        # its dtype test on the (host) shift runs at trace time
        with jax.ensure_compile_time_eval():
            return op(*a, **k)

    monkeypatch_module.setattr(jnf, "_coll_linear_operator", operator)


def _concrete_period(disc, T):
    """The JAX Collocation with the period as a host number (the NS core
    branches on the shift's dtype, which needs it concrete under jit)."""
    class _Disc(type(disc)):
        def split(self, X, n):
            return super().split(X, n)[0], T

    return _Disc(Ntst=disc.Ntst, m=disc.m)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _point(br, i):
    g = br.gamma
    sp = g.specialpoint[i]
    po = g.prob
    par = po.set_lens_param(po.params, sp.param)
    return po, torch.as_tensor(sp.x), par


def test_lure_pd_iooss_matches_jax(traced):
    _, _, br_po, ipd = lure_po_branch()
    po, X, par = _point(br_po, ipd)
    disc, n = po.disc, po.n_vf
    nj = disc.unknown_size(n) - 1
    got = pnf._pd_iooss_core(disc, po.prob_vf, n, X, par["_inner"],
                             par["_mesh"], borders=jax_null_borders(nj))
    pj = jm.lure(alpha=1.2, beta=1.0)
    dj = bj.Collocation(Ntst=disc.Ntst, m=disc.m)
    ref = jax.jit(lambda X_, p_, m_: pick(jnf._pd_iooss_core(
        dj, pj, n, X_, p_, m_), ("a", "b3")))(
        jnp.asarray(X.numpy()), jax_params(par["_inner"]),
        jnp.asarray(par["_mesh"].numpy()))
    close(got["a"], float(ref["a"]))
    close(got["b3"], float(ref["b3"]))
    assert got["b3"] == pytest.approx(-0.30509421737255177, rel=1e-2)
    # the port's own borders (a CPU torch.Generator): the same numbers up
    # to the point's distance from an exact PD
    pt = bt.get_normal_form_po(br_po, ipd, method="iooss")
    assert pt.subtype == "SuperCritical"
    close(pt.nf["b3"], got["b3"], 1e-5)


def pick(d, keys):
    return {k: d[k] for k in keys}
