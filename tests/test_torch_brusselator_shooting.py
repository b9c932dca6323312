"""Hopf -> periodic orbits on the 1D Brusselator by standard shooting on
the stiff rodas3 flow, cross-checked against collocation + COP on the
same branch (mirrors `test_brusselator_shooting.py`, cut from 20 to 10
sites and the branches from 4 steps to 2: each corrector iteration's
dF/dp is forward AD through the rodas3 flow, about 0.5 s on one CPU
thread; `test_torch_brusselator_mf.py` holds the matrix-free monodromy).
The model is the port's batched Brusselator (closed-form J.v and d2F),
so the shooting jacobians and monodromies take the variational flow.

Tolerances, and why:
* the Hopf point against the JAX package's: 1e-8 (both bisect to 1e-9);
* the JAX package's residual at the port's shooting orbit: 1e-7 (the
  Newton tolerance);
* shooting against collocation: period near onset within 0.1 of
  2 pi / omega and the period curves to 1e-3 on their overlap (the JAX
  test's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu.periodic.orbits import (
    periodic_orbit_problem as jpop)
import bifurcationkit.jl_tpu_torch as bt

N_SITES = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _cp(pkg):
    return pkg.ContinuationPar(ds=0.01, dsmax=0.02, dsmin=1e-6, p_min=0.29,
                               p_max=0.8, max_steps=120,
                               detect_bifurcation=3, nev=10, n_inversion=4,
                               newton_options=pkg.NewtonPar(tol=1e-9))


@pytest.fixture(scope="module")
def branches():
    brt = bt.continuation(bt.models.brusselator_1d(
        n=N_SITES, device="cpu", batched=True), bt.PALC(), _cp(bt))
    brj = bj.continuation(bj.models.brusselator_1d(n=N_SITES), bj.PALC(),
                          _cp(bj))
    return brt, brj


def test_shooting_vs_collocation(branches):
    brt, brj = branches
    hj = [sp.param for sp in brj.specialpoint if sp.type == "hopf"]
    ih = [i for i, sp in enumerate(brt.specialpoint) if sp.type == "hopf"][0]
    assert abs(brt.specialpoint[ih].param - hj[0]) < 1e-8
    cpo = bt.ContinuationPar(ds=0.01, dsmax=0.02, dsmin=1e-6, p_min=0.29,
                             p_max=0.75, max_steps=2, detect_bifurcation=2,
                             nev=6, tol_stability=1e-3,
                             newton_options=bt.NewtonPar(
                                 tol=1e-7, max_iterations=20,
                                 linesearch=True))
    disc = bt.Shooting(M=2, steps_per_segment=30, method="rodas3")
    br_sh = bt.continuation_hopf_po(brt, ih, cpo, delta_p=0.02, disc=disc)
    tab = br_sh.gamma._table()
    assert len(tab["param"]) >= 3
    assert bool(np.asarray(tab["stable"])[0])
    ev = np.asarray(brt.specialpoint[ih].eigenvals)
    omega = abs(float(np.imag(ev[np.argmin(np.abs(ev.real))])))
    assert abs(np.asarray(tab["period"])[0] - 2 * np.pi / omega) < 0.1
    # the JAX package's flow rows at the port's last shooting orbit (the
    # phase row's section moved with the branch)
    sol = br_sh.gamma.sol[-1]
    discj = bj.Shooting(M=2, steps_per_segment=30, method="rodas3")
    probj = bj.models.brusselator_1d(n=N_SITES)
    Xj = jnp.asarray(_host(sol["x"]))
    poj = jpop(probj, discj, Xj,
               params=probj.set_lens_param(probj.params, float(sol["p"])))
    assert float(jnp.linalg.norm(jax.jit(
        lambda X: poj.F(X, poj.params))(Xj)[:-1])) < 1e-7

    br_cl = bt.continuation_hopf_po(
        brt, ih, cpo.replace(newton_options=cpo.newton_options.replace(
            linesearch=False)),
        delta_p=0.02, disc=bt.Collocation(Ntst=20, m=4), use_cop=True)
    tab2 = br_cl.gamma._table()
    p_sh, per_sh = np.asarray(tab["param"]), np.asarray(tab["period"])
    p_cl, per_cl = np.asarray(tab2["param"]), np.asarray(tab2["period"])
    o, o2 = np.argsort(p_sh), np.argsort(p_cl)
    lo = max(p_sh.min(), p_cl.min())
    hi = min(p_sh.max(), p_cl.max())
    assert hi > lo
    ps = np.linspace(lo, hi, 5)
    assert np.abs(np.interp(ps, p_sh[o], per_sh[o])
                  - np.interp(ps, p_cl[o2], per_cl[o2])).max() < 1e-3
