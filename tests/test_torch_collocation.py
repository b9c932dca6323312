"""Parity of the port's collocation periodic orbits
(`periodic/collocation.py`, `FloquetGEV`, `monodromy_from_maps`, the
Collocation routes of `orbits.py`) with the JAX package's, on the
Stuart-Landau oscillator (exact limit cycle |z| = sqrt(r),
omega = mu - nu r; mirrors the Collocation cases of
`test_periodic_orbits.py`, whose Hopf branch switching
`test_torch_collocation_branch.py` holds).  Both packages get the same
orbit; the JAX side runs under `jax.jit` (its Newton and continuation are
jitted inside the package).

Tolerances, and why:
* residuals and interval maps against the JAX package's: 1e-12 (the same
  arithmetic up to rounding);
* Newton iterates, branch parameters and periods: 1e-9 (both converge to
  1e-10 or tighter from the same guess through the same steps);
* multipliers against the JAX package's: 1e-9 (FloquetGEV: its trivial
  exponent; both put the radial multiplier exp(-2 r T) ~ 3e-55 below
  1e-20, QZ's noise); against the analytic {1, exp(-2 r T)}: the JAX
  tests' checks (1e-5 / 1e-6 absolute, and pytest.approx's 1e-3 / 1e-4
  relative, whose 1e-12 absolute floor these tiny values fall under);
* the pairwise-tree monodromy against the sequential chain: 1e-10;
* amplitudes against 2 sqrt(p): the JAX test's 5e-3 relative.
"""
import jax
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu.periodic.floquet import (
    floquet_multipliers as jfloquet_multipliers)
from bifurcationkit.jl_tpu.periodic.orbits import (
    newton_po as jnewton_po, periodic_orbit_problem as jpop)
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop

R0, MU, NU = 0.5, 0.2, 0.5
RADIUS, OMEGA = np.sqrt(R0), MU - NU * R0
PERIOD = 2 * np.pi / abs(OMEGA)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def exact_orbit(t):
    s = np.sign(OMEGA)
    return np.array([RADIUS * np.cos(s * t), RADIUS * np.sin(s * t)])


def _kw(pkg):
    return {} if pkg is bj else {"device": "cpu"}


def _sl(pkg):
    return pkg.models.stuart_landau(r=R0, mu=MU, nu=NU, c3=1.0, c5=0.0,
                                    **_kw(pkg))


def _newton(pkg, disc, guess, T0, tol):
    X0 = disc.generate_solution(guess, T0, 2, **_kw(pkg))
    npo = jnewton_po if pkg is bj else bt.newton_po
    return npo(_sl(pkg), disc, X0, options=pkg.NewtonPar(
        tol=tol, max_iterations=30))


def test_residual_and_newton_po():
    """The residual on the exact orbit (`test_periodic_orbits.py:33-52`)
    and `newton_po` from a perturbed guess (`:55-79`)."""
    res, pos = {}, {}
    for pkg in (bj, bt):
        disc = pkg.Collocation(Ntst=20, m=4)
        X0 = disc.generate_solution(exact_orbit, PERIOD, 2, **_kw(pkg))
        pop = jpop if pkg is bj else bt.periodic_orbit_problem
        po = pos[pkg] = pop(_sl(pkg), disc, X0)
        res[pkg] = _host(jax.jit(lambda X: po.F(X, po.params))(X0)
                         if pkg is bj else po.F(X0, po.params))
    np.testing.assert_allclose(res[bt], res[bj], atol=1e-12)
    assert np.linalg.norm(res[bt]) < 1e-6
    # the JAX problem's collocation data (_uref, _phi, _mesh), carried to
    # the port, gives the port the same residual at a perturbed orbit
    pj, pt = pos[bj].params, pos[bt].params
    par = interop.po_params_from_numpy(
        {"_inner": {k: float(v) for k, v in pj["_inner"].items()},
         **{k: np.asarray(pj[k]) for k in ("_uref", "_phi", "_mesh")}},
        "cpu")
    X1 = pos[bt].u0 * 1.01
    np.testing.assert_allclose(_host(pos[bt].F(X1, par)),
                               _host(pos[bt].F(X1, pt)), atol=1e-12)

    sols = {pkg: _newton(pkg, pkg.Collocation(Ntst=20, m=4),
                         lambda t: 1.12 * exact_orbit(t) + 0.02,
                         PERIOD * 1.06, 1e-10)[0] for pkg in (bj, bt)}
    assert sols[bt].converged and bool(sols[bj].converged)
    assert sols[bt].itnewton == int(sols[bj].itnewton)
    np.testing.assert_allclose(_host(sols[bt].u), _host(sols[bj].u),
                               atol=1e-9)
    assert float(sols[bt].u[-1]) == pytest.approx(PERIOD, rel=1e-6)
    radii = np.linalg.norm(_host(sols[bt].u[:-1]).reshape(-1, 2), axis=1)
    np.testing.assert_allclose(radii, RADIUS, rtol=5e-5)


def test_floquet_multipliers_gev_and_assoc_monodromy():
    """The dense multipliers {1, exp(-2 r T)} (`test_periodic_orbits.py:
    82-97`), FloquetGEV against them (`:150-167`), and the pairwise-tree
    monodromy against the sequential chain (`:256-278`), each against the
    JAX package's."""
    out = {}
    for pkg in (bj, bt):
        disc = pkg.Collocation(Ntst=20, m=4)
        sol, po = _newton(pkg, disc, exact_orbit, PERIOD, 1e-11)
        assert bool(sol.converged)
        out[pkg] = (disc, sol, po)
    (dj, solj, poj), (dt_, solt, pot) = out[bj], out[bt]
    mj = jfloquet_multipliers(dj, poj.prob_vf, solj.u, poj.params)
    mt = bt.floquet_multipliers(dt_, pot.prob_vf, solt.u, pot.params)
    np.testing.assert_allclose(mt, mj, atol=1e-9)
    m = np.sort(np.abs(mt))[::-1]
    assert m[0] == pytest.approx(1.0, abs=1e-5)
    assert m[1] == pytest.approx(np.exp(-2 * R0 * PERIOD), rel=1e-3)

    maps = dt_.interval_maps(pot.prob_vf, solt.u, pot.params)
    mapsj = jax.jit(lambda X: dj.interval_maps(poj.prob_vf, X,
                                               poj.params))(solj.u)
    np.testing.assert_allclose(_host(maps), np.asarray(mapsj), atol=1e-12)
    expo, _, cv, _ = bt.FloquetGEV()(maps, 2)
    expoj = np.asarray(bj.FloquetGEV()(mapsj, 2)[0])
    # the trivial exponent to 1e-9; the radial multiplier exp(-2 r T) ~
    # 3e-55 lies below both QZ's resolution (a multiplier < 1e-20 each)
    assert abs(_host(expo)[0] - expoj[0]) < 1e-9
    assert max(_host(expo)[1].real, expoj[1].real) < np.log(1e-20)
    mult = np.sort(np.abs(np.exp(_host(expo))))[::-1]
    assert mult[0] == pytest.approx(1.0, abs=1e-6)
    assert mult[1] == pytest.approx(np.exp(-2 * R0 * PERIOD), rel=1e-4)

    M_seq = bt.monodromy_from_maps(maps, method="seq")
    M_tree = bt.monodromy_from_maps(maps)
    np.testing.assert_allclose(_host(M_tree), _host(M_seq), atol=1e-10)
    np.testing.assert_allclose(_host(M_seq), _host(dt_.monodromy(
        pot.prob_vf, solt.u, pot.params)), atol=1e-12)
    # 21 maps: the tree's odd leftovers keep their place in the product
    M21 = torch.cat([maps, maps[:1]])
    np.testing.assert_allclose(_host(bt.monodromy_from_maps(M21)),
                               _host(bt.monodromy_from_maps(M21, "seq")),
                               atol=1e-10)
    assert np.abs(np.linalg.eigvals(_host(M_tree)) - 1.0).min() < 1e-6


def test_mesh_adaptation():
    """Continuation with mesh adaptation in the update hook
    (`test_periodic_orbits.py:170-186`, cut from 15 to 7 steps): the
    radius stays sqrt(r), the branch and the adapted mesh equal the JAX
    package's."""
    out = {}
    for pkg in (bj, bt):
        disc = pkg.Collocation(Ntst=14, m=3, adapt_mesh=True)
        X0 = disc.generate_solution(exact_orbit, PERIOD, 2, **_kw(pkg))
        cp = pkg.ContinuationPar(
            ds=0.02, dsmax=0.06, dsmin=1e-6, p_min=0.2, p_max=0.9,
            max_steps=7, detect_bifurcation=0, detect_fold=False,
            newton_options=pkg.NewtonPar(tol=1e-8, max_iterations=25))
        br = pkg.continuation_po(_sl(pkg), disc, X0, cp)
        out[pkg] = br
    tj = out[bj].gamma._table()
    tt = out[bt].gamma._table()
    for k in ("param", "period", "amplitude"):
        np.testing.assert_allclose(np.asarray(tt[k], dtype=float),
                                   np.asarray(tj[k], dtype=float), atol=1e-9)
    # the last orbit, on its adapted mesh, is the JAX package's
    np.testing.assert_allclose(_host(out[bt].gamma.sol[-1]["x"]),
                               _host(out[bj].gamma.sol[-1]["x"]), atol=1e-9)
    assert len(tt["param"]) > 5
    mask = np.asarray(tt["param"]) > 0.3
    np.testing.assert_allclose(np.asarray(tt["amplitude"])[mask],
                               2 * np.sqrt(np.asarray(tt["param"])[mask]),
                               rtol=5e-3)
