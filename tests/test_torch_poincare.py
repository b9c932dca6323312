"""Parity of the port's Poincare shooting (`periodic/shooting.py`:
`PoincareShooting`, event-driven and free-time) with the JAX package's,
on the Stuart-Landau oscillator (exact limit cycle |z| = sqrt(r),
omega = mu - nu r; mirrors `test_periodic_orbits.py:189-238`).  The JAX
side runs under `jax.jit`.

Tolerances, and why:
* residuals and crossing periods against the JAX package's: 1e-12 and
  1e-10 (the same arithmetic; the crossing's Newton refinements);
* the PO jacobians (the variational flow on the identity's columns,
  through the section crossing) and the monodromy against the JAX
  package's jacfwd: 1e-10;
* the JAX tests' bounds against the exact orbit: residual 1e-6, period
  1e-6 / 1e-7 relative, the event-driven fixed point within 1e-5 of the
  exact orbit, multipliers {1, exp(-2 r T)} to 1e-5 and 1e-3 relative;
  the JAX package's residual at the port's solution: 1e-9.
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
from bifurcationkit.jl_tpu_torch import interop

DT = torch.float64
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


def _pair(disc_kw, cls="Shooting", orbit=exact_orbit, T=PERIOD):
    """The same PO problem in both packages."""
    out = {}
    for pkg in (bj, bt):
        kw = {} if pkg is bj else {"device": "cpu"}
        prob = pkg.models.stuart_landau(r=R0, mu=MU, nu=NU, c3=1.0, c5=0.0,
                                        **kw)
        disc = getattr(pkg, cls)(**disc_kw)
        X0 = disc.generate_solution(orbit, T, 2, **kw)
        pop = jpop if pkg is bj else bt.periodic_orbit_problem
        out[pkg] = (prob, disc, X0, pop(prob, disc, X0))
    return out


def _jres(po, X):
    return np.asarray(jax.jit(lambda X: po.F(X, po.params))(
        jnp.asarray(_host(X))))


def test_poincare_shooting_both_modes():
    """Event-driven Poincare shooting (`test_periodic_orbits.py:
    189-222`) and the free-time mode (`:225-238`): residual, period,
    Newton, monodromy, each against the JAX package's."""
    pair = _pair(dict(M=2, steps_per_segment=150, event_driven=True),
                 cls="PoincareShooting")
    (pj, dj, Xj, poj), (pt, dt_, Xt, pot) = pair[bj], pair[bt]
    assert tuple(Xt.shape) == (2,)
    res = _host(pot.F(Xt, pot.params))
    np.testing.assert_allclose(res, _jres(poj, Xj), atol=1e-12)
    assert np.linalg.norm(res) < 1e-6
    # the JAX problem's sections (_centers, _normals, _thint), carried to
    # the port, give the port the same residual at a perturbed guess
    par = interop.po_params_from_numpy(
        {"_inner": {k: float(v) for k, v in poj.params["_inner"].items()},
         **{k: np.asarray(poj.params[k])
            for k in ("_centers", "_normals", "_thint")}}, "cpu")
    np.testing.assert_allclose(_host(pot.F(Xt + 0.05, par)),
                               _host(pot.F(Xt + 0.05, pot.params)),
                               atol=1e-12)
    T = float(dt_.period_par(pt, Xt, pot.params))
    Tj = float(jax.jit(lambda X: dj.period_par(pj, X, poj.params))(Xj))
    assert T == pytest.approx(PERIOD, rel=1e-6) and abs(T - Tj) < 1e-10
    Xp = Xt + 0.05
    Jj = jax.jit(jax.jacfwd(lambda X: poj.F(X, poj.params)))(Xj + 0.05)
    np.testing.assert_allclose(_host(pot.jacobian(Xp, pot.params)),
                               np.asarray(Jj), atol=1e-10)
    sol = bt.newton(pot.re_make(u0=Xp), bt.NewtonPar(tol=1e-10,
                                                     max_iterations=25))
    assert sol.converged
    assert float(torch.linalg.vector_norm(sol.u - Xt)) < 1e-5
    M = dt_.monodromy(pt, sol.u, pot.params)
    Mj = jax.jit(lambda X: dj.monodromy(pj, X, poj.params))(
        jnp.asarray(_host(sol.u)))
    np.testing.assert_allclose(_host(M), np.asarray(Mj), atol=1e-10)
    mult = np.sort(np.abs(np.linalg.eigvals(_host(M))))[::-1]
    assert mult[0] == pytest.approx(1.0, abs=1e-5)
    assert mult[1] == pytest.approx(np.exp(-2 * R0 * PERIOD), rel=1e-3)

    pair = _pair(dict(M=2, steps_per_segment=150), cls="PoincareShooting")
    (_, _, Xj, poj), (_, dt_, Xt, pot) = pair[bj], pair[bt]
    res = _host(pot.F(Xt, pot.params))
    np.testing.assert_allclose(res, _jres(poj, Xj), atol=1e-12)
    assert np.linalg.norm(res) < 1e-6
    sol = bt.newton(pot, bt.NewtonPar(tol=1e-10, max_iterations=30))
    assert sol.converged
    assert float(dt_.period(sol.u)) == pytest.approx(PERIOD, rel=1e-7)
    assert np.linalg.norm(_jres(poj, sol.u)) < 1e-9
