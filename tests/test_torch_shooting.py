"""Parity of the port's standard shooting (`periodic/shooting.py`:
`Shooting`, its dense and matrix-free monodromies) with the JAX
package's, on the Stuart-Landau oscillator (exact limit cycle
|z| = sqrt(r), omega = mu - nu r; mirrors the Shooting cases of
`test_periodic_orbits.py` and `test_floquet_mf.py:37-49`;
`test_torch_poincare.py` holds Poincare shooting).  The JAX side runs
under `jax.jit`.

Tolerances, and why:
* residuals against the JAX package's: 1e-12 (the same arithmetic);
* the PO jacobians (the variational flow on the identity's columns)
  against the JAX package's jacfwd: 1e-10;
* the matrix-free monodromy through the model's J.v against the dense
  one: 1e-10, and its leading multipliers (Arnoldi) to 1e-9, as the JAX
  test;
* the JAX tests' bounds against the exact orbit: residual 1e-6, period
  1e-6 relative; the JAX package's residual at the port's solution: 1e-9.
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


def test_shooting_residual_jacobian_and_newton():
    """The residual on the exact orbit (`test_periodic_orbits.py:33-52`),
    the dense jacobian, and `newton_po` from a perturbed guess (`:55-79`)."""
    pair = _pair(dict(M=4, steps_per_segment=100))
    (_, _, Xj, poj), (_, _, Xt, pot) = pair[bj], pair[bt]
    res = _host(pot.F(Xt, pot.params))
    np.testing.assert_allclose(res, _jres(poj, Xj), atol=1e-12)
    assert np.linalg.norm(res) < 1e-6
    X = Xt * 1.01
    # the JAX problem's section (_xsec, _phisec), carried to the port,
    # gives the port the same residual at a perturbed orbit
    par = interop.po_params_from_numpy(
        {"_inner": {k: float(v) for k, v in poj.params["_inner"].items()},
         **{k: np.asarray(poj.params[k]) for k in ("_xsec", "_phisec")}},
        "cpu")
    np.testing.assert_allclose(_host(pot.F(X, par)),
                               _host(pot.F(X, pot.params)), atol=1e-12)
    Jj = jax.jit(jax.jacfwd(lambda X: poj.F(X, poj.params)))(
        jnp.asarray(_host(X)))
    np.testing.assert_allclose(_host(pot.jacobian(X, pot.params)),
                               np.asarray(Jj), atol=1e-10)

    pair = _pair(dict(M=3, steps_per_segment=120),
                 orbit=lambda t: 1.12 * exact_orbit(t) + 0.02,
                 T=PERIOD * 1.06)
    prob, disc, X0, _ = pair[bt]
    sol, po = bt.newton_po(prob, disc, X0, options=bt.NewtonPar(
        tol=1e-10, max_iterations=30))
    assert sol.converged
    assert float(disc.period(sol.u)) == pytest.approx(PERIOD, rel=1e-6)
    radii = np.linalg.norm(_host(sol.u[:-1]).reshape(-1, 2), axis=1)
    np.testing.assert_allclose(radii, RADIUS, rtol=5e-6)
    # the JAX problem with the port's section data vanishes at the orbit
    poj = pair[bj][3]
    assert np.linalg.norm(_jres(poj.re_make(params={
        **poj.params, "_xsec": jnp.asarray(_host(po.params["_xsec"])),
        "_phisec": jnp.asarray(_host(po.params["_phisec"]))}), sol.u)) \
        < 1e-9


def test_mf_shooting_monodromy():
    """The matrix-free monodromy (`test_floquet_mf.py:37-49`) through the
    model's J.v against the dense monodromy and the JAX package's, and
    `FloquetQaDMF` on it (`test_torch_brusselator_shooting.py` holds the
    operator against `torch.func.jvp`)."""
    pair = _pair(dict(M=3, steps_per_segment=40))
    (pj, dj, Xj, poj), (pt, dt_, Xt, pot) = pair[bj], pair[bt]
    sol, po = bt.newton_po(pt, dt_, Xt, options=bt.NewtonPar(
        tol=1e-11, max_iterations=20))
    assert sol.converged
    op = dt_.monodromy_operator(po.prob_vf, sol.u, po.params)
    V = torch.as_tensor(np.random.default_rng(0).standard_normal((3, 2)))
    Mn = dt_.monodromy(po.prob_vf, sol.u, po.params)
    np.testing.assert_allclose(_host(op.block(V)), _host(V @ Mn.T),
                               atol=1e-10)
    poj = poj.re_make(params={**poj.params, **{
        k: jnp.asarray(_host(po.params[k])) for k in ("_xsec", "_phisec")}})
    Mj = jax.jit(lambda X: dj.monodromy(pj, X, poj.params))(
        jnp.asarray(_host(sol.u)))
    np.testing.assert_allclose(_host(Mn), np.asarray(Mj), atol=1e-10)
    mf = bt.FloquetQaDMF(eigsolver=bt.ArnoldiEig(which="LM", krylov_dim=2,
                                                 restarts=4, tol=1e-12))
    expo, _, _, _ = mf(op, 2)
    got = np.sort(np.abs(np.exp(_host(expo))))[::-1]
    ref = np.sort(np.abs(np.linalg.eigvals(_host(Mn))))[::-1]
    np.testing.assert_allclose(got, ref, atol=1e-9)
    assert got[0] == pytest.approx(1.0, abs=1e-8)
