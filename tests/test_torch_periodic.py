"""Parity of the port's trapezoid periodic orbits (`periodic/trapezoid.py`,
`floquet.py`, `orbits.py`) with the JAX package's, on the Stuart-Landau
oscillator (exact limit cycle |z| = sqrt(r), omega = mu - nu r; mirrors
`test_periodic_orbits.py` and `test_floquet_mf.py:51-75`) with M = 80
slices: the trapezoid residual, `newton_po`, the dense and the
matrix-free monodromy and `FloquetEig` (`test_torch_periodic_cgl.py`
holds the cGL2d pieces).  Both packages get the same orbit and
parameters: `interop.po_params_from_numpy` carries the JAX problem's
phase data to the port.

Tolerances, and why:
* the model's closed-form J.v against the jvp of F: 1e-12;
* residuals, Newton iterates, dense monodromies and matrix-free
  applications solved to rtol 1e-12: 1e-9 of the JAX package's (the same
  arithmetic on both sides up to rounding; the MF products through
  GMRES to 1e-12), and the exponents of `FloquetEig`;
* the orbit's period to the trapezoid's accuracy (2e-3, as the JAX
  test), its radius to 1e-2 and the radial multiplier exp(-2 r T) to 5e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu.periodic.floquet import FloquetEig as JFloquetEig
from bifurcationkit.jl_tpu.periodic.orbits import (
    newton_po as jnewton_po, periodic_orbit_problem as jpop)
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop

CPU = torch.device("cpu")
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


def exact_orbit(t):
    s = np.sign(OMEGA)
    return np.array([RADIUS * np.cos(s * t), RADIUS * np.sin(s * t)])


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


@pytest.fixture(scope="module")
def sl_orbits():
    """The perturbed Stuart-Landau guess of `test_periodic_orbits.py:56`
    solved by `newton_po` in both packages."""
    out = {}
    guess = (lambda t: 1.12 * exact_orbit(t) + 0.02)
    for pkg, npo, kw in ((bj, jnewton_po, {}), (bt, bt.newton_po,
                                                {"device": "cpu"})):
        prob = pkg.models.stuart_landau(r=R0, mu=MU, nu=NU, c3=1.0, c5=0.0,
                                        **kw)
        disc = pkg.Trapeze(M=80)
        X0 = disc.generate_solution(guess, PERIOD * 1.06, 2, **kw)
        sol, po = npo(prob, disc, X0,
                      options=pkg.NewtonPar(tol=1e-10, max_iterations=30))
        out[pkg] = (prob, disc, X0, sol, po)
    return out


def test_sl_residual_on_exact_orbit():
    res = {}
    for pkg, kw in ((bj, {}), (bt, {"device": "cpu"})):
        prob = pkg.models.stuart_landau(r=R0, mu=MU, nu=NU, c3=1.0, c5=0.0,
                                        **kw)
        disc = pkg.Trapeze(M=80)
        X0 = disc.generate_solution(exact_orbit, PERIOD, 2, **kw)
        pop = jpop if pkg is bj else bt.periodic_orbit_problem
        po = pop(prob, disc, X0)
        res[pkg] = _host(po.F(X0, po.params))
    np.testing.assert_allclose(res[bt], res[bj], rtol=0, atol=1e-12)
    assert np.linalg.norm(res[bt]) < 2e-2       # O(h^2) trapezoid error
    # the model's closed-form batched J.v against the jvp of its F
    prob = bt.models.stuart_landau(r=0.3, mu=0.2, nu=0.7, c3=1.1, c5=0.4,
                                   device="cpu")
    rng = np.random.default_rng(6)
    u, v = (torch.as_tensor(rng.standard_normal((5, 2))) for _ in range(2))
    ref = torch.func.jvp(lambda x: prob.F(x, prob.params), (u,), (v,))[1]
    np.testing.assert_allclose(_host(prob.jac_op(u, prob.params)(v)),
                               _host(ref), atol=1e-12)


def test_sl_newton_po_matches_jax(sl_orbits):
    _, disc, _, solj, _ = sl_orbits[bj]
    _, _, _, solt, pot = sl_orbits[bt]
    assert solt.converged and bool(solj.converged)
    assert solt.itnewton == int(solj.itnewton)
    np.testing.assert_allclose(_host(solt.u), _host(solj.u), rtol=0,
                               atol=1e-9)
    assert float(solt.u[-1]) == pytest.approx(PERIOD, rel=2e-3)
    radii = np.linalg.norm(_host(solt.u[:-1]).reshape(-1, 2), axis=1)
    np.testing.assert_allclose(radii, RADIUS, rtol=1e-2)
    # the JAX problem's phase data, carried to the port, gives the same
    # residual at the port's orbit
    pj = sl_orbits[bj][4]
    par = interop.po_params_from_numpy(
        {"_inner": {k: float(v) for k, v in pj.params["_inner"].items()},
         "_uref": np.asarray(pj.params["_uref"]),
         "_phi": np.asarray(pj.params["_phi"])}, CPU)
    np.testing.assert_allclose(_host(pot.F(solt.u, par)),
                               _host(pot.F(solt.u, pot.params)), atol=1e-12)


def test_sl_monodromy_dense_mf_and_floquet(sl_orbits):
    """The dense monodromy against the JAX package's, the matrix-free
    operator (one vector and a block) against the dense one
    (`test_floquet_mf.py:51-75`), and `FloquetEig` / `floquet_multipliers`
    against the JAX package's."""
    probj, discj, _, solj, poj = sl_orbits[bj]
    _, disct, _, solt, pot = sl_orbits[bt]
    Mj = np.asarray(discj.monodromy(poj.prob_vf, solj.u, poj.params))
    Mt = disct.monodromy(pot.prob_vf, solt.u, pot.params)
    np.testing.assert_allclose(_host(Mt), Mj, rtol=0, atol=1e-9)
    op = disct.monodromy_operator(
        pot.prob_vf, solt.u, pot.params,
        linsolver=bt.GMRES(restart=4, maxiter=40, rtol=1e-12))
    V = torch.as_tensor(np.random.default_rng(0).standard_normal((3, 2)),
                        dtype=DT)
    np.testing.assert_allclose(_host(op.block(V)), _host(V @ Mt.T),
                               atol=1e-10)
    np.testing.assert_allclose(_host(op(V[0])), _host(Mt @ V[0]), atol=1e-10)
    ej = np.asarray(JFloquetEig()(jnp.asarray(Mj), 2)[0])
    et, _, cv, _ = bt.FloquetEig()(Mt, 2)
    np.testing.assert_allclose(_host(et), ej, atol=1e-9)
    assert abs(complex(_host(et)[0])) < 1e-6          # the trivial exponent
    # `floquet_multipliers` sorts as the JAX package's dense eig does
    mt = bt.floquet_multipliers(disct, pot.prob_vf, solt.u, pot.params)
    mj = np.linalg.eigvals(Mj)
    np.testing.assert_allclose(mt, mj[np.lexsort((-mj.imag, -mj.real))],
                               atol=1e-9)
    # the radial multiplier, exp(-2 r T), to the trapezoid's accuracy
    assert np.sort(np.abs(mt))[0] == pytest.approx(
        np.exp(-2 * R0 * PERIOD), rel=5e-2)
