"""The variational route of the port's `Flow.jvp` (`periodic/flow.py`:
the model's J.v, and d2F for rodas3, along the stages) against
`torch.func.jvp` through the integrator, and Newton on adaptive-flow
shooting against the JAX package's residual (mirrors
`test_adaptive_flow.py:96-115`).

Tolerances, and why:
* the variational flow against `torch.func.jvp` of the same integrator,
  in (u0, T), fixed-step and adaptive (its clipped steps' dependence on
  T included): 1e-12 relative to the largest tangent entry (exact jvps of
  the same maps, up to rounding);
* the shooting period against the exact one: 1e-6 (the JAX test's); the
  JAX package's residual at the port's orbit: 1e-9 (both integrate the
  same adaptive step sequence).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch.periodic.flow import Flow

DT = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=float), dtype=DT)


@pytest.mark.parametrize("method,adaptive", [
    ("rk4", False), ("dopri5", False), ("rodas3", False),
    ("dopri5", True), ("rodas3", True)])
def test_variational_matches_torch_func_jvp(method, adaptive):
    """`Flow.jvp` through the model's J.v (and d2F for rodas3: the
    Brusselator's closed form) against `torch.func.jvp` of the integrator,
    in (u0, T), for a batch of 2 states with per-state times and 3
    tangent columns each."""
    prob = bt.models.brusselator_1d(n=4, l=0.5, device="cpu", batched=True)
    kw = dict(steps=12, method=method, adaptive=adaptive, rtol=1e-6,
              atol=1e-9, max_steps=40)
    fl = Flow(prob.F, jac_op=prob.jac_op, d2F=prob.d2F_user, batched=True,
              **kw)
    fl_ad = Flow(prob.F, batched=True, **kw)
    rng = np.random.default_rng(3)
    U = prob.u0 * _t(1 + 0.1 * rng.standard_normal((2, 8)))
    T = _t([0.4, 0.7])
    dU = _t(rng.standard_normal((2, 3, 8)))
    dT = _t(rng.standard_normal((2, 3)))
    assert fl.variational and not fl_ad.variational
    out, dout = fl.jvp(U, prob.params, T, dU, dT)
    out_ad, dout_ad = fl_ad.jvp(U, prob.params, T, dU, dT)
    np.testing.assert_allclose(_host(out), _host(out_ad), rtol=0,
                               atol=1e-12)
    scale = float(torch.abs(dout_ad).max())
    np.testing.assert_allclose(_host(dout), _host(dout_ad), rtol=0,
                               atol=1e-12 * max(scale, 1.0))


def test_adaptive_shooting_period():
    """Newton on adaptive-flow shooting gives the Stuart-Landau period to
    1e-6 (`test_adaptive_flow.py:96-115`); the JAX package's residual at
    the port's orbit vanishes."""
    from bifurcationkit.jl_tpu.periodic.orbits import (
        periodic_orbit_problem as jpop)

    R0, MU, NU = 0.5, 0.2, 0.5
    radius, omega = np.sqrt(R0), MU - NU * R0
    period = 2 * np.pi / abs(omega)

    def orbit(t):
        s = np.sign(omega)
        return np.array([radius * np.cos(s * t), radius * np.sin(s * t)])

    kw = dict(M=5, adaptive=True, rtol=1e-9, atol=1e-12, max_steps=384)
    prob = bt.models.stuart_landau(r=R0, mu=MU, nu=NU, c3=1.0, c5=0.0,
                                   device="cpu")
    disc = bt.Shooting(**kw)
    X0 = disc.generate_solution(lambda t: 1.1 * orbit(t) + 0.02,
                                period * 1.05, 2, device="cpu")
    sol, po = bt.newton_po(prob, disc, X0, options=bt.NewtonPar(
        tol=1e-10, max_iterations=25))
    assert sol.converged
    assert abs(float(disc.period(sol.u)) - period) < 1e-6
    probj = bj.models.stuart_landau(r=R0, mu=MU, nu=NU, c3=1.0, c5=0.0)
    discj = bj.Shooting(**kw)
    X = jnp.asarray(_host(sol.u))
    poj = jpop(probj, discj, X)
    res = jax.jit(lambda X: poj.F(X, poj.params))(X)
    assert float(jnp.linalg.norm(res)) < 1e-9
