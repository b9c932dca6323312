"""Parity of the port's ODE flows (`periodic/flow.py`) with the JAX
package's (mirrors `test_adaptive_flow.py:24-93` and
`test_periodic_orbits.py:211-237`; `test_torch_flow_variational.py`
holds the variational route and adaptive shooting).  The JAX side runs
under `jax.jit`.

Tolerances, and why:
* flows against the JAX package's: 1e-10 fixed-step and 1e-9 adaptive
  (the same step sequence; the adaptive error norm's rounding can move a
  step-size choice in its last digits);
* accepted/rejected step counts: equal;
* derivatives through the adaptive loop and rodas3 monodromies against
  the JAX package's jacfwd: 1e-9 and 1e-12;
* the JAX tests' own bounds against exact or brute-force references
  (errors falling with rtol, the rotation monodromy to 1e-6, dphi/dT =
  F to 1e-6, rodas3's third order, L-stability, the stiff Van der Pol
  to 1e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifurcationkit.jl_tpu.periodic.flow import Flow as JFlow
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


def osc_j(u, p):
    return jnp.array([u[1], -u[0]])


def osc(u, p):
    # u'' = -u as a system: the flow rotates by angle T
    return torch.stack([u[..., 1], -u[..., 0]], -1)


def osc_jv(u, p):
    return lambda v: osc(v, p)


def test_adaptive_tolerance_steps_and_parity():
    """The error falls with rtol (`test_adaptive_flow.py:24-42`), the
    solver picks its steps and reaches T (`:45-53`); outputs and step
    counts equal the JAX package's."""
    u0 = np.array([1.0, 0.0])
    T = 20.0
    exact = np.array([np.cos(T), -np.sin(T)])
    errs = []
    for rtol in (1e-4, 1e-6, 1e-8):
        kw = dict(adaptive=True, rtol=rtol, atol=rtol * 1e-2, max_steps=512)
        out = Flow(osc, **kw)(_t(u0), None, _t(T))
        outj = jax.jit(lambda u: JFlow(osc_j, **kw)(u, None, T))(u0)
        np.testing.assert_allclose(_host(out), np.asarray(outj), atol=1e-9)
        errs.append(float(np.linalg.norm(_host(out) - exact)))
    assert errs[0] > errs[1] > errs[2]
    assert errs[1] < errs[0] / 10 and errs[2] < errs[1] / 10
    assert errs[2] < 1e-7

    kw = dict(adaptive=True, rtol=1e-6, atol=1e-9, max_steps=512)
    out, stats = Flow(osc, **kw).solve_stats(_t([1.0, 0.0]), None, _t(10.0))
    _, sj = jax.jit(lambda u: JFlow(osc_j, **kw).solve_stats(
        u, None, jnp.asarray(10.0)))(jnp.array([1.0, 0.0]))
    assert bool(stats["reached"])
    assert 5 < int(stats["n_accepted"]) < 512
    assert abs(float(stats["t_final"]) - 10.0) < 1e-9
    assert int(stats["n_accepted"]) == int(sj["n_accepted"])
    assert int(stats["n_rejected"]) == int(sj["n_rejected"])


def test_adaptive_stiff_rodas3_and_fixed_rodas3():
    """Adaptive rodas3 on the stiff Van der Pol (`test_adaptive_flow.py:
    56-75`) and fixed-step rodas3's order, L-stability and monodromy
    (`test_periodic_orbits.py:211-237`), against the JAX package's."""
    mu = 50.0

    def vdp(u, p):
        return torch.stack([u[1], mu * ((1 - u[0] ** 2) * u[1]) - u[0]])

    def vdp_jv(u, p):
        # the closed-form J.v spares rodas3 a forward-AD jacobian per step
        return lambda v: torch.stack(
            [v[..., 1], (-2 * mu * u[0] * u[1] - 1) * v[..., 0]
             + mu * (1 - u[0] ** 2) * v[..., 1]], -1)

    def vdp_j(u, p):
        return jnp.array([u[1], mu * ((1 - u[0] ** 2) * u[1]) - u[0]])

    kw = dict(adaptive=True, rtol=1e-5, atol=1e-8, method="rodas3",
              max_steps=400)
    out, stats = Flow(vdp, jac_op=vdp_jv, **kw).solve_stats(
        _t([2.0, 0.0]), None, _t(5.0))
    assert bool(stats["reached"]) and bool(torch.isfinite(out).all())
    outj = jax.jit(lambda u: JFlow(vdp_j, **kw)(u, None, 5.0))(
        jnp.array([2.0, 0.0]))
    np.testing.assert_allclose(_host(out), np.asarray(outj), atol=1e-9)
    ref = jax.jit(lambda u: JFlow(vdp_j, steps=200000, method="rk4")(
        u, None, 5.0))(jnp.array([2.0, 0.0]))
    assert float(np.linalg.norm(_host(out) - np.asarray(ref))) < 1e-2

    def F(u, p):
        r2 = u[..., 0] ** 2 + u[..., 1] ** 2
        return torch.stack([u[..., 0] - u[..., 1] - u[..., 0] * r2,
                            u[..., 0] + u[..., 1] - u[..., 1] * r2], -1)

    def F_jv(u, p):
        x, y = u[..., 0], u[..., 1]
        r2 = x * x + y * y
        return lambda v: torch.stack(
            [(1 - r2 - 2 * x * x) * v[..., 0] - (1 + 2 * x * y) * v[..., 1],
             (1 - 2 * x * y) * v[..., 0] + (1 - r2 - 2 * y * y) * v[..., 1]],
            -1)

    def F_d2(u, p, a, b):
        x, y = u[..., 0], u[..., 1]
        ax, ay, bx, by = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
        ab = 2 * (ax * bx + ay * by)
        return -torch.stack(
            [2 * ax * (x * bx + y * by) + 2 * bx * (x * ax + y * ay)
             + x * ab,
             2 * ay * (x * bx + y * by) + 2 * by * (x * ax + y * ay)
             + y * ab], -1)

    def F_j(u, p):
        r2 = u[0] * u[0] + u[1] * u[1]
        return jnp.array([u[0] - u[1] - u[0] * r2, u[0] + u[1] - u[1] * r2])

    u0 = np.array([0.3, 0.1])
    ref = np.asarray(jax.jit(lambda u: JFlow(F_j, steps=20000)(
        u, None, 5.0))(u0))
    e = []
    for steps in (200, 400):
        o = Flow(F, steps=steps, method="rodas3", jac_op=F_jv,
                 batched=True)(_t(u0), None, 5.0)
        oj = jax.jit(lambda u: JFlow(F_j, steps=steps, method="rodas3")(
            u, None, 5.0))(u0)
        np.testing.assert_allclose(_host(o), np.asarray(oj), atol=1e-10)
        e.append(float(np.linalg.norm(_host(o) - ref)))
    assert e[0] < 2e-6 and e[0] / e[1] > 5.0          # -> 8 for order 3
    stiff = Flow(lambda u, p: -1e6 * u, steps=100, method="rodas3")(
        _t([1.0]), None, 1.0)
    assert abs(float(stiff[0])) < 1e-12
    M = Flow(F, steps=60, method="rodas3", jac_op=F_jv, d2F=F_d2,
             batched=True).monodromy(_t(u0), None, 2.0)
    Mj = jax.jit(lambda u: JFlow(F_j, steps=60, method="rodas3").monodromy(
        u, None, 2.0))(u0)
    np.testing.assert_allclose(_host(M), np.asarray(Mj), atol=1e-12)
    Mref = jax.jit(lambda u: JFlow(F_j, steps=5000).monodromy(
        u, None, 2.0))(u0)
    assert float(np.abs(_host(M) - np.asarray(Mref)).max()) < 1e-4


def test_adaptive_monodromy_and_dphi_dT():
    """The derivative through the adaptive loop (`test_adaptive_flow.py:
    78-93`): the monodromy of the oscillator is the rotation by T and
    dphi/dT = F(phi(T)); the variational route (the model's J.v) against
    the JAX package's jacfwd."""
    T = 3.0
    kw = dict(adaptive=True, rtol=1e-8, atol=1e-11, max_steps=512)
    fl = Flow(osc, jac_op=osc_jv, batched=True, **kw)
    u0 = _t([1.0, 0.0])
    M = fl.monodromy(u0, None, _t(T))
    R = np.array([[np.cos(T), np.sin(T)], [-np.sin(T), np.cos(T)]])
    np.testing.assert_allclose(_host(M), R, atol=1e-6)
    Mj = jax.jit(lambda u: JFlow(osc_j, **kw).monodromy(u, None, T))(
        jnp.array([1.0, 0.0]))
    np.testing.assert_allclose(_host(M), np.asarray(Mj), atol=1e-9)
    phi, g = fl.jvp(u0, None, _t(T), torch.zeros((1, 2), dtype=DT),
                    _t([1.0]))
    np.testing.assert_allclose(_host(g[0]), _host(osc(phi, None)), atol=1e-6)
    gj = jax.jit(jax.jacfwd(lambda t: JFlow(osc_j, **kw)(
        jnp.array([1.0, 0.0]), None, t)))(jnp.asarray(T))
    np.testing.assert_allclose(_host(g[0]), np.asarray(gj), atol=1e-9)
