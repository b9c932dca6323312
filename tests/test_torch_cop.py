"""Parity of the port's condensation of parameters (`periodic/cop.py`) and
collocation Floquet solvers (`FloquetColl`, `FloquetGEV`) with the JAX
package's, on the Stuart-Landau orbit (exact limit cycle |z| = sqrt(r),
omega = mu - nu r) and on orbits with planted Floquet multipliers
(mirrors `test_cop.py`).  Both packages get the same orbit; the JAX side
runs under `jax.jit`.

Tolerances, and why:
* blocks against the JAX package's and the port's COP matvec against the
  AD jacobian of the residual: 1e-12 (the same arithmetic);
* `cop_solve`, the bordered single pass and Newton iterates against the
  JAX package's: 1e-10 (pivoted LUs of the same blocks); against a dense
  solve of the AD jacobian: 1e-7 (as the JAX test) and, on the strongly
  unstable orbit, 1e-9 relative;
* the mixed-precision solves against the f64 ones: 1e-8 (f32
  factorization refined in f64, as the JAX test);
* Floquet exponents against the JAX package's: 1e-9 (f64 reductions of
  the same maps); against the planted ones: 2e-3 (the JAX test's); the
  f32 reduction against the f64 one: 1e-4 on exponents > -10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu.core.problem import (
    BifurcationProblem as JBifurcationProblem)
from bifurcationkit.jl_tpu.periodic import cop as jcop
from bifurcationkit.jl_tpu.periodic.orbits import (
    periodic_orbit_problem as jpop)
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch.continuation.engine import ContIterable
from bifurcationkit.jl_tpu_torch.linalg.bordered import _default_dotp
from bifurcationkit.jl_tpu_torch.periodic import cop as tcop

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


def orbit(t, extra=0):
    s = np.sign(OMEGA)
    return np.concatenate([[RADIUS * np.cos(s * t), RADIUS * np.sin(s * t)],
                           np.zeros(extra)])


def _sl(pkg, Ntst=12, m=3):
    kw = {} if pkg is bj else {"device": "cpu"}
    prob = pkg.models.stuart_landau(r=R0, mu=MU, nu=NU, c3=1.0, c5=0.0, **kw)
    disc = pkg.Collocation(Ntst=Ntst, m=m)
    X0 = disc.generate_solution(orbit, PERIOD, 2, **kw)
    pop = jpop if pkg is bj else bt.periodic_orbit_problem
    return prob, disc, X0, pop(prob, disc, X0)


def _planted(pkg, lams, Ntst, m=4):
    """Stuart-Landau extended by decoupled modes w' = lam w: Floquet
    multipliers exp(lam T) beside 1 and exp(-2 r T)."""
    xp = jnp if pkg is bj else torch
    k = len(lams)

    def F(u, par):
        x, y = u[0], u[1]
        r, mu, nu = par["r"], par["mu"], par["nu"]
        a = x * x + y * y
        rows = [r * x - mu * y - (x - nu * y) * a,
                mu * x + r * y - (y + nu * x) * a]
        rows += [lam * u[2 + i] for i, lam in enumerate(lams)]
        return xp.stack(rows)

    par = {"r": R0, "mu": MU, "nu": NU}
    if pkg is bj:
        prob = JBifurcationProblem(F, u0=jnp.zeros(2 + k), params=par,
                                   lens="r")
        kw = {}
    else:
        prob = bt.BifurcationProblem(
            F, u0=torch.zeros(2 + k, dtype=DT),
            params={a: torch.tensor(v, dtype=DT) for a, v in par.items()},
            lens="r")
        kw = {"device": "cpu"}
    disc = pkg.Collocation(Ntst=Ntst, m=m)
    X0 = disc.generate_solution(lambda t: orbit(t, k), PERIOD, 2 + k, **kw)
    pop = jpop if pkg is bj else bt.periodic_orbit_problem
    return prob, disc, X0, pop(prob, disc, X0)


def _jblocks(disc, prob, X, par):
    return jax.jit(lambda X: jcop.collocation_block_jacobian(
        disc, prob, X, par))(X)


def test_blocks_solve_and_bordered_pass():
    """Blocks, matvec, `cop_solve` and the `COPBLS` single pass
    (`test_cop.py:33-57,83-113`)."""
    pj, dj, Xj, poj = _sl(bj)
    pt, dt_, Xt, pot = _sl(bt)
    bj_ = _jblocks(dj, pj, Xj, poj.params)
    bt_ = tcop.collocation_block_jacobian(dt_, pt, Xt, pot.params)
    for f in ("Aint", "B0", "cT", "phi0", "phiI"):
        np.testing.assert_allclose(_host(getattr(bt_, f)),
                                   np.asarray(getattr(bj_, f)), atol=1e-12)
    J = torch.func.jacfwd(lambda X: pot.F(X, pot.params))(Xt)
    N = Xt.shape[0]
    # the JAX tests' data: rhs from seed 1, the borders from seed 3
    rhs = torch.as_tensor(np.random.default_rng(1).standard_normal(N))
    rng = np.random.default_rng(3)
    dR, dzu, R = (torch.as_tensor(rng.standard_normal(N)) for _ in range(3))
    np.testing.assert_allclose(_host(bt_(rhs)), _host(J @ rhs), atol=1e-12)
    x = tcop.cop_solve(bt_, rhs)
    np.testing.assert_allclose(_host(x), _host(torch.linalg.solve(J, rhs)),
                               atol=1e-7)
    xj = jax.jit(jcop.cop_solve)(bj_, jnp.asarray(_host(rhs)))
    np.testing.assert_allclose(_host(x), np.asarray(xj), atol=1e-10)

    theta, dzp, rn = 0.5, 0.7, 0.3
    Aext = torch.zeros((N + 1, N + 1), dtype=DT)
    Aext[:N, :N], Aext[:N, N] = J, dR
    Aext[N, :N], Aext[N, N] = theta / N * dzu, (1 - theta) * dzp
    sol = torch.linalg.solve(Aext, torch.cat([R, torch.tensor([rn],
                                                            dtype=DT)]))
    dX, dp, cv, _ = bt.COPBLS()(bt_, dR, dzu, torch.tensor(dzp, dtype=DT),
                                R, torch.tensor(rn, dtype=DT), theta,
                                1 - theta, dotp=_default_dotp)
    assert cv
    np.testing.assert_allclose(_host(dX), _host(sol[:N]), atol=1e-7)
    assert abs(float(dp - sol[N])) < 1e-9
    dXj, dpj = jax.jit(lambda b, *a: jcop.cop_solve_bordered(
        b, *a, xi_u=theta, xi_p=1 - theta, dot_scale=1.0 / N))(
        bj_, *(jnp.asarray(a) for a in (_host(R), rn, _host(dR),
                                        _host(dzu), dzp)))
    np.testing.assert_allclose(_host(dX), np.asarray(dXj), atol=1e-10)
    assert abs(float(dp) - float(dpj)) < 1e-10

    # the mixed-precision solves against the f64 ones (`test_cop.py:272-310`)
    xm, cvm = tcop.cop_solve_mixed(bt_, rhs)
    assert cvm
    assert float(torch.linalg.vector_norm(xm - x)
                 / torch.linalg.vector_norm(x)) < 1e-8
    assert float(torch.linalg.vector_norm(rhs - bt_(xm))) < 1e-8
    dXm, dpm, cvb, _ = bt.COPBLS(low_dtype=torch.float32)(
        bt_, dR, dzu, torch.tensor(dzp, dtype=DT), R,
        torch.tensor(rn, dtype=DT), theta, 1 - theta, dotp=_default_dotp)
    assert cvb
    np.testing.assert_allclose(_host(dXm), _host(dX), atol=1e-8)
    assert abs(float(dpm - dp)) < 1e-9


def test_cop_solve_stable_on_strongly_unstable_orbit():
    """COP against the dense solve at Ntst = 100 on an orbit with a
    multiplier ~1e3 (`test_cop.py:151-165`): no unpivoted chain loses
    digits."""
    pt, dt_, Xt, pot = _planted(bt, [0.055], Ntst=100, m=3)
    blocks = tcop.collocation_block_jacobian(dt_, pt, Xt, pot.params)
    J = torch.func.jacfwd(lambda X: pot.F(X, pot.params))(Xt)
    rhs = torch.as_tensor(np.random.default_rng(7).standard_normal(
        Xt.shape[0]))
    x = tcop.cop_solve(blocks, rhs)
    x_dense = torch.linalg.solve(J, rhs)
    assert float(torch.linalg.vector_norm(x - x_dense)
                 / torch.linalg.vector_norm(x_dense)) < 1e-9


def test_floquet_coll_gev_threeway_parity():
    """FloquetColl, FloquetGEV and the dense product on multipliers ~1e3
    and ~1e-3 at once (`test_cop.py:168-268`), each against the JAX
    package's route, and FloquetColl's f32 reduction against its f64 one
    (`test_cop.py:345-363`)."""
    lams = [0.055, -0.055]
    pj, dj, Xj, poj = _planted(bj, lams, Ntst=60)
    pt, dt_, Xt, pot = _planted(bt, lams, Ntst=60)
    exact = np.sort([lams[0] * PERIOD, 0.0, lams[1] * PERIOD,
                     -2 * R0 * PERIOD])[::-1]
    bt_ = tcop.collocation_block_jacobian(dt_, pt, Xt, pot.params)
    ec, _, cv, _ = bt.FloquetColl()(bt_, 4)
    got_c = np.sort(_host(ec).real)[::-1]
    bj_ = _jblocks(dj, pj, Xj, poj.params)
    P, logs = jax.jit(bj.FloquetColl().device_reduce)(bj_)
    ecj = bj.FloquetColl().host_eig(np.asarray(P), np.asarray(logs), 4)[0]
    np.testing.assert_allclose(_host(ec)[:3], ecj[:3], atol=1e-9)

    maps = dt_.interval_maps(pt, Xt, pot.params)
    mapsj = jax.jit(lambda X: dj.interval_maps(pj, X, poj.params))(Xj)
    np.testing.assert_allclose(_host(maps), np.asarray(mapsj), atol=1e-12)
    eg, _, _, _ = bt.FloquetGEV()(maps, 4)
    got_g = np.sort(_host(eg).real)[::-1]
    egj = np.asarray(bj.FloquetGEV()(mapsj, 4)[0])
    np.testing.assert_allclose(_host(eg)[:3], egj[:3], atol=1e-9)

    np.testing.assert_allclose(got_c[:3], exact[:3], atol=2e-3)
    np.testing.assert_allclose(got_g[:3], exact[:3], atol=2e-3)
    np.testing.assert_allclose(got_c[:3], got_g[:3], atol=2e-3)
    assert got_c[3] < -30.0 and got_g[3] < -30.0
    # the dense product: the leading exponents, a degraded but sane third
    got_q = np.sort(np.log(np.abs(np.linalg.eigvals(
        _host(bt.monodromy_from_maps(maps))))))[::-1]
    np.testing.assert_allclose(got_q[:2], exact[:2], atol=2e-3)
    assert abs(got_q[2] - exact[2]) < 0.5

    # f32 stage 1 and product, f64 host eig
    e64 = bt.FloquetColl().host_eig(*bt.FloquetColl().device_reduce(bt_),
                                    2)[0]
    f32 = bt.FloquetColl(low_dtype=torch.float32)
    e32 = f32.host_eig(*f32.device_reduce(bt_), 2)[0]
    win = np.real(e64) > -10
    assert win.any() and np.max(np.abs(e64[win] - e32[win])) < 1e-4


def test_newton_and_continuation_with_cop():
    """Newton on COPLS (`test_cop.py:60-80`) and PALC on COPLS/COPBLS
    with FloquetColl's two-stage eig, in f64 and in mixed precision
    (`test_cop.py:313-342`), against the JAX package's."""
    out = {}
    for pkg in (bj, bt):
        prob, disc, _, _ = _sl(pkg)
        kw = {} if pkg is bj else {"device": "cpu"}
        X0 = disc.generate_solution(lambda t: 1.1 * orbit(t),
                                    PERIOD * 1.05, 2, **kw)
        pop = jpop if pkg is bj else bt.periodic_orbit_problem
        po = pop(prob, disc, X0, use_cop=True, floquet="coll")
        sol = pkg.newton(po, pkg.NewtonPar(tol=1e-10, max_iterations=25,
                                           linsolver=pkg.COPLS()))
        assert bool(sol.converged)
        out[pkg] = (sol, po)
    (solj, _), (solt, pot) = out[bj], out[bt]
    assert solt.itnewton == int(solj.itnewton)
    np.testing.assert_allclose(_host(solt.u), np.asarray(solj.u), atol=1e-10)
    assert float(solt.u[-1]) == pytest.approx(PERIOD, rel=1e-6)

    cp = bt.ContinuationPar(
        ds=0.01, dsmax=0.03, dsmin=1e-5, p_min=0.05, p_max=0.6,
        max_steps=12, detect_bifurcation=1, detect_fold=False, nev=2,
        newton_options=bt.NewtonPar(tol=1e-9, max_iterations=20,
                                    eigsolver=bt.FloquetColl()))

    def run(lo, steps=4):
        cpx = cp.replace(newton_options=cp.newton_options.replace(
            linsolver=bt.COPLS(low_dtype=lo)))
        it = ContIterable(pot, bt.PALC(bls=bt.COPBLS(low_dtype=lo)), cpx,
                          kind="PeriodicOrbitCont")
        state = it.init_state(x0=solt.u)
        ps, eigs = [], []
        for _ in range(steps):
            it.iterate(state)
            assert state.converged
            ps.append(float(state.p))
            eigs.append(state.eigvals)
        return np.asarray(ps), eigs

    p64, eigs = run(None)
    pmx, _ = run(torch.float32)
    np.testing.assert_allclose(pmx, p64, atol=1e-8)
    # the steps against the JAX package's, and the engine's two-stage eig
    # (FloquetColl): the trivial exponent and a strongly stable one (its
    # exact -2 r T ~ -125 lies below what the f64 product resolves,
    # Floquet.jl:28-31) against the JAX package's
    brj = bj.continuation_po(
        bj.models.stuart_landau(r=R0, mu=MU, nu=NU, c3=1.0, c5=0.0),
        bj.Collocation(Ntst=12, m=3), solj.u,
        bj.ContinuationPar(ds=0.01, dsmax=0.03, dsmin=1e-5, p_min=0.05,
                           p_max=0.6, max_steps=4, detect_bifurcation=1,
                           detect_fold=False, nev=2,
                           newton_options=bj.NewtonPar(
                               tol=1e-9, max_iterations=20,
                               eigsolver=bj.FloquetColl())),
        use_cop=True)
    np.testing.assert_allclose(p64, np.asarray(brj.gamma.param)[1:5],
                               atol=1e-8)
    for e, ej in zip(eigs, brj.gamma.eig[1:5]):
        ej = np.asarray(ej["eigenvals"])
        assert abs(e[0]) < 1e-6 and e[1].real < -30.0
        assert abs(e[0] - ej[0]) < 1e-9
