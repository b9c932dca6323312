"""Parity of the port's continuation paths beyond the flagship's — the
`Bordered` tangent, `Natural` stepping, the dense `DenseLS` / `DenseEig`
route, Newton's line search — and of the other bordered solvers, on a
small dense problem written identically for both packages: the 1-D Bratu
problem  u'' + lam * exp(u) = 0,  u(0) = u(1) = 0, on n interior points,
whose branch folds at lam ~ 3.5 (one eigenvalue crosses zero there).

Tolerances, and why: `p` per step 1e-8 absolute and special points 1e-6 —
both packages run the same f64 dense LU solves, whose results agree to
rounding; `n_unstable` equal (LAPACK eigenvalues, none near zero at the
recorded points); bordered solves 1e-10 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu.linalg.bordered import (
    solve_bls_block as j_solve_bls_block)
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch.linalg.bordered import (
    solve_bls_block as t_solve_bls_block)

N = 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bratu(pkg, xp, concat):
    h2 = (1.0 / (N + 1)) ** 2

    def F(u, par):
        z = xp.zeros_like(u[:1])
        up = concat([z, u, z])
        return (up[:-2] - 2 * up[1:-1] + up[2:]) / h2 + par["lam"] * xp.exp(u)

    return F


def _problems():
    Fj = _bratu(bj, jnp, jnp.concatenate)
    Ft = _bratu(bt, torch, torch.cat)
    pj = bj.BifurcationProblem(Fj, u0=jnp.zeros(N), params={"lam": 0.5},
                               lens="lam")
    u0, par = interop.state_from_numpy(np.zeros(N), {"lam": 0.5}, "cpu")
    pt = bt.BifurcationProblem(Ft, u0=u0, params=par, lens="lam")
    return pj, pt


def _cp(pkg, max_steps):
    return pkg.ContinuationPar(
        ds=0.2, dsmax=0.4, dsmin=1e-5, p_min=0.0, p_max=3.6,
        max_steps=max_steps, nev=N, detect_bifurcation=3,
        newton_options=pkg.NewtonPar(tol=1e-11, max_iterations=20))


@pytest.mark.parametrize("alg", ["palc_bordered", "natural"])
def test_branch(alg):
    pj, pt = _problems()
    make = {"palc_bordered": lambda pkg: pkg.PALC(tangent=pkg.Bordered()),
            "natural": lambda pkg: pkg.Natural()}[alg]
    steps = 20 if alg == "palc_bordered" else 12
    j = interop.branch_to_numpy(bj.continuation(pj, make(bj), _cp(bj, steps)))
    t = interop.branch_to_numpy(bt.continuation(pt, make(bt), _cp(bt, steps)))
    assert len(t["p"]) == len(j["p"])
    np.testing.assert_allclose(t["p"], j["p"], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(t["n_unstable"], j["n_unstable"])
    assert list(t["sp_type"]) == list(j["sp_type"])
    np.testing.assert_allclose(t["sp_p"], j["sp_p"], rtol=0, atol=1e-6)
    if alg == "palc_bordered":      # the branch turns at the fold
        assert "fold" in list(t["sp_type"])


def test_newton_line_search():
    pj, pt = _problems()
    opts = dict(tol=1e-12, max_iterations=30, linesearch=True)
    guess = np.full(N, 4.0)
    par = {"lam": 3.0}
    sj = bj.newton(pj, bj.NewtonPar(**opts), x0=jnp.asarray(guess),
                   params=par)
    ut, part = interop.state_from_numpy(guess, par, "cpu")
    st = bt.newton(pt, bt.NewtonPar(**opts), x0=ut, params=part)
    assert st.converged == bool(sj.converged)
    assert st.itnewton == int(sj.itnewton)
    np.testing.assert_allclose(st.u.numpy(), np.asarray(sj.u), rtol=1e-10,
                               atol=1e-12)


def test_bordered_solver_variants():
    rng = np.random.default_rng(5)
    n = 15
    A = 3 * np.eye(n) + rng.standard_normal((n, n)) / np.sqrt(n)
    dR, dzu, R = (rng.standard_normal(n) for _ in range(3))
    args = (0.7, R, 0.2, 0.4, 0.6)     # dzp, R, n, xi_u, xi_p
    to_j = [jnp.asarray(x) for x in (A, dR, dzu)]
    to_t = [torch.as_tensor(x) for x in (A, dR, dzu)]
    for Sj, St in ((bj.MatrixBLS(), bt.MatrixBLS()),
                   (bj.BorderingBLS(), bt.BorderingBLS()),
                   (bj.MatrixFreeBLS(), bt.MatrixFreeBLS())):
        xj, lj, _, _ = jax.jit(lambda A, dR, dzu, R, S=Sj: S(
            A, dR, dzu, args[0], R, *args[2:]))(*to_j, jnp.asarray(R))
        xt, lt, cv, _ = St(*to_t, args[0], torch.as_tensor(R), *args[2:])
        assert bool(cv)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10,
                                   atol=1e-12)
        assert abs(float(lt) - float(lj)) < 1e-10 * max(1.0, abs(float(lj)))

    # k-border block elimination and a bordered solver as a plain solver
    C, D = rng.standard_normal((n, 2)), rng.standard_normal((2, n))
    E, s = rng.standard_normal((2, 2)), rng.standard_normal(2)
    xj, yj, _, _ = jax.jit(lambda *a: j_solve_bls_block(bj.DenseLS(), *a))(
        *(jnp.asarray(a) for a in (A, C, D, E, R, s)))
    xt, yt, _, _ = t_solve_bls_block(bt.DenseLS(), *(torch.as_tensor(a) for a
                                                     in (A, C, D, E, R, s)))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-10)
    B = rng.standard_normal((n + 1, n + 1)) + 4 * np.eye(n + 1)
    b = rng.standard_normal(n + 1)
    zj, _, _ = jax.jit(bj.LSFromBLS().__call__)(jnp.asarray(B),
                                                 jnp.asarray(b))
    zt, _, _ = bt.LSFromBLS()(torch.as_tensor(B), torch.as_tensor(b))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-10)
    np.testing.assert_allclose(zt.numpy(), np.linalg.solve(B, b), rtol=1e-10)


def test_dense_eig():
    rng = np.random.default_rng(6)
    A = rng.standard_normal((9, 9))
    wj, vj, _, _ = bj.DenseEig()(jnp.asarray(A), 4)
    wt, vt, _, _ = bt.DenseEig()(torch.as_tensor(A), 4)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-12)
    with pytest.raises(TypeError):
        bt.DenseEig()(lambda v: v, 2)


def test_failed_corrector_eigensolves_the_accepted_point():
    """A PALC step whose corrector fails returns the old point and tangent,
    and — as the JAX package's fused step does — the eigenvalues of that
    point and a seed refreshed from its Ritz directions.  Arnoldi on the
    full space (krylov_dim = N) from the same numpy v0 in both packages:
    eigenvalues to 1e-10 relative, the seed to 1e-8 relative (a sum of
    unit Ritz vectors from the same Hessenberg matrix)."""
    from bifurcationkit.jl_tpu.continuation.kernels import (
        make_kernels as j_make_kernels)
    from bifurcationkit.jl_tpu.core.state import BorderedState as JBS
    from bifurcationkit.jl_tpu_torch.continuation.kernels import (
        make_kernels as t_make_kernels)

    pj, pt = _problems()
    rng = np.random.default_rng(8)
    u = 0.3 * np.sin(np.pi * np.arange(1, N + 1) / (N + 1))
    v0 = rng.standard_normal(N)

    def cp(pkg):
        # one Newton iteration cannot reach 1e-13 from a far predictor
        return pkg.ContinuationPar(
            ds=0.5, dsmax=1.0, p_min=0.0, p_max=3.6, nev=4,
            newton_options=pkg.NewtonPar(
                tol=1e-13, max_iterations=1,
                eigsolver=pkg.ArnoldiEig(krylov_dim=N, restarts=1)))

    kj = j_make_kernels(pj, bj.PALC(), cp(bj))
    zj = JBS(u=jnp.asarray(u), p=jnp.asarray(0.5))
    tj = JBS(u=jnp.zeros(N), p=jnp.asarray(1.0))
    (zaj, taj, cvj, _, _, _, wj, _, _, seed_j) = kj.palc_full_step(
        zj, tj, 0.5, pj.params, jnp.asarray(v0))

    kt = t_make_kernels(pt, bt.PALC(), cp(bt))
    ut, part = interop.state_from_numpy(u, {"lam": 0.5}, "cpu")
    zt = bt.BorderedState(u=ut, p=part["lam"])
    tt = bt.BorderedState(u=torch.zeros(N, dtype=torch.float64),
                          p=torch.tensor(1.0, dtype=torch.float64))
    (zat, tat, cvt, _, _, _, wt, _, _, seed_t) = kt.palc_step(
        zt, tt, 0.5, part, eig_seed=torch.as_tensor(v0))

    assert not cvt and not bool(cvj)
    assert zat is zt and tat is tt
    np.testing.assert_array_equal(np.asarray(zaj.u), u)
    assert wt is not None, "no eigensolve after the failed corrector"
    assert np.abs(wt - np.asarray(wj)).max() < 1e-10 * np.abs(wj).max()
    # the eigenvalues are those of the accepted (old) point
    J = jax.jacfwd(lambda x: pj.F(x, {"lam": 0.5}))(jnp.asarray(u))
    lam = np.sort(np.linalg.eigvals(np.asarray(J)).real)[::-1][:4]
    assert np.abs(wt.real - lam).max() < 1e-10 * np.abs(lam).max()
    seed_j, seed_t = np.asarray(seed_j), seed_t.numpy()
    assert np.abs(seed_t - seed_j).max() < 1e-8 * np.abs(seed_j).max()
    assert np.abs(seed_t - v0).max() > 1e-3      # refreshed, not passed on
