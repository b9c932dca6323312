"""The reference's cGL2d Hopf-curve leg (`jacobian_ma = MinAug()` in
(r, gamma), ref examples/cGL2d.jl:115-127; mirrors
`test_minaug_mf.py::test_hopf_mf_cgl2d_curve`) through the port's
matrix-free minimally augmented code, from the exact Hopf point of the
trivial state (r* = -lambda_1(Delta), omega = nu) with the DST-I spectral
preconditioner and BT/GH monitoring.

From a point of the curve, `continuation_from_hopf_point` switches to
the periodic orbits there (a Trapeze branch of 2 steps in gamma).

Tolerances, and why: the curve's start at (r*, omega = nu) to 1e-8;
sigma with fresh borders below 1e-3 on the curve and below 1e-2 of its
value 0.2 off it in omega (the JAX test's bounds); the JAX package's
minimally augmented functional at the port's last point below 1e-6 (the
curve's Newton tolerance is 1e-8), and it, one Govaerts product and dFdp
to 1e-9 of the port's relative to the largest entry (or 1e-3 where all
are smaller; the bordered solves converge to rtol 1e-12); the switched
branch's omega equal to the curve's to 1e-9 and its period within 5 % of
2 pi / omega.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch.codim2.minaug_mf import (
    ext_precond2, solve_bordered_ext_cplx)
from bifurcationkit.jl_tpu_torch.core.state import ravel

DT = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _r_star(Nx, Ny):
    hx, hy = 2 * np.pi / Nx, np.pi / Ny
    return -(2 * (np.cos(np.pi / (Nx + 1)) - 1) / hx ** 2
             + 2 * (np.cos(np.pi / (Ny + 1)) - 1) / hy ** 2)


NX_C, NY_C = 9, 5           # the JAX test continues at 21x11 (ref grid)


def test_hopf_mf_cgl2d_curve():
    """`test_minaug_mf.py:228`: the matrix-free Hopf curve in (r, gamma)
    from the exact Hopf point with the DST-I preconditioner, at 9x5 and 4
    steps, checked by sigma with fresh random complex borders.  The JAX
    package's matrix-free curve compiles for about 25 s on the CPU, so it
    is not run: its minimally augmented functional is evaluated at the
    port's last point instead, with the same fresh borders, where it must
    vanish and equal the port's, with one Govaerts product and dFdp."""
    from bifurcationkit.jl_tpu.codim2.minaug_mf import (
        hopf_ma_problem_mf as j_hopf)
    from bifurcationkit.jl_tpu_torch.codim2.minaug_mf import (
        hopf_ma_problem_mf as t_hopf)

    r_star = _r_star(NX_C, NY_C)
    tb = bt.models.cgl2d(Nx=NX_C, Ny=NY_C, r=0.1, c3=1.0, device="cpu")
    omega = float(tb.params["nu"])
    ls = bt.GMRES(restart=40, maxiter=400, rtol=1e-10,
                  precond=tb.spectral_precond)
    cp = bt.ContinuationPar(ds=0.02, dsmax=0.05, dsmin=1e-6, p_min=-2.0,
                            p_max=2.0, max_steps=4, detect_bifurcation=0,
                            detect_fold=False, save_sol_every_step=1,
                            newton_options=bt.NewtonPar(
                                tol=1e-8, max_iterations=20, linsolver=ls))
    sp = bt.SpecialPoint(type="hopf", param=r_star, ind_ev=1,
                         x=torch.zeros((2, NX_C, NY_C), dtype=DT),
                         eigenvals=np.array([1j * omega]))
    brh = bt.continuation_hopf(bt.ContResult(prob=tb, specialpoint=[sp]), 0,
                               "gamma", cp, detect_codim2_bifurcation=2,
                               jacobian_ma="minaug")
    got = interop.codim2_branch_to_numpy(brh)
    assert len(got["param"]) == 5
    assert np.all(got["omega"] > 0)
    assert got["p1"][0] == pytest.approx(r_star, abs=1e-8)
    assert got["omega"][0] == pytest.approx(omega, abs=1e-8)

    maprob = brh.gamma.prob
    n = maprob.n_inner
    inner = maprob.inner_prob
    rng = np.random.default_rng(11)
    b = {k: rng.standard_normal(n) for k in ("_ar", "_ai")}
    nrm = np.sqrt(b["_ar"] @ b["_ar"] + b["_ai"] @ b["_ai"])
    ar, ai = (torch.as_tensor(b[k] / nrm) for k in ("_ar", "_ai"))
    gm2 = bt.GMRES(restart=40, maxiter=400, rtol=1e-8, atol=1e-12,
                   precond=ext_precond2(tb.spectral_precond, n))

    def sigma_at(X, p2, p1, om):
        params = maprob.inner_lens.set(
            maprob.outer_lens.set(inner.params, p2), p1)
        xs = maprob.unravel_inner(X[:n])

        def Jd(d):
            return ravel(inner.dF(xs, params, maprob.unravel_inner(d)))[0]

        _, _, sr, si, cv = solve_bordered_ext_cplx(Jd, -om, ar, ai, ar, ai,
                                                   gm2)
        assert bool(cv)
        return float(np.hypot(float(sr), float(si)))

    for k in (1, len(got["param"]) - 1):
        X = ravel(brh.gamma.sol[k]["x"])[0]
        p2, p1, om = (float(got[key][k]) for key in ("param", "p1", "omega"))
        on = sigma_at(X, p2, p1, om)
        off = sigma_at(X, p2, p1, om + 0.2)
        assert on < 1e-3, f"step {k}: |sigma| = {on}"
        assert on < 1e-2 * off, f"step {k}: on {on} vs off {off}"

    # branch switching from a point of the curve to its periodic orbits
    # (`continuation_from_hopf_point`: the MF normal form there, with the
    # curve's preconditioner, and a Trapeze branch in gamma)
    k = 2
    disc = bt.Trapeze(M=11)
    T_k = 2 * np.pi / float(got["omega"][k])
    pre = disc.spectral_precond(n, *tb.po_spectral_data(float(got["p1"][k])),
                                T_k, device="cpu")
    cpo = bt.ContinuationPar(
        ds=0.01, dsmax=0.01, p_min=-2.0, p_max=2.0, max_steps=2,
        detect_bifurcation=0, save_sol_every_step=1,
        newton_options=bt.NewtonPar(tol=1e-8, max_iterations=20,
                                    linsolver=bt.GMRES(restart=40,
                                                       maxiter=400,
                                                       rtol=1e-10,
                                                       precond=pre)))
    brpo = bt.continuation_from_hopf_point(brh, k, cpo, disc=disc,
                                           delta_p=0.01)
    assert len(brpo) == 3
    assert brpo.bp.omega == pytest.approx(float(got["omega"][k]), abs=1e-9)
    assert np.all(np.abs(np.asarray(brpo.gamma["period"]) / T_k - 1) < 0.05)
    traj, T, p = bt.orbit_from_branch(brpo)
    assert traj.shape == (11, n) and T == pytest.approx(
        float(brpo.gamma["period"][-1])) and p == float(brpo.param[-1])
    assert bt.get_periodic_orbit(brpo, 0)["u"].shape == (11, n)

    # the JAX package's functional at the port's last point
    X = ravel(brh.gamma.sol[-1]["x"])[0].numpy()
    p2 = float(got["param"][-1])
    borders = {"_ar": ar.numpy(), "_ai": ai.numpy(), "_br": ar.numpy(),
               "_bi": ai.numpy()}
    d = rng.standard_normal(n + 2)
    gm = dict(restart=n + 2, maxiter=4 * (n + 2), rtol=1e-12, atol=1e-14)
    out = {}
    jb = bj.models.cgl2d(Nx=NX_C, Ny=NY_C, r=0.1, c3=1.0)
    for pkg, make, prob in ((bj, j_hopf, jb), (bt, t_hopf, tb)):
        mp = make(prob, prob.lens, "gamma", gmres_opts=gm)
        par = dict(mp.params)
        arr = (jnp.asarray if pkg is bj
               else (lambda a: torch.as_tensor(a, dtype=DT)))
        par.update({k: arr(v) for k, v in borders.items()})
        par = mp.set_lens_param(par, p2)

        def apply(Xa, par, da, mp=mp):
            return mp.F(Xa, par), mp.jac_op(Xa, par)(da), mp.dFdp(Xa, par)

        if pkg is bj:
            apply = jax.jit(apply)
        out[pkg] = [np.asarray(o) if pkg is bj else o.numpy()
                    for o in apply(arr(X), par, arr(d))]
    assert np.abs(out[bj][0]).max() < 1e-6          # on the JAX curve too
    for t, j in zip(out[bt], out[bj]):
        assert np.abs(t - j).max() <= 1e-9 * max(np.abs(j).max(), 1e-3)
