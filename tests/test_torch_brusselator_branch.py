"""The slice as a whole: the 1D Brusselator's equilibrium branch in the
domain length `l`, with its jacobian given as a five-diagonal `DIAMatrix`
(offsets -n, -1, 0, 1, n on the stacked (u, v) state), GMRES for Newton
and PALC, and shift-invert Arnoldi stability sweeps that detect and bisect
its Hopf point — run by the JAX package and by the port from the same
numpy data, compared point by point.  Also the port's small models
(`models/equilibria.py`) against the JAX ones.

The DIA `jac_op` is user code, written once with jnp and once with torch
below: neither package's `brusselator_1d` ships a DIA jacobian.

The branch is cut to 16 sites and starts at l = 0.46, just below the Hopf
point (l ~ 0.483 at 16 sites), so a few steps pass it and stop at p_max.

Tolerances, and why:
* model residuals and jacobians: 1e-12 relative to max |JAX value| —
  the same f64 formulas (and `jacfwd` on both sides); the DIA jacobian
  equals `jacfwd`'s to 1e-12 as well;
* branch `p` and `norm` per point: 1e-8 absolute — both correctors stop
  at residual 1e-9 with GMRES at rtol 1e-11;
* `n_unstable` and special-point types: equal — counts of eigenvalues
  above 1e-10 from shift-invert Arnoldi sweeps that agree to ~1e-9, and
  the bisection never brings the Hopf pair that close to the axis;
* the Hopf point's `l`: within the bisection interval of the JAX one
  (and to 1e-8, since both bisections replay the same steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu import models as jmodels
from bifurcationkit.jl_tpu.ops import DIAMatrix as JDIA
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch import models as tmodels
from bifurcationkit.jl_tpu_torch.ops import DIAMatrix

SITES = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dia_jac_op(xp, dia, n):
    """The Brusselator jacobian as a DIA matrix, in either package."""
    h = 1.0 / n
    cat = jnp.concatenate if xp is jnp else torch.cat

    def jac_op(uv, par):
        a, b, l = par["alpha"], par["beta"], par["l"]
        c1 = par["D1"] / (l ** 2 * h ** 2)
        c2 = par["D2"] / (l ** 2 * h ** 2)
        u, v = uv[:n], uv[n:]
        zero = xp.zeros_like(u)
        # rows whose neighbour lies in the other block couple to nothing
        first = xp.ones_like(u) - (xp.arange(n) == 0) * 1.0
        last = xp.ones_like(u) - (xp.arange(n) == n - 1) * 1.0
        data = xp.stack([
            cat([zero, b - 2 * u * v]),                 # -n: dfv/du
            cat([c1 * first, c2 * first]),              # -1
            cat([-2 * c1 - (b + 1) + 2 * u * v, -2 * c2 - u * u]),
            cat([c1 * last, c2 * last]),                # +1
            cat([u * u, zero]),                         # +n: dfu/dv
        ])
        return dia(data, (-n, -1, 0, 1, n))

    return jac_op


def _small_models(pkg_models, **dev):
    return {
        "chan": pkg_models.chan(n=11, **dev),
        "carrier": pkg_models.carrier(N=20, **dev),
        "transcritical": pkg_models.transcritical_1d(p=0.3, **dev),
        "pitchfork": pkg_models.pitchfork_1d(p=0.3, **dev),
        "hopf": pkg_models.hopf_normal_2d(p=0.2, **dev),
        "brusselator": pkg_models.brusselator_1d(n=8, l=0.7, **dev),
    }


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("name", ["chan", "carrier", "transcritical",
                                  "pitchfork", "hopf", "brusselator"])
def test_small_models_match_jax(name):
    pj = _small_models(jmodels)[name]
    pt = _small_models(tmodels, device="cpu")[name]
    u0 = np.asarray(pj.u0)
    assert _rel(pt.u0.numpy(), u0) == 0
    rng = np.random.default_rng(len(name))
    u = u0 + 0.3 * rng.standard_normal(u0.shape)
    ut, part = interop.state_from_numpy(u, pj.params, "cpu")
    Fj = jax.jit(pj.F)(jnp.asarray(u), pj.params)
    assert _rel(pt.F(ut, part).numpy(), Fj) < 1e-12
    Jj = jax.jit(pj.jacobian)(jnp.asarray(u), pj.params)
    assert _rel(pt.jacobian(ut, part).numpy(), Jj) < 1e-12
    # the lens and dF/dp agree too
    assert pt.lens == pj.lens
    dj = jax.jit(pj.dFdp)(jnp.asarray(u), pj.params)
    assert _rel(pt.dFdp(ut, part).numpy(), dj) < 1e-12


def test_dia_jac_op_matches_jacfwd():
    n = 8
    pj = jmodels.brusselator_1d(n=n, l=0.7)
    pt = tmodels.brusselator_1d(n=n, l=0.7, device="cpu")
    u = np.asarray(pj.u0) * (1 + 0.1 * np.random.default_rng(2)
                             .standard_normal(2 * n))
    ut, part = interop.state_from_numpy(u, pj.params, "cpu")
    J_fwd = np.asarray(jax.jit(pj.jacobian)(jnp.asarray(u), pj.params))
    Dj = _dia_jac_op(jnp, JDIA, n)(jnp.asarray(u), pj.params)
    Dt = _dia_jac_op(torch, DIAMatrix, n)(ut, part)
    assert _rel(np.asarray(jax.jit(lambda D: D.todense())(Dj)), J_fwd) < 1e-12
    assert _rel(Dt.todense().numpy(), J_fwd) < 1e-12
    assert _rel(Dt.todense().numpy(), pt.jacobian(ut, part).numpy()) < 1e-12
    # as the problem's jac_op, on one vector and on a (K, 2n) batch
    V = np.random.default_rng(3).standard_normal((3, 2 * n))
    op = pt.re_make(jac_op=_dia_jac_op(torch, DIAMatrix, n)) \
        .jacobian_operator(ut, part)
    assert _rel(op(torch.as_tensor(V)).numpy(), V @ J_fwd.T) < 1e-12
    assert _rel(op(torch.as_tensor(V[0])).numpy(), J_fwd @ V[0]) < 1e-12


def _cont_par(pkg, n):
    ls = pkg.GMRES(restart=2 * n, maxiter=4 * n, rtol=1e-11)
    eig = pkg.ShiftInvertEig(
        sigma=0.0,
        eigsolver=pkg.ArnoldiEig(which="LM", krylov_dim=30, restarts=3,
                                 tol=1e-9),
        linsolver=pkg.GMRES(restart=2 * n, maxiter=4 * n, rtol=1e-10))
    # examples/brusselator.py:14-17, started just below the Hopf point
    return pkg.ContinuationPar(
        ds=0.01, dsmax=0.02, dsmin=1e-6, p_min=0.29, p_max=0.52,
        max_steps=10, detect_bifurcation=3, nev=8, n_inversion=4,
        newton_options=pkg.NewtonPar(tol=1e-9, linsolver=ls,
                                     eigsolver=eig))


def test_branch_matches_jax_with_hopf():
    n = SITES
    pj = jmodels.brusselator_1d(n=n, l=0.46)
    # a strongly typed u0: the JAX Newton then compiles once, not twice
    pj = pj.re_make(u0=jnp.asarray(np.asarray(pj.u0)),
                    jac_op=_dia_jac_op(jnp, JDIA, n))
    br_j = bj.continuation(pj, bj.PALC(), _cont_par(bj, n))

    pt = tmodels.brusselator_1d(n=n, l=0.46, device="cpu")
    u0, par0 = interop.state_from_numpy(np.asarray(pj.u0), pj.params, "cpu")
    pt = pt.re_make(u0=u0, params=par0,
                    jac_op=_dia_jac_op(torch, DIAMatrix, n))
    br_t = bt.continuation(pt, bt.PALC(), _cont_par(bt, n))

    j, t = interop.branch_to_numpy(br_j), interop.branch_to_numpy(br_t)
    assert len(t["p"]) == len(j["p"])
    np.testing.assert_allclose(t["p"], j["p"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(br_t["norm"], br_j["norm"], rtol=0,
                               atol=1e-8)
    np.testing.assert_array_equal(t["n_unstable"], j["n_unstable"])
    assert list(t["sp_type"]) == list(j["sp_type"])
    assert "hopf" in list(t["sp_type"])
    hj, ht = br_j.get_special_points("hopf")[0], \
        br_t.get_special_points("hopf")[0]
    assert ht.status == hj.status == "converged"
    lo, hi = hj.interval
    assert lo - 1e-12 <= ht.param <= hi + 1e-12
    assert abs(ht.param - hj.param) < 1e-8
    # the Hopf pair is complex and crosses at the located point
    assert ht.delta == hj.delta == (2, 2)
    assert t["p"][-1] == pytest.approx(0.52)
