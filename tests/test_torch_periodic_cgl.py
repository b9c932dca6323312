"""Parity of the port's trapezoid periodic-orbit pieces on a cGL2d orbit
at 9x5 with M = 11 slices (`models.cgl2d`, `periodic/trapezoid.py`,
`floquet.py`): the trapezoid residual, the f32 space-time and slice
spectral preconditioners, the dense monodromy, the matrix-free monodromy
on a block (a batched GMRES solve per slice) and `FloquetQaDMF` over
`SubspaceEig`.  Both packages get the same orbit guess and parameters.

Tolerances, and why:
* the residual and the dense monodromy: 1e-12 and 1e-9 of the JAX
  package's (the same arithmetic up to rounding); the matrix-free
  monodromy with plain GMRES to rtol 1e-12: 1e-9 of the dense one;
* the f32 preconditioners: 2e-5 relative to the JAX package's (both run
  f32 with full-precision products; the chains differ by f32 rounding);
  the monodromy through the f32 slice preconditioner 5e-6 relative (the
  preconditioner rounds its input to f32, which bounds the solve);
* Floquet multipliers from the same start block, over that operator:
  1e-5 of the JAX package's, the leading ones within 1e-5 of the dense
  monodromy's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu.periodic.orbits import (
    periodic_orbit_problem as jpop)
from bifurcationkit.jl_tpu.periodic.trapezoid import (
    slice_spectral_precond as jslice)
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch.periodic.trapezoid import (
    slice_spectral_precond as tslice)

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


NX, NY, M = 9, 5, 11
N_VF = 2 * NX * NY


def _r_star():
    hx, hy = 2 * np.pi / NX, np.pi / NY
    return -(2 * (np.cos(np.pi / (NX + 1)) - 1) / hx ** 2
             + 2 * (np.cos(np.pi / (NY + 1)) - 1) / hy ** 2)


def _cgl_orbit_guess():
    """A smooth periodic guess around the trivial state near the Hopf
    point (the first DST mode in both components, a quarter turn apart),
    its period 2 pi / nu and r a little past r*."""
    x = np.sin(np.pi * np.arange(1, NX + 1) / (NX + 1))
    y = np.sin(np.pi * np.arange(1, NY + 1) / (NY + 1))
    mode = np.outer(x, y).ravel()

    def orbit(t):
        return 0.3 * np.concatenate([np.cos(t) * mode, np.sin(t) * mode])

    return orbit, 2 * np.pi


@pytest.fixture(scope="module")
def cgl_both():
    orbit, T0 = _cgl_orbit_guess()
    r0 = _r_star()
    out = {}
    for pkg, kw in ((bj, {}), (bt, {"device": "cpu"})):
        base = pkg.models.cgl2d(Nx=NX, Ny=NY, r=0.1, c3=1.0, **kw)
        disc = pkg.Trapeze(M=M)
        X0 = disc.generate_solution(orbit, T0, N_VF, **kw)
        params = base.set_lens_param(base.params, r0 + 0.02)
        pop = jpop if pkg is bj else bt.periodic_orbit_problem
        po = pop(base, disc, X0, params=params)
        blocks, to_m, from_m = base.po_spectral_data(r0)
        out[pkg] = dict(base=base, disc=disc, X0=X0, po=po,
                        spec=(blocks, to_m, from_m), T0=T0, kw=kw)
    return out


def test_cgl_residual_and_spectral_precond(cgl_both):
    """The residual, the space-time preconditioner and the slice
    preconditioner (both f32) on the same vectors."""
    j, t = cgl_both[bj], cgl_both[bt]
    np.testing.assert_allclose(_host(t["po"].F(t["X0"], t["po"].params)),
                               np.asarray(j["po"].F(j["X0"], j["po"].params)),
                               rtol=0, atol=1e-12)
    v = np.random.default_rng(1).standard_normal(M * N_VF + 1)
    pj = j["disc"].spectral_precond(N_VF, *j["spec"], j["T0"])
    pt = t["disc"].spectral_precond(N_VF, *t["spec"], t["T0"], device="cpu")
    oj = np.asarray(jax.jit(pj)(jnp.asarray(v)))
    ot = _host(pt(torch.as_tensor(v, dtype=DT)))
    assert ot.dtype == np.float64
    assert np.abs(ot - oj).max() <= 2e-5 * np.abs(oj).max()
    assert ot[-1] == v[-1]
    c0 = t["T0"] / (M - 1) / 2.0
    w = np.random.default_rng(2).standard_normal((3, N_VF))
    sj = jslice(*j["spec"], c0)
    st = tslice(*t["spec"], c0, device="cpu")
    oj = np.stack([np.asarray(sj(jnp.asarray(r))) for r in w])
    ot = _host(st(torch.as_tensor(w, dtype=DT)))
    assert np.abs(ot - oj).max() <= 2e-5 * np.abs(oj).max()


def test_cgl_mf_monodromy_and_subspace_floquet(cgl_both):
    """The dense monodromy against the JAX package's; the matrix-free one
    on a block (the batched GMRES in each slice) against the dense one with
    plain GMRES, and against the JAX package's operator with the f32 slice
    preconditioner; then `FloquetQaDMF(SubspaceEig)` over the
    preconditioned operator from the same start block."""
    j, t = cgl_both[bj], cgl_both[bt]
    c0 = t["T0"] / (M - 1) / 2.0
    V = np.random.default_rng(3).standard_normal((4, N_VF))
    Mt = _host(t["disc"].monodromy(t["po"].prob_vf, t["X0"],
                                   t["po"].params))
    Mj = np.asarray(jax.jit(lambda X: j["disc"].monodromy(
        j["po"].prob_vf, X, j["po"].params))(j["X0"]))
    np.testing.assert_allclose(Mt, Mj, rtol=0, atol=1e-9 * np.abs(Mj).max())
    cfg = dict(restart=20, maxiter=200, rtol=1e-12)
    opt = t["disc"].monodromy_operator(t["po"].prob_vf, t["X0"],
                                       t["po"].params,
                                       linsolver=bt.GMRES(**cfg))
    got = _host(opt.block(torch.as_tensor(V, dtype=DT)))
    ref = V @ Mt.T
    assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()
    # an f32 preconditioner rounds its input, so a preconditioned solve is
    # as accurate as f32 (the production setting asks rtol 1e-6)
    opj = j["disc"].monodromy_operator(
        j["po"].prob_vf, j["X0"], j["po"].params,
        linsolver=bj.GMRES(precond=jslice(*j["spec"], c0), **cfg))
    opt = t["disc"].monodromy_operator(
        t["po"].prob_vf, t["X0"], t["po"].params,
        linsolver=bt.GMRES(precond=tslice(*t["spec"], c0, device="cpu"),
                           **cfg))
    got = _host(opt.block(torch.as_tensor(V, dtype=DT)))
    refj = np.asarray(jax.jit(jax.vmap(opj))(jnp.asarray(V)))
    assert np.abs(got - refj).max() <= 5e-6 * np.abs(refj).max()
    assert np.abs(got - ref).max() <= 5e-6 * np.abs(ref).max()

    nev = 4
    v0 = np.random.default_rng(4).standard_normal((N_VF, nev + 4))
    eig_cfg = dict(sweeps=2, krylov_blocks=3, extra=4, tol=1e-6)
    qj = bj.FloquetQaDMF(eigsolver=bj.SubspaceEig(**eig_cfg))
    ej = np.asarray(jax.jit(lambda v: qj(opj, nev, v0=v)[0])(
        jnp.asarray(v0)))
    qt = bt.FloquetQaDMF(eigsolver=bt.SubspaceEig(**eig_cfg))
    et, vecs, cv, _ = qt(opt, nev, v0=torch.as_tensor(v0, dtype=DT))
    np.testing.assert_allclose(np.exp(_host(et)), np.exp(ej), atol=1e-5)
    dense = np.linalg.eigvals(Mt)
    for mu in np.exp(_host(et))[:2]:
        assert np.min(np.abs(dense - mu)) < 1e-5
    assert qt.seed_cols(nev) == nev + 4
    assert qt.make_seed(vecs, nev + 4).shape == (N_VF, nev + 4)
