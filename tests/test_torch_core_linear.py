"""Parity of the port's problem layer, SH2d model, spectral
preconditioner and dense Newton (`jl_tpu_torch/core`, `models/sh.py`,
`newton.py`) with the JAX package at small grids; the Krylov and bordered
solvers are in `test_torch_krylov.py`.  Inputs are made with numpy from a
seed and handed to both.

Tolerance: 1e-12 relative for the derivatives and the preconditioner —
the same f64 arithmetic in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu import models as jmodels
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch import models as tmodels
from bifurcationkit.jl_tpu_torch.models.sh import dct2, idct2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(Nx, Ny):
    """The SH2d model in both packages, on a domain cut with the grid so
    the mesh width stays the flagship's."""
    kw = dict(lx=8 * np.pi * Nx / 151, ly=4 * np.pi / np.sqrt(3) * Ny / 100)
    pj = jmodels.swift_hohenberg_2d(Nx=Nx, Ny=Ny, **kw)
    pt = tmodels.swift_hohenberg_2d(Nx=Nx, Ny=Ny, device="cpu", **kw)
    u0 = np.asarray(pj.u0)
    ut, part = interop.state_from_numpy(u0, pj.params, "cpu")
    return pj, pt, u0, ut, part


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_residual_and_derivatives():
    pj, pt, u0, ut, part = _pair(31, 20)
    rng = np.random.default_rng(0)
    v, w, z = (rng.standard_normal(u0.shape) for _ in range(3))
    vt, wt, zt = (torch.as_tensor(a) for a in (v, w, z))

    @jax.jit        # one compile instead of one per primitive
    def forms(u, v, w, z):
        par = pj.params
        return (pj.F(u, par), pj.dF(u, par, v), pj.dFdp(u, par),
                pj.d2F(u, par, v, w), pj.d3F(u, par, v, w, z),
                pj.dFt(u, par, v))

    refs = forms(*(jnp.asarray(a) for a in (u0, v, w, z)))
    gots = (pt.F(ut, part), pt.dF(ut, part, vt), pt.dFdp(ut, part),
            pt.d2F(ut, part, vt, wt), pt.d3F(ut, part, vt, wt, zt),
            pt.dFt(ut, part, vt))
    for got, ref in zip(gots, refs):
        assert _rel(got.numpy(), ref) < 1e-12
    # the jvp path of a problem without jac_op, and the dense jacobian
    bare = pt.re_make(jac_op=None)
    assert _rel(bare.dF(ut, part, vt).numpy(), refs[1]) < 1e-12
    pj8, pt8, u8, ut8, part8 = _pair(6, 5)
    assert _rel(pt8.jacobian(ut8, part8).numpy(),
                jax.jit(lambda u: pj8.jacobian(u, pj8.params))(
                    jnp.asarray(u8))) < 1e-12


def test_dct_preconditioner():
    pj, pt, u0, _, _ = _pair(31, 20)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 31, 20))
    ref = scipy.fft.dct(scipy.fft.dct(x, type=2, norm="ortho", axis=1),
                        type=2, norm="ortho", axis=2)
    got = dct2(torch.as_tensor(x))
    assert np.abs(got.numpy() - ref).max() < 1e-12 * np.abs(ref).max()
    assert np.abs(idct2(got).numpy() - x).max() < 1e-12 * np.abs(x).max()
    v = rng.standard_normal(u0.shape)
    for shift in (1.0, 0.3):
        ref = jax.jit(lambda v: pj.spectral_precond(v, shift=shift))(
            jnp.asarray(v))
        got = pt.spectral_precond(torch.as_tensor(v), shift=shift)
        assert _rel(got.numpy(), ref) < 1e-12
    # a block of flat rows (the eigensolver's layout) gives the same rows
    blk = torch.as_tensor(rng.standard_normal((4, v.size)))
    rows = torch.stack([pt.spectral_precond(r) for r in blk])
    assert _rel(pt.spectral_precond(blk).numpy(), rows.numpy()) < 1e-14


def test_newton_dense():
    """`newton` with the dense direct solver (jacfwd jacobian) on a small
    grid: same iteration count and residual history, same solution (here
    the trivial one, so compared in absolute terms)."""
    pj, pt, u0, ut, part = _pair(24, 16)
    opts = dict(tol=1e-10, max_iterations=30)
    sj = bj.newton(pj, bj.NewtonPar(**opts))
    st = bt.newton(pt.re_make(u0=ut, params=part), bt.NewtonPar(**opts))
    assert st.converged == bool(sj.converged)
    assert st.itnewton == int(sj.itnewton)
    k = st.itnewton + 1
    np.testing.assert_allclose(st.residuals[:k], np.asarray(sj.residuals)[:k],
                               rtol=1e-6, atol=1e-11)
    assert np.abs(st.u.numpy() - np.asarray(sj.u)).max() < 1e-10
