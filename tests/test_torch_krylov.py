"""Parity of the port's Krylov and bordered solvers (`jl_tpu_torch/linalg/
linear.py`, `linalg/bordered.py`) with the JAX package, on the SH2d
operator at 31x20 (the fused J.v's plain version on the CPU) and on a
dense matrix.  Inputs are made with numpy from a seed and handed to both.

Tolerances, and why:
* f64 GMRES and the bordered solve: solution to 1e-10 relative, equal
  converged flags and equal matvec counts — the Krylov iterates agree to
  rounding, so every stopping decision is the same;
* iterative refinement with an f32 inner GMRES: solution to 1e-10
  relative, equal converged flags, equal first-pass inner count and totals
  within 3 iterations per pass — an f32 solve to rtol 1e-5 is determined
  only to its tolerance, so the later passes start from residuals that
  differ by a few percent between any two f32 implementations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu import models as jmodels
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch import models as tmodels


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


@pytest.mark.parametrize("case", ["sh_precond", "sh_plain", "dense"])
def test_gmres(case):
    rng = np.random.default_rng(2)
    if case == "dense":
        n = 60
        A = 4 * np.eye(n) + rng.standard_normal((n, n)) / np.sqrt(n)
        b = rng.standard_normal(n)
        Jj, Jt = jnp.asarray(A), torch.as_tensor(A)
        kw = dict(restart=8, maxiter=400, rtol=1e-11)
        gj, gt = bj.GMRES(**kw), bt.GMRES(**kw)
    else:
        pj, pt, u0, ut, part = _pair(31, 20)
        b = rng.standard_normal(u0.shape)
        Jj = pj.jacobian_operator(jnp.asarray(u0), pj.params)
        Jt = pt.jacobian_operator(ut, part)
        if case == "sh_precond":
            kw = dict(restart=20, maxiter=300, rtol=1e-10)
            gj = bj.GMRES(precond=pj.spectral_precond, **kw)
            gt = bt.GMRES(precond=pt.spectral_precond, **kw)
        else:       # restarted, stops at maxiter unconverged
            kw = dict(restart=15, maxiter=120, rtol=1e-8)
            gj, gt = bj.GMRES(**kw), bt.GMRES(**kw)
    xj, cj, ij = jax.jit(lambda b: gj(Jj, b))(jnp.asarray(b))
    xt, ct, it = gt(Jt, torch.as_tensor(b))
    assert ct == bool(cj)
    assert it == int(ij)
    assert _rel(xt.numpy(), xj) < 1e-10


@pytest.mark.parametrize("low", ["float32", "float64"])
def test_iterative_refinement(low):
    pj, pt, u0, ut, part = _pair(31, 20)
    b = np.random.default_rng(3).standard_normal(u0.shape)
    Jj = pj.jacobian_operator(jnp.asarray(u0), pj.params)
    Jt = pt.jacobian_operator(ut, part)
    inner = dict(restart=40, maxiter=160, rtol=1e-5)
    counts = {}

    class Counted(bt.GMRES):
        def __call__(self, J, rhs, a0=0.0, a1=1.0):
            out = super().__call__(J, rhs, a0=a0, a1=a1)
            counts.setdefault("t", []).append(out[2])
            return out

    irj = bj.IterativeRefinement(
        inner=bj.GMRES(precond=pj.spectral_precond, **inner),
        low_dtype=getattr(jnp, low), refinements=4, rtol=1e-10)
    irt = bt.IterativeRefinement(
        inner=Counted(precond=pt.spectral_precond, **inner),
        low_dtype=getattr(torch, low), refinements=4, rtol=1e-10)
    xj, cj, ij = jax.jit(lambda b: irj(Jj, b))(jnp.asarray(b))
    xt, ct, it = irt(Jt, torch.as_tensor(b))
    assert ct == bool(cj) and ct
    assert _rel(xt.numpy(), xj) < 1e-10
    first = jax.jit(lambda b: bj.GMRES(precond=pj.spectral_precond, **inner)(
        lambda v: Jj(v.astype(jnp.float64)).astype(getattr(jnp, low)), b))(
        jnp.asarray(b, getattr(jnp, low)))[2]
    assert counts["t"][0] == int(first)
    if low == "float64":
        assert it == int(ij)
    else:
        assert abs(it - int(ij)) <= 3 * len(counts["t"])


def test_bordering_bls():
    pj, pt, u0, ut, part = _pair(31, 20)
    rng = np.random.default_rng(4)
    dzu, R = rng.standard_normal(u0.shape), rng.standard_normal(u0.shape)
    dR = np.asarray(pj.dFdp(jnp.asarray(u0), pj.params))
    kw = dict(restart=40, maxiter=400, rtol=1e-11)
    blsj = bj.BorderingBLS(solver=bj.GMRES(precond=pj.spectral_precond, **kw))
    blst = bt.BorderingBLS(solver=bt.GMRES(precond=pt.spectral_precond, **kw))
    dXj, dlj, cvj, itj = jax.jit(lambda u, dR, dzu, R: blsj(
        pj.jacobian_operator(u, pj.params), dR, dzu, 0.3, R, 0.1, 0.5, 0.5))(
        jnp.asarray(u0), jnp.asarray(dR), jnp.asarray(dzu), jnp.asarray(R))
    dXt, dlt, cvt, itt = blst(
        pt.jacobian_operator(ut, part), torch.tensor(dR),
        torch.as_tensor(dzu), 0.3, torch.as_tensor(R), 0.1, 0.5, 0.5)
    assert cvt == bool(cvj) and itt == int(itj)
    assert _rel(dXt.numpy(), dXj) < 1e-10
    assert abs(float(dlt) - float(dlj)) < 1e-10 * abs(float(dlj))
