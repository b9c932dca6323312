"""Parity of the port's periodic Swift-Hohenberg model
(`jl_tpu_torch/models/sh.py::swift_hohenberg_periodic_2d`, the reference's
GPU workload, ref examples/SH2d-fronts-cuda.jl) and of the periodic
closure of its J.v (`sh_jv(..., closure="periodic")`) with the JAX
package's model, whose J.v is `jax.jvp` of its residual.

On the CPU the wrapper takes its plain version; the kernel itself is held
against that plain version in `test_torch_sh_jv_periodic_card.py`, which
skips where there is no card.

Grids: ragged and batched shapes for the J.v; Newton on a 32x32 grid of
one hexagon cell (2 lx = 4 pi, 2 ly = 4 pi / sqrt(3)), where the
reference's hexagon guess is periodic.  (Cutting the 512x512 box in
proportion with the grid makes the guess non-periodic, and Newton from it
falls to u = 0.)

Tolerances: F and J.v relative to max |JAX|, 1e-12 (the same stencil
summed in another order); the preconditioner inverts the linear part to
1e-10 absolute (the JAX test's bound); Newton's roots agree to 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu import models as jmodels
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import models as tmodels
from bifurcationkit.jl_tpu_torch.ops.sh_jv import (launch_count, sh_jv,
                                                   sh_jv_operator,
                                                   sh_jv_plain)

CELL = dict(lx=2 * np.pi, ly=2 * np.pi / np.sqrt(3))
RTOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pair(operator, Nx, Ny, **dom):
    return (jmodels.swift_hohenberg_periodic_2d(Nx=Nx, Ny=Ny,
                                                operator=operator, **dom),
            tmodels.swift_hohenberg_periodic_2d(Nx=Nx, Ny=Ny,
                                                operator=operator,
                                                device="cpu", **dom))


@pytest.mark.parametrize("operator", ["fd", "fft"])
def test_residual_and_jv_match_jax(operator):
    """F and J.v (the fd model's `jac_op`, the fft model's forward AD)
    against JAX's F and `jax.jvp` at a random state and l."""
    jp, tp = _pair(operator, 24, 18, **CELL)
    rng = np.random.default_rng(0)
    u, v = rng.standard_normal((2, 24, 18))
    par_j = {"l": jnp.asarray(-0.2), "nu": jnp.asarray(1.3)}
    par_t = {"l": torch.tensor(-0.2, dtype=torch.float64),
             "nu": torch.tensor(1.3, dtype=torch.float64)}
    F_j = jax.jit(jp.F)(jnp.asarray(u), par_j)
    jv_j = jax.jit(lambda x, d: jax.jvp(lambda y: jp.F(y, par_j), (x,),
                                        (d,))[1])(jnp.asarray(u),
                                                  jnp.asarray(v))
    F_t = tp.F(torch.as_tensor(u), par_t)
    assert _rel(F_t.numpy(), F_j) < 1e-12
    assert (tp.jac_op is not None) == (operator == "fd")
    jv_t = tp.dF(torch.as_tensor(u), par_t, torch.as_tensor(v))
    assert _rel(jv_t.numpy(), jv_j) < 1e-12
    rec = tp.record_from_solution(torch.as_tensor(u), -0.2)
    assert float(rec["n8"]) == pytest.approx(
        float(np.sum(u.ravel() ** 8) ** (1 / 8)), rel=1e-14)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape,K", [((31, 20), 1), ((37, 23), 3),
                                     ((2, 5), 2), ((1, 1), 1), ((3, 7), 15)])
def test_periodic_plain_matches_jax_jvp(shape, K, dtype):
    """The periodic closure at ragged shapes, N or M in {1, 2, 3}, and a
    batch of K fields, f32 and f64: `sh_jv_plain(closure="periodic")`
    against `jax.jvp` of the periodic residual on the same grid."""
    rng = np.random.default_rng(1)
    u = rng.standard_normal(shape).astype(dtype)
    v = rng.standard_normal((K,) + shape).astype(dtype)
    hx2, hy2 = 0.11, 0.07
    scal = np.array([-0.1, 1.3, 1.0 / hx2, 1.0 / hy2], dtype)

    def lap(a):
        return ((jnp.roll(a, 1, 0) - 2 * a + jnp.roll(a, -1, 0)) / hx2
                + (jnp.roll(a, 1, 1) - 2 * a + jnp.roll(a, -1, 1)) / hy2)

    def F(x):
        w = x + lap(x)
        return -(w + lap(w)) - 0.1 * x + 1.3 * x * x - x ** 3

    jvp = jax.jit(jax.vmap(lambda d: jax.jvp(F, (jnp.asarray(u),),
                                             (d,))[1]))
    ref = np.asarray(jvp(jnp.asarray(v)))
    ut, vt, st = (torch.as_tensor(a) for a in (u, v, scal))
    before = launch_count()
    out = sh_jv(ut, vt, st, closure="periodic")
    assert launch_count() == before          # CPU tensors: no launch
    assert out.dtype == ut.dtype
    assert _rel(out.numpy(), ref) < RTOL[dtype]
    assert torch.equal(sh_jv_plain(ut, vt[0], st, "periodic"), out[0])
    op = sh_jv_operator(ut, st, closure="periodic")
    assert torch.equal(op(vt), out)
    # the closure matters: the Neumann J.v differs except on a 1x1 grid
    if shape != (1, 1):
        assert _rel(sh_jv(ut, vt, st).numpy(), ref) > 1e-3


def test_unknown_closure_is_refused():
    u = torch.zeros(4, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="closure"):
        sh_jv(u, u, torch.ones(4, dtype=torch.float64), closure="dirichlet")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_precond_is_exact_inverse(dtype):
    """The FFT preconditioner with the DISCRETE symbol inverts the FD
    linear part exactly (JAX test_precond_is_exact_inverse), in f64 and
    on the f32 route, and equals JAX's on the same input."""
    jp, tp = _pair("fd", 32, 24, **CELL)
    v = np.random.default_rng(2).standard_normal((32, 24))
    par0 = {"l": torch.tensor(0.0, dtype=torch.float64),
            "nu": torch.tensor(0.0, dtype=torch.float64)}
    vt = torch.as_tensor(v)
    Lv = tp.F(vt, par0) + vt ** 3               # strip the cubic
    w = tp.spectral_precond((Lv - vt).to(dtype), shift=1.0)
    assert w.dtype == dtype
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    assert float((w.double() - vt).abs().max()) < tol
    ref = np.asarray(jp.spectral_precond(jnp.asarray(v), shift=1.0))
    assert _rel(tp.spectral_precond(vt).numpy(), ref) < 1e-13
    # a block of flat vectors, as LOBPCG hands over
    blk = tp.spectral_precond(torch.stack([vt, 2 * vt]).reshape(2, -1))
    assert _rel(blk[1].reshape(32, 24).numpy(), 2 * ref) < 1e-13


def test_newton_matches_jax():
    """Newton from the hexagon guess on one cell at 32x32: the same
    nontrivial root as the JAX package, to 1e-9, with f64 residuals."""
    jp, tp = _pair("fd", 32, 32, **CELL)
    np.testing.assert_array_equal(tp.u0.numpy(), np.asarray(jp.u0))

    def solve(pkg, prob):
        ls = pkg.GMRES(restart=40, maxiter=300, rtol=1e-11,
                       precond=prob.spectral_precond)
        return pkg.newton(prob, pkg.NewtonPar(tol=1e-10, max_iterations=30,
                                              linsolver=ls))

    sj, st = solve(bj, jp), solve(bt, tp)
    assert bool(sj.converged) and st.converged
    assert st.itnewton == int(sj.itnewton)
    np.testing.assert_allclose(st.u.numpy(), np.asarray(sj.u), rtol=0,
                               atol=1e-9)
    res = tp.F(st.u, tp.params)
    assert float(torch.linalg.vector_norm(res)) < 1e-9
    assert float(st.u.abs().max()) > 0.5          # nontrivial hexagons


def test_default_dtype_and_aliases():
    """f64 by default for both operators (the card has complex128 FFTs),
    and the legacy (N, L) square-box aliases."""
    for op in ("fd", "fft"):
        p = tmodels.swift_hohenberg_periodic_2d(N=8, L=4.0, operator=op,
                                                device="cpu")
        assert p.u0.shape == (8, 8) and p.u0.dtype == torch.float64
    with pytest.raises(ValueError, match="operator"):
        tmodels.swift_hohenberg_periodic_2d(N=8, operator="spectral",
                                            device="cpu")
