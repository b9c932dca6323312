"""Parity of the port's SH3d (`jl_tpu_torch/models/sh.py::
swift_hohenberg_3d`, ref examples/SH3d.jl) with the JAX package's at
`test_sh3d.py`'s N = 10: the residual, the record, the closed-form J.v
against forward AD, the exact DCT-II
preconditioner in three axes, and matrix-free Newton-GMRES from the
doubled guess.

Tolerances: F relative to max |JAX| 1e-13; the preconditioner inverts
-(I+Delta)^2 - shift to 1e-10 (the JAX test's bound) and equals JAX's to
1e-13 relative; the Newton roots agree to 1e-9 (both at tol 1e-9).
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
from bifurcationkit.jl_tpu_torch.models.sh import dct3, idct3

N = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_residual_record_and_dct_match_jax():
    jp = jmodels.swift_hohenberg_3d(N=N)
    tp = tmodels.swift_hohenberg_3d(N=N, device="cpu")
    np.testing.assert_array_equal(tp.u0.numpy(), np.asarray(jp.u0))
    u = np.random.default_rng(0).standard_normal((N, N, N))
    assert _rel(tp.F(torch.as_tensor(u), tp.params).numpy(),
                jax.jit(jp.F)(jnp.asarray(u), jp.params)) < 1e-13
    rj = jp.record_from_solution(jnp.asarray(u), 0.1)
    rt = tp.record_from_solution(torch.as_tensor(u), 0.1)
    for key in ("norm", "n8", "nw"):        # nw: the same seeded weight
        assert float(rt[key]) == pytest.approx(float(rj[key]), rel=1e-13)
    ut = torch.as_tensor(u)
    # the closed-form J.v (`jac_op`) is forward AD of F, also on a batch
    v = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, N, N, N)))
    ad = torch.func.jvp(lambda x: tp.F(x, tp.params), (ut,), (v[1],))[1]
    jv = tp.jac_op(ut, tp.params)(v)
    assert _rel(jv[1].numpy(), ad.numpy()) < 1e-13
    assert float((idct3(dct3(ut)) - ut).abs().max()) < 1e-13
    assert _rel(tp.spectral_precond(ut, shift=0.7).numpy(),
                jp.spectral_precond(jnp.asarray(u), shift=0.7)) < 1e-13


def test_precond_is_exact_inverse():
    tp = tmodels.swift_hohenberg_3d(N=N, device="cpu")
    v = torch.as_tensor(np.random.default_rng(3).standard_normal((N, N, N)))
    w = tp.spectral_precond(v, shift=1.0)
    zero = {"l": torch.tensor(0.0, dtype=torch.float64),
            "nu": torch.tensor(0.0, dtype=torch.float64)}
    lin = tp.F(w, zero) + w ** 3
    assert float((lin - w - v).abs().max()) < 1e-10
    # a block of flat vectors keeps its shape and dtype
    blk = tp.spectral_precond(torch.stack([v, v]).reshape(2, -1).float())
    assert blk.shape == (2, N ** 3) and blk.dtype == torch.float32


def test_newton_matches_jax():
    def solve(pkg, prob):
        ls = pkg.GMRES(restart=40, maxiter=200, rtol=1e-10,
                       precond=prob.spectral_precond)
        return pkg.newton(prob.re_make(u0=prob.u0 * 2.0),
                          pkg.NewtonPar(tol=1e-9, max_iterations=80,
                                        linsolver=ls))

    sj = solve(bj, jmodels.swift_hohenberg_3d(N=N))
    st = solve(bt, tmodels.swift_hohenberg_3d(N=N, device="cpu"))
    assert bool(sj.converged) and st.converged
    np.testing.assert_allclose(st.u.numpy(), np.asarray(sj.u), rtol=0,
                               atol=1e-9)
    assert float(st.u.abs().max()) > 0.5

