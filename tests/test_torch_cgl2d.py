"""The cGL2d model (`models.cgl2d`) and the reference's cGL2d Hopf normal
form through code the port already had (mirrors
`test_minaug_mf.py::test_hopf_nf_mf_parity_cgl2d`): the model's pieces (F
batched, its closed-form J.v and the DST-I preconditioner) against the
JAX package's, then the Hopf normal form dense and matrix-free at the
exact Hopf point of the trivial state (r* = -lambda_1(Delta),
omega = nu).  `test_torch_cgl2d_curve.py` holds the Hopf curve.

Tolerances, and why:
* F, J.v and the f64 preconditioner: 1e-12 relative to the JAX
  package's (the same arithmetic; the DST-I on `torch.fft`);
* the normal form: a and b to 1e-8 relative to max(|c|, 1) between the
  port's dense and matrix-free routes (the JAX test's bound) and between
  the port and the JAX package's dense route; Psi001 to 1e-8, Re Psi110
  to 1e-7 (as the JAX test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu.normal_forms.codim1 import (
    hopf_normal_form_point as jhopf_nf)
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch.normal_forms.codim1 import (
    hopf_normal_form_point as thopf_nf)

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


def test_cgl2d_model_matches_jax():
    Nx, Ny = 7, 4
    rng = np.random.default_rng(0)
    u = rng.standard_normal((3, 2, Nx, Ny))
    v = rng.standard_normal((3, 2, Nx, Ny))
    vals = dict(r=0.3, mu=0.2, nu=1.1, c3=0.7, c5=0.4, gamma=0.05)
    jb = bj.models.cgl2d(Nx=Nx, Ny=Ny, **vals)
    tb = bt.models.cgl2d(Nx=Nx, Ny=Ny, device="cpu", **vals)
    Fj = np.stack([np.asarray(jb.F(jnp.asarray(x), jb.params)) for x in u])
    Jvj = np.stack([np.asarray(jax.jvp(lambda y: jb.F(y, jb.params),
                                       (jnp.asarray(x),),
                                       (jnp.asarray(w),))[1])
                    for x, w in zip(u, v)])
    Pj = np.stack([np.asarray(jb.spectral_precond(jnp.asarray(w), 0.3))
                   for w in v])
    ut, vt = torch.as_tensor(u), torch.as_tensor(v)
    for got, ref in ((tb.F(ut, tb.params), Fj),
                     (tb.jac_op(ut, tb.params)(vt), Jvj),
                     (tb.spectral_precond(vt, 0.3), Pj)):
        got = got.numpy()
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    # the f32 preconditioner runs in f32 (the JAX package picks f32 the
    # same way on the CPU)
    p32 = tb.spectral_precond(vt[0].to(torch.float32))
    assert p32.dtype == torch.float32
    assert np.abs(p32.numpy() - np.asarray(jb.spectral_precond(
        jnp.asarray(v[0], jnp.float32)))).max() <= 1e-5 * np.abs(Pj).max()


def test_hopf_nf_mf_parity_cgl2d():
    """`test_minaug_mf.py:299` (at 11x5 there; 7x3 here, where the dense
    jets cost a second): the matrix-free form against the dense one in the
    port, and the port's dense form against the JAX package's."""
    Nx, Ny = 7, 3
    r_star = _r_star(Nx, Ny)
    tb = bt.models.cgl2d(Nx=Nx, Ny=Ny, r=0.1, c3=1.0, device="cpu")
    x0 = torch.zeros((2, Nx, Ny), dtype=DT)
    omega = float(tb.params["nu"])
    hp_d = thopf_nf(tb, x0, r_star, omega)
    hp_m = thopf_nf(tb, x0, r_star, omega, matrix_free=True,
                    precond=tb.spectral_precond)
    jb = bj.models.cgl2d(Nx=Nx, Ny=Ny, r=0.1, c3=1.0)
    hp_j = jhopf_nf(jb, jnp.zeros((2, Nx, Ny)), r_star, omega)
    for key in ("a", "b"):
        d, m, j = (complex(h.nf[key]) for h in (hp_d, hp_m, hp_j))
        assert abs(d - m) <= 1e-8 * max(abs(d), 1.0), (key, d, m)
        assert abs(d - j) <= 1e-8 * max(abs(j), 1.0), (key, d, j)
    assert abs(hp_m.omega - omega) < 1e-9
    assert hp_m.subtype == hp_d.subtype == hp_j.subtype == "SuperCritical"
    np.testing.assert_allclose(hp_m.nf["Psi001"].numpy(),
                               hp_d.nf["Psi001"].numpy(), atol=1e-8)
    np.testing.assert_allclose(np.asarray(hp_d.nf["Psi001"]),
                               np.asarray(hp_j.nf["Psi001"]), atol=1e-8)
    np.testing.assert_allclose(np.real(hp_m.nf["Psi110"].numpy()),
                               np.real(hp_d.nf["Psi110"].numpy()), atol=1e-7)
