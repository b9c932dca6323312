"""Parity of the port's preconditioned blocked LOBPCG (`jl_tpu_torch/linalg/
eig.py::LOBPCGEig`) with the JAX package's, in the flagship's stability
configuration (f32 sweep, tol 3e-3, extra 8, two f64 Rayleigh-Ritz refine
passes, shifted spectral preconditioner) on the SH2d jacobian at 40x30.

JAX's PRNGKey start block cannot be reproduced in PyTorch, so both get the
same full numpy start block of nev + extra columns (it overwrites every
random column).  Their conjugate-direction seeds and refills still come
from different generators, so the two runs take different paths to the
same eigenpairs.

Tolerance: 2e-5 absolute on eigenvalues of size <= 0.12, against each
other and against a dense `eigvalsh` — the f32 sweep stops at a subspace
angle of ~tol, and the f64 refine leaves an eigenvalue error of the order
of that angle squared times ||J|| (observed ~3e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu import models as jmodels
from bifurcationkit.jl_tpu.continuation.kernels import _cast_floats as jcast
from bifurcationkit.jl_tpu.continuation.kernels import _flat_op as jflat
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch import models as tmodels
from bifurcationkit.jl_tpu_torch.continuation.kernels import (
    _cast_floats as tcast)
from bifurcationkit.jl_tpu_torch.continuation.kernels import (
    _flat_op as tflat)

NEV, EXTRA = 12, 8
KW = dict(maxiter=30, tol=3e-3, extra=EXTRA, refine_iters=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sh2d_mixed_precision_eigenvalues():
    pj = jmodels.swift_hohenberg_2d(Nx=40, Ny=30)
    pt = tmodels.swift_hohenberg_2d(Nx=40, Ny=30, device="cpu")
    u0 = np.asarray(pj.u0)
    n = u0.size
    ut, part = interop.state_from_numpy(u0, pj.params, "cpu")
    v0 = np.random.default_rng(0).standard_normal((n, NEV + EXTRA))

    ej = bj.LOBPCGEig(precond=lambda v: pj.spectral_precond(v, shift=1.0),
                      compute_dtype=jnp.float32, symmetry_check=False, **KW)

    @jax.jit
    def run_jax(u, v0):
        lo = bj.FlatOperator(jflat(pj, jcast(u, jnp.float32),
                                   jcast(pj.params, jnp.float32),
                                   out_dtype=jnp.float32), n, jnp.float32)
        hi = bj.FlatOperator(jflat(pj, u, pj.params), n)
        return ej(lo, NEV, v0=v0, J_hi=hi)

    vals_j, _, cv_j, _ = run_jax(jnp.asarray(u0), jnp.asarray(v0))

    et = bt.LOBPCGEig(precond=lambda v: pt.spectral_precond(v, shift=1.0),
                      compute_dtype=torch.float32, **KW)
    lo = tflat(pt, tcast(ut, torch.float32), tcast(part, torch.float32),
               out_dtype=torch.float32)
    hi = tflat(pt, ut, part)
    vals_t, vecs_t, cv_t, _ = et(lo, NEV, v0=torch.as_tensor(v0), J_hi=hi)

    assert cv_t == bool(cv_j)
    assert vals_t.dtype == torch.complex128 and vecs_t.shape == (n, NEV)
    vj, vt = np.real(np.asarray(vals_j)), np.real(vals_t.numpy())
    assert np.abs(vt - vj).max() < 2e-5
    # both against the dense spectrum (the plain J.v applied to I)
    Jd = hi.block(torch.eye(n, dtype=torch.float64)).numpy()
    w_ref = np.sort(np.linalg.eigvalsh(0.5 * (Jd + Jd.T)))[::-1][:NEV]
    assert np.abs(vt - w_ref).max() < 2e-5
    assert np.abs(vj - w_ref).max() < 2e-5
    # returned vectors are eigenvectors of the f64 operator
    X = np.real(vecs_t.numpy())
    res = Jd @ X - X * vt[None, :]
    assert np.linalg.norm(res, axis=0).max() < 1e-2


def test_symmetry_probe_rejects_nonsymmetric():
    A = torch.as_tensor(np.triu(np.random.default_rng(1).standard_normal(
        (30, 30))))
    with pytest.raises(ValueError, match="SYMMETRIC"):
        bt.LOBPCGEig()(A, 3)


def test_dense_symmetric():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(120, 120))
    A = (A + A.T) / 2
    w_ref = np.sort(np.linalg.eigvalsh(A))[::-1]
    vals, vecs, cv, _ = bt.LOBPCGEig(maxiter=300, tol=1e-8, extra=3)(
        torch.as_tensor(A), 6)
    assert np.abs(np.real(vals.numpy()) - w_ref[:6]).max() < 1e-6
